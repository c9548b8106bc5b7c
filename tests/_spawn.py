"""Spawn the ranks of a gloo process group for the port's multi-process
tests: each rank runs ``target(rank, world, port, *args, out_dir)`` and
saves its results to ``out_dir/rank<r>.pt``."""

import os
import socket

import torch
import torch.multiprocessing as mp


def spawn(target, world: int, args, out_dir: str, timeout: float = 300):
    """Run the ranks in spawned processes, each killed past ``timeout``
    seconds; require a clean exit and return each rank's results."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, port, *args, out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(world)]
