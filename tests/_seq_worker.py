"""A process of the T-sharded forward tests (``tests/test_torch_seq*.py``):
one rank of a gloo process group on the CPU, spawned by the test.  It
imports torch and the port only (no JAX), so the processes start fast."""

import os

import torch
import torch.distributed as dist


def run(rank: int, world: int, port: int, cases, out_dir: str) -> None:
    """Join the group, run each case's model on this process's frames of
    its clip through ``make_seq_sharded_forward`` (or its ``module`` under
    the clip's ``SeqShard``) on the case's ``mesh`` shape (default: every
    process on ``data``) and save the outputs and the bytes each exchange
    sent to ``out_dir/rank<r>.pt``."""
    from vmg_tpu_torch.models.vmg import create_model
    from vmg_tpu_torch.parallel import make_mesh, make_seq_sharded_forward, shard_clip_over_time
    from vmg_tpu_torch.parallel.exchange import BYTES, SeqShard, seq_sharded, zero_bytes

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        mesh = make_mesh((0, 1))
        try:
            shard_clip_over_time(mesh, torch.zeros(1, 2 * world + 1, 1))
        except ValueError as e:
            assert "do not split" in str(e)
        else:
            raise AssertionError("shard_clip_over_time took a T the processes do not divide")
        meshes, results = {(0, 1): mesh}, []
        for case in cases:
            shape = tuple(case.get("mesh", (0, 1)))
            if shape not in meshes:  # every process makes the subgroups, in case order
                meshes[shape] = make_mesh(shape)
            mesh = meshes[shape]
            if "module" in case:  # one module on its frames, under the current shard
                shard = SeqShard(mesh.data_group, mesh.data_ranks(), mesh.data_index,
                                 case["x"].shape[1])
                zero_bytes()
                with torch.no_grad(), seq_sharded(shard):
                    args = [shard_clip_over_time(mesh, case["x"])]
                    if "flows" in case:  # a trajectory module: its flows' views
                        args += [shard.local_flows(f, forward=fwd)
                                 for f, fwd in zip(case["flows"], (True, False))]
                    y = case["module"](*args)
                results.append((y, dict(BYTES)))
                continue
            model = create_model(case["cfg"], device="cpu")
            model.load_state_dict(case["state"])
            fwd = make_seq_sharded_forward(model, mesh, frames_mirror=case["mirror"])
            zero_bytes()
            with torch.no_grad():
                y = fwd(shard_clip_over_time(mesh, case["x"]))
            results.append((y, dict(BYTES)))
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()

