"""A data-parallel training process of ``tests/test_torch_parallel.py``:
one rank of a gloo process group on the CPU, spawned by the test.  It
imports torch and the port only (no JAX), so the processes start fast."""

import os

import torch
import torch.distributed as dist


def run(rank: int, world: int, port: int, cases, out_dir: str) -> None:
    """Join the group, check the multihost helpers, run each case's
    sharded training step on this process's rows and save (loss, grad norm,
    parameters) of each case to ``out_dir/rank<r>.pt``."""
    from vmg_tpu_torch.configs import TrainConfig
    from vmg_tpu_torch.models.vmg import create_model
    from vmg_tpu_torch.parallel import (all_gather_host_values, assert_same_across_hosts,
                                        broadcast_from_host0, make_mesh,
                                        make_sharded_train_step, process_local_batch_slice)

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        gathered = all_gather_host_values([float(rank), 1.0])
        assert gathered.tolist() == [[float(r), 1.0] for r in range(world)], gathered
        assert broadcast_from_host0({"rank": rank, "t": torch.full((2,), rank)})["rank"] == 0
        assert_same_across_hosts({"a": torch.ones(3)}, "ones")
        try:
            assert_same_across_hosts(rank, "rank")
        except AssertionError as e:
            assert "rank differs" in str(e)
        else:
            raise AssertionError("assert_same_across_hosts passed on differing values")
        mesh = make_mesh((0, 1))
        assert (mesh.data, mesh.rank) == (world, rank)
        results = []
        for case in cases:
            model = create_model(case["cfg"], is_train=True, device="cpu")
            model.load_state_dict(case["state"])
            step = make_sharded_train_step(model, TrainConfig(**case["train"]), mesh,
                                           grad_acc=case["grad_acc"], flow_fix=0)
            local, first = process_local_batch_slice(case["LRs"].shape[0])
            batch = {k: case[k][first:first + local] for k in ("LRs", "HRs")}
            m = step(batch, torch.Generator().manual_seed(case["seed"]))
            assert_same_across_hosts(model.state_dict(), "parameters after the step")
            results.append((float(m["loss"]), float(m["grad_norm"]),
                            {k: v.clone() for k, v in model.state_dict().items()}))
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
