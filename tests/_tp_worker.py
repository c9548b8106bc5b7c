"""A process of ``tests/test_torch_tp.py``: one rank of a gloo process
group on the CPU, spawned by the test, running the tensor-parallel training
step.  It imports torch and the port only (no JAX)."""

import os

import torch
import torch.distributed as dist


def run(rank: int, world: int, port: int, case, out_dir: str) -> None:
    """Join the group, shard the model over a (world / t, t) mesh, take one
    step on this data index's rows and save (loss, grad norm, the whole
    state gathered, the sharded leaves' names, this rank's and the whole
    bytes of every sharded parameter and its AdamW moments) to
    ``out_dir/rank<r>.pt``, with the serving forward of two frames after
    the step; check that the whole state, sharded again (``shard_state``)
    and loaded, is this rank's state."""
    from vmg_tpu_torch.ckpt.io import load_trainer_state, trainer_state
    from vmg_tpu_torch.configs import TrainConfig
    from vmg_tpu_torch.models.vmg import create_model
    from vmg_tpu_torch.parallel import (gather_state, make_mesh, make_sharded_train_step,
                                        param_shardings, process_local_batch_slice,
                                        shard_params, shard_state)
    from vmg_tpu_torch.parallel.tp import sharded_mask

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        mesh = make_mesh(case["mesh"])
        model = create_model(case["cfg"], is_train=True, device="cpu")
        model.load_state_dict(case["state"])
        rule = param_shardings(mesh, model)
        shard_params(mesh, model)
        step = make_sharded_train_step(model, TrainConfig(**case["train"]), mesh, flow_fix=0)
        local, first = process_local_batch_slice(case["LRs"].shape[0], mesh)
        clip = case["LRs"][:1, :2]
        _serve(model, clip)  # packs the serving forms' operands from the first weights
        m = step({k: case[k][first:first + local] for k in ("LRs", "HRs")})
        served = _serve(model, clip)  # after the update: packed again
        mask = sharded_mask(model)
        opt = step.optimizer
        held = sum(t.numel() for ts in (opt.params, opt.mu, opt.nu)
                   for t, s in zip(ts, mask) if s)
        state = gather_state(mesh, trainer_state(model, step), model)
        # the whole state sharded again is this rank's state: a round trip
        mine = trainer_state(model, step)
        load_trainer_state(shard_state(mesh, state, model), model, step)
        again = trainer_state(model, step)
        for k, v in mine["params"].items():
            assert torch.equal(again["params"][k], v), k
        for a, b in zip(mine["opt"]["mu"] + mine["opt"]["nu"],
                        again["opt"]["mu"] + again["opt"]["nu"]):
            assert torch.equal(a, b)
        whole = sum(v.numel() for k, v in state["params"].items() if rule[k] is not None) * 3
        torch.save((float(m["loss"]), float(m["grad_norm"]), state["params"],
                    sorted(k for k, v in rule.items() if v is not None), held, whole, served),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _serve(model, clip):
    model.eval()
    try:
        with torch.no_grad():
            return model(clip)
    finally:
        model.train()


def record_first_grads(step) -> dict:
    """Wrap ``step``'s optimizer so that its first update keeps the
    gradients it is given, by plain state-dict name (a sharded leaf's as
    this rank's slice)."""
    opt = step.optimizer
    names = {id(p): n.replace("parametrizations.", "").replace(".original", "")
             for n, p in step.model.named_parameters()}
    grads, update = {}, opt.step

    def first(gs, norm=None):
        if not grads:
            grads.update({names[id(p)]: g.detach().clone() for p, g in zip(opt.params, gs)})
        return update(gs, norm)

    opt.step = first
    return grads


def run_grads(rank: int, world: int, port: int, case, out_dir: str) -> None:
    """Join the group, shard the model over a (1, world) mesh, take one
    step on the whole batch and save (loss, the first gradient by name,
    the sharding rule) to ``out_dir/rank<r>.pt``."""
    from vmg_tpu_torch.configs import TrainConfig
    from vmg_tpu_torch.models.vmg import create_model
    from vmg_tpu_torch.parallel import (make_mesh, make_sharded_train_step, param_shardings,
                                        shard_params)

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        mesh = make_mesh((1, world))
        model = create_model(case["cfg"], is_train=True, device="cpu")
        model.load_state_dict(case["state"])
        rule = param_shardings(mesh, model)
        shard_params(mesh, model)
        step = make_sharded_train_step(model, TrainConfig(**case["train"]), mesh, flow_fix=0)
        grads = record_first_grads(step)
        m = step({k: case[k] for k in ("LRs", "HRs")}, torch.Generator().manual_seed(1))
        torch.save((float(m["loss"]), grads, rule), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
