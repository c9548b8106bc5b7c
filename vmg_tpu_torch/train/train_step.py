"""The training step (``vmg_tpu/train/train_step.py``): forward in the
compute precision, Charbonnier (+ edge) loss, backward, microbatched
gradient accumulation, one grouped AdamW update of the float32 masters.

With ``grad_acc`` > 1 the batch (B rows, B divisible by grad_acc) splits
into microbatches of strided rows ``[i::grad_acc]`` that run one after
another; their gradients and losses are averaged and the optimizer takes
one update -- the reference's ``total_batch`` semantics, with the memory
of one microbatch.  Over a (data, tensor) mesh (``parallel/mesh.py``) each
process runs its data index's rows of the global batch and the gradients
are averaged over the data group before the update; a model whose wide
weights ``parallel/tp.py`` sharded over the tensor group gathers them at
use, once a microbatch, and updates its slices.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.nn.utils import parametrize

from vmg_tpu_torch.parallel.exchange import all_reduce_sum
from vmg_tpu_torch.parallel.mesh import average_across, broadcast_parameters
from vmg_tpu_torch.parallel.tp import sharded, sharded_mask
from vmg_tpu_torch.train.loss import total_loss
from vmg_tpu_torch.train.optimizer import AdamW, global_norm
from vmg_tpu_torch.train.precision import compute_model, float32_grads, sync_compute


def loss_and_grads(model, lrs, hrs, train_cfg, *, frames_mirror: bool = False,
                   generator: Optional[torch.Generator] = None, drop_rows=None):
    """One microbatch on ``model`` in training mode: returns the detached
    loss and the float32 gradients, in parameter order, and leaves no
    gradient on the model.  ``drop_rows``: see ``VMG.forward``."""
    was = model.training
    model.train()
    # tensor-sharded leaves: gathered once for the forward and the backward
    cache = parametrize.cached() if sharded(model) else contextlib.nullcontext()
    try:
        for p in model.parameters():
            p.grad = None
        with cache:
            out = model(lrs, frames_mirror=frames_mirror, generator=generator,
                        drop_rows=drop_rows)
            loss = total_loss(out, hrs, eps=train_cfg.eps, if_aux=train_cfg.if_aux,
                              aux_ratio=train_cfg.aux_ratio)
            loss.backward()
        grads = float32_grads(model)
        for p in model.parameters():
            p.grad = None
    finally:
        model.train(was)
    return loss.detach(), grads


def make_train_step(model, train_cfg, grad_acc: int = 1, frames_mirror: bool = False,
                    flow_fix: Optional[int] = None, mesh=None):
    """Returns ``step(batch, generator=None) -> {"loss", "grad_norm"}`` that
    updates ``model`` (the float32 master, built with ``is_train=True``
    for its stochastic depth) in place.  ``batch``: {"LRs": (B, T, h, w,
    3), "HRs": (B, T, 4h, 4w, 3)} on the model's device, B the effective
    update batch.  ``generator`` draws the stochastic-depth masks.
    ``train_cfg.amp``: bf16 compute (:mod:`precision`).  ``flow_fix``: the
    SPyNet freeze (default ``model.cfg.flow_fix``).  ``frames_mirror``: the
    clips are mirror-extended (see ``VMG.forward``).  ``mesh``: a
    ``parallel.mesh.Mesh``; ``batch`` is then this process's contiguous rows
    of the global batch (``process_local_batch_slice``), each microbatch
    draws the masks of the global microbatch and keeps its rows', and the
    loss and gradients are averaged over the processes (the parameters
    are broadcast down the data groups first).  A model sharded by
    ``parallel.tp.shard_params`` keeps its slices: the optimizer's moments
    are slices too, and the gradient norm sums the slices' squares over the
    tensor group."""
    if mesh is not None:
        broadcast_parameters(model, mesh)
    compute = compute_model(model, torch.bfloat16 if train_cfg.amp else torch.float32)
    opt = AdamW(model, train_cfg, model.cfg.flow_fix if flow_fix is None else flow_fix)
    split = sharded_mask(model) if mesh is not None and mesh.tensor > 1 else None

    def norm(grads):
        if split is None:
            return global_norm(grads)
        sq = torch.stack(torch._foreach_norm(grads)) ** 2
        part = all_reduce_sum(sq[torch.tensor(split, device=sq.device)].sum().reshape(1),
                              mesh.tensor_group, "weights")
        return torch.sqrt(sq[~torch.tensor(split, device=sq.device)].sum() + part[0])

    def step(batch, generator: Optional[torch.Generator] = None):
        lrs, hrs = batch["LRs"], batch["HRs"]
        if lrs.shape[0] % grad_acc:
            raise ValueError(f"batch {lrs.shape[0]} not divisible by grad_acc={grad_acc}")
        loss, grads, rows = 0.0, None, None
        if mesh is not None:  # (global microbatch, this process's first row in it)
            micro = lrs.shape[0] // grad_acc
            rows = (micro * mesh.data, micro * mesh.data_index)
        for i in range(grad_acc):
            li, gi = loss_and_grads(compute, lrs[i::grad_acc], hrs[i::grad_acc],
                                    train_cfg, frames_mirror=frames_mirror,
                                    generator=generator, drop_rows=rows)
            loss = loss + li
            grads = gi if grads is None else torch._foreach_add(grads, gi)
        if grad_acc > 1:
            grads = torch._foreach_div(grads, float(grad_acc))
            loss = loss / grad_acc
        if mesh is not None:
            *grads, loss = average_across(mesh, [*grads, loss.reshape(1)])
            loss = loss.reshape(())
        grad_norm = norm(grads)
        opt.step(grads, grad_norm)
        sync_compute(model, compute)
        return {"loss": loss, "grad_norm": grad_norm}

    step.model = model
    step.optimizer = opt
    step.compute_model = compute
    return step
