"""The training step (``vmg_tpu/train/train_step.py``): forward in the
compute precision, Charbonnier (+ edge) loss, backward, microbatched
gradient accumulation, one grouped AdamW update of the float32 masters.

With ``grad_acc`` > 1 the batch (B rows, B divisible by grad_acc) splits
into microbatches of strided rows ``[i::grad_acc]`` that run one after
another; their gradients and losses are averaged and the optimizer takes
one update -- the reference's ``total_batch`` semantics, with the memory
of one microbatch.  Over a data-parallel mesh (``parallel/mesh.py``) each
process runs its rows of the global batch and the gradients are averaged
across the processes before the update.
"""

from __future__ import annotations

from typing import Optional

import torch

from vmg_tpu_torch.parallel.mesh import average_across, broadcast_parameters
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
    try:
        for p in model.parameters():
            p.grad = None
        out = model(lrs, frames_mirror=frames_mirror, generator=generator, drop_rows=drop_rows)
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
    are broadcast from process 0 first)."""
    if mesh is not None:
        broadcast_parameters(model)
    compute = compute_model(model, torch.bfloat16 if train_cfg.amp else torch.float32)
    opt = AdamW(model, train_cfg, model.cfg.flow_fix if flow_fix is None else flow_fix)

    def step(batch, generator: Optional[torch.Generator] = None):
        lrs, hrs = batch["LRs"], batch["HRs"]
        if lrs.shape[0] % grad_acc:
            raise ValueError(f"batch {lrs.shape[0]} not divisible by grad_acc={grad_acc}")
        loss, grads, rows = 0.0, None, None
        if mesh is not None:  # (global microbatch, this process's first row in it)
            micro = lrs.shape[0] // grad_acc
            rows = (micro * mesh.data, micro * mesh.rank)
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
        grad_norm = global_norm(grads)
        opt.step(grads)
        sync_compute(model, compute)
        return {"loss": loss, "grad_norm": grad_norm}

    step.model = model
    step.optimizer = opt
    step.compute_model = compute
    return step
