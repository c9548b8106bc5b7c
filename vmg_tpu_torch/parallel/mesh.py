"""The data-parallel mesh and train step (``vmg_tpu/parallel/mesh.py``).

The JAX package builds a (data, tensor) device mesh, shards the batch over
``data`` and lets XLA emit the gradient all-reduce.  Here one process
drives one card and ``torch.distributed`` is the mesh: the ``data`` axis is
the process group's world, each process feeds its rows of the global
batch (:func:`process_local_batch_slice`, the reference's rank sharding),
and :func:`make_sharded_train_step` averages the float32 gradients with
``all_reduce`` before the gradient norm and the AdamW update, so every
process takes the same update.  Without an initialised process group the
mesh is one process.  A ``tensor`` axis above 1 (the JAX package's
``parallel/tp.py``) is refused by name: it is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.distributed as dist


def _rank_world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True)
class Mesh:
    """A (data, tensor) mesh of processes: ``data`` processes, this one at
    ``rank``."""

    data: int
    tensor: int
    rank: int


def make_mesh(shape: Tuple[int, int] = (0, 1)) -> Mesh:
    """A (data, tensor) mesh over the process group: ``shape=(0, 1)`` (or
    (-1, 1)) puts every process on ``data``; a given data size must be the
    world size."""
    d, t = shape
    if t != 1:
        raise NotImplementedError(f"mesh shape {tuple(shape)}: a 'tensor' axis above 1 is "
                                  "tensor parallelism (vmg_tpu/parallel/tp.py), which the port "
                                  "does not have yet")
    rank, world = _rank_world()
    if d in (0, -1):
        d = world
    if d != world:
        raise ValueError(f"mesh shape {tuple(shape)}: the data axis must span the "
                         f"{world} process(es) of the group")
    return Mesh(d, t, rank)


def process_local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(local_batch, offset) of this process: its contiguous rows of the
    global batch."""
    rank, world = _rank_world()
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} does not split over {world} processes")
    local = global_batch // world
    return local, rank * local


def average_across(mesh: Mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The element-wise mean of ``tensors`` over the mesh's processes, by
    one ``all_reduce`` of their concatenation (float32)."""
    if not dist.is_initialized():
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat.div_(mesh.data)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def broadcast_parameters(model) -> None:
    """Process 0's parameters and buffers on every process (no-op without
    a process group)."""
    if not dist.is_initialized():
        return
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            dist.broadcast(t.data, src=0)


def make_sharded_train_step(model, train_cfg, mesh: Mesh, grad_acc: int = 1,
                            frames_mirror: bool = False, flow_fix=None):
    """``train.train_step.make_train_step`` over the mesh's data axis: each
    process's step takes its rows of the global batch (``grad_acc``
    microbatches of them, as the global step strides its rows), draws the
    stochastic-depth masks of the global microbatch from a generator seeded
    alike on every process and keeps its rows' columns, and averages the
    loss and the float32 gradients over the processes before the update.
    The model's parameters are first broadcast from process 0."""
    from vmg_tpu_torch.train.train_step import make_train_step

    return make_train_step(model, train_cfg, grad_acc=grad_acc, frames_mirror=frames_mirror,
                           flow_fix=flow_fix, mesh=mesh)
