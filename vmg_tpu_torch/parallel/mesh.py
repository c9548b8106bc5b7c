"""The (data, tensor) process mesh and the data-parallel train step
(``vmg_tpu/parallel/mesh.py``).

The JAX package builds a (data, tensor) device mesh, shards the batch over
``data`` and lets XLA emit the collectives.  Here one process drives one
card and ``torch.distributed`` is the mesh: rank r sits at (r // t, r % t)
of a (d, t) mesh, as ``np.asarray(devices).reshape(d, t)`` places device r.
The processes of one ``tensor`` index form a data group, those of one
``data`` index a tensor group (``dist.new_group``).  Each process feeds the
rows of the global batch of its data index (:func:`process_local_batch_slice`,
the reference's rank sharding); :func:`make_sharded_train_step` averages the
float32 gradients over the data group before the gradient norm and the
AdamW update.  Tensor peers see the same rows; with a ``tensor`` axis above
1 the wide weights are stored sharded over the tensor group
(``parallel/tp.py``).  Without an initialised process group the mesh is one
process.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist


def _rank_world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True)
class Mesh:
    """A (data, tensor) mesh of ``data * tensor`` processes, this one at
    ``rank``; ``data_group`` / ``tensor_group`` are its process groups
    (None: the axis is this process alone, or no process group exists)."""

    data: int
    tensor: int
    rank: int
    data_group: Any = field(default=None, compare=False, repr=False)
    tensor_group: Any = field(default=None, compare=False, repr=False)

    @property
    def data_index(self) -> int:
        return self.rank // self.tensor

    @property
    def tensor_index(self) -> int:
        return self.rank % self.tensor

    def __deepcopy__(self, memo):  # immutable, and its process groups are not copyable
        return self

    def data_ranks(self) -> List[int]:
        """The global ranks of this process's data group, by data index."""
        return [d * self.tensor + self.tensor_index for d in range(self.data)]

    def tensor_ranks(self) -> List[int]:
        """The global ranks of this process's tensor group, by tensor index."""
        return [self.data_index * self.tensor + j for j in range(self.tensor)]


def make_mesh(shape: Tuple[int, int] = (0, 1)) -> Mesh:
    """A (data, tensor) mesh over the process group: ``shape=(0, t)`` (or
    (-1, t)) puts world / t processes on ``data``; d x t must be the world
    size.  Every process of the group calls it (the subgroups are made
    collectively, in the same order everywhere)."""
    d, t = shape
    rank, world = _rank_world()
    if t < 1:
        raise ValueError(f"mesh shape {tuple(shape)}: the tensor axis must be >= 1")
    if d in (0, -1):
        d = world // t
    if d * t != world or d < 1:
        raise ValueError(f"mesh shape {tuple(shape)}: the data axis times the tensor axis "
                         f"({d} x {t}) must span the {world} process(es) of the group")
    if world == 1:
        return Mesh(d, t, rank)
    data_group = tensor_group = None
    for j in range(t):  # the data groups: one per tensor index
        ranks = [i * t + j for i in range(d)]
        g = dist.group.WORLD if d == world else (dist.new_group(ranks) if d > 1 else None)
        if rank in ranks:
            data_group = g
    for i in range(d):  # the tensor groups: one per data index
        ranks = [i * t + j for j in range(t)]
        g = dist.group.WORLD if t == world else (dist.new_group(ranks) if t > 1 else None)
        if rank in ranks:
            tensor_group = g
    return Mesh(d, t, rank, data_group, tensor_group)


def process_local_batch_slice(global_batch: int, mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """(local_batch, offset) of this process: the contiguous rows of the
    global batch of its data index (``mesh``; default: every process of the
    group on ``data``).  Tensor peers get the same rows."""
    if mesh is None:
        index, size = _rank_world()
    else:
        index, size = mesh.data_index, mesh.data
    if global_batch % size:
        raise ValueError(f"global batch {global_batch} does not split over {size} data "
                         "processes")
    local = global_batch // size
    return local, index * local


def average_across(mesh: Mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The element-wise mean of ``tensors`` over the mesh's data group, by
    one ``all_reduce`` of their concatenation (float32)."""
    if not dist.is_initialized() or mesh.data == 1:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(mesh.data)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def broadcast_parameters(model, mesh: Optional[Mesh] = None) -> None:
    """The parameters and buffers of data index 0 on every process of its
    data group (``mesh`` None: process 0's on every process; no-op without
    a process group).  Tensor-sharded leaves hold each tensor index's
    slice, so they are broadcast down the data groups only."""
    if not dist.is_initialized():
        return
    if mesh is not None and mesh.data == 1:
        return
    src, group = (0, None) if mesh is None else (mesh.data_ranks()[0], mesh.data_group)
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            dist.broadcast(t.data, src=src, group=group)


def make_sharded_train_step(model, train_cfg, mesh: Mesh, grad_acc: int = 1,
                            frames_mirror: bool = False, flow_fix=None):
    """``train.train_step.make_train_step`` over the mesh: each process's
    step takes its data index's rows of the global batch (``grad_acc``
    microbatches of them, as the global step strides its rows), draws the
    stochastic-depth masks of the global microbatch from a generator seeded
    alike on every process and keeps its rows' columns, and averages the
    loss and the float32 gradients over the data group before the update.
    The model's parameters are first broadcast down the data groups.  A
    model whose wide weights :func:`parallel.tp.shard_params` sharded
    gathers them over the tensor group at use and updates its slices."""
    from vmg_tpu_torch.train.train_step import make_train_step

    return make_train_step(model, train_cfg, grad_acc=grad_acc, frames_mirror=frames_mirror,
                           flow_fix=flow_fix, mesh=mesh)
