"""Sequence-parallel (T-sharded) serving forward (``vmg_tpu/parallel/seq.py``).

The JAX package places a clip's T axis on the mesh's ``data`` axis and lets
GSPMD partition the forward and insert the collectives.  Here each process
of the data group holds its contiguous T / n frames and runs the model on
them, and every op that crosses T makes its exchange explicitly
(``parallel/exchange.py``):

* the SPyNet pairs: the pair across a shard's end takes the next process's
  first level-0 frame (pooled locally to every level); the T - 1 flows are
  gathered, and each stage reads this process's views of them -- flipped
  first with ``frames_mirror``;
* the reweight means over (T, H, W) of the MorphFC-decay mixers (the
  per-frame sums of the axes or reduce kernel), of plain MorphFC and of
  the shift FFN: a float32 all-reduce of the (B, C) sums, divided by the
  whole clip's T;
* the trajectory recurrence: windows inside a shard run as they do in one
  process; a window that spans shards hands its carry (the propagated
  feature, the warped keyframe buffers -- or the 'loc' slots and their
  locations) to the next process forward and to the previous one backward;
* the DCN alignment: one neighbour frame from each adjacent process;
* the 3D window attention: its windows span T and wrap around it, so the
  layer runs on the clip gathered from every process.

Everything else (InputProj, the norms, the FFN, RCAB, the resamplers, the
head, the trilinear residual) is per frame.  The forward only, as in the
JAX package.
"""

from __future__ import annotations

import torch

from vmg_tpu_torch.parallel.exchange import SeqShard, seq_sharded
from vmg_tpu_torch.parallel.mesh import Mesh, broadcast_parameters


def make_seq_sharded_forward(model, mesh: Mesh, frames_mirror: bool = False):
    """``fwd(x) -> y`` on this process's frames: x (B, T/n, h, w, 3) the
    contiguous frames :func:`shard_clip_over_time` gives it of a T-frame
    clip, y (B, T/n, 4h, 4w, 3) their output, as the one-process forward
    gives those frames.  Every process of the mesh's data group calls it
    together.  ``model``'s parameters are first broadcast from data index 0
    (the JAX package's replicated params)."""
    broadcast_parameters(model, mesh)

    def fwd(x: torch.Tensor) -> torch.Tensor:
        shard = SeqShard(mesh.data_group, mesh.data_ranks(), mesh.data_index,
                         x.shape[1] * mesh.data)
        with seq_sharded(shard):
            return model(x, frames_mirror=frames_mirror)

    return fwd


def shard_clip_over_time(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This process's contiguous frames of a (B, T, ...) clip: T / n of
    them, n the mesh's data size.  A T that n does not divide is refused,
    as the JAX package's ``P(None, 'data')`` refuses it."""
    T, n = x.shape[1], mesh.data
    if T % n:
        raise ValueError(f"shard_clip_over_time: T={T} frames do not split over the "
                         f"{n} processes of the data axis")
    Tl = T // n
    return x[:, mesh.data_index * Tl:(mesh.data_index + 1) * Tl]
