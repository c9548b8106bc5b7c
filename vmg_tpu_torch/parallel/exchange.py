"""The exchanges of the port's sharded paths over ``torch.distributed``.

The JAX package leaves every collective to GSPMD; PyTorch has none, so the
T-sharded forward (``parallel/seq.py``) and the tensor-sharded weights
(``parallel/tp.py``) call these explicitly.  The backend decides how a
tensor travels, by an explicit branch (:func:`staged`): NCCL moves CUDA
tensors where they lie; gloo takes CPU tensors (CUDA ones only for
``all_reduce`` and ``broadcast``), so under gloo every tensor crosses
through host memory -- copied to the host, moved, copied back to its
device -- while the compute stays where it was.  Gathers and point-to-point
messages move raw bytes (any dtype, bit for bit); sums run in float32.
:data:`BYTES` counts what each kind of exchange moved out of this process.

:class:`SeqShard` is this process's share of a clip sharded over T: its
contiguous frames ``a .. b - 1`` of ``T``, and the exchanges the cross-T
ops of the model make.  :func:`seq_sharded` makes it the current shard;
the model's cross-T ops read it with :func:`current_seq` and run their
one-process form where there is none.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# bytes this process sent, by exchange: the T-sharded forward's halos,
# carries, flow gathers and time sums, the tensor-sharded weights' gathers
BYTES: Dict[str, int] = {"halo": 0, "carry": 0, "flows": 0, "frames": 0, "time_sum": 0,
                         "weights": 0}


def zero_bytes() -> None:
    for k in BYTES:
        BYTES[k] = 0


def staged(group=None) -> bool:
    """True where tensors cross through host memory (gloo), False where
    the backend moves them on the card (NCCL)."""
    return dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t``'s bytes as a flat uint8 tensor where the backend takes it."""
    t = t.contiguous()
    if staged(group) and t.is_cuda:
        t = t.cpu()
    return t.reshape(-1).view(torch.uint8)


def all_reduce_sum(t: torch.Tensor, group, kind: str) -> torch.Tensor:
    """The float32 sum of ``t`` over ``group``, on ``t``'s device."""
    f = t.float().contiguous()
    wire = f.cpu() if staged(group) and f.is_cuda else f.clone()
    dist.all_reduce(wire, group=group)
    BYTES[kind] += wire.numel() * 4
    return wire.to(t.device)


def all_gather(t: torch.Tensor, group, n: int, kind: str) -> List[torch.Tensor]:
    """Every process's ``t`` (the same shape and dtype everywhere), in group
    rank order, on ``t``'s device."""
    w = _wire(t, group)
    out = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(out, w, group=group)
    BYTES[kind] += w.numel()
    return [o.to(t.device).view(t.dtype).reshape(t.shape) for o in out]


def exchange(sends: Dict[int, Sequence[torch.Tensor]],
             recvs: Dict[int, Sequence[torch.Tensor]], group, kind: str) -> None:
    """One round of point-to-point messages over ``group``: the tensors of
    ``sends`` {global rank: tensors} go out, and those of ``recvs`` {global
    rank: tensors}, whose shapes and dtypes the receiver knows, are filled
    from their ranks, as one batch: under NCCL one group call, so two
    processes that send to each other in the same round do not wait on
    each other's receive.  A send completes when its peer receives it in
    some round of its own."""
    ops, fills = [], []
    for dst, ts in sends.items():
        for t in ts:
            if t.numel():
                w = _wire(t, group)
                ops.append(dist.P2POp(dist.isend, w, dst, group))
                BYTES[kind] += w.numel()
    for src, ts in recvs.items():
        for t in ts:
            if t.numel():
                w = torch.empty(t.numel() * t.element_size(), dtype=torch.uint8,
                                device="cpu" if staged(group) else t.device)
                ops.append(dist.P2POp(dist.irecv, w, src, group))
                fills.append((t, w))
    for work in dist.batch_isend_irecv(ops) if ops else []:
        work.wait()
    for t, w in fills:
        t.copy_(w.to(t.device).view(t.dtype).reshape(t.shape))


class SeqShard:
    """Frames ``a .. b - 1`` of a ``T``-frame clip on process ``index`` of
    the ``n`` processes ``ranks`` (global ranks, by data index) of
    ``group``: T / n contiguous frames each, as the JAX package's
    ``P(None, 'data')`` places them.  With one process (``n`` 1: no
    process group, or a data axis of 1) nothing is exchanged."""

    def __init__(self, group, ranks: Sequence[int], index: int, T: int):
        self.group, self.ranks, self.index, self.n = group, list(ranks), index, len(ranks)
        if T % self.n:
            raise ValueError(f"a clip of T={T} frames does not split over {self.n} processes")
        self.T, self.Tl = T, T // self.n
        self.a, self.b = index * self.Tl, (index + 1) * self.Tl

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.n - 1

    def time_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The float32 sum over every process of this process's partial sum
        ``t`` (a sum over its frames)."""
        if self.n == 1:
            return t.float()
        return all_reduce_sum(t, self.group, "time_sum")

    def halo(self, x: torch.Tensor, prev: bool = True, nxt: bool = True):
        """(the previous process's last frame, the next process's first
        frame) of ``x`` (B, Tl, ...), each (B, 1, ...) or None past the
        clip's ends; ``prev`` / ``nxt`` False skip that exchange (every
        process passes the same flags)."""
        before, after = self.index - 1, self.index + 1
        got_prev = torch.empty_like(x[:, :1]) if prev and not self.first else None
        got_next = torch.empty_like(x[:, :1]) if nxt and not self.last else None
        sends, recvs = {}, {}
        if nxt and not self.first:
            sends[before] = [x[:, :1]]
        if prev and not self.last:
            sends[after] = [x[:, -1:]]
        if got_prev is not None:
            recvs[before] = [got_prev]
        if got_next is not None:
            recvs[after] = [got_next]
        self.exchange(sends, recvs, "halo")
        return got_prev, got_next

    def exchange(self, sends: Dict[int, Sequence[torch.Tensor]],
                 recvs: Dict[int, Sequence[torch.Tensor]], kind: str) -> None:
        """:func:`exchange` with the processes named by their index."""
        exchange({self.ranks[i]: ts for i, ts in sends.items()},
                 {self.ranks[i]: ts for i, ts in recvs.items()}, self.group, kind)

    def gather_frames(self, x: torch.Tensor) -> torch.Tensor:
        """The whole clip of ``x`` (B, Tl, ...) on every process: (B, T, ...)."""
        if self.n == 1:
            return x
        return torch.cat(all_gather(x, self.group, self.n, "frames"), dim=1)

    def gather_flows(self, f: torch.Tensor) -> torch.Tensor:
        """The T - 1 flows of the clip from each process's pairs: process i
        holds pairs a .. min(b, T - 1) - 1 (Tl, the last Tl - 1), ``f`` (B,
        pairs, ...) -> (B, T - 1, ...) on every process."""
        if self.n == 1:
            return f
        if self.last:  # equal shapes for the gather: pad, then drop
            f = torch.cat([f, f.new_zeros((f.shape[0], 1, *f.shape[2:]))], dim=1)
        return torch.cat(all_gather(f, self.group, self.n, "flows"), dim=1)[:, :self.T - 1]

    def local_flows(self, flows: torch.Tensor, forward: bool) -> torch.Tensor:
        """This process's view of the clip's (B, T - 1, ...) flows, one a
        frame: forward flows ``a - 1 .. b - 2`` (frame i's from i - 1),
        backward flows ``a .. b - 1`` (frame i's from i + 1), zeros where
        the clip has none (before frame 0, after frame T - 1)."""
        zero = flows.new_zeros((flows.shape[0], 1, *flows.shape[2:]))
        if forward:
            body = flows[:, max(self.a - 1, 0):self.b - 1]
            return torch.cat([zero, body], dim=1) if self.first else body
        body = flows[:, self.a:min(self.b, self.T - 1)]
        return torch.cat([body, zero], dim=1) if self.last else body


_CURRENT: contextvars.ContextVar[Optional[SeqShard]] = contextvars.ContextVar(
    "vmg_seq_shard", default=None)


def current_seq() -> Optional[SeqShard]:
    """The shard of the T-sharded forward running in this context, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def seq_sharded(shard: SeqShard):
    """Run the enclosed forward on ``shard``'s frames."""
    token = _CURRENT.set(shard)
    try:
        yield shard
    finally:
        _CURRENT.reset(token)


def mean_over_time(x: torch.Tensor) -> torch.Tensor:
    """float32 mean of (B, T, H, W, C) over (T, H, W) -> (B, C), over the
    whole clip where it is sharded over T."""
    seq = current_seq()
    if seq is None:
        return x.float().mean(dim=(1, 2, 3))
    B, T, H, W, C = x.shape
    return seq.time_sum(x.float().sum(dim=(1, 2, 3))) / float(seq.T * H * W)
