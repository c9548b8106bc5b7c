"""Timing on the card, and the card's peak rates for bounds.

Port of ``timed`` from the JAX package's ``utils/profiling.py``; its
traces, annotations and compiled-cost statistics are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch


def timed(fn: Callable, *args, iters: int = 3, warmup: int = 2) -> float:
    """Seconds per call of ``fn(*args)`` on the card: ``warmup`` calls,
    then ``iters`` calls between two CUDA events, fenced by the second
    event's completion.  Raises without a CUDA device: a host clock around
    CPU work is no device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("timed measures device time and needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


# Peak rates of one NVIDIA H100 SXM (data sheet, dense): HBM bytes/s, and
# FLOP/s on the bf16 tensor cores and in f32 outside them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"bf16 tensor cores": 989e12, "f32": 67e12}


def bound(nbytes: int, flops: float, peak: str = "bf16 tensor cores") -> dict:
    """The least time the card could take for a call that moves ``nbytes``
    (each input read once, each output written once) and does ``flops``
    operations at ``peak``: {bound_ms, bound_by ("bytes" or
    "operations")}."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS_PER_S[peak] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
