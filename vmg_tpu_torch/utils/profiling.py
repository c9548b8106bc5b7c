"""Timing, traces, annotations and cost statistics on the card
(``vmg_tpu/utils/profiling.py``), and the card's peak rates for bounds.

``trace`` and ``annotate`` are ``torch.profiler``'s; ``compiled_stats``
counts what a call does by running it under dispatch modes: the
convolutions' and matrix products' FLOPs (``FlopCounterMode``, 2 x the
multiply-adds, with a formula for each ``vmg::`` operator that multiplies
-- :func:`register_vmg_flops` -- so a hand kernel and its plain version
count alike), the bytes every dispatched op reads and writes, and the
peak of allocated device memory.  XLA's ``flops``, which the JAX package
reads, also counts elementwise work; these count products only.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


# torch.cuda._sleep spins for a number of SM clock cycles; H100 SXM's boost
# clock (1.98 GHz) makes it sleep at least the seconds asked for.
_SLEEP_CYCLES_PER_S = 1.98e9


def timed(fn: Callable, *args, iters: int = 3, warmup: int = 2) -> float:
    """Seconds per call of ``fn(*args)`` on the card: ``warmup`` calls,
    then ``iters`` calls between two CUDA events, fenced by the second
    event's completion.  The stream first sleeps for longer than the host
    takes to enqueue the ``iters`` calls, so the calls run back to back and
    the events time the device, not the host's launch rate (a call whose
    host work outlasts its kernels, a short kernel behind a Python wrapper,
    would otherwise measure the host).  Raises without a CUDA device: a
    host clock around CPU work is no device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("timed measures device time and needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)  # the host's time to enqueue one call
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * iters * host_s + 1e-4, 1.0) * _SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Profile the enclosed block (CPU and, where there is a card, CUDA
    activity) and write its Chrome trace to ``logdir/trace_<pid>.json``
    (default: ``vmg_trace`` under the temporary directory)."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "vmg_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range of the traces: a profiler record, and on the card an
    NVTX range too."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _ltam_fwd_flops(q_shape, kv_shape, K: int):
    # per query pixel: K slots x the 2x2 window's 4 keys, a d-long dot
    # product for each logit and for each value, over every head
    n, h, w, c = q_shape
    return 2 * 2 * n * h * w * K * 4 * c


_VMG_FLOPS = {
    # x (N, H, W, C), the grouped 3x3 expand to the hidden width, the
    # projection back; the hidden width is b1p's (groups x the padded group)
    "group_ffn": lambda x, w, b1p, b2, groups, act, out_shape=None: (
        2 * x[0] * x[1] * x[2] * b1p[0] * (x[3] // groups) * 9
        + 2 * x[0] * x[1] * x[2] * b1p[0] * x[3]),
    # both axis FCs: a (Cp, Cp) product for every pixel's token, Cp = kh's
    "morphfc_axes": lambda x, c, kh, bh, kw, bw, *a, out_shape=None: (
        2 * x[0] * x[1] * x[2] * (kh[0] + kw[0]) * x[3]),
    # the projection of the combined branches, (C_in, C_out)
    "morphfc_combine": lambda x, *a, out_shape=None: 2 * x[0] * x[1] * x[2] * x[3] * x[3],
    # the two 3x3 convolutions, Cin -> Cm -> Cout (b1's width is Cm's)
    "conv_chain": lambda x, w1, b1, w2, b2, *a, out_shape=None: (
        2 * x[0] * x[1] * x[2] * 9 * b1[0] * (x[3] + x[3])),
    "ltam_fwd": lambda q, kv, pe, K, heads, with_den, out_shape=None: _ltam_fwd_flops(q, kv, K),
    # the gradients of both products: twice the forward's
    "ltam_bwd": lambda q, kv, pe, den, out, g, K, heads, out_shape=None:
        2 * _ltam_fwd_flops(q, kv, K),
}


def register_vmg_flops() -> None:
    """Give ``FlopCounterMode`` a formula for each ``vmg::`` operator that
    multiplies (once; the ops register on import of ``vmg_tpu_torch.ops``)."""
    from torch.utils.flop_counter import register_flop_formula

    import vmg_tpu_torch.ops  # noqa: F401  (defines the operators)

    if getattr(register_vmg_flops, "done", False):
        return
    for name, formula in _VMG_FLOPS.items():
        register_flop_formula(getattr(torch.ops.vmg, name))(formula)
    register_vmg_flops.done = True


class _ByteCounter(TorchDispatchMode):
    """Bytes of the tensors every dispatched op takes and returns."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten((args, kwargs, out))[0]:
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def compiled_stats(fn: Callable, *example_args) -> dict:
    """{"flops", "bytes accessed", "peak_memory_bytes"} of one call of
    ``fn(*example_args)``: the products' FLOPs (2 x multiply-adds), the
    bytes every op reads and writes, and the peak of allocated device memory
    over the call (None on the CPU).  The call runs."""
    from torch.utils.flop_counter import FlopCounterMode

    register_vmg_flops()
    cuda = torch.cuda.is_available() and any(
        isinstance(a, torch.Tensor) and a.is_cuda for a in tree_flatten(example_args)[0])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counter = FlopCounterMode(display=False)
    nbytes = _ByteCounter()
    with counter, nbytes:
        fn(*example_args)
    peak = None
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    return {"flops": float(counter.get_total_flops()), "bytes accessed": float(nbytes.bytes),
            "peak_memory_bytes": peak}


# Peak rates of one NVIDIA H100 SXM (data sheet, dense): HBM bytes/s, and
# FLOP/s on the bf16 tensor cores, in f32 outside them, and of an f32
# product as three TF32 products (3xTF32) at the TF32 rate of 494.7 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"bf16 tensor cores": 989e12, "f32": 67e12,
                    "3xTF32 tensor cores": 494.7e12 / 3}


def bound(nbytes: int, flops: float, peak: str = "bf16 tensor cores") -> dict:
    """The least time the card could take for a call that moves ``nbytes``
    (each input read once, each output written once) and does ``flops``
    operations at ``peak``: {bound_ms, bound_by ("bytes" or
    "operations")}."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS_PER_S[peak] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
