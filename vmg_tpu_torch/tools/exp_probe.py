"""Hopper probes, round 1: the port's counterpart of the JAX package's
Mosaic probe tool (``tools/exp_mosaic_probe.py``), under its probe names,
shapes and dtypes.

    python -m vmg_tpu_torch.tools.exp_probe [--device cuda|cpu]

One JSON line per probe: a row-slab copy through bulk asynchronous copies
(``dma_*``), shared-memory relayouts (``vmem_subshift*``, ``lane_store_*``,
``lane_read_off28``, ``roll_lane``, ``sublane_store_t32``) and the inner
products of the grouped-conv kernel's candidates (``mm_*``).  Copies give
their difference from the plain version (``maxdiff``, which must be 0),
products theirs and ``tf_s``; on the card each gives ``ms``, ``plain_ms``,
``library_ms`` (one PyTorch call for the same function) and ``bound_ms``.
A failing probe prints "ERR ..." and the tool exits 1.

``lane_store_*`` reads nine row taps of 320 rows, rows t .. t + 319 for
t < 9, so its input has 328 rows; the JAX tool's had 322, six short, and
its oracle could not be formed.
"""

from __future__ import annotations

import sys

import torch

from vmg_tpu_torch.ops.probes import (GemmForm, Layout, relayout_plain, slab_copy,
                                      slab_copy_plain, smem_relayout, tile_gemm,
                                      tile_gemm_plain)
from vmg_tpu_torch.tools._probing import bf16_input, copy_probe, gemm_probe, main as _main

R = 6  # rows of a halo'd slab


def dma_probe(H2, Wp, C):
    """Rows 1 .. R-2 of two halo'd (R, Wp, C) slabs of frame 0 of (2, H2, Wp, C)."""
    def probe(dev, rng):
        x = bf16_input(rng, (2, H2, Wp, C), dev)
        out_rows = 2 * (R - 2)  # the two slabs' inner rows are rows 1 .. 2R - 4
        return copy_probe(dev, lambda: slab_copy(x, R), lambda: slab_copy_plain(x, R),
                          lambda: x[0, 1:1 + out_rows].clone(), out_rows * Wp * C * 2)
    return probe


def relayout_probe(shape, layout, library):
    """``layout`` of a bf16 input of ``shape`` (2-D inputs as one frame)."""
    def probe(dev, rng):
        x = bf16_input(rng, shape, dev)
        x3 = x if x.dim() == 3 else x[None]

        def kernel():
            out = smem_relayout(x3, layout)
            return out if x.dim() == 3 else out[0]

        def plain():
            out = relayout_plain(x3, layout).contiguous()
            return out if x.dim() == 3 else out[0]

        return copy_probe(dev, kernel, plain, lambda: library(x), read_bytes(x3, layout))
    return probe


def read_bytes(x, layout):
    """Bytes of x that the layout's output depends on."""
    A, B, C = x.shape
    rows = {"slice": layout.rows, "taps": layout.rows + layout.taps - 1}.get(layout.kind, B)
    chans = layout.chans if layout.kind == "slice" else C
    return A * rows * chans * x.element_size()


def taps(rows=320, n=9):
    return Layout("taps", rows=rows, taps=n)


def lane_taps_cat(x):
    return torch.cat([x[:, t:t + 320] for t in range(9)], dim=-1)


def mm_probe(shape_lhs, shape_rhs):
    """bf16 (.., K, M) or (M, K) @ (K, N), f32 accumulation, bf16 out: the
    TPU tool's ``mm_time`` shapes (a 3-D lhs contracts its dim 1)."""
    def probe(dev, rng):
        a = bf16_input(rng, shape_lhs, dev)
        b = bf16_input(rng, shape_rhs, dev)
        K, N = shape_rhs
        if len(shape_lhs) == 3:
            batch, _, M = shape_lhs
            form = GemmForm("cols", M=M, K=K, batch=batch, lda=M)
            library = lambda: torch.matmul(a.transpose(1, 2), b)  # noqa: E731
        else:
            M = shape_lhs[0]
            form = GemmForm("rows", M=M, K=K, lda=K)
            library = lambda: torch.matmul(a, b)  # noqa: E731
        batch = form.batch
        return gemm_probe(dev, lambda: tile_gemm(a, b, form),
                          lambda: tile_gemm_plain(a, b, form), library,
                          a.numel() * 2 + b.numel() * 2, 2 * batch * M * N * K)
    return probe


PROBES = {
    "dma_sub328_lane112": dma_probe(20, 328, 112),
    "dma_sub322_lane112": dma_probe(20, 322, 112),
    "dma_sub328_lane28": dma_probe(20, 328, 28),
    "dma_sub328_lane128": dma_probe(20, 328, 128),
    "vmem_subshift1": relayout_probe((8, 328, 128), Layout("slice", rows=320, chans=128, row=1),
                                     lambda x: x[:, 1:321].clone()),
    "vmem_subshift2": relayout_probe((8, 328, 128), Layout("slice", rows=320, chans=128, row=2),
                                     lambda x: x[:, 2:322].clone()),
    "lane_store_cg28": relayout_probe((8, 328, 28), taps(), lane_taps_cat),
    "lane_store_cg32": relayout_probe((8, 328, 32), taps(), lane_taps_cat),
    "lane_read_off28": relayout_probe((8, 320, 112), Layout("slice", rows=320, chans=28, ch=28),
                                      lambda x: x[:, :, 28:56].clone()),
    "roll_lane": relayout_probe((8, 128, 384), Layout("roll", shift=1),
                                lambda x: torch.roll(x, 1, 2)),
    "sublane_store_t32": relayout_probe((32, 384), Layout("tile", taps=9),
                                        lambda x: x.repeat(9, 1)),
    "mm_R8_288x384_168": mm_probe((8, 288, 384), (288, 168)),
    "mm_R16_288x384_168": mm_probe((16, 288, 384), (288, 168)),
    "mm_2560x252_168": mm_probe((2560, 252), (252, 168)),
}


def main(argv=None) -> int:
    return _main(PROBES, argv, __doc__.split("\n\n")[0])


if __name__ == "__main__":
    sys.exit(main())
