"""Hopper probes, round 2: the port's counterpart of the JAX package's
second Mosaic probe tool (``tools/exp_mosaic_probe2.py``), under its probe
names, shapes and dtypes.

    python -m vmg_tpu_torch.tools.exp_probe2 [--device cuda|cpu]

Can an im2col patch be assembled in on-chip memory (``lane_store_*``,
``lane_concat_cg28``), and how does one stage-0 conv tile (R = 8 rows x
W = 320 columns, cg = 28 input and fg = 168 output channels of one group)
run as one deep product over the assembled patch (``tile_assembled_s28``,
``_s32``: K = 252 or 288, taps at channel stride 28 or 32), as nine
accumulated shallow products (``tile_accum_taps``: K = 28 each) or as
three dy products over 128 packed channels (``tile_3dot_K128``)?  Output
as in ``exp_probe``; a tile probe on the card also runs the same tile on
every SM at once (``ms_all_sms``, ``tf_s_all_sms``), the rate a conv
kernel's tiles would see.  The library call of the conv tiles is one
``F.conv2d`` of the same function; the assembled tiles also give
``matmul_ms``, ``torch.matmul`` of the patch formed beforehand.

``tile_assembled_s32`` writes zeros in the four patch channels past each
tap's 28: the TPU kernel left them unwritten, so it multiplied whatever
its scratch held.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from vmg_tpu_torch.ops.probes import GemmForm, tile_gemm, tile_gemm_plain
from vmg_tpu_torch.tools._probing import ITERS, bf16_input, gemm_probe, main as _main
from vmg_tpu_torch.utils.profiling import timed
from vmg_tpu_torch.tools.exp_probe import lane_taps_cat, relayout_probe, taps

R, W, CG, FG = 8, 320, 28, 168  # the stage-0 tile: rows, columns, group channels in/out


def conv_library(x, w_oihw):
    """One PyTorch call for the tile: the valid 3x3 conv of x's first cg
    channels (NCHW view of the HWC slab)."""
    xs, wc = x[:, :W + 2, :CG].permute(2, 0, 1)[None], w_oihw.contiguous()
    return lambda: F.conv2d(xs, wc)


def tile_probe(form_of, w_shape, w_oihw):
    """The stage-0 tile with the A operand in ``form_of``'s form; an
    assembled tile is also timed as ``torch.matmul`` of its patch
    (``matmul_ms``: the product alone, the patch formed beforehand)."""
    def probe(dev, rng):
        x = bf16_input(rng, (R + 2, 328, 128), dev)
        w = bf16_input(rng, w_shape, dev, scale=0.05)
        form = form_of()
        res = gemm_probe(dev, lambda: tile_gemm(x, w, form),
                         lambda: tile_gemm_plain(x, w, form),
                         conv_library(x, w_oihw(w)),
                         (R + 2) * (W + 2) * CG * 2 + w.numel() * 2, 2 * R * W * FG * 9 * CG,
                         all_sms=lambda reps: tile_gemm(x, w, form, reps=reps))
        if form.kind == "assembled":
            patch = form.operands(x)[0][0].contiguous()
            res["matmul_ms"] = (timed(lambda: torch.matmul(patch, w), iters=ITERS) * 1e3
                                if dev.type == "cuda" else None)
        return res
    return probe


def assembled(stride):
    return tile_probe(
        lambda: GemmForm("assembled", M=R * W, K=9 * stride, Wo=W, Cx=128, cg=CG,
                         stride=stride),
        (9 * stride, FG),
        lambda w: w.reshape(3, 3, stride, FG)[:, :, :CG].permute(3, 2, 0, 1))


def tile_3dot(dev, rng):
    """Three dy products over 128 contiguous channels, a stand-in for
    (dx, c)-packed lanes as the TPU tool timed it."""
    x = bf16_input(rng, (R + 2, W, 128), dev)
    w = bf16_input(rng, (3, 128, FG), dev, scale=0.05)
    form = GemmForm("rows", M=R * W, K=128, taps=3, lda=128, tap_stride=W * 128)
    xs, wk = x.permute(2, 0, 1)[None], w.permute(2, 1, 0)[..., None].contiguous()
    return gemm_probe(dev, lambda: tile_gemm(x, w, form), lambda: tile_gemm_plain(x, w, form),
                      lambda: F.conv2d(xs, wk), x.numel() * 2 + w.numel() * 2,
                      2 * R * W * FG * 3 * 128,
                      all_sms=lambda reps: tile_gemm(x, w, form, reps=reps))


PROBES = {
    "lane_store_cg28": relayout_probe((8, 328, 28), taps(), lane_taps_cat),
    "lane_store_cg32": relayout_probe((8, 328, 32), taps(), lane_taps_cat),
    "lane_store_cg128": relayout_probe((8, 328, 128), taps(), lane_taps_cat),
    "lane_concat_cg28": relayout_probe((8, 328, 28), taps(), lane_taps_cat),
    "tile_assembled_s28": assembled(28),
    "tile_assembled_s32": assembled(32),
    "tile_accum_taps": tile_probe(
        lambda: GemmForm("taps", M=R * W, K=CG, taps=9, Wo=W, Cx=128),
        (9, CG, FG), lambda w: w.reshape(3, 3, CG, FG).permute(3, 2, 0, 1)),
    "tile_3dot_K128": tile_3dot,
}


def main(argv=None) -> int:
    return _main(PROBES, argv, __doc__.split("\n\n")[0])


if __name__ == "__main__":
    sys.exit(main())
