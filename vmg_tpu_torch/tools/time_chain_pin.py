"""The bf16 conv chain, the layout pin, the grouped-conv FFN, the MorphFC
combine and axes kernels, LTAM attention and the probe kernels of two
checkouts of the port, timed on one card with one timer.

    python -m vmg_tpu_torch.tools.time_chain_pin --other DIR [--reps 5]

DIR is the root of another checkout of this repo (e.g. an earlier commit
unpacked with ``git archive``).  Four processes run in turn, DIR, this
checkout, this checkout, DIR, each importing ``vmg_tpu_torch`` (and
building its kernels) from its own root but timing with this checkout's
``utils/profiling.timed``; each also times with the timer it replaced
(CUDA events around back-to-back calls, the stream not held behind a
sleep), which under ~0.05 ms partly times the host's launch rate.  At the
serving path's shapes, bf16, seeded inputs: ``fused_conv_chain`` on one
1x184x320x112 trajectory resblock (residual 0.1) and on the 16-frame RCAB
branch with its sums, the module form's two cuDNN convolutions beside
each, ``layout_pin`` on 1x184x320x224 and ``x.clone()`` beside it, and
``fused_group_ffn`` at FULL_PRESET's four stage shapes (16 frames: 184x320
x 112, 92x160 x 224, 46x80 x 224, 23x40 x 448; groups 4, hidden 6C) and the
few-levels preset's two (32 frames: 128x128 and 64x64 x 144, groups 1,
hidden 2C), each tree on its own packed operands, with the module form
beside each (``ffn_module_*``: cuDNN grouped conv, GELU, ``F.linear``);
the MorphFC combine (tanh gate, folded residual) at
the same five shapes (C = 112, 224, 224, 448, 144), on its tree's Pk
operand; the LTAM forward at the stage-0 shape (1x184x320x112) at K = 1..5
with its sum over a FULL_PRESET clip's 60 launches (12 at each K), and at
the few-levels head width (1x128x128x144, d = 36, K = 3); the backward at
the training crop (1x64x64x112) at K = 1..5 with its sum over a training
step's 60 launches, and at d = 36 (1x64x64x144, K = 3), with bf16 keys and
values; the axes kernel's big form at stages 0/6 (16x184x320x112,
chunk 8); its token form at stages 1/5 (16x92x160x224, chunk 16) and 3
(16x23x40x448, chunk 8), with the 'hybrid' form those stages run beside
it (the module's axis FCs, then the reduce); and the reduce at every
shape it runs (FULL_PRESET's stages 1/5, 2/4 and 3, the few-levels
preset's 32x128x128 and 32x64x64 at C = 144) and at stages 0/6
(16x184x320x112, the kernel table's continuity row), with its sum over a
clip (``reduce_per_clip``: 8, 4 and 2 launches; ``reduce_per_clip_few``:
8 and 4).  The probe kernels at every probe of the two probe tools that
runs them: the slab copy at the four ``dma_*`` shapes beside ``clone``
(``slab_copy_<probe>``), the relayout at its eight distinct probes (the
eleven entries of the two tools) beside the probe's own PyTorch call
(``smem_relayout_<probe>``: ``clone`` of a slice, ``cat``, ``roll``,
``repeat``; and each call behind an empty launch, ``after_empty``, which
no launch overlaps), the tile GEMM at the three ``mm_*`` products
beside ``torch.matmul`` and the four stage-0 conv tiles beside ``F.conv2d``
(``tile_gemm_<probe>``; the s28 tile also beside ``torch.matmul`` of its
assembled patch), each conv tile also on every SM at once
(``..._all_sms``); and an empty launch (``empty_launch``,
``torch.cuda._sleep(0)``), the floor under these microsecond kernels.
Each kernel is first held to its own tree's plain version (1e-2 of
max|plain|, the pin, the slab copy and the relayout exactly, the tile
GEMM 1 bf16 ulp; LTAM's f32 output and dq 1e-4; the f32 sums 1e-6 of the
sum of their terms' magnitudes).  One JSON line per process (median and range over
``--reps`` timings of 20 calls each), then the card's name and power
limit, then one JSON line of this checkout's median over the other's for
each timing.  ``--only reduce,token`` (key prefixes) times just those
kernels: a quick check (``--only slab_copy,smem_relayout,tile_gemm,empty``:
the probes).

``--dtype float32`` times the float32 kernels the evaluation path runs
instead (``f32_*`` keys, TF32 off unless named): ``fused_group_ffn`` at the
evaluator's four 16x128x128 tile shapes, FULL_PRESET's four stage shapes
and 16x128x128x144 at groups 1 (erf GELU, as evaluation runs it), each
beside the module form with TF32 off (``f32_ffn_module_*``) and with
cuDNN's default TF32 on (``f32_ffn_module_tf32_*``, as the evaluation
command runs its convolutions), and the axes kernel's big form at
16x128x128x112 and 16x184x320x112 (chunk 8) beside the 'hybrid' form
(``f32_hybrid_*``), its token form at FULL_PRESET's stages 1/5 and 3
(``f32_token_*``) beside the 'hybrid' form (``f32_token_hybrid_*``;
``--only f32_token`` times just these); the combine (tanh, folded residual) at the eval tile's
four shapes and 16x184x320x112 beside its plain version
(``f32_combine_plain_*``), on the Pk operand its tree's kernel takes; the
conv chain on one resblock (1x184x320x112 and 1x128x128x112, residual
0.1) and on the 16-frame RCAB branch with its sums (16x184x320x112)
beside the module form with TF32 off (``f32_chain_module_*``) and with
cuDNN's default TF32 (``f32_chain_module_tf32_*``); each kernel held to
5e-5 of max|plain| (the sums 1e-6 of the sum of their terms' magnitudes).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]
_ITERS = 20
# ((N, H, W, C), groups, hidden ratio) of the FFN's path shapes
FFN_SHAPES = [((16, 184, 320, 112), 4, 6), ((16, 92, 160, 224), 4, 6),
              ((16, 46, 80, 224), 4, 6), ((16, 23, 40, 448), 4, 6),
              ((32, 128, 128, 144), 1, 2), ((32, 64, 64, 144), 1, 2),
              # the evaluator's 128x128 tiles of 16 frames: stages 0/6, 1/5,
              # 2/4 and 3
              ((16, 128, 128, 112), 4, 6), ((16, 64, 64, 224), 4, 6),
              ((16, 32, 32, 224), 4, 6), ((16, 16, 16, 448), 4, 6)]


# (N, H, W, C) of the combine: FULL_PRESET's stages 0/6, 1/5, 2/4, 3 and the
# few-levels preset
COMBINE_SHAPES = [(16, 184, 320, 112), (16, 92, 160, 224), (16, 46, 80, 224),
                  (16, 23, 40, 448), (16, 128, 128, 144)]
# (H, W, head width, K) of the LTAM forward and backward timings
LTAM_CASES = [(184, 320, 28, K) for K in range(1, 6)] + [(128, 128, 36, 3)]
LTAM_BWD_CASES = [(64, 64, 28, K) for K in range(1, 6)] + [(64, 64, 36, 3)]
# (N, H, W, C, chunk) of the axes kernel: FULL_PRESET's stages 0/6
AXES_SHAPE = (16, 184, 320, 112, 8)
# --dtype float32: the FFN at the evaluator's tile shapes, FULL_PRESET's
# stage shapes and the groups-1 width; the axes at the eval tile's stage 0
# and FULL_PRESET's
F32_FFN_SHAPES = FFN_SHAPES[6:] + FFN_SHAPES[:4] + [((16, 128, 128, 144), 1, 2)]
F32_AXES_SHAPES = [(16, 128, 128, 112, 8), AXES_SHAPE]
# the combine at the eval tile's four stage shapes and FULL_PRESET's stage 0;
# the chain (N, H, W, C, kwargs): one trajectory resblock at FULL_PRESET's
# frame and at the eval tile's (residual 0.1), the 16-frame RCAB branch
# with its sums
F32_COMBINE_SHAPES = [s for s, _, _ in FFN_SHAPES[6:]] + [COMBINE_SHAPES[0]]
F32_CHAIN_CASES = [("n1", (1, 184, 320, 112), dict(res_scale=0.1)),
                   ("n1_128x128", (1, 128, 128, 112), dict(res_scale=0.1)),
                   ("n16", (16, 184, 320, 112), dict(emit_psum=True))]
# (N, H, W, C, chunk) of the token form: FULL_PRESET's stages 1/5 and 3
TOKEN_SHAPES = [(16, 92, 160, 224, 16), (16, 23, 40, 448, 8)]
# (N, H, W, C) of the reduce and its launches per clip: FULL_PRESET's
# stages 1/5, 2/4 and 3 ('hybrid' mixers), the few-levels preset's two
# resolutions (32 frames, C = 144), and stages 0/6 (the 'full' form runs
# there: a continuity row, no launches)
REDUCE_SHAPES = [((16, 92, 160, 224), 8), ((16, 46, 80, 224), 4), ((16, 23, 40, 448), 2),
                 ((32, 128, 128, 144), 8), ((32, 64, 64, 144), 4), ((16, 184, 320, 112), 0)]
REDUCE_FEW = {(32, 128, 128, 144), (32, 64, 64, 144)}
# the probes of the two probe kernels, under the probe tools' names: the
# slab copy's (H2, Wp, C) of a (2, H2, Wp, C) input, six-row slabs
SLAB_PROBES = {"dma_sub328_lane112": (20, 328, 112), "dma_sub322_lane112": (20, 322, 112),
               "dma_sub328_lane28": (20, 328, 28), "dma_sub328_lane128": (20, 328, 128)}
# the tile GEMM's: mm_* (lhs, rhs shapes; a 3-D lhs contracts its dim 1)
# and the stage-0 conv tile (R = 8 rows x W = 320, cg = 28 in, fg = 168
# out) in its four A forms
MM_PROBES = {"mm_R8_288x384_168": ((8, 288, 384), (288, 168)),
             "mm_R16_288x384_168": ((16, 288, 384), (288, 168)),
             "mm_2560x252_168": ((2560, 252), (252, 168))}
TILE_PROBES = ("tile_assembled_s28", "tile_assembled_s32", "tile_accum_taps", "tile_3dot_K128")
# the relayout's distinct probes: (input shape, the Layout's fields, the
# probe's PyTorch call as a function of (x, torch), the probe-tool entries
# it stands for); the tile probe's 2-D (32, 384) input as one frame
RELAYOUT_PROBES = {
    "vmem_subshift1": ((8, 328, 128), dict(kind="slice", rows=320, chans=128, row=1),
                       lambda x, torch: x[:, 1:321].clone(), ("exp_probe.vmem_subshift1",)),
    "vmem_subshift2": ((8, 328, 128), dict(kind="slice", rows=320, chans=128, row=2),
                       lambda x, torch: x[:, 2:322].clone(), ("exp_probe.vmem_subshift2",)),
    "lane_store_cg28": ((8, 328, 28), dict(kind="taps", rows=320, taps=9),
                        lambda x, torch: torch.cat([x[:, t:t + 320] for t in range(9)], -1),
                        ("exp_probe.lane_store_cg28", "exp_probe2.lane_store_cg28",
                         "exp_probe2.lane_concat_cg28")),
    "lane_store_cg32": ((8, 328, 32), dict(kind="taps", rows=320, taps=9),
                        lambda x, torch: torch.cat([x[:, t:t + 320] for t in range(9)], -1),
                        ("exp_probe.lane_store_cg32", "exp_probe2.lane_store_cg32")),
    "lane_store_cg128": ((8, 328, 128), dict(kind="taps", rows=320, taps=9),
                         lambda x, torch: torch.cat([x[:, t:t + 320] for t in range(9)], -1),
                         ("exp_probe2.lane_store_cg128",)),
    "lane_read_off28": ((8, 320, 112), dict(kind="slice", rows=320, chans=28, ch=28),
                        lambda x, torch: x[:, :, 28:56].clone(), ("exp_probe.lane_read_off28",)),
    "roll_lane": ((8, 128, 384), dict(kind="roll", shift=1),
                  lambda x, torch: torch.roll(x, 1, 2), ("exp_probe.roll_lane",)),
    "sublane_store_t32": ((1, 32, 384), dict(kind="tile", taps=9),
                          lambda x, torch: x.repeat(1, 9, 1), ("exp_probe.sublane_store_t32",)),
}


def ffn_key(shape, groups, kind="ffn") -> str:
    return f"{kind}_" + "x".join(map(str, shape)) + f"_g{groups}"


def combine_key(shape) -> str:
    return "combine_" + "x".join(map(str, shape))


def ltam_key(h, w, d, K, kind="ltam") -> str:
    return f"{kind}_{h}x{w}_d{d}_k{K}"


def axes_key() -> str:
    return "axes_" + "x".join(map(str, AXES_SHAPE[:4]))


def token_key(shape, kind="token") -> str:
    return f"{kind}_" + "x".join(map(str, shape[:4])) + f"_c{shape[4]}"


def reduce_key(shape) -> str:
    return "reduce_" + "x".join(map(str, shape))


def _this_profiling():
    """This checkout's ``utils/profiling`` (``timed``, ``bound``), loaded
    from its file whatever tree the process imports ``vmg_tpu_torch``
    from."""
    spec = importlib.util.spec_from_file_location(
        "_this_profiling", _ROOT / "vmg_tpu_torch" / "utils" / "profiling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _unfenced(fn, iters, warmup=3):
    """Seconds per call: CUDA events around ``iters`` back-to-back calls,
    with no sleep ahead of them (the timer ``timed`` replaced)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _import_tree(root: Path):
    """Imports ``vmg_tpu_torch`` from the checkout at ``root``; returns its
    package directory.  Raises if another checkout's package was imported
    or there is no CUDA device."""
    sys.path.insert(0, str(root))
    import torch

    import vmg_tpu_torch

    pkg = Path(vmg_tpu_torch.__file__).resolve().parent
    if pkg != root.resolve() / "vmg_tpu_torch":
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("time_chain_pin times the card and needs a CUDA device")
    return pkg


def _timers(reps: int, only):
    """time_both(fn): median and range of ``reps`` timings of ``_ITERS``
    calls with this checkout's ``timed`` and with the timer it replaced;
    wanted(*keys): whether a key starts with one of ``only``."""
    timed = _this_profiling().timed

    def time_both(fn):
        new = [timed(fn, iters=_ITERS, warmup=3) * 1e3 for _ in range(reps)]
        old = [_unfenced(fn, _ITERS) * 1e3 for _ in range(reps)]
        return {"ms": statistics.median(new), "range": [min(new), max(new)],
                "ms_unfenced": statistics.median(old),
                "range_unfenced": [min(old), max(old)]}

    def wanted(*prefixes):
        return only is None or any(p.startswith(o) for p in prefixes for o in only)

    return time_both, wanted


def _side(root: Path, reps: int, only=None) -> dict:
    """Times the kernels with the package at ``root`` (those whose keys
    start with one of ``only``, if given); raises if a kernel disagrees
    with its plain version."""
    pkg = _import_tree(root)
    import torch
    import torch.nn.functional as F

    from vmg_tpu_torch.ops import conv_chain, group_conv, ltam_attention, morphfc_fused

    time_both, wanted = _timers(reps, only)
    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dt)

    out = {"tree": str(root), "package": str(pkg)}
    C, h, w = 112, 184, 320
    with torch.no_grad():
        for N, kw in ((1, dict(res_scale=0.1)), (16, dict(emit_psum=True))):
            if not wanted("chain", "module"):
                continue
            x = rn(N, h, w, C)
            wc = [rn(C, C, 3, 3, scale=(9 * C) ** -0.5) for _ in range(2)]
            bc = [rn(C, scale=0.1) for _ in range(2)]
            ops = (*conv_chain.pack_conv_taps(wc[0], bc[0]),
                   *conv_chain.pack_conv_taps(wc[1], bc[1]))
            wcl = [t.contiguous(memory_format=torch.channels_last) for t in wc]
            xc = x.permute(0, 3, 1, 2)

            def chain():
                return conv_chain.fused_conv_chain(x, *ops, **kw)

            def module():
                y = F.conv2d(F.relu(F.conv2d(xc, wcl[0], bc[0], padding=1)), wcl[1], bc[1],
                             padding=1).permute(0, 2, 3, 1)
                return x + 0.1 * y if "res_scale" in kw else y

            got, want = chain(), conv_chain.conv_chain_plain(x, *ops, **kw)
            got, want = (got[0], want[0]) if N > 1 else (got, want)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= 1e-2 * want.float().abs().max().item():
                raise AssertionError(f"chain N={N}: max_abs_err {err} against the plain version")
            out[f"chain_n{N}"] = {**time_both(chain), "max_abs_err": err}
            out[f"module_n{N}"] = time_both(module)
            del x, xc, ops, wc, wcl, got, want
        if wanted("pin", "clone"):
            x = rn(1, h, w, 2 * C)
            if not torch.equal(conv_chain.layout_pin(x), x):
                raise AssertionError("the pin's copy differs from its input")
            out["pin"] = time_both(lambda: conv_chain.layout_pin(x))
            out["clone"] = time_both(lambda: x.clone())
            del x
        for (N, h, w, C), G, ratio in FFN_SHAPES:
            if not wanted(ffn_key((N, h, w, C), G), ffn_key((N, h, w, C), G, "ffn_module")):
                continue
            Fh = ratio * C
            x = rn(N, h, w, C)
            w1 = rn(Fh, C // G, 3, 3, scale=(9 * C / G) ** -0.5)
            b1, b2, w2 = rn(Fh, scale=0.1), rn(C, scale=0.1), rn(C, Fh, scale=0.02)
            args = (x, *group_conv.pack_ffn_weights(w1, b1, w2, G), b2)

            def ffn():
                return group_conv.fused_group_ffn(*args, groups=G, act="tanh")

            got, want = ffn(), group_conv.group_ffn_plain(*args, groups=G, act="tanh")
            err = (got.float() - want.float()).abs().max().item()
            if not err <= 1e-2 * want.float().abs().max().item():
                raise AssertionError(f"FFN {(N, h, w, C)}: max_abs_err {err} against the plain "
                                     "version")
            out[ffn_key((N, h, w, C), G)] = {**time_both(ffn), "max_abs_err": err}
            # the module form (what training runs): cuDNN grouped conv on a
            # channels-last view, GELU, fc2
            xc, w1c = x.permute(0, 3, 1, 2), w1.contiguous(memory_format=torch.channels_last)

            def module():
                y = F.conv2d(xc, w1c, b1, padding=1, groups=G).permute(0, 2, 3, 1)
                return F.linear(group_conv.gelu(y, "tanh"), w2, b2)

            out[ffn_key((N, h, w, C), G, "ffn_module")] = time_both(module)
            del x, xc, w1c, args, got, want

        def held(name, got, want, rel):
            err = (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
            if not err <= rel:
                raise AssertionError(f"{name}: max_rel_err {err} against the plain version")
            return err

        # the combine at every path shape (tanh gate, folded residual), on
        # the Pk operand its tree's bf16 kernel takes (a tree with
        # pack_combine_weight takes the B image)
        pack = getattr(morphfc_fused, "pack_combine_weight", lambda pk: pk)
        for N, hc, wc, C in COMBINE_SHAPES if wanted("combine") else ():
            x, xh, xw, xc, res = (rn(N, hc, wc, C) for _ in range(5))
            a = torch.softmax(torch.randn(N, 3, C, generator=gen, device=dev), dim=1).to(dt)
            pk, pb = rn(C, C, scale=0.02), torch.randn(C, generator=gen, device=dev) * 0.1
            cargs, pargs = (x, xh, xw, xc, a, pack(pk), pb), (x, xh, xw, xc, a, pk, pb)
            err = held("combine", morphfc_fused.fused_morphfc_combine(*cargs, residual=res),
                       morphfc_fused.morphfc_combine_plain(*pargs, residual=res), 1e-2)
            out[combine_key((N, hc, wc, C))] = {**time_both(
                lambda: morphfc_fused.fused_morphfc_combine(*cargs, residual=res)),
                "max_rel_err": err}
            del x, xh, xw, xc, res, cargs, pargs
        def held_sums(name, got, want, terms):
            err = ((got - want).abs() / terms).max().item()
            if not err <= 1e-6:
                raise AssertionError(f"{name}: sums off by {err} of sum|terms|")
            return err

        # the axes kernel: the big form at stages 0/6 (both branches at
        # chunk 8), the token form at stages 1/5 and 3 next to the 'hybrid'
        # form; the decayed weights as the module packs them (C_in, C_out)
        from vmg_tpu_torch.models.blocks import _axis_mix

        for (N, hh, ww, C, ck), form in [(AXES_SHAPE, "big")] + [
                (shape, "token") for shape in TOKEN_SHAPES]:
            key = axes_key() if form == "big" else token_key((N, hh, ww, C, ck))
            if not wanted(key.split("_")[0], "hybrid"):
                continue
            x, xc = rn(N, hh, ww, C), rn(N, hh, ww, C, scale=0.01)
            kh, kw = rn(C, C, scale=0.02), rn(C, C, scale=0.02)
            bh, bw = (torch.randn(C, generator=gen, device=dev) * 0.1 for _ in range(2))
            aargs = (x, xc, kh, bh, kw, bw)

            def axes():
                return morphfc_fused.fused_morphfc_axes(*aargs, chunk_h=ck, chunk_w=ck, form=form)

            got = axes()
            ref = morphfc_fused.morphfc_axes_plain(*aargs, chunk_h=ck, chunk_w=ck)
            terms = sum(v.float().abs().sum(dim=(1, 2)) for v in (ref[0], ref[1], xc))
            err = max(held("axes h", got[0], ref[0], 1e-2), held("axes w", got[1], ref[1], 1e-2))
            out[key] = {**time_both(axes), "max_rel_err": err,
                        "sums_rel_err": held_sums("axes psum", got[2], ref[2], terms)}
            if form == "token":
                def hybrid():
                    hb = _axis_mix(x, kh, bh.to(dt), ck, 1).contiguous()
                    wb = _axis_mix(x, kw, bw.to(dt), ck, 2).contiguous()
                    return morphfc_fused.fused_morphfc_reduce(hb, wb, xc)

                out[token_key((N, hh, ww, C, ck), "hybrid")] = time_both(hybrid)
            del x, xc, aargs, got, ref
        # the reduce at each shape it runs, f32 sums of three bf16 tensors
        for shape, _ in REDUCE_SHAPES if wanted("reduce") else ():
            xh, xw, xc = (rn(*shape) for _ in range(3))
            terms = sum(v.float().abs().sum(dim=(1, 2)) for v in (xh, xw, xc))
            err = held_sums("reduce", morphfc_fused.fused_morphfc_reduce(xh, xw, xc),
                            morphfc_fused.morphfc_reduce_plain(xh, xw, xc), terms)
            out[reduce_key(shape)] = {**time_both(
                lambda: morphfc_fused.fused_morphfc_reduce(xh, xw, xc)), "sums_rel_err": err}
            del xh, xw, xc
        if wanted("reduce"):
            # device time per clip: FULL_PRESET's 14 launches, the few-levels 12
            for name, few in (("reduce_per_clip", False), ("reduce_per_clip_few", True)):
                out[name] = {t: sum(k * out[reduce_key(s)][t] for s, k in REDUCE_SHAPES
                                    if (s in REDUCE_FEW) == few)
                             for t in ("ms", "ms_unfenced")}
        # the LTAM forward at the stage-0 shape at K = 1..5 and at the
        # few-levels head width (d = 36, 1x128x128, K = 3); the backward at
        # the training crop 1x64x64 at K = 1..5 and at d = 36, K = 3
        for (hh, ww, C, heads), Ks in (((184, 320, 112, 4), (1, 2, 3, 4, 5)),
                                       ((128, 128, 144, 4), (3,)),
                                       ((64, 64, 112, 4), (1, 2, 3, 4, 5)),
                                       ((64, 64, 144, 4), (3,))) if wanted("ltam") else ():
            for K in Ks:
                q = torch.nn.functional.normalize(
                    torch.randn(1, hh, ww, C, generator=gen, device=dev), dim=-1) * \
                    (C // heads) ** -0.5
                kv = rn(1, hh, ww, K * 2 * C)
                pe = torch.exp(torch.randn(K, 4, 4, heads, generator=gen, device=dev) * 0.02)
                if hh != 64:
                    err = held("ltam", ltam_attention.ltam_attention_2x2(q, kv, pe, K=K, heads=heads),
                               ltam_attention.ltam_attention_plain(q, kv, pe, K=K, heads=heads),
                               1e-4)
                    out[ltam_key(hh, ww, C // heads, K)] = {**time_both(
                        lambda: ltam_attention.ltam_attention_2x2(q, kv, pe, K=K, heads=heads)),
                        "max_rel_err": err}
                    continue
                g = torch.randn(1, hh, ww, C, generator=gen, device=dev)
                o, den = ltam_attention.ltam_fwd(q, kv, pe, K=K, heads=heads, with_den=True)

                def bwd():
                    return ltam_attention.ltam_attention_2x2_bwd(q, kv, pe, den, o, g, K=K,
                                                                 heads=heads)

                want = ltam_attention.ltam_attention_bwd_plain(q, kv, pe, g, K=K, heads=heads)
                err = held("ltam_bwd", bwd()[0], want[0], 1e-4)  # dq (dkv bf16, dpe summed)
                out[ltam_key(hh, ww, C // heads, K, "ltam_bwd")] = {**time_both(bwd),
                                                                   "max_rel_err": err}
        # device time per FULL_PRESET clip (forward) and training step
        # (backward): 12 launches at each K
        if wanted("ltam"):
            out["ltam_per_clip"] = {
                t: 12 * sum(out[ltam_key(184, 320, 28, K)][t] for K in range(1, 6))
                for t in ("ms", "ms_unfenced")}
            out["ltam_bwd_per_step"] = {
                t: 12 * sum(out[ltam_key(64, 64, 28, K, "ltam_bwd")][t] for K in range(1, 6))
                for t in ("ms", "ms_unfenced")}
        if wanted("empty"):  # the floor under a microsecond-scale kernel
            out["empty_launch"] = time_both(lambda: torch.cuda._sleep(0))
        if wanted("slab_copy", "tile_gemm", "smem_relayout"):
            out.update(_probe_times(_this_profiling().bound, time_both, rn, dev, wanted))
    return out


def _probe_times(bound, time_both, rn, dev, wanted) -> dict:
    """The slab copy and the tile GEMM at every probe of the probe tools
    (keys ``slab_copy_<probe>``, ``tile_gemm_<probe>``), each held to its
    tree's plain version (copies exactly, products within 1 bf16 ulp of
    max|plain|) and timed beside its PyTorch call (``library``), with its
    bound; the conv tiles also on every SM at once (``..._all_sms``, every
    copy equal to the single tile) and the s28 tile also beside
    ``torch.matmul`` of its assembled patch (``library_matmul``)."""
    import torch
    import torch.nn.functional as F

    from vmg_tpu_torch.ops import probes
    from vmg_tpu_torch.tools import exp_probe

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    out = {}
    for name, (shape, fields, lib, covers) in RELAYOUT_PROBES.items() \
            if wanted("smem_relayout") else ():
        x, layout = rn(*shape), probes.Layout(**fields)
        got, want = probes.smem_relayout(x, layout), probes.relayout_plain(x, layout)
        if not torch.equal(got, want):
            raise AssertionError(f"relayout {name}: not bit-exact")
        read = exp_probe.read_bytes(x, layout)
        out[f"smem_relayout_{name}"] = {
            **time_both(lambda: probes.smem_relayout(x, layout)), "max_abs_err": 0.0,
            "library": time_both(lambda: lib(x, torch)), "probes": list(covers),
            "after_empty": time_both(lambda: (torch.cuda._sleep(0),
                                              probes.smem_relayout(x, layout))),
            **bound(read + nbytes(want), 0)}
    for name, (H2, Wp, C) in SLAB_PROBES.items() if wanted("slab_copy") else ():
        x = rn(2, H2, Wp, C)
        got, want = probes.slab_copy(x), probes.slab_copy_plain(x)
        if not torch.equal(got, want):
            raise AssertionError(f"slab copy {name}: not bit-exact")
        out[f"slab_copy_{name}"] = {
            **time_both(lambda: probes.slab_copy(x)), "library_call": "clone",
            "library": time_both(lambda: x[0, 1:9].clone()), **bound(2 * nbytes(want), 0)}
    if not wanted("tile_gemm"):
        return out
    R, W, CG, FG = 8, 320, 28, 168
    cases = {}
    for name, (sa, sb) in MM_PROBES.items():
        a, b = rn(*sa), rn(*sb)
        if len(sa) == 3:
            form = probes.GemmForm("cols", M=sa[2], K=sb[0], batch=sa[0], lda=sa[2])
            lib = (lambda a, b: lambda: torch.matmul(a.transpose(1, 2), b))(a, b)
        else:
            form = probes.GemmForm("rows", M=sa[0], K=sb[0], lda=sb[0])
            lib = (lambda a, b: lambda: torch.matmul(a, b))(a, b)
        cases[name] = (a, b, form, "matmul", lib, nbytes(a, b))
    for name in TILE_PROBES:
        if name == "tile_3dot_K128":
            x, w = rn(R + 2, W, 128), rn(3, 128, FG, scale=0.05)
            form = probes.GemmForm("rows", M=R * W, K=128, taps=3, lda=128, tap_stride=W * 128)
            xs, wk = x.permute(2, 0, 1)[None], w.permute(2, 1, 0)[..., None].contiguous()
            cases[name] = (x, w, form, "conv2d", (lambda xs, wk: lambda: F.conv2d(xs, wk))(
                xs, wk), nbytes(x, w))
            continue
        x = rn(R + 2, 328, 128)
        if name == "tile_accum_taps":
            w = rn(9, CG, FG, scale=0.05)
            form = probes.GemmForm("taps", M=R * W, K=CG, taps=9, Wo=W, Cx=128)
            w_oihw = w.reshape(3, 3, CG, FG).permute(3, 2, 0, 1)
        else:
            stride = int(name[-2:])
            w = rn(9 * stride, FG, scale=0.05)
            form = probes.GemmForm("assembled", M=R * W, K=9 * stride, Wo=W, Cx=128, cg=CG,
                                   stride=stride)
            w_oihw = w.reshape(3, 3, stride, FG)[:, :, :CG].permute(3, 2, 0, 1)
        xs, wc = x[:, :W + 2, :CG].permute(2, 0, 1)[None], w_oihw.contiguous()
        cases[name] = (x, w, form, "conv2d", (lambda xs, wc: lambda: F.conv2d(xs, wc))(xs, wc),
                       (R + 2) * (W + 2) * CG * 2 + nbytes(w))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (a, b, form, call, lib, read) in cases.items():
        got, want = probes.tile_gemm(a, b, form), probes.tile_gemm_plain(a, b, form)
        err = (got.float() - want.float()).abs().max().item()
        if not err <= 8e-3 * want.float().abs().max().item():
            raise AssertionError(f"tile GEMM {name}: max_abs_err {err} over 1 bf16 ulp")
        flops = 2 * form.batch * form.M * b.shape[-1] * form.K * form.taps
        key = f"tile_gemm_{name}"
        out[key] = {**time_both(lambda: probes.tile_gemm(a, b, form)), "max_abs_err": err,
                    "library_call": call, "library": time_both(lib),
                    **bound(read + nbytes(want), flops)}
        out[key]["tf_s"] = flops / out[key]["ms"] / 1e9
        if name == "tile_assembled_s28":
            patch = form.operands(a)[0][0].contiguous()
            out[key]["library_matmul"] = time_both(lambda: torch.matmul(patch, b))
        if name.startswith("tile_"):
            many = probes.tile_gemm(a, b, form, reps=sms)
            if not all(torch.equal(c, got) for c in many):
                raise AssertionError(f"tile GEMM {name}: a copy on {sms} SMs differs")
            del many
            out[f"{key}_all_sms"] = t = {
                **time_both(lambda: probes.tile_gemm(a, b, form, reps=sms)), "reps": sms}
            t["tf_s"] = sms * flops / t["ms"] / 1e9
    return out


def _side_f32(root: Path, reps: int, only=None) -> dict:
    """The float32 timings (``--dtype float32``) with the package at
    ``root``; raises if a kernel disagrees with its plain version."""
    pkg = _import_tree(root)
    import torch
    import torch.nn.functional as F

    from vmg_tpu_torch.models.blocks import _axis_mix
    from vmg_tpu_torch.ops import conv_chain, group_conv, morphfc_fused

    time_both, wanted = _timers(reps, only)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def held(name, got, want):
        err = (got - want).abs().max().item() / want.abs().max().item()
        if not err <= 5e-5:
            raise AssertionError(f"{name}: max_rel_err {err} against the plain version")
        return err

    out = {"tree": str(root), "package": str(pkg)}
    with torch.no_grad():
        for (N, h, w, C), G, ratio in F32_FFN_SHAPES:
            key = ffn_key((N, h, w, C), G, "f32_ffn")
            if not wanted(key, ffn_key((N, h, w, C), G, "f32_ffn_module")):
                continue
            Fh = ratio * C
            x = rn(N, h, w, C)
            w1 = rn(Fh, C // G, 3, 3, scale=(9 * C / G) ** -0.5)
            b1, b2, w2 = rn(Fh, scale=0.1), rn(C, scale=0.1), rn(C, Fh, scale=0.02)
            args = (x, *group_conv.pack_ffn_weights(w1, b1, w2, G), b2)

            def ffn():
                return group_conv.fused_group_ffn(*args, groups=G, act="erf")

            err = held(key, ffn(), group_conv.group_ffn_plain(*args, groups=G, act="erf"))
            out[key] = {**time_both(ffn), "max_rel_err": err}
            xc, w1c = x.permute(0, 3, 1, 2), w1.contiguous(memory_format=torch.channels_last)

            def module():
                y = F.conv2d(xc, w1c, b1, padding=1, groups=G).permute(0, 2, 3, 1)
                return F.linear(group_conv.gelu(y, "erf"), w2, b2)

            out[ffn_key((N, h, w, C), G, "f32_ffn_module")] = time_both(module)
            torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, the CLI's
            out[ffn_key((N, h, w, C), G, "f32_ffn_module_tf32")] = time_both(module)
            torch.backends.cudnn.allow_tf32 = False
            del x, xc, w1c, args
        for N, h, w, C, ck in F32_AXES_SHAPES:
            key = "f32_" + token_key((N, h, w, C, ck), "axes")
            if not wanted(key, "f32_hybrid"):
                continue
            x, xc = rn(N, h, w, C), rn(N, h, w, C, scale=0.01)
            kh, kw = rn(C, C, scale=0.02), rn(C, C, scale=0.02)
            bh, bw = rn(C, scale=0.1), rn(C, scale=0.1)
            aargs = (x, xc, kh, bh, kw, bw)

            def axes():
                return morphfc_fused.fused_morphfc_axes(*aargs, chunk_h=ck, chunk_w=ck)

            got = axes()
            ref = morphfc_fused.morphfc_axes_plain(*aargs, chunk_h=ck, chunk_w=ck)
            terms = sum(v.abs().sum(dim=(1, 2)) for v in (ref[0], ref[1], xc))
            err = max(held("axes h", got[0], ref[0]), held("axes w", got[1], ref[1]))
            serr = ((got[2] - ref[2]).abs() / terms).max().item()
            if not serr <= 1e-6:
                raise AssertionError(f"axes psum: off by {serr} of sum|terms|")
            out[key] = {**time_both(axes), "max_rel_err": err, "sums_rel_err": serr}

            def hybrid():
                hb = _axis_mix(x, kh, bh, ck, 1).contiguous()
                wb = _axis_mix(x, kw, bw, ck, 2).contiguous()
                return morphfc_fused.fused_morphfc_reduce(hb, wb, xc)

            out["f32_" + token_key((N, h, w, C, ck), "hybrid")] = time_both(hybrid)
            del x, xc, aargs, got, ref
        for N, h, w, C, ck in TOKEN_SHAPES:
            key = "f32_" + token_key((N, h, w, C, ck))
            if not wanted(key, "f32_" + token_key((N, h, w, C, ck), "token_hybrid")):
                continue
            x, xc = rn(N, h, w, C), rn(N, h, w, C, scale=0.01)
            kh, kw = rn(C, C, scale=0.02), rn(C, C, scale=0.02)
            bh, bw = rn(C, scale=0.1), rn(C, scale=0.1)
            aargs = (x, xc, kh, bh, kw, bw)

            def token():
                return morphfc_fused.fused_morphfc_axes(*aargs, chunk_h=ck, chunk_w=ck,
                                                        form="token")

            got = token()
            ref = morphfc_fused.morphfc_axes_plain(*aargs, chunk_h=ck, chunk_w=ck)
            terms = sum(v.abs().sum(dim=(1, 2)) for v in (ref[0], ref[1], xc))
            err = max(held("token h", got[0], ref[0]), held("token w", got[1], ref[1]))
            serr = ((got[2] - ref[2]).abs() / terms).max().item()
            if not serr <= 1e-6:
                raise AssertionError(f"token psum: off by {serr} of sum|terms|")
            out[key] = {**time_both(token), "max_rel_err": err, "sums_rel_err": serr}

            def hybrid():
                hb = _axis_mix(x, kh, bh, ck, 1).contiguous()
                wb = _axis_mix(x, kw, bw, ck, 2).contiguous()
                return morphfc_fused.fused_morphfc_reduce(hb, wb, xc)

            out["f32_" + token_key((N, h, w, C, ck), "token_hybrid")] = time_both(hybrid)
            del x, xc, aargs, got, ref
        # the combine (tanh, folded residual) on the Pk operand its tree's f32
        # kernel takes: the packed image where combine_image_shape takes the
        # dtype, else the plain matrix
        try:
            morphfc_fused.combine_image_shape(16, torch.float32)
            pack = morphfc_fused.pack_combine_weight
        except TypeError:
            def pack(pk):
                return pk
        for shape in F32_COMBINE_SHAPES:
            key = "f32_" + combine_key(shape)
            if not wanted(key, "f32_combine_plain"):
                continue
            N, hc, wc, C = shape
            x, xh, xw, xc, res = (rn(*shape) for _ in range(5))
            a = torch.softmax(rn(N, 3, C), dim=1)
            pk, pb = rn(C, C, scale=0.02), rn(C, scale=0.1)
            cargs, pargs = (x, xh, xw, xc, a, pack(pk), pb), (x, xh, xw, xc, a, pk, pb)

            def combine():
                return morphfc_fused.fused_morphfc_combine(*cargs, residual=res)

            def plain():
                return morphfc_fused.morphfc_combine_plain(*pargs, residual=res)

            err = held(key, combine(), plain())
            out[key] = {**time_both(combine), "max_rel_err": err}
            out["f32_combine_plain_" + "x".join(map(str, shape))] = time_both(plain)
            del x, xh, xw, xc, res, cargs, pargs
        # the chain on its tree's packed taps, beside the module form's two
        # cuDNN convolutions with TF32 off and with cuDNN's default TF32
        for label, (N, hc, wc, C), kw in F32_CHAIN_CASES:
            key = f"f32_chain_{label}"
            if not wanted(key, f"f32_chain_module_{label}"):
                continue
            x = rn(N, hc, wc, C)
            wts = [rn(C, C, 3, 3, scale=(9 * C) ** -0.5) for _ in range(2)]
            bc = [rn(C, scale=0.1) for _ in range(2)]
            ops = (*conv_chain.pack_conv_taps(wts[0], bc[0]),
                   *conv_chain.pack_conv_taps(wts[1], bc[1]))
            wcl = [t.contiguous(memory_format=torch.channels_last) for t in wts]
            xcl = x.permute(0, 3, 1, 2)

            def chain():
                return conv_chain.fused_conv_chain(x, *ops, **kw)

            def module():
                y = F.conv2d(F.relu(F.conv2d(xcl, wcl[0], bc[0], padding=1)), wcl[1], bc[1],
                             padding=1).permute(0, 2, 3, 1)
                return x + 0.1 * y if "res_scale" in kw else y

            got, want = chain(), conv_chain.conv_chain_plain(x, *ops, **kw)
            err = held(key, got[0] if N > 1 else got, want[0] if N > 1 else want)
            out[key] = {**time_both(chain), "max_rel_err": err}
            out[f"f32_chain_module_{label}"] = time_both(module)
            torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, the CLI's
            out[f"f32_chain_module_tf32_{label}"] = time_both(module)
            torch.backends.cudnn.allow_tf32 = False
            del x, xcl, ops, wts, wcl, got, want
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="root of the other checkout")
    ap.add_argument("--side", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", help="comma-separated key prefixes to time (default: all)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="float32: the evaluation path's float32 kernels instead")
    args = ap.parse_args(argv)
    only = None if args.only is None else args.only.split(",")
    if args.side is not None:
        side = _side if args.dtype == "bfloat16" else _side_f32
        print(json.dumps(side(args.side, args.reps, only)), flush=True)
        return 0
    if args.other is None:
        ap.error("--other is required")
    runs = []
    for label, root in (("other", args.other), ("this", _ROOT), ("this", _ROOT),
                        ("other", args.other)):
        res = subprocess.run([sys.executable, __file__, "--side", str(root.resolve()),
                              "--reps", str(args.reps), "--dtype", args.dtype]
                             + ([] if only is None else ["--only", args.only]),
                             stdout=subprocess.PIPE, text=True, check=True, timeout=900)
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": label, **line}), flush=True)
        runs.append((label, line))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())
    ratios = {}
    keys = ["chain_n1", "chain_n16", "module_n1", "module_n16", "pin", "clone", axes_key(),
            "ltam_per_clip", "ltam_bwd_per_step"]
    keys += [ffn_key(shape, G, kind) for shape, G, _ in FFN_SHAPES
             for kind in ("ffn", "ffn_module")]
    keys += [combine_key(shape) for shape in COMBINE_SHAPES]
    keys += [ltam_key(*case) for case in LTAM_CASES]
    keys += [ltam_key(*case, "ltam_bwd") for case in LTAM_BWD_CASES]
    keys += [token_key(shape, kind) for shape in TOKEN_SHAPES
             for kind in ("token", "hybrid")]
    keys += [reduce_key(shape) for shape, _ in REDUCE_SHAPES]
    keys += ["reduce_per_clip", "reduce_per_clip_few", "empty_launch"]
    keys += [f"slab_copy_{name}" for name in SLAB_PROBES]
    keys += [f"smem_relayout_{name}" for name in RELAYOUT_PROBES]
    keys += [f"tile_gemm_{name}" for name in (*MM_PROBES, *TILE_PROBES)]
    keys += [f"tile_gemm_{name}_all_sms" for name in TILE_PROBES]
    keys += [ffn_key(shape, G, kind) for shape, G, _ in F32_FFN_SHAPES
             for kind in ("f32_ffn", "f32_ffn_module", "f32_ffn_module_tf32")]
    keys += ["f32_" + token_key(shape, kind) for shape in F32_AXES_SHAPES
             for kind in ("axes", "hybrid")]
    keys += ["f32_" + token_key(shape, kind) for shape in TOKEN_SHAPES
             for kind in ("token", "token_hybrid")]
    keys += [f"f32_{kind}_" + "x".join(map(str, shape)) for shape in F32_COMBINE_SHAPES
             for kind in ("combine", "combine_plain")]
    keys += [f"f32_chain_{kind}{label}" for label, _, _ in F32_CHAIN_CASES
             for kind in ("", "module_", "module_tf32_")]
    for key in (k for k in keys if all(k in r for _, r in runs)):
        for timer in ("ms", "ms_unfenced"):
            med = {s: statistics.median(r[key][timer] for lab, r in runs if lab == s)
                   for s in ("this", "other")}
            ratios[f"{key}.{timer}"] = {**med, "this_over_other": med["this"] / med["other"]}
    print(json.dumps({"this_over_other": ratios}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
