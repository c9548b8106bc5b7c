#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vmg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card name and power limit; build the CUDA kernels from
     vmg_tpu_torch/csrc (one nvcc per source, in parallel) and time it;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of the paths that run it, in float32 (TF32 off) and bf16,
     each timed (CUDA events) next to its plain version and its bound
     (the MorphFC axis-branch kernel also next to the 'hybrid' form it
     replaces at stages 0/6, the conv chain next to the module form's
     cuDNN convolutions, the norm and the pin next to one PyTorch call);
     the LTAM backward at the training shape; the conv chain at both
     path shapes run twice and held bit-equal (outputs and sums), with
     its TFLOP/s, share of the bound and ratio to the module form beside
     its times before the redesign (PERF.md); the FFN likewise at the four
     FULL_PRESET stage shapes and the few-levels shape (16x128x128x144,
     groups 1), next to its module form (cuDNN grouped conv, GELU,
     F.linear); the combine with each gate (tanh, sigmoid, relu), in bf16
     at the four FULL_PRESET stage shapes and the few-levels shape (run
     twice and held bit-equal, its share of the bound beside its time
     before the redesign); the LTAM forward at the stage-0 shape at each
     slot count K = 1..5 with the sum over a clip's 60 launches, then
     forward (1x128x128) and backward (1x64x64) at head widths 36, 64 and
     144; the pin with its GB/s and
     share of the bound; the axis branches' token
     form, first driven through its op entry point (``form="token"``) at
     the stage-1/5 (16x92x160x224, chunk 16) and stage-3 (16x23x40x448,
     chunk 8) shapes, then checked there next to the 'hybrid' form those
     stages run (two runs bit-equal), and against the big form at the
     stage-0 shape;
     the reduce at every shape it runs (FULL_PRESET's stages 1/5, 2/4, 3
     and the few-levels 32x128x128 and 32x64x64 at C = 144) and at stages
     0/6, two runs bit-equal, with its sum over each preset's clip (14 and
     12 launches);
 2p. the probes: every probe of ``vmg_tpu_torch.tools.exp_probe`` and
     ``exp_probe2`` called directly (copies bit-exact, products within 1
     bf16 ulp of max|plain|, the tiles' copies on every SM bit-equal),
     each with its time, bound and one PyTorch call (the assembled tiles
     also beside ``torch.matmul`` of their patch), the three probe kernels
     beside an empty launch's time (the launch floor; every relayout probe
     as its ratio to it) and their times before the redesign; then both
     tools' command lines in-process (exit 0, one JSON line per probe);
  3. slice parity: FULL_PRESET in float32 at 1x2x64x64, kernel path on the
     card against the plain path (CPU tensors) with the same weights;
 3b. the same with the opt-in kernel forms: the RCAB and trajectory conv
     chains against phase 3's plain output, the barrier forms against the
     default forms on the card;
 3c. slice parity of FEW_LEVELS_PRESET (C = 144, LTAM head width 36, FFN
     groups 1), as phase 3;
  4. serving (main path 1): an SRServer on FULL_PRESET in bf16 (tanh GELU,
     bf16 SPyNet convs), seeded random init, 1x16x180x320 clips: one
     warm-up request, then 3 clips x 3 reps, each request timed; the
     output must be finite and (1,16,720,1280,3), every serving kernel's
     launch count over the run must be > 0, the FFN's one a TAB (22 a
     clip), and the opt-in forms' kernels must not launch;
 4b. serving in the kernel forms (main path 3): the same server, weights
     and clips with rcab_impl, traj_conv_impl and norm_impl "kernel": one
     warm-up request, then 3 clips; 968 conv-chain and 50 norm launches
     per clip; its bf16 error at 1x2x64x64 against phase 3's f32 plain
     output at most twice the default form's; then one request in each
     barrier form, which pins 64 times per clip;
 4c. serving the few-levels model (main path 4): FEW_LEVELS_PRESET with
     the eval preset's 32 frames and trajectory window, bf16, 1x32x128x128
     clips: one warm-up request, then 2 clips; finite output of the right
     shape, the LTAM, FFN (12 a clip), reduce and combine kernels launched;
     peak memory;
  5. train-step parity: one float32 FULL_PRESET training step (loss and
     gradients, drop_path 0, remat on) at 1x5x64x64, kernels on the card
     against the plain path on CPU tensors from the same weights;
  6. training (main path 2): the function of ``python -m
     vmg_tpu_torch.train`` on FULL_PRESET -- bf16 compute on float32
     masters, remat on, B=1, T=16, 64x64 crops, seeded data: one warm-up
     step, then timed steps; the losses must be finite and both LTAM
     kernels must have launched;
 6b. the same trainer with norm_impl="kernel": a warm-up step and 2 timed
     steps; finite losses, norm launches, the warm-up loss within 1e-2 of
     phase 6's;
 6c. the trainer on FEW_LEVELS_PRESET (main path 5), B=1, T=6, 64x64
     crops: a warm-up and a timed step; finite losses, the LTAM backward
     launched (head width 36).
Prints a {"kernels": [...]} JSON line (each kernel with its launches on
the path that runs it -- the token form's and the probes' on their entry
points in phases 2/2p, none on the model paths -- its times, its bound and
the library call, if any), the nvidia-smi line, and last {"ok": true,
"device": {...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import subprocess
import sys
import time

import numpy as np
import torch

T, H, W = 16, 180, 320  # bench protocol: REDS4 clip of 16 180x320 frames
# Outputs in the inputs' dtype, relative to the largest plain output.  f32:
# the kernels and plain versions sum in other orders (<= ~1700 terms);
# bf16: both round at the same places, so differences are a few output ulps.
REL_TOL = {torch.float32: 5e-5, torch.bfloat16: 1e-2}
# Outputs that are f32 whatever the inputs (LTAM attention) take the f32
# tolerance in both dtypes; f32 sums over a frame (the reweight sums) are
# held per element to SUM_TOL of the sum of their terms' magnitudes -- a
# sum missing one pixel of a 184x320 frame is off by ~1.7e-5 of it.
SUM_TOL = 1e-6
SLICE_TOL = 1e-3  # f32 full model, cuDNN and kernels vs CPU, output in ~[0, 1]
# The barrier forms run the default forms' arithmetic plus identity copies:
# the same outputs up to cuDNN's run-to-run choices, held at 1e-6 of max|out|.
BARRIER_TOL = 1e-6
# bf16 kernel-form serving: its error against the f32 plain output at most
# KFORM_RATIO x the default bf16 form's; its warm-up training loss within
# TRAIN_LOSS_TOL (relative) of the default form's.
KFORM_RATIO, TRAIN_LOSS_TOL = 2.0, 1e-2
# (width, rows of its first call) of every LayerNorm on the serving path of
# a 1x16x180x320 clip (padded to 184x320): the TABs of stages 0 and 1, the
# down resamplers 0 and 1 (4C), the up resampler 1 (C/4)
NORM_SHAPES = [(112, 16 * 184 * 320), (448, 16 * 92 * 160), (224, 16 * 92 * 160),
               (896, 16 * 46 * 80), (56, 16 * 92 * 160)]
CHAIN_PER_CLIP, NORM_PER_CLIP, PIN_PER_CLIP = 968, 50, 64
# FFN kernel launches a clip, one a TAB at every width: FULL_PRESET's 22,
# the few-levels preset's 12
FFN_PER_CLIP, FEW_FFN_PER_CLIP = 22, 12
# the few-levels serving run: the eval preset's network fields
# (vmg_tpu/configs/presets/vmg_eval_reds4_few_levels.yml: 32 frames, one
# trajectory window over them, no flow freeze) on FEW_LEVELS_PRESET, its
# 128x128 LR tile ('wins'); training at the train preset's 6 frames
FEW_EVAL = dict(num_frames=32, traj_win=(32, None), flow_fix=None)
FEW_T, FEW_HW, FEW_TRAIN_T = 32, 128, 6
# the kernels the few-levels serving path must launch ('hybrid' mixers at
# C = 144: the reduce, then the combine)
FEW_PATH = ("ltam_attention_2x2", "fused_group_ffn", "fused_morphfc_reduce",
            "fused_morphfc_combine")
# the bf16 chain's and the pin's times before their redesign, printed
# beside this run's: PERF.md's, from vmg_tpu_torch/tools/time_chain_pin.py
# with the timer this script uses (H100 80GB HBM3, 700 W); (frames, dtype)
# -> ms
CHAIN_BEFORE_MS = {(1, torch.bfloat16): 0.463, (16, torch.bfloat16): 6.552}
PIN_BEFORE_MS = 0.0187
# the FFN's path shapes: ((N, H, W, C), groups, hidden ratio) of FULL_PRESET's
# stages 0/6, 1/5, 2/4 and 3 (16 frames of a 180x320 clip padded to 184x320)
# and of the few-levels preset (a 128x128 tile, groups 1, mlp_ratio 2)
FFN_SHAPES = [((16, 184, 320, 112), 4, 6), ((16, 92, 160, 224), 4, 6),
              ((16, 46, 80, 224), 4, 6), ((16, 23, 40, 448), 4, 6),
              ((16, 128, 128, 144), 1, 2)]
# the bf16 FFN's times before its redesign (the wmma kernel it replaced), printed
# beside this run's: PERF.md's, medians of vmg_tpu_torch/tools/
# time_chain_pin.py --other (that tree and this one in one call, one
# timer; H100 80GB HBM3, 700 W); shape -> ms
FFN_BEFORE_MS = {(16, 184, 320, 112): 11.129, (16, 92, 160, 224): 10.560,
                 (16, 46, 80, 224): 2.886, (16, 23, 40, 448): 3.503,
                 (16, 128, 128, 144): 4.535}
# the combine's path shapes (N, H, W, C): FULL_PRESET's stages 0/6, 1/5, 2/4
# and 3, and the few-levels preset's (a 128x128 tile, C = 144)
COMBINE_SHAPES = [(16, 184, 320, 112), (16, 92, 160, 224), (16, 46, 80, 224),
                  (16, 23, 40, 448), (16, 128, 128, 144)]
# the bf16 combine's and LTAM forward's times before their redesign, printed
# beside this run's: PERF.md's, medians of vmg_tpu_torch/tools/
# time_chain_pin.py --other (that tree and this one in one call, one timer;
# H100 80GB HBM3, 700 W); shape -> ms
COMBINE_BEFORE_MS = {(16, 184, 320, 112): 1.1593, (16, 92, 160, 224): 0.8297,
                     (16, 46, 80, 224): 0.2186, (16, 23, 40, 448): 0.3164,
                     (16, 128, 128, 144): 0.4507}
LTAM_BEFORE_MS = 0.2964  # 1x184x320x112, K = 5
# the LTAM backward's (1x64x64x112, K = 5) and the bf16 axes kernel's
# (16x184x320x112, chunk 8) times before their redesign: PERF.md's kernel
# table (chip_smoke.py phase 2 of the tree before; H100 80GB HBM3, 700 W)
LTAM_BWD_BEFORE_MS = 0.2213
AXES_BEFORE_MS = 1.3472
# LTAM launches of a FULL_PRESET clip at each slot count K = 1..5: 3 steps
# x 2 directions x 2 trajectory stages
LTAM_STEPS_PER_K = 12
# LTAM head widths d = C / heads beyond the full preset's 28: (C, heads, K) --
# the few-levels preset's 36, 64, and one head of 144 -- at the few-levels
# serving shape (1x128x128) and training crop (1x64x64), ragged slot counts
LTAM_WIDTHS = [(144, 4, 3), (128, 2, 4), (144, 1, 5)]
# the axis branches' token form: (N, H, W, C) and chunk of stages 1/5 and 3
TOKEN_SHAPES = [((16, 92, 160, 224), 16), ((16, 23, 40, 448), 8)]
# the reduce's shapes (N, H, W, C) and launches per clip: FULL_PRESET's
# stages 1/5, 2/4 and 3 ('hybrid' mixers), the few-levels preset's two
# resolutions of a 32-frame clip (C = 144), and stages 0/6 (the 'full' form
# runs there: the kernel table's continuity row)
REDUCE_SHAPES = [((16, 92, 160, 224), 8), ((16, 46, 80, 224), 4), ((16, 23, 40, 448), 2),
                 ((32, 128, 128, 144), 8), ((32, 64, 64, 144), 4), ((16, 184, 320, 112), 0)]
REDUCE_FEW = ((32, 128, 128, 144), (32, 64, 64, 144))
# the reduce's and the token form's times before their redesign, printed
# beside this run's: PERF.md's step 0 (vmg_tpu_torch/tools/time_chain_pin.py
# on the tree before, the timer this script uses; H100 80GB HBM3, 700 W)
REDUCE_BEFORE_MS = {(16, 92, 160, 224): 0.2156, (16, 46, 80, 224): 0.0638,
                    (16, 23, 40, 448): 0.0841, (32, 128, 128, 144): 0.3060,
                    (32, 64, 64, 144): 0.0806, (16, 184, 320, 112): 0.4759}
TOKEN_BEFORE_MS = {(16, 92, 160, 224): 1.2431, (16, 23, 40, 448): 0.3689}
# the probe kernels before their redesign, at their primary probes (PERF.md,
# the step 0 of each redesign: time_chain_pin on the previous tree; same
# timer; the relayout at lane_store_cg28)
PROBE_BEFORE_MS = {"slab_copy": 0.0036, "tile_gemm": 0.0464, "smem_relayout": 0.0043}
# Train-step parity, f32: the loss within LOSS_TOL relative; each
# parameter's gradient within GRAD_LIMIT of max(its max|plain|, GRAD_FLOOR x
# the largest max|plain| of any parameter).  GRAD_TOL of its own max is
# reported, not held: the plain path misses it against itself -- two CPU
# thread counts (summation orders) differ by up to ~2e-2 of their own max
# on gradients ~1e-8 of the largest, and by ~4e-3 on gradients 1e-3 of it
# (see PERF.md); the phase measures that spread too.
LOSS_TOL, GRAD_TOL, GRAD_LIMIT, GRAD_FLOOR = 1e-5, 1e-3, 1e-2, 1e-3

def bound(inputs, outputs, flops, peak):
    """{bound_ms, bound_by, ...} for a call that reads ``inputs`` once,
    writes ``outputs`` once and does ``flops`` operations at ``peak``: the
    least time the card could take (NVIDIA H100 SXM data sheet rates)."""
    from vmg_tpu_torch.utils.profiling import bound as least_time

    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    return {**least_time(nbytes, flops, peak), "bound_bytes": nbytes, "bound_flops": flops,
            "bound_peak": peak}


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip()


def cuda_ms(fn, iters=10) -> float:
    """Device ms per call of ``fn`` after one warm-up call (CUDA events)."""
    from vmg_tpu_torch.utils.profiling import timed

    return timed(fn, iters=iters, warmup=1) * 1e3


def within_max(got, want, rel, label=""):
    """Check against rel * max|want|: (label, max_abs_err, ok, text)."""
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    return (label, err, err <= rel * ref,
            f"max_rel_err={err / max(ref, 1e-30):.3e} (tol {rel:g} of max|plain|)")


def within_sum(got, want, terms, label=""):
    """Check f32 sums per element against SUM_TOL * ``terms``, the sum of
    the summed terms' magnitudes: (label, max_abs_err, ok, text)."""
    diff = (got - want).abs()
    rel = (diff / terms).max().item()
    return (label, diff.max().item(), rel <= SUM_TOL,
            f"max_rel_err={rel:.3e} (tol {SUM_TOL:g} of sum|terms|)")


def ltam_dpe_terms(q, kv, pe, g, K, heads):
    """Per entry of the LTAM backward's dpe (K, 4, 4, heads), the sum of its
    terms' magnitudes: over the pixels at that query position,
    exp(logit) (|g.v| + |g.out|) / den, plain PyTorch."""
    from vmg_tpu_torch.ops.ltam_attention import _tap, ltam_attention_plain

    N, H, W, C = q.shape
    d = C // heads
    kv6 = kv.reshape(N, H, W, K, 2, C)
    qh, gh = q.reshape(N, H, W, heads, d), g.reshape(N, H, W, heads, d)
    out = ltam_attention_plain(q, kv, pe, K=K, heads=heads).reshape(N, H, W, heads, d)
    s = (gh * out).sum(-1).abs()
    pos = (2 * (torch.arange(H, device=q.device) % 2)[:, None]
           + (torch.arange(W, device=q.device) % 2)[None, :])
    den, mags = 0.0, {}
    for k in range(K):
        for t in range(4):
            val = _tap(kv6[:, :, :, k, 0], *divmod(t, 2)).float().reshape(N, H, W, heads, d)
            key = _tap(kv6[:, :, :, k, 1], *divmod(t, 2)).float().reshape(N, H, W, heads, d)
            ex = torch.exp((qh * key).sum(-1))
            den = den + ex * pe[k, t][pos]
            mags[k, t] = ex * ((gh * val).sum(-1).abs() + s)
    terms = torch.empty_like(pe)
    for (k, t), m in mags.items():
        m = m / den.clamp_min(1e-30)
        for p in range(4):
            terms[k, t, p] = m[:, pos == p].sum(dim=(0, 1))
    return terms


def check_kernels(report):
    """Phase 2.  Returns one dict per kernel for the JSON line."""
    import torch.nn.functional as F

    from vmg_tpu_torch.models.blocks import _axis_mix
    from vmg_tpu_torch.ops import conv_chain, fused_norm, group_conv, ltam_attention, morphfc_fused
    from vmg_tpu_torch.ops.decay import morphfc_decay_np

    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")

    def rn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    entries = {
        "fused_group_ffn": dict(source="vmg_tpu_torch/csrc/group_ffn.cu",
                                replaces="vmg_tpu/ops/group_conv.py:187"),
        "fused_morphfc_axes": dict(source="vmg_tpu_torch/csrc/morphfc.cu",
                                   replaces="vmg_tpu/ops/morphfc_fused.py:175"),
        "fused_morphfc_reduce": dict(source="vmg_tpu_torch/csrc/morphfc.cu",
                                     replaces="vmg_tpu/ops/morphfc_fused.py:359"),
        "fused_morphfc_combine": dict(source="vmg_tpu_torch/csrc/morphfc.cu",
                                      replaces="vmg_tpu/ops/morphfc_fused.py:421"),
        "ltam_attention_2x2": dict(source="vmg_tpu_torch/csrc/ltam.cu",
                                   replaces="vmg_tpu/ops/ltam_attention.py:282"),
        "ltam_attention_2x2_bwd": dict(source="vmg_tpu_torch/csrc/ltam.cu",
                                       replaces="vmg_tpu/ops/ltam_attention.py:308"),
        "fused_conv_chain": dict(source="vmg_tpu_torch/csrc/conv_chain.cu",
                                 replaces="vmg_tpu/ops/conv_chain.py:183"),
        "fused_norm": dict(source="vmg_tpu_torch/csrc/fused_norm.cu",
                           replaces="vmg_tpu/ops/fused_norm.py:102"),
        "layout_pin": dict(source="vmg_tpu_torch/csrc/conv_chain.cu",
                           replaces="vmg_tpu/ops/conv_chain.py:164"),
        "fused_morphfc_axes_token": dict(source="vmg_tpu_torch/csrc/morphfc.cu",
                                         replaces="vmg_tpu/ops/morphfc_fused.py:257"),
        "slab_copy": dict(source="vmg_tpu_torch/csrc/probes.cu",
                          replaces="tools/exp_mosaic_probe.py:51"),
        "smem_relayout": dict(source="vmg_tpu_torch/csrc/probes.cu",
                              replaces="tools/exp_mosaic_probe2.py:46"),
        "tile_gemm": dict(source="vmg_tpu_torch/csrc/probes.cu",
                          replaces="tools/exp_mosaic_probe2.py:97"),
    }
    # No single PyTorch call computes the first seven functions (each needs
    # layout changes or several ops around a library call), so no library
    # time is taken for them; the norm's is F.layer_norm / F.rms_norm, the
    # pin's x.clone().
    for e in entries.values():
        e.update(route="cuda", max_abs_err=0.0, library_ms=None)

    def compare(name, shape, dtype, kernel, plain, check, primary, work, extra="",
                library=None, keys=None):
        """Check and time one kernel call.  ``check(got, want)`` gives one
        (label, max_abs_err, ok, text) per output; ``primary``: the call at
        the main path's shape and dtype whose times go into the JSON line;
        ``work``: (inputs, operations, peak) for its bound; ``library``: one
        PyTorch call computing the same function, timed beside it; ``keys``:
        more numbers for the JSON line of a primary call."""
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        results = check(got, want)
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        text = "; ".join(f"{lbl}max_abs_err={err:.3e} {txt}" for lbl, err, _, txt in results)
        if not (finite and all(ok for _, _, ok, _ in results)):
            report(f"  {name} {dtype} {shape}: finite={finite}; {text} FAIL")
            raise AssertionError(f"{name} disagrees with its plain version")
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain, iters=3)
        library_ms = None if library is None else cuda_ms(library)
        b = bound(work[0], got, work[1], work[2])
        lib_text = "" if library_ms is None else f"  library {library_ms:.3f} ms"
        report(f"  {name:22s} {str(dtype):15s} {str(shape):26s} {text} ok  "
               f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms{lib_text}  bound "
               f"{b['bound_ms']:.4f} ms ({b['bound_by']}){extra}")
        e = entries[name]
        e["max_abs_err"] = max([e["max_abs_err"]] + [err for _, err, _, _ in results])
        if primary:
            e.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                     at=f"{dtype} {shape}", **b, **(keys or {}))
        return ms, b, got

    def dtype_check(dtype):
        return lambda got, want: [within_max(got[0], want[0], REL_TOL[dtype])]

    def peak(dtype):  # the bf16 kernels multiply on the tensor cores
        return "bf16 tensor cores" if dtype == torch.bfloat16 else "f32"

    def axes_args(shape, ck, dtype):
        """x, c and the decay-folded axis weights and biases of a mixer."""
        N, h, w, C = shape
        x, xc = rn(N, h, w, C, dtype=dtype), rn(N, h, w, C, scale=0.01, dtype=dtype)
        gamma = torch.from_numpy(morphfc_decay_np(ck, C // ck)).to(dev, dtype)
        kh, kw = ((rn(C, C, scale=0.02, dtype=dtype) * gamma).contiguous() for _ in range(2))
        return x, xc, kh, rn(C, scale=0.1), kw, rn(C, scale=0.1)

    def axes_check(xc, dtype):
        def check(got, want):
            terms = sum(v.float().abs().sum(dim=(1, 2)) for v in (want[0], want[1], xc))
            return [within_max(got[0], want[0], REL_TOL[dtype], "h "),
                    within_max(got[1], want[1], REL_TOL[dtype], "w "),
                    within_sum(got[2], want[2], terms, "psum ")]
        return check

    # the token form's path: its op entry point at the wide stages' shapes,
    # in the serving dtype, counted from zero
    zero_counts()
    for shape, ck in TOKEN_SHAPES:
        args = axes_args(shape, ck, torch.bfloat16)
        morphfc_fused.fused_morphfc_axes(*args, chunk_h=ck, chunk_w=ck, form="token")
        del args
    torch.cuda.synchronize()
    token_path = read_counts()
    report(f"  token form's entry point at {TOKEN_SHAPES}: launches {token_path}")
    if token_path["fused_morphfc_axes_token"] != len(TOKEN_SHAPES):
        raise AssertionError("the token form's entry point did not launch its kernel")
    entries["fused_morphfc_axes_token"]["path_launches"] = token_path

    for dtype in (torch.float32, torch.bfloat16):
        # the FFN at the four stage shapes of FULL_PRESET (N = 16 frames,
        # groups 4, 6C hidden) and the few-levels shape (groups 1, 2C)
        for (N, h, w, C), G, ratio in FFN_SHAPES:
            Fh = ratio * C
            x = rn(N, h, w, C, dtype=dtype)
            w1 = rn(Fh, C // G, 3, 3, scale=(9 * C / G) ** -0.5, dtype=dtype)
            b1, b2 = rn(Fh, scale=0.1, dtype=dtype), rn(C, scale=0.1, dtype=dtype)
            w2 = rn(C, Fh, scale=0.02, dtype=dtype)
            args = (x, *group_conv.pack_ffn_weights(w1, b1, w2, G), b2)
            # grouped 3x3 conv (C/G inputs per output) and the C x ratio*C fc2
            flops = 2 * N * h * w * Fh * (9 * C // G + C)
            shape = (N, h, w, C)
            bf16 = dtype == torch.bfloat16
            extra, keys, module_ms = "", {}, None
            if bf16:  # the module form training runs: cuDNN grouped conv, GELU, fc2
                xc = x.permute(0, 3, 1, 2)  # NHWC memory: a channels-last view
                w1c = w1.contiguous(memory_format=torch.channels_last)

                def module():
                    y = F.conv2d(xc, w1c, b1, padding=1, groups=G).permute(0, 2, 3, 1)
                    return F.linear(group_conv.gelu(y, "tanh"), w2, b2)

                module_ms = cuda_ms(module, iters=5)
                extra, keys = f"  module form {module_ms:.3f} ms", {"module_ms": module_ms}
            ms, b, got = compare(
                "fused_group_ffn", shape, dtype,
                lambda: group_conv.fused_group_ffn(*args, groups=G, act="tanh"),
                lambda: group_conv.group_ffn_plain(*args, groups=G, act="tanh"),
                dtype_check(dtype), primary=bf16 and shape == FFN_SHAPES[0][0],
                work=((x, w1, b1, w2, b2), flops, peak(dtype)), extra=extra, keys=keys)
            # the result must not depend on which block took which tile
            again = group_conv.fused_group_ffn(*args, groups=G, act="tanh")
            torch.cuda.synchronize()
            if not torch.equal(again, got[0]):
                raise AssertionError(f"two runs of the FFN differ at {shape}")
            if bf16:
                before = FFN_BEFORE_MS[shape]
                report(f"    {flops / ms / 1e9:.1f} TFLOP/s, {b['bound_ms'] / ms:.3f} of the "
                       f"bound, {ms / module_ms:.3f} x the module form; two runs bit-equal; "
                       + f"before the redesign {before} ms (PERF.md, same timer)")
                entries["fused_group_ffn"][f"groups{G}_" + "x".join(map(str, shape))] = {
                    "ms": ms, "module_ms": module_ms, "bound_ms": b["bound_ms"],
                    "tflop_s": flops / ms / 1e9}
            del x, w1, args, got, again

        # the axis-branch kernel at stages 0/6: chunk 8 along H and W; its
        # token form at stages 1/5 and 3, next to the 'hybrid' form they run
        # (XLA-form axis FCs + the reduce kernel), and against the big form
        for shape, ck, form in [((16, 184, 320, 112), 8, "big")] + [
                (shape, ck, "token") for shape, ck in TOKEN_SHAPES]:
            N, h, w, C = shape
            args = axes_args(shape, ck, dtype)
            x, xc, kh, bh, kw, bw = args
            name = "fused_morphfc_axes" if form == "big" else "fused_morphfc_axes_token"

            def hybrid():
                hh = _axis_mix(x, kh, bh.to(dtype), ck, 1).contiguous()
                ww = _axis_mix(x, kw, bw.to(dtype), ck, 2).contiguous()
                return morphfc_fused.fused_morphfc_reduce(hh, ww, xc)

            hybrid_ms = cuda_ms(hybrid, iters=3)
            ms, b, got = compare(
                name, (N, h, w, C, ck), dtype,
                lambda: morphfc_fused.fused_morphfc_axes(*args, chunk_h=ck, chunk_w=ck,
                                                         form=form),
                lambda: morphfc_fused.morphfc_axes_plain(*args, chunk_h=ck, chunk_w=ck),
                axes_check(xc, dtype), primary=dtype == torch.bfloat16 and C in (112, 224),
                work=(args, 2 * 2 * N * h * w * C * C, peak(dtype)),  # two C x C FCs
                extra=f"  hybrid form {hybrid_ms:.3f} ms", keys={"hybrid_ms": hybrid_ms})
            # the result must not depend on which warpgroup took which tile
            again = morphfc_fused.fused_morphfc_axes(*args, chunk_h=ck, chunk_w=ck, form=form)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b_) for a, b_ in zip(again, got)):
                raise AssertionError(f"two runs of the axes kernel ({form}) differ at {shape}")
            del again
            if dtype == torch.bfloat16:
                before = AXES_BEFORE_MS if form == "big" else TOKEN_BEFORE_MS[shape]
                report(f"    {b['bound_ms'] / ms:.3f} of the bound "
                       f"({b['bound_bytes'] / ms / 1e9:.2f} TB/s); two runs bit-equal; "
                       f"before the redesign {before} ms (PERF.md)")
                if form == "token":
                    entries[name]["x".join(map(str, shape))] = {
                        "ms": ms, "bound_ms": b["bound_ms"], "hybrid_ms": hybrid_ms}
            del got
            if form == "big":  # the token form on the big form's domain
                big = morphfc_fused.fused_morphfc_axes(*args, chunk_h=ck, chunk_w=ck)
                token = morphfc_fused.fused_morphfc_axes(*args, chunk_h=ck, chunk_w=ck,
                                                         form="token")
                torch.cuda.synchronize()
                results = axes_check(xc, dtype)(token, big)
                text = "; ".join(f"{lbl}max_abs_err={err:.3e} {txt}"
                                 for lbl, err, _, txt in results)
                ok = all(r[2] for r in results)
                report(f"  token form vs big form {dtype} {(N, h, w, C, ck)}: {text} "
                       f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("the token form disagrees with the big form")
                del big, token
            del x, xc, args

        # the reduce at every shape it runs (bf16) and at stages 0 and 3
        # (f32), two runs bit-equal; its sum over a clip of each preset
        clip = {False: [0.0, 0.0], True: [0.0, 0.0]}  # few-levels? -> ms, bound
        for shape, per_clip in (REDUCE_SHAPES if bf16 else
                                [(REDUCE_SHAPES[-1][0], 0), (REDUCE_SHAPES[2][0], 0)]):
            N, h, w, C = shape
            xh, xw, xc = (rn(*shape, dtype=dtype) for _ in range(3))
            terms = sum(v.float().abs().sum(dim=(1, 2)) for v in (xh, xw, xc))
            ms, b, got = compare("fused_morphfc_reduce", shape, dtype,
                                 lambda: morphfc_fused.fused_morphfc_reduce(xh, xw, xc),
                                 lambda: morphfc_fused.morphfc_reduce_plain(xh, xw, xc),
                                 lambda got, want: [within_sum(got[0], want[0], terms)],
                                 bf16 and shape == REDUCE_SHAPES[0][0],
                                 work=((xh, xw, xc), 3 * xh.numel(), "f32"))
            again = morphfc_fused.fused_morphfc_reduce(xh, xw, xc)
            torch.cuda.synchronize()
            if not torch.equal(again, got[0]):
                raise AssertionError(f"two runs of the reduce differ at {shape}")
            if bf16:
                few = shape in REDUCE_FEW
                clip[few][0] += per_clip * ms
                clip[few][1] += per_clip * b["bound_ms"]
                report(f"    {b['bound_ms'] / ms:.3f} of the bound "
                       f"({b['bound_bytes'] / ms / 1e9:.2f} TB/s), {per_clip} launches a "
                       f"{'few-levels' if few else 'FULL_PRESET'} clip; two runs bit-equal; "
                       f"before the redesign {REDUCE_BEFORE_MS[shape]} ms (PERF.md)")
                entries["fused_morphfc_reduce"]["x".join(map(str, shape))] = {
                    "ms": ms, "bound_ms": b["bound_ms"], "launches_per_clip": per_clip}
            del xh, xw, xc, got, again
        if bf16:
            for few, (label, n) in ((False, ("FULL_PRESET", 14)), (True, ("few-levels", 12))):
                c_ms, c_bound = clip[few]
                report(f"    reduce per {label} clip ({n} launches): {c_ms:.4f} ms against a "
                       f"bound of {c_bound:.4f} ms ({c_bound / c_ms:.3f})")
                entries["fused_morphfc_reduce"]["per_clip_few" if few else "per_clip"] = {
                    "ms": c_ms, "bound_ms": c_bound}

        # the combine: bf16 (the B image of Pk) at every path shape, f32 at
        # stages 0 and 3; each gate (tanh on every preset's path)
        bf16 = dtype == torch.bfloat16
        for shape in COMBINE_SHAPES if bf16 else (COMBINE_SHAPES[0], COMBINE_SHAPES[3]):
            N, h, w, C = shape
            xh, xw, xc, x, res = (rn(*shape, dtype=dtype) for _ in range(5))
            a = torch.softmax(rn(N, 3, C), dim=1).to(dtype)
            pk, pb = rn(C, C, scale=0.02, dtype=dtype), rn(C, scale=0.1)
            pkk = morphfc_fused.pack_combine_weight(pk) if bf16 else pk
            args, pargs = (x, xh, xw, xc, a, pkk, pb), (x, xh, xw, xc, a, pk, pb)
            for act in ("tanh", "sigmoid", "relu"):
                # the C x C projection; the weighted sum and gate are elementwise
                ms, b, got = compare(
                    "fused_morphfc_combine", (*shape, act), dtype,
                    lambda: morphfc_fused.fused_morphfc_combine(*args, act=act, residual=res),
                    lambda: morphfc_fused.morphfc_combine_plain(*pargs, act=act, residual=res),
                    dtype_check(dtype), bf16 and shape == COMBINE_SHAPES[0] and act == "tanh",
                    work=((x, xh, xw, xc, a, pk, pb, res), 2 * x.numel() * C, peak(dtype)))
                if bf16 and act == "tanh":
                    # the result must not depend on which warpgroup took which tile
                    again = morphfc_fused.fused_morphfc_combine(*args, act=act, residual=res)
                    torch.cuda.synchronize()
                    if not torch.equal(again, got[0]):
                        raise AssertionError(f"two runs of the combine differ at {shape}")
                    before = COMBINE_BEFORE_MS.get(shape)
                    report(f"    {b['bound_ms'] / ms:.3f} of the bound "
                           f"({b['bound_bytes'] / ms / 1e9:.2f} TB/s); two runs bit-equal"
                           + ("" if before is None else
                              f"; before the redesign {before} ms (PERF.md)"))
                    entries["fused_morphfc_combine"]["x".join(map(str, shape))] = {
                        "ms": ms, "bound_ms": b["bound_ms"], "share": b["bound_ms"] / ms}
                del got
            del xh, xw, xc, x, res, args, pargs

        # LTAM forward at the serving shape (stage 0 of a 1x16x180x320
        # clip) at every slot count a clip's steps see (a slot every third
        # step: K = 1, 1, 1, 2, ..., 5, 5, 5 in each direction of stages 0
        # and 6); f32 arithmetic on the CUDA cores: per pixel, slot and tap
        # a C-long logit and a C-long value sum
        N, h, w, C, heads = 1, 184, 320, 112, 4
        clip_ms = clip_bound = 0.0
        for K in (1, 2, 3, 4, 5) if bf16 else (5,):
            q = torch.nn.functional.normalize(rn(N, h, w, C), dim=-1) * (C // heads) ** -0.5
            kv = rn(N, h, w, K * 2 * C, dtype=dtype)
            pe = torch.exp(rn(K, 4, 4, heads, scale=0.02))
            ms, b, _ = compare(
                "ltam_attention_2x2", (N, h, w, C, K), dtype,
                lambda: ltam_attention.ltam_attention_2x2(q, kv, pe, K=K, heads=heads),
                lambda: ltam_attention.ltam_attention_plain(q, kv, pe, K=K, heads=heads),
                dtype_check(torch.float32),  # f32 output: f32 tolerance
                primary=bf16 and K == 5,
                work=((q, kv, pe), N * h * w * K * 4 * 4 * C, "f32"))
            if bf16:
                report(f"    {b['bound_ms'] / ms:.3f} of the bound"
                       + (f"; before the redesign {LTAM_BEFORE_MS} ms (PERF.md)" if K == 5
                          else ""))
                entries["ltam_attention_2x2"][f"k{K}"] = {"ms": ms, "bound_ms": b["bound_ms"]}
                clip_ms += LTAM_STEPS_PER_K * ms
                clip_bound += LTAM_STEPS_PER_K * b["bound_ms"]
            del q, kv
        if bf16:
            report(f"    per FULL_PRESET clip ({5 * LTAM_STEPS_PER_K} launches, "
                   f"{LTAM_STEPS_PER_K} at each K): {clip_ms:.3f} ms against a bound of "
                   f"{clip_bound:.3f} ms ({clip_bound / clip_ms:.3f})")
            entries["ltam_attention_2x2"]["per_clip"] = {"ms": clip_ms, "bound_ms": clip_bound}

        # LTAM backward at the training shape (stage 0 of a 64x64 crop) at
        # every slot count a step's backward sees (12 launches at each K = 1..5,
        # as the forward's), from the forward kernel's saved out and
        # denominator; two runs bit-equal
        N, h, w = 1, 64, 64
        step_ms = step_bound = 0.0

        def bwd_check(got, want):
            return [within_max(got[0], want[0], REL_TOL[torch.float32], "dq "),
                    within_max(got[1], want[1], REL_TOL[dtype], "dkv "),
                    within_sum(got[2], want[2], dpe_terms, "dpe ")]

        for K in (1, 2, 3, 4, 5) if bf16 else (5,):
            q = torch.nn.functional.normalize(rn(N, h, w, C), dim=-1) * (C // heads) ** -0.5
            kv = rn(N, h, w, K * 2 * C, dtype=dtype)
            pe = torch.exp(rn(K, 4, 4, heads, scale=0.02))
            g = rn(N, h, w, C)
            out, den = ltam_attention._forward_kernel(q, kv, pe, K, heads, with_den=True)
            dpe_terms = ltam_dpe_terms(q, kv, pe, g, K, heads)
            # per pixel, slot and tap: logit, g.v and dq, C-long each; dval
            # and dkey, C-long each
            ms, b, got = compare(
                "ltam_attention_2x2_bwd", (N, h, w, C, K), dtype,
                lambda: ltam_attention.ltam_attention_2x2_bwd(q, kv, pe, den, out, g,
                                                              K=K, heads=heads),
                lambda: ltam_attention.ltam_attention_bwd_plain(q, kv, pe, g, K=K,
                                                                heads=heads),
                bwd_check, primary=bf16 and K == 5,
                work=((q, kv, pe, den, out, g), N * h * w * K * 4 * 10 * C, "f32"))
            again = ltam_attention.ltam_attention_2x2_bwd(q, kv, pe, den, out, g, K=K,
                                                          heads=heads)
            torch.cuda.synchronize()
            if got[1].dtype != kv.dtype or not all(torch.equal(a, b_) for a, b_ in zip(again, got)):
                raise AssertionError(f"the LTAM backward at K={K}: dkv not in kv's dtype, or "
                                     "two runs differ")
            if bf16:
                report(f"    {b['bound_ms'] / ms:.3f} of the bound; two runs bit-equal"
                       + (f"; before the redesign {LTAM_BWD_BEFORE_MS} ms (PERF.md)" if K == 5
                          else ""))
                entries["ltam_attention_2x2_bwd"][f"k{K}"] = {"ms": ms, "bound_ms": b["bound_ms"]}
                step_ms += LTAM_STEPS_PER_K * ms
                step_bound += LTAM_STEPS_PER_K * b["bound_ms"]
            del q, kv, out, den, g, got, again
        if bf16:
            report(f"    per FULL_PRESET training step ({5 * LTAM_STEPS_PER_K} launches, "
                   f"{LTAM_STEPS_PER_K} at each K): {step_ms:.3f} ms against a bound of "
                   f"{step_bound:.3f} ms ({step_bound / step_ms:.3f})")
            entries["ltam_attention_2x2_bwd"]["per_step"] = {"ms": step_ms,
                                                             "bound_ms": step_bound}

        # LTAM at the wider heads: the forward at the few-levels serving
        # shape, the backward at its training crop
        for C, heads, K in LTAM_WIDTHS:
            d = C // heads
            for N, h, w in ((1, 128, 128), (1, 64, 64)):
                q = torch.nn.functional.normalize(rn(N, h, w, C), dim=-1) * d ** -0.5
                kv = rn(N, h, w, K * 2 * C, dtype=dtype)
                pe = torch.exp(rn(K, 4, 4, heads, scale=0.02))
                if h == 128:
                    ms, _, _ = compare(
                        "ltam_attention_2x2", (N, h, w, C, K, f"d={d}"), dtype,
                        lambda: ltam_attention.ltam_attention_2x2(q, kv, pe, K=K, heads=heads),
                        lambda: ltam_attention.ltam_attention_plain(q, kv, pe, K=K, heads=heads),
                        dtype_check(torch.float32), primary=False,
                        work=((q, kv, pe), N * h * w * K * 4 * 4 * C, "f32"))
                else:
                    g = rn(N, h, w, C)
                    out, den = ltam_attention._forward_kernel(q, kv, pe, K, heads, with_den=True)
                    dpe_terms = ltam_dpe_terms(q, kv, pe, g, K, heads)
                    ms, _, _ = compare(
                        "ltam_attention_2x2_bwd", (N, h, w, C, K, f"d={d}"), dtype,
                        lambda: ltam_attention.ltam_attention_2x2_bwd(q, kv, pe, den, out, g,
                                                                      K=K, heads=heads),
                        lambda: ltam_attention.ltam_attention_bwd_plain(q, kv, pe, g, K=K,
                                                                        heads=heads),
                        bwd_check, primary=False,
                        work=((q, kv, pe, den, out, g), N * h * w * K * 4 * 10 * C, "f32"))
                    del g, out, den
                if dtype == torch.bfloat16:
                    name = "ltam_attention_2x2" if h == 128 else "ltam_attention_2x2_bwd"
                    entries[name][f"d{d}"] = {"ms": ms, "at": f"{N}x{h}x{w}x{C} K={K}"}
                del q, kv

        # the conv chain: a trajectory resblock (one frame, residual 0.1;
        # the serving path's shape) and the RCAB branch of a stage-0/6
        # mixer (16 frames, the pool sums), each next to the module form's
        # cuDNN convolutions
        C = 112
        for N, kw in ((1, dict(res_scale=0.1)), (16, dict(emit_psum=True))):
            h, w = 184, 320
            x = rn(N, h, w, C, dtype=dtype)
            wc = [rn(C, C, 3, 3, scale=(9 * C) ** -0.5, dtype=dtype) for _ in range(2)]
            bc = [rn(C, scale=0.1, dtype=dtype) for _ in range(2)]
            ops = (*conv_chain.pack_conv_taps(wc[0], bc[0]),
                   *conv_chain.pack_conv_taps(wc[1], bc[1]))
            wcl = [t.contiguous(memory_format=torch.channels_last) for t in wc]
            xc = x.permute(0, 3, 1, 2)  # NHWC memory: a channels-last view

            def module():  # ResidualBlockNoBN / RCAB's convs in the module form
                y = F.conv2d(F.relu(F.conv2d(xc, wcl[0], bc[0], padding=1)), wcl[1], bc[1],
                             padding=1).permute(0, 2, 3, 1)
                return x + 0.1 * y if "res_scale" in kw else y

            def chain_check(got, want):
                res = [within_max(got[0], want[0], REL_TOL[dtype])]
                if len(got) > 1:  # the sums of the kernel's own (rounded) output
                    own = got[0].float().sum(dim=(1, 2))
                    terms = got[0].float().abs().sum(dim=(1, 2))
                    res.append(within_sum(got[1], own, terms, "psum "))
                    if dtype == torch.float32:
                        res.append(within_sum(got[1], want[1], terms, "psum vs plain "))
                return res

            module_ms = cuda_ms(module, iters=5)
            # two 3x3 convs, C x C, per pixel
            flops = 2 * 2 * N * h * w * 9 * C * C
            ms, b, got = compare(
                "fused_conv_chain", (N, h, w, C), dtype,
                lambda: conv_chain.fused_conv_chain(x, *ops, **kw),
                lambda: conv_chain.conv_chain_plain(x, *ops, **kw),
                chain_check, primary=dtype == torch.bfloat16 and N == 1,
                work=((x, *ops), flops, peak(dtype)), extra=f"  module form {module_ms:.3f} ms",
                keys={"module_ms": module_ms})
            # the result must not depend on which block took which tile
            again = conv_chain.fused_conv_chain(x, *ops, **kw)
            again = again if isinstance(again, tuple) else (again,)
            torch.cuda.synchronize()
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                raise AssertionError("two runs of the conv chain differ")
            before = CHAIN_BEFORE_MS.get((N, dtype))
            report(f"    {flops / ms / 1e9:.1f} TFLOP/s, {b['bound_ms'] / ms:.3f} of the bound, "
                   f"{ms / module_ms:.3f} x the module form; two runs bit-equal"
                   + ("" if before is None else f"; before the redesign {before} ms (PERF.md, same timer)"))
            if dtype == torch.bfloat16:
                entries["fused_conv_chain"][f"n{N}"] = {
                    "ms": ms, "module_ms": module_ms, "bound_ms": b["bound_ms"],
                    "tflop_s": flops / ms / 1e9}
            del x, xc, ops, wc, wcl, got, again

        # the norm at every LayerNorm width of the serving path, each at the
        # rows of its first call, and RMS at 112; weights in the model dtype
        for C, rows, rms in [(C, rows, False) for C, rows in NORM_SHAPES] + [
                (*NORM_SHAPES[0], True)]:
            x = (rn(rows, C) * 1.5 + 0.5).to(dtype)
            g = (1.0 + rn(C, scale=0.2)).to(dtype)
            b = None if rms else rn(C, scale=0.1, dtype=dtype)
            eps = 1e-6 if rms else 1e-5
            lib = ((lambda: F.rms_norm(x, (C,), g, eps)) if rms else
                   (lambda: F.layer_norm(x, (C,), g, b, eps)))
            compare("fused_norm", ("rms" if rms else "ln", rows, C), dtype,
                    lambda: fused_norm.fused_norm(x, g, b, eps=eps, rms=rms),
                    lambda: fused_norm.fused_norm_plain(x, g, b, eps=eps, rms=rms),
                    dtype_check(dtype),
                    primary=dtype == torch.bfloat16 and (C, rows) == NORM_SHAPES[0] and not rms,
                    work=((x, g) + (() if b is None else (b,)), 8 * x.numel(), "f32"),
                    library=lib)
            del x

        # the pin: the trajectory step's resblock input (2C channels)
        x = rn(1, 184, 320, 224, dtype=dtype)

        def exact(got, want):
            return [within_max(got[0], want[0], 0.0)]

        ms, b, _ = compare("layout_pin", tuple(x.shape), dtype, lambda: conv_chain.layout_pin(x),
                           lambda: conv_chain.layout_pin_plain(x), exact,
                           primary=dtype == torch.bfloat16, work=((x,), 0, "f32"),
                           library=lambda: x.clone())
        report(f"    {2 * x.numel() * x.element_size() / ms / 1e6:.0f} GB/s, "
               f"{b['bound_ms'] / ms:.3f} of the bound"
               + (f"; before the redesign {PIN_BEFORE_MS} ms (PERF.md, same timer)"
                  if dtype == torch.bfloat16 else ""))
        del x
    torch.cuda.empty_cache()
    return entries


def check_probes(report, entries):
    """Phase 2p: every probe of both probe tools, called directly, counted
    from zero; then the tools' command lines.  Fills the three probe
    kernels' entries."""
    from vmg_tpu_torch.tools import exp_probe, exp_probe2
    from vmg_tpu_torch.utils.profiling import timed

    dev = torch.device("cuda")
    floor = timed(lambda: torch.cuda._sleep(0), iters=20) * 1e3
    report(f"  empty launch (torch.cuda._sleep(0)): {floor:.4f} ms, the floor under these kernels")
    primary = {"slab_copy": "exp_probe.dma_sub328_lane112",
               "smem_relayout": "exp_probe2.lane_store_cg28",
               "tile_gemm": "exp_probe2.tile_assembled_s28"}
    for name in primary:
        entries[name].update(route="cuda", max_abs_err=0.0, probes={})
    zero_counts()
    for tool in (exp_probe, exp_probe2):
        rng = np.random.default_rng(0)  # the command line's stream
        short = tool.__name__.rsplit(".", 1)[-1]
        for name, probe in tool.PROBES.items():
            r = probe(dev, rng)
            kernel = ("slab_copy" if name.startswith("dma") else
                      "tile_gemm" if name.startswith(("mm_", "tile_")) else "smem_relayout")
            e = entries[kernel]
            e["max_abs_err"] = max(e["max_abs_err"], r["maxdiff"])
            e["probes"][f"{short}.{name}"] = r
            primary_call = primary[kernel] == f"{short}.{name}"
            lib = "" if r["library_ms"] is None else f"  library {r['library_ms']:.4f} ms"
            if r.get("matmul_ms") is not None:
                lib += f" (matmul of the patch {r['matmul_ms']:.4f} ms)"
            rate = "" if r.get("tf_s") is None else f"  {r['tf_s']:.1f} TFLOP/s"
            sms = ("" if "ms_all_sms" not in r else
                   f"  on all {r['sms']} SMs {r['ms_all_sms']:.4f} ms "
                   f"({r['tf_s_all_sms']:.1f} TFLOP/s)")
            report(f"  {short}.{name:20s} {kernel:13s} maxdiff {r['maxdiff']:.3e} ok  kernel "
                   f"{r['ms']:.4f} ms{rate}  plain {r['plain_ms']:.4f} ms{lib}  bound "
                   f"{r['bound_ms']:.5f} ms ({r['bound_by']}){sms}")
            if primary_call and kernel in PROBE_BEFORE_MS:
                report(f"    {kernel}: before the redesign {PROBE_BEFORE_MS[kernel]} ms (PERF.md, "
                       f"same timer); {r['ms'] / floor:.2f} x the empty launch")
            elif kernel == "smem_relayout":
                report(f"    {r['ms'] / floor:.2f} x the empty launch")
            if primary_call:
                e.update(ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                         at=f"{short}.{name}", bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                         bound_bytes=r["bytes"], bound_flops=r["flops"],
                         bound_peak="bf16 tensor cores" if r["flops"] else None)
    probe_path = read_counts()
    report(f"  launches over the probes: {probe_path}")
    missing = [k for k in primary if probe_path[k] <= 0]
    if missing:
        raise AssertionError(f"probe kernels never launched: {missing}")
    for name in primary:
        entries[name]["path_launches"] = probe_path
    for tool in (exp_probe, exp_probe2):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tool.main([])
        names = [next(iter(json.loads(line))) for line in out.getvalue().splitlines()]
        report(f"  python -m {tool.__name__}: exit {rc}, {len(names)} JSON lines")
        if rc != 0 or names != list(tool.PROBES):
            raise AssertionError(f"{tool.__name__} failed: exit {rc}, lines {names}")


def launch_counts():
    """Kernel name -> (object, attribute) of its launch counter."""
    from vmg_tpu_torch.ops import (conv_chain, fused_norm, group_conv, ltam_attention,
                                   morphfc_fused, probes)
    ltam = ltam_attention.ltam_attention_2x2
    return {"fused_group_ffn": (group_conv.fused_group_ffn, "launches"),
            "fused_morphfc_axes": (morphfc_fused.fused_morphfc_axes, "launches"),
            "fused_morphfc_axes_token": (morphfc_fused.fused_morphfc_axes, "token_launches"),
            "slab_copy": (probes.slab_copy, "launches"),
            "smem_relayout": (probes.smem_relayout, "launches"),
            "tile_gemm": (probes.tile_gemm, "launches"),
            "fused_morphfc_reduce": (morphfc_fused.fused_morphfc_reduce, "launches"),
            "fused_morphfc_combine": (morphfc_fused.fused_morphfc_combine, "launches"),
            "ltam_attention_2x2": (ltam, "launches"),
            "ltam_attention_2x2_bwd": (ltam, "bwd_launches"),
            "fused_conv_chain": (conv_chain.fused_conv_chain, "launches"),
            "fused_norm": (fused_norm.fused_norm, "launches"),
            "layout_pin": (conv_chain.layout_pin, "launches")}


# the kernels of the opt-in forms: none launches in the default forms
OPT_IN = ("fused_conv_chain", "fused_norm", "layout_pin")
# the kernels on no model path: their entry points only (phases 2, 2p)
OFF_PATH = ("fused_morphfc_axes_token", "slab_copy", "smem_relayout", "tile_gemm")


def off_path_launched(counts):
    return [k for k in OFF_PATH if counts[k]]


def zero_counts():
    for obj, attr in launch_counts().values():
        setattr(obj, attr, 0)


def read_counts():
    return {name: getattr(obj, attr) for name, (obj, attr) in launch_counts().items()}


def grad_errors(grads, want, names):
    """Per parameter, max|grads - want| over max(max|want|, GRAD_FLOOR x the
    largest max|want|), and over max|want| alone: (worst floored, worst
    own, the parameter of the worst own and its max|want|, the largest
    max|want|, count over GRAD_TOL of own)."""
    peaks = [w.abs().max().item() for w in want]
    floor = GRAD_FLOOR * max(peaks)
    floored, own = [], []
    for a, w, m in zip(grads, want, peaks):
        err = (a.cpu() - w).abs().max().item()
        floored.append(err / max(m, floor))
        own.append(err / m if m > 0 else (0.0 if err == 0 else float("inf")))
    i = int(np.argmax(own))
    return (max(floored), own[i], names[i], peaks[i], max(peaks),
            sum(e > GRAD_TOL for e in own))


def train_parity(report, preset, device="cuda", frames=5):
    """Phase 5: one f32 training step's loss and gradients, on ``device``
    (kernels on the card) against the plain path on CPU tensors, and the
    plain path against itself at another CPU thread count.  Returns a dict
    of the errors."""
    from vmg_tpu_torch.configs import TrainConfig
    from vmg_tpu_torch.models.vmg import create_model
    from vmg_tpu_torch.train.train_step import loss_and_grads

    cfg = dataclasses.replace(preset, drop_path_rate=0.0)
    cpu_model = create_model(cfg, is_train=True, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to(device)
    rng = np.random.default_rng(3)
    lrs = torch.from_numpy(rng.random((1, frames, 64, 64, 3), dtype=np.float32))
    hrs = torch.from_numpy(rng.random((1, frames, 256, 256, 3), dtype=np.float32))
    tcfg = TrainConfig(if_aux=True)
    t1 = time.time()
    loss_cpu, g_cpu = loss_and_grads(cpu_model, lrs, hrs, tcfg)
    t_cpu = time.time() - t1
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))
    loss_cpu2, g_cpu2 = loss_and_grads(cpu_model, lrs, hrs, tcfg)
    torch.set_num_threads(threads)
    zero_counts()
    loss_gpu, g_gpu = loss_and_grads(gpu_model, lrs.to(device), hrs.to(device), tcfg)
    counts = read_counts()
    names = [n for n, _ in cpu_model.named_parameters()]
    finite = all(bool(torch.isfinite(g).all()) for g in g_gpu)
    res = {}
    for label, loss, grads in (("kernels", loss_gpu, g_gpu), ("plain_self", loss_cpu2, g_cpu2)):
        floored, own, own_name, own_peak, peak, n_over = grad_errors(grads, g_cpu, names)
        res[label] = {"loss_rel_err": abs(float(loss) - float(loss_cpu)) / abs(float(loss_cpu)),
                      "grad_err": floored, "grad_err_own_max": own,
                      "grad_err_own_max_param": own_name, "its_max_grad": own_peak,
                      "largest_max_grad": peak, "params_over_target": n_over}
    for label, text in (("kernels", "kernels on the card"),
                        ("plain_self", f"plain at {max(1, threads // 2)} CPU threads")):
        r = res[label]
        report(f"    {text} vs plain at {threads}: loss rel err {r['loss_rel_err']:.3e}; "
               f"worst gradient error {r['grad_err']:.3e} of max(own, {GRAD_FLOOR:g} x "
               f"largest) max|plain|; of its own max {r['grad_err_own_max']:.3e} in "
               f"{r['grad_err_own_max_param']} (its max|plain| {r['its_max_grad']:.3e}, the "
               f"largest {r['largest_max_grad']:.3e}); {r['params_over_target']} of "
               f"{len(names)} parameters over {GRAD_TOL:g} of their own max")
    report(f"    tol: loss {LOSS_TOL:g}, gradients {GRAD_LIMIT:g}; LTAM launches fwd "
           f"{counts['ltam_attention_2x2']} bwd {counts['ltam_attention_2x2_bwd']}; "
           f"CPU plain step {t_cpu:.1f} s")
    k = res["kernels"]
    if not (finite and k["loss_rel_err"] <= LOSS_TOL and k["grad_err"] <= GRAD_LIMIT):
        raise AssertionError("train-step parity failed")
    if counts["ltam_attention_2x2_bwd"] <= 0:
        raise AssertionError("the parity step did not reach the LTAM backward kernel")
    del gpu_model, cpu_model
    if device != "cpu":
        torch.cuda.empty_cache()
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's kernels need one",
              file=sys.stderr)
        return 1
    from vmg_tpu_torch import _build
    from vmg_tpu_torch.configs import FEW_LEVELS_PRESET, FULL_PRESET
    from vmg_tpu_torch.models.blocks import MlpCnn
    from vmg_tpu_torch.models.vmg import KERNEL_FORMS, create_model
    from vmg_tpu_torch.ops.resize import upsample_trilinear_frames
    from vmg_tpu_torch.serve import SRServer
    from vmg_tpu_torch.train.__main__ import run as train_run

    def report(msg):
        print(msg, flush=True)

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    report(f"[1] card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    _build.load_library()
    report(f"[1] kernels built and loaded in {time.time() - t0:.1f} s")

    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report("[2] kernels vs plain versions on the card (tol: f32 "
           f"{REL_TOL[torch.float32]}, bf16 {REL_TOL[torch.bfloat16]} of max|plain|; "
           f"f32 sums {SUM_TOL:g} of the sum of |terms|)")
    entries = check_kernels(report)
    report("[2p] probes: both probe tools' kernels vs plain versions on the card (copies "
           "bit-exact, products within 1 bf16 ulp of max|plain|)")
    check_probes(report, entries)

    report("[3] slice parity: FULL_PRESET f32 1x2x64x64, kernels on the card vs "
           "plain versions on CPU tensors, same weights")
    sd = create_model(FULL_PRESET, device="cpu",
                      generator=torch.Generator().manual_seed(0)).state_dict()
    cpu_model = create_model(FULL_PRESET, device="cpu")
    cpu_model.load_state_dict(sd)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    x = torch.from_numpy(np.random.default_rng(1).random((1, 2, 64, 64, 3), dtype=np.float32))
    with torch.inference_mode():
        t1 = time.time()
        want = cpu_model(x)
        t_cpu = time.time() - t1
        got = gpu_model(x.cuda()).cpu()
    err = (got - want).abs().max().item()
    net = (want - upsample_trilinear_frames(x, 4)).abs().max().item()
    report(f"    max_abs_err={err:.3e} (tol {SLICE_TOL}); network part max |out - "
           f"trilinear| = {net:.3e}; CPU plain path {t_cpu:.1f} s")
    if not (torch.isfinite(got).all() and err <= SLICE_TOL):
        raise AssertionError("slice parity failed")
    del gpu_model, cpu_model
    torch.cuda.empty_cache()

    report("[3b] kernel forms, FULL_PRESET f32 1x2x64x64 on the card: rcab/traj conv "
           f"'kernel' vs phase 3's plain output (tol {SLICE_TOL}); 'barrier' and "
           f"'barrier_out' vs the default forms (tol {BARRIER_TOL:g} of max|out|)")
    for forms in (KERNEL_FORMS, dict(traj_conv_impl="barrier"),
                  dict(traj_conv_impl="barrier_out")):
        model = create_model(FULL_PRESET, device="cuda", **forms)
        model.load_state_dict(sd)
        zero_counts()
        with torch.inference_mode():
            out_k = model(x.cuda()).cpu()
        counts = {k: v for k, v in read_counts().items() if k in OPT_IN}
        barrier = "traj_conv_impl" in forms and len(forms) == 1
        ref, tol = (got, BARRIER_TOL * got.abs().max().item()) if barrier else (want, SLICE_TOL)
        e = (out_k - ref).abs().max().item()
        report(f"    {forms}: max_abs_err={e:.3e} (tol {tol:.3e}); launches {counts}")
        need = "layout_pin" if barrier else "fused_conv_chain"
        if not (torch.isfinite(out_k).all() and e <= tol and counts[need] > 0):
            raise AssertionError(f"kernel-form slice parity failed for {forms}")
        del model
    torch.cuda.empty_cache()

    report("[3c] slice parity: FEW_LEVELS_PRESET f32 1x2x64x64, kernels on the card vs "
           "plain versions on CPU tensors, same weights")
    sd_few = create_model(FEW_LEVELS_PRESET, device="cpu",
                          generator=torch.Generator().manual_seed(0)).state_dict()
    cpu_model = create_model(FEW_LEVELS_PRESET, device="cpu")
    cpu_model.load_state_dict(sd_few)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    zero_counts()
    with torch.inference_mode():
        t1 = time.time()
        want_few = cpu_model(x)
        t_cpu = time.time() - t1
        got_few = gpu_model(x.cuda()).cpu()
    counts = read_counts()
    err_few = (got_few - want_few).abs().max().item()
    report(f"    max_abs_err={err_few:.3e} (tol {SLICE_TOL}); CPU plain path {t_cpu:.1f} s; "
           f"launches {counts}")
    if not (torch.isfinite(got_few).all() and err_few <= SLICE_TOL):
        raise AssertionError("few-levels slice parity failed")
    if min(counts[k] for k in FEW_PATH) <= 0:
        raise AssertionError(f"the few-levels slice missed a kernel of {FEW_PATH}")
    del gpu_model, cpu_model
    torch.cuda.empty_cache()

    report("[4] serving: SRServer FULL_PRESET bf16 (tanh GELU, fast flow), "
           f"1x{T}x{H}x{W}")
    server = SRServer(FULL_PRESET, sd, "cuda", torch.bfloat16, gelu="tanh",
                      fast_flow=True)
    small = server(x.numpy())
    report(f"    bf16 vs f32 at 1x2x64x64: max_abs_diff="
           f"{np.abs(small - got.numpy()).max():.3e} (informational)")
    rng = np.random.default_rng(0)
    warm = rng.random((1, T, H, W, 3), dtype=np.float32)
    clips = [rng.random((1, T, H, W, 3), dtype=np.float32) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t1 = time.time()
    out = server(warm)
    report(f"    warm-up request {time.time() - t1:.2f} s")
    reps = 3
    per_request = []
    t1 = time.time()
    for _ in range(reps):
        for c in clips:
            t2 = time.time()
            out = server(c)
            per_request.append(T / (time.time() - t2))
    dt = time.time() - t1
    serving_launches = read_counts()
    fps = T * reps * len(clips) / dt
    peak = torch.cuda.max_memory_allocated()
    report(f"    {fps:.3f} frames/s ({dt / (reps * len(clips)):.3f} s per clip, host "
           f"clock, numpy in/out); per request median {np.median(per_request):.3f}, "
           f"range {min(per_request):.3f}-{max(per_request):.3f} frames/s; peak "
           f"allocated {peak / 2**30:.2f} GiB; {kind}; card {smi}")
    report(f"    launches over the serving run: {serving_launches}")
    ffns = [m.fc2.out_features for m in server.model.modules() if isinstance(m, MlpCnn)]
    clips_run = 1 + reps * len(clips)
    report(f"    FFN: {len(ffns)} a clip at C in {sorted(set(ffns))}, "
           f"{serving_launches['fused_group_ffn'] / clips_run:g} kernel launches a clip")
    if len(ffns) != FFN_PER_CLIP or serving_launches["fused_group_ffn"] != FFN_PER_CLIP * clips_run:
        raise AssertionError(f"FFN kernel launches {serving_launches['fused_group_ffn']} over "
                             f"{clips_run} clips, expected {FFN_PER_CLIP} a clip")
    if out.shape != (1, T, 4 * H, 4 * W, 3) or not np.isfinite(out).all():
        raise AssertionError(f"bad serving output {out.shape}")
    missing = [k for k, v in serving_launches.items()
               if v <= 0 and k != "ltam_attention_2x2_bwd" and k not in OPT_IN + OFF_PATH]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")
    if any(serving_launches[k] for k in OPT_IN) or off_path_launched(serving_launches):
        raise AssertionError("the default serving forms launched an opt-in or off-path kernel")
    del server
    torch.cuda.empty_cache()

    report("[4b] serving in the kernel forms (rcab, traj conv, norm 'kernel'): same "
           f"weights and clips, 1x{T}x{H}x{W}")
    server = SRServer(FULL_PRESET, sd, "cuda", torch.bfloat16, gelu="tanh",
                      fast_flow=True, **KERNEL_FORMS)
    small_k = server(x.numpy())
    err_default = np.abs(small - want.numpy()).max()
    err_kernel = np.abs(small_k - want.numpy()).max()
    report(f"    bf16 vs phase 3's f32 plain output at 1x2x64x64: kernel forms "
           f"max_abs_err={err_kernel:.3e}, default forms {err_default:.3e} (tol: kernel <= "
           f"{KFORM_RATIO:g} x default)")
    if not (np.isfinite(small_k).all() and err_kernel <= KFORM_RATIO * err_default):
        raise AssertionError("kernel-form bf16 serving is further from the f32 output")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t1 = time.time()
    out = server(warm)
    warm_counts = read_counts()
    report(f"    warm-up request {time.time() - t1:.2f} s; launches {warm_counts}")
    per_clip = {"fused_conv_chain": CHAIN_PER_CLIP, "fused_norm": NORM_PER_CLIP,
                "layout_pin": 0}
    if any(warm_counts[k] != v for k, v in per_clip.items()):
        raise AssertionError(f"kernel-form launches per clip {warm_counts}, expected {per_clip}")
    zero_counts()
    per_request_k = []
    t1 = time.time()
    for c in clips:
        t2 = time.time()
        out = server(c)
        per_request_k.append(T / (time.time() - t2))
    dt_k = time.time() - t1
    kernel_launches = read_counts()
    fps_k = T * len(clips) / dt_k
    peak_k = torch.cuda.max_memory_allocated()
    report(f"    {fps_k:.3f} frames/s ({dt_k / len(clips):.3f} s per clip, host clock, numpy "
           f"in/out; default forms {fps:.3f}); per request median "
           f"{np.median(per_request_k):.3f}, range {min(per_request_k):.3f}-"
           f"{max(per_request_k):.3f} frames/s; peak allocated {peak_k / 2**30:.2f} GiB "
           f"(default {peak / 2**30:.2f}); {kind}; card {smi}")
    report(f"    launches over the {len(clips)} clips: {kernel_launches}")
    if out.shape != (1, T, 4 * H, 4 * W, 3) or not np.isfinite(out).all():
        raise AssertionError(f"bad kernel-form serving output {out.shape}")
    if off_path_launched(warm_counts) or off_path_launched(kernel_launches):
        raise AssertionError("kernel-form serving launched an off-path kernel")
    del server
    barrier_launches = {}
    for impl in ("barrier", "barrier_out"):
        server = SRServer(FULL_PRESET, sd, "cuda", torch.bfloat16, gelu="tanh",
                          fast_flow=True, traj_conv_impl=impl)
        zero_counts()
        t1 = time.time()
        out = server(clips[0])
        barrier_launches[impl] = read_counts()
        report(f"    traj_conv_impl={impl!r}: one request {time.time() - t1:.2f} s (its first); "
               f"launches {barrier_launches[impl]}")
        pins = barrier_launches[impl]["layout_pin"]
        if not np.isfinite(out).all() or pins != PIN_PER_CLIP or \
                off_path_launched(barrier_launches[impl]):
            raise AssertionError(f"{impl}: {pins} pins per clip, expected {PIN_PER_CLIP}")
        del server
    torch.cuda.empty_cache()

    few_eval = dataclasses.replace(FEW_LEVELS_PRESET, **FEW_EVAL)
    d_few = few_eval.embed_dim[0] // few_eval.traj_heads[0]
    report(f"[4c] serving the few-levels model: SRServer FEW_LEVELS_PRESET with the eval "
           f"preset's {FEW_EVAL}, bf16, 1x{FEW_T}x{FEW_HW}x{FEW_HW} clips (LTAM head width "
           f"{d_few}, FFN groups {few_eval.n_groups})")
    server = SRServer(few_eval, sd_few, "cuda", torch.bfloat16, gelu="tanh", fast_flow=True)
    few_clips = [rng.random((1, FEW_T, FEW_HW, FEW_HW, 3), dtype=np.float32) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    out = server(few_clips[0])
    report(f"    warm-up request {time.time() - t1:.2f} s")
    zero_counts()
    per_request_few = []
    t1 = time.time()
    for c in few_clips[1:]:
        t2 = time.time()
        out = server(c)
        per_request_few.append(FEW_T / (time.time() - t2))
    dt_few = time.time() - t1
    few_launches = read_counts()
    fps_few = FEW_T * (len(few_clips) - 1) / dt_few
    peak_few = torch.cuda.max_memory_allocated()
    report(f"    {fps_few:.3f} frames/s ({dt_few / (len(few_clips) - 1):.3f} s per clip, host "
           f"clock, numpy in/out); per request {[round(v, 3) for v in per_request_few]} "
           f"frames/s; peak allocated {peak_few / 2**30:.2f} GiB; {kind}; card {smi}")
    report(f"    launches over the {len(few_clips) - 1} clips: {few_launches}")
    if out.shape != (1, FEW_T, 4 * FEW_HW, 4 * FEW_HW, 3) or not np.isfinite(out).all():
        raise AssertionError(f"bad few-levels serving output {out.shape}")
    missing = [k for k in FEW_PATH if few_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched serving the few-levels model: {missing}")
    if few_launches["fused_group_ffn"] != FEW_FFN_PER_CLIP * (len(few_clips) - 1):
        raise AssertionError(f"few-levels FFN kernel launches {few_launches['fused_group_ffn']}, "
                             f"expected {FEW_FFN_PER_CLIP} a clip")
    del server
    torch.cuda.empty_cache()

    report(f"[5] train-step parity: FULL_PRESET f32 1x5x64x64, drop_path 0, TF32 off, "
           f"kernels on the card vs plain versions on CPU tensors, same weights")
    parity = train_parity(report, FULL_PRESET)

    # the trainer as a user runs it: PyTorch's default TF32 settings
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_defaults
    iters = 6
    report(f"[6] training: FULL_PRESET bf16 + f32 masters, remat, B=1 T=16 64x64 "
           f"crops, if_aux, seeded data; 1 warm-up + {iters} timed steps")
    zero_counts()
    rec = train_run(preset="full", batch=1, frames=16, crop=64, iters=iters,
                    grad_acc=1, remat=True, device="cuda")
    train_launches = read_counts()
    report(f"    step {rec['step_ms_median']:.1f} ms median ({rec['step_ms_min']:.1f}-"
           f"{rec['step_ms_max']:.1f}), {rec['frames_per_s']:.3f} frames/s, peak "
           f"allocated {rec['peak_bytes'] / 2**30:.2f} GiB, losses "
           f"{rec['loss_first']:.6f} (warm-up) .. {rec['loss_last']:.6f}; {kind}; card {smi}")
    report(f"    launches over the {iters} timed steps: {train_launches}")
    losses = [rec["loss_first"], *rec["losses"]]
    if not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    missing = [k for k in ("ltam_attention_2x2", "ltam_attention_2x2_bwd")
               if train_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the training path: {missing}")
    if any(train_launches[k] for k in OPT_IN) or off_path_launched(train_launches):
        raise AssertionError("the default training forms launched an opt-in or off-path kernel")

    iters_k = 2
    report(f"[6b] training with norm_impl='kernel': as phase 6, 1 warm-up + {iters_k} "
           "timed steps")
    zero_counts()
    rec_k = train_run(preset="full", batch=1, frames=16, crop=64, iters=iters_k,
                      grad_acc=1, remat=True, device="cuda", norm_impl="kernel")
    norm_counts = read_counts()
    norm_train = norm_counts["fused_norm"]
    rel = abs(rec_k["loss_first"] - rec["loss_first"]) / abs(rec["loss_first"])
    report(f"    step {rec_k['step_ms_median']:.1f} ms median ({rec_k['step_ms_min']:.1f}-"
           f"{rec_k['step_ms_max']:.1f}), peak allocated {rec_k['peak_bytes'] / 2**30:.2f} "
           f"GiB, losses {rec_k['loss_first']:.6f} (warm-up; phase 6 {rec['loss_first']:.6f}, "
           f"rel diff {rel:.3e}, tol {TRAIN_LOSS_TOL:g}) .. {rec_k['loss_last']:.6f}; norm "
           f"launches {norm_train} over {iters_k} steps")
    losses_k = [rec_k["loss_first"], *rec_k["losses"]]
    if not all(np.isfinite(v) for v in losses_k) or rel > TRAIN_LOSS_TOL or norm_train <= 0 \
            or off_path_launched(norm_counts):
        raise AssertionError(f"kernel-norm training failed: losses {losses_k}, "
                             f"norm launches {norm_train}")

    report("[6c] training the few-levels model: as phase 6 on FEW_LEVELS_PRESET, B=1 "
           f"T={FEW_TRAIN_T} (its num_frames) 64x64 crops, 1 warm-up + 1 timed step")
    zero_counts()
    rec_few = train_run(preset="few_levels", batch=1, frames=FEW_TRAIN_T, crop=64, iters=1,
                        grad_acc=1, remat=True, device="cuda")
    few_train = read_counts()
    report(f"    step {rec_few['step_ms_median']:.1f} ms, {rec_few['frames_per_s']:.3f} frames/s, "
           f"peak allocated {rec_few['peak_bytes'] / 2**30:.2f} GiB, losses "
           f"{rec_few['loss_first']:.6f} (warm-up) .. {rec_few['loss_last']:.6f}; LTAM head "
           f"width {FEW_LEVELS_PRESET.embed_dim[0] // FEW_LEVELS_PRESET.traj_heads[0]}; "
           f"launches over the timed step {few_train}")
    losses_few = [rec_few["loss_first"], *rec_few["losses"]]
    if not all(np.isfinite(v) for v in losses_few) or few_train["ltam_attention_2x2_bwd"] <= 0:
        raise AssertionError(f"few-levels training failed: losses {losses_few}, "
                             f"LTAM backward launches {few_train['ltam_attention_2x2_bwd']}")

    # each kernel's launches on the path that runs it: the LTAM backward in
    # training (phase 6), the conv chain and the norm in kernel-form serving
    # (phase 4b, 3 clips), the pin in the barrier form (phase 4b, 1 clip),
    # the token form at its op entry point (phase 2), the probe kernels at
    # the probes' (phase 2p), the others in serving (phase 4)
    paths = {"ltam_attention_2x2_bwd": ("training", train_launches),
             "fused_conv_chain": ("kernel-form serving", kernel_launches),
             "fused_norm": ("kernel-form serving", kernel_launches),
             "layout_pin": ("barrier-form serving", barrier_launches["barrier"])}
    for name in OFF_PATH:
        paths[name] = ("op entry point" if name == "fused_morphfc_axes_token"
                       else "probe entry points", entries[name]["path_launches"])
    kernels = []
    for name, e in entries.items():
        path, counts = paths.get(name, ("serving", serving_launches))
        extra = {k: v for k, v in e.items() if k in ("module_ms", "hybrid_ms", "n1", "n16")
                 or k.startswith(("groups", "d"))}
        kernels.append({"name": name, "route": e["route"], "source": e["source"],
                        "replaces": e["replaces"], "launches": counts[name],
                        "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                        "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                        "bound_by": e["bound_by"], "library_ms": e["library_ms"],
                        "at": e["at"], "launches_path": path,
                        "launches_serving": serving_launches[name],
                        "launches_kernel_forms": kernel_launches[name],
                        "launches_barrier": barrier_launches["barrier"][name],
                        "launches_training": train_launches[name],
                        "launches_training_norm_kernel": norm_train if name == "fused_norm"
                        else None,
                        "launches_few_levels_serving": few_launches[name],
                        "launches_few_levels_training": few_train[name],
                        "bound_bytes": e["bound_bytes"], "bound_flops": e["bound_flops"],
                        "bound_peak": e["bound_peak"], **extra})
    print(json.dumps({"serving": {"frames_per_s": fps, "per_request_frames_per_s": per_request,
                                  "peak_bytes": peak, "slice_max_abs_err": err},
                      "serving_kernel_forms": {
                          "frames_per_s": fps_k, "per_request_frames_per_s": per_request_k,
                          "peak_bytes": peak_k, "bf16_err_64": float(err_kernel),
                          "bf16_err_64_default": float(err_default)},
                      "serving_few_levels": {
                          "frames_per_s": fps_few, "per_request_frames_per_s": per_request_few,
                          "peak_bytes": peak_few, "slice_max_abs_err": err_few}}))
    print(json.dumps({"training": {**rec, "parity": parity},
                      "training_norm_kernel": rec_k, "training_few_levels": rec_few}))
    print(json.dumps({"probes": {k: entries[k]["probes"] for k in OFF_PATH[1:]}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
