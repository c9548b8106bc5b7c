#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vmg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card name and power limit; build the CUDA kernels from
     vmg_tpu_torch/csrc and time the build;
  2. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes, in float32 (TF32 off) and bf16, each timed
     (CUDA events) next to its plain version (the MorphFC axis-branch
     kernel also next to the 'hybrid' form it replaces at stages 0/6);
  3. slice parity: FULL_PRESET in float32 at 1x2x64x64, kernel path on the
     card against the plain path (CPU tensors) with the same weights;
  4. serving: an SRServer on FULL_PRESET in bf16 (tanh GELU, bf16 SPyNet
     convs), seeded random init, 1x16x180x320 clips: one warm-up request,
     then 3 clips x 3 reps, each request timed; the output must be finite
     and (1,16,720,1280,3) and every kernel's launch count over the run
     must be > 0.
Prints a {"kernels": [...]} JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import copy
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


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip()


def cuda_ms(fn, iters=10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def check_kernels(report):
    """Phase 2.  Returns one dict per kernel for the JSON line."""
    from vmg_tpu_torch.models.blocks import _axis_mix
    from vmg_tpu_torch.ops import group_conv, ltam_attention, morphfc_fused
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
    }
    for e in entries.values():
        e.update(route="cuda", max_abs_err=0.0)

    def compare(name, shape, dtype, kernel, plain, check, primary, extra=""):
        """Check and time one kernel call.  ``check(got, want)`` gives one
        (label, max_abs_err, ok, text) per output; ``primary``: the bf16
        stage-0 call whose times go into the JSON line."""
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
        report(f"  {name:22s} {str(dtype):15s} {str(shape):26s} {text} ok  "
               f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms{extra}")
        e = entries[name]
        e["max_abs_err"] = max([e["max_abs_err"]] + [err for _, err, _, _ in results])
        if primary:
            e.update(ms=ms, plain_ms=plain_ms, at=f"{dtype} {shape}")

    def dtype_check(dtype):
        return lambda got, want: [within_max(got[0], want[0], REL_TOL[dtype])]

    # the four FFN stage shapes (N = 16 frames): stage 0/6, 1/5, 2/4, 3
    ffn_shapes = [(16, 184, 320, 112), (16, 92, 160, 224), (16, 46, 80, 224),
                  (16, 23, 40, 448)]
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ffn_shapes:
            N, h, w, C = shape
            Fh = 6 * C
            x = rn(N, h, w, C, dtype=dtype)
            w1 = rn(Fh, C // 4, 3, 3, scale=(9 * C / 4) ** -0.5, dtype=dtype)
            b1, b2 = rn(Fh, scale=0.1, dtype=dtype), rn(C, scale=0.1, dtype=dtype)
            w2 = rn(C, Fh, scale=0.02, dtype=dtype)
            args = (x, *group_conv.pack_ffn_weights(w1, b1, w2, 4), b2)
            compare("fused_group_ffn", shape, dtype,
                    lambda: group_conv.fused_group_ffn(*args, groups=4, act="tanh"),
                    lambda: group_conv.group_ffn_plain(*args, groups=4, act="tanh"),
                    dtype_check(dtype), primary=dtype == torch.bfloat16 and C == 112)
            del x, w1, args

        # the axis-branch kernel at stages 0/6: chunk 8 along H and W
        N, h, w, C, ck = 16, 184, 320, 112, 8
        x, xc = rn(N, h, w, C, dtype=dtype), rn(N, h, w, C, scale=0.01, dtype=dtype)
        gamma = torch.from_numpy(morphfc_decay_np(ck, C // ck)).to(dev, dtype)
        kh, kw = ((rn(C, C, scale=0.02, dtype=dtype) * gamma).contiguous() for _ in range(2))
        bh, bw = rn(C, scale=0.1), rn(C, scale=0.1)
        args = (x, xc, kh, bh, kw, bw)

        def axes_check(got, want):
            terms = sum(v.float().abs().sum(dim=(1, 2)) for v in (want[0], want[1], xc))
            return [within_max(got[0], want[0], REL_TOL[dtype], "h "),
                    within_max(got[1], want[1], REL_TOL[dtype], "w "),
                    within_sum(got[2], want[2], terms, "psum ")]

        def hybrid():  # what stages 0/6 ran before: XLA-form axis FCs + reduce
            hh = _axis_mix(x, kh, bh.to(dtype), ck, 1).contiguous()
            ww = _axis_mix(x, kw, bw.to(dtype), ck, 2).contiguous()
            return morphfc_fused.fused_morphfc_reduce(hh, ww, xc)

        compare("fused_morphfc_axes", (N, h, w, C, ck), dtype,
                lambda: morphfc_fused.fused_morphfc_axes(*args, chunk_h=ck, chunk_w=ck),
                lambda: morphfc_fused.morphfc_axes_plain(*args, chunk_h=ck, chunk_w=ck),
                axes_check, primary=dtype == torch.bfloat16,
                extra=f"  hybrid form {cuda_ms(hybrid, iters=3):.3f} ms")
        del x, xc, args

        for shape in ((16, 184, 320, 112), (16, 23, 40, 448)):
            N, h, w, C = shape
            xh, xw, xc, x, res = (rn(*shape, dtype=dtype) for _ in range(5))
            primary = dtype == torch.bfloat16 and C == 112
            terms = sum(v.float().abs().sum(dim=(1, 2)) for v in (xh, xw, xc))
            compare("fused_morphfc_reduce", shape, dtype,
                    lambda: morphfc_fused.fused_morphfc_reduce(xh, xw, xc),
                    lambda: morphfc_fused.morphfc_reduce_plain(xh, xw, xc),
                    lambda got, want: [within_sum(got[0], want[0], terms)],
                    primary)
            a = torch.softmax(rn(N, 3, C), dim=1).to(dtype)
            pk, pb = rn(C, C, scale=0.02, dtype=dtype), rn(C, scale=0.1)
            args = (x, xh, xw, xc, a, pk, pb)
            compare("fused_morphfc_combine", shape, dtype,
                    lambda: morphfc_fused.fused_morphfc_combine(*args, residual=res),
                    lambda: morphfc_fused.morphfc_combine_plain(*args, residual=res),
                    dtype_check(dtype), primary)
            del xh, xw, xc, x, res, args

        N, h, w, C, K, heads = 1, 184, 320, 112, 5, 4
        q = torch.nn.functional.normalize(rn(N, h, w, C), dim=-1) * (C // heads) ** -0.5
        kv = rn(N, h, w, K * 2 * C, dtype=dtype)
        pe = torch.exp(rn(K, 4, 4, heads, scale=0.02))
        compare("ltam_attention_2x2", (N, h, w, C, K), dtype,
                lambda: ltam_attention.ltam_attention_2x2(q, kv, pe, K=K, heads=heads),
                lambda: ltam_attention.ltam_attention_plain(q, kv, pe, K=K, heads=heads),
                dtype_check(torch.float32),  # f32 output: f32 tolerance
                primary=dtype == torch.bfloat16)
        del q, kv
    torch.cuda.empty_cache()
    return entries


def launch_counts():
    from vmg_tpu_torch.ops import group_conv, ltam_attention, morphfc_fused
    return {"fused_group_ffn": group_conv.fused_group_ffn,
            "fused_morphfc_axes": morphfc_fused.fused_morphfc_axes,
            "fused_morphfc_reduce": morphfc_fused.fused_morphfc_reduce,
            "fused_morphfc_combine": morphfc_fused.fused_morphfc_combine,
            "ltam_attention_2x2": ltam_attention.ltam_attention_2x2}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's kernels need one",
              file=sys.stderr)
        return 1
    from vmg_tpu_torch import _build
    from vmg_tpu_torch.configs import FULL_PRESET
    from vmg_tpu_torch.models.vmg import create_model
    from vmg_tpu_torch.ops.resize import upsample_trilinear_frames
    from vmg_tpu_torch.serve import SRServer

    def report(msg):
        print(msg, flush=True)

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    report(f"[1] card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    _build.load_library()
    report(f"[1] kernels built and loaded in {time.time() - t0:.1f} s")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report("[2] kernels vs plain versions on the card (tol: f32 "
           f"{REL_TOL[torch.float32]}, bf16 {REL_TOL[torch.bfloat16]} of max|plain|; "
           f"f32 sums {SUM_TOL:g} of the sum of |terms|)")
    entries = check_kernels(report)

    report("[3] slice parity: FULL_PRESET f32 1x2x64x64, kernels on the card vs "
           "plain versions on CPU tensors, same weights")
    sd = create_model(FULL_PRESET, generator=torch.Generator().manual_seed(0)).state_dict()
    cpu_model = create_model(FULL_PRESET)
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
    counters = launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
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
    launches = {name: fn.launches for name, fn in counters.items()}
    fps = T * reps * len(clips) / dt
    peak = torch.cuda.max_memory_allocated()
    report(f"    {fps:.3f} frames/s ({dt / (reps * len(clips)):.3f} s per clip, host "
           f"clock, numpy in/out); per request median {np.median(per_request):.3f}, "
           f"range {min(per_request):.3f}-{max(per_request):.3f} frames/s; peak "
           f"allocated {peak / 2**30:.2f} GiB; {kind}; card {smi}")
    report(f"    launches over the serving run: {launches}")
    if out.shape != (1, T, 4 * H, 4 * W, 3) or not np.isfinite(out).all():
        raise AssertionError(f"bad serving output {out.shape}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    kernels = []
    for name, e in entries.items():
        kernels.append({"name": name, "route": e["route"], "source": e["source"],
                        "replaces": e["replaces"], "launches": launches[name],
                        "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                        "plain_ms": e["plain_ms"], "at": e["at"]})
    print(json.dumps({"serving": {"frames_per_s": fps, "per_request_frames_per_s": per_request,
                                  "peak_bytes": peak, "slice_max_abs_err": err}}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
