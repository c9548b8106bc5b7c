"""Where the serving forward's time goes on one CUDA card.

    python3 -m vmg_tpu_torch.profile_serving [--reps 5] [--forms module|kernel]
        [--preset full|few_levels] [--json PATH]

``FULL_PRESET`` in bf16 with the serving fast-math (tanh GELU, bf16
SPyNet convolutions), seeded random init, 1x16x180x320 clips, in the
default (module) forms or, with ``--forms kernel``, with the three opt-in
kernel forms on (the RCAB and trajectory conv chains, the fused norm).
``--preset few_levels``: ``FEW_LEVELS_PRESET`` with its eval preset's
network fields (32 frames, one 32-frame trajectory window, no flow
freeze) on 1x32x128x128 clips, the eval preset's 128x128 tile.
Reports:

* the device-resident forward per clip (input already on the card, output
  left there): CUDA-event time, median and range over ``--reps`` runs
  after a warm-up;
* ``SRServer`` per clip (numpy in, numpy out), host clock, median and
  range over ``--reps`` requests;
* from one profiled device-resident forward (``torch.profiler``, device
  activity only: tracing host operators slows the host's launches and
  would idle the device more than an untraced run does): device time by
  kernel category and the longest kernels, and the device's idle share,
  1 - (union of the device activity intervals) / (first device activity
  start to last end), read from the trace's device timeline.

Prints a table and one JSON line; ``--json`` also writes the JSON there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# preset -> (clip frames, height, width); few_levels also takes its eval
# preset's network fields (vmg_eval_reds4_few_levels.yml)
CLIPS = {"full": (16, 180, 320), "few_levels": (32, 128, 128)}
FEW_EVAL = dict(num_frames=32, traj_win=(32, None), flow_fix=None)

# (category, kernel-name pattern), first match wins
CATEGORIES = [
    ("FFN kernel", r"vmg::group_ffn"),
    ("MorphFC axes kernel", r"vmg::morphfc_axes"),
    ("MorphFC reduce kernel (pass 1)", r"vmg::morphfc_partial"),
    ("MorphFC sums, fixed-order pass (axes, reduce)", r"vmg::morphfc_final"),
    ("MorphFC combine kernel", r"vmg::morphfc_combine"),
    ("LTAM backward kernels", r"vmg::ltam_bwd"),
    ("LTAM kernel", r"vmg::ltam"),
    ("conv chain kernel", r"vmg::conv3x3_wgmma|vmg::conv_chain|vmg::chain_psum"),
    ("fused norm kernel", r"vmg::norm_kernel"),
    ("layout pin kernel", r"vmg::copy(_vec|1)_kernel"),
    ("LayerNorm", r"layer_norm"),
    ("convolutions (cuDNN)", r"fprop|cudnn|conv|implicit_gemm"),
    ("matmuls (cuBLAS)", r"gemm|nvjet|cutlass"),
    ("copies", r"copy|memcpy|Memcpy|memset|Memset"),
    ("grid_sample", r"grid_sampler"),
    ("gathers (index)", r"index"),
    ("reductions", r"reduce"),
    ("elementwise", r"elementwise"),
]
# device-timeline entries that are waits, not work
WAITS = ("Command Buffer Full",)


def category(name: str) -> str:
    for cat, pat in CATEGORIES:
        if re.search(pat, name):
            return cat
    return "other"


def union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_events(prof):
    """(name, start_us, end_us) of every device activity in the trace."""
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def spread(values):
    return {"median": float(np.median(values)), "min": float(min(values)),
            "max": float(max(values)), "values": [float(v) for v in values]}


def trace_summary(prof) -> dict:
    """Device events, busy time, span, idle share, device time by category
    and the longest kernels of a device-activity trace."""
    events = device_events(prof)
    work = [(n, s, e) for n, s, e in events if n not in WAITS]
    by_cat, by_name = {}, {}
    for n, s, e in work:
        for table, key in ((by_cat, category(n)), (by_name, n)):
            calls, us = table.get(key, (0, 0.0))
            table[key] = (calls + 1, us + (e - s))
    busy_us = union_us([(s, e) for _, s, e in work])
    span_us = (max(e for _, _, e in events) - min(s for _, s, _ in events)) if events else 0.0
    return {
        "device_events": len(events),
        "busy_ms": busy_us / 1e3, "span_ms": span_us / 1e3,
        "idle_share": (1.0 - busy_us / span_us) if span_us else None,
        "waits_ms": sum(e - s for n, s, e in events if n in WAITS) / 1e3,
        "by_category_ms": {k: {"calls": c, "ms": us / 1e3} for k, (c, us) in
                           sorted(by_cat.items(), key=lambda kv: -kv[1][1])},
        "top_kernels_ms": [{"name": k[:160], "calls": c, "ms": us / 1e3} for k, (c, us) in
                           sorted(by_name.items(), key=lambda kv: -kv[1][1])[:20]],
    }


def print_trace(tr: dict, what: str) -> None:
    if not tr["device_events"]:
        print("trace: no device activity recorded; idle share not measured")
        return
    print(f"trace of one {what}: {tr['device_events']} device events; device busy "
          f"{tr['busy_ms']:.2f} ms of a {tr['span_ms']:.2f} ms span, idle share "
          f"{tr['idle_share']:.4f}; waits {tr['waits_ms']:.2f} ms")
    print(f"{'device time by category':48s} {'calls':>6s} {'ms':>9s} {'share':>7s}")
    for k, v in tr["by_category_ms"].items():
        print(f"{k:48s} {v['calls']:6d} {v['ms']:9.3f} {v['ms'] / tr['busy_ms']:7.2%}")
    print("longest kernels:")
    for k in tr["top_kernels_ms"][:12]:
        print(f"  {k['calls']:6d} {k['ms']:9.3f} ms  {k['name'][:110]}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--forms", default="module", choices=["module", "kernel"],
                    help="'kernel': rcab_impl, traj_conv_impl and norm_impl 'kernel'")
    ap.add_argument("--preset", default="full", choices=sorted(CLIPS))
    ap.add_argument("--json", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    T, H, W = CLIPS[args.preset]
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device visible", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from vmg_tpu_torch.configs import FEW_LEVELS_PRESET, FULL_PRESET
    from vmg_tpu_torch.models.vmg import KERNEL_FORMS, create_model
    from vmg_tpu_torch.serve import SRServer

    smi = card_line()
    base = FULL_PRESET if args.preset == "full" else FEW_LEVELS_PRESET
    preset = base if args.preset == "full" else dataclasses.replace(base, **FEW_EVAL)
    sd = create_model(base, device="cpu",
                      generator=torch.Generator().manual_seed(0)).state_dict()
    forms = KERNEL_FORMS if args.forms == "kernel" else {}
    server = SRServer(preset, sd, "cuda", torch.bfloat16, gelu="tanh", fast_flow=True,
                      **forms)
    clip = np.random.default_rng(0).random((1, T, H, W, 3), dtype=np.float32)
    x = torch.from_numpy(clip).cuda()

    with torch.inference_mode():
        server.model(x)  # warm-up: kernel build, cuDNN plans
        torch.cuda.synchronize()
        resident = []
        for _ in range(args.reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            server.model(x)
            end.record()
            torch.cuda.synchronize()
            resident.append(start.elapsed_time(end) / 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            server.model(x)
            torch.cuda.synchronize()
    served = []
    for _ in range(args.reps):
        t0 = time.time()
        server(clip)
        served.append(time.time() - t0)

    result = {
        "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "preset": args.preset, "forms": args.forms, "clip": [1, T, H, W],
        "resident_s_per_clip": spread(resident), "served_s_per_clip": spread(served),
        "served_frames_per_s": spread([T / s for s in served]),
        "trace": trace_summary(prof),
    }

    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{args.preset} preset, 1x{T}x{H}x{W} clips, {args.forms} forms")
    r, s = result["resident_s_per_clip"], result["served_s_per_clip"]
    print(f"device-resident forward: median {r['median']:.4f} s per clip "
          f"(range {r['min']:.4f}-{r['max']:.4f}, {args.reps} reps, CUDA events)")
    print(f"SRServer: median {s['median']:.4f} s per clip (range {s['min']:.4f}-"
          f"{s['max']:.4f}, host clock), {T / s['median']:.3f} frames/s")
    print_trace(result["trace"], "forward")
    line = json.dumps(result)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
