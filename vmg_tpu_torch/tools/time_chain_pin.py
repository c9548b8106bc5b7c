"""The bf16 conv chain and the layout pin of two checkouts of the port,
timed on one card with one timer.

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
each, ``layout_pin`` on 1x184x320x224 and ``x.clone()`` beside it.  Each
kernel is first held to its own tree's plain version (1e-2 of max|plain|,
the pin exactly).  One JSON line per process (median and range over
``--reps`` timings of 20 calls each), then the card's name and power
limit, then one JSON line of this checkout's median over the other's for
each timing.
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


def _this_timer():
    """This checkout's ``timed``, loaded from its file whatever tree the
    process imports ``vmg_tpu_torch`` from."""
    spec = importlib.util.spec_from_file_location(
        "_this_profiling", _ROOT / "vmg_tpu_torch" / "utils" / "profiling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.timed


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


def _side(root: Path, reps: int) -> dict:
    """Times the chain, the pin and their yardsticks with the package at
    ``root``; raises if a kernel disagrees with its plain version."""
    sys.path.insert(0, str(root))
    import torch
    import torch.nn.functional as F

    import vmg_tpu_torch
    from vmg_tpu_torch.ops import conv_chain

    pkg = Path(vmg_tpu_torch.__file__).resolve().parent
    if pkg != root.resolve() / "vmg_tpu_torch":
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("time_chain_pin times the card and needs a CUDA device")
    timed = _this_timer()
    dev, dt = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dt)

    def time_both(fn):
        new = [timed(fn, iters=_ITERS, warmup=3) * 1e3 for _ in range(reps)]
        old = [_unfenced(fn, _ITERS) * 1e3 for _ in range(reps)]
        return {"ms": statistics.median(new), "range": [min(new), max(new)],
                "ms_unfenced": statistics.median(old),
                "range_unfenced": [min(old), max(old)]}

    out = {"tree": str(root), "package": str(pkg)}
    C, h, w = 112, 184, 320
    with torch.no_grad():
        for N, kw in ((1, dict(res_scale=0.1)), (16, dict(emit_psum=True))):
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
        x = rn(1, h, w, 2 * C)
        if not torch.equal(conv_chain.layout_pin(x), x):
            raise AssertionError("the pin's copy differs from its input")
        out["pin"] = time_both(lambda: conv_chain.layout_pin(x))
        out["clone"] = time_both(lambda: x.clone())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="root of the other checkout")
    ap.add_argument("--side", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if args.side is not None:
        print(json.dumps(_side(args.side, args.reps)), flush=True)
        return 0
    if args.other is None:
        ap.error("--other is required")
    runs = []
    for label, root in (("other", args.other), ("this", _ROOT), ("this", _ROOT),
                        ("other", args.other)):
        res = subprocess.run([sys.executable, __file__, "--side", str(root.resolve()),
                              "--reps", str(args.reps)],
                             stdout=subprocess.PIPE, text=True, check=True, timeout=900)
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": label, **line}), flush=True)
        runs.append((label, line))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())
    ratios = {}
    for key in ("chain_n1", "chain_n16", "module_n1", "module_n16", "pin", "clone"):
        for timer in ("ms", "ms_unfenced"):
            med = {s: statistics.median(r[key][timer] for lab, r in runs if lab == s)
                   for s in ("this", "other")}
            ratios[f"{key}.{timer}"] = {**med, "this_over_other": med["this"] / med["other"]}
    print(json.dumps({"this_over_other": ratios}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
