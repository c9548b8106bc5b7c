"""Where the training step's time goes on one CUDA card.

    python3 -m vmg_tpu_torch.profile_training [--iters 5] [--json PATH]

The step of ``python -m vmg_tpu_torch.train`` (``FULL_PRESET``, bf16
compute on float32 masters, remat, B=1, T=16, 64x64 crops, seeded data).
Reports the step's host-clock time, each step ended by a synchronise
(median and range over ``--iters`` steps after a warm-up step), and from
one profiled step (device activity only, as ``profile_serving``): the
device events, device time by kernel category, the longest kernels and
the device's idle share.  Prints a table and one JSON line; ``--json``
also writes the JSON there.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from vmg_tpu_torch.profile_serving import card_line, print_trace, spread, trace_summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--json", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_training: no CUDA device visible", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from vmg_tpu_torch.train.__main__ import setup

    smi = card_line()
    step, data, gen = setup()
    step(data, gen)  # warm-up: kernel build, cuDNN plans
    torch.cuda.synchronize()
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        step(data, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(data, gen)
        torch.cuda.synchronize()
    result = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "step_s": spread(times), "trace": trace_summary(prof)}

    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    t = result["step_s"]
    print(f"training step: median {t['median']:.4f} s (range {t['min']:.4f}-{t['max']:.4f}, "
          f"{args.iters} steps, host clock)")
    print_trace(result["trace"], "step")
    line = json.dumps(result)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
