"""Stress the bf16 token form of the MorphFC axes op on the card: rounds of
calls queued with no synchronisation between them.

    python -m vmg_tpu_torch.tools.stress_token [--rounds 100] [--calls 40]

At each shape (stages 1/5 and 3 of FULL_PRESET, and two generic shapes
whose weight tiles stream: C = 448 and 512 at chunk 16), every round
queues ``--calls`` calls of ``fused_morphfc_axes(form="token")`` on one
seeded input, then synchronises and holds every output bit-equal to the
first call's. One JSON line per shape: the calls made, the seconds taken
and ``ok``; the first mismatch or CUDA error ends the run (a kernel fault
leaves the context unusable) with the shape and round, and exit code 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from vmg_tpu_torch.ops import morphfc_fused

# (N, H, W, C, chunk): stages 1/5 (weights resident) and 3 (streamed, the
# compile-time instantiations), then the generic streamed instantiation
SHAPES = [(16, 92, 160, 224, 16), (16, 23, 40, 448, 8), (3, 21, 32, 448, 16),
          (2, 16, 64, 512, 16)]


def _inputs(shape, gen, dev):
    N, H, W, C, _ = shape

    def rn(*size, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*size, generator=gen, device=dev) * scale).to(dtype)

    return (rn(N, H, W, C), rn(N, H, W, C, scale=0.01), rn(C, C, scale=0.02),
            rn(C, scale=0.1, dtype=torch.float32), rn(C, C, scale=0.02),
            rn(C, scale=0.1, dtype=torch.float32))


def stress(shape, rounds: int, calls: int, dev) -> dict:
    chunk = shape[-1]
    args = _inputs(shape, torch.Generator(device=dev).manual_seed(0), dev)
    first = None
    t0 = time.perf_counter()
    for r in range(rounds):
        try:
            outs = [morphfc_fused.fused_morphfc_axes(*args, chunk_h=chunk, chunk_w=chunk,
                                                     form="token") for _ in range(calls)]
            torch.cuda.synchronize()
        except RuntimeError as e:  # torch.AcceleratorError is one
            return {"shape": shape, "ok": False, "round": r, "error": str(e).splitlines()[0]}
        first = first or outs[0]
        for out in outs:
            if not all(torch.equal(a, b) for a, b in zip(first, out)):
                return {"shape": shape, "ok": False, "round": r, "error": "outputs differ"}
    return {"shape": shape, "ok": True, "calls": rounds * calls,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--calls", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stress_token needs a CUDA device", file=sys.stderr)
        return 1
    for shape in SHAPES:
        res = stress(shape, args.rounds, args.calls, torch.device("cuda"))
        print(json.dumps(res), flush=True)
        if not res["ok"]:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
