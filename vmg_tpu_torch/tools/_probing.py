"""What the two probe tools share: seeded inputs, the checks and timings
of one probe, and the command line.

A probe calls its kernel wrapper and the plain version on the same input
and fails unless a copy is bit-exact and a product is within 1 bf16 ulp of
the largest plain output (8e-3 of it: f32 sums in another order, then one
rounding).  On the card it then times the kernel, the plain version and
the one PyTorch call that computes the same function (``utils.profiling.
timed``), and gives the bound (``utils.profiling.bound``: the bytes the
function must move over the HBM rate, or its operations over the bf16
tensor-core peak, whichever is longer).  On the CPU no time is taken.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from vmg_tpu_torch.utils.profiling import bound, timed

GEMM_REL_TOL = 8e-3  # 1 bf16 ulp (2**-7) of the largest output, rounded up
ITERS = 20


def bf16_input(rng, shape, dev, scale=None):
    """rng.random (uniform [0, 1)) or, with ``scale``, scaled normals, as the
    JAX tools draw them; then bf16 on ``dev``."""
    a = (rng.random(shape, np.float32) if scale is None
         else rng.standard_normal(shape).astype(np.float32) * scale)
    return torch.from_numpy(a).to(dev, torch.bfloat16)


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _bound(nbytes, flops):
    return {**bound(nbytes, flops), "bytes": nbytes, "flops": flops}


def _times(dev, kernel, plain, library):
    if dev.type != "cuda":
        return {"ms": None, "plain_ms": None, "library_ms": None}
    return {"ms": timed(kernel, iters=ITERS) * 1e3,
            "plain_ms": timed(plain, iters=ITERS) * 1e3,
            "library_ms": None if library is None else timed(library, iters=ITERS) * 1e3}


def copy_probe(dev, kernel, plain, library, read_bytes):
    """A copy: bit-exact against the plain version; ``read_bytes`` of
    input the output depends on."""
    got, want = kernel(), plain()
    maxdiff = (got.float() - want.float()).abs().max().item()
    if tuple(got.shape) != tuple(want.shape) or maxdiff != 0.0:
        raise AssertionError(f"not bit-exact: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, maxdiff {maxdiff}")
    return {"maxdiff": maxdiff, **_times(dev, kernel, plain, library),
            **_bound(read_bytes + _nbytes(want), 0)}


def gemm_probe(dev, kernel, plain, library, read_bytes, flops, all_sms=None):
    """A product: within GEMM_REL_TOL of max|plain|.  ``all_sms(reps)``
    runs the same tile ``reps`` times in one launch; on the card it runs
    once per SM, each copy checked bit-equal to the single tile."""
    got, want = kernel(), plain()
    maxdiff = (got.float() - want.float()).abs().max().item()
    tol = GEMM_REL_TOL * want.float().abs().max().item()
    if tuple(got.shape) != tuple(want.shape) or not maxdiff <= tol:
        raise AssertionError(f"shape {tuple(got.shape)} vs {tuple(want.shape)}, maxdiff "
                             f"{maxdiff} over {tol} (1 bf16 ulp of max|plain|)")
    res = {"maxdiff": maxdiff, "tol": tol, **_times(dev, kernel, plain, library),
           **_bound(read_bytes + _nbytes(want), flops)}
    res["tf_s"] = None if res["ms"] is None else flops / res["ms"] / 1e9
    if all_sms is not None and dev.type == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        many = all_sms(sms)
        torch.cuda.synchronize()
        if not (torch.equal(many[0], got) and torch.equal(many[-1], got)):
            raise AssertionError("a copy of the tile run on every SM differs from the tile")
        ms = timed(lambda: all_sms(sms), iters=5) * 1e3
        res.update(sms=sms, ms_all_sms=ms, tf_s_all_sms=sms * flops / ms / 1e9)
    return res


def main(probes, argv=None, description=None) -> int:
    """Run every probe in order on one seeded generator (numpy, seed 0),
    one JSON line each; a probe that fails prints "ERR ...".  Returns 1 if
    any probe failed."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (the kernels, timed) or cpu (the plain versions)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: the probes' kernels need one (--device cpu runs the plain "
              "versions)", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rng = np.random.default_rng(0)
    failed = False
    for name, probe in probes.items():
        try:
            r = {**probe(dev, rng), "device": kind}
        except Exception as e:  # noqa: BLE001 -- reported, and the run fails
            r, failed = f"ERR {type(e).__name__}: {e}"[:200], True
        print(json.dumps({name: r}), flush=True)
    return 1 if failed else 0
