"""Time the port's training step at the ``tools/bench_train.py`` protocol.

    python -m vmg_tpu_torch.train [--preset full|few_levels|tiny] [--batch 1]
        [--frames 16] [--crop 64] [--iters 8] [--grad-acc 1] [--no-remat]
        [--norm-impl module|kernel] [--device cuda] [--ckpt-dir DIR]

The full training step (forward, backward, grouped AdamW) of a randomly
initialised model (seed 0) on one seeded synthetic batch of B clips of T
frames, LR crops crop x crop and HR 4x that: bf16 compute on float32
master weights, SPyNet float32, remat on, Charbonnier + edge loss,
SPyNet frozen through update 1 (flow_fix 0).  One warm-up step (it builds
the kernels), then ``iters`` timed steps, each ended by a host sync.
Prints one JSON line: step ms median and range, frames/s, peak device
bytes, the first (warm-up) and last loss, and the LTAM forward and
backward and fused-norm kernel launches per step.  ``--norm-impl kernel``
runs the bf16 LayerNorms through the fused norm kernel (its backward
recomputes through the plain formulation).  ``--ckpt-dir``: resume from
the latest trainer checkpoint there, if any (``vmg_tpu_torch.ckpt.io``:
parameters, optimizer moments and step, the stochastic-depth generator),
and save one after the timed steps; ``python -m vmg_tpu_torch.eval
--checkpoint DIR`` evaluates it.  Training on a dataset (the clip
datasets, the prefetching loader, ``tools/train.py``'s loop) is ``python
-m vmg_tpu_torch.tools.train``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from vmg_tpu_torch.ckpt.io import (latest_step, load_trainer_state, restore_checkpoint,
                                   save_checkpoint, trainer_state)
from vmg_tpu_torch.configs import (FEW_LEVELS_PRESET, FULL_PRESET, TINY_TEST_PRESET,
                                   TrainConfig)
from vmg_tpu_torch.models.vmg import create_model
from vmg_tpu_torch.ops.fused_norm import fused_norm
from vmg_tpu_torch.ops.ltam_attention import ltam_attention_2x2
from vmg_tpu_torch.train.train_step import make_train_step

PRESETS = {"full": FULL_PRESET, "few_levels": FEW_LEVELS_PRESET, "tiny": TINY_TEST_PRESET}


def setup(preset: str = "full", batch: int = 1, frames: int = 16, crop: int = 64,
          grad_acc: int = 1, remat: bool = True, device="cuda", seed: int = 0,
          norm_impl: str = "module", network=None):
    """The protocol's step function, its seeded batch on ``device`` and the
    stochastic-depth generator: (step, batch, generator).  ``network``: a
    ``VMGNetworkConfig`` in place of the preset's."""
    dev = torch.device(device)
    cfg = dataclasses.replace(PRESETS[preset] if network is None else network, remat=remat)
    tcfg = TrainConfig(lr=2e-4, T_period=(400000,), if_aux=True, amp=True)
    model = create_model(cfg, is_train=True, device=dev,
                         generator=torch.Generator().manual_seed(seed),
                         norm_impl=norm_impl)
    rng = np.random.default_rng(seed)
    data = {"LRs": rng.random((batch, frames, crop, crop, 3), dtype=np.float32),
            "HRs": rng.random((batch, frames, 4 * crop, 4 * crop, 3), dtype=np.float32)}
    data = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    step = make_train_step(model, tcfg, grad_acc=grad_acc, flow_fix=0)
    return step, data, torch.Generator(device=dev).manual_seed(seed + 1)


def run(preset: str = "full", batch: int = 1, frames: int = 16, crop: int = 64,
        iters: int = 8, grad_acc: int = 1, remat: bool = True, device="cuda",
        seed: int = 0, norm_impl: str = "module", ckpt_dir: Optional[str] = None,
        network=None) -> dict:
    """Warm-up step plus ``iters`` timed steps; returns the record.  With
    ``ckpt_dir``: first resume from its latest checkpoint, if any, and save
    one at the end.  ``network``: see :func:`setup`."""
    dev = torch.device(device)
    step, data, gen = setup(preset, batch, frames, crop, grad_acc, remat, dev, seed,
                            norm_impl, network)
    cuda = dev.type == "cuda"
    resumed = None
    if ckpt_dir is not None and latest_step(ckpt_dir) is not None:
        resumed = load_trainer_state(restore_checkpoint(ckpt_dir), step.model, step, gen)

    loss_first = float(step(data, gen)["loss"])
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ltam_attention_2x2.launches = ltam_attention_2x2.bwd_launches = 0
    fused_norm.launches = 0
    times, losses = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        m = step(data, gen)
        losses.append(float(m["loss"]))
        if cuda:
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    saved = None
    if ckpt_dir is not None:
        saved = step.optimizer.count
        save_checkpoint(ckpt_dir, saved, trainer_state(step.model, step, gen))
    return {
        "metric": (f"train step ({preset} preset, B={batch}, T={frames}, {crop}x{crop} "
                   f"crops, grad_acc={grad_acc}, remat={remat}, norm_impl={norm_impl}, "
                   "bf16 + f32 masters)"),
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "step_ms_median": med * 1e3,
        "step_ms_min": min(times) * 1e3,
        "step_ms_max": max(times) * 1e3,
        "frames_per_s": batch * frames / med,
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
        "loss_first": loss_first,
        "loss_last": losses[-1],
        "losses": losses,
        "ltam_fwd_launches_per_step": ltam_attention_2x2.launches / iters,
        "ltam_bwd_launches_per_step": ltam_attention_2x2.bwd_launches / iters,
        "norm_launches_per_step": fused_norm.launches / iters,
        "resumed_from_step": resumed,
        "saved_step": saved,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="full", choices=sorted(PRESETS))
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--crop", type=int, default=64)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--grad-acc", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true",
                    help="keep every activation instead of recomputing each TAB "
                         "and trajectory step in the backward pass")
    ap.add_argument("--norm-impl", default="module", choices=["module", "kernel"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="resume from the latest checkpoint here, if any; save one at the end")
    args = ap.parse_args(argv)
    rec = run(args.preset, args.batch, args.frames, args.crop, args.iters,
              args.grad_acc, not args.no_remat, args.device, norm_impl=args.norm_impl,
              ckpt_dir=args.ckpt_dir)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
