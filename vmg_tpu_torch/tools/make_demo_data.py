"""A tiny REDS-layout demo dataset for overfit training, the counterpart of
``tools/make_demo_data.py``: one clip of a textured scene (mixed
sinusoids and moving squares) drifting over time, HR as a packed tree, LR
by MATLAB's bicubic /4 (``ops.resize.imresize_matlab``, on the card unless
``--device cpu``), the PNG frames of both under ``val/`` for validation,
and the bicubic-upsampling PSNR as the bar training must clear.

    python -m vmg_tpu_torch.tools.make_demo_data --out /tmp/vmg_demo --frames 30
    python -m vmg_tpu_torch.tools.train --config demo_overfit \\
        --val-lr-root /tmp/vmg_demo/val/LR --val-gt-root /tmp/vmg_demo/val/GT
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from vmg_tpu_torch.data.storage import PackedWriter
from vmg_tpu_torch.eval.png import write_png
from vmg_tpu_torch.ops.resize import imresize_matlab


def make_frame(t: float, h: int, w: int) -> np.ndarray:
    """Frame ``t`` of the scene, float32 RGB in [0, 1]."""
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    img = np.zeros((h, w, 3), np.float32)
    # drifting plaid of incommensurate frequencies per channel
    for c, (fy, fx, sp) in enumerate([(0.031, 0.055, 17.0), (0.047, 0.023, -11.0),
                                      (0.019, 0.041, 7.0)]):
        img[..., c] = 0.5 + 0.25 * np.sin(
            2 * np.pi * (fy * (yy + sp * t) + fx * (xx - sp * t))
        ) + 0.15 * np.sin(2 * np.pi * (0.09 * xx + 0.5 * sp * t * 0.04))
    # moving high-contrast squares (sharp edges)
    for i in range(6):
        size = 12 + 6 * i
        cy = int((0.13 * (i + 1) * h + 9.0 * t * (1 + 0.3 * i)) % (h - size))
        cx = int((0.17 * (i + 1) * w - 6.0 * t * (1 + 0.2 * i)) % (w - size))
        color = np.asarray([(i * 53) % 255, (i * 97) % 255, (i * 151) % 255],
                           np.float32) / 255.0
        img[cy:cy + size, cx:cx + size] = color
    return np.clip(img, 0.0, 1.0)


def make_demo(out: str, frames: int = 30, size: int = 256, device="cuda") -> float:
    """Write the demo tree under ``out``; returns the mean bicubic PSNR."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible; pass --device cpu to resize on the CPU")
    h = w = size
    os.makedirs(out, exist_ok=True)
    hr_w = PackedWriter(os.path.join(out, "hr.pack"), (h, w, 3))
    lr_w = PackedWriter(os.path.join(out, "lr.pack"), (h // 4, w // 4, 3))
    val_lr, val_gt = os.path.join(out, "val", "LR", "000"), os.path.join(out, "val", "GT", "000")
    os.makedirs(val_lr, exist_ok=True)
    os.makedirs(val_gt, exist_ok=True)
    psnrs = []
    for i in range(frames):
        hr = make_frame(float(i), h, w)
        lr = imresize_matlab(torch.from_numpy(hr).to(dev), 0.25).cpu().numpy()
        hr_u8 = np.round(hr * 255).astype(np.uint8)
        lr_u8 = np.round(np.clip(lr, 0, 1) * 255).astype(np.uint8)
        hr_w.add(f"000_{i}", hr_u8, clip_key="000")
        lr_w.add(f"000_{i}", lr_u8, clip_key="000")
        write_png(os.path.join(val_lr, f"{i:08d}.png"), lr_u8)
        write_png(os.path.join(val_gt, f"{i:08d}.png"), hr_u8)
        bi = imresize_matlab(torch.from_numpy(lr_u8.astype(np.float32) / 255).to(dev),
                             4.0).cpu().numpy()
        bi_u8 = np.round(np.clip(bi, 0, 1) * 255).astype(np.uint8)
        mse = np.mean((bi_u8.astype(np.float64) - hr_u8.astype(np.float64)) ** 2)
        psnrs.append(10 * np.log10(255.0 ** 2 / mse))
    hr_w.close()
    lr_w.close()
    return float(np.mean(psnrs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="VMG demo dataset")
    ap.add_argument("--out", default="/tmp/vmg_demo")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    psnr = make_demo(args.out, args.frames, args.size, args.device)
    print(f"demo dataset: {args.frames} frames at {args.size}x{args.size} -> {args.out}")
    print(f"bicubic-upsample baseline PSNR: {psnr:.3f} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
