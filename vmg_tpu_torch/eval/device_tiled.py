"""Spatial tiled inference with the tile loop on the device.

Port of ``vmg_tpu/eval/device_tiled.py``: the host loop of
``SlidingEvaluator.test_image`` copies every tile up and every output back.
Here the clip goes up once, each tile is a slice of it on the device, the
trimmed outputs and their masks accumulate in device tensors in the host
loop's order (rows of tiles, then columns), and one copy brings ``E / W``
back.  The overlap trim is the reference's: ``ov // 2`` pixels of the
SR-space tile on each side that has a neighbouring tile.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def _starts(full: int, win: int, stride: int):
    return list(range(0, full - win, stride)) + [max(0, full - win)]


def make_device_tiled_forward(apply_fn: Callable[[torch.Tensor], torch.Tensor], scale: int,
                              wins: Tuple[int, int], overlap: int,
                              image_hw: Tuple[int, int]):
    """Returns ``run(x) -> (B, T, sH, sW, C)`` float32 on x's device, for a
    (B, T, H, W, C) clip of LR size ``image_hw``; ``apply_fn(patch)`` is the
    model forward on an LR patch of ``wins``."""
    win_h, win_w = wins
    H, W = image_hw
    s, t = scale, overlap // 2
    h_list = _starts(H, win_h, win_h - overlap)
    w_list = _starts(W, win_w, win_w - overlap)

    def run(x: torch.Tensor) -> torch.Tensor:
        B, T, h, w, C = x.shape
        if (h, w) != (H, W):
            raise ValueError(f"clip of {h}x{w}; this forward tiles {H}x{W}")
        E = torch.zeros((B, T, H * s, W * s, C), dtype=torch.float32, device=x.device)
        Wacc = torch.zeros_like(E)
        for hy in h_list:
            for wx in w_list:
                out = apply_fn(x[:, :, hy: hy + win_h, wx: wx + win_w]).float()
                mask = torch.ones_like(out)
                if t > 0:
                    rows = slice(None, -t) if hy < h_list[-1] else slice(None)
                    cols = slice(None, -t) if wx < w_list[-1] else slice(None)
                    keep = torch.zeros(out.shape[2:4], dtype=torch.bool, device=x.device)
                    keep[rows, cols] = True
                    if hy > h_list[0]:
                        keep[:t] = False
                    if wx > w_list[0]:
                        keep[:, :t] = False
                    out = torch.where(keep[:, :, None], out, 0.0)
                    mask = torch.where(keep[:, :, None], mask, 0.0)
                E[:, :, hy * s: (hy + win_h) * s, wx * s: (wx + win_w) * s] += out
                Wacc[:, :, hy * s: (hy + win_h) * s, wx * s: (wx + win_w) * s] += mask
        return E / Wacc

    return run
