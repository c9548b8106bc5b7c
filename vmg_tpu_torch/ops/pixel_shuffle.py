"""Pixel shuffle, channels-last, torch channel ordering
(``vmg_tpu/ops/pixel_shuffle.py``).

torch ``nn.PixelShuffle(r)`` maps input channel ``c*r^2 + i*r + j`` to
output channel ``c`` at spatial offset ``(i, j)``.  The JAX package folds
that reorder into the conv kernel for the TPU; its parameter layout is a
plain conv, so the port runs the conv and then this shuffle.
"""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(..., H, W, C*r^2) -> (..., H*r, W*r, C)."""
    *lead, H, W, Cr2 = x.shape
    C = Cr2 // (r * r)
    y = x.reshape(-1, H, W, C, r, r).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(*lead, H * r, W * r, C)
