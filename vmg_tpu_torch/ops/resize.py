"""Resizing and pooling on channels-last tensors (``vmg_tpu/ops/resize.py``).

The JAX package builds these from dense per-axis weight matrices so XLA
maps them onto the TPU's matrix unit; on the GPU PyTorch's own resamplers
compute the same functions (torch ``F.interpolate`` / pooling semantics
are the reference the JAX versions were written against).  Every function
takes ``(..., H, W, C)`` and returns the same dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _to_nchw(x: torch.Tensor):
    *lead, H, W, C = x.shape
    return x.reshape(-1, H, W, C).permute(0, 3, 1, 2), lead


def _from_nchw(y: torch.Tensor, lead):
    N, C, H, W = y.shape
    return y.permute(0, 2, 3, 1).reshape(*lead, H, W, C)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize, ``F.interpolate`` semantics, computed in float32."""
    y, lead = _to_nchw(x)
    y = F.interpolate(y.float(), size=(out_h, out_w), mode="bilinear",
                      align_corners=align_corners)
    return _from_nchw(y, lead).to(x.dtype)


def upsample_trilinear_frames(x: torch.Tensor, scale: int) -> torch.Tensor:
    """xN spatial upsampling of a (B, T, H, W, C) clip: trilinear with an
    unscaled depth axis is per-frame half-pixel bilinear."""
    B, T, H, W, C = x.shape
    return resize_bilinear(x, H * scale, W * scale, align_corners=False)


def avg_pool2d(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Average pool with a k x k window and stride k, no padding."""
    y, lead = _to_nchw(x)
    return _from_nchw(F.avg_pool2d(y, k), lead)


def adaptive_avg_pool2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    y, lead = _to_nchw(x)
    y = F.adaptive_avg_pool2d(y.float(), (out_h, out_w))
    return _from_nchw(y, lead).to(x.dtype)


def adaptive_max_pool2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    y, lead = _to_nchw(x)
    return _from_nchw(F.adaptive_max_pool2d(y, (out_h, out_w)), lead)
