"""Resizing and pooling on channels-last tensors (``vmg_tpu/ops/resize.py``).

The JAX package builds these from dense per-axis weight matrices so XLA
maps them onto the TPU's matrix unit; on the GPU PyTorch's own resamplers
compute the same functions (torch ``F.interpolate`` / pooling semantics
are the reference the JAX versions were written against).
:func:`imresize_matlab` (MATLAB's antialiased bicubic, for LR synthesis)
keeps the JAX package's form: the per-axis weight matrices built in numpy,
two float32 products on the tensor's device.  Every function takes
``(..., H, W, C)`` and returns the same dtype.
"""

from __future__ import annotations

import functools

import numpy as np
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


def _cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax * ax, ax * ax * ax
    return ((1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0) * ((ax > 1) & (ax <= 2)))


@functools.lru_cache(maxsize=None)
def _matlab_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) float32 MATLAB imresize bicubic weights:
    antialiased when downscaling, out-of-range taps mirrored (symmetric
    padding), as the reference's ``utils/image_resize.py``."""
    scale = out_size / in_size
    kernel_width = 4.0 / scale if scale < 1.0 else 4.0
    x = np.arange(1, out_size + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    P = int(np.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(P)[None, :]  # 1-based tap indices
    dist = u[:, None] - idx
    w = scale * _cubic(dist * scale) if scale < 1.0 else _cubic(dist)
    w = w / np.sum(w, axis=1, keepdims=True)
    aux = np.concatenate([np.arange(in_size), np.arange(in_size - 1, -1, -1)])
    idx = aux[np.mod(idx.astype(np.int64) - 1, 2 * in_size)]
    dense = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(dense, (np.repeat(np.arange(out_size), P), idx.ravel()), w.ravel())
    return dense.astype(np.float32)


def imresize_matlab(x: torch.Tensor, scale: float) -> torch.Tensor:
    """MATLAB ``imresize`` (bicubic, antialiased) of (..., H, W, C) by
    ``scale``, computed in float32 on ``x``'s device."""
    *lead, H, W, C = x.shape
    out_h, out_w = int(np.ceil(H * scale)), int(np.ceil(W * scale))
    wh = torch.from_numpy(_matlab_resize_weights(H, out_h)).to(x.device)
    ww = torch.from_numpy(_matlab_resize_weights(W, out_w)).to(x.device)
    y = torch.einsum("oh,...hwc->...owc", wh, x.float())
    y = torch.einsum("ow,...hwc->...hoc", ww, y)
    return y.to(x.dtype)
