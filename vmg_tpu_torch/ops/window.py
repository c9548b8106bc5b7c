"""3D (T, H, W) window partitioning for shifted-window attention
(``vmg_tpu/ops/window.py``).

The shift masks are built with numpy and cached per shape, as the JAX
package builds them (its shapes are static under jit); the swin3d tail
turns one into a tensor on the input's device once per call.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


def window_partition_3d(x: torch.Tensor, window_size: Sequence[int]) -> torch.Tensor:
    """(B, D, H, W, C) -> (B*nW, wd*wh*ww, C)."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window_size
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, C)


def window_reverse_3d(windows: torch.Tensor, window_size: Sequence[int], B: int, D: int,
                      H: int, W: int) -> torch.Tensor:
    """Inverse of :func:`window_partition_3d` -> (B, D, H, W, C)."""
    wd, wh, ww = window_size
    C = windows.shape[-1]
    x = windows.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, C)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, C)


def get_window_size(x_size: Sequence[int], window_size: Sequence[int],
                    shift_size: Sequence[int] | None = None):
    """Clamp the window (and zero the shift) along axes not larger than the
    window."""
    use_ws = list(window_size)
    use_ss = list(shift_size) if shift_size is not None else None
    for i, s in enumerate(x_size):
        if s <= window_size[i]:
            use_ws[i] = s
            if use_ss is not None:
                use_ss[i] = 0
    if use_ss is None:
        return tuple(use_ws)
    return tuple(use_ws), tuple(use_ss)


@functools.lru_cache(maxsize=None)
def shift_mask_np(D: int, H: int, W: int, window_size: Tuple[int, ...],
                  shift_size: Tuple[int, ...]) -> np.ndarray:
    """(nW, win_vol, win_vol) float32 additive mask of the shifted windows:
    -100 between positions of different shifted regions, else 0."""
    img_mask = np.zeros((D, H, W), dtype=np.int32)
    cnt = 0

    def seg(ws, ss):
        return (slice(0, -ws), slice(-ws, -ss), slice(-ss, None)) if ss > 0 else (slice(None),)

    for d in seg(window_size[0], shift_size[0]):
        for h in seg(window_size[1], shift_size[1]):
            for w in seg(window_size[2], shift_size[2]):
                img_mask[d, h, w] = cnt
                cnt += 1
    wd, wh, ww = window_size
    m = img_mask.reshape(D // wd, wd, H // wh, wh, W // ww, ww)
    m = m.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)
    attn = m[:, None, :] - m[:, :, None]
    return np.where(attn != 0, -100.0, 0.0).astype(np.float32)


def compute_shift_mask_3d(D: int, H: int, W: int, window_size: Sequence[int],
                          shift_size: Sequence[int], device=None) -> torch.Tensor:
    """(nW, win_vol, win_vol) additive attention mask for shifted windows."""
    return torch.from_numpy(shift_mask_np(D, H, W, tuple(window_size),
                                          tuple(shift_size))).to(device)
