"""Training losses (``vmg_tpu/train/loss.py``).

Charbonnier with eps inside the sqrt (mean form), plus the optional
Laplacian-edge term: 5x5 Gaussian blur with replicate padding, decimate,
zero-stuffed x4 re-upsample, blur again, difference -- Charbonnier on the
difference, averaged per frame, then over frames.  Inputs are
``(B, T, H, W, C)``; everything is computed in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_EDGE_K = (0.05, 0.25, 0.4, 0.25, 0.05)


def charbonnier_loss(x, y, eps: float = 1e-12):
    diff = x.float() - y.float()
    return torch.sqrt(diff * diff + eps).mean()


def _gauss_blur(img):
    """Depthwise 5x5 Gaussian with replicate padding; img (N, C, H, W)."""
    C = img.shape[1]
    k = torch.tensor(_EDGE_K, dtype=img.dtype, device=img.device)
    w = torch.outer(k, k).expand(C, 1, 5, 5)
    return F.conv2d(F.pad(img, (2, 2, 2, 2), mode="replicate"), w, groups=C)


def _laplacian(img):
    filtered = _gauss_blur(img)
    up = torch.zeros_like(filtered)
    up[:, :, ::2, ::2] = filtered[:, :, ::2, ::2] * 4.0
    return img - _gauss_blur(up)


def edge_loss(x, y, eps: float = 1e-12):
    """Per-frame Laplacian Charbonnier, mean over frames."""
    B, T, H, W, C = x.shape

    def lap(v):
        v = v.float().reshape(B * T, H, W, C).permute(0, 3, 1, 2)
        return _laplacian(v).reshape(B, T, C, H, W)

    per_frame = torch.sqrt((lap(x) - lap(y)) ** 2 + eps).mean(dim=(0, 2, 3, 4))
    return per_frame.mean()


def total_loss(pred, target, eps: float = 1e-12, if_aux: bool = True,
               aux_ratio: float = 0.005):
    loss = charbonnier_loss(pred, target, eps)
    if if_aux:
        loss = loss + aux_ratio * edge_loss(pred, target, eps)
    return loss
