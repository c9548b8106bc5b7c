"""Backward warping / grid sampling, channels-last (``vmg_tpu/ops/warp.py``).

Semantics are those of ``torch.nn.functional.grid_sample`` with
``align_corners=True``:

  * grid values in [-1, 1] map to pixel coords ``(g + 1) / 2 * (size - 1)``;
  * ``padding_mode='zeros'``: out-of-bounds taps contribute 0;
  * ``padding_mode='border'``: coords clamp to the valid range;
  * ``mode='nearest'`` rounds half-to-even (torch's nearbyint).

Bilinear sampling goes through ``F.grid_sample`` in float32 and rounds
back to the input dtype once, as the JAX version does.  Nearest sampling
is an exact index gather in the input's own dtype, so the wide keyframe
buffers of the trajectory recurrence are moved without a float32 copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _unnormalize(grid: torch.Tensor, H: int, W: int):
    fx = (grid[..., 0].float() + 1.0) * 0.5 * (W - 1)
    fy = (grid[..., 1].float() + 1.0) * 0.5 * (H - 1)
    return fx, fy


def _gather_nearest(img, fx, fy, padding_mode):
    N, H, W, C = img.shape
    rx = torch.round(fx)
    ry = torch.round(fy)
    ix = rx.clamp(0, W - 1).long()
    iy = ry.clamp(0, H - 1).long()
    idx = (iy * W + ix).reshape(N, -1)
    rows = torch.arange(N, device=img.device)[:, None]
    out = img.reshape(N, H * W, C)[rows, idx].reshape(*fx.shape, C)
    if padding_mode == "zeros":
        valid = (rx >= 0) & (rx <= W - 1) & (ry >= 0) & (ry <= H - 1)
        out = out.masked_fill(~valid[..., None], 0)
    return out


def grid_sample(img: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                padding_mode: str = "zeros") -> torch.Tensor:
    """Sample ``img`` (N,H,W,C) at normalized ``grid`` (N,Ho,Wo,2), xy order.
    Returns (N,Ho,Wo,C) in img.dtype."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode {mode!r}")
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    N, H, W, C = img.shape
    if mode == "nearest":
        fx, fy = _unnormalize(grid, H, W)
        return _gather_nearest(img, fx, fy, padding_mode)
    out = F.grid_sample(img.permute(0, 3, 1, 2).float(), grid.float(),
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=True)
    return out.permute(0, 2, 3, 1).to(img.dtype)


def _flow_grid(flow: torch.Tensor, H: int, W: int) -> torch.Tensor:
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=flow.device),
        torch.arange(W, dtype=torch.float32, device=flow.device),
        indexing="ij")
    fx = gx[None] + flow[..., 0].float()
    fy = gy[None] + flow[..., 1].float()
    nx = 2.0 * fx / max(W - 1, 1) - 1.0
    ny = 2.0 * fy / max(H - 1, 1) - 1.0
    return torch.stack([nx, ny], dim=-1)


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              interpolation: str = "bilinear",
              padding_mode: str = "zeros") -> torch.Tensor:
    """Warp ``x`` (N,H,W,C) backward along ``flow`` (N,H,W,2); flow[..., 0]
    is the x (width) offset in pixels, flow[..., 1] the y offset."""
    N, H, W, C = x.shape
    if flow.shape[1] != H or flow.shape[2] != W:
        raise ValueError(f"flow spatial {tuple(flow.shape[1:3])} != input {(H, W)}")
    return grid_sample(x, _flow_grid(flow, H, W), mode=interpolation,
                       padding_mode=padding_mode)
