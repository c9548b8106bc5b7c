"""Modulated deformable convolution (DCNv2), channels-last
(``vmg_tpu/ops/deform.py``).

The function of ``torchvision.ops.deform_conv2d`` with a mask, stride 1,
dilation 1, as the flow-guided alignment tail calls it: K = k * k bilinear
gathers with zero padding (one per kernel tap, the deform groups folded
into the batch axis, through ``ops/warp.grid_sample``), each scaled by its
modulation mask, then one (K * Cin -> Cout) matrix product.  The JAX
package computes it outside any TPU kernel, with the same decomposition;
so does the port.  The gathered taps are built in the compute dtype (not
in float32: at the full preset's stage 1 they are ~1 GB in bf16) and
freed once the product has read them.

Offsets and masks are channels-last as in the JAX package: offset (N, H,
W, G, K, 2) with the last axis (dy, dx), taps ordered (kh, kw) row-major
within a group; mask (N, H, W, G, K).
"""

from __future__ import annotations

import torch

from vmg_tpu_torch.ops.warp import grid_sample


def modulated_deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                            weight: torch.Tensor, bias: torch.Tensor | None = None,
                            kernel_size: int = 3, padding: int = 1) -> torch.Tensor:
    """x (N, H, W, Cin); offset (N, H, W, G, K, 2) (dy, dx); mask (N, H, W,
    G, K); weight (K, Cin, Cout), tap k = kh * kernel_size + kw; bias (Cout,)
    or None.  Returns (N, H, W, Cout) in x's dtype (the product in x's
    dtype, accumulated in float32 on the card)."""
    N, H, W, Cin = x.shape
    K = kernel_size * kernel_size
    G = offset.shape[3]
    Cg = Cin // G
    dev = x.device
    xg = x.reshape(N, H, W, G, Cg).permute(0, 3, 1, 2, 4).reshape(N * G, H, W, Cg)
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    taps = x.new_empty((N, H, W, K, G, Cg))
    for kh in range(kernel_size):
        for kw in range(kernel_size):
            k = kh * kernel_size + kw
            py = gy[None, :, :, None] + (kh - padding) + offset[..., k, 0].float()
            px = gx[None, :, :, None] + (kw - padding) + offset[..., k, 1].float()
            ny = 2.0 * py / max(H - 1, 1) - 1.0
            nx = 2.0 * px / max(W - 1, 1) - 1.0
            grid = torch.stack([nx, ny], dim=-1).permute(0, 3, 1, 2, 4).reshape(N * G, H, W, 2)
            v = grid_sample(xg, grid, mode="bilinear", padding_mode="zeros")
            v = v.reshape(N, G, H, W, Cg).permute(0, 2, 3, 1, 4)
            taps[:, :, :, k] = v * mask[..., k, None].to(v.dtype)
    taps = taps.reshape(N * H * W, K * Cin)
    w = weight.reshape(K * Cin, -1).to(x.dtype)
    out = taps @ w if bias is None else torch.addmm(bias.to(x.dtype), taps, w)
    return out.reshape(N, H, W, -1)
