"""Normalization layers over the trailing dim (``vmg_tpu/models/norms.py``).

``impl`` is the JAX package's ``set_norm_impl`` as a per-module switch:
``"module"`` (its default) or ``"kernel"`` -- bf16 inputs go through the
fused norm (``ops/fused_norm``: one pass, f32 one-pass moments), in eval
and in training (its autograd backward recomputes through the plain
formulation).  float32 inputs keep the exact two-pass path whatever the
switch says.

:class:`TorchLayerNorm` is ``nn.LayerNorm`` (eps 1e-5, affine): for bf16
inputs torch computes the statistics and the affine in float32 and rounds
once, as the JAX module does around its float32 computation.
:class:`RMSNorm` (eps 1e-6, no bias) follows the JAX module's module form:
bf16 squares summed in f32.
"""

from __future__ import annotations

import torch
from torch import nn

from vmg_tpu_torch.ops.fused_norm import fused_norm

NORM_IMPLS = ("module", "kernel")


def _check_impl(impl: str) -> str:
    if impl not in NORM_IMPLS:
        raise ValueError(f"norm impl must be one of {NORM_IMPLS}, got {impl!r}")
    return impl


class TorchLayerNorm(nn.LayerNorm):
    def __init__(self, dim: int, eps: float = 1e-5, *, impl: str = "module",
                 device=None):
        super().__init__(dim, eps=eps, device=device)
        self.impl = _check_impl(impl)

    def forward(self, x):
        if self.impl == "kernel" and x.dtype == torch.bfloat16:
            return fused_norm(x, self.weight, self.bias, eps=self.eps)
        return super().forward(x)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, *, impl: str = "module",
                 device=None):
        super().__init__()
        self.eps = eps
        self.impl = _check_impl(impl)
        self.weight = nn.Parameter(torch.ones(dim, device=device))

    def forward(self, x):
        if x.dtype == torch.bfloat16:
            if self.impl == "kernel":
                return fused_norm(x, self.weight, None, eps=self.eps, rms=True)
            ms = (x * x).float().sum(dim=-1, keepdim=True) * (1.0 / x.shape[-1])
            y = x.float() * torch.rsqrt(ms + self.eps)
        else:
            xf = x.float()
            y = xf / torch.sqrt((xf * xf).mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight).to(x.dtype)
