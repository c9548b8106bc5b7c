"""LayerNorm / RMSNorm over the trailing dim in one pass.

Port of ``vmg_tpu/ops/fused_norm.py``.  :func:`fused_norm` runs the CUDA
kernel of ``csrc/fused_norm.cu`` on CUDA tensors (one warp per row, the
f32 statistics in registers; see the note there) and
:func:`fused_norm_plain` on CPU tensors.  Both compute the Pallas
kernel's math: f32 one-pass moments of the f32-converted inputs
(``var = E[x^2] - mean^2``), ``rsqrt(var + eps)``, scale (+ bias) in f32,
one rounding to the input dtype.

On CUDA the kernel sits in a ``torch.autograd.Function`` whose backward
recomputes through the plain formulation under autograd, as the JAX
package's custom VJP does (``_fused_norm2d_bwd``); there is no backward
kernel, as there is none in JAX.
"""

from __future__ import annotations

import torch

from vmg_tpu_torch import _build


def fused_norm_plain(x, scale, bias=None, *, eps: float, rms: bool = False):
    """x (..., C); scale, bias (C,) -> x's shape and dtype."""
    xf = x.float()
    inv_c = 1.0 / x.shape[-1]
    ms = (xf * xf).sum(dim=-1, keepdim=True) * inv_c
    if rms:
        y = xf * torch.rsqrt(ms + eps)
    else:
        mean = xf.sum(dim=-1, keepdim=True) * inv_c
        y = (xf - mean) * torch.rsqrt(ms - mean * mean + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _launch(x, scale, bias, eps: float, rms: bool):
    C = x.shape[-1]
    x = x.contiguous()
    _build.require(x, "x")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None:
            _build.require(t, name, shape=(C,), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    code = _build.load_library().vmg_fused_norm(
        x.data_ptr(), scale.data_ptr(), _build.ptr(bias), out.data_ptr(),
        x.numel() // C, C, float(eps), int(rms), _build.DTYPE_CODES[x.dtype],
        _build.stream_of(x))
    _build.check(code, "vmg_fused_norm")
    fused_norm.launches += 1
    return out


class _FusedNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, rms):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps, ctx.rms = eps, rms
        return _launch(x, scale, bias, eps, rms)

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (x, scale)]
        if bias is not None:
            leaves.append(bias.detach().requires_grad_())
        with torch.enable_grad():
            y = fused_norm_plain(*leaves[:2], leaves[2] if bias is not None else None,
                                 eps=ctx.eps, rms=ctx.rms)
            grads = torch.autograd.grad(y, leaves, dy)
        return (*grads[:2], grads[2] if bias is not None else None, None, None)


def fused_norm(x, scale, bias=None, *, eps: float, rms: bool = False):
    """Normalize ``x`` (..., C) over its last dim; ``scale``/``bias`` (C,)
    (``bias`` may be None; on the card both in x's dtype, float32 or
    bfloat16).  Returns x's shape and dtype.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (under autograd when a gradient
    is needed)."""
    if x.device.type == "cpu":
        return fused_norm_plain(x, scale, bias, eps=eps, rms=rms)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, scale, bias))
    if needs_grad:
        return _FusedNorm.apply(x, scale, bias, eps, rms)
    return _launch(x, scale, bias, eps, rms)


fused_norm.launches = 0
