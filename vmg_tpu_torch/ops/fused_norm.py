"""LayerNorm / RMSNorm over the trailing dim in one pass.

Port of ``vmg_tpu/ops/fused_norm.py``.  :func:`fused_norm` runs the CUDA
kernel of ``csrc/fused_norm.cu`` on CUDA tensors (one warp per row, the
f32 statistics in registers; see the note there) and
:func:`fused_norm_plain` on CPU tensors.  Both compute the Pallas
kernel's math: f32 one-pass moments of the f32-converted inputs
(``var = E[x^2] - mean^2``), ``rsqrt(var + eps)``, scale (+ bias) in f32,
one rounding to the input dtype.

:func:`fused_norm` calls the operator ``vmg::fused_norm``
(``ops/library.py``) with the kernel on CUDA tensors and the plain version
on CPU tensors; its gradient (``register_autograd``) recomputes through the
plain formulation under autograd, as the JAX package's custom VJP does
(``_fused_norm2d_bwd``); there is no backward kernel, as there is none in
JAX.
"""

from __future__ import annotations

import torch

from vmg_tpu_torch import _build
from vmg_tpu_torch.ops import library


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
    return y.to(x.dtype).contiguous()


def _norm_cuda(x, scale, bias, eps: float, rms: bool):
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


def _norm_cpu(x, scale, bias, eps: float, rms: bool):
    return fused_norm_plain(x, scale, bias, eps=eps, rms=rms)


_fused_norm = library.define(
    "fused_norm", "(Tensor x, Tensor scale, Tensor? bias, float eps, bool rms) -> Tensor",
    cpu=_norm_cpu, cuda=_norm_cuda, fake=lambda x, scale, bias, eps, rms: library.empty(x))


def _setup_context(ctx, inputs, output):
    x, scale, bias, eps, rms = inputs
    ctx.save_for_backward(x, scale, bias)
    ctx.eps, ctx.rms = eps, rms


def _backward(ctx, dy):
    """Autograd of the plain formulation, recomputed (the JAX package's
    custom VJP, ``_fused_norm2d_bwd``)."""
    x, scale, bias = ctx.saved_tensors
    leaves = [t.detach().requires_grad_() for t in (x, scale)]
    if bias is not None:
        leaves.append(bias.detach().requires_grad_())
    with torch.enable_grad():
        y = fused_norm_plain(*leaves[:2], leaves[2] if bias is not None else None,
                             eps=ctx.eps, rms=ctx.rms)
        grads = torch.autograd.grad(y, leaves, dy)
    return (*grads[:2], grads[2] if bias is not None else None, None, None)


library.register_autograd(_fused_norm, _backward, _setup_context)


def fused_norm(x, scale, bias=None, *, eps: float, rms: bool = False):
    """Normalize ``x`` (..., C) over its last dim; ``scale``/``bias`` (C,)
    (``bias`` may be None; on the card both in x's dtype, float32 or
    bfloat16).  Returns x's shape and dtype, contiguous:
    ``vmg::fused_norm``, the plain version on CPU tensors, the kernel on
    CUDA tensors (differentiable either way)."""
    return _fused_norm(x, scale, bias, float(eps), bool(rms))


fused_norm.launches = 0
