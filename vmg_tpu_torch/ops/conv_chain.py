"""Chained 3x3 convolutions and the layout pin.

Port of ``vmg_tpu/ops/conv_chain.py``.  :func:`fused_conv_chain` computes
conv3x3 -> act -> conv3x3 [-> x + s * y] [+ f32 per-frame sums of the
result] with the intermediate kept on chip: the CUDA kernel of
``csrc/conv_chain.cu`` on CUDA tensors (design notes there),
:func:`conv_chain_plain` on CPU tensors.  The weights come packed by
:func:`pack_conv_taps`, once per parameter state (the consumers are
``PackedOperands``).  Serving only: no backward.

Numerics (both versions, the TPU kernel's): conv1 accumulates in f32,
adds its bias and applies the activation in f32 and rounds once to the
input dtype, with ZEROS at positions outside the image (conv2's SAME
padding); conv2 accumulates in f32, adds its bias and rounds once; the
residual ``x + s * y`` is computed in the dtype's arithmetic; the sums
are f32 sums of the rounded result over (H, W).

:func:`layout_pin` is the TPU's identity pass that pinned a tensor's
layout inside the trajectory scan.  On the card it pins nothing (PyTorch
tensors have one layout), but it is the same function at the same cost:
one read and one write into a fresh tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vmg_tpu_torch import _build

_ACTS = {None: 0, "relu": 1, "lrelu": 2}


def _act(y, act1):
    if act1 == "relu":
        return F.relu(y)
    if act1 == "lrelu":
        return torch.where(y >= 0, y, 0.1 * y)
    if act1 is None:
        return y
    raise ValueError(f"unknown act {act1!r}")


def pack_conv_taps(weight, bias):
    """Conv2d weight (Cout, Cin, 3, 3) and bias (Cout,) -> per-tap matrices
    (9, Cinp, Coutp) in the weight's dtype, tap = dy * 3 + dx, and the bias
    (Coutp,) f32.  For bf16 (the tensor-core path) Cinp, Coutp are Cin,
    Cout rounded up to a multiple of 16, zeros in the padding, so padded
    output channels are exact zeros through bias and relu/lrelu; for
    float32 they are Cin, Cout."""
    cout, cin = weight.shape[:2]
    align = 16 if weight.dtype == torch.bfloat16 else 1
    cinp, coutp = -(-cin // align) * align, -(-cout // align) * align
    w = weight.permute(2, 3, 1, 0).reshape(9, cin, cout)
    w = F.pad(w, (0, coutp - cout, 0, cinp - cin))
    b = torch.zeros(cout, device=weight.device) if bias is None else bias.float()
    return w.contiguous(), F.pad(b, (0, coutp - cout)).contiguous()


def _conv_weight(w, cin):
    """Packed taps (9, Kp, Np) -> a Conv2d weight (Np, cin, 3, 3), f32."""
    kp, np_ = w.shape[1:]
    return w.float().reshape(3, 3, kp, np_).permute(3, 2, 0, 1)[:, :cin]


def conv_chain_plain(x, w1, b1, w2, b2, *, act1="relu", res_scale=None,
                     emit_psum=False):
    """Plain PyTorch version on the packed operands: two f32 convolutions
    with the kernel's roundings."""
    C = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), _conv_weight(w1, C), b1.float(),
                 padding=1)
    y = _act(y, act1).to(x.dtype)
    y = F.conv2d(y.float(), _conv_weight(w2, w2.shape[1])[:C], b2[:C].float(),
                 padding=1)
    y = y.to(x.dtype).permute(0, 2, 3, 1).contiguous()
    if res_scale is not None:
        y = x + res_scale * y
    if emit_psum:
        return y, y.float().sum(dim=(1, 2))
    return y


def fused_conv_chain(x, w1, b1, w2, b2, *, act1="relu", res_scale=None,
                     emit_psum=False):
    """x (N, H, W, C) -> (N, H, W, C) (conv2 maps back to x's C channels,
    as both consumers need), and with ``emit_psum`` also its (N, C) f32
    sums over (H, W).  ``res_scale``: return ``x + res_scale * chain(x)``.
    Operands from :func:`pack_conv_taps`; channels up to 128.  CPU tensors
    take the plain version; CUDA tensors launch the kernel, which has no
    backward."""
    if act1 not in _ACTS:
        raise ValueError(f"unknown act {act1!r}")
    if x.device.type == "cpu":
        return conv_chain_plain(x, w1, b1, w2, b2, act1=act1, res_scale=res_scale,
                                emit_psum=emit_psum)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise RuntimeError("fused_conv_chain has no backward: call it under "
                           "torch.no_grad() or on tensors that need no gradient")
    N, H, W, C = x.shape
    dt, dev = x.dtype, x.device
    align = 16 if dt == torch.bfloat16 else 1
    cp, cm, coutp = w1.shape[1], w1.shape[2], w2.shape[2]
    if cp != -(-C // align) * align or coutp != cp or cm > 128 or cp > 128:
        raise ValueError(f"packed taps {tuple(w1.shape)}, {tuple(w2.shape)} do not fit "
                         f"x with {C} channels (at most 128)")
    _build.require(x, "x")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    for name, t, shape, dtype in (("w1", w1, (9, cp, cm), dt), ("b1", b1, (cm,), torch.float32),
                                  ("w2", w2, (9, cm, cp), dt),
                                  ("b2", b2, (cp,), torch.float32)):
        _build.require(t, name, shape=shape, dtype=dtype, device=dev)
    lib = _build.load_library()
    code = _build.DTYPE_CODES[dt]
    out = torch.empty_like(x)
    partial = psum = None
    if emit_psum:
        tiles = lib.vmg_conv_chain_tiles(H, W, code)
        partial = torch.empty((N, tiles, C), dtype=torch.float32, device=dev)
        psum = torch.empty((N, C), dtype=torch.float32, device=dev)
    err = lib.vmg_conv_chain(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), _build.ptr(partial), _build.ptr(psum), N, H, W, C, cp, cm,
        C, cp, _ACTS[act1], int(res_scale is not None),
        float(res_scale or 0.0), code, _build.stream_of(x))
    _build.check(err, "vmg_conv_chain")
    fused_conv_chain.launches += 1
    return (out, psum) if emit_psum else out


fused_conv_chain.launches = 0


def layout_pin_plain(x):
    """A fresh contiguous copy of x."""
    return x.clone(memory_format=torch.contiguous_format)


def layout_pin(x):
    """x -> an equal, contiguous tensor that is not an alias of x (one read
    and one write).  CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return layout_pin_plain(x)
    _build.require(x, "x", dtype=x.dtype)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    code = _build.load_library().vmg_layout_pin(
        x.data_ptr(), out.data_ptr(), x.numel() * x.element_size(), _build.stream_of(x))
    _build.check(code, "vmg_layout_pin")
    layout_pin.launches += 1
    return out


layout_pin.launches = 0
