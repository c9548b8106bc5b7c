"""Chained 3x3 convolutions and the layout pin.

Port of ``vmg_tpu/ops/conv_chain.py``.  :func:`fused_conv_chain` computes
conv3x3 -> act -> conv3x3 [-> x + s * y] [+ f32 per-frame sums of the
result]: the CUDA kernels of ``csrc/conv_chain.cu`` on CUDA tensors (bf16:
two launches of one wgmma implicit-GEMM conv through an (N, H, W, Cm)
scratch; f32: the same two launches with every product as three TF32
products on wgmma; design notes there), :func:`conv_chain_plain` on CPU
tensors, through the operator ``vmg::conv_chain`` (``ops/library.py``).
The weights come packed by :func:`pack_conv_taps`, once per parameter
state (the consumers are ``PackedOperands``).  Serving only: no backward.

Numerics (both versions, the TPU kernel's): conv1 accumulates in f32,
adds its bias and applies the activation in f32 and rounds once to the
input dtype, with ZEROS at positions outside the image (conv2's SAME
padding); conv2 accumulates in f32, adds its bias and rounds once; the
residual ``x + s * y`` is computed in the dtype's arithmetic; the sums
are f32 sums of the rounded result over (H, W).

:func:`layout_pin` is the TPU's identity pass that pinned a tensor's
layout inside the trajectory scan.  On the card it pins nothing (PyTorch
tensors have one layout), but it is the same function at the same cost:
one read and one write into a fresh tensor (``vmg::layout_pin``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vmg_tpu_torch import _build
from vmg_tpu_torch.ops import library
from vmg_tpu_torch.ops.group_conv import _tf32_image, _tf32_unimage

_ACTS = {None: 0, "relu": 1, "lrelu": 2}
MAX_SMEM = 232_448
# the f32 kernel (csrc/conv_chain.cu conv3x3_tf32_kernel): an 8-channel slab
# box of 4 x 66 positions, ring stages at most (each an even number of k8
# steps: whole commit groups)
TF32_BOX_BYTES = 4 * 66 * 32
TF32_MAX_STAGES = 6


def _act(y, act1):
    if act1 == "relu":
        return F.relu(y)
    if act1 == "lrelu":
        return torch.where(y >= 0, y, 0.1 * y)
    if act1 is None:
        return y
    raise ValueError(f"unknown act {act1!r}")


def pack_conv_taps(weight, bias):
    """Conv2d weight (Cout, Cin, 3, 3) and bias (Cout,) -> the per-tap
    weights in the weight's dtype, tap = dy * 3 + dx, and the bias (Coutp,)
    f32.  bf16 (the tensor-core path): Cinp, Coutp are Cin, Cout rounded up
    to a multiple of 16, zeros in the padding (so padded output channels are
    exact zeros through bias and relu/lrelu), and each tap is the wgmma B
    image (Cinp / 8, Coutp, 8): ``image[t, c, n, e]`` is the tap's entry (k =
    8c + e, n), so each 8-channel chunk holds the outputs' rows 16 bytes
    apart (no-swizzle core matrices) and one tap is one contiguous bulk
    copy.  float32 (the 3xTF32 path): Cinp rounds up to the k8 step and
    Coutp to 16, and each k8 step s of a tap is its TF32 hi then its lo B
    image, ``image[t, s, hilo, kb, n, e]`` holding entry (8 s + 2 e + kb, n)
    (K-major 8 x 16-byte core matrices, rows in the fragment order of
    ``group_conv._tf32_image``; hi + lo is the entry exactly); the taps are
    one stream of 9 Cinp / 8 steps.  Other dtypes: the matrices (9, Cin,
    Cout).  :func:`tap_matrices` gives back the (9, Kp, Np) matrices."""
    cout, cin = weight.shape[:2]
    f32, bf16 = weight.dtype == torch.float32, weight.dtype == torch.bfloat16
    kal, nal = (16, 16) if bf16 else (8, 16) if f32 else (1, 1)
    cinp, coutp = -(-cin // kal) * kal, -(-cout // nal) * nal
    w = weight.permute(2, 3, 1, 0).reshape(9, cin, cout)
    w = F.pad(w, (0, coutp - cout, 0, cinp - cin))
    if bf16:
        w = w.reshape(9, cinp // 8, 8, coutp).transpose(2, 3)
    elif f32:
        w = torch.stack([_tf32_image(m) for m in w]).reshape(9, cinp // 8, 2, 2, coutp, 4)
    b = torch.zeros(cout, device=weight.device) if bias is None else bias.float()
    return w.contiguous(), F.pad(b, (0, coutp - cout)).contiguous()


def tap_matrices(w):
    """Packed taps -> (9, Kp, Np) matrices, entry (k, n) of tap t."""
    if w.dim() == 3:
        return w
    if w.dim() == 6:  # f32: hi + lo of each k8 step
        steps, np_ = w.shape[1], w.shape[4]
        return torch.stack([_tf32_unimage(t.reshape(-1), steps, np_) for t in w])
    return w.transpose(2, 3).reshape(9, w.shape[1] * 8, w.shape[2])


def _conv_weight(w, cin=None):
    """Packed taps -> a Conv2d weight (Np, cin or Kp, 3, 3), f32."""
    w = tap_matrices(w)
    kp, np_ = w.shape[1:]
    return w.float().reshape(3, 3, kp, np_).permute(3, 2, 0, 1)[:, :cin]


def chain_tf32_smem(ks: int, np_: int, kcs: int, nst: int) -> int:
    """Shared memory of the f32 kernel (``conv_tf32_smem`` in the source):
    alignment slack, the slab (ks 8-channel boxes), nst ring stages of kcs
    k8 steps (hi and lo images, 64 Np bytes a step), the barriers, the
    per-warp channel sums."""
    return 128 + ks * TF32_BOX_BYTES + nst * kcs * 64 * np_ + 128 + 8 * np_ * 4


def chain_tf32_plan(ks: int, np_: int):
    """(kcs, nst) of one f32 conv with ks 8-channel input boxes and Np output
    channels: 4 k8 steps a ring stage where three stages fit beside the
    slab (C = 112: 28 KB stages), else 2 (C = 128), as many stages as fit,
    at most TF32_MAX_STAGES."""
    for kcs, least in ((4, 3), (2, 2)):
        nst = min(TF32_MAX_STAGES, (MAX_SMEM - chain_tf32_smem(ks, np_, kcs, 0))
                  // (kcs * 64 * np_))
        if nst >= least:
            return kcs, nst
    raise ValueError(f"the f32 conv kernel has no plan at {8 * ks} x {np_} channels")


def chain_tf32_plan_ints(w1, w2) -> list:
    """The f32 entry point's plan from the packed taps: conv1's (kcs, nst),
    then conv2's."""
    return [*chain_tf32_plan(w1.shape[1], w1.shape[4]), *chain_tf32_plan(w2.shape[1], w2.shape[4])]


def conv_chain_plain(x, w1, b1, w2, b2, *, act1="relu", res_scale=None,
                     emit_psum=False):
    """Plain PyTorch version on the packed operands: two f32 convolutions
    with the kernel's roundings."""
    C = x.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), _conv_weight(w1, C), b1.float(),
                 padding=1)
    y = _act(y, act1).to(x.dtype)
    w2m = _conv_weight(w2)[:C]  # f32 taps: K may stop short of conv1's padded (zero) outputs
    y = F.conv2d(y.float()[:, :w2m.shape[1]], w2m, b2[:C].float(), padding=1)
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
    backward (``vmg::conv_chain``, serving only)."""
    if act1 not in _ACTS:
        raise ValueError(f"unknown act {act1!r}")
    if (x.device.type != "cpu" and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, w1, b1, w2, b2))):
        raise RuntimeError("fused_conv_chain has no backward: call it under "
                           "torch.no_grad() or on tensors that need no gradient")
    out, psum = _conv_chain(x, w1, b1, w2, b2, act1,
                            None if res_scale is None else float(res_scale), emit_psum)
    return (out, psum) if emit_psum else out


def _chain_cuda(x, w1, b1, w2, b2, act1, res_scale, emit_psum: bool):
    N, H, W, C = x.shape
    dt, dev = x.dtype, x.device
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the conv chain kernel takes bf16 or float32, got {dt}")
    bf16 = dt == torch.bfloat16
    if bf16:  # (9, Kp / 8, Np, 8) images
        cp, cm, coutp, k2 = w1.shape[1] * 8, w1.shape[2], w2.shape[2], w2.shape[1] * 8
        shapes = ((9, cp // 8, cm, 8), (9, cm // 8, coutp, 8))
        ok = w1.dim() == 4 and cp == -(-C // 16) * 16
    else:  # (9, Kp / 8, 2, 2, Np, 4) hi / lo images
        if w1.dim() != 6 or w2.dim() != 6:
            raise ValueError(f"float32 taps must be pack_conv_taps' (9, Kp / 8, 2, 2, Np, 4) "
                             f"images, got {tuple(w1.shape)}, {tuple(w2.shape)}")
        cp, cm, coutp, k2 = w1.shape[1] * 8, w1.shape[4], w2.shape[4], w2.shape[1] * 8
        shapes = ((9, cp // 8, 2, 2, cm, 4), (9, k2 // 8, 2, 2, coutp, 4))
        ok = cp == -(-C // 8) * 8 and -(-k2 // 16) * 16 == cm
    if not ok or coutp != -(-C // 16) * 16 or cm > 128 or cp > 128:
        raise ValueError(f"packed taps {tuple(w1.shape)}, {tuple(w2.shape)} do not fit "
                         f"{dt} x with {C} channels (at most 128)")
    _build.require(x, "x")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    for name, t, shape, dtype in (("w1", w1, shapes[0], dt), ("b1", b1, (cm,), torch.float32),
                                  ("w2", w2, shapes[1], dt),
                                  ("b2", b2, (coutp,), torch.float32)):
        _build.require(t, name, shape=shape, dtype=dtype, device=dev)
    lib = _build.load_library()
    code = _build.DTYPE_CODES[dt]
    out = torch.empty_like(x)
    mid = torch.empty((N, H, W, cm), dtype=dt, device=dev)
    ints = [] if bf16 else chain_tf32_plan_ints(w1, w2)
    plan = (ctypes.c_int * len(ints))(*ints) if ints else None
    partial = None
    psum = torch.empty(_psum_shape(x, emit_psum), dtype=torch.float32, device=dev)
    if emit_psum:
        rows = lib.vmg_conv_chain_tiles(H, W, code)  # partial sums per frame
        partial = torch.empty((N, rows, C), dtype=torch.float32, device=dev)
    err = lib.vmg_conv_chain(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), mid.data_ptr(), _build.ptr(partial),
        psum.data_ptr() if emit_psum else None, N, H, W, C,
        cp, k2, C, coutp, _ACTS[act1], int(res_scale is not None),
        float(res_scale or 0.0), plan, code, _build.stream_of(x))
    _build.check(err, "vmg_conv_chain")
    fused_conv_chain.launches += 1
    return out, psum


def _psum_shape(x, emit_psum: bool):
    """The (N, C) sums, or an empty tensor where none are asked for."""
    return (x.shape[0], x.shape[-1]) if emit_psum else (0,)


def _chain_cpu(x, w1, b1, w2, b2, act1, res_scale, emit_psum: bool):
    out, psum = conv_chain_plain(x, w1, b1, w2, b2, act1=act1, res_scale=res_scale,
                                 emit_psum=True)
    return out, psum if emit_psum else psum.new_empty((0,))


def _chain_fake(x, w1, b1, w2, b2, act1, res_scale, emit_psum: bool):
    return library.empty(x), library.empty(x, _psum_shape(x, emit_psum), torch.float32)


_conv_chain = library.define(
    "conv_chain", "(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, str? act1, "
    "float? res_scale, bool emit_psum) -> (Tensor, Tensor)",
    cpu=_chain_cpu, cuda=_chain_cuda, fake=_chain_fake)
fused_conv_chain.launches = 0


def layout_pin_plain(x):
    """A fresh contiguous copy of x."""
    return x.clone(memory_format=torch.contiguous_format)


def _pin_cuda(x):
    _build.require(x, "x", dtype=x.dtype)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    code = _build.load_library().vmg_layout_pin(
        x.data_ptr(), out.data_ptr(), x.numel() * x.element_size(), _build.stream_of(x))
    _build.check(code, "vmg_layout_pin")
    layout_pin.launches += 1
    return out


_layout_pin = library.define("layout_pin", "(Tensor x) -> Tensor", cpu=layout_pin_plain,
                             cuda=_pin_cuda, fake=library.empty)


def layout_pin(x):
    """x -> an equal, contiguous tensor that is not an alias of x (one read
    and one write): ``vmg::layout_pin``, the plain version on CPU
    tensors."""
    return _layout_pin(x)


layout_pin.launches = 0
