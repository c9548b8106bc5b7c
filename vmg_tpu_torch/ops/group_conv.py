"""Grouped-conv FFN: conv3x3 (groups) + bias + GELU + dense projection.

Port of ``vmg_tpu/ops/group_conv.py``.  :func:`fused_group_ffn` runs the
hand-written CUDA kernel ``csrc/group_ffn.cu`` on CUDA tensors (the 6C
hidden stays in shared memory; see the note at the top of that file) and
:func:`group_ffn_plain` -- the JAX package's ``_xla_forward_ffn`` written
in PyTorch -- on CPU tensors.  Both take the operands :func:`pack_ffn_weights`
makes from ``MlpCnn``'s parameters (conv weight (F, C/g, 3, 3), bias
(F,), projection weight (C, F)); ``MlpCnn`` packs them once.

Numerics (both versions): the conv accumulates in f32, bias and GELU in
f32, the hidden rounds to the input dtype before the projection, which
accumulates in f32 across groups and rounds once at the end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vmg_tpu_torch import _build

_ACTS = {"erf": 0, "tanh": 1}


def gelu(x: torch.Tensor, act: str) -> torch.Tensor:
    if act not in _ACTS:
        raise ValueError(f"unknown GELU flavor {act!r}")
    return F.gelu(x, approximate="tanh" if act == "tanh" else "none")


def pack_ffn_weights(w1, b1, w2, groups: int):
    """(F, cg, 3, 3) conv weight, (F,) bias, (C, F) projection weight ->
    the kernel's operands w1p (g, 9*cgp, fgp) with rows in (dy, dx, ci)
    order, b1p (g*fgp,), w2p (g, fgp, C).  For bf16 (the tensor-core path)
    cgp, fgp are cg, fg rounded up to a multiple of 16, the padding zeros,
    so it adds nothing; for float32 they are cg, fg."""
    Fh, cg = w1.shape[:2]
    fg = Fh // groups
    align = 16 if w1.dtype == torch.bfloat16 else 1
    cgp, fgp = -(-cg // align) * align, -(-fg // align) * align
    w1p = w1.reshape(groups, fg, cg, 3, 3).permute(0, 3, 4, 2, 1)
    w1p = F.pad(w1p, (0, fgp - fg, 0, cgp - cg)).reshape(groups, 9 * cgp, fgp)
    b1p = F.pad(b1.reshape(groups, fg), (0, fgp - fg)).reshape(-1)
    w2p = F.pad(w2.t().reshape(groups, fg, -1), (0, 0, 0, fgp - fg))
    return w1p.contiguous(), b1p.contiguous(), w2p.contiguous()


def group_ffn_plain(x, w1p, b1p, w2p, b2, *, groups: int, act: str = "erf"):
    """Plain PyTorch version on the packed operands: im2col taps per group
    (channels zero-padded like the packed rows), f32 matmuls."""
    N, H, W, C = x.shape
    cg = C // groups
    cgp, fg = w1p.shape[1] // 9, w1p.shape[2]
    xw = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = torch.zeros((N, H, W, C), dtype=torch.float32, device=x.device)
    for b in range(groups):
        xg = F.pad(xw[..., b * cg:(b + 1) * cg], (0, cgp - cg))
        taps = torch.cat([xg[:, dy:dy + H, dx:dx + W]
                          for dy in range(3) for dx in range(3)], dim=-1)
        acc = taps.float() @ w1p[b].float()
        y = gelu(acc + b1p[b * fg:(b + 1) * fg].float(), act)
        out += y.to(x.dtype).float() @ w2p[b].float()
    return (out + b2.float()).to(x.dtype)


def fused_group_ffn(x, w1p, b1p, w2p, b2, *, groups: int, act: str = "erf"):
    """x (N, H, W, C) -> (N, H, W, C), on the operands of
    :func:`pack_ffn_weights` (all in x's dtype).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return group_ffn_plain(x, w1p, b1p, w2p, b2, groups=groups, act=act)
    N, H, W, C = x.shape
    if C % groups:
        raise ValueError(f"C={C} not divisible by groups={groups}")
    if act not in _ACTS:
        raise ValueError(f"unknown GELU flavor {act!r}")
    align = 16 if x.dtype == torch.bfloat16 else 1
    cgp = -(-(C // groups) // align) * align
    fgp = w1p.shape[-1]
    _build.require(x, "x")
    for name, t, shape in (("w1p", w1p, (groups, 9 * cgp, fgp)),
                           ("b1p", b1p, (groups * fgp,)),
                           ("w2p", w2p, (groups, fgp, C)), ("b2", b2, (C,))):
        _build.require(t, name, shape=shape, dtype=x.dtype, device=x.device)
    if fgp % align:
        raise ValueError(f"w1p has {fgp} features per group; bf16 needs a multiple of 16")
    out = torch.empty_like(x)
    code = _build.load_library().vmg_group_ffn(
        x.data_ptr(), w1p.data_ptr(), b1p.data_ptr(), w2p.data_ptr(),
        b2.data_ptr(), out.data_ptr(), N, H, W, C, groups, fgp,
        _ACTS[act], _build.DTYPE_CODES[x.dtype], _build.stream_of(x))
    _build.check(code, "vmg_group_ffn")
    fused_group_ffn.launches += 1
    return out


fused_group_ffn.launches = 0
