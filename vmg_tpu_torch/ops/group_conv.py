"""Grouped-conv FFN: conv3x3 (groups) + bias + GELU + dense projection.

Port of ``vmg_tpu/ops/group_conv.py``.  :func:`fused_group_ffn` runs the
hand-written CUDA kernel ``csrc/group_ffn.cu`` on CUDA tensors (bf16: a
wgmma implicit GEMM whose hidden stays on chip; f32: scalar FMA; see the
note at the top of that file) and :func:`group_ffn_plain` -- the JAX
package's ``_xla_forward_ffn`` written in PyTorch -- on CPU tensors.  Both
take the operands :func:`pack_ffn_weights` makes from ``MlpCnn``'s
parameters (conv weight (F, C/g, 3, 3), bias (F,), projection weight
(C, F)): one weight buffer in the kernel's layout for the dtype, and the
padded bias; ``MlpCnn`` packs them once per parameter state.

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


def out_width(C: int) -> int:
    """Output channels one consumer warpgroup of the bf16 kernel
    accumulates: all C up to 224; above, the two warpgroups split them,
    half of C rounded up to 16 each (csrc/group_ffn.cu ``ffn_out_width``)."""
    return C if C <= 224 else -(-(C // 2) // 16) * 16


def chunk_width(C: int) -> int:
    """Hidden features per chunk of the bf16 kernel (``kFC``; ``kFCS`` where
    the warpgroups split the output channels, each computing half the
    chunk's conv)."""
    return 48 if C <= 224 else 64


def slab_depth(C: int, groups: int) -> int:
    """K rows per tap of the bf16 kernel: group b's slab starts at channel
    (cg * b) rounded down to 8 (TMA boxes start on 16 bytes), so its
    channels sit at offset (cg * b) % 8; K covers the largest offset plus
    cg, rounded up to 16 (csrc/group_ffn.cu ``ffn_slab_depth``)."""
    cg = C // groups
    return -(-(cg + max((cg * b) % 8 for b in range(groups))) // 16) * 16


def _round(n: int, align: int) -> int:
    return -(-n // align) * align


def _align(C: int, dtype) -> int:
    """Padding of cg and fg: none in f32; bf16 (the tensor cores) to 16, fg
    to 32 where each warpgroup computes half of a chunk (C > 224)."""
    return 1 if dtype != torch.bfloat16 else 16 if C <= 224 else 32


def _chunks(C: int, fgp: int):
    cw = chunk_width(C)
    return [(f0, min(cw, fgp - f0)) for f0 in range(0, fgp, cw)]


def _stream_size(C: int, groups: int, fgp: int) -> int:
    NW = out_width(C)
    return groups * fgp * (9 * slab_depth(C, groups) + -(-C // NW) * NW)


def _stream(w1p, w2p):
    """The bf16 kernel's weights from the padded operands w1p (g, 9*cgp,
    fgp) and w2p (g, fgp, C), flat, in the order the kernel walks them: per
    group b and hidden chunk (f0, fcw), the chunk's 9 taps as wgmma B images
    (9, Kp/8, fcw, 8) -- K row k is slab channel k, the group's channel k -
    (cg * b) % 8, zeros elsewhere (:func:`slab_depth`) -- then its w2 rows
    as (fcw/8, NW, 8), once per warpgroup's output channels [h*NW, h*NW +
    NW) (:func:`out_width`, zeros past C)."""
    G, K9, fgp = w1p.shape
    C = w2p.shape[-1]
    cg, Kp, NW = C // G, slab_depth(C, G), out_width(C)
    halves = -(-C // NW)
    taps = torch.zeros((G, 9, Kp, fgp), dtype=w1p.dtype, device=w1p.device)
    for b in range(G):
        o = (cg * b) % 8
        taps[b, :, o:o + cg] = w1p[b].reshape(9, K9 // 9, fgp)[:, :cg]
    taps = taps.reshape(G, 9, Kp // 8, 8, fgp)
    w2z = F.pad(w2p, (0, halves * NW - C))
    parts = []
    for b in range(G):
        for f0, fcw in _chunks(C, fgp):
            parts.append(taps[b, ..., f0:f0 + fcw].permute(0, 1, 3, 2).reshape(-1))
            for h in range(halves):
                rows = w2z[b, f0:f0 + fcw, h * NW:(h + 1) * NW]
                parts.append(rows.reshape(fcw // 8, 8, NW).permute(0, 2, 1).reshape(-1))
    return torch.cat(parts).contiguous()


def _unstream(w, C: int, groups: int, fgp: int):
    """(w1p, w2p) back from a bf16 weight stream (the inverse of
    :func:`_stream`); raises if a K row outside the group's channels or a
    w2 column past C is not zero."""
    cg, Kp, NW = C // groups, slab_depth(C, groups), out_width(C)
    halves = -(-C // NW)
    taps = torch.zeros((groups, 9, Kp, fgp), dtype=w.dtype, device=w.device)
    w2p = torch.zeros((groups, fgp, halves * NW), dtype=w.dtype, device=w.device)
    off = 0
    for b in range(groups):
        for f0, fcw in _chunks(C, fgp):
            n = 9 * Kp * fcw
            tap = w[off:off + n].reshape(9, Kp // 8, fcw, 8).permute(0, 1, 3, 2)
            taps[b, ..., f0:f0 + fcw] = tap.reshape(9, Kp, fcw)
            off += n
            for h in range(halves):
                n = fcw * NW
                rows = w[off:off + n].reshape(fcw // 8, NW, 8).permute(0, 2, 1)
                w2p[b, f0:f0 + fcw, h * NW:(h + 1) * NW] = rows.reshape(fcw, NW)
                off += n
    if off != w.numel():
        raise ValueError(f"stream of {w.numel()} elements, layout of {off}")
    cgp = _round(cg, 16)
    w1p = torch.zeros((groups, 9, cgp, fgp), dtype=w.dtype, device=w.device)
    for b in range(groups):
        o = (cg * b) % 8
        w1p[b, :, :cg] = taps[b, :, o:o + cg]
        taps[b, :, o:o + cg] = 0
    if taps.any() or w2p[..., C:].any():
        raise ValueError("the stream has weights outside the groups' channels")
    return w1p.reshape(groups, 9 * cgp, fgp), w2p[..., :C]


def pack_ffn_weights(w1, b1, w2, groups: int):
    """(F, cg, 3, 3) conv weight, (F,) bias, (C, F) projection weight ->
    (w, b1p), in w1's dtype: the kernel's weights w, flat -- in bf16 the
    weight stream of the wgmma kernel (:func:`_stream`), in f32 w1p (g,
    9*cg, fg) with rows in (dy, dx, ci) order, then w2p (g, fg, C) -- and
    b1p (g*fgp,).  In bf16 cg and fg are padded with zeros (:func:`_align`),
    which adds nothing."""
    Fh, cg = w1.shape[:2]
    fg, C = Fh // groups, w2.shape[0]
    align = _align(C, w1.dtype)
    cgp, fgp = _round(cg, min(align, 16)), _round(fg, align)
    w1p = w1.reshape(groups, fg, cg, 3, 3).permute(0, 3, 4, 2, 1)
    w1p = F.pad(w1p, (0, fgp - fg, 0, cgp - cg)).reshape(groups, 9 * cgp, fgp)
    b1p = F.pad(b1.reshape(groups, fg), (0, fgp - fg)).reshape(-1).contiguous()
    w2p = F.pad(w2.t().reshape(groups, fg, -1), (0, 0, 0, fgp - fg))
    if w1.dtype == torch.bfloat16:
        return _stream(w1p, w2p), b1p
    return torch.cat([w1p.reshape(-1), w2p.reshape(-1)]), b1p


def unpack_ffn_weights(w, b1p, C: int, groups: int):
    """The padded operands (w1p (g, 9*cgp, fgp), w2p (g, fgp, C)) of the
    weights w of :func:`pack_ffn_weights`."""
    fgp = b1p.numel() // groups
    if w.dtype == torch.bfloat16:
        return _unstream(w, C, groups, fgp)
    n1 = groups * 9 * (C // groups) * fgp
    return w[:n1].reshape(groups, -1, fgp), w[n1:].reshape(groups, fgp, C)


def group_ffn_plain(x, w, b1p, b2, *, groups: int, act: str = "erf"):
    """Plain PyTorch version on the packed operands: im2col taps per group
    (channels zero-padded like the packed rows), f32 matmuls."""
    N, H, W, C = x.shape
    cg = C // groups
    w1p, w2p = unpack_ffn_weights(w, b1p, C, groups)
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


def fused_group_ffn(x, w, b1p, b2, *, groups: int, act: str = "erf"):
    """x (N, H, W, C) -> (N, H, W, C), on the operands of
    :func:`pack_ffn_weights` (all in x's dtype).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return group_ffn_plain(x, w, b1p, b2, groups=groups, act=act)
    N, H, W, C = x.shape
    if C % groups:
        raise ValueError(f"C={C} not divisible by groups={groups}")
    if act not in _ACTS:
        raise ValueError(f"unknown GELU flavor {act!r}")
    _build.require(x, "x")
    fgp = b1p.numel() // groups
    if fgp % _align(C, x.dtype):
        raise ValueError(f"b1p has {fgp} features per group; {x.dtype} needs a multiple "
                         f"of {_align(C, x.dtype)}")
    size = (_stream_size(C, groups, fgp) if x.dtype == torch.bfloat16
            else groups * fgp * (9 * C // groups + C))
    for name, t, shape in (("w", w, (size,)), ("b1p", b1p, (groups * fgp,)), ("b2", b2, (C,))):
        _build.require(t, name, shape=shape, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    code = _build.load_library().vmg_group_ffn(
        x.data_ptr(), w.data_ptr(), b1p.data_ptr(), b2.data_ptr(), out.data_ptr(),
        N, H, W, C, groups, fgp, _ACTS[act], _build.DTYPE_CODES[x.dtype],
        _build.stream_of(x))
    _build.check(code, "vmg_group_ffn")
    fused_group_ffn.launches += 1
    return out


fused_group_ffn.launches = 0
