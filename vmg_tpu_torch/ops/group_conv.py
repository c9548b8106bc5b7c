"""Grouped-conv FFN: conv3x3 (groups) + bias + GELU + dense projection.

Port of ``vmg_tpu/ops/group_conv.py``.  :func:`fused_group_ffn` calls
the operator ``vmg::group_ffn`` (``ops/library.py``): the hand-written
CUDA kernel ``csrc/group_ffn.cu`` on CUDA tensors (a wgmma implicit GEMM
whose hidden stays on chip: bf16 products, or f32 as three TF32 products
each; see the note at the top of that file) and :func:`group_ffn_plain`
-- the JAX package's ``_xla_forward_ffn`` written in PyTorch -- on CPU
tensors.  Both
take the operands :func:`pack_ffn_weights` makes from ``MlpCnn``'s
parameters (conv weight (F, C/g, 3, 3), bias (F,), projection weight
(C, F)): one weight buffer in the kernel's layout for the dtype, and the
padded bias; ``MlpCnn`` packs them once per parameter state.

Numerics (both versions): the conv accumulates in f32, bias and GELU in
f32, the hidden rounds to the input dtype before the projection, which
accumulates in f32 across groups and rounds once at the end.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vmg_tpu_torch import _build
from vmg_tpu_torch.ops import library

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
    return 48 if C <= 224 else 128


def slab_depth(C: int, groups: int, dtype=torch.bfloat16) -> int:
    """K rows per tap of the kernel: group b's slab starts at channel
    (cg * b) rounded down to 16 bytes (TMA boxes start there: 8 bf16 or 4
    f32 channels), so its channels sit at offset (cg * b) % 8 (% 4); K
    covers the largest offset plus cg, rounded up to the k step, 16 (8 in
    f32) (csrc/group_ffn.cu ``ffn_slab_depth``, ``ffn_slab_depth_f32``)."""
    cg = C // groups
    unit, k = (8, 16) if dtype == torch.bfloat16 else (4, 8)
    return -(-(cg + max((cg * b) % unit for b in range(groups))) // k) * k


def tf32_chunk(C: int) -> int:
    """Hidden features per chunk of the f32 kernel (``tf32_chunk``): 48, 32
    where a warpgroup's output accumulator is wider than 144 channels."""
    return 48 if out_width(C) <= 144 else 32


def tf32_kgroup(C: int) -> int:
    """Conv k8 steps a commit group of the f32 kernel (``tf32_kgroup``): 4
    up to 112 output channels a warpgroup, else 2 (registers)."""
    return 4 if out_width(C) <= 112 else 2


def _round(n: int, align: int) -> int:
    return -(-n // align) * align


FFN_PLAN_FIELDS = ("nb", "Wc", "P", "step", "span", "rows", "tps", "nslab", "nst")
_MAX_SMEM = 232448  # shared memory a block may use (csrc/common.cuh kMaxSmem)
_STAGE_CAP = 32768  # bytes of conv taps a weight stage holds at most
_MAX_STAGES = 12  # ring slots (csrc/group_ffn.cu kMaxStages)


def _ffn_bands(N: int, H: int, W: int, ms: int, sms: int):
    """(nb, Wc, P, step, span, tiles a frame) of the packed bands and of
    64-column bands, whichever takes fewer rounds of ``sms`` blocks; on a
    tie the 64-column bands, whose geometry the kernel knows at compile
    time (~5% faster a tile than the packed form's run-time geometry)."""
    best = None
    for nb, Wc in ((-(-W // 64), -(-W // -(-W // 64))), (-(-W // 64), 64)):
        P = Wc + 2
        step = P if Wc == 64 else 64
        tiles = nb * -(-((H - 1) * P + Wc) // (ms * step))
        key = (-(-N * tiles // sms), Wc != 64)
        if best is None or key < best[0]:
            best = (key, (nb, Wc, P, step, ms * step, tiles))
    return best[1]


def ffn_plan(N: int, H: int, W: int, C: int, groups: int, fgp: int, sms: int = 132):
    """The bf16 kernel's tiles and buffers for frames of H x W x C (the C
    side, ``launch_ffn``, checks what it is given).

    The columns are cut into nb bands of Wc <= 64 (W split as evenly as
    whole columns allow); a band's slab rows hold P = Wc + 2 positions
    (one pad column each side, TMA's out-of-bounds zeros), and its
    positions f = y P + x are walked in tiles of ``span``: ms m64
    sub-tiles (4 up to C = 112, 2 up to 224, else 1), each ``step``
    positions after the last.  Where Wc is 64 a sub-tile is one band row
    (step = P); narrower bands pack 64 consecutive positions across rows
    (step = 64), so only the two pad columns a row are dead: W / (W + 2)
    of a tile is live at one band, against W / 64 for a one-row tile.
    Packed bands are taken where they need fewer rounds of the N frames'
    tiles over ``sms`` blocks (one block an SM).  A
    slab is ``rows`` rows: every row a tile touches plus the halo.  Conv
    taps go ``tps`` a weight stage (9, 3 or 1, <= 32 KB); two slab buffers
    and four ring slots where shared memory holds them, else fewer (above
    C = 224: as many slots as fit, up to 12, each warpgroup's w2 rows in
    two)."""
    split = C > 224
    ms = 1 if split else 4 if C <= 112 else 2
    FC, NW, Kp = chunk_width(C), out_width(C), slab_depth(C, groups)
    nb, Wc, P, step, span, tiles = _ffn_bands(N, H, W, ms, sms)
    b0max = P - 1 if step == 64 else 0
    rows = (b0max + span - 1) // P + 3
    SP = _round(rows * P, 8)
    tps = 9
    while tps > 1 and tps * Kp * FC * 2 > _STAGE_CAP:
        tps //= 3
    # a ring slot: a conv stage, or a w2 stage (split: half of one
    # warpgroup's w2 rows, so that the ring has more, smaller slots)
    stage = max(tps * Kp * FC * 2, FC * NW * 2 // (2 if split else 1))
    hidden = 64 * FC * 2 if split else 0
    out_tile = 0 if split else ms * 64 * (2 * NW + 16)
    plans = (((2, n) for n in range(_MAX_STAGES, 3, -1)) if split
             else ((2, 4), (2, 3), (1, 4), (1, 3), (1, 2)))
    # one slab buffer: the ring holds at least a chunk's w2 slots (2 halves x
    # 2 pieces, or 1), which go ahead of the next group's slab
    w2_slots = 4 if split else 1
    for nslab, nst in (*plans, *((1, n) for n in range(_MAX_STAGES, w2_slots - 1, -1))):
        smem = 128 + nslab * (Kp // 8) * SP * 16 + nst * stage + 2 * hidden + 256 + out_tile
        if smem <= _MAX_SMEM:
            break
    else:
        raise ValueError(f"no FFN plan fits shared memory at {H}x{W}x{C}")
    return dict(nb=nb, Wc=Wc, P=P, step=step, span=span, rows=rows, tps=tps, nslab=nslab,
                nst=nst, ms=ms, SP=SP, tiles=tiles, stage_bytes=stage, smem=smem,
                live=H * W / (tiles * 64 * ms))


def ffn_plan_ints(plan) -> list:
    """A :func:`ffn_plan` as the C entry point reads it (FFN_PLAN_FIELDS)."""
    return [int(plan[k]) for k in FFN_PLAN_FIELDS]


FFN_TF32_PLAN_FIELDS = ("nb", "Wc", "P", "step", "span", "rows", "kcs", "kps", "nslab", "nst")
_TF32_STAGE_CAPS = (28672, 20480, 14336, 8192)  # bytes a ring slot holds at most, tried in turn


def ffn_tf32_plan(N: int, H: int, W: int, C: int, groups: int, fgp: int, sms: int = 132):
    """The f32 kernel's tiles and buffers (the C side, ``launch_ffn_tf32``,
    checks them): :func:`ffn_plan`'s bands with two m64 sub-tiles a tile
    (one a consumer warpgroup: the split fragments leave no registers for
    a second), each tile run once per output half above C = 224 (the conv
    computed again for the second half); slabs of raw f32 in 8-channel
    boxes (``slab_depth(..., float32)`` deep); ring slots of ``kcs`` conv
    (whole commit groups of :func:`tf32_kgroup` steps) or ``kps``
    projection k8 steps, each step as its TF32 hi then lo B image (64 bytes
    a column).  Two slab buffers with at least three slots, and at least a
    chunk's projection slots (the kernel keeps them until the chunk's last
    output piece), where they fit, else one with a chunk's projection slots
    and one more; the largest slot cap that fits."""
    halves = 2 if C > 224 else 1
    FC, NW, Kp = tf32_chunk(C), out_width(C), slab_depth(C, groups, torch.float32)
    nb, Wc, P, step, span, tiles = _ffn_bands(N * halves, H, W, 2, sms)
    b0max = P - 1 if step == 64 else 0
    rows = (b0max + span - 1) // P + 3
    SP = _round(rows * P, 8)
    slab, nk, kb = Kp // 8 * SP * 32, FC // 8, tf32_kgroup(C)
    for cap in _TF32_STAGE_CAPS:
        kcs, kps = max(kb, cap // (64 * FC) // kb * kb), max(1, min(nk, cap // (64 * NW)))
        stage, npj = max(kcs * 64 * FC, kps * 64 * NW), -(-nk // kps)
        for nslab, least in ((2, max(3, npj)), (1, npj + 1)):
            nst = min(_MAX_STAGES, (_MAX_SMEM - 384 - nslab * slab) // stage)
            if nst >= max(2, least):
                smem = 128 + nslab * slab + nst * stage + 256
                return dict(nb=nb, Wc=Wc, P=P, step=step, span=span, rows=rows, kcs=kcs,
                            kps=kps, nslab=nslab, nst=nst, ms=2, SP=SP, tiles=tiles,
                            halves=halves, stage_bytes=stage, smem=smem,
                            live=H * W / (tiles * 128))
    raise ValueError(f"no f32 FFN plan fits shared memory at {H}x{W}x{C}")


def ffn_tf32_plan_ints(plan) -> list:
    """A :func:`ffn_tf32_plan` as the C entry point reads it
    (FFN_TF32_PLAN_FIELDS)."""
    return [int(plan[k]) for k in FFN_TF32_PLAN_FIELDS]


def _align(C: int, dtype) -> int:
    """Padding of fg (and, in bf16, cg): f32 to the k8 step; bf16 to 16, fg
    to 32 where each warpgroup computes half of a chunk (C > 224)."""
    return 8 if dtype != torch.bfloat16 else 16 if C <= 224 else 32


def _chunks(C: int, fgp: int, dtype=torch.bfloat16):
    cw = chunk_width(C) if dtype == torch.bfloat16 else tf32_chunk(C)
    return [(f0, min(cw, fgp - f0)) for f0 in range(0, fgp, cw)]


def _stream_size(C: int, groups: int, fgp: int, dtype=torch.bfloat16) -> int:
    NW, hilo = out_width(C), 1 if dtype == torch.bfloat16 else 2
    return hilo * groups * fgp * (9 * slab_depth(C, groups, dtype) + -(-C // NW) * NW)


def split_tf32(t):
    """(hi, lo) of a float32 tensor: hi rounded to TF32 (to nearest, ties
    away from zero: the low 13 mantissa bits zero, as ``cvt.rna.tf32.f32``),
    lo = t - hi, exact, so hi + lo == t.  The tensor cores read lo's upper
    19 bits: the 3xTF32 product a_hi b_hi + a_hi b_lo + a_lo b_hi misses a b
    by about 2^-21 of |a b|.  A float64 tensor (CPU modules only) splits
    the same way, so that its stream too unpacks exactly."""
    bits = t.float().contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32).to(t.dtype)
    return hi, t - hi


# B row q of a TF32 k8 step holds element _KPERM[q] of the step: a thread's
# register-A pair (k = lane % 4 and lane % 4 + 4) is then elements 2 (lane %
# 4) and + 1, neighbours in the slab and in the conv's accumulator
_KPERM = (0, 2, 4, 6, 1, 3, 5, 7)
_KINV = tuple(_KPERM.index(e) for e in range(8))


def _tf32_image(m):
    """(8 s, n) K x N -> the f32 kernel's B images of its s k8 steps, flat:
    per step its hi then its lo image (2, n, 4) -- K-major 8 x 16-byte core
    matrices, k position 4 kb + e of column n at (kb n + n) 4 + e -- rows
    in _KPERM order."""
    s8, n = m.shape
    img = m.reshape(s8 // 8, 8, n)[:, list(_KPERM)]
    img = img.reshape(s8 // 8, 2, 4, n).permute(0, 1, 3, 2)
    return torch.stack(split_tf32(img), 1).reshape(-1)


def _tf32_unimage(v, steps: int, n: int):
    """The (8 steps, n) matrix of :func:`_tf32_image` (hi + lo)."""
    x = v.reshape(steps, 2, 2, n, 4)
    m = (x[:, 0] + x[:, 1]).permute(0, 1, 3, 2).reshape(steps, 8, n)[:, list(_KINV)]
    return m.reshape(steps * 8, n)


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


def _stream_tf32(w1p, w2p):
    """The f32 kernel's weights from w1p (g, 9*cg, fgp) and w2p (g, fgp, C),
    flat, in its walk order: per group b and hidden chunk (f0, fcw) of
    :func:`tf32_chunk`, the chunk's 9 x Kp/8 conv k8 steps (tap-major; K row
    k is slab channel k, the group's channel k - (cg * b) % 4, zeros
    elsewhere) as :func:`_tf32_image` images, then its w2 rows as fcw/8 steps,
    once per output half [h*NW, h*NW + NW) (:func:`out_width`, zeros past
    C)."""
    G, K9, fgp = w1p.shape
    C = w2p.shape[-1]
    cg, Kp, NW = C // G, slab_depth(C, G, torch.float32), out_width(C)
    halves = -(-C // NW)
    taps = torch.zeros((G, 9, Kp, fgp), dtype=w1p.dtype, device=w1p.device)
    for b in range(G):
        o = (cg * b) % 4
        taps[b, :, o:o + cg] = w1p[b].reshape(9, K9 // 9, fgp)[:, :cg]
    w2z = F.pad(w2p, (0, halves * NW - C))
    parts = []
    for b in range(G):
        for f0, fcw in _chunks(C, fgp, torch.float32):
            parts.append(_tf32_image(taps[b, ..., f0:f0 + fcw].reshape(9 * Kp, fcw)))
            for h in range(halves):
                parts.append(_tf32_image(w2z[b, f0:f0 + fcw, h * NW:(h + 1) * NW]))
    return torch.cat(parts).contiguous()


def _unstream_tf32(w, C: int, groups: int, fgp: int):
    """(w1p, w2p) back from an f32 weight stream (the inverse of
    :func:`_stream_tf32`, hi + lo: exact); raises if a K row outside the
    group's channels or a w2 column past C is not zero."""
    cg, Kp, NW = C // groups, slab_depth(C, groups, torch.float32), out_width(C)
    halves = -(-C // NW)
    taps = torch.zeros((groups, 9 * Kp, fgp), dtype=w.dtype, device=w.device)
    w2p = torch.zeros((groups, fgp, halves * NW), dtype=w.dtype, device=w.device)
    off = 0
    for b in range(groups):
        for f0, fcw in _chunks(C, fgp, torch.float32):
            n = 2 * 9 * Kp * fcw
            taps[b, :, f0:f0 + fcw] = _tf32_unimage(w[off:off + n], 9 * Kp // 8, fcw)
            off += n
            for h in range(halves):
                n = 2 * fcw * NW
                w2p[b, f0:f0 + fcw, h * NW:(h + 1) * NW] = _tf32_unimage(
                    w[off:off + n], fcw // 8, NW)
                off += n
    if off != w.numel():
        raise ValueError(f"stream of {w.numel()} elements, layout of {off}")
    taps = taps.reshape(groups, 9, Kp, fgp)
    w1p = torch.zeros((groups, 9, cg, fgp), dtype=w.dtype, device=w.device)
    for b in range(groups):
        o = (cg * b) % 4
        w1p[b] = taps[b, :, o:o + cg]
        taps[b, :, o:o + cg] = 0
    if taps.any() or w2p[..., C:].any():
        raise ValueError("the stream has weights outside the groups' channels")
    return w1p.reshape(groups, 9 * cg, fgp), w2p[..., :C]


def pack_ffn_weights(w1, b1, w2, groups: int):
    """(F, cg, 3, 3) conv weight, (F,) bias, (C, F) projection weight ->
    (w, b1p), in w1's dtype: the kernel's weight stream w, flat (bf16:
    :func:`_stream`; f32: :func:`_stream_tf32`, each weight as its TF32 hi
    and lo), and b1p (g*fgp,).  fg (and, in bf16, cg) is padded with zeros
    (:func:`_align`), which adds nothing."""
    Fh, cg = w1.shape[:2]
    fg, C = Fh // groups, w2.shape[0]
    align = _align(C, w1.dtype)
    cgp = _round(cg, min(align, 16) if w1.dtype == torch.bfloat16 else 1)
    fgp = _round(fg, align)
    w1p = w1.reshape(groups, fg, cg, 3, 3).permute(0, 3, 4, 2, 1)
    w1p = F.pad(w1p, (0, fgp - fg, 0, cgp - cg)).reshape(groups, 9 * cgp, fgp)
    b1p = F.pad(b1.reshape(groups, fg), (0, fgp - fg)).reshape(-1).contiguous()
    w2p = F.pad(w2.t().reshape(groups, fg, -1), (0, 0, 0, fgp - fg))
    return (_stream if w1.dtype == torch.bfloat16 else _stream_tf32)(w1p, w2p), b1p


def unpack_ffn_weights(w, b1p, C: int, groups: int):
    """The padded operands (w1p (g, 9*cgp, fgp), w2p (g, fgp, C)) of the
    weights w of :func:`pack_ffn_weights`."""
    unstream = _unstream if w.dtype == torch.bfloat16 else _unstream_tf32
    return unstream(w, C, groups, b1p.numel() // groups)


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


def _ffn_cuda(x, w, b1p, b2, groups: int, act: str):
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
    size = _stream_size(C, groups, fgp, x.dtype)
    for name, t, shape in (("w", w, (size,)), ("b1p", b1p, (groups * fgp,)), ("b2", b2, (C,))):
        _build.require(t, name, shape=shape, dtype=x.dtype, device=x.device)
    sms = _build.sm_count(x.device.index or 0)
    ints = (ffn_plan_ints(ffn_plan(N, H, W, C, groups, fgp, sms)) if x.dtype == torch.bfloat16
            else ffn_tf32_plan_ints(ffn_tf32_plan(N, H, W, C, groups, fgp, sms)))
    plan = (ctypes.c_int * len(ints))(*ints)
    out = torch.empty_like(x)
    code = _build.load_library().vmg_group_ffn(
        x.data_ptr(), w.data_ptr(), b1p.data_ptr(), b2.data_ptr(), out.data_ptr(),
        N, H, W, C, groups, fgp, _ACTS[act], plan, _build.DTYPE_CODES[x.dtype],
        _build.stream_of(x))
    _build.check(code, "vmg_group_ffn")
    fused_group_ffn.launches += 1
    return out


def _ffn_cpu(x, w, b1p, b2, groups: int, act: str):
    return group_ffn_plain(x, w, b1p, b2, groups=groups, act=act)


_group_ffn = library.define(
    "group_ffn", "(Tensor x, Tensor w, Tensor b1p, Tensor b2, int groups, str act) -> Tensor",
    cpu=_ffn_cpu, cuda=_ffn_cuda, fake=lambda x, w, b1p, b2, groups, act: library.empty(x))


def fused_group_ffn(x, w, b1p, b2, *, groups: int, act: str = "erf"):
    """x (N, H, W, C) -> (N, H, W, C), on the operands of
    :func:`pack_ffn_weights` (all in x's dtype): ``vmg::group_ffn``.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (on
    :func:`ffn_plan`'s tiles in bf16, :func:`ffn_tf32_plan`'s in f32)."""
    return _group_ffn(x, w, b1p, b2, groups, act)


fused_group_ffn.launches = 0
