"""Host-side layouts and launch plans of the MorphFC reduce, combine and
axes kernels (big and token forms), the LTAM forward and backward kernels
and the grouped-conv FFN (``csrc/morphfc.cu``, ``csrc/ltam.cu``,
``csrc/group_ffn.cu``), on CPU.

The combine kernel multiplies against Pk as a wgmma B image that the
module packs once; these tests hold the pack and its inverse to the plain
(C_in, C_out) matrix.  The kernels take their block plans from the
wrappers; every plan must fit a block's 232,448 bytes of shared memory and
128 (LTAM forward), 256 (LTAM backward, axes) or 384 (combine) threads at
every path shape.  The bf16 axes kernels (both forms) form their token
matrices straight from the staged slab or unit with their own index
arithmetic: a Python model of that arithmetic is held to ``axis_tokens`` /
``axis_untokens``.  The reduce's and the token form's plans must cover
every pixel (unit) once, from the shape and the SM count alone.  The
FFN's plan (bands, slab pitch, packed sub-tiles, ring) must store
every pixel once, give every stored position all nine taps inside its
slab, fit shared memory, and pass the checks of the C entry point, whose
plan fields it names in order.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vmg_tpu_torch.ops import group_conv, ltam_attention, morphfc_fused

MAX_SMEM = 232_448
SMS = 132  # NVIDIA H100 SXM
# (C, heads) of LTAM on the repo's paths: FULL_PRESET's trajectory stages
# (d = 28), the few-levels preset (d = 36), and the wider test widths
LTAM_PATH = [(112, 4), (144, 4), (128, 2), (144, 1), (16, 4), (32, 2)]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch at full
    width in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("C", [16, 32, 112, 144, 224, 240, 448])
def test_combine_image_round_trip(C):
    """The bf16 image; 240 pads its last 64-column N-tile with zeros."""
    rng = np.random.default_rng(C)
    pk = torch.from_numpy(rng.standard_normal((C, C)).astype(np.float32)).bfloat16()
    img = morphfc_fused.pack_combine_weight(pk)
    nt = morphfc_fused.combine_tile_n(C)
    assert nt == (C if C <= 224 else 64)
    assert tuple(img.shape) == morphfc_fused.combine_image_shape(C) == (-(-C // nt), C // 8, nt, 8)
    assert img.is_contiguous()
    assert torch.equal(morphfc_fused.unpack_combine_weight(img), pk)
    # the B image: N-tile t, k group kg, column n, k = 8 kg + ki; zeros past C
    for _ in range(20):
        k, col = rng.integers(C, size=2)
        assert img[col // nt, k // 8, col % nt, k % 8] == pk[k, col]
    assert not img.reshape(-1, C // 8, nt, 8).permute(1, 3, 0, 2).reshape(C, -1)[:, C:].any()
    # flat, each N-tile is contiguous: element (k, col) at t C NT + (kg NT + n) 8 + ki
    flat = img.reshape(-1)
    k, col = C - 1, C - 1
    t, n = divmod(col, nt)
    assert flat[t * C * nt + ((k // 8) * nt + n) * 8 + k % 8] == pk[k, col]


def test_combine_image_refuses_bad_shapes():
    with pytest.raises(ValueError, match="C % 16"):
        morphfc_fused.pack_combine_weight(torch.zeros(24, 24))
    with pytest.raises(ValueError, match=r"\(C, C\)"):
        morphfc_fused.pack_combine_weight(torch.zeros(16, 32))


@pytest.mark.parametrize("C", list(range(16, 449, 16)))
def test_combine_plan_fits(C):
    nwg, ring = morphfc_fused.combine_plan(C)
    assert 1 <= nwg <= (3 if C <= 128 else 2)
    assert 2 <= ring <= morphfc_fused.COMBINE_RING_MAX
    assert morphfc_fused.combine_smem(C, nwg, ring) <= MAX_SMEM
    # the Pk image stays resident up to C = 224, streams in column tiles above
    resident = C * C * 2 if C <= 224 else 0
    assert morphfc_fused.combine_smem(C, 0, 0) == resident + 256
    # slots hold whole 8 KB boxes, 1 KB aligned (the 128-byte swizzle's atom)
    slot = morphfc_fused._combine_slot_bytes(C)
    assert slot % 1024 == 0
    for width in (morphfc_fused.combine_k_width(C), morphfc_fused.combine_x_width(C)):
        assert width <= (C if C <= 160 else 128) and width % 16 == 0
        assert slot >= -(-width // 64) * morphfc_fused.COMBINE_BOX_BYTES
    if C > 224:  # a streamed Pk tile fits a slot
        assert slot >= C * morphfc_fused.combine_tile_n(C) * 2


def test_combine_plan_at_path_shapes():
    """FULL_PRESET's stage widths and the few-levels preset's: three
    warpgroups at C = 112, two at 144 and 224 (Pk resident: 98 KB), one at
    448 (Pk streamed in 56 KB column tiles), the widest rings that fit."""
    assert morphfc_fused.combine_plan(112) == (3, 4)
    assert morphfc_fused.combine_plan(144) == (2, 3)
    assert morphfc_fused.combine_plan(224) == (2, 4)
    assert morphfc_fused.combine_plan(448) == (1, 4)


def test_combine_cpu_route_takes_the_plain_matrix():
    """The module packs the B image only for bf16 parameters on the card:
    CPU tensors keep (C_in, C_out) for the plain version."""
    from vmg_tpu_torch.models.blocks import MorphFCDecay

    m = MorphFCDecay(32, 8, 8).to(torch.bfloat16)
    assert tuple(m.operands()["pk"].shape) == (32, 32)
    assert torch.equal(m.operands()["pk"], m.proj.weight.t())


@pytest.mark.parametrize("C,heads", LTAM_PATH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ltam_fwd_plan_at_path_shapes(C, heads, dtype):
    Wt, HB = ltam_attention.fwd_plan(C, heads)
    d = C // heads
    threads = 2 * Wt * HB * ltam_attention.lanes(d)
    assert Wt >= 2 and Wt % 2 == 0 and heads % HB == 0
    assert threads <= 128
    assert ltam_attention.fwd_smem(Wt, HB, d, dtype) <= MAX_SMEM
    if (C, heads) == (112, 4) and dtype == torch.bfloat16:
        # stage 0: 16 columns, all 4 heads, 128 threads; three blocks an SM
        # (233,472 bytes, 1 KB reserved per block) with all four buffers
        assert (Wt, HB, threads) == (16, 4, 128)
        assert 3 * (ltam_attention.fwd_smem(Wt, HB, d, dtype) + 1024) <= 233_472


@pytest.mark.parametrize("heads", [1, 2, 3, 4, 6, 8])
def test_ltam_fwd_plan_every_head_width(heads):
    """Every head width up to MAX_HEAD_WIDTH has a plan that fits."""
    for d in list(range(1, 65)) + [96, 100, 144, 255, 256, 500, 1000, 1024]:
        C = d * heads
        Wt, HB = ltam_attention.fwd_plan(C, heads)
        assert 2 * Wt * HB * ltam_attention.lanes(d) <= 128
        for dtype in (torch.float32, torch.bfloat16):
            assert ltam_attention.fwd_smem(Wt, HB, d, dtype) <= MAX_SMEM, (d, heads, dtype)


@pytest.mark.parametrize("seg2,es", [(224, 2), (288, 2), (224, 4), (8, 2), (6, 2), (72, 4)])
def test_ltam_pixel_stride(seg2, es):
    """The padded stride keeps 16-byte copies aligned and puts two pixel
    strides 16 banks apart where the run is a 16-byte multiple."""
    pst = ltam_attention._pixel_stride(seg2, es)
    assert pst >= seg2
    if seg2 * es % 16 == 0:
        assert pst * es % 16 == 0
        assert (2 * pst * es // 4) % 32 == 16
    else:
        assert pst == seg2


@pytest.mark.parametrize("C,heads", LTAM_PATH)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 3, 5, 6])
def test_ltam_bwd_plan_at_path_shapes(C, heads, dtype, K):
    Wt, HB, nbuf = ltam_attention.bwd_plan(C, heads, K, dtype)
    d = C // heads
    L = ltam_attention.bwd_lanes(d)
    assert Wt >= 2 and Wt % 2 == 0 and heads % HB == 0 and 1 <= nbuf <= min(K, 4)
    assert 2 * Wt * HB * L <= ltam_attention.BWD_THREADS
    assert ltam_attention.bwd_smem(Wt, HB, d, dtype, nbuf) <= MAX_SMEM
    if (C, heads) in ((112, 4), (144, 4)) and dtype == torch.bfloat16:
        # the training crop at d = 28 and 36: 4 lanes a head, 8 columns x 4
        # heads, 256 threads; 1x64x64 is 256 blocks -- one wave at two a SM
        assert (L, Wt, HB, 2 * Wt * HB * L) == (4, 8, 4, 256)
        assert 32 * (64 // Wt) == 256
        assert 2 * (ltam_attention.bwd_smem(Wt, HB, d, dtype, nbuf) + 1024) <= 233_472


@pytest.mark.parametrize("heads", [1, 2, 3, 4, 6, 8])
def test_ltam_bwd_plan_every_head_width(heads):
    """Every head width up to MAX_HEAD_WIDTH has a backward plan that fits,
    with more lanes per (pixel, head) than the forward's from d = 16 to
    256."""
    for d in list(range(1, 65)) + [96, 100, 144, 255, 256, 257, 500, 1000, 1024]:
        C = d * heads
        L = ltam_attention.bwd_lanes(d)
        assert L & (L - 1) == 0 and L <= 32 and L * (32 if d > 256 else 12) >= d
        if 16 <= d <= 256:
            assert L > ltam_attention.lanes(d) or L == 32
        for dtype in (torch.float32, torch.bfloat16):
            for K in (1, 5):
                Wt, HB, nbuf = ltam_attention.bwd_plan(C, heads, K, dtype)
                assert 2 * Wt * HB * L <= ltam_attention.BWD_THREADS
                assert ltam_attention.bwd_smem(Wt, HB, d, dtype, nbuf) <= MAX_SMEM, (d, heads)


# (C, chunk_h, chunk_w) of the bf16 axes kernel: the stage-0/6 shape, the
# on-card tests' shapes, unequal chunks (two passes), chunks that are not
# powers of two (padded token groups) and odd S = C / chunk
AXES_CASES = [(112, 8, 8), (16, 4, 4), (32, 2, 8), (48, 3, 3), (80, 5, 5), (48, 16, 16),
              (80, 16, 16), (96, 6, 4), (144, 4, 4)]


def test_axes_plan_fits_every_width():
    """Every C = 16..160 with chunks dividing C and chunk * C <= 1024 (the
    form ``axes_form`` picks the big form for) has a plan: the least slab
    of whole W chunks with at least 64 positions, within a block's shared
    memory."""
    for C in range(16, 161, 16):
        for ch in range(1, 65):
            for cw in (ch, 1, 2, 4, 8):
                if C % ch or C % cw or ch * C > 1024 or cw * C > 1024:
                    continue
                plan = morphfc_fused.axes_plan(C, ch, cw)
                assert plan is not None, (C, ch, cw)
                WT, npass, nwg, ring = plan
                assert WT % cw == 0 and 64 <= ch * WT < 64 + ch * cw and WT <= 256
                assert npass == 2 or ch == cw  # one pass needs one branch geometry
                assert 1 <= nwg <= 2 and 1 <= ring <= morphfc_fused.AXES_RING_MAX
                assert ring >= 2 or nwg == 1
                slab = morphfc_fused._slab_bytes(ch * WT, C)
                assert slab % 128 == 0
                assert morphfc_fused.axes_smem(C, slab, nwg, ring, npass) <= MAX_SMEM


def test_axes_plan_at_the_path_shape():
    """Stages 0/6: 8 x 8 slabs (64 tokens a branch, one m64 sub-tile), one
    pass with both 112 x 112 images resident (50 KB), two warpgroups of
    three slots; and the refusal where no plan fits (C = 224, chunk 16)."""
    assert morphfc_fused.axes_plan(112, 8, 8) == (8, 1, 2, 3)
    assert morphfc_fused.axes_plan(224, 16, 16) is None
    assert morphfc_fused.axes_plan(224, 4, 4)[1] == 2  # one weight at a time


def _axes_model(C, ch, cw, WT):
    """The kernel's index arithmetic (csrc/morphfc.cu
    morphfc_axes_wgmma_kernel), element for element: per branch, the slab
    offset of every (token row m, feature column f) of the padded token
    matrix, or -1 for a padding row.  Columns 8 j + 2 l + e are walked as
    the kernel walks them: (P, Z) from 2 l by steps of 8."""
    kg = WT // cw
    out = {}
    for is_h in (True, False):
        chunk = ch if is_h else cw
        cp = morphfc_fused._pow2(chunk)
        S = C // chunk
        ngroups = WT if is_h else ch * kg
        rows = -(-ngroups * cp // 64) * 64
        cstride = WT * C if is_h else C
        col = np.empty(C, dtype=np.int64)
        for l4 in range(4):
            P, Z = divmod(2 * l4, S)
            dP, dZ = divmod(8, S)
            for j in range(C // 8):
                P1, Z1 = (P + 1, 0) if Z + 1 == S else (P, Z + 1)
                col[8 * j + 2 * l4] = P * cstride + Z
                col[8 * j + 2 * l4 + 1] = P1 * cstride + Z1
                P, Z = P + dP, Z + dZ
                if Z >= S:
                    Z, P = Z - S, P + 1
        off = np.full((rows, C), -1, dtype=np.int64)
        for m in range(rows):
            grp, q = divmod(m, cp)
            if q >= chunk or grp >= ngroups:
                continue
            if is_h:
                rowpart = grp * C + q * S
            else:
                rr, G = divmod(grp, kg)
                rowpart = (rr * WT + G * cw) * C + q * S
            off[m] = rowpart + col
        out["h" if is_h else "w"] = off
    return out


def _token_rows(lgu):
    """Token (group, segment q) of each accumulator row (warp wq, lane row
    gr, half hh) of the bf16 token kernel's m64 tile, Gu = 2 ** lgu groups
    a unit (``rowpart`` in morphfc_axes_token_wgmma_kernel)."""
    lqw = max(0, 4 - lgu)
    rows = {}
    for wq in range(4):
        for gr in range(8):
            for hh in range(2):
                if lgu >= 5:
                    q, grp = divmod(16 * wq + gr + 8 * hh, 1 << lgu)
                elif lqw == 4:
                    q, grp = 16 * wq + gr + 8 * hh, 0
                else:
                    q = (wq << lqw) + (gr & ((1 << lqw) - 1))
                    grp = (gr >> lqw) + (hh << (3 - lqw))
                rows[wq, gr, hh] = (grp, q)
    return rows


def _token_model(C, L, is_h, nt):
    """The bf16 token kernel's index arithmetic for one unit of a branch of
    chunk L: the unit's box shape (rows, columns, C); the token (group, q)
    of each accumulator row; per row the box offset of every feature column
    k; per image column n the plain output feature f (-1: a zero column);
    and the box offset each (row, n) is staged at."""
    b = morphfc_fused.token_branch(64, 64, C, L, 1 if is_h else 2, nt)
    S, gu = b["S"], b["gu"]
    box = (L, gu, C) if is_h else (gu, L, C)
    cstride = gu * C if is_h else C
    col = np.empty(C, dtype=np.int64)  # fragment column 8 j + 2 l4 + e -> (P, Z)
    for l4 in range(4):
        P, Z = divmod(2 * l4, S)
        dP, dZ = divmod(8, S)
        for j in range(C // 8):
            P1, Z1 = (P + 1, 0) if Z + 1 == S else (P, Z + 1)
            col[8 * j + 2 * l4] = P * cstride + Z
            col[8 * j + 2 * l4 + 1] = P1 * cstride + Z1
            P, Z = P + dP, Z + dZ
            if Z >= S:
                Z, P = Z - S, P + 1
    ncols = b["ntiles"] * nt
    feat = np.full(ncols, -1, dtype=np.int64)
    stage_col = np.full(ncols, -1, dtype=np.int64)
    for n in range(ncols):
        t, nn = divmod(n, nt)
        Z = 8 * (t // b["tpz"]) + nn % 8
        P = (t % b["tpz"]) * (nt // 8) + nn // 8
        if Z < S and P < L:
            feat[n] = P * S + Z
            stage_col[n] = P * cstride + Z
    rows = _token_rows(int(np.log2(gu)))
    tokens = {}  # accumulator row index m = 16 wq + gr + 8 hh -> box offset base
    for (wq, gr, hh), (grp, q) in rows.items():
        if q < L:
            tokens[16 * wq + gr + 8 * hh] = (grp, q, (grp * C if is_h else grp * L * C) + q * S)
    return b, box, col, feat, stage_col, tokens, rows


def _token_fold(b, y_img, C, nt):
    """The kernel's per-channel sums of one unit: per tile, a thread's
    positions of each row and channel (lane l4's channels 8 zb + 2 l4 + e),
    its two rows where they share q, the lanes the shuffles join, one owner
    lane's add into the warpgroup's channel array at q S + Z (or, Gu >= 32,
    its warp's); then the arrays in order."""
    S, L, lgu = b["S"], b["L"], int(np.log2(b["gu"]))
    rows = _token_rows(lgu)
    lqw = max(0, 4 - lgu)
    hshare, lsh = lqw < 4, min(lqw, 3)
    ws = np.zeros((4, C))
    for t in range(b["ntiles"]):
        zc = 8 * (t // b["tpz"])
        pb = (t % b["tpz"]) * (nt // 8)
        for wq in range(4):
            rs = np.zeros((8, 4, 2, 2))  # gr, l4, hh, e
            for gr in range(8):
                for l4 in range(4):
                    for hh in range(2):
                        grp, q = rows[wq, gr, hh]
                        if q >= L:
                            continue
                        for j in range(nt // 8):
                            if pb + j >= L:
                                break
                            for e in range(2):
                                rs[gr, l4, hh, e] += y_img[16 * wq + gr + 8 * hh,
                                                           t * nt + 8 * j + 2 * l4 + e]
            for gr in range(8):
                if gr >> lsh:
                    continue  # not an owner lane
                mates = [g2 for g2 in range(8) if g2 & ((1 << lsh) - 1) == gr]
                for l4 in range(4):
                    for e in range(2):
                        Z = zc + 2 * l4 + e
                        if Z >= S:
                            continue
                        v0 = sum(rs[g2, l4, 0, e] + (rs[g2, l4, 1, e] if hshare else 0)
                                 for g2 in mates)
                        arr = wq if lgu >= 5 else 0
                        grp, q = rows[wq, gr, 0]
                        if q < L:
                            ws[arr, q * S + Z] += v0
                        if not hshare:
                            grp, q = rows[wq, gr, 1]
                            if q < L:
                                ws[arr, q * S + Z] += rs[gr, l4, 1, e]
    return ((ws[0] + ws[1]) + ws[2]) + ws[3]


# the token form's cases: stages 1/5 (S = 14) and 3 (S = 56), small chunks
# (padded token groups; Gu = 32: a segment's rows span warps), odd S
TOKEN_MAP_CASES = [(224, 16, 16), (448, 8, 8), (96, 4, 4), (64, 2, 8), (160, 8, 8), (48, 3, 3),
                   (112, 16, 16), (48, 16, 16), (64, 64, 64)]


@pytest.mark.parametrize("C,ch,cw,form", [case + ("big",) for case in AXES_CASES] + [
    case + ("token",) for case in TOKEN_MAP_CASES], ids=[
    "-".join(map(str, case)) for case in AXES_CASES] + [
    "token-" + "-".join(map(str, case)) for case in TOKEN_MAP_CASES])
def test_axes_fragment_maps_match_the_token_maps(C, ch, cw, form):
    """The model's token matrices of a seeded slab (big form) or unit
    (token form) are ``axis_tokens``'s (their groups padded to powers of
    two, their rows to m64), the staged output of a seeded product is
    ``axis_untokens``'s (even and odd S), and the sums' fixed enumeration
    -- big form: rows m = q, q + cp, ... of a sub-tile, features P S + Z;
    token form: the Z-major image columns' 8-column groups folded across
    lanes and warps -- sums each channel's positions exactly once.  The
    token form at the stage-1/5 (C = 224, chunk 16, S = 14) and stage-3
    (C = 448, chunk 8, S = 56) chunks."""
    if form == "token":
        rng = np.random.default_rng(C + ch + cw)
        nt = morphfc_fused.token_nt(C, ch, cw)
        for L, axis in ((ch, 1), (cw, 2)):
            b, box, col, feat, stage_col, tokens, rows = _token_model(C, L, axis == 1, nt)
            # every accumulator row is one token (padding rows: q >= L)
            assert sorted(rows.values()) == sorted(
                (g, q) for g in range(b["gu"]) for q in range(b["cp"]))
            x = torch.from_numpy(rng.standard_normal((1, *box)).astype(np.float32))
            flat = x.reshape(-1)
            tok = morphfc_fused.axis_tokens(x, L, axis)  # rows (group, q)
            assert len(tokens) == tok.shape[0] == b["gu"] * L
            order = sorted(tokens, key=lambda m: tokens[m][:2])  # accumulator rows by token
            off = np.stack([tokens[m][2] + col for m in order])
            assert torch.equal(flat[torch.from_numpy(off)], tok)
            assert sorted(off.reshape(-1).tolist()) == list(range(flat.numel()))
            # the image's columns: every plain feature once, the rest zero
            assert sorted(feat[feat >= 0].tolist()) == list(range(C))
            # the epilogue: image column n of token row m lands at its
            # row's base + stage_col[n], the (token, feature)'s own x element
            y = torch.from_numpy(rng.standard_normal((tok.shape[0], C)).astype(np.float32))
            y_img = np.zeros((64, feat.size))
            for i, m in enumerate(order):
                y_img[m, feat >= 0] = y.numpy()[i, feat[feat >= 0]]
            staged = torch.full_like(flat, float("nan"))
            for m in order:
                idx = tokens[m][2] + stage_col[stage_col >= 0]
                staged[torch.from_numpy(idx)] = torch.from_numpy(y_img[m, stage_col >= 0]).float()
            untok = morphfc_fused.axis_untokens(y, x.shape, L, axis)
            assert torch.equal(staged.reshape(x.shape), untok)
            np.testing.assert_allclose(_token_fold(b, y_img, C, nt),
                                       untok.sum(dim=(0, 1, 2)).numpy(), rtol=1e-5, atol=1e-4)
        return
    WT = morphfc_fused.axes_slab_width(C, ch, cw)
    rng = np.random.default_rng(C + ch + cw)
    x = torch.from_numpy(rng.standard_normal((1, ch, WT, C)).astype(np.float32))
    flat = x.reshape(-1)
    model = _axes_model(C, ch, cw, WT)
    for name, chunk, axis in (("h", ch, 1), ("w", cw, 2)):
        off = model[name]
        cp = morphfc_fused._pow2(chunk)
        real = off[:, 0] >= 0
        tok = morphfc_fused.axis_tokens(x, chunk, axis)
        assert int(real.sum()) == tok.shape[0] and off.shape[0] % 64 == 0
        assert torch.equal(flat[torch.from_numpy(off[real])], tok)
        # every slab element is one (token, feature) of the branch
        assert sorted(off[real].reshape(-1).tolist()) == list(range(flat.numel()))
        # the epilogue's staging: y at the (token, feature)'s own offset
        y = torch.from_numpy(rng.standard_normal((tok.shape[0], C)).astype(np.float32))
        staged = torch.empty_like(flat)
        staged[torch.from_numpy(off[real])] = y
        assert torch.equal(staged.reshape(x.shape),
                           morphfc_fused.axis_untokens(y, x.shape, chunk, axis))
        # the flush: accumulator positions (m % 64, f), summed over sub-tiles
        yp = torch.zeros((off.shape[0], C))
        yp[torch.from_numpy(real)] = y
        acc = yp.reshape(-1, 64, C).sum(0)
        S = C // chunk
        want = morphfc_fused.axis_untokens(y, x.shape, chunk, axis).sum(dim=(0, 1, 2))
        got = torch.zeros(C)
        for cc in range(C):
            q, Z = divmod(cc, S)
            for m in range(q, 64, cp):
                for P in range(chunk):
                    got[cc] += acc[m, P * S + Z]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_axes_cpu_route_takes_the_plain_matrices():
    """The bf16 kernel stages its B images from the plain (C_in, C_out)
    decayed matrices, so ``MorphFCDecay`` packs nothing new: its kh, kw stay
    the plain matrices the 'hybrid' form and the CPU route read."""
    from vmg_tpu_torch.models.blocks import MorphFCDecay

    m = MorphFCDecay(32, 8, 8).to(torch.bfloat16)
    ops = m.operands()
    kh, kw = m._decayed()
    assert tuple(ops["kh"].shape) == tuple(ops["kw"].shape) == (32, 32)
    assert torch.equal(ops["kh"], kh.contiguous()) and torch.equal(ops["kw"], kw.contiguous())


@pytest.mark.parametrize("kernel,cat", [
    ("void vmg::ltam_bwd_kernel<__nv_bfloat16, 4, 8>(float const*, __nv_bfloat16 const*, "
     "float const*, float const*, float const*, float const*, float*, __nv_bfloat16*, float*, "
     "vmg::LtamBwdArgs)", "LTAM backward kernels"),
    ("vmg::ltam_bwd_dpe_kernel(float const*, float*, int, int)", "LTAM backward kernels"),
    ("void vmg::ltam_fwd_kernel<__nv_bfloat16, 1, 4>(float const*, __nv_bfloat16 const*, "
     "float const*, float*, float*, vmg::LtamFwdArgs)", "LTAM kernel"),
    ("void vmg::morphfc_axes_wgmma_kernel<7>(vmg::AxesMaps, vmg::AxesArgs)",
     "MorphFC axes kernel"),
    ("vmg::morphfc_axes_f32_kernel(float const*, float const*, float const*, float const*, "
     "float const*, float const*, float*, float*, float*, int, int, int, int, int, int)",
     "MorphFC axes kernel"),
    ("void vmg::morphfc_axes_wgmma_kernel<7, true>(vmg::AxesMaps, vmg::AxesArgs)",
     "MorphFC axes kernel"),
    ("void vmg::group_ffn_tf32_kernel<112>(CUtensorMap_st, vmg::FfnTfArgs)", "FFN kernel"),
    ("vmg::morphfc_final_kernel(float const*, float*, int, int)",
     "MorphFC sums, fixed-order pass (axes, reduce)"),
])
def test_profile_files_the_redesigned_kernels_under_their_names(kernel, cat):
    """profile_serving's (and profile_training's) device-time breakdown
    counts the LTAM backward's two launches, the axes kernels (the f32
    scalar kernel's name too: ``--tree`` profiles earlier trees), the f32
    FFN and the sums pass under their rows."""
    from vmg_tpu_torch.profile_serving import category
    assert category(kernel) == cat


# (N, P) of the reduce: FULL_PRESET's stages 1/5, 2/4, 3 and 0/6, the
# few-levels preset's two resolutions, and frames smaller than one block
REDUCE_CASES = [(16, 92 * 160), (16, 46 * 80), (16, 23 * 40), (16, 184 * 320), (32, 128 * 128),
                (32, 64 * 64), (3, 5), (1, 1), (2, 17), (1, 300), (300, 2)]


@pytest.mark.parametrize("C", [16, 112, 144, 224, 448])
@pytest.mark.parametrize("N,P", REDUCE_CASES)
def test_reduce_plan_covers_every_pixel_once(C, N, P):
    """The reduce's first pass: S slices of ``per`` pixels cover each
    frame's pixels exactly once with none empty; every lane of a block is
    live (16-byte vectors at every preset width); at least two blocks an SM
    wherever the frames have a pixel for each lane of that many blocks."""
    vec = morphfc_fused.reduce_vec(C, 2)
    assert vec == 8 and C // vec <= morphfc_fused.RED_THREADS
    lanes = morphfc_fused.RED_THREADS // (C // vec)
    assert lanes * (C // vec) >= morphfc_fused.RED_THREADS - C // vec  # < one vector idle
    S, per = morphfc_fused.reduce_plan(N, P, C, vec, SMS)
    cover = np.zeros(P, dtype=np.int64)
    for s in range(S):
        lo, hi = s * per, min(P, (s + 1) * per)
        assert hi > lo
        cover[lo:hi] += 1
    assert (cover == 1).all()
    if P // lanes >= -(-2 * SMS // N):
        assert N * S >= 2 * SMS
    if (N, P) == (16, 23 * 40) and C == 448:  # stage 3: 272 blocks, 55 pixels each
        assert (S, per) == (17, 55)


@pytest.mark.parametrize("C,itemsize,want", [(112, 2, 8), (40, 2, 8), (24, 2, 8), (12, 2, 4),
                                             (6, 2, 2), (7, 2, 1), (112, 4, 4), (6, 4, 2),
                                             (7, 4, 1)])
def test_reduce_vector_width(C, itemsize, want):
    """16-byte loads where a pixel's C channels are a 16-byte multiple, else
    the widest that divides them; a pointer off the alignment narrows it."""
    assert morphfc_fused.reduce_vec(C, itemsize) == want
    if want >= 2:
        assert morphfc_fused.reduce_vec(C, itemsize, [0, want * itemsize // 2]) == want // 2


@pytest.mark.parametrize("C,itemsize,offset", [(112, 2, 0), (448, 2, 0), (448, 2, 2),
                                                (448, 2, 4), (511, 2, 0), (511, 4, 0),
                                                (512, 4, 4), (16, 2, 0), (40, 2, 2)])
def test_reduce_threads_cover_every_channel_once_a_lane(C, itemsize, offset):
    """The first pass's thread map (``morphfc_partial_kernel``): thread t
    is pixel lane t // nv, vector t % nv; where a pixel has more vectors
    than a block has threads (C = 511, or C = 448 in a view whose rows
    start 2 or 4 bytes off 16) the block is one lane whose threads walk
    vectors t, t + 256, ...  Every lane sums every channel once, and the
    slices still cover each frame's pixels once."""
    vec = morphfc_fused.reduce_vec(C, itemsize, [0, offset])
    nv, lanes = C // vec, morphfc_fused.reduce_lanes(C, vec)
    T = morphfc_fused.RED_THREADS
    seen = np.zeros((lanes, C), dtype=np.int64)
    for t in range(T):
        j, v0 = divmod(t, nv)
        for v in range(v0, nv, T) if j < lanes else ():
            seen[j, v * vec:(v + 1) * vec] += 1
    assert (seen == 1).all()
    if nv > T:
        assert lanes == 1
    else:  # the shared-memory sum of the lanes fits its lanes x C floats
        assert lanes * C <= T * vec
    S, per = morphfc_fused.reduce_plan(16, 23 * 40, C, vec, SMS)
    assert (S - 1) * per < 23 * 40 <= S * per


@pytest.mark.parametrize("N,P,C", [(16, 92 * 160, 224), (16, 23 * 40, 448), (3, 5, 16)])
def test_reduce_plan_depends_on_the_shape_only(N, P, C):
    """The plan -- and so each partial sum's order -- is a function of the
    shape and the SM count: the same on every call, for any data."""
    plans = {morphfc_fused.reduce_plan(N, P, C, 8, SMS) for _ in range(3)}
    assert len(plans) == 1


def _token_walkers(N, b):
    """The bf16 token kernel's walker ranges (``range`` in
    morphfc_axes_token_wgmma_kernel): walker k -> (units [u0, u1), partial
    row in its frame)."""
    out = []
    for k in range(morphfc_fused.TOKEN_WG * b["blocks"]):
        upf = b["upf"]
        if b["fpw"] == 0:
            if k >= N * b["wpf"]:
                out.append((0, 0, 0))
                continue
            f, sub = divmod(k, b["wpf"])
            out.append((f * upf + sub * upf // b["wpf"], f * upf + (sub + 1) * upf // b["wpf"],
                        sub))
        else:
            f0 = min(N, k * b["fpw"])
            f1 = min(N, f0 + b["fpw"])
            out.append((f0 * upf, f1 * upf, 0))
    return out


# (N, H, W, C, chunk_h, chunk_w): stages 1/5 and 3, the on-card tests'
# shapes, the largest C the entry point takes, many frames on few walkers
TOKEN_CASES = [(16, 92, 160, 224, 16, 16), (16, 23, 40, 448, 8, 8), (3, 21, 32, 224, 16, 16),
               (3, 9, 16, 448, 8, 8), (3, 18, 32, 96, 16, 16), (3, 11, 16, 160, 8, 8),
               (3, 18, 24, 96, 4, 4), (3, 14, 32, 64, 2, 8), (2, 16, 64, 512, 8, 8),
               (2, 16, 64, 512, 16, 16), (2, 64, 64, 512, 64, 64), (600, 4, 16, 112, 16, 16)]


@pytest.mark.parametrize("N,H,W,C,ch,cw", TOKEN_CASES)
def test_token_plan_fits_and_covers_every_unit(N, H, W, C, ch, cw):
    """The bf16 token form's plan fits a block (232,448 bytes) with weights
    resident up to C = 224 and streamed above; its walkers cover every unit
    of each branch exactly once and write each frame's partial rows exactly
    once; the partial holds stot rows a frame, c's included."""
    plan = morphfc_fused.token_plan(N, H, W, C, ch, cw, SMS)
    assert plan is not None
    brs = plan["branches"]
    ntmax = max(b["ntiles"] for b in brs)
    assert plan["resident"] == (C <= 224)
    assert morphfc_fused.token_smem(C, plan["nt"], plan["ring"],
                                    ntmax if plan["resident"] else plan["wring"],
                                    plan["nws"]) <= MAX_SMEM
    assert sum(b["blocks"] for b in brs) <= SMS
    rows = 0
    for b in brs:
        # tiles: blocks of 8 channels (S padded), chunk positions in tpz tiles
        assert b["gu"] * b["cp"] == 64 and b["tpz"] * plan["nt"] // 8 >= b["L"]
        assert b["ntiles"] == -(-b["S"] // 8) * b["tpz"]
        cover = np.zeros(N * b["upf"], dtype=np.int64)
        written = np.zeros((N, b["wpf"] if b["fpw"] == 0 else 1), dtype=np.int64)
        for u0, u1, slot in _token_walkers(N, b):
            cover[u0:u1] += 1
            for f in sorted({u // b["upf"] for u in range(u0, u1)}):
                written[f, slot] += 1
        assert (cover == 1).all() and (written == 1).all()
        rows += written.shape[1]
    assert plan["stot"] == rows + plan["sc"]
    # the compile-time path shapes: a tile an 8-channel block, the sums in
    # registers (no channel arrays)
    assert (plan["nws"] == 0) == ((C, ch, cw) in ((224, 16, 16), (448, 8, 8)))
    if (N, H, W, C) == (16, 92, 160, 224):
        # stage 1/5: 28 KB units, two slots each; the 112 KB image (S = 14
        # padded to 16) resident in two tiles
        assert (plan["ring"], plan["nt"]) == (2, 128) and [b["wpf"] for b in brs] == [8, 8]
        assert [b["ntiles"] for b in brs] == [2, 2]
    if (N, H, W, C) == (16, 23, 40, 448):
        # stage 3: 56 KB units, one slot each; 56 KB weight tiles streamed
        # through two slots, seven a unit
        assert (plan["ring"], plan["nt"], plan["wring"]) == (1, 64, 2)
        assert [b["ntiles"] for b in brs] == [7, 7]


def _entry_accepts(plan, N, H, W, C, ch, cw):
    """The checks ``vmg_morphfc_axes_token`` makes of a plan before it
    launches (the C entry point decides nothing of its own)."""
    nt, exact, nws = plan["nt"], plan["exact"], plan["nws"]
    if exact:
        ok = (C, ch, cw, nt) in ((224, 16, 16, 128), (448, 8, 8, 64)) and nws == 0
    else:
        ok = nt in (16, 32, 64) and nws in (1, 4)
    ok &= plan["ring"] in (1, 2) and 2 <= plan["wring"] <= morphfc_fused.TOKEN_WMAX
    slots = ntmax = 0
    for b, L, axis in zip(plan["branches"], (ch, cw), (1, 2)):
        gu = 1 << b["lgu"]
        bw, bh = (gu, L) if axis == 1 else (L, gu)
        G = morphfc_fused.TOKEN_WG * b["blocks"]
        ok &= (b["L"] == L and b["S"] == C // L and gu * morphfc_fused._pow2(L) == 64
               and not (gu >= 32 and not exact and nws != 4)
               and b["tpz"] * nt // 8 >= L and not (exact and b["tpz"] != 1)
               and b["ntiles"] == -(-b["S"] // 8) * b["tpz"] and b["ucols"] * bw >= W
               and b["upf"] % b["ucols"] == 0 and b["upf"] // b["ucols"] * bh >= H
               and b["blocks"] >= 1)
        ok &= (1 <= b["wpf"] <= b["upf"] and N * b["wpf"] <= G if b["fpw"] == 0
               else b["wpf"] == 1 and b["fpw"] * G >= N)
        slots += b["wpf"] if b["fpw"] == 0 else 1
        ntmax = max(ntmax, b["ntiles"])
    ok &= plan["stot"] == slots + plan["sc"]
    ok &= not (plan["resident"] and ntmax > morphfc_fused.TOKEN_WMAX)
    return ok and morphfc_fused.token_smem(
        C, nt, plan["ring"], ntmax if plan["resident"] else plan["wring"], nws) <= MAX_SMEM


@pytest.mark.parametrize("N,H,W,C,ch,cw", TOKEN_CASES)
def test_token_plan_passes_the_entry_points_checks(N, H, W, C, ch, cw):
    """Every plan the wrapper makes is one the C entry point runs: its
    geometry tiles the frames, its tiles cover the chunk and the channel
    blocks, its instantiation exists; residence follows from C and shared
    memory alone (resident up to C = 224, streamed above)."""
    plan = morphfc_fused.token_plan(N, H, W, C, ch, cw, SMS)
    assert _entry_accepts(plan, N, H, W, C, ch, cw)
    assert plan["resident"] == (C <= 224)
    ints = morphfc_fused.token_plan_ints(plan)
    assert len(ints) == len(morphfc_fused.TOKEN_PLAN_FIELDS) + 2 * len(
        morphfc_fused.TOKEN_BRANCH_FIELDS) and all(type(v) is int for v in ints)


def _struct_fields(src, name):
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    return tuple(f.strip() for line in body.split(";") if line.strip().startswith("int ")
                 for f in line.strip()[4:].split(","))


def test_token_plan_fields_match_the_entry_points_struct():
    """The plan crosses into C as ints in the order of ``TokPlan`` and
    ``TokPlanBranch`` in ``csrc/morphfc.cu``: the wrapper's field lists name
    the same fields in the same order."""
    src = (Path(morphfc_fused.__file__).parents[1] / "csrc" / "morphfc.cu").read_text()
    assert _struct_fields(src, "TokPlan") == morphfc_fused.TOKEN_PLAN_FIELDS
    assert _struct_fields(src, "TokPlanBranch") == morphfc_fused.TOKEN_BRANCH_FIELDS
    assert "TokPlanBranch br[2];" in src


# ---- the grouped-conv FFN ----------------------------------------------------

# ((H, W, C), groups, hidden ratio): FULL_PRESET's four stage shapes, the
# few-levels preset's two, the evaluator's 128x128 tiles at four stages, and
# ragged widths (the on-card test's)
FFN_PLAN_SHAPES = [((184, 320, 112), 4, 6), ((92, 160, 224), 4, 6), ((46, 80, 224), 4, 6),
                   ((23, 40, 448), 4, 6), ((128, 128, 144), 1, 2), ((64, 64, 144), 1, 2),
                   ((128, 128, 112), 4, 6), ((64, 64, 224), 4, 6), ((32, 32, 224), 4, 6),
                   ((16, 16, 448), 4, 6), ((11, 13, 16), 4, 6), ((9, 70, 256), 2, 6),
                   ((9, 70, 448), 4, 6), ((1, 1, 32), 1, 2), ((5, 300, 112), 4, 6)]


def _fgp(C, G, ratio):
    fg = ratio * C // G
    return -(-fg // (16 if C <= 224 else 32)) * (16 if C <= 224 else 32)


def _ffn_stores(H, W, plan):
    """The kernel's tile walk (``ffn_tile`` and the epilogues) in numpy: the
    times each pixel is stored, and the largest slab position a stored
    position's taps read (tap (2, 2) of position f: f + 2P + 2)."""
    nb, Wc, P, step, span = (plan[k] for k in ("nb", "Wc", "P", "step", "span"))
    t = np.arange(plan["tiles"])
    q0 = (t // nb) * span
    y0, x0 = q0 // P, (t % nb) * Wc
    f = ((q0 - y0 * P)[:, None, None] + np.arange(plan["ms"])[None, :, None] * step
         + np.arange(64)[None, None, :])
    yy, col = f // P, f % P
    gy, gx = y0[:, None, None] + yy, x0[:, None, None] + col
    live = (col < Wc) & (gx < W) & (gy < H)
    seen = np.zeros((H, W), int)
    np.add.at(seen, (gy[live], gx[live]), 1)
    return seen, int((f + 2 * P + 2)[live].max())


@pytest.mark.parametrize("shape,G,ratio", FFN_PLAN_SHAPES)
def test_ffn_plan_stores_every_pixel_once(shape, G, ratio):
    H, W, C = shape
    plan = group_conv.ffn_plan(16, H, W, C, G, _fgp(C, G, ratio))
    seen, last = _ffn_stores(H, W, plan)
    assert (seen == 1).all()
    assert last < plan["rows"] * plan["P"]  # every stored tap inside the slab's rows
    assert plan["P"] == plan["Wc"] + 2 <= 66 and plan["nb"] * plan["Wc"] >= W
    assert plan["smem"] <= MAX_SMEM and 2 <= plan["nst"] <= 12 and plan["nslab"] in (1, 2)
    assert plan["step"] == (plan["P"] if plan["Wc"] == 64 else 64)


def test_ffn_plan_at_the_narrow_shapes():
    """Stage 3 and the eval tile's stage 3: tiles packed across rows (16 and
    5 a frame, one-row tiles took 23 and 16) and ring slots of 28 KB (one
    tap of 128 features, or half a warpgroup's w2 rows); 64-column bands
    keep one row a sub-tile."""
    fgp = _fgp(448, 4, 6)
    p3 = group_conv.ffn_plan(16, 23, 40, 448, 4, fgp)
    assert (p3["tiles"], p3["P"], p3["step"], p3["rows"]) == (16, 42, 64, 5)
    assert (p3["nslab"], p3["nst"], p3["stage_bytes"]) == (1, 5, 28672)
    assert abs(p3["live"] - 23 * 40 / (16 * 64)) < 1e-12
    pe = group_conv.ffn_plan(16, 16, 16, 448, 4, fgp)
    assert (pe["tiles"], pe["P"], pe["nslab"], pe["nst"]) == (5, 18, 2, 4)
    p0 = group_conv.ffn_plan(16, 184, 320, 112, 4, _fgp(112, 4, 6))
    assert (p0["nb"], p0["P"], p0["step"], p0["rows"], p0["tiles"]) == (5, 66, 66, 6, 230)
    assert (p0["nslab"], p0["nst"], p0["tps"]) == (2, 4, 9)
    # 16x32x32x224: 144 packed tiles and 256 one-row tiles both take two
    # rounds of 132 blocks: the 64-column band wins the tie; with 150
    # blocks the packed tiles take one round
    p2 = group_conv.ffn_plan(16, 32, 32, 224, 4, _fgp(224, 4, 6))
    assert (p2["Wc"], p2["step"], p2["tiles"]) == (64, 66, 16)
    assert group_conv.ffn_plan(16, 32, 32, 224, 4, _fgp(224, 4, 6), sms=150)["Wc"] == 32


def _ffn_entry_accepts(H, W, C, plan):
    """``launch_ffn``'s checks of the plan, in Python."""
    ms = 1 if C > 224 else 4 if C <= 112 else 2
    packed = plan["step"] == 64
    ok = (plan["nb"] >= 1 and plan["Wc"] >= 1 and plan["nb"] * plan["Wc"] >= W
          and (plan["nb"] - 1) * plan["Wc"] < W and plan["P"] == plan["Wc"] + 2
          and plan["P"] <= 256 and plan["rows"] <= 256
          and plan["step"] == (64 if packed else 66) and (packed or plan["Wc"] == 64)
          and plan["span"] == ms * plan["step"])
    b0max = plan["P"] - 1 if packed else 0
    ok &= (b0max + plan["span"] - 1) // plan["P"] + 3 <= plan["rows"]
    ok &= plan["tps"] in (1, 3, 9) and plan["nslab"] in (1, 2) and 2 <= plan["nst"] <= 12
    return ok and (plan["nslab"] == 2 or plan["nst"] >= (4 if C > 224 else 1))


@pytest.mark.parametrize("C,G", [(16, 4), (112, 4), (144, 1), (224, 4), (256, 2), (448, 4)])
def test_ffn_plan_passes_the_entry_points_checks(C, G):
    for H in (1, 7, 23, 64):
        for W in (1, 13, 40, 63, 64, 65, 130, 320):
            plan = group_conv.ffn_plan(3, H, W, C, G, _fgp(C, G, 6 if G > 1 else 2))
            assert _ffn_entry_accepts(H, W, C, plan), (H, W, C, plan)


def test_ffn_plan_fields_match_the_entry_point():
    """The plan crosses into C as ints in FFN_PLAN_FIELDS' order: the entry
    point reads ``plan[i]`` into the field of that name."""
    src = (Path(group_conv.__file__).parents[1] / "csrc" / "group_ffn.cu").read_text()
    reads = dict((int(i), name) for name, i in re.findall(r"a\.(\w+) = plan\[(\d+)\]", src))
    assert tuple(reads[i] for i in sorted(reads)) == group_conv.FFN_PLAN_FIELDS
