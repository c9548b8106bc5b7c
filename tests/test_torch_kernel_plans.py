"""Host-side layouts and launch plans of the bf16 MorphFC combine and axes
kernels and the LTAM forward and backward kernels (``csrc/morphfc.cu``,
``csrc/ltam.cu``), on CPU.

The combine kernel multiplies against Pk as a wgmma B image that the
module packs once; these tests hold the pack and its inverse to the plain
(C_in, C_out) matrix.  The kernels take their block plans from the
wrappers; every plan must fit a block's 232,448 bytes of shared memory and
128 (LTAM forward), 256 (LTAM backward, axes) or 384 (combine) threads at
every path shape.  The bf16 axes kernel forms its token matrices straight
from the staged slab with its own index arithmetic: a Python model of that
arithmetic is held to ``axis_tokens`` / ``axis_untokens``.
"""

import numpy as np
import pytest
import torch

from vmg_tpu_torch.ops import ltam_attention, morphfc_fused

MAX_SMEM = 232_448
# (C, heads) of LTAM on the repo's paths: FULL_PRESET's trajectory stages
# (d = 28), the few-levels preset (d = 36), and the wider test widths
LTAM_PATH = [(112, 4), (144, 4), (128, 2), (144, 1), (16, 4), (32, 2)]


@pytest.mark.parametrize("C", [16, 32, 112, 144, 224, 240, 448])
def test_combine_image_round_trip(C):
    """240 pads its last 64-column N-tile with zeros."""
    rng = np.random.default_rng(C)
    pk = torch.from_numpy(rng.standard_normal((C, C)).astype(np.float32))
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


@pytest.mark.parametrize("C,ch,cw", AXES_CASES)
def test_axes_fragment_maps_match_the_token_maps(C, ch, cw):
    """The model's token matrices of a seeded slab are ``axis_tokens``'s
    (their groups padded to powers of two, their rows to m64), the staged
    output of a seeded product is ``axis_untokens``'s (even and odd S),
    and the flush's fixed enumeration -- rows m = q, q + cp, ... of a
    sub-tile, features P S + Z -- sums each channel's positions exactly
    once."""
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
    ("vmg::morphfc_final_kernel(float const*, float*, int, int)",
     "MorphFC sums, fixed-order pass (axes, reduce)"),
])
def test_profile_files_the_redesigned_kernels_under_their_names(kernel, cat):
    """profile_serving's (and profile_training's) device-time breakdown
    counts the LTAM backward's two launches, the axes kernels and the
    sums pass under their rows."""
    from vmg_tpu_torch.profile_serving import category
    assert category(kernel) == cat
