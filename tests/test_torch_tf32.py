"""Host side of the float32 FFN, big-form axes, combine and conv-chain
kernels, which run every product as three TF32 products on wgmma (3xTF32:
a_hi b_hi + a_hi b_lo + a_lo b_hi), on CPU.

Why 3xTF32: a numpy emulation at the FFN projection's depth and at the
conv chain's holds it to the f32 tolerance the card's checks use, and one
TF32 product does not meet it.  The split: every hi is a TF32 value and hi + lo is the weight exactly.
The FFN's f32 plan (``group_conv.ffn_tf32_plan``) must store every pixel
once (each tile once per output half), give every stored position its nine
taps inside the slab, fit a block's shared memory at every path, eval-tile
and tiny shape, and pass the C entry point's checks, whose fields it names
in order.  The axes kernel stages each weight's hi and lo images itself: a
model of its staging index arithmetic is held to the k order its token
fragments assume (the FFN stream's ``_KPERM``).  The combine's Pk image and
the chain's tap images come from the host: both round-trip bit for bit,
their padding is zero, and both kernels' plans fit a block's shared memory
at every width the wrappers take.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vmg_tpu_torch.ops import conv_chain, group_conv, morphfc_fused

MAX_SMEM = 232_448
F32 = torch.float32
# ((N, H, W, C), groups, hidden ratio): FULL_PRESET's four stage shapes, the
# few-levels preset's two, the evaluator's 128x128 tiles at four stages,
# the on-card tests' ragged and tiny widths
SHAPES = [((16, 184, 320, 112), 4, 6), ((16, 92, 160, 224), 4, 6), ((16, 46, 80, 224), 4, 6),
          ((16, 23, 40, 448), 4, 6), ((32, 128, 128, 144), 1, 2), ((32, 64, 64, 144), 1, 2),
          ((16, 128, 128, 112), 4, 6), ((16, 64, 64, 224), 4, 6), ((16, 32, 32, 224), 4, 6),
          ((16, 16, 16, 448), 4, 6), ((2, 11, 13, 16), 4, 6), ((3, 9, 70, 256), 2, 6),
          ((3, 9, 70, 448), 4, 6), ((1, 1, 1, 32), 1, 2), ((2, 37, 100, 112), 4, 6),
          ((1, 4, 32, 32), 4, 2), ((2, 5, 7, 48), 4, 6), ((2, 5, 7, 80), 4, 6)]


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch at full
    width in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _fgp(C, G, ratio):
    return -(-(ratio * C // G) // 8) * 8


def _rna(a):
    """float32 -> TF32 to nearest, ties away (cvt.rna.tf32.f32)."""
    return ((a.view(np.int32) + 0x1000) & -0x2000).view(np.float32)


def _trunc(a):
    """What the tensor cores read of a raw float32: its upper 19 bits."""
    return (a.view(np.int32) & -0x2000).view(np.float32)


def test_split_tf32_hi_is_tf32_and_hi_plus_lo_is_exact():
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.standard_normal(4096) * s for s in (1e-30, 1e-3, 1.0, 1e3, 1e30)])
    w = torch.from_numpy(w.astype(np.float32))
    w = torch.cat([w, torch.tensor([0.0, -0.0, 1.0, -2.5, 1 + 2 ** -11, 1 + 3 * 2 ** -12])])
    hi, lo = group_conv.split_tf32(w)
    assert not (hi.view(torch.int32) & 0x1FFF).any()  # low 13 mantissa bits zero
    assert torch.equal(hi + lo, w)
    assert bool(((w - hi - lo).abs() <= 2.0 ** -20 * w.abs()).all())
    assert bool(((w - hi).abs() <= 2.0 ** -11 * w.abs()).all())  # to nearest
    assert torch.equal(hi, torch.from_numpy(_rna(w.numpy())))
    # ties go away from zero: 1 + 2^-11 is halfway between two TF32 values
    assert hi[-2].item() == 1 + 2 ** -10 and hi[-1].item() == 1 + 2 ** -10


def _gelu_hidden(rng):
    """The FFN projection's A at C = 448: 64 positions x K = fg * groups =
    2688 hidden features (GELU outputs), B 2688 x 448."""
    v = rng.standard_normal((64, 2688))
    a = (0.5 * v * (1 + np.tanh(0.7978845608 * (v + 0.044715 * v ** 3)))).astype(np.float32)
    return a, (rng.standard_normal((2688, 448)) * 0.02).astype(np.float32)


def _chain_taps(rng):
    """The conv chain's conv2 at C = 112: 64 positions x K = 9 taps x 112
    channels = 1008 (relu'd conv1 outputs), B 1008 x 112 at the init scale."""
    a = np.maximum(rng.standard_normal((64, 1008)), 0).astype(np.float32)
    return a, (rng.standard_normal((1008, 112)) * 1008 ** -0.5).astype(np.float32)


@pytest.mark.parametrize("operands", [_gelu_hidden, _chain_taps], ids=["ffn_K2688", "chain_K1008"])
def test_3xtf32_meets_the_f32_tolerance_and_one_tf32_pass_does_not(operands):
    """The FFN projection at C = 448 (K = 2688) and the conv chain's conv at
    C = 112 (K = 9 x 112 = 1008).  Against the float64 product, relative to
    its largest value: 3xTF32 (hi rounded, lo as the tensor cores read it)
    within the card's f32 tolerance of 5e-5 (by two orders of magnitude:
    the dropped a_lo b_lo is ~2^-22 a product), one TF32 pass (both
    operands rounded) not."""
    rng = np.random.default_rng(14)
    a, b = operands(rng)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    ahi, bhi = _rna(a), _rna(b)
    alo, blo = _trunc(a - ahi), _trunc(b - bhi)
    f64 = np.float64
    three = ahi.astype(f64) @ bhi.astype(f64) + ahi.astype(f64) @ blo.astype(f64) \
        + alo.astype(f64) @ bhi.astype(f64)
    one = ahi.astype(f64) @ bhi.astype(f64)
    scale = np.abs(exact).max()
    err3, err1 = np.abs(three - exact).max() / scale, np.abs(one - exact).max() / scale
    assert err3 <= 5e-5 / 100, err3
    assert err1 > 5e-5, err1


def test_tf32_image_rows_follow_the_fragment_order():
    """Column n of k8 step j: B row 4 kb + e holds element 8 j + 2 e + kb
    (a thread's register-A pair is elements 2 (lane % 4) and + 1), hi then
    lo, K-major 8 x 16-byte core matrices; the inverse gives the matrix
    back."""
    rng = np.random.default_rng(1)
    m = torch.from_numpy(rng.standard_normal((24, 40)).astype(np.float32))
    img = group_conv._tf32_image(m).reshape(3, 2, 2, 40, 4)  # step, hi/lo, kb, n, e
    hi, lo = group_conv.split_tf32(m)
    for j in range(3):
        for kb in range(2):
            for e in range(4):
                assert torch.equal(img[j, 0, kb, :, e], hi[8 * j + 2 * e + kb])
                assert torch.equal(img[j, 1, kb, :, e], lo[8 * j + 2 * e + kb])
    assert torch.equal(group_conv._tf32_unimage(img.reshape(-1), 3, 40), m)


def _axes_staged(K):
    """The f32 axes kernel's staging (``stage`` in morphfc_axes_wgmma_kernel,
    F32) in numpy: item it = (2 j + kb) C + n writes rows 8 j + 2 e + kb of
    column n, hi at j 16 C + (kb C + n) 4 + e and lo 8 C after."""
    C = K.shape[0]
    out = np.zeros(2 * C * C, np.float32)
    hi = _rna(K)
    lo = K - hi
    for it in range(C // 4 * C):
        jk, n = divmod(it, C)
        j, kb = jk >> 1, jk & 1
        for e in range(4):
            o = j * 16 * C + (kb * C + n) * 4 + e
            out[o], out[o + 8 * C] = hi[8 * j + 2 * e + kb, n], lo[8 * j + 2 * e + kb, n]
    return out


@pytest.mark.parametrize("C", [16, 48, 112])
def test_axes_staged_images_are_the_ffn_streams_image(C):
    """The axes kernel's staged hi and lo images are :func:`_tf32_image` of
    the plain (C_in, C_out) weight (one B layout and k order for both
    kernels), and they sum back to it."""
    rng = np.random.default_rng(C)
    K = (rng.standard_normal((C, C)) * C ** -0.5).astype(np.float32)
    staged = _axes_staged(K)
    assert torch.equal(torch.from_numpy(staged), group_conv._tf32_image(torch.from_numpy(K)))
    assert torch.equal(group_conv._tf32_unimage(torch.from_numpy(staged), C // 8, C),
                       torch.from_numpy(K))


def test_axes_f32_plan_fits_every_width_it_takes():
    """The f32 big form at every C = 16..128 with chunks dividing C and
    chunk * C <= 1024: a plan within a block's shared memory wherever one
    warpgroup's slot (x and c slabs) beside one weight's hi and lo images
    fits, and none only where it does not (C = 144 at chunk 4; C = 32 at
    chunk 32, 131 KB slabs): the wrapper takes the token form there.  Both
    branches in one pass only where both images fit; the stage-0/6 shape
    runs two passes, one warpgroup of two slots."""
    for C in range(16, 129, 16):
        for ch in range(1, 65):
            for cw in (ch, 1, 2, 4, 8):
                if C % ch or C % cw or ch * C > 1024 or cw * C > 1024:
                    continue
                plan = morphfc_fused.axes_plan(C, ch, cw, F32)
                least = morphfc_fused.big_form_smem(
                    ch * morphfc_fused.axes_slab_width(C, ch, cw), C, F32)
                assert (plan is None) == (least > MAX_SMEM), (C, ch, cw)
                if plan is not None:
                    WT, npass, nwg, ring = plan
                    slab = morphfc_fused._slab_bytes(ch * WT, C, F32)
                    assert morphfc_fused.axes_smem(C, slab, nwg, ring, npass, F32) <= MAX_SMEM
    assert morphfc_fused.axes_plan(112, 8, 8, F32) == (8, 2, 1, 2)
    assert morphfc_fused.axes_plan(32, 8, 8, F32) is not None
    assert morphfc_fused.axes_plan(144, 4, 4, F32) is None
    assert morphfc_fused.axes_plan(32, 32, 32, F32) is None


def _stores(H, W, plan):
    """The f32 kernel's tile walk (``ffn_tile`` with two sub-tiles, each
    tile once per output half): the times each (pixel, half) is stored,
    and the largest slab position a stored position's taps read."""
    nb, Wc, P, step, span = (plan[k] for k in ("nb", "Wc", "P", "step", "span"))
    t = np.arange(plan["tiles"])
    q0 = (t // nb) * span
    y0, x0 = q0 // P, (t % nb) * Wc
    f = ((q0 - y0 * P)[:, None, None] + np.arange(2)[None, :, None] * step
         + np.arange(64)[None, None, :])
    yy, col = f // P, f % P
    gy, gx = y0[:, None, None] + yy, x0[:, None, None] + col
    live = (col < Wc) & (gx < W) & (gy < H)
    seen = np.zeros((H, W), int)
    np.add.at(seen, (gy[live], gx[live]), 1)
    return seen * plan["halves"], int((f + 2 * P + 2)[live].max())


def _entry_accepts(H, W, C, plan):
    """``launch_ffn_tf32``'s checks of the plan and its shared memory, in
    Python."""
    NW = group_conv.out_width(C)
    nk = group_conv.tf32_chunk(C) // 8
    ok = (plan["nb"] >= 1 and plan["Wc"] >= 1 and plan["nb"] * plan["Wc"] >= W
          and (plan["nb"] - 1) * plan["Wc"] < W and plan["P"] == plan["Wc"] + 2
          and plan["P"] <= 256 and plan["rows"] <= 256
          and plan["step"] == (plan["P"] if plan["Wc"] == 64 else 64)
          and plan["span"] == 2 * plan["step"])
    b0max = plan["P"] - 1 if plan["step"] == 64 else 0
    ok &= (b0max + plan["span"] - 1) // plan["P"] + 3 <= plan["rows"]
    kb = group_conv.tf32_kgroup(C)
    ok &= (plan["kcs"] >= kb and plan["kcs"] % kb == 0 and 1 <= plan["kps"] <= nk
           and plan["nslab"] in (1, 2)
           and 2 <= plan["nst"] <= 12)
    ok &= plan["nst"] >= -(-nk // plan["kps"])
    Kp = group_conv.slab_depth(C, 1 if C == 32 else 4, F32)  # only the check's form
    stage = max(plan["kcs"] * 64 * group_conv.tf32_chunk(C), plan["kps"] * 64 * NW)
    ok &= stage == plan["stage_bytes"] and plan["smem"] <= MAX_SMEM
    return ok and Kp % 8 == 0


@pytest.mark.parametrize("shape,G,ratio", SHAPES)
def test_ffn_tf32_plan_stores_every_pixel_once_and_fits(shape, G, ratio):
    N, H, W, C = shape
    plan = group_conv.ffn_tf32_plan(N, H, W, C, G, _fgp(C, G, ratio))
    seen, last = _stores(H, W, plan)
    assert (seen == plan["halves"]).all() and plan["halves"] == (2 if C > 224 else 1)
    assert last < plan["rows"] * plan["P"] <= plan["SP"]  # every stored tap inside the slab
    Kp = group_conv.slab_depth(C, G, F32)
    slab = Kp // 8 * plan["SP"] * 32
    assert plan["smem"] == 128 + plan["nslab"] * slab + plan["nst"] * plan["stage_bytes"] + 256
    assert plan["smem"] <= MAX_SMEM
    assert _entry_accepts(H, W, C, plan)


def test_ffn_tf32_plan_at_the_eval_tile():
    """The evaluator's 16x128x128 tile: stage 0/6 on 64-column bands, two
    slab buffers; stage 3 (16x16, C = 448) packed, one slab buffer, each
    tile run for both output halves; K rows a tap padded to the k8 step
    (cg = 28: the slab of 32 channels, 4 borrowed)."""
    p0 = group_conv.ffn_tf32_plan(16, 128, 128, 112, 4, 168)
    assert (p0["Wc"], p0["step"], p0["rows"], p0["nslab"], p0["halves"]) == (64, 66, 4, 2, 1)
    p3 = group_conv.ffn_tf32_plan(16, 16, 16, 448, 4, 672)
    assert (p3["Wc"], p3["step"], p3["nslab"], p3["halves"]) == (16, 64, 1, 2)
    assert group_conv.slab_depth(112, 4, F32) == 32 and group_conv.slab_depth(224, 4, F32) == 56
    assert group_conv.slab_depth(48, 4, F32) == 16 and group_conv.slab_depth(144, 1, F32) == 144
    assert group_conv.slab_depth(40, 4, F32) == 16  # cg = 10: offsets 0, 2, 0, 2


@pytest.mark.parametrize("C,G", [(16, 4), (112, 4), (144, 1), (224, 4), (256, 2), (448, 4)])
def test_ffn_tf32_plan_passes_the_entry_points_checks(C, G):
    for H in (1, 7, 23, 64):
        for W in (1, 13, 40, 63, 64, 65, 130, 320):
            plan = group_conv.ffn_tf32_plan(3, H, W, C, G, _fgp(C, G, 6 if G > 1 else 2))
            assert _entry_accepts(H, W, C, plan), (H, W, C, plan)


def test_ffn_tf32_plan_fields_match_the_entry_point():
    """The f32 plan crosses into C as ints in FFN_TF32_PLAN_FIELDS' order:
    the entry point reads ``plan[i]`` into the field of that name."""
    src = (Path(group_conv.__file__).parents[1] / "csrc" / "group_ffn.cu").read_text()
    reads = dict((int(i), name) for name, i in re.findall(r"t\.(\w+) = plan\[(\d+)\]", src))
    assert tuple(reads[i] for i in sorted(reads)) == group_conv.FFN_TF32_PLAN_FIELDS
    assert group_conv.ffn_tf32_plan_ints(
        group_conv.ffn_tf32_plan(16, 128, 128, 112, 4, 168))[:6] == [2, 64, 66, 66, 132, 4]


# ---- the f32 combine and conv chain (3xTF32) ---------------------------------


def _hi_lo_checks(w, hi, lo):
    """Every hi a TF32 value, hi + lo the weight exactly, and lo as the
    tensor cores read it (its upper 19 bits) within 2^-20 of it."""
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi + lo, w)
    seen = torch.from_numpy(_trunc(lo.numpy().copy()))
    assert bool(((w - hi - seen).abs() <= 2.0 ** -20 * w.abs()).all())


@pytest.mark.parametrize("C", [16, 112, 128, 144, 224, 240, 448])
def test_combine_f32_image_round_trips_and_splits(C):
    """The f32 Pk image: N-tiles of all C up to 224, else two of C / 2
    rounded up to 32 (240: 128, its last 16 columns zero); per N-tile and
    k8 step its hi then its lo image in the fragment order (``_tf32_image``);
    back through :func:`unpack_combine_weight` bit for bit."""
    rng = np.random.default_rng(C)
    pk = torch.from_numpy((rng.standard_normal((C, C)) * 0.02).astype(np.float32))
    img = morphfc_fused.pack_combine_weight(pk)
    nt = morphfc_fused.combine_tile_n(C, F32)
    assert nt == (C if C <= 224 else {240: 128, 448: 224}[C])
    t = -(-C // nt)
    assert tuple(img.shape) == morphfc_fused.combine_image_shape(C, F32) == (t, C // 8, 2, 2, nt, 4)
    assert img.dtype == F32 and img.is_contiguous()
    assert torch.equal(morphfc_fused.unpack_combine_weight(img), pk)
    padded = torch.nn.functional.pad(pk, (0, t * nt - C))
    for i in range(t):
        assert torch.equal(img[i].reshape(-1), group_conv._tf32_image(padded[:, i * nt:(i + 1) * nt]))
    z = torch.zeros_like(img[:, :, 0])
    hi, lo = (torch.cat([group_conv._tf32_unimage(m.reshape(-1), C // 8, nt)
                         for m in torch.stack(parts, 2)], 1) for parts in
              ((img[:, :, 0], z), (z, img[:, :, 1])))
    _hi_lo_checks(padded, hi, lo)
    assert not hi[:, C:].any() and not lo[:, C:].any()


@pytest.mark.parametrize("cin,cout", [(16, 16), (19, 19), (20, 24), (24, 40), (32, 32),
                                      (112, 112), (128, 128), (112, 48), (12, 128)])
def test_conv_f32_tap_images_round_trip_and_split(cin, cout):
    """The f32 taps: K padded to the k8 step, N to 16, zeros in the padding
    (so padded outputs come out exactly zero); per tap and k8 step its hi
    then its lo B image in the fragment order, one stream of 9 Kp / 8 steps;
    back through :func:`tap_matrices` bit for bit."""
    rng = np.random.default_rng(cin * 131 + cout)
    w = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3)) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    img, bias = conv_chain.pack_conv_taps(w, b)
    kp, np_ = -(-cin // 8) * 8, -(-cout // 16) * 16
    assert img.shape == (9, kp // 8, 2, 2, np_, 4) and img.is_contiguous()
    assert bias.shape == (np_,) and torch.equal(bias[:cout], b) and not bias[cout:].any()
    m = conv_chain.tap_matrices(img)
    assert m.shape == (9, kp, np_)
    assert torch.equal(m[:, :cin, :cout], w.permute(2, 3, 1, 0).reshape(9, cin, cout))
    assert not m[:, cin:].any() and not m[:, :, cout:].any()
    for tap in range(9):
        assert torch.equal(img[tap].reshape(-1), group_conv._tf32_image(m[tap]))
    hi, lo = group_conv.split_tf32(m)
    _hi_lo_checks(m, hi, lo)
    # step j of tap t starts 64 Np bytes after step j - 1: one flat stream
    flat = img.reshape(-1)
    assert flat.numel() == 9 * kp // 8 * 16 * np_


@pytest.mark.parametrize("C", list(range(16, 449, 16)))
def test_combine_f32_plan_fits(C):
    """At every C the wrapper takes, two warpgroups (or one, for a call of
    no more items than SMs), at least 4 slots each, within a block's shared
    memory and the kernel's barrier space; Pk resident up to C = 128."""
    for items, nwg in ((10_000, 2), (132, 1), (1, 1)):
        got, ring = morphfc_fused.combine_plan(C, F32, items, 132)
        assert got == nwg and 4 <= ring <= morphfc_fused.COMBINE_F32_RING_MAX
        assert morphfc_fused.combine_smem(C, nwg, ring, F32) <= MAX_SMEM
    fixed = morphfc_fused.combine_smem(C, 0, 0, F32) - morphfc_fused.COMBINE_F32_BAR_BYTES
    assert fixed == (8 * C * C if C <= 128 else 0) + 4 * C  # the resident Pk image, pb


def test_combine_f32_plan_at_path_shapes():
    """The eval tile's stages (112, 224, 448: 16 x 128 x 128 to 16 x 16 x 16),
    FULL_PRESET's stage 0, few-levels' 144, the tiny presets' 32."""
    def plan(N, H, W, C):
        return morphfc_fused.combine_plan(C, F32, morphfc_fused.combine_items(N, H * W, C))

    assert plan(16, 128, 128, 112) == (2, 7)
    assert plan(16, 64, 64, 224) == plan(16, 32, 32, 224) == (2, 7)
    assert morphfc_fused.combine_items(16, 16 * 16, 448) == 128
    assert plan(16, 16, 16, 448) == (1, 15)
    assert plan(16, 184, 320, 112) == (2, 7)
    assert plan(32, 128, 128, 144) == (2, 12)
    assert plan(2, 64, 64, 32) == (1, 24)


@pytest.mark.parametrize("ks", range(1, 17))
@pytest.mark.parametrize("np_", range(16, 129, 16))
def test_conv_f32_plan_fits(ks, np_):
    """Every (input boxes, output width) the f32 chain takes (Cin, Cm up to
    128): a plan within a block's shared memory, whole commit groups a
    stage, at least 3 stages of 4 k8 steps up to 112 channels, and at 128 x
    128 (1x2x64x64's and RCAB's widest) 2-step stages."""
    kcs, nst = conv_chain.chain_tf32_plan(ks, np_)
    assert kcs % 2 == 0 and 2 <= nst <= conv_chain.TF32_MAX_STAGES  # whole commit groups
    assert conv_chain.chain_tf32_smem(ks, np_, kcs, nst) <= MAX_SMEM
    if ks <= 14 and np_ <= 112:
        assert kcs == 4 and nst >= 3
    assert conv_chain.chain_tf32_plan(14, 112) == (4, 3)
    assert conv_chain.chain_tf32_plan(16, 128) == (2, 5)


def test_conv_f32_plan_ints_follow_the_packed_taps():
    """conv1's (kcs, nst), then conv2's, from the images' step counts and
    widths: 1x2x64x64 at the tiny preset's 32 channels, FULL_PRESET's 112."""
    for C, want in ((32, [4, 6, 4, 6]), (112, [4, 3, 4, 3])):
        w = torch.zeros(C, C, 3, 3)
        ops = conv_chain.pack_conv_taps(w, None)
        assert conv_chain.chain_tf32_plan_ints(ops[0], ops[0]) == want
