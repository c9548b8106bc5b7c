"""Host-side layouts and launch plans of the bf16 MorphFC combine and the
LTAM forward kernels (``csrc/morphfc.cu``, ``csrc/ltam.cu``), on CPU.

The combine kernel multiplies against Pk as a wgmma B image that the
module packs once; these tests hold the pack and its inverse to the plain
(C_in, C_out) matrix.  Both kernels take their block plans from the
wrappers; every plan must fit a block's 232,448 bytes of shared memory and
128 (LTAM) or 384 (combine) threads at every path shape.
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
