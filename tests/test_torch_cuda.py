"""The CUDA kernels of vmg_tpu_torch against their plain PyTorch versions,
on the card (marker ``cuda``; each test skips without a CUDA device).

Imports neither jax nor the repo's conftest fixtures, so the GPU machine
runs it as ``python -m pytest tests/test_torch_cuda.py --noconftest``.
Inputs are seeded; float32 with TF32 off, and bf16.  Tolerance, relative
to the largest plain output: f32 1e-4 (summation order), bf16 1.6e-2 (a
few output ulps: both versions round at the same places).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from vmg_tpu_torch.ops import (conv_chain, fused_norm, group_conv, ltam_attention,
                               morphfc_fused, probes)
from vmg_tpu_torch.tools import exp_probe, exp_probe2

_TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _randn(rng, shape, dev, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(dev, dtype)


def _close(got, want, dtype):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= _TOL[dtype] * scale, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,groups", [(16, 4), (32, 1), (112, 4), (224, 4), (448, 4), (144, 1),
                                      (256, 2)])
@pytest.mark.parametrize("N,H,W", [(2, 11, 13), (3, 9, 70)])
def test_group_ffn_kernel(cuda, dtype, C, groups, N, H, W):
    """Ragged tiles (odd H and W; 70 columns: a 64-column tile and a
    6-column one, 9 rows: a partial row band), several frames on the
    persistent walk; every path width: groups of 4 (cg = 4, 28, 56, 112:
    borrowed channels at 4, 28 and 56; fg = 168 padded to 176, a last
    hidden chunk of 32), groups = 1 at C = 32 and the few-levels C = 144
    (fg = 288); above C = 224 the warpgroups split the output channels
    (448: fg = 672, a last chunk of 32; 256 at groups 2: 128 channels
    each).  Two runs are bit-equal."""
    rng = np.random.default_rng(C + W)
    Fh = (2 if groups == 1 else 6) * C
    x = _randn(rng, (N, H, W, C), cuda, dtype)
    w1 = _randn(rng, (Fh, C // groups, 3, 3), cuda, dtype, (9 * C / groups) ** -0.5)
    b1 = _randn(rng, (Fh,), cuda, dtype, 0.1)
    w2 = _randn(rng, (C, Fh), cuda, dtype, 0.02)
    b2 = _randn(rng, (C,), cuda, dtype, 0.1)
    args = (x, *group_conv.pack_ffn_weights(w1, b1, w2, groups), b2)
    for act in ("erf", "tanh"):
        before = group_conv.fused_group_ffn.launches
        got = group_conv.fused_group_ffn(*args, groups=groups, act=act)
        assert group_conv.fused_group_ffn.launches == before + 1
        _close(got, group_conv.group_ffn_plain(*args, groups=groups, act=act), dtype)
        again = group_conv.fused_group_ffn(*args, groups=groups, act=act)
        torch.cuda.synchronize()
        assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,groups", [
    (16, 23, 40, 448, 4), (16, 16, 16, 448, 4),  # packed, warpgroups split C
    (2, 9, 128, 448, 4), (2, 9, 64, 256, 2),  # 64-column bands, split
    (16, 46, 80, 224, 4), (2, 30, 40, 112, 4),  # packed, S = 1 and 2
    (4, 64, 64, 144, 1), (2, 8, 128, 112, 4)])  # 64-column bands, S = 1 and 2
def test_group_ffn_kernel_narrow_images(cuda, N, H, W, C, groups):
    """Every branch of the bf16 kernel's plan (``group_conv.ffn_plan``):
    sub-tiles packed across band rows where a band is narrower than 64
    columns (stage 3, the evaluator's 16x16 stage-3 tile), one row a
    sub-tile on 64-column bands, split and unsplit output channels, one
    slab buffer and two; two runs bit-equal."""
    rng = np.random.default_rng(N * H + W + C)
    dtype, Fh = torch.bfloat16, (2 if groups == 1 else 6) * C
    x = _randn(rng, (N, H, W, C), cuda, dtype)
    w1 = _randn(rng, (Fh, C // groups, 3, 3), cuda, dtype, (9 * C / groups) ** -0.5)
    b1 = _randn(rng, (Fh,), cuda, dtype, 0.1)
    w2 = _randn(rng, (C, Fh), cuda, dtype, 0.02)
    b2 = _randn(rng, (C,), cuda, dtype, 0.1)
    args = (x, *group_conv.pack_ffn_weights(w1, b1, w2, groups), b2)
    got = group_conv.fused_group_ffn(*args, groups=groups, act="tanh")
    _close(got, group_conv.group_ffn_plain(*args, groups=groups, act="tanh"), dtype)
    again = group_conv.fused_group_ffn(*args, groups=groups, act="tanh")
    torch.cuda.synchronize()
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,groups", [
    (2, 37, 100, 112, 4),  # cg = 28 (4 borrowed channels), W not a multiple of the band
    (16, 16, 16, 448, 4), (3, 9, 70, 448, 4),  # output halves, packed / 64-column, one slab
    (16, 46, 80, 224, 4), (4, 64, 64, 144, 1),  # packed C = 224; groups 1, one slab buffer
    (16, 128, 128, 112, 4)])  # the evaluator's stage-0 tile
def test_group_ffn_tf32_plans(cuda, N, H, W, C, groups):
    """The f32 (3xTF32) kernel at every branch of ``ffn_tf32_plan``, with
    the evaluator's erf GELU: within the f32 tolerance of the plain version,
    two runs bit-equal."""
    rng = np.random.default_rng(N * H + W + C)
    dtype, Fh = torch.float32, (2 if groups == 1 else 6) * C
    x = _randn(rng, (N, H, W, C), cuda, dtype)
    w1 = _randn(rng, (Fh, C // groups, 3, 3), cuda, dtype, (9 * C / groups) ** -0.5)
    b1 = _randn(rng, (Fh,), cuda, dtype, 0.1)
    w2 = _randn(rng, (C, Fh), cuda, dtype, 0.02)
    b2 = _randn(rng, (C,), cuda, dtype, 0.1)
    args = (x, *group_conv.pack_ffn_weights(w1, b1, w2, groups), b2)
    got = group_conv.fused_group_ffn(*args, groups=groups, act="erf")
    _close(got, group_conv.group_ffn_plain(*args, groups=groups, act="erf"), dtype)
    again = group_conv.fused_group_ffn(*args, groups=groups, act="erf")
    torch.cuda.synchronize()
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_device_tiled_forward(cuda):
    """The evaluator's tile loop on the card equals the host tile loop (the
    same forward on the same tiles), tiny model, float32."""
    from vmg_tpu_torch.configs import TINY_TEST_PRESET
    from vmg_tpu_torch.eval.device_tiled import make_device_tiled_forward
    from vmg_tpu_torch.eval.inference import SlidingEvaluator
    from vmg_tpu_torch.models.vmg import create_model

    model = create_model(TINY_TEST_PRESET, device=cuda,
                         generator=torch.Generator().manual_seed(0))

    @torch.inference_mode()
    def apply(x):
        return model(x)

    clip = np.random.default_rng(4).random((1, 4, 80, 96, 3), dtype=np.float32)
    host = SlidingEvaluator(lambda c: apply(torch.from_numpy(c).to(cuda)).cpu().numpy(),
                            scale=4, spatial_wins=(64, 64), overlapped_spatial_length=20)
    want = host.test_image(clip)
    got = make_device_tiled_forward(apply, 4, (64, 64), 20, (80, 96))(
        torch.from_numpy(clip).to(cuda))
    assert got.is_cuda and got.shape == want.shape
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [16, 112, 144, 224, 448])
@pytest.mark.parametrize("shape", [(3, 18, 12), (2, 23, 40)])
def test_morphfc_kernels(cuda, dtype, C, shape):
    """The reduce, and the combine with each gate (tanh, sigmoid - 0.5,
    relu), with and without the residual; frames of 216 and 920 pixels
    (ragged last 64-pixel tiles, several frames on the persistent walk);
    every plan: bf16 three warpgroups (16, 112), two (144), one (224, Pk
    resident at 100 KB), two with Pk streamed in column tiles (448); f32 (3xTF32)
    Pk resident (16, 112), streamed a k8 step a unit (144, 224), two N-tiles
    (448).  Both take the packed B image; two runs are bit-equal."""
    rng = np.random.default_rng(C + shape[2])
    shape = (*shape, C)
    x, h, w, c, res = (_randn(rng, shape, cuda, dtype) for _ in range(5))
    a = torch.softmax(_randn(rng, (shape[0], 3, C), cuda, torch.float32), dim=1).to(dtype)
    pk, pb = _randn(rng, (C, C), cuda, dtype, 0.02), _randn(rng, (C,), cuda, dtype, 0.1)
    torch.testing.assert_close(morphfc_fused.fused_morphfc_reduce(h, w, c),
                               morphfc_fused.morphfc_reduce_plain(h, w, c),
                               atol=1e-3, rtol=1e-5)
    pb = pb.float()
    pkk = morphfc_fused.pack_combine_weight(pk)
    for act in ("tanh", "sigmoid", "relu"):
        for r in (None, res):
            before = morphfc_fused.fused_morphfc_combine.launches
            got = morphfc_fused.fused_morphfc_combine(x, h, w, c, a, pkk, pb, act=act,
                                                      residual=r, res_scale=0.5)
            _close(got, morphfc_fused.morphfc_combine_plain(x, h, w, c, a, pk, pb, act=act,
                                                            residual=r, res_scale=0.5),
                   dtype)
            assert morphfc_fused.fused_morphfc_combine.launches == before + 1
            again = morphfc_fused.fused_morphfc_combine(x, h, w, c, a, pkk, pb, act=act,
                                                        residual=r, res_scale=0.5)
            torch.cuda.synchronize()
            assert torch.equal(again, got)
    with pytest.raises(ValueError, match="pk has shape"):  # the plain matrix is not the operand
        morphfc_fused.fused_morphfc_combine(x, h, w, c, a, pk, pb)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [144, 240, 448])
@pytest.mark.parametrize("shape", [(2, 7, 9), (3, 5, 27)])
def test_morphfc_combine_f32_odd_shapes(cuda, C, shape):
    """The f32 (3xTF32) combine where frames are not whole 64-pixel tiles
    (63 and 135 pixels) at the few-levels width (144: Pk streamed), at 240
    (two N-tiles of 128, the last one's columns past C zero) and at 448 (two
    N-tiles of 224), each gate with and without the residual, against the
    plain version; two runs bit-equal."""
    rng = np.random.default_rng(C + shape[2])
    shape = (*shape, C)
    x, h, w, c, res = (_randn(rng, shape, cuda, torch.float32) for _ in range(5))
    a = torch.softmax(_randn(rng, (shape[0], 3, C), cuda, torch.float32), dim=1)
    pk, pb = _randn(rng, (C, C), cuda, torch.float32, 0.02), _randn(rng, (C,), cuda, torch.float32)
    pkk = morphfc_fused.pack_combine_weight(pk)
    for act in ("tanh", "sigmoid", "relu"):
        for r in (None, res):
            kw = dict(act=act, residual=r, res_scale=0.5)
            got = morphfc_fused.fused_morphfc_combine(x, h, w, c, a, pkk, pb, **kw)
            _close(got, morphfc_fused.morphfc_combine_plain(x, h, w, c, a, pk, pb, **kw),
                   torch.float32)
            again = morphfc_fused.fused_morphfc_combine(x, h, w, c, a, pkk, pb, **kw)
            torch.cuda.synchronize()
            assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,H,W,C", [(3, 7, 9, 16), (2, 5, 11, 40), (1, 1, 3, 112), (4, 2, 2, 448),
                                     (2, 33, 65, 144), (16, 23, 40, 448), (16, 46, 80, 224),
                                     (3, 4, 5, 24), (2, 3, 3, 6), (2, 5, 7, 511)])
def test_morphfc_reduce_kernel(cuda, dtype, N, H, W, C):
    """The reduce's first pass at ragged widths (C = 16, 40: 2 and 5
    vectors a pixel; 24 and 6: 8- and 4-byte loads in bf16; 511: one
    element a load, more vectors than a block has threads), frames smaller
    than a block's lanes (3, 11 and 4 pixels), the stage-2/4 and stage-3
    shapes and a few-levels width, against the plain version: f32 sums
    within 1e-6 of the sum of their terms' magnitudes; two runs bit-equal
    (the plan is a function of the shape)."""
    rng = np.random.default_rng(C + H)
    h, w, c = (_randn(rng, (N, H, W, C), cuda, dtype) for _ in range(3))
    before = morphfc_fused.fused_morphfc_reduce.launches
    got = morphfc_fused.fused_morphfc_reduce(h, w, c)
    again = morphfc_fused.fused_morphfc_reduce(h, w, c)
    assert morphfc_fused.fused_morphfc_reduce.launches == before + 2
    want = morphfc_fused.morphfc_reduce_plain(h, w, c)
    terms = sum(v.float().abs().sum(dim=(1, 2)) for v in (h, w, c))
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-6 * terms).all())
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,C,offset", [(torch.bfloat16, 448, 1), (torch.bfloat16, 448, 2),
                                            (torch.bfloat16, 112, 1), (torch.float32, 448, 1),
                                            (torch.float32, 511, 2)])
def test_morphfc_reduce_kernel_views(cuda, dtype, C, offset):
    """Contiguous views whose data start ``offset`` elements into their
    storage (2, 4 or 8 bytes off a 16-byte boundary): narrower loads, and at
    C = 448 more vectors a pixel than a block has threads; against the
    plain version as above, two runs bit-equal."""
    rng = np.random.default_rng(C + offset)
    shape = (3, 9, 13, C)
    n = int(np.prod(shape))
    h, w, c = (_randn(rng, (n + offset,), cuda, dtype)[offset:].view(shape) for _ in range(3))
    assert h.data_ptr() % 16 != 0
    got = morphfc_fused.fused_morphfc_reduce(h, w, c)
    again = morphfc_fused.fused_morphfc_reduce(h, w, c)
    want = morphfc_fused.morphfc_reduce_plain(h, w, c)
    terms = sum(v.float().abs().sum(dim=(1, 2)) for v in (h, w, c))
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-6 * terms).all())
    assert torch.equal(got, again)


def _axes_case(rng, H, W, C, dev, dtype):
    x, c = (_randn(rng, (3, H, W, C), dev, dtype) for _ in range(2))
    kh, kw = (_randn(rng, (C, C), dev, dtype, C ** -0.5) for _ in range(2))
    bh, bw = (_randn(rng, (C,), dev, torch.float32, 0.1) for _ in range(2))
    return x, c, kh, bh, kw, bw


def _axes_close(got, want, c, dtype):
    torch.cuda.synchronize()
    for g, wnt in zip(got[:2], want[:2]):
        err = (g.float() - wnt.float()).abs().max().item()
        assert err <= _TOL[dtype] * wnt.float().abs().max().item(), err
    scale = (want[0].float().abs() + want[1].float().abs() + c.float().abs()).sum(dim=(1, 2))
    assert bool(((got[2] - want[2]).abs() <= 1e-5 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,W,C,chunk_h,chunk_w", [(18, 24, 16, 4, 4), (16, 24, 112, 8, 8),
                                                   (14, 16, 32, 2, 8)])
def test_morphfc_axes_kernel(cuda, dtype, H, W, C, chunk_h, chunk_w):
    """A ragged last H-chunk and slab (18 rows, 24 columns in 16-wide
    slabs), the stage-0 channels and chunks, unequal chunks (a 32-wide slab
    over 16 columns).  h and w are held relative to their largest value
    (they are ~1/C); the sums are f32 whatever the dtype, held to 1e-5 of
    the sum of |h| + |w| + |c|."""
    args = _axes_case(np.random.default_rng(C + H), H, W, C, cuda, dtype)
    got = morphfc_fused.fused_morphfc_axes(*args, chunk_h=chunk_h, chunk_w=chunk_w)
    want = morphfc_fused.morphfc_axes_plain(*args, chunk_h=chunk_h, chunk_w=chunk_w)
    _axes_close(got, want, args[1], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,W,C,chunk_h,chunk_w", [
    (18, 32, 96, 16, 16), (11, 16, 160, 8, 8), (21, 32, 224, 16, 16), (9, 16, 448, 8, 8),
    (18, 24, 96, 4, 4), (14, 32, 64, 2, 8)])
def test_morphfc_axes_token_kernel(cuda, dtype, H, W, C, chunk_h, chunk_w):
    """The token form against the plain version: ragged last H-chunks, a
    ragged W slab (24 columns in 16-wide slabs), C = 96/160/224/448 with
    chunk * C > 1024 (two M-tiles at 224, a partial weight column tile at
    96, 160 and 224), the token form forced below 1024 and unequal chunks.
    Tolerances as the big form's."""
    rng = np.random.default_rng(C + H)
    args = _axes_case(rng, H, W, C, cuda, dtype)
    ax = morphfc_fused.fused_morphfc_axes
    big, token = ax.launches, ax.token_launches
    got = ax(*args, chunk_h=chunk_h, chunk_w=chunk_w, form="token")
    assert (ax.launches, ax.token_launches) == (big, token + 1)
    want = morphfc_fused.morphfc_axes_plain(*args, chunk_h=chunk_h, chunk_w=chunk_w)
    _axes_close(got, want, args[1], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_morphfc_axes_token_against_big(cuda, dtype):
    """The two forms' kernels on one input (the stage-0 channels and
    chunks), and the big form's refusal where its weight does not fit."""
    rng = np.random.default_rng(7)
    args = _axes_case(rng, 16, 24, 112, cuda, dtype)
    big = morphfc_fused.fused_morphfc_axes(*args, chunk_h=8, chunk_w=8, form="big")
    token = morphfc_fused.fused_morphfc_axes(*args, chunk_h=8, chunk_w=8, form="token")
    assert morphfc_fused.axes_form(112, 8, 8) == "big"
    _axes_close(token, big, args[1], dtype)
    wide = _axes_case(rng, 16, 16, 224, cuda, dtype)
    with pytest.raises(ValueError, match="form='token'"):
        morphfc_fused.fused_morphfc_axes(*wide, chunk_h=16, chunk_w=16, form="big")


# (dtype, form, H, W, C, chunk): the four axes kernels -- bf16 and f32 big
# form (stage 0's channels and chunks), bf16 token form at stage 3's
# compile-time shape and at a generic one, f32 token form
AXES_FORMS = [(torch.bfloat16, "big", 18, 24, 112, 8), (torch.float32, "big", 18, 24, 112, 8),
              (torch.bfloat16, "token", 9, 16, 448, 8), (torch.bfloat16, "token", 18, 32, 96, 16),
              (torch.float32, "token", 11, 16, 160, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,form,H,W,C,chunk", AXES_FORMS)
@pytest.mark.parametrize("non_linear,bias", [(True, False), (False, True), (False, False)])
def test_morphfc_axes_kernel_options(cuda, dtype, form, H, W, C, chunk, non_linear, bias):
    """Each axes instantiation in its linear (``non_linear`` off) and
    bias-free forms against the plain version: the kernels take the
    options, none gives way to its plain version (the launch counted), and
    the linear form keeps negative values."""
    rng = np.random.default_rng(C + H + 3)
    x, c, kh, bh, kw, bw = _axes_case(rng, H, W, C, cuda, dtype)
    if not bias:
        bh = bw = None
    ax = morphfc_fused.fused_morphfc_axes
    before = ax.launches + ax.token_launches
    got = ax(x, c, kh, bh, kw, bw, chunk_h=chunk, chunk_w=chunk, form=form,
             non_linear=non_linear)
    assert ax.launches + ax.token_launches == before + 1
    want = morphfc_fused.morphfc_axes_plain(x, c, kh, bh, kw, bw, chunk_h=chunk, chunk_w=chunk,
                                            non_linear=non_linear)
    _axes_close(got, want, c, dtype)
    assert bool((got[0] < 0).any()) == (not non_linear)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk", [((16, 92, 160, 224), 16), ((16, 23, 40, 448), 8)])
def test_morphfc_axes_token_path_shapes(cuda, shape, chunk):
    """The bf16 token form at the stage-1/5 and stage-3 shapes (the ragged
    last H chunk at 92 and 23 rows) against the plain version, within
    phase 2's tolerances (h and w 1e-2 of their largest value, the sums
    1e-6 of the sum of |h| + |w| + |c|); two runs bit-equal (resident
    weight tiles at stage 1/5, streamed at stage 3)."""
    N, H, W, C = shape
    rng = np.random.default_rng(C + H)
    x = _randn(rng, shape, cuda, torch.bfloat16)
    c = _randn(rng, shape, cuda, torch.bfloat16, 0.01)
    kh, kw = (_randn(rng, (C, C), cuda, torch.bfloat16, 0.02) for _ in range(2))
    bh, bw = (_randn(rng, (C,), cuda, torch.float32, 0.1) for _ in range(2))
    args = (x, c, kh, bh, kw, bw)
    ax = morphfc_fused.fused_morphfc_axes
    got = ax(*args, chunk_h=chunk, chunk_w=chunk, form="token")
    again = ax(*args, chunk_h=chunk, chunk_w=chunk, form="token")
    want = morphfc_fused.morphfc_axes_plain(*args, chunk_h=chunk, chunk_w=chunk)
    torch.cuda.synchronize()
    for g, wnt in zip(got[:2], want[:2]):
        assert (g.float() - wnt.float()).abs().max().item() <= 1e-2 * wnt.float().abs().max().item()
    terms = sum(v.float().abs().sum(dim=(1, 2)) for v in (want[0], want[1], c))
    assert bool(((got[2] - want[2]).abs() <= 1e-6 * terms).all())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,chunk", [(16, 23, 40, 448, 8), (4, 46, 80, 224, 16),
                                           (3, 21, 32, 448, 16), (2, 16, 64, 512, 16),
                                           (5, 20, 32, 160, 8), (3, 14, 32, 64, 2)])
def test_morphfc_axes_token_back_to_back(cuda, N, H, W, C, chunk):
    """The bf16 token form in 5 rounds of 40 calls queued with no
    synchronisation between (the pack, c's sums, the kernel and the sums
    pass of one call behind the last call's), at both compile-time path
    shapes and in the generic instantiations (tile widths 16, 32 and 64;
    weight tiles resident, and streamed at C = 448 and 512; a channel
    array a warp at chunk 2): every call's output bit-equal to the first,
    which the plain version holds within phase 2's tolerances.  A weight
    producer whose lane 0 waited alone on the other warpgroup trapped at
    the stage-3 shape within 200 such calls."""
    rng = np.random.default_rng(C + H + chunk)
    shape = (N, H, W, C)
    x = _randn(rng, shape, cuda, torch.bfloat16)
    c = _randn(rng, shape, cuda, torch.bfloat16, 0.01)
    kh, kw = (_randn(rng, (C, C), cuda, torch.bfloat16, 0.02) for _ in range(2))
    bh, bw = (_randn(rng, (C,), cuda, torch.float32, 0.1) for _ in range(2))
    args = (x, c, kh, bh, kw, bw)
    first = None
    for _ in range(5):
        outs = [morphfc_fused.fused_morphfc_axes(*args, chunk_h=chunk, chunk_w=chunk,
                                                 form="token") for _ in range(40)]
        torch.cuda.synchronize()
        first = first or outs[0]
        for out in outs:
            assert all(torch.equal(a, b) for a, b in zip(first, out))
    want = morphfc_fused.morphfc_axes_plain(*args, chunk_h=chunk, chunk_w=chunk)
    torch.cuda.synchronize()
    for g, wnt in zip(first[:2], want[:2]):
        assert (g.float() - wnt.float()).abs().max().item() <= 1e-2 * wnt.float().abs().max().item()
    terms = sum(v.float().abs().sum(dim=(1, 2)) for v in (want[0], want[1], c))
    assert bool(((first[2] - want[2]).abs() <= 1e-6 * terms).all())


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,chunk", [(7, 70, 44, 112, 4), (5, 20, 32, 48, 16),
                                           (3, 21, 40, 32, 2), (17, 184, 40, 112, 8)])
def test_morphfc_axes_persistent_walk(cuda, N, H, W, C, chunk):
    """The bf16 kernel's persistent walk: a frame count and widths that do
    not divide into the walkers' runs or the slabs (a ragged last W slab at
    44 and 40 columns, a ragged last H chunk at 70, 20 and 21 rows), runs
    that cross frames (378 and 1,955 tiles over at most 2 x 132 walkers),
    odd S = C / chunk (48 / 16), and two runs bit-equal."""
    rng = np.random.default_rng(N * W + C)
    x, c = (_randn(rng, (N, H, W, C), cuda, torch.bfloat16) for _ in range(2))
    kh, kw = (_randn(rng, (C, C), cuda, torch.bfloat16, C ** -0.5) for _ in range(2))
    bh, bw = (_randn(rng, (C,), cuda, torch.float32, 0.1) for _ in range(2))
    args = (x, c, kh, bh, kw, bw)
    ax = morphfc_fused.fused_morphfc_axes
    before = ax.launches
    got = ax(*args, chunk_h=chunk, chunk_w=chunk, form="big")
    again = ax(*args, chunk_h=chunk, chunk_w=chunk, form="big")
    assert ax.launches == before + 2
    want = morphfc_fused.morphfc_axes_plain(*args, chunk_h=chunk, chunk_w=chunk)
    _axes_close(got, want, c, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,chunk", [(3, 21, 44, 112, 4), (5, 20, 32, 48, 16),
                                           (17, 184, 40, 112, 8), (2, 9, 16, 32, 8)])
def test_morphfc_axes_f32_persistent_walk(cuda, N, H, W, C, chunk):
    """The f32 (3xTF32) big form's walk: a ragged last W slab (44 columns
    in 16-wide slabs) and H chunk (21, 20 rows), odd S = C / chunk (48 /
    16), runs across frames (2,805 tiles at 17x184x40), both branches in
    one pass where both images fit (C = 32, 48) and two at C = 112; within
    the f32 tolerances of the plain version, two runs bit-equal."""
    rng = np.random.default_rng(N * W + C)
    x, c = (_randn(rng, (N, H, W, C), cuda, torch.float32) for _ in range(2))
    kh, kw = (_randn(rng, (C, C), cuda, torch.float32, C ** -0.5) for _ in range(2))
    bh, bw = (_randn(rng, (C,), cuda, torch.float32, 0.1) for _ in range(2))
    args = (x, c, kh, bh, kw, bw)
    ax = morphfc_fused.fused_morphfc_axes
    before = ax.launches
    got = ax(*args, chunk_h=chunk, chunk_w=chunk)
    again = ax(*args, chunk_h=chunk, chunk_w=chunk)
    assert ax.launches == before + 2
    want = morphfc_fused.morphfc_axes_plain(*args, chunk_h=chunk, chunk_w=chunk)
    _axes_close(got, want, c, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


_PROBES = [(tool, name) for tool in (exp_probe, exp_probe2) for name in tool.PROBES]


@pytest.mark.cuda
@pytest.mark.parametrize("tool,name", _PROBES, ids=[f"{t.__name__.split('.')[-1]}-{n}"
                                                    for t, n in _PROBES])
def test_probe_kernels(cuda, tool, name):
    """Every probe of both tools on the card: its kernel against its plain
    version (copies bit-exact, products within 1 bf16 ulp of max|plain|,
    the tile probes' copies on every SM bit-equal), one launch or more."""
    counters = (probes.slab_copy, probes.smem_relayout, probes.tile_gemm)
    before = sum(f.launches for f in counters)
    res = tool.PROBES[name](cuda, np.random.default_rng(0))
    assert sum(f.launches for f in counters) > before
    assert res["ms"] > 0 and res["bound_ms"] > 0


def _bf16(rng, shape, dev, scale=1.0):
    return _randn(rng, shape, dev, torch.bfloat16, scale)


# (id, form, A shape, B shape): the tile GEMM at the shapes its design makes
# special -- row tiles off 64 rows, 8 to 192 columns, every A form on both
# A paths (TMA where rows are 16-byte aligned, the producer's cp.async
# otherwise), 'cols' with batch > 1, nine K = 28 taps, a stride-32 patch
# whose B gap rows hold junk
_GEMM_CASES = [
    *[(f"rows_M100_N{n}", probes.GemmForm("rows", M=100, K=64, lda=64), (100, 64), (64, n))
      for n in (8, 56, 168, 192)],
    ("rows_K252_cp", probes.GemmForm("rows", M=130, K=252, lda=252), (130, 252), (252, 168)),
    ("rows_3taps", probes.GemmForm("rows", M=150, K=72, taps=3, lda=72, tap_stride=160 * 72),
     (480, 72), (3, 72, 56)),
    ("cols_batch3_cp", probes.GemmForm("cols", M=100, K=40, batch=3, lda=100), (3, 40, 100),
     (40, 24)),
    ("cols_batch2", probes.GemmForm("cols", M=136, K=300, batch=2, lda=136), (2, 300, 136),
     (300, 192)),
    ("taps_K28", probes.GemmForm("taps", M=3 * 70, K=28, taps=9, Wo=70, Cx=32), (5, 80, 32),
     (9, 28, 56)),
    ("taps_K28_cp", probes.GemmForm("taps", M=2 * 37, K=28, taps=9, Wo=37, Cx=28), (4, 40, 28),
     (9, 28, 168)),
    ("taps_K40", probes.GemmForm("taps", M=2 * 70, K=40, taps=9, Wo=70, Cx=40), (4, 80, 40),
     (9, 40, 192)),
    ("assembled_s28", probes.GemmForm("assembled", M=2 * 100, K=252, Wo=100, Cx=128, cg=28,
                                      stride=28), (4, 110, 128), (252, 168)),
    ("assembled_s28_cp", probes.GemmForm("assembled", M=2 * 37, K=252, Wo=37, Cx=28, cg=28,
                                         stride=28), (4, 40, 28), (252, 64)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, 3])
@pytest.mark.parametrize("name,form,a_shape,b_shape", _GEMM_CASES,
                         ids=[c[0] for c in _GEMM_CASES])
def test_tile_gemm_kernel(cuda, name, form, a_shape, b_shape, reps):
    """The tile GEMM against its plain version, within 1 bf16 ulp of the
    largest plain output (f32 sums in another order, one rounding); every
    copy of reps > 1 equal to the first, two runs bit-equal."""
    rng = np.random.default_rng(7)
    a, b = _bf16(rng, a_shape, cuda), _bf16(rng, b_shape, cuda, 0.1)
    before = probes.tile_gemm.launches
    got = probes.tile_gemm(a, b, form, reps=reps)
    again = probes.tile_gemm(a, b, form, reps=reps)
    want = probes.tile_gemm_plain(a, b, form)
    torch.cuda.synchronize()
    assert probes.tile_gemm.launches == before + 2
    one = got if reps == 1 else got[0]
    assert one.shape == want.shape
    err = (one.float() - want.float()).abs().max().item()
    assert err <= 8e-3 * want.float().abs().max().item(), err
    assert torch.equal(got, again)
    if reps > 1:
        assert all(torch.equal(c, got[0]) for c in got)


@pytest.mark.cuda
def test_tile_gemm_stride32_gaps(cuda):
    """The stride-32 assembled patch on the card: junk in B's gap rows (the
    four rows past each tap's 28) never counts."""
    rng = np.random.default_rng(8)
    x = _bf16(rng, (10, 328, 128), cuda)
    w = _bf16(rng, (9, 32, 168), cuda, 0.05)
    w[:, 28:] = 7.0
    form = probes.GemmForm("assembled", M=8 * 320, K=288, Wo=320, Cx=128, cg=28, stride=32)
    got = probes.tile_gemm(x, w.reshape(288, 168), form)
    want = probes.tile_gemm_plain(x, w.reshape(288, 168), form)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 8e-3 * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("H2,Wp,C,R,slabs", [
    (20, 328, 112, 6, 2), (20, 322, 112, 6, 2), (20, 328, 28, 6, 2), (20, 328, 128, 6, 2),
    (20, 331, 112, 6, 2), (20, 326, 28, 6, 2), (12, 100, 16, 4, 3)],
    ids=["dma_sub328_lane112", "dma_sub322_lane112", "dma_sub328_lane28", "dma_sub328_lane128",
         "ragged_331x112", "ragged_326x28", "R4_3slabs"])
def test_slab_copy_kernel(cuda, H2, Wp, C, R, slabs):
    """The slab copy bit-exact against its plain version at every dma_*
    probe's shape and where the last piece is ragged; two runs equal."""
    x = _bf16(np.random.default_rng(9), (2, H2, Wp, C), cuda)
    piece = probes.slab_piece(Wp, C, R, slabs, torch.cuda.get_device_properties(cuda)
                              .multi_processor_count)
    if (H2, Wp, C) in ((20, 331, 112), (20, 326, 28)):
        assert Wp % piece != 0  # the shape exercises a ragged last piece
    got, again = probes.slab_copy(x, R, slabs), probes.slab_copy(x, R, slabs)
    torch.cuda.synchronize()
    assert torch.equal(got, probes.slab_copy_plain(x, R, slabs)) and torch.equal(got, again)


# (id, input shape, layout): every map kind at the probes' shapes and where
# the design takes its other branches -- runs off 16-byte alignment (taps of
# 56-byte rows, a channel slice at 56 bytes, the roll's 2-byte run, slice
# offsets of 1-7 rows and channels), row tiles that are not whole 16-byte
# units (odd Cout, 13 and 9 channels) and ragged last row tiles, roll shifts
# 0 and C - 1, a tiling whose tile does not divide the input's rows, inputs
# that end off a 16-byte unit (the staged tail)
_RELAY_CASES = [
    ("subshift1", (8, 328, 128), probes.Layout("slice", rows=320, chans=128, row=1)),
    ("lane_store_cg28", (8, 328, 28), probes.Layout("taps", rows=320, taps=9)),
    ("lane_store_cg128", (8, 328, 128), probes.Layout("taps", rows=320, taps=9)),
    ("lane_read_off28", (8, 320, 112), probes.Layout("slice", rows=320, chans=28, ch=28)),
    ("roll_lane", (8, 128, 384), probes.Layout("roll", shift=1)),
    ("sublane_store_t32", (1, 32, 384), probes.Layout("tile", taps=9)),
    *[(f"slice_r{r}", (3, 21, 13), probes.Layout("slice", rows=13, chans=5, row=r, ch=r))
      for r in (1, 3, 7)],
    *[(f"taps{t}_c7", (2, 30, 7), probes.Layout("taps", rows=31 - t, taps=t)) for t in (1, 4, 9)],
    ("taps9_ragged", (3, 11, 28), probes.Layout("taps", rows=3, taps=9)),
    *[(f"roll{s}_c9", (2, 9, 9), probes.Layout("roll", shift=s)) for s in (0, 1, 8)],
    ("roll2_tail", (1, 7, 3), probes.Layout("roll", shift=2)),
    ("tile7_c11", (1, 5, 11), probes.Layout("tile", taps=7)),
    ("tile3_frames2", (2, 32, 384), probes.Layout("tile", taps=3)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("sms", [None, 3])
@pytest.mark.parametrize("name,shape,layout", _RELAY_CASES, ids=[c[0] for c in _RELAY_CASES])
def test_smem_relayout_kernel(cuda, name, shape, layout, sms, monkeypatch):
    """The relayout kernel bit-exact against relayout_plain for every map
    kind, aligned and unaligned runs, ragged last row tiles and odd Cout,
    on the card's plan and on a plan for three SMs (longer row tiles); two
    runs bit-equal; one launch a call."""
    if sms is not None:
        monkeypatch.setattr(probes._build, "sm_count", lambda index: sms)
    x = _bf16(np.random.default_rng(11), shape, cuda)
    before = probes.smem_relayout.launches
    got = probes.smem_relayout(x, layout)
    assert probes.smem_relayout.launches == before + 1
    again = probes.smem_relayout(x, layout)
    torch.cuda.synchronize()
    assert probes.smem_relayout.launches == before + 2
    assert torch.equal(got, probes.relayout_plain(x, layout).contiguous())
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_smem_relayout_refuses(cuda):
    """An input off 16-byte alignment raises, launching nothing."""
    x = torch.zeros(181, device=cuda, dtype=torch.bfloat16)[1:].reshape(1, 20, 9)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    before = probes.smem_relayout.launches
    with pytest.raises(ValueError, match="16-byte"):
        probes.smem_relayout(x, probes.Layout("roll", shift=1))
    assert probes.smem_relayout.launches == before


@pytest.mark.cuda
def test_mlp_cnn_kernel_at_stage3_on_the_card(cuda):
    """MlpCnn in eval at FULL_PRESET's stage 3 (16x23x40x448, groups 4,
    exp_r 6), bf16: one FFN kernel launch, and its output agrees with the
    module form (the training path: grouped conv, GELU, fc2) within the
    FFN's bf16 tolerance."""
    from vmg_tpu_torch.models import blocks

    torch.manual_seed(0)
    m = blocks.MlpCnn(448, 6.0, 4, gelu_act="tanh").to(cuda, torch.bfloat16).eval()
    x = _bf16(np.random.default_rng(12), (1, 16, 23, 40, 448), cuda)
    before = group_conv.fused_group_ffn.launches
    with torch.no_grad():
        got = m(x)
        torch.cuda.synchronize()
        assert group_conv.fused_group_ffn.launches == before + 1
        module = m.train()(x)
    torch.cuda.synchronize()
    assert group_conv.fused_group_ffn.launches == before + 1
    _close(got, module, torch.bfloat16)


@pytest.mark.cuda
def test_probe_wrappers_refuse(cuda):
    """A slab row that breaks the bulk copy's 16-byte rule, a product wider
    than the kernel's 192 columns, an A operand off its 4-element units."""
    x = torch.zeros((1, 12, 5, 3), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16 bytes"):
        probes.slab_copy(x)
    a = torch.zeros((32, 16), device=cuda, dtype=torch.bfloat16)
    b = torch.zeros((16, 200), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="N = 200"):
        probes.tile_gemm(a, b, probes.GemmForm("rows", M=32, K=16, lda=16))
    with pytest.raises(ValueError, match="4-element units"):
        probes.tile_gemm(a[:, :14].contiguous(), b[:14, :16].contiguous(),
                         probes.GemmForm("rows", M=32, K=14, lda=14))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,C,heads", [(1, 16, 4), (5, 112, 4), (2, 32, 2), (3, 144, 4),
                                        (2, 128, 2), (4, 144, 1), (6, 112, 4), (2, 12, 3),
                                        (1, 2048, 32)])
@pytest.mark.parametrize("h,w", [(8, 12), (6, 70)])
def test_ltam_kernel(cuda, dtype, K, C, heads, h, w):
    """Head widths d = C / heads of 4, 28, 16, 36 (the few-levels preset's:
    two lanes a head), 64 and 144 (eight lanes), slot counts 1-6, kv in
    f32 and bf16; 70 columns are not a multiple of any column span (16 at
    d = 28: four spans and a 6-column one).  C = 12 (runs of 24 bytes in
    bf16) takes the cp.async copies instead of bulk copies; 32 heads of 64
    split into two head groups per window row."""
    rng = np.random.default_rng(K + w)
    n = 2
    q = torch.nn.functional.normalize(_randn(rng, (n, h, w, C), cuda, torch.float32), dim=-1)
    q = q * (C // heads) ** -0.5
    kv = _randn(rng, (n, h, w, K * 2 * C), cuda, dtype)
    pe = torch.exp(_randn(rng, (K, 4, 4, heads), cuda, torch.float32, 0.5))
    got = ltam_attention.ltam_attention_2x2(q, kv, pe, K=K, heads=heads)
    _close(got, ltam_attention.ltam_attention_plain(q, kv, pe, K=K, heads=heads),
           torch.float32)
    out, den = ltam_attention.ltam_fwd(q, kv, pe, K=K, heads=heads, with_den=True)
    torch.cuda.synchronize()
    assert torch.equal(out, got)
    # den: the unclamped softmax denominator per (pixel, head)
    d = C // heads
    logits = torch.zeros((n, h, w, heads), device=cuda)
    kv6 = kv.reshape(n, h, w, K, 2, C).float()
    pos = (2 * (torch.arange(h, device=cuda) % 2)[:, None]
           + (torch.arange(w, device=cuda) % 2)[None, :])
    for k in range(K):
        for t in range(4):
            key = ltam_attention._tap(kv6[:, :, :, k, 1], *divmod(t, 2))
            e = torch.exp((q.reshape(n, h, w, heads, d) * key.reshape(n, h, w, heads, d)).sum(-1))
            logits += e * pe[k, t][pos]
    torch.testing.assert_close(den, logits, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,C,heads", [(1, 16, 4), (5, 112, 4), (2, 32, 2), (3, 144, 4),
                                        (2, 128, 2), (4, 144, 1), (6, 112, 4)])
def test_ltam_bwd_kernel(cuda, dtype, K, C, heads):
    """The backward kernel against autograd of the plain forward: dq at
    the f32 tolerance, dkv at its dtype's, dpe (a sum over every pixel)
    within 1e-4 of its largest entry; and the autograd Function (forward
    kernel with the denominator, then the backward kernel) end to end."""
    rng = np.random.default_rng(K + C)
    n, h, w = 2, 8, 12
    q = torch.nn.functional.normalize(_randn(rng, (n, h, w, C), cuda, torch.float32), dim=-1)
    q = q * (C // heads) ** -0.5
    kv = _randn(rng, (n, h, w, K * 2 * C), cuda, dtype)
    pe = torch.exp(_randn(rng, (K, 4, 4, heads), cuda, torch.float32, 0.5))
    g = _randn(rng, (n, h, w, C), cuda, torch.float32)
    want = ltam_attention.ltam_attention_bwd_plain(q, kv, pe, g, K=K, heads=heads)

    def check(got):
        _close(got[0], want[0], torch.float32)
        assert got[1].dtype == dtype
        _close(got[1], want[1], dtype)
        err = (got[2] - want[2]).abs().max().item()
        assert err <= 1e-4 * want[2].abs().max().item(), err

    ref = ltam_attention.ltam_attention_2x2
    f0, b0 = ref.launches, ref.bwd_launches
    out, den = ltam_attention.ltam_fwd(q, kv, pe, K=K, heads=heads, with_den=True)
    check(ltam_attention.ltam_attention_2x2_bwd(q, kv, pe, den, out, g, K=K, heads=heads))
    leaves = [t.clone().requires_grad_() for t in (q, kv, pe)]
    y = ltam_attention.ltam_attention_2x2(*leaves, K=K, heads=heads)
    check(torch.autograd.grad(y, leaves, g))
    assert (ref.launches - f0, ref.bwd_launches - b0) == (2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,C,heads", [(5, 112, 4), (6, 112, 4), (3, 144, 4)])
def test_ltam_bwd_kernel_training_shape(cuda, dtype, K, C, heads):
    """The backward at the training crop (1x64x64: stage 0 of FULL_PRESET,
    d = 28, and the few-levels d = 36) and at K = 6 there: the tolerances
    of test_ltam_bwd_kernel, dkv returned in kv's dtype, two runs
    bit-equal."""
    rng = np.random.default_rng(K * C)
    n, h, w = 1, 64, 64
    q = torch.nn.functional.normalize(_randn(rng, (n, h, w, C), cuda, torch.float32), dim=-1)
    q = q * (C // heads) ** -0.5
    kv = _randn(rng, (n, h, w, K * 2 * C), cuda, dtype)
    pe = torch.exp(_randn(rng, (K, 4, 4, heads), cuda, torch.float32, 0.5))
    g = _randn(rng, (n, h, w, C), cuda, torch.float32)
    want = ltam_attention.ltam_attention_bwd_plain(q, kv, pe, g, K=K, heads=heads)
    out, den = ltam_attention.ltam_fwd(q, kv, pe, K=K, heads=heads, with_den=True)
    got = ltam_attention.ltam_attention_2x2_bwd(q, kv, pe, den, out, g, K=K, heads=heads)
    again = ltam_attention.ltam_attention_2x2_bwd(q, kv, pe, den, out, g, K=K, heads=heads)
    _close(got[0], want[0], torch.float32)
    assert got[1].dtype == kv.dtype == dtype
    _close(got[1], want[1], dtype)
    err = (got[2] - want[2]).abs().max().item()
    assert err <= 1e-4 * want[2].abs().max().item(), err
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_train_step_on_the_card(cuda):
    """The f32 training step of TINY_TEST_PRESET (drop_path 0, remat on,
    T=4: K reaches 2) on the card, through both LTAM kernels under autograd
    and checkpointing, against the same step on CPU tensors: the loss
    within 1e-5 relative and the gradient norm within 1e-4 (f32 summation
    order).  Per forward the trajectory stages attend 2 stages x 2
    directions x 3 steps = 12 times; remat recomputes them once."""
    from vmg_tpu_torch.configs import TINY_TEST_PRESET, TrainConfig
    from vmg_tpu_torch.models.vmg import create_model
    from vmg_tpu_torch.train.optimizer import global_norm
    from vmg_tpu_torch.train.train_step import loss_and_grads

    cfg = dataclasses.replace(TINY_TEST_PRESET, drop_path_rate=0.0)
    cpu = create_model(cfg, is_train=True, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(5)
    lrs = torch.from_numpy(rng.random((1, 4, 64, 64, 3), dtype=np.float32))
    hrs = torch.from_numpy(rng.random((1, 4, 256, 256, 3), dtype=np.float32))
    ltam = ltam_attention.ltam_attention_2x2
    f0, b0 = ltam.launches, ltam.bwd_launches
    loss, grads = loss_and_grads(gpu, lrs.to(cuda), hrs.to(cuda), TrainConfig())
    assert (ltam.launches - f0, ltam.bwd_launches - b0) == (24, 12)
    want_loss, want_grads = loss_and_grads(cpu, lrs, hrs, TrainConfig())
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    norm, want_norm = float(global_norm(grads)), float(global_norm(want_grads))
    assert abs(norm - want_norm) <= 1e-4 * want_norm, (norm, want_norm)


@pytest.mark.cuda
def test_bf16_train_steps_on_the_card(cuda):
    """Two steps of ``make_train_step`` in bf16 on float32 masters
    (TINY_TEST_PRESET, drop_path 0.1 from a generator on the card): finite
    losses, float32 masters that moved, bf16 compute weights that follow
    them, and 12 LTAM backward launches per step."""
    from vmg_tpu_torch.configs import TINY_TEST_PRESET, TrainConfig
    from vmg_tpu_torch.models.vmg import create_model
    from vmg_tpu_torch.train.train_step import make_train_step

    model = create_model(TINY_TEST_PRESET, is_train=True, device=cuda,
                         generator=torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.default_rng(6)
    batch = {"LRs": torch.from_numpy(rng.random((1, 4, 64, 64, 3), dtype=np.float32)),
             "HRs": torch.from_numpy(rng.random((1, 4, 256, 256, 3), dtype=np.float32))}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    step = make_train_step(model, TrainConfig(lr=1e-3, T_period=(100,), amp=True), flow_fix=0)
    gen = torch.Generator(device=cuda).manual_seed(1)
    b0 = ltam_attention.ltam_attention_2x2.bwd_launches
    losses = [float(step(batch, gen)["loss"]) for _ in range(2)]
    assert ltam_attention.ltam_attention_2x2.bwd_launches - b0 == 24
    assert all(np.isfinite(losses)), losses
    assert all(p.dtype == torch.float32 for p in model.parameters())
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert moved and not any(n.startswith("spynet") for n in moved)  # SPyNet frozen
    for (n, p), c in zip(model.named_parameters(), step.compute_model.parameters()):
        want = p if n.startswith("spynet") else p.to(torch.bfloat16)
        assert c.dtype == want.dtype and torch.equal(c, want), n


def _chain_operands(rng, Cin, Cm, dev, dtype):
    w1 = _randn(rng, (Cm, Cin, 3, 3), dev, dtype, (9 * Cin) ** -0.5)
    w2 = _randn(rng, (Cin, Cm, 3, 3), dev, dtype, (9 * Cm) ** -0.5)
    b1, b2 = _randn(rng, (Cm,), dev, dtype, 0.1), _randn(rng, (Cin,), dev, dtype, 0.1)
    return (*conv_chain.pack_conv_taps(w1, b1), *conv_chain.pack_conv_taps(w2, b2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N,H,W,Cin,Cm", [(2, 13, 22, 16, 16), (2, 11, 16, 24, 16),
                                          (1, 40, 64, 112, 112), (2, 24, 60, 112, 112),
                                          (3, 37, 70, 64, 64), (3, 9, 130, 128, 128),
                                          (2, 37, 70, 20, 20), (1, 8, 200, 112, 48),
                                          (3, 5, 9, 24, 128), (2, 21, 70, 19, 19),
                                          (1, 11, 70, 128, 112)])
def test_conv_chain_kernel(cuda, dtype, N, H, W, Cin, Cm):
    """Partial row and column tiles (13 x 22, 37 x 70, 9 x 130; the bf16
    tiles are 4 x 64), several frames (the persistent walk crosses frames),
    padded channels (24 -> 32, 20 -> 32 in bf16; 20 and 19 channels are
    rows of 40 and 38 bytes, which TMA cannot take: the plain-load slab; 19
    output channels are stored one at a time), 16 to 128 channels and
    Cm != Cin (bf16 stages the output tile whole, in halves at 128 x 112
    and in quarters at 128 x 128; f32 streams 4 k8 steps a stage up to 112
    channels, 2 at 128, and takes 2 x 64 tiles); the trajectory form (residual, res_scale
    0.1), the RCAB form, an lrelu chain and the residual with sums, each
    against the plain version.  The sums are
    the f32 sums of the kernel's own output: held to 1e-5 of the sum of
    their terms' magnitudes against that output's sums (in bf16 the outputs
    themselves may differ from the plain version's by an ulp, which the sums
    add up).  Two runs are bit-equal, outputs and sums."""
    rng = np.random.default_rng(Cin + H)
    x = _randn(rng, (N, H, W, Cin), cuda, dtype)
    ops = _chain_operands(rng, Cin, Cm, cuda, dtype)
    before = conv_chain.fused_conv_chain.launches
    for kw in (dict(res_scale=0.1), dict(act1="lrelu")):
        _close(conv_chain.fused_conv_chain(x, *ops, **kw),
               conv_chain.conv_chain_plain(x, *ops, **kw), dtype)
    got, psum = conv_chain.fused_conv_chain(x, *ops, emit_psum=True)
    want, wpsum = conv_chain.conv_chain_plain(x, *ops, emit_psum=True)
    _close(got, want, dtype)
    terms = got.float().abs().sum(dim=(1, 2))
    assert bool(((psum - got.float().sum(dim=(1, 2))).abs() <= 1e-5 * terms).all())
    if dtype == torch.float32:
        assert bool(((psum - wpsum).abs() <= 1e-5 * terms).all())
    again, psum_again = conv_chain.fused_conv_chain(x, *ops, emit_psum=True)
    torch.cuda.synchronize()
    assert torch.equal(again, got) and torch.equal(psum_again, psum)
    got, psum = conv_chain.fused_conv_chain(x, *ops, res_scale=0.1, emit_psum=True)
    _close(got, conv_chain.conv_chain_plain(x, *ops, res_scale=0.1), dtype)
    terms = got.float().abs().sum(dim=(1, 2))
    assert bool(((psum - got.float().sum(dim=(1, 2))).abs() <= 1e-5 * terms).all())
    assert conv_chain.fused_conv_chain.launches == before + 5
    x.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        conv_chain.fused_conv_chain(x, *ops)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,Cin,Cm", [(2, 64, 64, 32, 32), (1, 9, 100, 32, 48),
                                          (2, 15, 33, 24, 40), (3, 6, 65, 12, 24)])
def test_conv_chain_f32_shapes(cuda, N, H, W, Cin, Cm):
    """The f32 (3xTF32) chain at the tiny preset's 32 channels (1x2x64x64
    as the kernel-form slice runs it), with an intermediate wider than the
    input (48, 40: conv2's K stops short of the 16-padded scratch) and 12
    input channels (rows of 48 bytes: TMA; 2 x 64 tiles cut at 9, 15 and 65
    columns), each form against the plain version, the sums against the
    output's own; two runs bit-equal."""
    rng = np.random.default_rng(Cin + Cm + H)
    x = _randn(rng, (N, H, W, Cin), cuda, torch.float32)
    ops = _chain_operands(rng, Cin, Cm, cuda, torch.float32)
    for kw in (dict(res_scale=0.1), dict(act1="lrelu"), dict(act1=None)):
        _close(conv_chain.fused_conv_chain(x, *ops, **kw),
               conv_chain.conv_chain_plain(x, *ops, **kw), torch.float32)
    got, psum = conv_chain.fused_conv_chain(x, *ops, res_scale=0.1, emit_psum=True)
    _close(got, conv_chain.conv_chain_plain(x, *ops, res_scale=0.1), torch.float32)
    terms = got.abs().sum(dim=(1, 2))
    assert bool(((psum - got.sum(dim=(1, 2))).abs() <= 1e-5 * terms).all())
    again, psum_again = conv_chain.fused_conv_chain(x, *ops, res_scale=0.1, emit_psum=True)
    torch.cuda.synchronize()
    assert torch.equal(again, got) and torch.equal(psum_again, psum)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,C,rms", [(7, 112, False), (1001, 56, False), (37, 896, False),
                                        (4099, 448, False), (13, 224, False), (9, 112, True),
                                        (5, 20, False)])
def test_fused_norm_kernel(cuda, dtype, rows, C, rms):
    """Odd row counts, the five path widths and a width off the vector
    (20: scalar loads); bias and RMS forms; the autograd path's gradients
    against autograd of the plain version."""
    rng = np.random.default_rng(rows + C)
    x = _randn(rng, (rows, C), cuda, dtype) + 0.5
    g = _randn(rng, (C,), cuda, dtype, 0.2) + 1.0
    b = None if rms else _randn(rng, (C,), cuda, dtype, 0.1)
    eps = 1e-6 if rms else 1e-5
    before = fused_norm.fused_norm.launches
    _close(fused_norm.fused_norm(x, g, b, eps=eps, rms=rms),
           fused_norm.fused_norm_plain(x, g, b, eps=eps, rms=rms), dtype)
    assert fused_norm.fused_norm.launches == before + 1
    leaves = [t.clone().requires_grad_() for t in (x, g) + (() if b is None else (b,))]
    dy = _randn(rng, (rows, C), cuda, dtype)
    bias = leaves[2] if b is not None else None
    got = torch.autograd.grad(fused_norm.fused_norm(leaves[0], leaves[1], bias, eps=eps,
                                                    rms=rms), leaves, dy)
    want = torch.autograd.grad(fused_norm.fused_norm_plain(leaves[0], leaves[1], bias,
                                                           eps=eps, rms=rms), leaves, dy)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((1, 184, 320, 224), torch.bfloat16),
                                         ((1, 37, 53, 224), torch.bfloat16),
                                         ((2, 7, 5, 3), torch.float32),
                                         ((3, 5, 7), torch.bfloat16)])
def test_layout_pin_kernel(cuda, shape, dtype):
    """Bit-equal, contiguous, not an alias; 1x37x53x224 bf16 leaves a
    ragged tail after the grid-stride rounds; an odd byte count takes the
    byte copy."""
    x = _randn(np.random.default_rng(0), shape, cuda, dtype)
    before = conv_chain.layout_pin.launches
    y = conv_chain.layout_pin(x)
    torch.cuda.synchronize()
    assert torch.equal(y, x) and y.is_contiguous() and y.data_ptr() != x.data_ptr()
    assert conv_chain.layout_pin.launches == before + 1


def _opcheck_cases(dev):
    """Small CUDA cases of every ``vmg::`` operator (float32; the combine's
    projection as its kernel's B image)."""
    rng = np.random.default_rng(21)

    def t(*shape, scale=1.0):
        return _randn(rng, shape, dev, torch.float32, scale)

    x = t(1, 4, 8, 16)
    w, b1p = group_conv.pack_ffn_weights(t(32, 4, 3, 3, scale=0.2), t(32), t(16, 32, scale=0.1),
                                         4)
    c, kh, kw = t(1, 4, 8, 16, scale=0.1), t(16, 16, scale=0.2), t(16, 16, scale=0.2)
    h, wb = t(1, 4, 8, 16), t(1, 4, 8, 16)
    a = torch.softmax(t(1, 3, 16), dim=1)
    pk = morphfc_fused.pack_combine_weight(t(16, 16, scale=0.1))
    taps = (*conv_chain.pack_conv_taps(t(16, 16, 3, 3, scale=0.1), t(16)),
            *conv_chain.pack_conv_taps(t(16, 16, 3, 3, scale=0.1), t(16)))
    K, heads = 2, 2
    q, kv = t(1, 4, 6, 16, scale=0.3), t(1, 4, 6, K * 32)
    pe, g = torch.rand(K, 4, 4, heads, device=dev) + 0.5, t(1, 4, 6, 16)
    out, den = ltam_attention.ltam_fwd(q, kv, pe, K=K, heads=heads, with_den=True)
    return {
        "group_ffn": [(x, w, b1p, t(16), 4, act) for act in ("erf", "tanh")],
        "morphfc_axes": [(x, c, kh, b, kw, b if b is None else t(16), 4, 4, form, nl)
                         for form in ("big", "token") for b, nl in ((t(16), True), (None, False))],
        "morphfc_reduce": [(h, wb, c)],
        "morphfc_combine": [(x, h, wb, c, a, pk, t(16), "tanh", res, 0.5)
                            for res in (None, t(1, 4, 8, 16))],
        "fused_norm": [(t(2, 3, 16).requires_grad_(), t(16).requires_grad_(), bias, 1e-5, rms)
                       for bias, rms in ((t(16).requires_grad_(), False), (None, True))],
        "conv_chain": [(x, *taps, "relu", res, psum) for res, psum in ((None, False), (0.1, True))],
        "layout_pin": [(x,)],
        "ltam_fwd": [(q, kv, pe, K, heads, False),
                     (q.clone().requires_grad_(), kv.clone().requires_grad_(), pe, K, heads,
                      True)],
        "ltam_bwd": [(q, kv, pe, den, out, g, K, heads)]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["group_ffn", "morphfc_axes", "morphfc_reduce",
                                  "morphfc_combine", "fused_norm", "conv_chain", "layout_pin",
                                  "ltam_fwd", "ltam_bwd"])
def test_operators_opcheck(cuda, name):
    """``torch.library.opcheck`` of each ``vmg::`` operator on CUDA tensors:
    its schema, fake implementation, autograd registration and the
    operator through AOT autograd, the kernels launching."""
    for args in _opcheck_cases(cuda)[name]:
        torch.library.opcheck(getattr(torch.ops.vmg, name).default, args)
