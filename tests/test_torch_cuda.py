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
@pytest.mark.parametrize("C,groups", [(16, 4), (32, 1), (112, 4), (224, 4), (448, 4)])
def test_group_ffn_kernel(cuda, dtype, C, groups):
    rng = np.random.default_rng(C)
    Fh = 6 * C
    x = _randn(rng, (2, 11, 13, C), cuda, dtype)  # odd H, W: ragged tiles
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [112, 448])
def test_morphfc_kernels(cuda, dtype, C):
    rng = np.random.default_rng(C)
    shape = (3, 18, 12, C)
    x, h, w, c, res = (_randn(rng, shape, cuda, dtype) for _ in range(5))
    a = torch.softmax(_randn(rng, (3, 3, C), cuda, torch.float32), dim=1).to(dtype)
    pk, pb = _randn(rng, (C, C), cuda, dtype, 0.02), _randn(rng, (C,), cuda, dtype, 0.1)
    torch.testing.assert_close(morphfc_fused.fused_morphfc_reduce(h, w, c),
                               morphfc_fused.morphfc_reduce_plain(h, w, c),
                               atol=1e-3, rtol=1e-5)
    pb = pb.float()
    for r in (None, res):
        _close(morphfc_fused.fused_morphfc_combine(x, h, w, c, a, pk, pb, residual=r,
                                                   res_scale=0.5),
               morphfc_fused.morphfc_combine_plain(x, h, w, c, a, pk, pb, residual=r,
                                                   res_scale=0.5),
               dtype)
    with pytest.raises(ValueError, match="tanh"):
        morphfc_fused.fused_morphfc_combine(x, h, w, c, a, pk, pb, act="sigmoid")


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
@pytest.mark.parametrize("K,C,heads", [(1, 16, 4), (5, 112, 4)])
def test_ltam_kernel(cuda, dtype, K, C, heads):
    rng = np.random.default_rng(K)
    n, h, w = 2, 8, 12
    q = torch.nn.functional.normalize(_randn(rng, (n, h, w, C), cuda, torch.float32), dim=-1)
    q = q * (C // heads) ** -0.5
    kv = _randn(rng, (n, h, w, K * 2 * C), cuda, dtype)
    pe = torch.exp(_randn(rng, (K, 4, 4, heads), cuda, torch.float32, 0.5))
    _close(ltam_attention.ltam_attention_2x2(q, kv, pe, K=K, heads=heads),
           ltam_attention.ltam_attention_plain(q, kv, pe, K=K, heads=heads),
           torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,C,heads", [(1, 16, 4), (5, 112, 4)])
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
    out, den = ltam_attention._forward_kernel(q, kv, pe, K, heads, with_den=True)
    check(ltam_attention.ltam_attention_2x2_bwd(q, kv, pe, den, out, g, K=K, heads=heads))
    leaves = [t.clone().requires_grad_() for t in (q, kv, pe)]
    y = ltam_attention.ltam_attention_2x2(*leaves, K=K, heads=heads)
    check(torch.autograd.grad(y, leaves, g))
    assert (ref.launches - f0, ref.bwd_launches - b0) == (2, 2)


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
    and in quarters at 128 x 128); the trajectory form (residual, res_scale
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
