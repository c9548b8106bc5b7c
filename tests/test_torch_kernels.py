"""The port's kernel modules against the JAX Pallas kernels.

On CPU: each plain PyTorch version against the JAX kernel run in Pallas
interpret mode, fp32, on the same seeded numpy inputs, with the JAX tests'
own tolerances for the same op (2e-5 for the FFN and LTAM attention,
1e-5 for the reduction and the axis branches in both forms -- 1e-3
absolute for their sums -- and 3e-5 / 2e-4 for the combine).  The wrappers take
the plain version for CPU tensors and refuse other non-CUDA tensors.
The CUDA kernels themselves are checked in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vmg_tpu.ops.group_conv import fused_group_ffn as j_group_ffn
from vmg_tpu.ops.ltam_attention import ltam_attention_2x2 as j_ltam
from vmg_tpu.ops.morphfc_fused import (
    fused_morphfc_axes as j_axes,
    fused_morphfc_combine as j_combine,
    fused_morphfc_reduce as j_reduce,
)
from vmg_tpu_torch.ops import decay, group_conv, ltam_attention, morphfc_fused


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ffn_case(rng, N=2, H=10, W=14, C=16, F=96, g=4):
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    k = (rng.standard_normal((3, 3, C // g, F)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((F,)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((F, C)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal((C,)) * 0.1).astype(np.float32)
    return x, k, b, w2, b2, g


def _ffn_torch_args(x, k, b, w2, b2, g):
    """JAX layouts -> the port's (torch) parameter layouts -> the kernel's
    packed operands."""
    packed = group_conv.pack_ffn_weights(_t(k.transpose(3, 2, 0, 1)), _t(b), _t(w2.T), g)
    return (_t(x), *packed, _t(b2))


@pytest.mark.parametrize("act", ["erf", "tanh"])
def test_group_ffn_plain_matches_pallas(rng, act):
    x, k, b, w2, b2, g = _ffn_case(rng)
    want = np.asarray(j_group_ffn(*map(jnp.asarray, (x, k, b, w2, b2)), groups=g,
                                  act=act, impl="pallas", interpret=True, rows=4))
    got = group_conv.fused_group_ffn(*_ffn_torch_args(x, k, b, w2, b2, g), groups=g, act=act)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("act", ["erf", "tanh"])
def test_group_ffn_groups1_matches_xla(rng, act):
    """groups = 1, hidden 2C (the few-levels preset's FFN, which the port runs
    in its kernel and ``vmg_tpu`` in its XLA form) against ``vmg_tpu``'s
    XLA path."""
    x, k, b, w2, b2, g = _ffn_case(rng, C=32, F=64, g=1)
    want = np.asarray(j_group_ffn(*map(jnp.asarray, (x, k, b, w2, b2)), groups=g,
                                  act=act, impl="xla"))
    got = group_conv.fused_group_ffn(*_ffn_torch_args(x, k, b, w2, b2, g), groups=g, act=act)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("H", [16, 18])
def test_morphfc_reduce_plain_matches_pallas(rng, H):
    h, w, c = (rng.standard_normal((2, H, 12, 16)).astype(np.float32) * 0.1
               for _ in range(3))
    want = np.asarray(j_reduce(*map(jnp.asarray, (h, w, c)), interpret=True))
    got = morphfc_fused.fused_morphfc_reduce(_t(h), _t(w), _t(c))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("H,chunk_h,chunk_w", [(16, 4, 4), (18, 4, 4), (14, 2, 8)])
def test_morphfc_axes_plain_matches_pallas(rng, H, chunk_h, chunk_w):
    """H = 18 leaves a partial last H-chunk (masked rows); (2, 8) has
    unequal chunks."""
    N, W, C = 2, 16, 16
    x, c = (rng.standard_normal((N, H, W, C)).astype(np.float32) for _ in range(2))
    kh, kw = ((rng.standard_normal((C, C)) * 0.05).astype(np.float32) for _ in range(2))
    bh, bw = ((rng.standard_normal((C,)) * 0.1).astype(np.float32) for _ in range(2))
    want = j_axes(*map(jnp.asarray, (x, c, kh, bh, kw, bw)), chunk_h=chunk_h,
                  chunk_w=chunk_w, decay=True, non_linear=True, interpret=True)
    # the port takes the decay folded in, as MorphFCDecay packs it
    gh, gw = (decay.morphfc_decay_np(ch, C // ch) for ch in (chunk_h, chunk_w))
    got = morphfc_fused.fused_morphfc_axes(_t(x), _t(c), _t(kh * gh), _t(bh), _t(kw * gw),
                                           _t(bw), chunk_h=chunk_h, chunk_w=chunk_w)
    for g, wnt in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("H,W,C,chunk,form", [(18, 32, 96, 16, None), (11, 16, 160, 8, None),
                                               (14, 16, 16, 4, "token")])
def test_morphfc_axes_token_plain_matches_pallas(rng, H, W, C, chunk, form):
    """The token form (JAX's ``_axes_kernel_token``): chunk * C = 1536 and
    1280 select it, with a partial last H-chunk each; at 64 it is forced,
    as ``tests/test_morphfc_fused.py`` forces it."""
    N = 2
    x, c = (rng.standard_normal((N, H, W, C)).astype(np.float32) for _ in range(2))
    kh, kw = ((rng.standard_normal((C, C)) * 0.05).astype(np.float32) for _ in range(2))
    bh, bw = ((rng.standard_normal((C,)) * 0.1).astype(np.float32) for _ in range(2))
    want = j_axes(*map(jnp.asarray, (x, c, kh, bh, kw, bw)), chunk_h=chunk, chunk_w=chunk,
                  decay=True, non_linear=True, interpret=True, form=form)
    g = decay.morphfc_decay_np(chunk, C // chunk)
    got = morphfc_fused.fused_morphfc_axes(_t(x), _t(c), _t(kh * g), _t(bh), _t(kw * g),
                                           _t(bw), chunk_h=chunk, chunk_w=chunk, form=form)
    assert (form or morphfc_fused.axes_form(C, chunk, chunk)) == "token"
    for gt, wnt in zip(got[:2], want[:2]):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wnt), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("C,chunk", [(112, 8), (224, 16), (448, 8), (96, 16)])
def test_axes_form_matches_jax_selection(C, chunk):
    """``axes_form`` is "big" exactly where the JAX module selects 'full'
    (and with it the big-form axes kernel)."""
    from vmg_tpu.models.blocks import MorphFCDecay as JMorphFCDecay

    x = jnp.zeros((1, 1, 2 * chunk, 2 * chunk, C), jnp.float32)
    mode = JMorphFCDecay(dim=C, chunk_h=chunk, chunk_w=chunk)._pallas_mode(x, "interpret")
    assert (morphfc_fused.axes_form(C, chunk, chunk) == "big") == (mode == "full"), mode


def test_axes_form_argument():
    """An unknown form raises; the forms' launch counters are separate and
    a non-CUDA tensor reaches neither kernel; the big form's shared-memory
    size (the kernel's own arithmetic) fits at the stage-0 shape and not at
    the stage-1 and stage-3 shapes, where the token form is the only one."""
    m = torch.empty((1, 16, 16, 16), device="meta")
    k, b = torch.empty(16, 16, device="meta"), torch.empty(16, device="meta")
    ax = morphfc_fused.fused_morphfc_axes
    with pytest.raises(ValueError, match="form"):
        ax(m, m, k, b, k, b, chunk_h=4, chunk_w=4, form="wide")
    before = (ax.launches, ax.token_launches)
    with pytest.raises(ValueError, match="CUDA"):
        ax(m, m, k, b, k, b, chunk_h=4, chunk_w=4, form="token")
    assert (ax.launches, ax.token_launches) == before
    fits = morphfc_fused.big_form_smem
    assert fits(64, 112, torch.bfloat16) <= morphfc_fused.MAX_SMEM
    assert fits(256, 224, torch.bfloat16) > morphfc_fused.MAX_SMEM
    assert fits(64, 448, torch.bfloat16) > morphfc_fused.MAX_SMEM


def _combine_case(rng, N=2, H=18, W=12, C=16):
    x, h, w, c, res = (rng.standard_normal((N, H, W, C)).astype(np.float32)
                       for _ in range(5))
    a = rng.random((N, 3, C)).astype(np.float32)
    a /= a.sum(axis=1, keepdims=True)
    pk = (rng.standard_normal((C, C)) * 0.1).astype(np.float32)
    pb = (rng.standard_normal((C,)) * 0.1).astype(np.float32)
    return x, h, w, c, res, a, pk, pb


@pytest.mark.parametrize("act", ["tanh", "sigmoid", "relu"])
@pytest.mark.parametrize("with_res", [False, True])
def test_morphfc_combine_plain_matches_pallas(rng, act, with_res):
    x, h, w, c, res, a, pk, pb = _combine_case(rng)
    r = res if with_res else None
    want = np.asarray(j_combine(*map(jnp.asarray, (x, h, w, c, a, pk, pb)), act=act,
                                residual=None if r is None else jnp.asarray(r),
                                res_scale=0.7, interpret=True))
    got = morphfc_fused.fused_morphfc_combine(
        _t(x), _t(h), _t(w), _t(c), _t(a), _t(pk), _t(pb), act=act,
        residual=None if r is None else _t(r), res_scale=0.7)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=2e-4)


def _ltam_case(rng, n=2, K=3, h=8, w=12, C=16, heads=4):
    d = C // heads
    q = rng.standard_normal((n, h, w, C)).astype(np.float32)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True) * d ** -0.5
    vals = rng.standard_normal((n, h, w, K, C)).astype(np.float32)
    keys = rng.standard_normal((n, h, w, K, C)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=-1, keepdims=True)
    pe = np.exp(rng.standard_normal((K, 4, 4, heads)) * 0.5).astype(np.float32)
    return q, vals, keys, pe, K, heads


def _lanes(C):
    """C rounded up to the TPU kernel's 128-lane multiple."""
    return -(-C // 128) * 128


# (C, heads): head widths 4, 36 (the few-levels preset's) and 144 (one head)
LTAM_WIDTHS = [(16, 4), (72, 2), (144, 1)]


@pytest.mark.parametrize("C,heads", LTAM_WIDTHS)
def test_ltam_plain_matches_pallas(rng, C, heads):
    q, vals, keys, pe, K, heads = _ltam_case(rng, C=C, heads=heads)
    n, h, w, C = q.shape
    Cp = _lanes(C)

    def pad(v):
        return np.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, Cp - C)])

    kv_tpu = np.stack([pad(vals), pad(keys)], axis=-2).reshape(n, h, w, K * 2 * Cp)
    want = np.asarray(j_ltam(jnp.asarray(pad(q)), jnp.asarray(kv_tpu),
                             jnp.asarray(pe), K=K, heads=heads, C=C,
                             interpret=True))[..., :C]
    kv = np.stack([vals, keys], axis=-2).reshape(n, h, w, K * 2 * C)
    got = ltam_attention.ltam_attention_2x2(_t(q), _t(kv), _t(pe), K=K, heads=heads)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Only a CPU tensor selects the plain version; any other device goes to
    the kernel path, which validates and raises instead of falling back."""
    m = torch.empty((1, 4, 4, 16), device="meta")
    wrappers = (group_conv.fused_group_ffn, morphfc_fused.fused_morphfc_axes,
                morphfc_fused.fused_morphfc_reduce, morphfc_fused.fused_morphfc_combine,
                ltam_attention.ltam_attention_2x2)
    before = [f.launches for f in wrappers]
    with pytest.raises(ValueError, match="CUDA"):
        group_conv.fused_group_ffn(m, torch.empty(4 * 24 * (36 + 16), device="meta"),
                                   torch.empty(96, device="meta"),
                                   torch.empty(16, device="meta"), groups=4)
    with pytest.raises(ValueError, match="CUDA"):
        k, b = torch.empty(16, 16, device="meta"), torch.empty(16, device="meta")
        morphfc_fused.fused_morphfc_axes(m, m, k, b, k, b, chunk_h=4, chunk_w=4)
    with pytest.raises(ValueError, match="CUDA"):
        morphfc_fused.fused_morphfc_reduce(m, m, m)
    with pytest.raises(ValueError, match="CUDA"):
        morphfc_fused.fused_morphfc_combine(m, m, m, m, torch.empty(1, 3, 16, device="meta"),
                                            torch.empty(16, 16, device="meta"),
                                            torch.empty(16, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ltam_attention.ltam_attention_2x2(m, torch.empty(1, 4, 4, 32, device="meta"),
                                          torch.empty(1, 4, 4, 4, device="meta"),
                                          K=1, heads=4)
    bwd_before = ltam_attention.ltam_attention_2x2.bwd_launches
    with pytest.raises(ValueError, match="CUDA"):
        ltam_attention.ltam_attention_2x2_bwd(
            m, torch.empty(1, 4, 4, 32, device="meta"), torch.empty(1, 4, 4, 4, device="meta"),
            torch.empty(1, 4, 4, 4, device="meta"), m, m, K=1, heads=4)
    assert [f.launches for f in wrappers] == before
    assert ltam_attention.ltam_attention_2x2.bwd_launches == bwd_before


@pytest.mark.parametrize("C,heads", LTAM_WIDTHS)
def test_ltam_plain_grads_match_pallas_vjp(C, heads):
    """Gradients of the port's plain LTAM (autograd through normalize, kv
    packing and the exp(pe) factors) against ``jax.grad`` of the Pallas
    kernel's custom VJP in interpret mode: the inputs and tolerance of
    ``tests/test_fused_layouts.py::test_pallas_ltam_attention_grad_matches_autodiff``,
    at each head width."""
    import jax
    from vmg_tpu.models.trajectory import _normalize as j_normalize

    rng = np.random.default_rng(33)
    n, K, h, w = 1, 2, 6, 8
    Cp = _lanes(C)
    scale = (C // heads) ** -0.5
    curr = rng.standard_normal((n, h, w, C)).astype(np.float32)
    keys = rng.standard_normal((n, K, h, w, C)).astype(np.float32)
    vals = rng.standard_normal((n, K, h, w, C)).astype(np.float32)
    rpe = (rng.standard_normal((heads, 4, 4)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((n, h, w, C)).astype(np.float32)
    slot_decay = decay.ltam_decay_np(heads, K)

    def f_pallas(curr, keys, vals, rpe):
        def pad(x):
            return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, Cp - C)])

        qk = pad(j_normalize(curr) * scale)
        kv = jnp.stack([pad(vals), pad(j_normalize(keys))], axis=-2)
        kv = kv.transpose(0, 2, 3, 1, 4, 5).reshape(n, h, w, K * 2 * Cp)
        pef = jnp.exp(jnp.einsum("ek,ept->ktpe", slot_decay, rpe))
        out = j_ltam(qk, kv, pef, K=K, heads=heads, C=C, interpret=True)[..., :C]
        return jnp.sum(out * cot)

    want = jax.grad(f_pallas, argnums=(0, 1, 2, 3))(curr, keys, vals, rpe)

    from vmg_tpu_torch.models.trajectory import _normalize as normalize

    leaves = [_t(a).requires_grad_() for a in (curr, keys, vals, rpe)]
    tc, tk, tv, tr = leaves
    q = normalize(tc) * scale
    kv = torch.stack([tv, normalize(tk)], dim=-2).permute(0, 2, 3, 1, 4, 5)
    pef = torch.exp(torch.einsum("ek,ept->ktpe", _t(slot_decay), tr))
    out = ltam_attention.ltam_attention_2x2(q, kv.reshape(n, h, w, K * 2 * C), pef,
                                            K=K, heads=heads)
    got = torch.autograd.grad((out * _t(cot)).sum(), leaves)
    for g, wnt, name in zip(got, want, ("curr", "keys", "vals", "rpe")):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=3e-5, rtol=3e-5,
                                   err_msg=name)


def test_ltam_bwd_wrapper_takes_plain_on_cpu(rng):
    """On CPU tensors the backward wrapper is the plain backward (autograd
    of the plain forward), whatever den and out it is handed."""
    q, vals, keys, pe, K, heads = _ltam_case(rng, n=1, K=2, h=4, w=6)
    n, h, w, C = q.shape
    kv = _t(np.stack([vals, keys], axis=-2).reshape(n, h, w, K * 2 * C))
    g = _t(rng.standard_normal(q.shape).astype(np.float32))
    before = ltam_attention.ltam_attention_2x2.bwd_launches
    got = ltam_attention.ltam_attention_2x2_bwd(_t(q), kv, _t(pe), None, None, g,
                                                K=K, heads=heads)
    want = ltam_attention.ltam_attention_bwd_plain(_t(q), kv, _t(pe), g, K=K, heads=heads)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ltam_attention.ltam_attention_2x2.bwd_launches == before
