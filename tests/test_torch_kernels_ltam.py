"""The gradients of the port's plain LTAM against JAX's custom VJP of the
Pallas kernel (split from ``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vmg_tpu.ops.ltam_attention import ltam_attention_2x2 as j_ltam
from vmg_tpu_torch.ops import decay, ltam_attention

from test_torch_kernels import LTAM_WIDTHS, _few_torch_threads, _lanes, _t  # noqa: F401


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
