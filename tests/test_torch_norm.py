"""The port's fused norm and norm modules against ``vmg_tpu``.

* :func:`fused_norm` (its plain version on CPU tensors) against the JAX
  ``fused_norm`` run in Pallas interpret mode, LayerNorm and RMSNorm at the
  five widths of the serving path (56, 112, 224, 448, 896): bf16 within an
  output ulp (rtol 8e-3, atol 1e-2), f32 within 1e-5; its gradient against
  ``jax.grad`` of the JAX ``fused_norm`` (custom VJP) in f32, 2e-5.
* The modules in bf16: ``impl="kernel"`` against the JAX modules under
  ``set_norm_impl('interpret')``, and the default forms against the JAX
  modules' default bf16 paths, 2e-2 (the JAX package's own tolerance for
  the two bf16 formulations, ``tests/test_fused_layouts.py``).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vmg_tpu.models import norms as jnorms
from vmg_tpu.ops.fused_norm import fused_norm as j_fused_norm
from vmg_tpu_torch.models.norms import RMSNorm, TorchLayerNorm
from vmg_tpu_torch.ops.fused_norm import fused_norm

WIDTHS = [56, 112, 224, 448, 896]
TOL = {"f32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=1e-2, rtol=8e-3)}


def _inputs(C, seed=0, shape=(2, 4, 8)):
    """x with a non-zero mean (the one-pass variance's cancellation), scale
    and bias around 1 and 0, all representable in bf16."""
    rng = np.random.default_rng(seed + C)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    x = bf(rng.standard_normal((*shape, C)) * 1.5 + 0.7)
    g = bf(1.0 + 0.2 * rng.standard_normal(C))
    b = bf(0.1 * rng.standard_normal(C))
    return x.astype(np.float32), g.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("C", WIDTHS)
def test_fused_norm_plain_matches_pallas(C, rms, dtype):
    x, g, b = _inputs(C)
    bias = None if rms else b
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16,
                                                                    torch.bfloat16)
    eps = 1e-6 if rms else 1e-5
    want = j_fused_norm(jnp.asarray(x, jdt), jnp.asarray(g),
                        None if bias is None else jnp.asarray(bias), eps=eps, rms=rms,
                        interpret=True)
    got = fused_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(g),
                     None if bias is None else torch.from_numpy(bias), eps=eps, rms=rms)
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("C", [56, 224])
def test_fused_norm_grad_matches_jax(C, rms):
    x, g, b = _inputs(C, seed=1)
    cot = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    eps = 1e-6 if rms else 1e-5
    args = [x, g] if rms else [x, g, b]

    def f(*a):
        bias = None if rms else a[2]
        y = j_fused_norm(a[0], a[1], bias, eps=eps, rms=rms, interpret=True)
        return jnp.sum(y * cot)

    want = jax.grad(f, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y = fused_norm(leaves[0], leaves[1], None if rms else leaves[2], eps=eps, rms=rms)
    (y * torch.from_numpy(cot)).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5)


def _jax_module(mod, params, x, impl):
    prev = jnorms.set_norm_impl(impl)
    try:
        return np.asarray(mod.apply(params, jnp.asarray(x, jnp.bfloat16)), np.float32)
    finally:
        jnorms.set_norm_impl(prev)


@pytest.mark.parametrize("impl", ["module", "kernel"])
@pytest.mark.parametrize("C", [112, 224])
def test_norm_modules_bf16_match_jax(C, impl):
    """TorchLayerNorm and RMSNorm in bf16 (bf16 weights, as the serving and
    compute models hold them): ``impl="kernel"`` against the JAX modules'
    fused kernel (interpret mode), ``"module"`` against their default bf16
    paths (MXU-moment formulation with bf16 squares)."""
    x, g, b = _inputs(C, seed=3)
    xt = torch.from_numpy(x).bfloat16()
    jimpl = "interpret" if impl == "kernel" else None
    ln = TorchLayerNorm(C, impl=impl)
    rms = RMSNorm(C, impl=impl)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(g))
        ln.bias.copy_(torch.from_numpy(b))
        rms.weight.copy_(torch.from_numpy(g))
    ln.bfloat16()
    rms.bfloat16()
    jln, jrms = jnorms.TorchLayerNorm(C), jnorms.RMSNorm(C)
    pln = {"params": {"scale": jnp.asarray(g), "bias": jnp.asarray(b)}}
    prms = {"params": {"scale": jnp.asarray(g)}}
    for mod, jmod, p in ((ln, jln, pln), (rms, jrms, prms)):
        with torch.no_grad():
            got = mod(xt)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), _jax_module(jmod, p, x, jimpl),
                                   atol=2e-2, rtol=2e-2, err_msg=type(mod).__name__)


def test_norm_modules_keep_f32_exact_and_state_keys():
    """float32 inputs take the exact two-pass path whatever ``impl`` says
    (the JAX modules' f32 branch); TorchLayerNorm keeps nn.LayerNorm's
    weight/bias keys and type, RMSNorm has one weight."""
    x, g, b = _inputs(112, seed=4)
    xt = torch.from_numpy(x)
    a, k = TorchLayerNorm(112), TorchLayerNorm(112, impl="kernel")
    assert isinstance(k, torch.nn.LayerNorm)
    assert sorted(k.state_dict()) == ["bias", "weight"]
    assert sorted(RMSNorm(112).state_dict()) == ["weight"]
    with torch.no_grad():
        torch.testing.assert_close(a(xt), k(xt), rtol=0, atol=0)
    jm = jnorms.RMSNorm(112)
    want = jm.apply({"params": {"scale": jnp.asarray(g)}}, jnp.asarray(x))
    m = RMSNorm(112, impl="kernel")
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(g))
        np.testing.assert_allclose(m(xt).numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="impl"):
        TorchLayerNorm(8, impl="pallas")
