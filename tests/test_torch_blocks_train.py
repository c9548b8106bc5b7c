"""The TAB in training mode against the JAX TAB's module path, output and
gradients (split from ``tests/test_torch_blocks.py``, whose helpers it uses).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vmg_tpu.models import blocks as jblocks
from vmg_tpu_torch.models import blocks

from test_torch_blocks import TOL, _few_torch_threads, _load, _port_params, _x  # noqa: F401


@pytest.mark.parametrize("C,groups", [(16, 4), (18, 1)])
def test_tab_training_form_matches_jax_module_path(rng, C, groups):
    """TAB in training mode (drop_path 0) against the JAX TAB at
    ``deterministic=False`` -- the module paths training pins (MorphFCDecay
    fused axis FCs, grouped-conv FFN): output and every gradient, f32.
    C = 18 pads the axis-FC channels to 20."""
    x = _x(rng, (1, 2, 12, 14, C))
    cot = _x(rng, x.shape)
    jm = jblocks.TAB(C, 4, 4, mlp_ratio=6.0, n_groups=groups, channel_mixer="rcab")
    p = jax.jit(jm.init, static_argnums=2)(jax.random.key(2), jnp.asarray(x), True)

    def f(params, xx):
        return jnp.sum(jm.apply(params, xx, False) * cot)

    want = np.asarray(jax.jit(lambda params, xx: jm.apply(params, xx, False))(p, jnp.asarray(x)))
    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(p, jnp.asarray(x))
    m = _load(blocks.TAB(C, 4, 4, 6.0, groups), p, "encoder_layers0/mlp_blocks0",
              "encoder_layers.0.mlp_blocks.0.").train()
    xt = torch.from_numpy(x).requires_grad_()
    out = m(xt)
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    wgrads = _port_params(gp, "encoder_layers0/mlp_blocks0",
                                  "encoder_layers.0.mlp_blocks.0.")
    for name, prm in m.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), wgrads[name].numpy(), **TOL,
                                   err_msg=name)
