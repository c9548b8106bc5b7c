"""The TAB and the MorphFC mixer's RCAB kernel form against the JAX
modules (split from ``tests/test_torch_blocks.py``, whose helpers it uses).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vmg_tpu.models import blocks as jblocks
from vmg_tpu_torch.models import blocks

from test_torch_blocks import TOL, _few_torch_threads, _load, _run, _x  # noqa: F401


def test_tab(rng):
    x = _x(rng, (1, 2, 12, 14, 16))
    jm = jblocks.TAB(16, 4, 4, mlp_ratio=6.0, n_groups=4, channel_mixer="rcab")
    prev = (jblocks.set_morph_impl("interpret"), jblocks.set_ffn_impl("interpret"))
    try:
        p = jm.init(jax.random.key(2), jnp.asarray(x), True)
        want = np.asarray(jm.apply(p, jnp.asarray(x), True))
    finally:
        jblocks.set_morph_impl(prev[0])
        jblocks.set_ffn_impl(prev[1])
    m = _load(blocks.TAB(16, 4, 4, 6.0, 4), p, "encoder_layers0/mlp_blocks0",
              "encoder_layers.0.mlp_blocks.0.")
    np.testing.assert_allclose(_run(m, x), want, **TOL)


@pytest.mark.parametrize("H,W,C,chunk", [(18, 16, 16, 4), (16, 24, 32, 8)])
def test_morphfc_decay_rcab_kernel_form(rng, H, W, C, chunk):
    """The 'full' mixer with ``rcab_impl="kernel"`` against the JAX mixer,
    whose 'full' form (interpret) always runs the RCAB chain kernel."""
    x, res = _x(rng, (1, 2, H, W, C)), _x(rng, (1, 2, H, W, C))
    jm = jblocks.MorphFCDecay(C, chunk, chunk, channel_mixer="rcab", impl="interpret")
    p = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x))
    want = np.asarray(jm.apply(p, jnp.asarray(x), residual=jnp.asarray(res), res_scale=0.5))
    m = _load(blocks.MorphFCDecay(C, chunk, chunk, rcab_impl="kernel"), p,
              "encoder_layers0/mlp_blocks0/spatial_mixing",
              "encoder_layers.0.mlp_blocks.0.spatial_mixing.")
    assert m.full_form(W)
    np.testing.assert_allclose(_run(m, x, residual=torch.from_numpy(res), res_scale=0.5),
                               want, **TOL)
