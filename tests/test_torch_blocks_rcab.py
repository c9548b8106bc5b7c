"""RCAB's conv-chain form against the JAX RCAB (split from
``tests/test_torch_blocks.py``, whose helpers it uses).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vmg_tpu.models import blocks as jblocks
from vmg_tpu_torch.models import blocks

from test_torch_blocks import KTOL, _few_torch_threads, _load, _run, _x  # noqa: F401


@pytest.mark.parametrize("H,W,C", [(12, 16, 24), (13, 10, 16)])
def test_rcab_kernel_form_matches_jax(rng, H, W, C):
    """RCAB's conv-chain form (both convs and the attention's pool sums in
    one pass) against the JAX RCAB at ``impl='interpret'``; C = 24 pads
    the bf16 taps, 13 rows leave a partial row block on the JAX side."""
    x = _x(rng, (1, 2, H, W, C)) * 0.1
    jm = jblocks.RCAB(C, impl="interpret")
    p = jm.init(jax.random.key(6), jnp.asarray(x))
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    m = _load(blocks.RCAB(C), p, "encoder_layers0/mlp_blocks0/spatial_mixing/mlp_c",
              "encoder_layers.0.mlp_blocks.0.spatial_mixing.mlp_c.")
    np.testing.assert_allclose(_run(m, x, kernel=True), want, **KTOL)
    np.testing.assert_allclose(_run(m, x), want, **KTOL)
