"""The swin3d tail's two-block layer against ``vmg_tpu``'s (split from
``tests/test_torch_variants.py``, whose helpers it uses).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vmg_tpu.models import swin3d as jswin
from vmg_tpu_torch.models import swin3d

from test_torch_variants import TOL, _few_torch_threads, _load, _perturb, _run, _x  # noqa: F401


@pytest.mark.parametrize("D,window_size", [(3, (2, 4, 4)), (2, (8, 8, 8)), (5, (3, 4, 4))])
def test_decoder_layer_matches_jax(rng, D, window_size):
    """The two-block tail: the mirror extension (D % wt != 0), windows the
    input shrinks (8 x 8 x 8 against 2 x 6 x 7: the phase-10 stage-3 window
    at a short clip, out-of-range frame indices included) and padding."""
    B, H, W, C = 1, 6, 7, 16
    x = _x(rng, (B, D, H, W, C))
    jm = jswin.DecoderLayer(C, 2, 2, window_size, 2.0)
    p = _perturb(jm.init(jax.random.key(1), jnp.asarray(x)), rng)
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    m = _load(swin3d.DecoderLayer(C, 2, 2, window_size, 2.0), p, "encoder_layers0/traj_mixing",
              "encoder_layers.0.traj_mixing.")
    np.testing.assert_allclose(_run(m, x), want, **TOL)
