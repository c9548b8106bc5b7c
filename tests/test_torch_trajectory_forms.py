"""The trajectory recurrence in each conv form against the JAX module
(split from ``tests/test_torch_trajectory.py``, whose helpers it uses).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vmg_tpu.models import trajectory as jtraj
from vmg_tpu_torch.models import trajectory

from test_torch_trajectory import TOL, _few_torch_threads, _load, _run, _x  # noqa: F401


@pytest.mark.parametrize("impl", ["kernel", "barrier", "barrier_out"])
def test_trajectory_conv_forms_match_jax(rng, impl):
    """TrajectoryMultiHead with each ``traj_conv_impl`` against the JAX
    module at ``conv_impl='interpret'`` (the chain kernel in every step),
    3e-5.  JAX's layout pin has no interpret mode; the pin is the
    identity, so the barrier forms are held against the same output."""
    B, T, H, W, C = 1, 5, 8, 12, 16
    x = _x(rng, (B, T, H, W, C))
    ff, fb = _x(rng, (B, T - 1, H, W, 2)) * 2, _x(rng, (B, T - 1, H, W, 2)) * 2
    jm = jtraj.TrajectoryMultiHead(
        embed_dim=C, num_blocks=2, keyframe_stride=2, head=4, mode="wins",
        r_scaling=0.1, ltam=True, carry_impl="warped", win_impl="pallas",
        pallas_interpret=True, conv_impl="interpret")
    args = tuple(map(jnp.asarray, (x, ff, fb)))
    p = jax.jit(jm.init)(jax.random.key(8), *args)
    want = np.asarray(jax.jit(jm.apply)(p, *args))
    m = _load(trajectory.TrajectoryMultiHead(C, num_blocks=2, keyframe_stride=2, head=4,
                                             r_scaling=0.1, traj_conv_impl=impl),
              p, "encoder_layers0/traj_mixing", "encoder_layers.0.traj_mixing.")
    np.testing.assert_allclose(_run(m, x, ff, fb), want, **TOL)
