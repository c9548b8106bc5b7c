"""The warped carry against the 'loc' carry, and the 'loc' carry against
``vmg_tpu``'s (split from ``tests/test_torch_variants_traj.py``, whose
helpers it uses).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vmg_tpu.models import trajectory as jtraj
from vmg_tpu_torch.models import trajectory

from test_torch_variants_traj import TOL, _few_torch_threads, _load, _perturb, _run, _x  # noqa: F401


@pytest.mark.parametrize("mode", ["wins", "max"])
def test_warped_carry_matches_loc_carry(rng, mode):
    """The warped carry (the kernel route at 'wins') against the port's
    'loc' carry, the reference-shaped oracle, as
    ``tests/test_fused_layouts.py`` holds the JAX carries, and the 'loc'
    carry against the JAX package's."""
    B, T, H, W, C = 1, 5, 8, 10, 16
    x = _x(rng, (B, T, H, W, C))
    ff, fb = 2 * _x(rng, (B, T - 1, H, W, 2)), 2 * _x(rng, (B, T - 1, H, W, 2))
    jm = jtraj.TrajectoryMultiHead(C, num_blocks=1, keyframe_stride=2, head=4, r_scaling=0.1,
                                   mode=mode, carry_impl="loc")
    args = tuple(map(jnp.asarray, (x, ff, fb)))
    p = _perturb(jm.init(jax.random.key(9), *args), rng)
    want = np.asarray(jax.jit(jm.apply)(p, *args))
    outs = []
    for carry in ("warped", "loc"):
        m = _load(trajectory.TrajectoryMultiHead(C, 1, 2, 4, 0.1, mode=mode, carry_impl=carry),
                  p, "encoder_layers0/traj_mixing", "encoder_layers.0.traj_mixing.")
        outs.append(_run(m, x, ff, fb))
    np.testing.assert_allclose(outs[1], want, **TOL)
    np.testing.assert_allclose(outs[0], outs[1], **TOL)
