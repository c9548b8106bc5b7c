"""The trajectory's switches (``ltam`` off, 'max' with ``en_field``, other
twins windows) against ``vmg_tpu`` (split from
``tests/test_torch_variants_traj.py``, whose helpers it uses).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vmg_tpu.models import trajectory as jtraj
from vmg_tpu_torch.models import trajectory

from test_torch_variants_traj import TOL, _few_torch_threads, _load, _perturb, _run, _x  # noqa: F401


# (TrajectoryMultiHead kwargs of both packages): LTAM off; 'max' with the
# en_field context (field stride 2); 4 x 2 twins windows without the head
# scale -- the windowed module form on the port's side
TRAJ_CASES = [dict(ltam=False), dict(mode="max", en_field=True, field_stride=2),
              dict(twins=(4, 2), head_scale=False)]


@pytest.mark.parametrize("kw", TRAJ_CASES)
def test_trajectory_switches_match_jax(rng, kw):
    B, T, H, W, C = 1, 4, 8, 8, 16
    x = _x(rng, (B, T, H, W, C))
    ff, fb = 2 * _x(rng, (B, T - 1, H, W, 2)), 2 * _x(rng, (B, T - 1, H, W, 2))
    jm = jtraj.TrajectoryMultiHead(C, num_blocks=1, keyframe_stride=2, head=4,
                                   r_scaling=0.1, **kw)
    args = tuple(map(jnp.asarray, (x, ff, fb)))
    p = _perturb(jm.init(jax.random.key(8), *args), rng)
    want = np.asarray(jax.jit(jm.apply)(p, *args))
    tkw = {k: v for k, v in kw.items() if k != "field_stride"}
    m = _load(trajectory.TrajectoryMultiHead(C, 1, 2, 4, 0.1, field_stride=kw.get(
        "field_stride", 4), **tkw), p, "encoder_layers0/traj_mixing",
        "encoder_layers.0.traj_mixing.")
    np.testing.assert_allclose(_run(m, x, ff, fb), want, **TOL)
