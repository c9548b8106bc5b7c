"""The port's trajectory modules against the JAX modules (CPU, fp32,
3e-5; the conv-chain forms 1e-5): LTAM on its kernel path, the
recurrence, its gradients with remat, the residual block's and the
recurrence's conv-chain and barrier forms.  Split from
``tests/test_torch_blocks.py``, whose helpers it repeats; the JAX modules'
parameters reach the port through ``vmg_tpu_torch.weights``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vmg_tpu.models import trajectory as jtraj
from vmg_tpu_torch.models import trajectory
from vmg_tpu_torch.weights import state_dict_from_jax

TOL = dict(atol=3e-5, rtol=3e-5)
KTOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch at full
    width in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _port_params(params, path, prefix):
    """Export a JAX sub-module's params under a full-model path and strip
    the matching state-dict prefix."""
    tree = params["params"]
    for key in reversed(path.split("/")):
        tree = {key: tree}
    return state_dict_from_jax(tree, prefix=prefix)


def _load(module, params, path, prefix):
    module.load_state_dict(_port_params(params, path, prefix), strict=True)
    return module.eval()


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _run(module, *args, **kw):
    with torch.no_grad():
        return module(*(torch.from_numpy(a) for a in args), **kw).numpy()


def test_ltam(rng):
    n, K, h, w, C, heads = 2, 3, 8, 12, 16, 4
    curr, anchor = _x(rng, (n, h, w, C)), _x(rng, (n, h, w, C))
    vals = _x(rng, (n, h, w, K, C))
    keys = np.asarray(jtraj._normalize(jnp.asarray(_x(rng, (n, h, w, K, C)))))
    pad = [(0, 0)] * 4 + [(0, 128 - C)]
    kv_tpu = np.stack([np.pad(vals, pad), np.pad(keys, pad)], -2).reshape(n, h, w, -1)
    jm = jtraj.LTAM(C, head=heads, keys_prenormalized=True, presampled=True,
                    pallas_interpret=True)
    args = (jnp.asarray(curr), None, jnp.asarray(anchor), None, None)
    p = jm.init(jax.random.key(3), *args, kv_packed=jnp.asarray(kv_tpu))
    want = np.asarray(jm.apply(p, *args, kv_packed=jnp.asarray(kv_tpu)))
    m = _load(trajectory.LTAM(C, heads), p, "encoder_layers0/traj_mixing/step/LTAM",
              "encoder_layers.0.traj_mixing.LTAM.")
    kv = np.stack([vals, keys], -2).reshape(n, h, w, K * 2 * C)
    np.testing.assert_allclose(_run(m, curr, anchor, kv), want, **TOL)


def test_resblock_kernel_form_matches_jax(rng):
    x = _x(rng, (2, 12, 16, 24)) * 0.1
    jm = jtraj.ResidualBlockNoBN(24, res_scale=0.1, impl="interpret")
    p = jm.init(jax.random.key(7), jnp.asarray(x))
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    m = _load(trajectory.ResidualBlockNoBN(24, 0.1), p,
              "encoder_layers0/traj_mixing/step/resblocks/block0",
              "encoder_layers.0.traj_mixing.resblocks.main.2.0.")
    np.testing.assert_allclose(_run(m, x, kernel=True), want, **KTOL)
