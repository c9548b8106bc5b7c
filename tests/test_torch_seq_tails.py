"""The T-sharded serving forward of the port with the other stage tails,
against the JAX package: ``TINY_TEST_PRESET`` at one TAB and one residual
block a stage with the flow-guided DCN alignment at stages 0 and 2 (its
neighbour frames across the shards come from the adjacent process) and the
3D shifted-window attention at stage 1 (its windows span T and wrap around
it: the layer runs on the gathered clip).  Two gloo processes on the CPU
(``tests/_seq_worker.py``), an 8-frame 64x64 clip, float32, the JAX
package's init, against its one-device ``model.apply`` at ``atol=2e-5,
rtol=1e-4`` (``tests/test_parallel_mesh.py``'s tolerance for its sharded
forward).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmg_tpu.configs import TINY_TEST_PRESET as J_TINY
from vmg_tpu.models import create_model as j_create_model
from vmg_tpu_torch.configs import TINY_TEST_PRESET
from vmg_tpu_torch.weights import state_dict_from_jax

import _seq_worker
from _spawn import spawn

TAILS = dict(depths=(1, 1, 1), traj_res_n=(1, 0, 1), temporal_type=(True, None),
             temporal_empty=False)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_two_processes_with_every_tail_match_jax(tmp_path):
    x = np.random.default_rng(4).random((1, 8, 64, 64, 3), dtype=np.float32)
    jx = jnp.asarray(x)
    model = j_create_model(dataclasses.replace(J_TINY, **TAILS), is_train=False)
    params = jax.jit(model.init)(jax.random.key(0), jx[:, :2])
    # the DCN's zero-initialised offset head would align with the flow alone
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.01 if "conv_offset3" in jax.tree_util.keystr(p) else v, params)
    want = np.asarray(jax.jit(model.apply)(params, jx))

    case = dict(cfg=dataclasses.replace(TINY_TEST_PRESET, **TAILS),
                state=state_dict_from_jax(params), x=torch.from_numpy(x), mirror=False)
    ranks = spawn(_seq_worker.run, 2, ([case],), str(tmp_path))
    got = torch.cat([r[0][0] for r in ranks], dim=1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    for r in ranks:  # both halos (the DCN's neighbours) and the window layer's gather
        assert r[0][1]["halo"] > 0 and r[0][1]["frames"] > 0
