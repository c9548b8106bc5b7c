"""Tensor parallelism of the port's training state (``vmg_tpu_torch.parallel.tp``)
against the JAX package's sharded step, after ``tests/test_parallel_mesh.py``'s
``test_dp_vs_dp_tp_steps_match``.

``TINY_TEST_PRESET`` with stage 1 widened to 224 channels (past the
sharding threshold), one TAB and one residual block a stage, drop_path 0,
float32, the JAX package's init.  Two processes of a gloo group on the CPU
(spawned, two threads each, ``tests/_tp_worker.py``) form a (1, 2) mesh:
each stores half of every wide leaf and of its AdamW moments and takes one
step on the whole batch.  Against the JAX package's
``make_sharded_train_step(..., state_shardings)`` on a (1, 2) mesh of its
CPU devices, within that test's bounds: the loss at ``rtol=2e-5,
atol=1e-6``, every parameter within 2.5e-4 (at lr 1e-4 a step-1 AdamW
update is ~lr times the sign of the gradient, so a reassociated sum that
flips a near-zero gradient moves it by up to 2 lr).  Then both ranks
serve two frames in eval mode: the kernels' operands, packed from the
gathered weights before the step, are packed again after it, so the
output is the unsharded model's with the updated weights (within 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmg_tpu.configs import TINY_TEST_PRESET as J_TINY
from vmg_tpu.configs.config import TrainConfig as JTrainConfig
from vmg_tpu.models import create_model as j_create_model
from vmg_tpu.parallel import make_mesh, make_sharded_train_step, shard_state, state_shardings
from vmg_tpu.train import init_train_state, make_train_step
from vmg_tpu_torch.configs import TINY_TEST_PRESET
from vmg_tpu_torch.models.vmg import create_model
from vmg_tpu_torch.weights import state_dict_from_jax

import _tp_worker
from _spawn import spawn

WIDE = dict(embed_dim=(32, 224, 32), num_heads=(2, 4, 2), depths=(1, 1, 1),
            traj_res_n=(1, 0, 1), drop_path_rate=0.0)
TRAIN = dict(lr=1e-4, T_period=(100,), if_aux=True)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_two_tensor_ranks_match_jax_sharded_step(tmp_path):
    rng = np.random.default_rng(0)
    batch = {"LRs": rng.random((2, 2, 64, 64, 3), dtype=np.float32),
             "HRs": rng.random((2, 2, 256, 256, 3), dtype=np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = j_create_model(dataclasses.replace(J_TINY, **WIDE), is_train=True)
    params = jax.jit(model.init)(jax.random.key(0), jbatch["LRs"][:1])
    tcfg = JTrainConfig(niter=100, **TRAIN)
    state = init_train_state(model, params, tcfg, flow_fix=0)
    init = state_dict_from_jax(params)
    mesh = make_mesh((1, 2), jax.devices()[:2])
    step = make_sharded_train_step(make_train_step(model, tcfg, grad_acc=1, jit=False), mesh,
                                   state_shardings(mesh, state))
    after, m = step(shard_state(mesh, state), jbatch, jax.random.key(1))
    want = state_dict_from_jax(jax.device_get(after.params))

    case = dict(mesh=(1, 2), cfg=dataclasses.replace(TINY_TEST_PRESET, **WIDE), state=init,
                train=dict(niter=100, **TRAIN),
                **{k: torch.from_numpy(v) for k, v in batch.items()})
    ranks = spawn(_tp_worker.run, 2, (case,), str(tmp_path))
    loss, _, got, names, held, whole, served = ranks[0]
    np.testing.assert_allclose(loss, float(m["loss"]), rtol=2e-5, atol=1e-6)
    assert sorted(got) == sorted(want)
    diffs = {k: float((got[k] - v).abs().max()) for k, v in want.items()}
    assert max(diffs.values()) < 2.5e-4, sorted(diffs.items(), key=lambda kv: kv[1])[-3:]
    # each tensor rank holds half of every sharded leaf, its m and its v
    assert names and all(r[4] * 2 == r[5] for r in ranks), [(r[4], r[5]) for r in ranks]
    for k, v in ranks[1][2].items():  # the gathered state is one state on both
        torch.testing.assert_close(v, got[k], rtol=0, atol=0)
    # serving after the update repacks the kernels' operands from the
    # gathered weights: the unsharded model with those weights serves alike
    plain = create_model(case["cfg"], device="cpu")
    plain.load_state_dict(got)
    with torch.no_grad():
        want_y = plain(case["LRs"][:1, :2])
    for r in ranks:
        torch.testing.assert_close(r[6], want_y, rtol=0, atol=1e-6)
