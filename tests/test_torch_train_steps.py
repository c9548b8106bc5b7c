"""Three training steps of the port against ``vmg_tpu.train`` on CPU,
float32 (split from ``tests/test_torch_train.py``, whose docstring gives
the protocol and tolerances and whose constants it shares).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vmg_tpu.configs import TINY_TEST_PRESET as J_TINY
from vmg_tpu.configs.config import TrainConfig as JTrainConfig
from vmg_tpu.models import create_model as j_create_model
from vmg_tpu.train import init_train_state, make_train_step as j_make_train_step
from vmg_tpu_torch.configs import TINY_TEST_PRESET, TrainConfig
from vmg_tpu_torch.models.vmg import create_model
from vmg_tpu_torch.train.train_step import make_train_step
from vmg_tpu_torch.weights import state_dict_from_jax

from test_torch_train import STEP_NET, TRAIN, _few_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def jax_three_steps():
    """(initial JAX params, batch, per-step losses and grad norms, final
    params) of three JAX training steps."""
    cfg = dataclasses.replace(J_TINY, **STEP_NET)
    model = j_create_model(cfg, is_train=True)
    rng = np.random.default_rng(0)
    batch = {"LRs": rng.random((1, 4, 64, 64, 3), dtype=np.float32),
             "HRs": rng.random((1, 4, 256, 256, 3), dtype=np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(model.init)(jax.random.key(0), jbatch["LRs"])
    state = init_train_state(model, params, JTrainConfig(niter=1000, **TRAIN), flow_fix=0)
    step = j_make_train_step(model, JTrainConfig(niter=1000, **TRAIN), donate=False)
    losses, norms = [], []
    for i in range(3):
        state, m = step(state, jbatch, jax.random.key(i))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return params, batch, losses, norms, state.params


def test_train_steps_match_jax(jax_three_steps):
    params, batch, want_losses, want_norms, want_params = jax_three_steps
    cfg = dataclasses.replace(TINY_TEST_PRESET, **STEP_NET)
    model = create_model(cfg, is_train=True, device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    step = make_train_step(model, TrainConfig(**TRAIN), flow_fix=0)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        m = step(tbatch, gen)
        np.testing.assert_allclose(float(m["loss"]), want_losses[i], rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), want_norms[i],
                                   rtol=1e-5 if i == 0 else 1e-3)
    assert want_norms[0] > TRAIN["grad_clip_up"]  # the clip was active
    init, want = state_dict_from_jax(params), state_dict_from_jax(want_params)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        np.testing.assert_allclose(got[name].numpy(), v.numpy(), atol=5e-4, rtol=0,
                                   err_msg=name)
    diff = sum(float(((got[n] - want[n]).double() ** 2).sum()) for n in want) ** 0.5
    moved = sum(float(((want[n] - init[n]).double() ** 2).sum()) for n in want) ** 0.5
    assert diff <= 1e-2 * moved, (diff, moved)
