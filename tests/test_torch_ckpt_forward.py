"""The forward of a reference checkpoint file against ``vmg_tpu``'s, and the
trainer's save / restore round trip (split from ``tests/test_torch_ckpt.py``,
whose helpers it uses).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vmg_tpu.ckpt.torch_convert import convert_torch_state_dict as j_convert
from vmg_tpu.configs import TINY_TEST_PRESET as J_TINY
from vmg_tpu.models import create_model as j_create_model
from vmg_tpu_torch.ckpt import (latest_step, load_reference_checkpoint, reference_state_dict, restore_checkpoint, save_checkpoint, trainer_state)
from vmg_tpu_torch.configs import TINY_TEST_PRESET
from vmg_tpu_torch.models.vmg import create_model

from test_torch_ckpt import FIXTURE, _batch, _trainer, _two_threads  # noqa: F401


def test_forward_from_the_file_matches_jax():
    sd = load_reference_checkpoint(FIXTURE)
    model = create_model(TINY_TEST_PRESET, device="cpu")
    model.load_state_dict(reference_state_dict(sd), strict=True)
    params = jax.tree.map(jnp.asarray, j_convert({k: v.float() for k, v in sd.items()}))
    x = np.random.default_rng(11).random((1, 4, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(j_create_model(J_TINY, is_train=False).apply)(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_save_restore_round_trip(tmp_path):
    model, step, gen = _trainer()
    step(_batch(), gen)
    state = trainer_state(model, step, gen)
    for s in (1, 2, 3):
        save_checkpoint(str(tmp_path), s, state, max_to_keep=2)
    assert latest_step(str(tmp_path)) == 3
    assert sorted(os.listdir(tmp_path)) == ["2", "3"]
    back = restore_checkpoint(str(tmp_path))
    assert back["step"] == state["step"] == 1
    for k, v in state["params"].items():
        assert torch.equal(back["params"][k], v), k
    for a, b in zip(back["opt"]["mu"] + back["opt"]["nu"], state["opt"]["mu"] + state["opt"]["nu"]):
        assert torch.equal(a, b)
    assert torch.equal(back["generator"], state["generator"])
    assert latest_step(str(tmp_path / "none")) is None
