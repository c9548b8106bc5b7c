"""Properties of the port's training step that need no JAX run (CPU,
float32, ``TINY_TEST_PRESET``):

* ``grad_acc=2`` (strided microbatches) equals the full batch: loss
  within 1e-6 relative, gradient norm within 1e-5 (a sum over two
  microbatches rounds otherwise), parameters after the update within
  5e-4 (AdamW's normalisation of near-zero gradients, see
  ``test_torch_train.py``);
* remat on equals remat off at drop_path > 0 (the stochastic-depth masks
  are drawn outside the checkpointed blocks, so the recompute reuses
  them): loss and every gradient within 1e-6 of the largest;
* a model that served, took an optimizer step and serves again uses the
  new weights (the kernels' packed operands follow the update);
* ``frames_mirror`` on a mirrored clip gives the forward without it;
* the trainer entry point runs on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vmg_tpu_torch.configs import TINY_TEST_PRESET, TrainConfig
from vmg_tpu_torch.models.vmg import create_model
from vmg_tpu_torch.train.train_step import make_train_step


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; float32 work
    spread over every core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _model(seed=0, **cfg):
    return create_model(dataclasses.replace(TINY_TEST_PRESET, **cfg), is_train=True,
                        device="cpu", generator=torch.Generator().manual_seed(seed))


def _batch(B, T, seed=0):
    rng = np.random.default_rng(seed)
    return {"LRs": torch.from_numpy(rng.random((B, T, 64, 64, 3), dtype=np.float32)),
            "HRs": torch.from_numpy(rng.random((B, T, 256, 256, 3), dtype=np.float32))}


def test_serving_after_a_training_step_uses_the_new_weights():
    model = _model(drop_path_rate=0.0).eval()
    x = _batch(1, 2)["LRs"]
    with torch.no_grad():
        before = model(x)  # packs the kernels' operands
    step = make_train_step(model, TrainConfig(lr=1e-2, T_period=(1000,)))
    step(_batch(1, 2, seed=1))
    assert not model.training
    fresh = create_model(dataclasses.replace(TINY_TEST_PRESET, drop_path_rate=0.0),
                         device="cpu")
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        after, want = model(x), fresh(x)
    assert float((after - before).abs().max()) > 1e-4
    torch.testing.assert_close(after, want, rtol=0, atol=0)


def test_frames_mirror_on_a_mirrored_clip():
    model = _model().eval()
    x = _batch(1, 2)["LRs"]
    x = torch.cat([x, x.flip(1)], dim=1)
    with torch.no_grad():
        torch.testing.assert_close(model(x, frames_mirror=True), model(x), rtol=1e-6,
                                   atol=1e-6)


def test_trainer_entry_point_on_cpu():
    from vmg_tpu_torch.train.__main__ import run

    rec = run(preset="tiny", batch=1, frames=2, crop=64, iters=1, device="cpu")
    assert rec["device"] == "cpu" and rec["peak_bytes"] is None
    assert np.isfinite(rec["loss_first"]) and np.isfinite(rec["loss_last"])
    assert rec["step_ms_min"] <= rec["step_ms_median"] <= rec["step_ms_max"]
    assert rec["frames_per_s"] > 0
