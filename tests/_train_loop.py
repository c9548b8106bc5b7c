"""Helpers and fixtures of the port's training command line tests
(``tests/test_torch_train_loop*.py``): a small packed tree, the command's
config, and the JAX loop of ``tools/train.py`` the losses are held to
(``tests/test_torch_train_loop_jax*.py``: one file a grad_acc, so the two
JAX step compiles run in two workers).

``train`` on ``TINY_TEST_PRESET`` at depth 1 a stage (drop_path 0, T = 4;
the loop's arithmetic does not depend on the depth, the JAX step's compile
does) over a small packed tree, from one JAX init carried across by
``state_dict_from_jax``, against JAX steps fed by the JAX package's
dataset, loader and ``accumulate_batches`` -- at grad_acc 1 (batch 1) and
2 (batch 1, total batch 2), across an epoch boundary: per-step losses
within 1e-5 relative (the tolerance of ``tests/test_torch_train.py``).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vmg_tpu.configs import TINY_TEST_PRESET as J_TINY
from vmg_tpu.configs.config import DatasetConfig as JDatasetConfig
from vmg_tpu.configs.config import TrainConfig as JTrainConfig
from vmg_tpu.data import clip_dataset as jclip
from vmg_tpu.data import loader as jloader
from vmg_tpu.models import create_model as j_create_model
from vmg_tpu.train import init_train_state, make_train_step as j_make_train_step
from vmg_tpu_torch.configs import (TINY_TEST_PRESET, DatasetConfig, ExperimentConfig,
                                   PathConfig, TrainConfig)
from vmg_tpu_torch.data.storage import PackedWriter
from vmg_tpu_torch.tools import train as train_cli
from vmg_tpu_torch.weights import state_dict_from_jax

HR = (256, 288)
TRAIN = dict(lr=1e-3, T_period=(1000,), niter=1000, weight_decay=0.05, if_aux=True)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _tree(root, hr=HR, clips=("000", "001"), frames=8):
    rng = np.random.default_rng(0)
    lr = (hr[0] // 4, hr[1] // 4)
    hw = PackedWriter(os.path.join(root, "hr"), hr + (3,))
    lw = PackedWriter(os.path.join(root, "lr"), lr + (3,))
    for c in clips:
        for f in range(frames):
            hw.add(f"{c}_{f}", rng.integers(0, 256, hr + (3,), dtype=np.uint8), clip_key=c)
            lw.add(f"{c}_{f}", rng.integers(0, 256, lr + (3,), dtype=np.uint8), clip_key=c)
    hw.close()
    lw.close()
    return os.path.join(root, "hr"), os.path.join(root, "lr")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _tree(str(tmp_path_factory.mktemp("loop")))


def _data_kw(tree, grad_acc):
    return dict(dataroot_HR=tree[0], dataroot_LR=tree[1], num_frames=4, crop_size=256,
                image_shape=(3,) + HR, total_num_frames=8, batch_size=1,
                total_batch=grad_acc, dataset_expand_ratio=1, n_workers=2)


def _cfg(tree, root, grad_acc=1, **net):
    return ExperimentConfig(
        name="loop", network=dataclasses.replace(TINY_TEST_PRESET, **net),
        dataset=DatasetConfig(**_data_kw(tree, grad_acc)), train=TrainConfig(**TRAIN),
        path=PathConfig(experiments_root=str(root)))


# the network of both loops: the tiny preset at one TAB and one residual
# block a stage, no stochastic depth
LOOP_NET = dict(drop_path_rate=0.0, depths=(1, 1, 1), traj_res_n=(1, 0, 1))


@pytest.fixture(scope="module")
def jax_init():
    model = j_create_model(dataclasses.replace(J_TINY, **LOOP_NET), is_train=True)
    x = jnp.zeros((1, 4, 64, 64, 3), jnp.float32)
    return model, jax.jit(model.init)(jax.random.key(0), x)


def jax_loop(jax_init, tree, grad_acc, steps):
    """tools/train.py's loop: the JAX dataset, loader and accumulation."""
    model, params = jax_init
    tcfg = JTrainConfig(**TRAIN)
    state = init_train_state(model, params, tcfg, J_TINY.flow_fix)
    step = j_make_train_step(model, tcfg, grad_acc=grad_acc, donate=False)
    dcfg = JDatasetConfig(**_data_kw(tree, grad_acc))
    dataset = jclip.create_dataset(dcfg, 4)
    ldr = jloader.create_dataloader(dataset, dcfg)
    key, losses, epoch = jax.random.key(777), [], 0
    while len(losses) < steps:
        dataset.set_epoch(epoch)
        ldr.sampler.set_epoch(epoch)
        for batch in jloader.accumulate_batches(iter(ldr), grad_acc):
            if len(losses) >= steps:
                break
            key, sub = jax.random.split(key)
            state, m = step(state, {k: jnp.asarray(batch[k]) for k in ("LRs", "HRs")}, sub)
            losses.append(float(m["loss"]))
        epoch += 1
    return losses, epoch


def check_loop(jax_init, tree, tmp_path, grad_acc, steps):
    want, epochs = jax_loop(jax_init, tree, grad_acc, steps)
    assert epochs == 2  # the steps cross an epoch
    cfg = _cfg(tree, tmp_path, grad_acc, **LOOP_NET)
    rec = train_cli.train(cfg, max_steps=steps, max_retries=0, device="cpu",
                          init_state=state_dict_from_jax(jax_init[1]))
    assert rec["grad_acc"] == grad_acc and rec["steps"] == list(range(1, steps + 1))
    assert rec["epochs"] == 2 and len(rec["data_wait_s"]) >= steps
    np.testing.assert_allclose(rec["losses"], want, rtol=1e-5)
