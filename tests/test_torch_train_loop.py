"""The port's training command line (``vmg_tpu_torch.tools.train``) against
the JAX loop of ``tools/train.py`` on CPU.

* ``train`` on ``TINY_TEST_PRESET`` (drop_path 0, T = 4) over a small packed
  tree, from one JAX init carried across by ``state_dict_from_jax``,
  against JAX steps fed by the JAX package's dataset, loader and
  ``accumulate_batches`` -- at grad_acc 1 (batch 1) and 2 (batch 1, total
  batch 2), across an epoch boundary: per-step losses within 1e-5
  relative (the tolerance of ``tests/test_torch_train.py``).
* Resume: two steps, then ``resume=True`` to step 4, equals bit for bit
  (stochastic depth on) a run that steps without stopping on the batches
  the resumed run takes -- epoch 0's again: the data restarts at epoch 0
  after a resume, as the JAX loop's does.
* Recovery: a step that raises a device error restores the host snapshot
  and goes on, logged; past ``max_retries`` the error is raised.
* The command line in-process with ``--device cpu`` on the tiny_demo
  preset exits 0 and writes ``scalars.jsonl``, a log and the last step's
  checkpoint; without ``--device cpu`` and without a card it raises.
"""

import dataclasses
import glob
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
from vmg_tpu_torch.ckpt.io import restore_checkpoint
from vmg_tpu_torch.configs import (TINY_TEST_PRESET, DatasetConfig, ExperimentConfig,
                                   PathConfig, TrainConfig)
from vmg_tpu_torch.data import clip_dataset, loader
from vmg_tpu_torch.data.storage import PackedWriter
from vmg_tpu_torch.models.vmg import create_model
from vmg_tpu_torch.tools import train as train_cli
from vmg_tpu_torch.train.train_step import make_train_step
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


@pytest.fixture(scope="module")
def jax_init():
    model = j_create_model(dataclasses.replace(J_TINY, drop_path_rate=0.0), is_train=True)
    x = jnp.zeros((1, 4, 64, 64, 3), jnp.float32)
    return model, jax.jit(model.init)(jax.random.key(0), x)


def _jax_loop(jax_init, tree, grad_acc, steps):
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


@pytest.mark.parametrize("grad_acc,steps", [(1, 3), (2, 2)])
def test_loop_matches_jax(jax_init, tree, tmp_path, grad_acc, steps):
    want, epochs = _jax_loop(jax_init, tree, grad_acc, steps)
    assert epochs == 2  # the steps cross an epoch
    cfg = _cfg(tree, tmp_path, grad_acc, drop_path_rate=0.0)
    rec = train_cli.train(cfg, max_steps=steps, max_retries=0, device="cpu",
                          init_state=state_dict_from_jax(jax_init[1]))
    assert rec["grad_acc"] == grad_acc and rec["steps"] == list(range(1, steps + 1))
    assert rec["epochs"] == 2 and len(rec["data_wait_s"]) >= steps
    np.testing.assert_allclose(rec["losses"], want, rtol=1e-5)


def test_resume_restarts_at_epoch_0_bit_for_bit(tree, tmp_path):
    cfg = _cfg(tree, tmp_path)  # stochastic depth on (drop_path 0.1)
    first = train_cli.train(cfg, max_steps=2, max_retries=0, device="cpu")
    assert first["epochs"] == 1 and first["end_step"] == 2
    rec = train_cli.train(cfg, resume=True, max_steps=4, max_retries=0, device="cpu")
    assert rec["start_step"] == 2 and rec["steps"] == [3, 4] and rec["epochs"] == 1
    got = restore_checkpoint(rec["ckpt_dir"], 4)["params"]

    # without stopping, on the batches the resumed run takes: epoch 0 twice
    ds = clip_dataset.create_dataset(cfg.dataset)
    ldr = loader.create_dataloader(ds, cfg.dataset)
    epoch0 = list(ldr)
    ds.set_epoch(1)
    ldr.sampler.set_epoch(1)
    assert not np.array_equal(list(ldr)[0]["HRs"], epoch0[0]["HRs"])
    model = create_model(cfg.network, is_train=True, device="cpu",
                         generator=torch.Generator().manual_seed(cfg.train.manual_seed))
    step = make_train_step(model, cfg.train)
    gen = torch.Generator().manual_seed(cfg.train.manual_seed + 777)
    for batch in loader.DeviceFeed(epoch0 + epoch0, "cpu"):
        step(batch, gen)
    want = model.state_dict()
    assert sorted(got) == sorted(want)
    for name, v in want.items():
        assert torch.equal(got[name], v), name


def test_device_error_recovers_then_raises(tree, tmp_path, monkeypatch):
    real = train_cli.make_train_step
    failures = []

    def flaky(*a, **kw):
        step = real(*a, **kw)

        def wrapped(batch, gen=None):
            if len(failures) < 1:
                failures.append(1)
                raise torch.OutOfMemoryError("out of memory (injected)")
            return step(batch, gen)

        for attr in ("model", "optimizer", "compute_model"):
            setattr(wrapped, attr, getattr(step, attr))
        return wrapped

    monkeypatch.setattr(train_cli, "make_train_step", flaky)
    cfg = _cfg(tree, tmp_path / "a", drop_path_rate=0.0)
    rec = train_cli.train(cfg, max_steps=1, max_retries=1, device="cpu")
    assert rec["retries"] == 1 and rec["steps"] == [1]
    log = open(glob.glob(os.path.join(str(tmp_path / "a"), "loop", "train_*.log"))[0]).read()
    assert "device error at step 0 (retry 1/1)" in log
    assert "restored host snapshot step 0" in log
    failures.clear()
    with pytest.raises(torch.OutOfMemoryError, match="injected"):
        train_cli.train(_cfg(tree, tmp_path / "b"), max_steps=1, max_retries=0, device="cpu")


def test_command_line_on_cpu(tmp_path):
    hr, lr = _tree(str(tmp_path / "demo"), hr=(256, 256), clips=("000",), frames=6)
    exp = tmp_path / "exp"
    args = ["--config", "tiny_demo", "--max-steps", "2", "--dataroot-hr", hr,
            "--dataroot-lr", lr, "--experiments-root", str(exp)]
    assert train_cli.main(args + ["--device", "cpu"]) == 0
    root = exp / "VMG-tiny-demo"
    assert (root / "tb_logger" / "scalars.jsonl").exists()
    assert glob.glob(str(root / "train_*.log"))
    state = restore_checkpoint(str(root / "ckpt"))
    assert state["step"] == 2 and state["opt"]["count"] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(args)


def test_validation_hook_logs_psnr(tree, tmp_path):
    """``val_lr_root``: every ``val_freq`` steps the master weights run the
    whole-frame SlidingEvaluator over the LR clips; val_psnr goes to the
    log and ``scalars.jsonl``."""
    import json

    from vmg_tpu_torch.eval.png import write_png

    rng = np.random.default_rng(1)
    for sub, hw in (("LR", 64), ("GT", 256)):
        os.makedirs(tmp_path / "val" / sub / "clip0")
        for i in range(4):
            write_png(str(tmp_path / "val" / sub / "clip0" / f"{i:08d}.png"),
                      rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8))
    cfg = _cfg(tree, tmp_path / "exp", drop_path_rate=0.0)
    cfg.train.val_freq = cfg.logger.print_freq = 1
    rec = train_cli.train(cfg, max_steps=1, max_retries=0, device="cpu",
                          val_lr_root=str(tmp_path / "val" / "LR"),
                          val_gt_root=str(tmp_path / "val" / "GT"))
    assert rec["steps"] == [1]
    lines = [json.loads(s) for s in open(tmp_path / "exp" / "loop" / "tb_logger" / "scalars.jsonl")]
    val = [ln for ln in lines if "val_psnr" in ln]
    assert len(val) == 1 and val[0]["step"] == 1 and 0 < val[0]["val_psnr"] < 60
    assert any("loss" in ln and "lr" in ln and "grad_norm" in ln for ln in lines)


def test_visualization_hook_matches_jax(tmp_path):
    from vmg_tpu.edit.hooks import VisualizationHook as JVis
    from vmg_tpu_torch.edit.hooks import HookList, VisualizationHook
    from vmg_tpu_torch.eval.eval_utils import read_image

    rng = np.random.default_rng(2)
    extras = {"lq": rng.random((1, 9, 11, 3)), "output": rng.random((9, 11, 3)) * 1.2 - 0.1}
    HookList([VisualizationHook(str(tmp_path / "port"), interval=2)]).after_iter(4, None, extras)
    JVis(str(tmp_path / "jax"), interval=2).after_iter(4, None, extras)
    VisualizationHook(str(tmp_path / "skip"), interval=3).after_iter(4, None, extras)
    assert not os.path.exists(tmp_path / "skip")
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "iter_00000004_lq.png", "iter_00000004_output.png"]
    for n in names:
        np.testing.assert_array_equal(read_image(str(tmp_path / "port" / n)),
                                      read_image(str(tmp_path / "jax" / n)))
