"""The port's training command line (``vmg_tpu_torch.tools.train``) on CPU
(its losses against the JAX loop of ``tools/train.py``:
``tests/test_torch_train_loop_jax.py``).

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

import glob
import os

import numpy as np
import pytest
import torch

from vmg_tpu_torch.ckpt.io import restore_checkpoint
from vmg_tpu_torch.tools import train as train_cli

from _train_loop import _cfg, _few_torch_threads, _tree, tree  # noqa: F401


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
