"""Trainer checkpoints: a resumed run equals an uninterrupted one, also
through the trainer's command line (split from ``tests/test_torch_ckpt.py``,
whose helpers it uses).
"""

import torch

from vmg_tpu_torch.ckpt import (latest_step, load_trainer_state, restore_checkpoint,
                                save_checkpoint, trainer_state)
from vmg_tpu_torch.configs import TINY_TEST_PRESET

from test_torch_ckpt import _batch, _trainer, _two_threads  # noqa: F401


def test_resume_equals_uninterrupted(tmp_path):
    N, k = 2, 1
    batch = _batch()
    model, step, gen = _trainer()
    for _ in range(N):
        step(batch, gen)
    want = {n: p.detach().clone() for n, p in model.state_dict().items()}

    model, step, gen = _trainer()
    for _ in range(k):
        step(batch, gen)
    save_checkpoint(str(tmp_path), k, trainer_state(model, step, gen))
    model, step, gen = _trainer(seed=1)  # a fresh trainer, other weights
    assert load_trainer_state(restore_checkpoint(str(tmp_path)), model, step, gen) == k
    for _ in range(N - k):
        step(batch, gen)
    for n, p in model.state_dict().items():
        assert torch.equal(p, want[n]), n


def test_trainer_command_line_resumes(tmp_path):
    """``python -m vmg_tpu_torch.train --ckpt-dir``: two runs of a warm-up
    and one step, the second resumed from the first's checkpoint, end on
    the parameters, bit for bit, of one run of a warm-up and three steps;
    the evaluator's loader reads the directory."""
    import copy
    import dataclasses

    from vmg_tpu_torch.configs import EVAL_PRESETS
    from vmg_tpu_torch.eval import load_model
    from vmg_tpu_torch.train.__main__ import main, run

    kw = dict(preset="tiny", frames=2, crop=64, iters=1, device="cpu")
    split, whole = str(tmp_path / "split"), str(tmp_path / "whole")
    first, second = run(ckpt_dir=split, **kw), run(ckpt_dir=split, **kw)
    assert (first["resumed_from_step"], first["saved_step"]) == (None, 2)
    assert (second["resumed_from_step"], second["saved_step"]) == (2, 4)
    main(["--preset", "tiny", "--frames", "2", "--iters", "3", "--device", "cpu",
          "--ckpt-dir", whole])
    assert latest_step(whole) == 4
    got, want = restore_checkpoint(split), restore_checkpoint(whole)
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k

    cfg = copy.deepcopy(EVAL_PRESETS["vid4"])
    cfg.network = dataclasses.replace(TINY_TEST_PRESET)
    model = load_model(cfg, split, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, got["params"][k]), k
