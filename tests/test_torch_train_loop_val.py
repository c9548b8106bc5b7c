"""The training loop's validation hook (split from
``tests/test_torch_train_loop.py``; the tree and config: ``tests/_train_loop.py``).
"""

import os

import numpy as np

from vmg_tpu_torch.tools import train as train_cli

from _train_loop import _cfg, _few_torch_threads, _tree, tree  # noqa: F401


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
