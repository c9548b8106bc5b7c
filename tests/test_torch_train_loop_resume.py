"""Resuming the port's training command line (split from
``tests/test_torch_train_loop.py``; the tree and config: ``tests/_train_loop.py``).
"""

import numpy as np
import torch

from vmg_tpu_torch.ckpt.io import restore_checkpoint
from vmg_tpu_torch.data import clip_dataset, loader
from vmg_tpu_torch.models.vmg import create_model
from vmg_tpu_torch.tools import train as train_cli
from vmg_tpu_torch.train.train_step import make_train_step

from _train_loop import _cfg, _few_torch_threads, tree  # noqa: F401


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
