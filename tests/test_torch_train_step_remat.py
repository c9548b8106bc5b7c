"""Gradient accumulation and remat on the port's training step (split from
``tests/test_torch_train_step.py``, whose helpers it uses).
"""

import numpy as np
import torch

from vmg_tpu_torch.configs import TrainConfig
from vmg_tpu_torch.train.train_step import loss_and_grads, make_train_step

from test_torch_train_step import _batch, _few_torch_threads, _model  # noqa: F401


def test_grad_acc_equals_full_batch():
    tcfg = TrainConfig(lr=1e-3, T_period=(1000,))
    batch = _batch(2, 2)
    a, b = _model(drop_path_rate=0.0), _model(drop_path_rate=0.0)
    ma = make_train_step(a, tcfg, grad_acc=1)(batch)
    mb = make_train_step(b, tcfg, grad_acc=2)(batch)
    np.testing.assert_allclose(float(mb["loss"]), float(ma["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(mb["grad_norm"]), float(ma["grad_norm"]), rtol=1e-5)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        np.testing.assert_allclose(pb.detach().numpy(), pa.detach().numpy(), atol=5e-4,
                                   rtol=0, err_msg=name)


def test_remat_equals_no_remat_with_drop_path():
    """T=4 reaches K=2 slots; drop_path 0.5 on B=2 samples drops branches
    (the gradients differ from those at drop_path 0), identically with and
    without recomputation."""
    tcfg = TrainConfig()
    batch = _batch(2, 4)
    runs = []
    for remat, rate in ((True, 0.5), (False, 0.5), (True, 0.0)):
        model = _model(drop_path_rate=rate, remat=remat)
        gen = torch.Generator().manual_seed(7)
        runs.append(loss_and_grads(model, batch["LRs"], batch["HRs"], tcfg, generator=gen))
    (l_on, g_on), (l_off, g_off), (_, g_nodrop) = runs
    assert max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(g_on, g_nodrop)) > 0.1
    np.testing.assert_allclose(float(l_on), float(l_off), rtol=1e-6)
    for a, b in zip(g_on, g_off):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-6 * scale
