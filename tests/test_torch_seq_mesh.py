"""The port's T-sharded forward on a (1, 2) mesh: two gloo processes on
the CPU (spawned, two threads each, ``tests/_seq_worker.py``) on a data
axis of 1 and a tensor axis of 2, so each process holds the whole 8-frame
clip and no exchange runs -- in particular the time sums do not reduce
over the tensor peers, which share the data index.  The whole model
(``TINY_TEST_PRESET`` at one TAB and one residual block a stage, a
trajectory window split by no shard) and the MorphFC-decay mixer with its
reweight MLP at 10x, each against the same module on the clip in one
process, at ``atol=2e-5, rtol=1e-4``."""

import dataclasses

import numpy as np
import pytest
import torch

from vmg_tpu_torch.configs import TINY_TEST_PRESET
from vmg_tpu_torch.models.blocks import MorphFCDecay
from vmg_tpu_torch.models.vmg import create_model

import _seq_worker
from _spawn import spawn

TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_data_axis_of_one_exchanges_nothing(tmp_path):
    cfg = dataclasses.replace(TINY_TEST_PRESET, depths=(1, 1, 1), traj_res_n=(1, 0, 1),
                              traj_win=(8, None))
    torch.manual_seed(0)
    model = create_model(cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(6).random((1, 8, 64, 64, 3), dtype=np.float32))
    mixer = MorphFCDecay(32, 8, 8).eval()
    clip = torch.rand(1, 8, 16, 16, 32)
    clip[:, 4:] = 0.5 + 0.5 * clip[:, 4:]
    with torch.no_grad():
        for name, p in mixer.named_parameters():
            if "reweight" in name:
                p.mul_(10.0)
        want = [model(x).numpy(), mixer(clip).numpy()]
    cases = [dict(cfg=cfg, state=model.state_dict(), x=x, mirror=False, mesh=(1, 2)),
             dict(module=mixer, x=clip, mesh=(1, 2))]
    ranks = spawn(_seq_worker.run, 2, (cases,), str(tmp_path))
    for r in ranks:
        for i, w in enumerate(want):
            np.testing.assert_allclose(r[i][0].numpy(), w, err_msg=f"case {i}", **TOL)
            assert not any(r[i][1].values()), r[i][1]
