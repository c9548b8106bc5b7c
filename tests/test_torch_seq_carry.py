"""The trajectory recurrence of the port's T-sharded forward at splits the
whole-model tests do not reach: four gloo processes on the CPU
(``tests/_seq_worker.py``), a 20-frame clip, 5 frames a process, so a
process holds two open segments of two windows (``traj_win`` 4: a carry
in from the process before and one out to the process after), or the
middle of one window over all four (``traj_win`` None), with the 'loc'
carry (slot locations and buffers handed over), the warped carry, and
LTAM's 'max' mode with ``en_field`` (four buffers a slot).  Each against
the same module on the whole clip in one process, which
``tests/test_torch_trajectory*.py`` and ``test_torch_variants*.py`` hold to
the JAX package, at ``atol=2e-5, rtol=1e-4``.
"""

import numpy as np
import pytest
import torch

from vmg_tpu_torch.models.trajectory import TrajectoryMultiHead

import _seq_worker
from _spawn import spawn


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_carries_across_four_processes(tmp_path):
    g = torch.Generator().manual_seed(1)
    x = torch.rand(1, 20, 16, 16, 8, generator=g)
    flows = (torch.randn(1, 19, 16, 16, 2, generator=g),
             torch.randn(1, 19, 16, 16, 2, generator=g))
    cases, want = [], []
    for kw in (dict(traj_win=4, carry_impl="loc"), dict(traj_win=None),
               dict(traj_win=10, mode="max", en_field=True)):
        torch.manual_seed(0)
        module = TrajectoryMultiHead(8, num_blocks=1, head=2, device="cpu", **kw).eval()
        with torch.no_grad():
            want.append(module(x, *flows).numpy())
        cases.append(dict(module=module, x=x, flows=flows))
    ranks = spawn(_seq_worker.run, 4, (cases,), str(tmp_path))
    for i, w in enumerate(want):
        got = torch.cat([r[i][0] for r in ranks], dim=1).numpy()
        np.testing.assert_allclose(got, w, atol=2e-5, rtol=1e-4, err_msg=f"case {i}")
        assert all(r[i][1]["carry"] > 0 for r in ranks)
