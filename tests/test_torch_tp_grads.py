"""The tensor-parallel step's first gradient (``vmg_tpu_torch.parallel.tp``)
against the unsharded step's, leaf by leaf, in bf16 compute on float32
masters (``amp``), where every reassociated sum would show.

``TINY_TEST_PRESET`` with stage 1 widened to 224 channels (past the
sharding threshold), one TAB and one residual block a stage, torch init.
Two processes of a gloo group on the CPU (spawned, two threads each,
``tests/_tp_worker.py``) form a (1, 2) mesh and take one step on the whole
batch; this process takes the same step unsharded, on two threads too
(the CPU kernels' sums split by thread).  The gathered weights are exact
and the gather's backward keeps each rank's slice of the whole gradient,
so the loss and every gradient -- each rank's slice of a sharded leaf,
the whole of a replicated one -- equal the unsharded step's bit for bit.
"""

import dataclasses

import numpy as np
import torch

from vmg_tpu_torch.configs import TINY_TEST_PRESET, TrainConfig
from vmg_tpu_torch.models.vmg import create_model
from vmg_tpu_torch.train.train_step import make_train_step

import _tp_worker
from _spawn import spawn

WIDE = dict(embed_dim=(32, 224, 32), num_heads=(2, 4, 2), depths=(1, 1, 1),
            traj_res_n=(1, 0, 1))
TRAIN = dict(lr=1e-4, T_period=(100,), if_aux=True, amp=True)


def test_two_tensor_ranks_take_the_unsharded_gradient_in_bf16(tmp_path):
    cfg = dataclasses.replace(TINY_TEST_PRESET, **WIDE)
    torch.manual_seed(0)
    state = create_model(cfg, is_train=True, device="cpu").state_dict()
    rng = np.random.default_rng(0)
    case = dict(cfg=cfg, state=state, train=TRAIN,
                LRs=torch.from_numpy(rng.random((1, 4, 64, 64, 3), dtype=np.float32)),
                HRs=torch.from_numpy(rng.random((1, 4, 256, 256, 3), dtype=np.float32)))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model = create_model(cfg, is_train=True, device="cpu")
        model.load_state_dict(state)
        step = make_train_step(model, TrainConfig(**TRAIN), flow_fix=0)
        want = _tp_worker.record_first_grads(step)
        loss = float(step({k: case[k] for k in ("LRs", "HRs")},
                          torch.Generator().manual_seed(1))["loss"])
    finally:
        torch.set_num_threads(threads)
    ranks = spawn(_tp_worker.run_grads, 2, (case,), str(tmp_path))
    rule = ranks[0][2]
    assert sum(d is not None for d in rule.values()) > 0
    assert sorted(rule) == sorted(want)
    for r, (got_loss, grads, _) in enumerate(ranks):
        assert got_loss == loss
        for name, g in want.items():
            w = g if rule[name] is None else g.chunk(2, rule[name])[r]
            assert torch.equal(grads[name], w), name
