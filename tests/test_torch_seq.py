"""The T-sharded serving forward of the port (``vmg_tpu_torch.parallel.seq``)
against the JAX package, after ``tests/test_parallel_mesh.py``'s
``test_sequence_sharded_forward_matches_single_device``.

Two processes of a gloo group on the CPU (spawned, two threads each,
``tests/_seq_worker.py``) each hold 4 of an 8-frame 64x64 clip and return
their frames' output; ``TINY_TEST_PRESET`` at one TAB and one residual
block a stage (``NET``), float32, the JAX package's init.  Every case goes
through the exchanges: the SPyNet pair across the shards, the gathered
flows, the MorphFC-decay reweight sums.  Tolerance ``atol=2e-5,
rtol=1e-4``, as the JAX package's own sharded-forward test holds it:

* windows aligned with the shards (``traj_win`` 4: nothing crosses in the
  recurrence), against the JAX package's ``make_seq_sharded_forward`` on
  a (2, 1) mesh of its CPU devices;
* one trajectory window over both shards (``traj_win`` 8: the carry is
  handed over, forward and backward);
* ``frames_mirror`` (each process needs the other's flows, reversed);
both against the JAX package's one-device ``model.apply``, which its own
test pins to its sharded forward.

At the JAX init the mixers' reweight weights are small, so a mean over
the wrong frames moves the output by less than that tolerance.  The same
processes therefore also run the three means over (T, H, W) alone -- the
MorphFC-decay mixer's kernel form (its per-frame sums all-reduced),
plain MorphFC and the shift FFN, torch-initialised with their reweight
MLPs at 10x, on a clip whose second half is brighter (each shard's own
mean would move them by 1e-3 to 1e-1) -- against the same module on the
whole clip in one process, which the port's block tests hold to the JAX
package, at the same tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmg_tpu.configs import TINY_TEST_PRESET as J_TINY
from vmg_tpu.models import create_model as j_create_model
from vmg_tpu.parallel import make_mesh as j_make_mesh, replicate
from vmg_tpu.parallel.seq import (make_seq_sharded_forward as j_seq_forward,
                                  shard_clip_over_time as j_shard)
from vmg_tpu_torch.configs import TINY_TEST_PRESET
from vmg_tpu_torch.models.blocks import MlpCnnShift, MorphFC, MorphFCDecay
from vmg_tpu_torch.weights import state_dict_from_jax

import _seq_worker
from _spawn import spawn

NET = dict(depths=(1, 1, 1), traj_res_n=(1, 0, 1))
TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_two_processes_match_jax(tmp_path):
    x = np.random.default_rng(3).random((1, 8, 64, 64, 3), dtype=np.float32)
    jx = jnp.asarray(x)
    model = j_create_model(dataclasses.replace(J_TINY, **NET), is_train=False)
    params = jax.jit(model.init)(jax.random.key(0), jx[:, :2])
    mesh = j_make_mesh((2, 1), jax.devices()[:2])
    want = [np.asarray(j_seq_forward(model, mesh)(replicate(mesh, params), j_shard(mesh, jx)))]
    split = j_create_model(dataclasses.replace(J_TINY, traj_win=(8, None), **NET),
                           is_train=False)
    want.append(np.asarray(jax.jit(split.apply)(params, jx)))
    want.append(np.asarray(jax.jit(lambda p, v: model.apply(p, v, frames_mirror=True))(
        params, jx)))

    state = state_dict_from_jax(params)
    cfg = dataclasses.replace(TINY_TEST_PRESET, **NET)
    cases = [dict(cfg=cfg, state=state, x=torch.from_numpy(x), mirror=False),
             dict(cfg=dataclasses.replace(cfg, traj_win=(8, None)), state=state,
                  x=torch.from_numpy(x), mirror=False),
             dict(cfg=cfg, state=state, x=torch.from_numpy(x), mirror=True)]
    torch.manual_seed(0)
    clip = torch.rand(1, 8, 32, 32, 32)
    clip[:, 4:] = 0.5 + 0.5 * clip[:, 4:]
    for module in (MorphFCDecay(32, 8, 8), MorphFC(32, 8, 8), MlpCnnShift(32)):
        module.eval()
        with torch.no_grad():
            for name, p in module.named_parameters():
                if "reweight" in name:
                    p.mul_(10.0)
            want.append(module(clip).numpy())
        cases.append(dict(module=module, x=clip))
    ranks = spawn(_seq_worker.run, 2, (cases,), str(tmp_path))
    for i, w in enumerate(want):
        got = torch.cat([r[i][0] for r in ranks], dim=1).numpy()
        np.testing.assert_allclose(got, w, err_msg=f"case {i}", **TOL)
    # what crossed: the aligned windows hand no carry over, the split one does
    # (both ways); rank 1 sends rank 0 its first frame for the pair across
    aligned, window = ranks[1][0][1], ranks[1][1][1]
    assert aligned["carry"] == 0 and window["carry"] > 0 and ranks[0][1][1]["carry"] > 0
    assert aligned["halo"] == 64 * 64 * 3 * 4 and aligned["time_sum"] > 0
