"""Data parallelism of the port (``vmg_tpu_torch.parallel``) on the CPU,
after ``tests/test_parallel_mesh.py``.

Two processes of a gloo group (``torch.multiprocessing``, spawned, two
threads each; ``tests/_dp_worker.py``) each take their rows of the global
batch and run ``make_sharded_train_step``; the multihost helpers are
checked inside them.  ``TINY_TEST_PRESET`` at one TAB and one residual
block a stage (``NET``: the JAX step's compile and the processes' CPU time
grow with the depth; every module stays), float32:

* a batch of 2, drop_path 0: the two processes' step equals the
  one-process step on the whole batch and the JAX package's single-device
  step (same JAX init): losses and gradient norms within 1e-5 relative,
  parameters within 5e-4 (``test_torch_train.py``'s bounds for AdamW);
* a batch of 4 with ``grad_acc`` 2 and drop_path 0.1: each process draws
  the global microbatch's stochastic-depth masks and keeps its rows, so
  two processes equal one (the same bounds);
* both processes hold the same parameters after the step.
The mesh refuses a ``tensor`` axis above 1 by name; one process's batch
slice is the whole batch.
"""

import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from vmg_tpu.configs import TINY_TEST_PRESET as J_TINY
from vmg_tpu.configs.config import TrainConfig as JTrainConfig
from vmg_tpu.models import create_model as j_create_model
from vmg_tpu.train import init_train_state, make_train_step as j_make_train_step
from vmg_tpu_torch.configs import TINY_TEST_PRESET, TrainConfig
from vmg_tpu_torch.models.vmg import create_model
from vmg_tpu_torch.parallel import make_mesh, process_local_batch_slice
from vmg_tpu_torch.train.train_step import make_train_step
from vmg_tpu_torch.weights import state_dict_from_jax

import _dp_worker

TRAIN = dict(lr=1e-3, T_period=(1000,), if_aux=True, weight_decay=0.05,
             if_grad_clip=True, grad_clip_up=0.005)
NET = dict(depths=(1, 1, 1), traj_res_n=(1, 0, 1))


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _batch(B, seed):
    rng = np.random.default_rng(seed)
    return {"LRs": torch.from_numpy(rng.random((B, 4, 64, 64, 3), dtype=np.float32)),
            "HRs": torch.from_numpy(rng.random((B, 4, 256, 256, 3), dtype=np.float32))}


def _one_process(case):
    model = create_model(case["cfg"], is_train=True, device="cpu")
    model.load_state_dict(case["state"])
    step = make_train_step(model, TrainConfig(**case["train"]), grad_acc=case["grad_acc"],
                           flow_fix=0)
    m = step({k: case[k] for k in ("LRs", "HRs")}, torch.Generator().manual_seed(case["seed"]))
    return float(m["loss"]), float(m["grad_norm"]), model.state_dict()


def _close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    assert sorted(got[2]) == sorted(want[2])
    for k, v in want[2].items():
        np.testing.assert_allclose(np.asarray(got[2][k]), np.asarray(v), atol=5e-4, rtol=0,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_step():
    """(initial JAX params, batch of 2, loss, grad norm, params) of one JAX
    training step, drop_path 0."""
    model = j_create_model(dataclasses.replace(J_TINY, drop_path_rate=0.0, **NET),
                           is_train=True)
    batch = _batch(2, 0)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    params = jax.jit(model.init)(jax.random.key(0), jbatch["LRs"][:1])
    tcfg = JTrainConfig(niter=1000, **TRAIN)
    state = init_train_state(model, params, tcfg, flow_fix=0)
    state, m = j_make_train_step(model, tcfg, donate=False)(state, jbatch, jax.random.key(0))
    return params, batch, float(m["loss"]), float(m["grad_norm"]), state.params


def test_two_processes_equal_one_and_jax(jax_step, tmp_path):
    params, batch, loss, norm, after = jax_step
    state = state_dict_from_jax(params)
    cases = [dict(cfg=dataclasses.replace(TINY_TEST_PRESET, drop_path_rate=0.0, **NET),
                  state=state, train=TRAIN, grad_acc=1, seed=0, **batch),
             dict(cfg=dataclasses.replace(TINY_TEST_PRESET, **NET), state=state, train=TRAIN,
                  grad_acc=2, seed=5, **_batch(4, 1))]
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_dp_worker.run, args=(r, 2, port, cases, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for case, got0, got1 in zip(cases, *ranks):
        for k, v in got0[2].items():
            torch.testing.assert_close(got1[2][k], v, rtol=0, atol=0)
        _close(got0, _one_process(case))
    # the drop_path-0 case against the JAX package's single-device step
    _close(ranks[0][0], (loss, norm, state_dict_from_jax(after)))


def test_mesh_and_batch_slice_in_one_process():
    mesh = make_mesh((0, 1))
    assert (mesh.data, mesh.tensor, mesh.rank) == (1, 1, 0)
    assert make_mesh((1, 1)) == mesh
    with pytest.raises(NotImplementedError, match="tensor"):
        make_mesh((1, 2))
    with pytest.raises(ValueError, match="data axis"):
        make_mesh((2, 1))
    assert process_local_batch_slice(4) == (4, 0)
