"""The port's training slice against ``vmg_tpu.train`` on CPU, float32.

* Three steps of ``make_train_step`` against the JAX steps:
  ``tests/test_torch_train_steps.py`` (the protocol below), which shares
  ``TRAIN`` and ``STEP_NET``.  On ``TINY_TEST_PRESET`` at one TAB and one
  residual block a stage (``STEP_NET``: the JAX step's compile grows with
  the depth; every module of the preset stays; drop_path 0, T=4 so the
  recurrence reaches K=2 keyframe slots, ``if_aux``, remat on, weight
  decay and an active gradient clip), from one JAX init carried across by
  ``state_dict_from_jax``: per-step losses within 1e-5 relative; the first
  gradient norm within 1e-5 relative.  AdamW normalises each element's
  gradient, so an element whose gradient is below its eps (1e-8) and near
  the two frameworks' summation noise moves by a different fraction of the
  step: the final parameters are held to 5e-4 absolute (the JAX package's
  own bound for parameters after AdamW, ``tests/test_train_step.py``; each
  step moves an element by at most ~lr = 1e-3), their difference to 1e-2
  of the distance they moved (in 2-norm), and the later gradient norms to
  1e-3 relative.
* Losses (1e-6), the schedules over steps that cross warmup, a restart
  and the SPyNet freeze (1e-6 relative: JAX evaluates them in float32),
  and three grouped AdamW updates with weight decay and clipping against
  optax from ``build_optimizer`` (1e-6).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from vmg_tpu.ckpt.torch_convert import convert_torch_state_dict, export_torch_state_dict
from vmg_tpu.configs.config import TrainConfig as JTrainConfig
from vmg_tpu.train import loss as jloss
from vmg_tpu.train import schedule as jsched
from vmg_tpu.train.optimizer import build_optimizer, param_labels as j_param_labels
from vmg_tpu_torch.configs import TINY_TEST_PRESET, TrainConfig
from vmg_tpu_torch.models.vmg import create_model
from vmg_tpu_torch.train import loss, optimizer, schedule

TRAIN = dict(lr=1e-3, T_period=(1000,), if_aux=True, weight_decay=0.05,
             if_grad_clip=True, grad_clip_up=0.005)
STEP_NET = dict(drop_path_rate=0.0, depths=(1, 1, 1), traj_res_n=(1, 0, 1))


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; float32 work
    spread over every core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_param_labels_match_jax():
    """The three optimizer groups by state-dict name equal the JAX labels
    of the same parameters."""
    model = create_model(TINY_TEST_PRESET, device="cpu")
    tree = convert_torch_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    want = export_torch_state_dict(j_param_labels(tree["params"]))
    got = optimizer.param_labels(model)
    assert sorted(got) == sorted(want)
    assert {k: str(v) for k, v in want.items()} == got
    assert set(got.values()) == {"spynet", "wd", "main"}


@pytest.mark.parametrize("if_aux", [False, True])
def test_losses_match_jax(rng, if_aux):
    x = rng.random((2, 3, 32, 40, 3), dtype=np.float32)
    y = rng.random((2, 3, 32, 40, 3), dtype=np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(float(loss.charbonnier_loss(tx, ty)),
                               float(jloss.charbonnier_loss(jx, jy)), rtol=1e-6)
    np.testing.assert_allclose(float(loss.edge_loss(tx, ty)),
                               float(jloss.edge_loss(jx, jy)), rtol=1e-6)
    np.testing.assert_allclose(float(loss.total_loss(tx, ty, if_aux=if_aux, aux_ratio=0.3)),
                               float(jloss.total_loss(jx, jy, if_aux=if_aux, aux_ratio=0.3)),
                               rtol=1e-6)


def test_schedules_match_jax():
    """Warmup to step 5, a restart at 20 at half weight, the SPyNet group
    frozen through step flow_fix + 1 = 8; and the linear decay."""
    kw = dict(lr=2e-4, warmup_iter=5, T_period=(20, 30), restarts=(20,),
              restart_weights=(0.5,), eta_min=1e-7, pre_lr_ratio=0.125)
    mine, ref = TrainConfig(**kw), JTrainConfig(**kw)
    pairs = [(schedule.main_lr_schedule(mine), jsched.main_lr_schedule(ref)),
             (schedule.spynet_lr_schedule(mine, 7), jsched.spynet_lr_schedule(ref, 7)),
             (schedule.cosine_annealing_restart(2e-4, (20, 30), (20,), (0.5,), 1e-7),
              jsched.cosine_annealing_restart(2e-4, (20, 30), (20,), (0.5,), 1e-7)),
             (schedule.linear_decay(1e-3, 40, 0.1), jsched.linear_decay(1e-3, 40, 0.1))]
    for a, b in pairs:
        got = np.array([a(s) for s in range(50)])
        want = np.array([float(b(s)) for s in range(50)])
        # JAX evaluates in float32: ~1e-7 of the base rate near a period's end
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-11)
    spy = [schedule.spynet_lr_schedule(mine, 7)(s) for s in range(12)]
    assert spy[:9] == [0.0] * 9 and spy[9] > 0


def _module_from_tree(tree):
    m = torch.nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _module_from_tree(v))
        else:
            m.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    return m


def test_adamw_matches_optax(rng):
    """Three grouped AdamW updates (weight decay on mlp_blocks, global-norm
    clip active, SPyNet frozen for updates 0 and 1 with flow_fix 0) against
    optax from ``build_optimizer`` on the same gradients."""
    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tree = {"spynet": {"basic_module0": {"kernel": arr(3, 4), "bias": arr(4)}},
            "encoder_layers0": {"mlp_blocks0": {"proj": {"kernel": arr(4, 4)}},
                                "local_cnn": {"bias": arr(5)}},
            "input_proj": {"kernel": arr(2, 3)}}
    kw = dict(lr=1e-2, T_period=(10,), weight_decay=0.1, if_grad_clip=True,
              grad_clip_up=0.5, pre_lr_ratio=0.5)
    tx = build_optimizer(tree, JTrainConfig(**kw), flow_fix=0)
    jparams = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jparams)
    model = _module_from_tree(tree)
    opt = optimizer.AdamW(model, TrainConfig(**kw), flow_fix=0)
    names = [n for n, _ in model.named_parameters()]
    for _ in range(3):
        grads = {n: arr(*p.shape) for n, p in model.named_parameters()}
        jgrads = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(grads[".".join(k.key for k in path)]), jparams)
        updates, state = tx.update(jgrads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(grads[n]) for n in names])
        for n, p in model.named_parameters():
            want = jparams
            for k in n.split("."):
                want = want[k]
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-7, err_msg=n)
