"""The trajectory recurrence and its gradients with remat against the JAX
module on its Pallas LTAM path (split from ``tests/test_torch_trajectory.py``,
whose helpers it uses).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vmg_tpu.models import trajectory as jtraj
from vmg_tpu_torch.models import trajectory

from test_torch_trajectory import TOL, _few_torch_threads, _load, _port_params, _run, _x  # noqa: F401


@pytest.mark.parametrize("T,traj_win", [(7, None), (8, 4)])
def test_trajectory_multi_head(rng, T, traj_win):
    B, H, W, C = 1, 8, 12, 16
    x = _x(rng, (B, T, H, W, C))
    ff = _x(rng, (B, T - 1, H, W, 2)) * 2
    fb = _x(rng, (B, T - 1, H, W, 2)) * 2
    jm = jtraj.TrajectoryMultiHead(
        embed_dim=C, num_blocks=2, keyframe_stride=3, head=4, mode="wins",
        r_scaling=0.1, ltam=True, traj_win=traj_win, carry_impl="warped",
        win_impl="pallas", pallas_interpret=True)
    p = jax.jit(jm.init)(jax.random.key(4), *map(jnp.asarray, (x, ff, fb)))
    want = np.asarray(jax.jit(jm.apply)(p, *map(jnp.asarray, (x, ff, fb))))
    m = _load(trajectory.TrajectoryMultiHead(C, num_blocks=2, keyframe_stride=3, head=4,
                                             r_scaling=0.1, traj_win=traj_win),
              p, "encoder_layers0/traj_mixing", "encoder_layers.0.traj_mixing.")
    np.testing.assert_allclose(_run(m, x, ff, fb), want, **TOL)


def test_trajectory_grads_match_jax(rng):
    """TrajectoryMultiHead in training mode with remat (each step
    checkpointed) against ``jax.grad`` of the JAX module on its Pallas
    LTAM path (interpret mode, custom VJP): the gradients of the input, the
    flows (through the bilinear 'border' warps) and every parameter, f32,
    3e-5 -- the pattern of ``tests/test_fused_layouts.py:338-369``."""
    B, T, H, W, C = 1, 5, 6, 8, 16
    x = _x(rng, (B, T, H, W, C))
    ff, fb = _x(rng, (B, T - 1, H, W, 2)), _x(rng, (B, T - 1, H, W, 2))
    jm = jtraj.TrajectoryMultiHead(
        embed_dim=C, num_blocks=1, keyframe_stride=2, head=4, mode="wins",
        r_scaling=0.1, ltam=True, carry_impl="warped", win_impl="pallas",
        pallas_interpret=True, remat=True)
    args = tuple(map(jnp.asarray, (x, ff, fb)))
    p = jax.jit(jm.init)(jax.random.key(18), *args)

    def loss(params, xx, f1, f2):
        return jnp.mean(jm.apply(params, xx, f1, f2) ** 2)

    gp, *gin = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(p, *args)
    m = _load(trajectory.TrajectoryMultiHead(C, num_blocks=1, keyframe_stride=2, head=4,
                                             r_scaling=0.1, remat=True),
              p, "encoder_layers0/traj_mixing", "encoder_layers.0.traj_mixing.").train()
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, ff, fb)]
    (m(*ins) ** 2).mean().backward()
    for t, g, name in zip(ins, gin, ("x", "flows_forward", "flows_backward")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL, err_msg=name)
    wgrads = _port_params(gp, "encoder_layers0/traj_mixing",
                                  "encoder_layers.0.traj_mixing.")
    for name, prm in m.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), wgrads[name].numpy(), **TOL,
                                   err_msg=name)
