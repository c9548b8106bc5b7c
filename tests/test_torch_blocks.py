"""The port's modules against the JAX modules on their kernel paths (CPU,
fp32, 3e-5).

Each JAX module is initialised on seeded numpy inputs, run with its Pallas
kernels in interpret mode, and its parameters are carried into the port
through ``vmg_tpu_torch.weights`` (the reference state-dict names).  The
port's MorphFC mixer selects the same kernel form as the JAX module for
the shape ('full': axis-branch kernel; 'hybrid': plain axis matmuls and
the reduce kernel).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vmg_tpu.models import blocks as jblocks
from vmg_tpu.models import trajectory as jtraj
from vmg_tpu_torch.models import blocks, trajectory
from vmg_tpu_torch.weights import state_dict_from_jax

TOL = dict(atol=3e-5, rtol=3e-5)


def _port_params(params, path, prefix):
    """Export a JAX sub-module's params under a full-model path and strip
    the matching state-dict prefix."""
    tree = params["params"]
    for key in reversed(path.split("/")):
        tree = {key: tree}
    return state_dict_from_jax(tree, prefix=prefix)


def _load(module, params, path, prefix):
    module.load_state_dict(_port_params(params, path, prefix), strict=True)
    return module.eval()


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _run(module, *args, **kw):
    with torch.no_grad():
        return module(*(torch.from_numpy(a) for a in args), **kw).numpy()


def test_mlp_cnn_grouped(rng):
    x = _x(rng, (1, 2, 10, 12, 16))
    jm = jblocks.MlpCnn(16, exp_r=6.0, n_groups=4, impl="interpret")
    p = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    m = _load(blocks.MlpCnn(16, 6.0, 4), p, "encoder_layers0/mlp_blocks0/channel_mixing",
              "encoder_layers.0.mlp_blocks.0.channel_mixing.")
    np.testing.assert_allclose(_run(m, x), want, **TOL)


@pytest.mark.parametrize("C", [448, 224])
def test_mlp_cnn_eval_takes_the_kernel_at_every_width(rng, monkeypatch, C):
    """In eval, MlpCnn goes through the fused_group_ffn wrapper once at
    every width, FULL_PRESET's stage 3 (C = 448, where the bf16 kernel
    splits the output channels between its warpgroups) included, and
    matches vmg_tpu's MlpCnn(impl='interpret') (groups 4, exp_r 6) within
    TOL."""
    calls = []
    kernel_fn = blocks.fused_group_ffn
    monkeypatch.setattr(blocks, "fused_group_ffn",
                        lambda *a, **kw: calls.append(a[0].shape) or kernel_fn(*a, **kw))
    x = _x(rng, (1, 2, 6, 8, C))
    jm = jblocks.MlpCnn(C, exp_r=6.0, n_groups=4, impl="interpret")
    p = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    m = _load(blocks.MlpCnn(C, 6.0, 4), p, "encoder_layers0/mlp_blocks0/channel_mixing",
              "encoder_layers.0.mlp_blocks.0.channel_mixing.")
    np.testing.assert_allclose(_run(m, x), want, **TOL)
    assert calls == [(2, 6, 8, C)]


# (H, W, C, chunk, with_res): both sides pick 'full' for the first two,
# 'hybrid' for the others (W % chunk != 0; C % chunk != 0, which pads the axis-FC
# channels); H = 18 leaves a partial last H-chunk
MORPH_CASES = [(18, 16, 16, 4, False), (18, 16, 16, 4, True),
               (12, 14, 16, 4, True), (10, 12, 18, 4, True)]


@pytest.mark.parametrize("H,W,C,chunk,with_res", MORPH_CASES)
def test_morphfc_decay(rng, H, W, C, chunk, with_res):
    x, res = _x(rng, (1, 2, H, W, C)), _x(rng, (1, 2, H, W, C))
    jm = jblocks.MorphFCDecay(C, chunk, chunk, channel_mixer="rcab", impl="interpret")
    p = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x))
    kw = dict(residual=jnp.asarray(res), res_scale=0.5) if with_res else {}
    want = np.asarray(jm.apply(p, jnp.asarray(x), **kw))
    m = _load(blocks.MorphFCDecay(C, chunk, chunk), p,
              "encoder_layers0/mlp_blocks0/spatial_mixing",
              "encoder_layers.0.mlp_blocks.0.spatial_mixing.")
    kw = dict(residual=torch.from_numpy(res), res_scale=0.5) if with_res else {}
    np.testing.assert_allclose(_run(m, x, **kw), want, **TOL)


def test_tab(rng):
    x = _x(rng, (1, 2, 12, 14, 16))
    jm = jblocks.TAB(16, 4, 4, mlp_ratio=6.0, n_groups=4, channel_mixer="rcab")
    prev = (jblocks.set_morph_impl("interpret"), jblocks.set_ffn_impl("interpret"))
    try:
        p = jm.init(jax.random.key(2), jnp.asarray(x), True)
        want = np.asarray(jm.apply(p, jnp.asarray(x), True))
    finally:
        jblocks.set_morph_impl(prev[0])
        jblocks.set_ffn_impl(prev[1])
    m = _load(blocks.TAB(16, 4, 4, 6.0, 4), p, "encoder_layers0/mlp_blocks0",
              "encoder_layers.0.mlp_blocks.0.")
    np.testing.assert_allclose(_run(m, x), want, **TOL)


def test_ltam(rng):
    n, K, h, w, C, heads = 2, 3, 8, 12, 16, 4
    curr, anchor = _x(rng, (n, h, w, C)), _x(rng, (n, h, w, C))
    vals = _x(rng, (n, h, w, K, C))
    keys = np.asarray(jtraj._normalize(jnp.asarray(_x(rng, (n, h, w, K, C)))))
    pad = [(0, 0)] * 4 + [(0, 128 - C)]
    kv_tpu = np.stack([np.pad(vals, pad), np.pad(keys, pad)], -2).reshape(n, h, w, -1)
    jm = jtraj.LTAM(C, head=heads, keys_prenormalized=True, presampled=True,
                    pallas_interpret=True)
    args = (jnp.asarray(curr), None, jnp.asarray(anchor), None, None)
    p = jm.init(jax.random.key(3), *args, kv_packed=jnp.asarray(kv_tpu))
    want = np.asarray(jm.apply(p, *args, kv_packed=jnp.asarray(kv_tpu)))
    m = _load(trajectory.LTAM(C, heads), p, "encoder_layers0/traj_mixing/step/LTAM",
              "encoder_layers.0.traj_mixing.LTAM.")
    kv = np.stack([vals, keys], -2).reshape(n, h, w, K * 2 * C)
    np.testing.assert_allclose(_run(m, curr, anchor, kv), want, **TOL)


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


def test_packed_operands_follow_load_and_cast(rng):
    """The kernels' packed weights are rebuilt after load_state_dict and
    after a dtype conversion, not reused from the first forward."""
    x = torch.from_numpy(_x(rng, (1, 2, 8, 8, 16)))
    gen = torch.Generator().manual_seed(5)
    a, b = blocks.TAB(16, 4, 4, 6.0, 4), blocks.TAB(16, 4, 4, 6.0, 4)
    for m in (a, b):
        for p in m.parameters():
            p.data = torch.randn(p.shape, generator=gen) * 0.1
    with torch.no_grad():
        a(x)  # packs a's first weights
        a.load_state_dict(b.state_dict())
        torch.testing.assert_close(a(x), b(x), rtol=0, atol=0)
        a.double()
        assert a.spatial_mixing.operands()["pk"].dtype == torch.float64
        assert all(t.dtype == torch.float64 for t in a.channel_mixing.operands())


@pytest.mark.parametrize("C,groups", [(16, 4), (18, 1)])
def test_tab_training_form_matches_jax_module_path(rng, C, groups):
    """TAB in training mode (drop_path 0) against the JAX TAB at
    ``deterministic=False`` -- the module paths training pins (MorphFCDecay
    fused axis FCs, grouped-conv FFN): output and every gradient, f32.
    C = 18 pads the axis-FC channels to 20."""
    x = _x(rng, (1, 2, 12, 14, C))
    cot = _x(rng, x.shape)
    jm = jblocks.TAB(C, 4, 4, mlp_ratio=6.0, n_groups=groups, channel_mixer="rcab")
    p = jax.jit(jm.init, static_argnums=2)(jax.random.key(2), jnp.asarray(x), True)

    def f(params, xx):
        return jnp.sum(jm.apply(params, xx, False) * cot)

    want = np.asarray(jm.apply(p, jnp.asarray(x), False))
    gp, gx = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(x))
    m = _load(blocks.TAB(C, 4, 4, 6.0, groups), p, "encoder_layers0/mlp_blocks0",
              "encoder_layers.0.mlp_blocks.0.").train()
    xt = torch.from_numpy(x).requires_grad_()
    out = m(xt)
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    wgrads = _port_params(gp, "encoder_layers0/mlp_blocks0",
                                  "encoder_layers.0.mlp_blocks.0.")
    for name, prm in m.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), wgrads[name].numpy(), **TOL,
                                   err_msg=name)


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

    gp, *gin = jax.grad(loss, argnums=(0, 1, 2, 3))(p, *args)
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


# ---- the opt-in kernel forms (conv chain, layout pin) against the JAX
# package's Pallas forms in interpret mode, 1e-5 (the JAX tests' own
# tolerance for these modules, tests/test_conv_chain.py)

KTOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("H,W,C", [(12, 16, 24), (13, 10, 16)])
def test_rcab_kernel_form_matches_jax(rng, H, W, C):
    """RCAB's conv-chain form (both convs and the attention's pool sums in
    one pass) against the JAX RCAB at ``impl='interpret'``; C = 24 pads
    the bf16 taps, 13 rows leave a partial row block on the JAX side."""
    x = _x(rng, (1, 2, H, W, C)) * 0.1
    jm = jblocks.RCAB(C, impl="interpret")
    p = jm.init(jax.random.key(6), jnp.asarray(x))
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    m = _load(blocks.RCAB(C), p, "encoder_layers0/mlp_blocks0/spatial_mixing/mlp_c",
              "encoder_layers.0.mlp_blocks.0.spatial_mixing.mlp_c.")
    np.testing.assert_allclose(_run(m, x, kernel=True), want, **KTOL)
    np.testing.assert_allclose(_run(m, x), want, **KTOL)


def test_resblock_kernel_form_matches_jax(rng):
    x = _x(rng, (2, 12, 16, 24)) * 0.1
    jm = jtraj.ResidualBlockNoBN(24, res_scale=0.1, impl="interpret")
    p = jm.init(jax.random.key(7), jnp.asarray(x))
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    m = _load(trajectory.ResidualBlockNoBN(24, 0.1), p,
              "encoder_layers0/traj_mixing/step/resblocks/block0",
              "encoder_layers.0.traj_mixing.resblocks.main.2.0.")
    np.testing.assert_allclose(_run(m, x, kernel=True), want, **KTOL)


@pytest.mark.parametrize("H,W,C,chunk", [(18, 16, 16, 4), (16, 24, 32, 8)])
def test_morphfc_decay_rcab_kernel_form(rng, H, W, C, chunk):
    """The 'full' mixer with ``rcab_impl="kernel"`` against the JAX mixer,
    whose 'full' form (interpret) always runs the RCAB chain kernel."""
    x, res = _x(rng, (1, 2, H, W, C)), _x(rng, (1, 2, H, W, C))
    jm = jblocks.MorphFCDecay(C, chunk, chunk, channel_mixer="rcab", impl="interpret")
    p = jax.jit(jm.init)(jax.random.key(1), jnp.asarray(x))
    want = np.asarray(jm.apply(p, jnp.asarray(x), residual=jnp.asarray(res), res_scale=0.5))
    m = _load(blocks.MorphFCDecay(C, chunk, chunk, rcab_impl="kernel"), p,
              "encoder_layers0/mlp_blocks0/spatial_mixing",
              "encoder_layers.0.mlp_blocks.0.spatial_mixing.")
    assert m.full_form(W)
    np.testing.assert_allclose(_run(m, x, residual=torch.from_numpy(res), res_scale=0.5),
                               want, **TOL)


@pytest.mark.parametrize("impl", ["kernel", "barrier", "barrier_out"])
def test_trajectory_conv_forms_match_jax(rng, impl):
    """TrajectoryMultiHead with each ``traj_conv_impl`` against the JAX
    module at ``conv_impl='interpret'`` (the chain kernel in every step),
    3e-5.  JAX's layout pin has no interpret mode; the pin is the
    identity, so the barrier forms are held against the same output."""
    B, T, H, W, C = 1, 5, 8, 12, 16
    x = _x(rng, (B, T, H, W, C))
    ff, fb = _x(rng, (B, T - 1, H, W, 2)) * 2, _x(rng, (B, T - 1, H, W, 2)) * 2
    jm = jtraj.TrajectoryMultiHead(
        embed_dim=C, num_blocks=2, keyframe_stride=2, head=4, mode="wins",
        r_scaling=0.1, ltam=True, carry_impl="warped", win_impl="pallas",
        pallas_interpret=True, conv_impl="interpret")
    args = tuple(map(jnp.asarray, (x, ff, fb)))
    p = jax.jit(jm.init)(jax.random.key(8), *args)
    want = np.asarray(jax.jit(jm.apply)(p, *args))
    m = _load(trajectory.TrajectoryMultiHead(C, num_blocks=2, keyframe_stride=2, head=4,
                                             r_scaling=0.1, traj_conv_impl=impl),
              p, "encoder_layers0/traj_mixing", "encoder_layers.0.traj_mixing.")
    np.testing.assert_allclose(_run(m, x, ff, fb), want, **TOL)


def test_kernel_form_weights_carry_across_strict(rng):
    """A JAX tree initialised with the kernel impls (RCAB / resblock params
    made by the kernel path's param-only twins) has the module path's
    structure and loads, key for key and value for value, into the port's
    modules built with the kernel forms (``strict=True``)."""
    x = _x(rng, (1, 2, 8, 8, 16))
    for jk, jx, path, prefix, port in (
            (jblocks.RCAB(16, impl="interpret"), jblocks.RCAB(16, impl="xla"),
             "encoder_layers0/mlp_blocks0/spatial_mixing/mlp_c",
             "encoder_layers.0.mlp_blocks.0.spatial_mixing.mlp_c.", blocks.RCAB(16)),
            (jtraj.ResidualBlockNoBN(16, impl="interpret"), jtraj.ResidualBlockNoBN(16),
             "encoder_layers0/traj_mixing/step/resblocks/block0",
             "encoder_layers.0.traj_mixing.resblocks.main.2.0.",
             trajectory.ResidualBlockNoBN(16))):
        xin = jnp.asarray(x if isinstance(jk, jblocks.RCAB) else x[0])
        pk = jk.init(jax.random.key(9), xin)
        px = jx.init(jax.random.key(9), xin)
        assert jax.tree.structure(pk) == jax.tree.structure(px)
        sd = _port_params(pk, path, prefix)
        port.load_state_dict(sd, strict=True)
        for k, v in port.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    m = trajectory.TrajectoryMultiHead(16, num_blocks=2, traj_conv_impl="kernel")
    assert sorted(m.state_dict()) == sorted(
        trajectory.TrajectoryMultiHead(16, num_blocks=2).state_dict())
