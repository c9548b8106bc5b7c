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


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch at full
    width in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


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


# ---- the opt-in kernel forms (conv chain, layout pin) against the JAX
# package's Pallas forms in interpret mode, 1e-5 (the JAX tests' own
# tolerance for these modules, tests/test_conv_chain.py)

KTOL = dict(atol=1e-5, rtol=1e-5)


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
