"""The port's modules beyond the full preset's configuration, each against
its ``vmg_tpu`` counterpart (CPU, float32, seeded numpy inputs, the JAX
module's parameters carried into the port through
``vmg_tpu_torch.weights``): the 3D window ops and the swin3d tail, the
modulated deformable convolution, the FFN zoo, the MBConv and plain
MorphFC mixers and MorphFCDecay's switches (the axes op's new forms and
the trajectory's switches: ``tests/test_torch_variants_traj.py``).

Tolerances: ``TOL`` (3e-5, as ``tests/test_torch_blocks.py``) where the
JAX op runs a Pallas kernel in interpret mode or a module of the
reference's form; 1e-5 relative for the pure tensor ops; the deformable
convolution's properties at ``tests/test_ops_deform_decay.py``'s 2e-4 /
1e-4 against torch's conv2d.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as TF
import jax
import jax.numpy as jnp

from vmg_tpu.models import blocks as jblocks
from vmg_tpu.models import swin3d as jswin
from vmg_tpu.ops import deform as jdeform
from vmg_tpu.ops import window as jwindow
import vmg_tpu_torch
from vmg_tpu_torch.configs import VMGNetworkConfig
from vmg_tpu_torch.models import blocks, swin3d
from vmg_tpu_torch.models.vmg import check_supported
from vmg_tpu_torch.ops import deform, window
from vmg_tpu_torch.weights import state_dict_from_jax

from test_torch_variants_model import CONFIGS, SMALL

TOL = dict(atol=3e-5, rtol=3e-5)
STAGE = "encoder_layers0/mlp_blocks0/"
PREFIX = "encoder_layers.0.mlp_blocks.0."


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch at full
    width in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _load(module, params, path, prefix, **keys):
    """Carry a JAX sub-module's params (at ``path`` of a full model) into
    ``module`` (its state-dict ``prefix``), strict."""
    tree = params["params"]
    for key in reversed(path.split("/")):
        tree = {key: tree}
    module.load_state_dict(state_dict_from_jax(tree, prefix=prefix, **keys), strict=True)
    return module.eval()


def _perturb(params, rng, scale=0.05):
    """Every leaf plus seeded noise: zero-initialised weights and biases
    (the DCN's offset head, biases) take part in the comparison."""
    return jax.tree.map(lambda v: v + scale * rng.standard_normal(v.shape).astype(v.dtype),
                        params)


def _run(module, *args, **kw):
    with torch.no_grad():
        return module(*(torch.from_numpy(a) for a in args), **kw).numpy()


# ---------------------------------------------------------------------------
# window ops and the swin3d tail


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 2, 2)])
def test_window_ops_match_jax(rng, shift):
    x = _x(rng, (2, 4, 8, 12, 5))
    ws = (2, 4, 4)
    got = window.window_partition_3d(torch.from_numpy(x), ws)
    want = np.asarray(jwindow.window_partition_3d(jnp.asarray(x), ws))
    np.testing.assert_array_equal(got.numpy(), want)
    back = window.window_reverse_3d(got, ws, 2, 4, 8, 12)
    np.testing.assert_array_equal(back.numpy(), x)
    for size in ((4, 8, 12), (1, 3, 12)):
        assert window.get_window_size(size, ws, shift) == \
            jwindow.get_window_size(size, ws, shift)
    np.testing.assert_array_equal(
        window.compute_shift_mask_3d(4, 8, 12, ws, shift).numpy(),
        np.asarray(jwindow.compute_shift_mask_3d(4, 8, 12, ws, shift)))


@pytest.mark.parametrize("unfold,flows", [(False, False), (True, True)])
def test_encoder_block_matches_jax(rng, unfold, flows):
    """The shifted block (a partial window at H = 10, W = 12) with and
    without the unfold-KV branch and the flow-aligned residual."""
    B, D, H, W, C = 1, 4, 10, 12, 16
    x = _x(rng, (B, D, H, W, C))
    ff, fb = _x(rng, (B, D // 2, H, W, 2)), _x(rng, (B, D // 2, H, W, 2))
    jm = jswin.EncoderBlockOnOnetoken(C, 2, (2, 4, 4), (1, 2, 2), 2.0, if_unfold=unfold)
    fkw = dict(flow_f=jnp.asarray(ff), flow_b=jnp.asarray(fb)) if flows else {}
    p = _perturb(jm.init(jax.random.key(0), jnp.asarray(x), True, **fkw), rng)
    want = np.asarray(jm.apply(p, jnp.asarray(x), True, **fkw))
    m = _load(swin3d.EncoderBlockOnOnetoken(C, 2, (2, 4, 4), (1, 2, 2), 2.0, if_unfold=unfold),
              p, "encoder_layers0/traj_mixing/blocks0", "encoder_layers.0.traj_mixing.blocks.0.")
    tkw = dict(flow_f=torch.from_numpy(ff), flow_b=torch.from_numpy(fb)) if flows else {}
    np.testing.assert_allclose(_run(m, x, **tkw), want, **TOL)


# ---------------------------------------------------------------------------
# modulated deformable convolution


def test_deform_conv_matches_jax(rng):
    n, h, w, cin, cout, g = 2, 9, 11, 8, 6, 4
    args = (_x(rng, (n, h, w, cin)), 3 * _x(rng, (n, h, w, g, 9, 2)),
            rng.random((n, h, w, g, 9)).astype(np.float32), _x(rng, (9, cin, cout)) * 0.2,
            _x(rng, (cout,)))
    want = np.asarray(jdeform.modulated_deform_conv2d(*map(jnp.asarray, args)))
    got = deform.modulated_deform_conv2d(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["zero_offset", "integer_offset", "zero_mask"])
def test_deform_conv_properties(rng, case):
    """The three identities of ``tests/test_ops_deform_decay.py``: offset 0
    and mask 1 is a 3x3 conv; dx = +1 on every tap is the conv of the image
    shifted left (interior); mask 0 leaves the bias."""
    n, h, w, cin, cout, g = 2, 10, 12, 8, 6, 4
    x = _x(rng, (n, h, w, cin))
    wt = _x(rng, (cout, cin, 3, 3)) * 0.2
    b = _x(rng, (cout,))
    offset = np.zeros((n, h, w, g, 9, 2), np.float32)
    mask = np.ones((n, h, w, g, 9), np.float32)
    if case == "integer_offset":
        offset[..., 1] = 1.0
    if case == "zero_mask":
        mask[:] = 0.0
    w_ours = wt.transpose(2, 3, 1, 0).reshape(9, cin, cout)
    got = deform.modulated_deform_conv2d(*map(torch.from_numpy, (x, offset, mask, w_ours, b)))
    got = got.numpy()
    if case == "zero_mask":
        np.testing.assert_allclose(got, np.broadcast_to(b, got.shape), atol=1e-5)
        return
    src = x
    if case == "integer_offset":
        src = np.zeros_like(x)
        src[:, :, :-1] = x[:, :, 1:]
    want = TF.conv2d(torch.from_numpy(src).permute(0, 3, 1, 2), torch.from_numpy(wt),
                     torch.from_numpy(b), padding=1).permute(0, 2, 3, 1).numpy()
    if case == "integer_offset":
        got, want = got[:, 1:-1, 1:-2], want[:, 1:-1, 1:-2]
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the FFN zoo and the MBConv mixer

FFN_ZOO = ["vanilla", "ffn_cnn_shift", "irffn_single", "irffn_multi"]


@pytest.mark.parametrize("ffn_type", FFN_ZOO)
def test_ffn_zoo_matches_jax(rng, ffn_type):
    x = _x(rng, (1, 2, 6, 7, 16))
    jm = jblocks.make_ffn(ffn_type, 16, 2.0, 1, name=None)
    p = _perturb(jm.init(jax.random.key(2), jnp.asarray(x)), rng)
    want = np.asarray(jm.apply(p, jnp.asarray(x)))
    m = _load(blocks.make_ffn(ffn_type, 16, 2.0, 1), p, STAGE + "channel_mixing",
              PREFIX + "channel_mixing.")
    np.testing.assert_allclose(_run(m, x), want, **TOL)
    with pytest.raises(ValueError, match="ffn_type"):
        blocks.make_ffn("geglu", 16, 2.0, 1)


def test_geglu_and_patch_shift_match_jax(rng):
    x = _x(rng, (1, 2, 5, 6, 16))
    jm = jblocks.MlpGEGLU(16, 24)
    p = _perturb(jm.init(jax.random.key(3), jnp.asarray(x)), rng)
    m = _load(blocks.MlpGEGLU(16, 24), p, STAGE + "channel_mixing", PREFIX + "channel_mixing.")
    np.testing.assert_allclose(_run(m, x), np.asarray(jm.apply(p, jnp.asarray(x))), **TOL)
    for inv in (False, True):
        want = jblocks.PatchShift2D(inv=inv).apply({}, jnp.asarray(x))
        np.testing.assert_array_equal(
            blocks.patch_shift_2d(torch.from_numpy(x), inv).numpy(), np.asarray(want))


def test_multi_mbconv_matches_jax(rng):
    x = _x(rng, (1, 2, 6, 7, 8))
    jm = jblocks.MultiMBConv(8, num_blocks=2)
    p = _perturb(jm.init(jax.random.key(4), jnp.asarray(x)), rng)
    m = _load(blocks.MultiMBConv(8, num_blocks=2), p, STAGE + "spatial_mixing",
              PREFIX + "spatial_mixing.")
    np.testing.assert_allclose(_run(m, x), np.asarray(jm.apply(p, jnp.asarray(x))), **TOL)


# ---------------------------------------------------------------------------
# MorphFC, MorphFCDecay's switches and the axes op's forms


@pytest.mark.parametrize("fused,bias", [(True, True), (False, False)])
def test_morphfc_matches_jax(rng, fused, bias):
    """``ret_decay=False``: both JAX formulations (``morph_fused``) against
    the port's token form, C = 18 padding the chunks' channels."""
    x = _x(rng, (1, 2, 9, 10, 18))
    jm = jblocks.MorphFC(18, 4, 4, qkv_bias=bias, fused=fused)
    p = _perturb(jm.init(jax.random.key(5), jnp.asarray(x)), rng)
    m = _load(blocks.MorphFC(18, 4, 4, bias, wrap=False), p, STAGE + "spatial_mixing",
              PREFIX + "spatial_mixing.", non_linear=False)
    np.testing.assert_allclose(_run(m, x), np.asarray(jm.apply(p, jnp.asarray(x))), **TOL)


# (kwargs of both modules, W): the first two take the kernels ('full', then
# 'hybrid' at W % chunk != 0) in the linear, bias-free form; the rest the
# module form (no gate, the silu gate, a gelu / swish symmetric gate, no
# scaling, the RMSNorm scaling in the unfused form)
DECAY_CASES = [
    (dict(non_linear=False, qkv_bias=False, channel_mixer="vanilla"), 16),
    (dict(non_linear=False, qkv_bias=False, symm_act="relu"), 14),
    (dict(gating=False, channel_mixer="vanilla"), 16),
    (dict(symm=False, non_linear=False), 16),
    (dict(symm_act="gelu", relu_scale=False, qkv_bias=False), 16),
    (dict(symm_act="swish", relu_scale_norm=True, channel_mixer="vanilla"), 14),
]


@pytest.mark.parametrize("kw,W", DECAY_CASES)
def test_morphfc_decay_switches_match_jax(rng, monkeypatch, kw, W):
    """Eval with the folded residual, as the TAB calls it: the JAX module on
    its Pallas route in interpret mode where ``_pallas_mode`` sends it
    there, else its module path; the port routes alike (the kernel
    wrappers' calls counted)."""
    calls = []
    for name in ("fused_morphfc_axes", "fused_morphfc_reduce", "fused_morphfc_combine"):
        fn = getattr(blocks, name)
        monkeypatch.setattr(blocks, name,
                            lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    C, chunk = 16, 4
    x, res = _x(rng, (1, 2, 12, W, C)), _x(rng, (1, 2, 12, W, C))
    jkw = dict(dict(channel_mixer="rcab"), **kw)
    jm = jblocks.MorphFCDecay(C, chunk, chunk, impl="interpret", **jkw)
    mode = jm._pallas_mode(jnp.asarray(x), "interpret")
    p = _perturb(jm.init(jax.random.key(6), jnp.asarray(x)), rng)
    want = np.asarray(jm.apply(p, jnp.asarray(x), residual=jnp.asarray(res), res_scale=0.5))
    m = _load(blocks.MorphFCDecay(C, chunk, chunk, **jkw), p, STAGE + "spatial_mixing",
              PREFIX + "spatial_mixing.", non_linear=kw.get("non_linear", True),
              channel_mixer=jkw["channel_mixer"])
    got = _run(m, x, residual=torch.from_numpy(res), res_scale=0.5)
    np.testing.assert_allclose(got, want, **TOL)
    assert m.kernel_mode(W) == mode
    expect = {"full": ["fused_morphfc_axes", "fused_morphfc_combine"],
              "hybrid": ["fused_morphfc_reduce", "fused_morphfc_combine"], None: []}[mode]
    assert calls == expect


def test_only_what_jax_cannot_run_is_refused():
    """``check_supported`` refuses a tail that needs flows without a flow
    network (the JAX model fails there too) and nothing of the switches."""
    with pytest.raises(NotImplementedError, match="spynet=None"):
        check_supported(VMGNetworkConfig(**dict(SMALL, spynet=None,
                                                temporal_type=(True, None))))
    for cfg in CONFIGS.values():
        check_supported(VMGNetworkConfig(**cfg))
    with pytest.raises(ValueError, match="mixer_type"):
        vmg_tpu_torch.create_model(
            VMGNetworkConfig(**dict(SMALL, mixer_type=("conv", "mlps"))), device="cpu")
