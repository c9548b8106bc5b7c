"""Whole-model forwards of ``VMGNetworkConfig`` values beyond the full
preset, the port against ``vmg_tpu.create_model`` (CPU, float32, seeded
1x3x64x64 clips: T = 3 exercises the swin3d tail's mirror extension), and
one training step of a variant against ``vmg_tpu``'s loss and gradients.

Tolerances: the whole-model golden's ``atol=2e-4, rtol=1e-3`` on the
output and 2e-5 on the network's own contribution (the output minus the
trilinear residual), as ``tests/test_torch_model.py``; the training loss
and the gradients' global norm within 1e-5 relative (as
``tests/test_torch_train.py`` holds them), each gradient checked held
within 1e-3 of its largest element (its elements are sums over the clip
in other orders: the depthwise conv's, ~1e-5 at most, differ by ~2.5e-4
of that).
"""

import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vmg_tpu.ckpt.torch_convert import convert_torch_state_dict, export_torch_state_dict
from vmg_tpu.configs import VMGNetworkConfig as JConfig
from vmg_tpu.models import create_model as j_create_model
import vmg_tpu_torch
from vmg_tpu_torch.ckpt.torch_convert import export_torch_state_dict as export_port
from vmg_tpu_torch.configs import VMGNetworkConfig
from vmg_tpu_torch.models.vmg import check_supported
from vmg_tpu_torch.ops.resize import upsample_trilinear_frames
from vmg_tpu_torch.weights import state_dict_from_jax

SMALL = dict(embed_dim=(16, 16, 16), depths=(1, 1, 1), num_heads=(2, 2, 2), num_frames=4,
             window_sizes=((2, 4, 4),) * 3, mlp_ratio=2.0, traj_win=(4, None),
             traj_keyframes_n=(2, None), traj_heads=(2, None), traj_res_n=(1, 1, 1),
             deform_groups=(2, 4, 2), max_res_scale=(1, 2, 1), image_size=(32, 32),
             chunk_ratios=(0.25, 0.25))
CONFIGS = {
    # the tails of tests/test_model_forward.py (32 wide there)
    "swin3d_tail": dict(SMALL, temporal_type=(None, None), temporal_empty=False),
    "dcn_tail": dict(SMALL, temporal_type=(True, None)),
    # every other switch of the decay mixer, the trajectory and the model
    "switches": dict(SMALL, temporal_type=(False, True), non_linear=False, qkv_bias=False,
                     if_symm=False, relu_scale_norm=True, channel_mixer="vanilla",
                     ffn_type="irffn_single", traj_mode="max", traj_scale=False, back_RBs=1,
                     if_local_fuse=False, flow_smooth=False),
    # seven stages without a flow network (3D window attention at every
    # stage), without the multi-scale shortcuts, with concatenated skips,
    # MBConv and plain MorphFC mixers and the shift FFN
    "seven_stage": dict(
        SMALL, embed_dim=(8, 16, 16, 16, 16, 16, 8), depths=(1,) * 7,
        num_heads=(2,) * 7, window_sizes=((2, 4, 4),) * 7, traj_win=(4, None, None, None),
        traj_keyframes_n=(2, None, None, None), traj_heads=(2, None, None, None),
        temporal_type=(None,) * 4, temporal_empty=False, spynet=None,
        traj_res_n=(1,) * 7, deform_groups=(2,) * 4, max_res_scale=(1,) * 4,
        chunk_ratios=(0.125, 0.25, 0.25, 0.25), mixer_type=("mbconv", "mlps", "mlps", "mlps"),
        mixer_n=(2, None, None, None), ret_decay=False, use_mdsc=False, if_concat=True,
        ffn_type="ffn_cnn_shift"),
    # the training step's: no flow network, an MBConv and a gate-free mixer
    "no_flow": dict(SMALL, spynet=None, temporal_type=(None, None), temporal_empty=False,
                    mixer_type=("mbconv", "mlps"), mixer_n=(1, None), ffn_type="vanilla",
                    gating=False, relu_scale=False),
}


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch at full
    width in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _keys(cfg):
    return dict(non_linear=cfg["non_linear"] if "non_linear" in cfg else True,
                channel_mixer=cfg.get("channel_mixer", "rcab"))


def _jax_params(model):
    """The port's seeded init, every parameter perturbed so that the
    zero-initialised ones (the DCN's offset head, biases) take part, as a
    JAX param tree: the reference converter, and the MBConv mixer's convs
    (which it has no rule for) by hand."""
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    mb = re.compile(r"^(\w+)_layers\.(\d+)\.mlp_blocks\.(\d+)\.spatial_mixing\.block(\d+)\."
                    r"(pw|dw|pw_linear)\.(weight|bias)$")
    params = convert_torch_state_dict({k: v for k, v in sd.items() if not mb.match(k)})
    for k, v in sd.items():
        m = mb.match(k)
        if m:
            node = params["params"].setdefault(f"{m[1]}_layers{m[2]}", {})
            for key in (f"mlp_blocks{m[3]}", "spatial_mixing", f"block{m[4]}", m[5]):
                node = node.setdefault(key, {})
            node["kernel" if m[6] == "weight" else "bias"] = (
                v.transpose(2, 3, 1, 0) if m[6] == "weight" else v)
    return jax.tree.map(jnp.asarray, params)


def check_forward(name):
    """The port's forward of ``CONFIGS[name]`` against ``vmg_tpu``'s."""
    cfg = CONFIGS[name]
    x = np.random.default_rng(1).random((1, 3, 64, 64, 3)).astype(np.float32)
    port_cfg = VMGNetworkConfig(**cfg)
    check_supported(port_cfg)
    model = vmg_tpu_torch.create_model(port_cfg, device="cpu",
                                       generator=torch.Generator().manual_seed(0))
    params = _jax_params(model)
    jm = j_create_model(JConfig(**cfg), is_train=False)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    sd = state_dict_from_jax(params, **_keys(cfg))
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 3, 256, 256, 3)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    up = upsample_trilinear_frames(torch.from_numpy(x), 4).numpy()
    assert np.abs(want - up).max() > 1e-2  # the network part is not negligible
    np.testing.assert_allclose(got - up, want - up, atol=2e-5)
    if name in ("dcn_tail", "switches"):
        # the JAX package's reference export names every parameter as the
        # port does (it has no rule for the MBConv mixer and the swin3d
        # tail's MLP), and the port's export writes them
        assert sorted(export_torch_state_dict(params, **_keys(cfg))) == sorted(sd)
        assert sorted(export_port(model.state_dict(), **_keys(cfg))) == sorted(sd)


@pytest.mark.parametrize("name", ["swin3d_tail", "dcn_tail", "switches"])
def test_variant_forward_matches_jax(name):
    check_forward(name)

