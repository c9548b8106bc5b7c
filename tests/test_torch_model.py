"""The whole serving forward of the port against ``vmg_tpu.create_model``.

The 7-stage U-Net of ``tests/test_golden_reference.py``'s mdsc golden
(trajectory tails at stages 0 and 6), with the grouped FFN (n_groups=4) of
the full preset, on a seeded 1x4x64x64 clip, fp32 on CPU.  The weights
are the port's seeded init carried into a JAX param tree by the
reference converter (faster than a jitted flax init), and back into the
port through ``vmg_tpu_torch.weights``.  Tolerance: that
golden's ``atol=2e-4, rtol=1e-3``; the network's own contribution (the
output minus the trilinear residual) is also held to 2e-5.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vmg_tpu.ckpt.torch_convert import convert_torch_state_dict, export_torch_state_dict
from vmg_tpu.configs import FEW_LEVELS_PRESET as J_FEW, FULL_PRESET as J_FULL
from vmg_tpu.configs import TINY_TEST_PRESET as J_TINY
from vmg_tpu.configs import VMGNetworkConfig as JConfig
from vmg_tpu.models import create_model as j_create_model
import vmg_tpu_torch
from vmg_tpu_torch.configs import (FEW_LEVELS_PRESET, FULL_PRESET, TINY_TEST_PRESET,
                                   VMGNetworkConfig)
from vmg_tpu_torch.models.vmg import check_supported
from vmg_tpu_torch.ops.resize import upsample_trilinear_frames
from vmg_tpu_torch.serve import SRServer
from vmg_tpu_torch.weights import state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEVEN_STAGE = dict(
    embed_dim=(16, 32, 32, 64, 32, 32, 16), depths=(1,) * 7,
    num_heads=(2, 2, 2, 4, 2, 2, 2), num_frames=4,
    window_sizes=((2, 4, 4),) * 7, mlp_ratio=2.0, n_groups=4,
    traj_win=(4, None, None, None), traj_keyframes_n=(2, None, None, None),
    traj_heads=(2, None, None, None), temporal_type=(False, None, None, None),
    temporal_empty=True, traj_res_n=(2, 0, 0, 0, 0, 0, 2),
    deform_groups=(4, 8, 8, 16), max_res_scale=(1, 2, 2, 4),
    spatial_type=(False,) * 4, use_mdsc=True, mixer_type=("mlps",) * 4,
    mixer_n=(None,) * 4, r_scaling=0.1,
    chunk_ratios=(0.125, 0.25, 0.1875, 0.125), if_local_fuse=True,
    channel_mixer="rcab", image_size=(64, 64),
)


@pytest.fixture(scope="module")
def seven_stage():
    """(JAX params, input clip, JAX output)."""
    port = vmg_tpu_torch.create_model(VMGNetworkConfig(**SEVEN_STAGE), device="cpu",
                                      generator=torch.Generator().manual_seed(0))
    params = convert_torch_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, strict=True)
    params = jax.tree.map(jnp.asarray, params)
    model = j_create_model(JConfig(**SEVEN_STAGE), is_train=False)
    x = np.random.default_rng(1).random((1, 4, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x)))
    return params, x, want


def test_slice_matches_jax(seven_stage):
    params, x, want = seven_stage
    model = vmg_tpu_torch.create_model(VMGNetworkConfig(**SEVEN_STAGE), device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 4, 256, 256, 3)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    up = upsample_trilinear_frames(torch.from_numpy(x), 4).numpy()
    assert np.abs(want - up).max() > 1e-2  # the network part is not negligible
    np.testing.assert_allclose(got - up, want - up, atol=2e-5)


@pytest.mark.parametrize("traj_conv_impl", ["kernel", "barrier", "barrier_out"])
def test_kernel_forms_match_jax(seven_stage, traj_conv_impl):
    """The 7-stage model with every opt-in kernel form on (the RCAB chain in
    the 'full' mixers, the trajectory conv form, the fused norm) against
    ``vmg_tpu``'s forward, f32, at the golden's tolerances.  The forms are
    the same functions as the module forms; f32 norms keep the exact path,
    as in JAX.  (JAX's layout pin has no interpret mode, so the barrier
    forms are held against the default JAX forward, the same function.)"""
    params, x, want = seven_stage
    model = vmg_tpu_torch.create_model(VMGNetworkConfig(**SEVEN_STAGE), device="cpu",
                                       rcab_impl="kernel", norm_impl="kernel",
                                       traj_conv_impl=traj_conv_impl)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    up = upsample_trilinear_frames(torch.from_numpy(x), 4).numpy()
    np.testing.assert_allclose(got - up, want - up, atol=2e-5)


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(a[0].dtype)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_kernel_form_selection_rules(monkeypatch):
    """Where each form applies, as in JAX: the RCAB chain only inside the
    'full' mixers (stages 0, 1, 3, 5, 6 of the 7-stage config) and only in
    eval; the trajectory chain in every step's blocks (2 stages x 2
    directions x 4 steps x 2 blocks), eval only; the fused norm on bf16
    inputs only (2 per TAB + 6 resamplers), in eval and in training; the
    barrier forms pin once per step; the defaults launch none of them."""
    from vmg_tpu_torch.models import blocks, norms, trajectory
    from vmg_tpu_torch.models.vmg import KERNEL_FORMS

    rcab = _count_calls(monkeypatch, blocks, "fused_conv_chain")
    chain = _count_calls(monkeypatch, trajectory, "fused_conv_chain")
    pins = _count_calls(monkeypatch, trajectory, "layout_pin")
    norm = _count_calls(monkeypatch, norms, "fused_norm")
    cfg = VMGNetworkConfig(**SEVEN_STAGE)
    x = torch.from_numpy(np.random.default_rng(1).random((1, 4, 64, 64, 3), dtype=np.float32))
    gen = torch.Generator().manual_seed(0)

    def run(dtype=torch.float32, train=False, **forms):
        for c in (rcab, chain, pins, norm):
            c.clear()
        model = vmg_tpu_torch.create_model(cfg, device="cpu", dtype=dtype, is_train=train,
                                           generator=gen, **forms)
        with torch.set_grad_enabled(train):
            model(x)
        return len(rcab), len(chain), len(pins), len(norm)

    assert run() == (0, 0, 0, 0)
    assert run(**KERNEL_FORMS) == (5, 32, 0, 0)
    assert run(torch.bfloat16, **KERNEL_FORMS) == (5, 32, 0, 20)
    assert set(rcab + chain + norm) == {torch.bfloat16}
    assert run(torch.bfloat16, train=True, **KERNEL_FORMS) == (0, 0, 0, 20)
    assert run(traj_conv_impl="barrier") == (0, 0, 16, 0)
    assert run(traj_conv_impl="barrier_out") == (0, 0, 16, 0)
    with pytest.raises(ValueError, match="traj_conv_impl"):
        vmg_tpu_torch.create_model(cfg, device="cpu", traj_conv_impl="pallas")


def test_weights_follow_reference_export(seven_stage):
    """state_dict_from_jax == export_torch_state_dict, key for key and value
    for value, and it fills every parameter of the port's model."""
    params = seven_stage[0]
    sd = state_dict_from_jax(params)
    ref = export_torch_state_dict(params, channel_mixer="rcab")
    assert sorted(sd) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v, np.float32))
    model = vmg_tpu_torch.create_model(VMGNetworkConfig(**SEVEN_STAGE), device="cpu")
    assert sorted(model.state_dict()) == sorted(sd)
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == tuple(sd[k].shape), k


@pytest.mark.parametrize("name", ["FULL_PRESET", "TINY_TEST_PRESET", "FEW_LEVELS_PRESET"])
def test_config_fields_match_jax(name):
    """Each preset equals ``vmg_tpu``'s field by field, and the ported slice
    takes it (``check_supported``: the few-levels preset's LTAM head width
    36 and FFN groups 1 included)."""
    mine = {"FULL_PRESET": FULL_PRESET, "TINY_TEST_PRESET": TINY_TEST_PRESET,
            "FEW_LEVELS_PRESET": FEW_LEVELS_PRESET}[name]
    ref = {"FULL_PRESET": J_FULL, "TINY_TEST_PRESET": J_TINY, "FEW_LEVELS_PRESET": J_FEW}[name]
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name
    for prop in ("num_layers", "num_enc_layers", "num_dec_layers", "scale_factor"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    check_supported(mine)


# the few-levels preset's shape at a tiny width: 3 stages of one width,
# groups 1, hidden 2C, two trajectory heads of 36 channels
FEW_SHAPED = dict(dataclasses.asdict(TINY_TEST_PRESET), embed_dim=(72, 72, 72),
                  depths=(1, 1, 1), num_heads=(2, 4, 2), traj_heads=(2, None),
                  traj_res_n=(1, 0, 1))


def test_few_levels_shape_matches_jax():
    """A forward of the few-levels shape (C = 72, LTAM head width 36, FFN
    groups 1) against ``vmg_tpu``'s, f32, at the golden's tolerances."""
    cfg = VMGNetworkConfig(**FEW_SHAPED)
    assert (cfg.n_groups, cfg.embed_dim[0] // cfg.traj_heads[0]) == (1, 36)
    port = vmg_tpu_torch.create_model(cfg, device="cpu",
                                      generator=torch.Generator().manual_seed(0))
    params = convert_torch_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, strict=True)
    model = j_create_model(JConfig(**FEW_SHAPED), is_train=False)
    x = np.random.default_rng(2).random((1, 3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(model.apply)(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    up = upsample_trilinear_frames(torch.from_numpy(x), 4).numpy()
    np.testing.assert_allclose(got - up, want - up, atol=2e-5)


def test_server_contract():
    """SRServer: numpy (1, T, h, w, 3) f32 -> (1, T, 4h, 4w, 3) f32, from a
    seeded random-init state dict (tiny preset, CPU, float32)."""
    gen = torch.Generator().manual_seed(0)
    sd = vmg_tpu_torch.create_model(TINY_TEST_PRESET, device="cpu", generator=gen).state_dict()
    server = SRServer(TINY_TEST_PRESET, sd, "cpu", torch.float32, gelu="erf",
                      fast_flow=False)
    clip = np.random.default_rng(2).random((1, 4, 64, 64, 3)).astype(np.float32)
    out = server(clip)
    assert out.shape == (1, 4, 256, 256, 3) and out.dtype == np.float32
    assert np.isfinite(out).all()


_NO_JAX_SNIPPET = """
import sys
import numpy as np
import torch
import vmg_tpu_torch
import vmg_tpu_torch.profile_serving
import vmg_tpu_torch.profile_training
import vmg_tpu_torch.train.__main__
import vmg_tpu_torch.ops.conv_chain
import vmg_tpu_torch.ops.fused_norm
import vmg_tpu_torch.ops.probes
import vmg_tpu_torch.tools.exp_probe
import vmg_tpu_torch.tools.exp_probe2
import vmg_tpu_torch.utils.profiling
import vmg_tpu_torch.utils.logging_utils
import vmg_tpu_torch.ckpt
import vmg_tpu_torch.ckpt.io
import vmg_tpu_torch.eval
import vmg_tpu_torch.eval.__main__
import vmg_tpu_torch.eval.device_tiled
import vmg_tpu_torch.eval.png
import vmg_tpu_torch.data
import vmg_tpu_torch.data.clip_dataset
import vmg_tpu_torch.data.color
import vmg_tpu_torch.data.loader
import vmg_tpu_torch.data.native
import vmg_tpu_torch.data.sampler
import vmg_tpu_torch.data.storage
import vmg_tpu_torch.edit.hooks
import vmg_tpu_torch.tools.train
import vmg_tpu_torch.tools.prepare_data
import vmg_tpu_torch.tools.make_demo_data
import vmg_tpu_torch.utils.misc
import vmg_tpu_torch.utils.scalars
import vmg_tpu_torch.utils.collect_env
from vmg_tpu_torch.ckpt import load_reference_checkpoint, reference_state_dict
from vmg_tpu_torch.models.vmg import KERNEL_FORMS
from vmg_tpu_torch.serve import SRServer
gen = torch.Generator().manual_seed(0)
for forms in ({}, KERNEL_FORMS, {"traj_conv_impl": "barrier"}):
    model = vmg_tpu_torch.create_model(vmg_tpu_torch.TINY_TEST_PRESET, device="cpu",
                                       generator=gen, **forms)
    with torch.no_grad():
        y = model(torch.rand(1, 4, 64, 64, 3, generator=gen))
    assert y.shape == (1, 4, 256, 256, 3) and bool(torch.isfinite(y).all())
sd = reference_state_dict(load_reference_checkpoint("tests/fixtures/ref_tiny_mine.pth"))
model.load_state_dict(sd)
import tempfile
from vmg_tpu_torch.configs import DatasetConfig
with tempfile.TemporaryDirectory() as d:
    for side, hw in (("hr", 64), ("lr", 16)):
        w = vmg_tpu_torch.data.PackedWriter(f"{d}/{side}", (hw, hw, 3))
        for i in range(4):
            w.add(f"000_{i}", np.full((hw, hw, 3), i, np.uint8), clip_key="000")
        w.close()
    cfg = DatasetConfig(dataroot_HR=f"{d}/hr", dataroot_LR=f"{d}/lr", num_frames=2,
                        crop_size=32, image_shape=(3, 64, 64), total_num_frames=4)
    batch = vmg_tpu_torch.data.create_dataset(cfg).get_batch([0])
    assert batch["HRs"].shape == (1, 2, 32, 32, 3)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "yaml", "cv2", "PIL", "vmg_tpu"))
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _NO_JAX_SNIPPET], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


_WEIGHTS_SNIPPET = """
import os, sys
import numpy as np
from vmg_tpu_torch.weights import state_dict_from_jax
rng = np.random.default_rng(0)
tree = {"params": {
    "input_proj": {"proj": {"kernel": rng.random((3, 3, 3, 8)), "bias": rng.random(8)}},
    "encoder_layers0": {"mlp_blocks0": {"norm2": {"scale": rng.random(8), "bias": rng.random(8)},
                                        "channel_mixing": {"fc2": {"kernel": rng.random((16, 8)),
                                                                   "bias": rng.random(8)}}}}}}
sd = state_dict_from_jax(tree)
assert tuple(sd["input_proj.proj.0.weight"].shape) == (8, 3, 3, 3)
assert tuple(sd["encoder_layers.0.mlp_blocks.0.channel_mixing.fc2.weight"].shape) == (8, 16)
jax_pkg = os.path.join(sys.argv[1], "vmg_tpu") + os.sep
bad = sorted(n for n, m in list(sys.modules.items())
             if (getattr(m, "__file__", None) or "").startswith(jax_pkg))
assert not bad, bad
print("ok")
"""


def test_weights_read_nothing_of_the_jax_package():
    """``state_dict_from_jax`` loads no module from ``vmg_tpu/``, and no
    source file of the port names a path under it or imports from it."""
    import ast
    import pathlib

    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _WEIGHTS_SNIPPET, REPO], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    pattern = __import__("re").compile(r"(^|[/\\])vmg_tpu([/\\]|$)")
    for path in pathlib.Path(REPO, "vmg_tpu_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and id(node) not in docs:
                assert not pattern.search(node.value), (path, node.value)
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] == "vmg_tpu" for n in names), (path, names)


def test_entry_points_default_to_the_card():
    """``create_model`` and ``SRServer`` without a device take the card;
    without one they raise instead of falling back to the CPU."""
    sd = vmg_tpu_torch.create_model(TINY_TEST_PRESET, device="cpu").state_dict()
    if torch.cuda.is_available():
        model = vmg_tpu_torch.create_model(TINY_TEST_PRESET)
        assert next(model.parameters()).device.type == "cuda"
        assert SRServer(TINY_TEST_PRESET, sd).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        vmg_tpu_torch.create_model(TINY_TEST_PRESET)
    with pytest.raises(RuntimeError, match="CUDA"):
        SRServer(TINY_TEST_PRESET, sd)
