"""Where each kernel form applies, the port's imports, and the few-levels
shape against ``vmg_tpu`` (split from ``tests/test_torch_model.py``, whose
configuration and helpers it uses).
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

from vmg_tpu.ckpt.torch_convert import convert_torch_state_dict
from vmg_tpu.configs import VMGNetworkConfig as JConfig
from vmg_tpu.models import create_model as j_create_model
import vmg_tpu_torch
from vmg_tpu_torch.configs import TINY_TEST_PRESET, VMGNetworkConfig
from vmg_tpu_torch.ops.resize import upsample_trilinear_frames

from test_torch_model import REPO, SEVEN_STAGE, _few_torch_threads  # noqa: F401


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


_NO_JAX_SNIPPET = """
import sys
import numpy as np
import torch
torch.set_num_threads(2)
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
import vmg_tpu_torch.models.swin3d
import vmg_tpu_torch.ops.deform
import vmg_tpu_torch.ops.window
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
