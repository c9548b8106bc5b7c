"""The port's checkpoint leftovers against ``vmg_tpu.ckpt.torch_convert``.

* ``export_torch_state_dict`` of the port's ``state_dict`` gives the keys
  and arrays of the JAX package's export of the same weights (carried into
  a JAX tree by the reference converter);
* port -> reference ``.pth`` -> ``load_reference_checkpoint`` ->
  ``reference_state_dict`` serves the same outputs, bit for bit (float32;
  a bf16 model exports its float32 values);
* ``remap_ttvsr_pretrain`` equals the JAX package's on a synthetic TTVSR
  state dict that reaches the stage-2 0->4 / 1->5 remap, the mirror copy,
  the ``module.`` prefix and the refusals;
* ``verify_against`` equals the JAX package's diagnostics.
``TINY_TEST_PRESET``, seeded, CPU.
"""

import numpy as np
import pytest
import torch

from vmg_tpu.ckpt import torch_convert as jconv
import vmg_tpu_torch
from vmg_tpu_torch.ckpt import torch_convert as conv
from vmg_tpu_torch.configs import TINY_TEST_PRESET


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch at full
    width in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return vmg_tpu_torch.create_model(TINY_TEST_PRESET, device="cpu",
                                      generator=torch.Generator().manual_seed(0))


def test_export_matches_jax(model):
    sd = model.state_dict()
    params = jconv.convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    want = jconv.export_torch_state_dict(params, channel_mixer="rcab")
    got = conv.export_torch_state_dict(sd)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), err_msg=k)


def test_export_refuses_what_the_port_lacks(model):
    with pytest.raises(ValueError, match="non_linear=False"):
        conv.export_torch_state_dict(model.state_dict(), non_linear=False)
    with pytest.raises(KeyError, match="no export rule"):
        conv.export_torch_state_dict({"head.weight": torch.zeros(2)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pth_round_trip_serves_the_same(model, tmp_path, dtype):
    path = tmp_path / "vmg.pth"
    src = vmg_tpu_torch.create_model(TINY_TEST_PRESET, device="cpu", dtype=dtype)
    src.load_state_dict(model.state_dict())
    conv.save_reference_checkpoint(src.state_dict(), str(path))
    sd = conv.reference_state_dict(conv.load_reference_checkpoint(str(path)))
    back = vmg_tpu_torch.create_model(TINY_TEST_PRESET, device="cpu", dtype=dtype)
    back.load_state_dict(sd, strict=True)
    for k, v in src.state_dict().items():
        torch.testing.assert_close(back.state_dict()[k], v, rtol=0, atol=0, msg=k)
    x = torch.from_numpy(np.random.default_rng(4).random((1, 3, 64, 64, 3), dtype=np.float32))
    with torch.no_grad():
        torch.testing.assert_close(back(x), src(x), rtol=0, atol=0)


def _ttvsr_state_dict():
    """A TTVSR-style checkpoint: ``backbone.*`` keys at stages 0-2 (stage 2
    with sub-indices 0, 1, 4, 5 and 7), one key outside the backbone, a
    ``module.`` prefix, torch tensors."""
    rng = np.random.default_rng(5)
    keys = ["backbone.layers.0.conv.weight", "backbone.layers.1.conv.bias",
            "backbone.layers.2.blocks.0.weight", "backbone.layers.2.blocks.1.weight",
            "backbone.layers.2.blocks.4.weight", "backbone.layers.2.blocks.5.weight",
            "backbone.layers.2.blocks.7.weight", "backbone.layers.2.blocks.3.bias",
            "backbone.layers.3.conv.weight", "backbone.head", "spynet.conv.weight"]
    return {f"module.{k}": torch.from_numpy(rng.standard_normal((2, 3), dtype=np.float32))
            for k in keys}


@pytest.mark.parametrize("targets", ["all", "some", "none"])
def test_remap_ttvsr_pretrain_matches_jax(targets):
    sd = _ttvsr_state_dict()
    names = [k[len("module."):].replace("backbone", "align_t_down", 1) for k in sd]
    target = {"all": names, "some": names[2:4] + names[7:9], "none": []}[targets]
    want = jconv.remap_ttvsr_pretrain({k: v.numpy() for k, v in sd.items()}, target)
    got = conv.remap_ttvsr_pretrain(sd, target)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if targets == "all":
        # stage 2: sub-index 0 takes 4's weights, 1 takes 5's, each mirrored up
        src = {k[len("module."):]: v.numpy() for k, v in sd.items()}
        np.testing.assert_array_equal(got["align_t_down.layers.2.blocks.0.weight"],
                                      src["backbone.layers.2.blocks.4.weight"])
        np.testing.assert_array_equal(got["align_t_up.layers.2.blocks.1.weight"],
                                      src["backbone.layers.2.blocks.5.weight"])
        assert "align_t_down.layers.2.blocks.7.weight" not in got


def test_verify_against_matches_jax(model):
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = conv.convert_torch_state_dict(sd)
    broken = jconv.convert_torch_state_dict(sd)
    del broken["params"]["local_cnn"]
    broken["params"]["conv_last"]["kernel"] = np.zeros((1, 1))
    for pair in ((tree, tree), (tree, broken)):
        assert conv.verify_against(*pair) == jconv.verify_against(*pair)
    missing, bad = conv.verify_against(tree, broken)
    assert missing == ["local_cnn"] and [b[0] for b in bad] == ["conv_last/kernel"]
