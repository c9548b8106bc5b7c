"""The port's checkpoints (``vmg_tpu_torch.ckpt``) against ``vmg_tpu.ckpt`` on
CPU.

* ``tests/fixtures/ref_tiny_mine.pth`` (a reference-format ``torch.save``
  file, float16): the port's converter against ``vmg_tpu``'s converter
  followed by ``weights.state_dict_from_jax``, over the 'mine', 'ST' and
  'KAIR' containers: equal tensors.  The port's forward from the file
  against ``vmg_tpu``'s from the same file, float32: 2e-4 absolute
  (``test_ckpt_fixture.py``'s tolerance).  Strict mode refuses an extra
  key (both converters) and a missing one (both models).
* Trainer checkpoints: a save / restore round trip is bit-exact; k steps,
  a save, a restore into a fresh trainer and N - k more steps end on the
  same parameters, bit for bit, as N steps (``TINY_TEST_PRESET``, drop
  path on, so the generator's state is part of the checkpoint).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmg_tpu.ckpt.torch_convert import convert_spynet_state_dict as j_convert_spynet
from vmg_tpu.ckpt.torch_convert import convert_torch_state_dict as j_convert
from vmg_tpu.ckpt.torch_convert import normalize_torch_checkpoint as j_normalize
from vmg_tpu.configs import TINY_TEST_PRESET as J_TINY
from vmg_tpu.models import create_model as j_create_model
from vmg_tpu_torch.ckpt import (convert_spynet_state_dict, load_reference_checkpoint, reference_state_dict)
from vmg_tpu_torch.configs import TINY_TEST_PRESET, TrainConfig
from vmg_tpu_torch.models.vmg import create_model
from vmg_tpu_torch.train.train_step import make_train_step
from vmg_tpu_torch.weights import state_dict_from_jax

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ref_tiny_mine.pth")


@pytest.fixture(autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def containers(tmp_path_factory):
    """{source: path} of the fixture in the three containers."""
    d = tmp_path_factory.mktemp("containers")
    base = j_normalize(torch.load(FIXTURE, map_location="cpu", weights_only=True), "mine")
    st, kair = str(d / "st.pth"), str(d / "kair.pth")
    torch.save({"state_dict": {"generator." + k: v for k, v in base.items()}, "meta": {}}, st)
    torch.save({"params": dict(base)}, kair)
    return {"mine": FIXTURE, "ST": st, "KAIR": kair}


@pytest.mark.parametrize("source", ["mine", "ST", "KAIR"])
def test_converter_matches_jax(containers, source):
    ck = torch.load(containers[source], map_location="cpu", weights_only=True)
    sd = load_reference_checkpoint(containers[source], source)
    assert not any(k.startswith(("module.", "generator.")) for k in sd)
    got = reference_state_dict(sd)
    want = state_dict_from_jax(j_convert({k: v.float() for k, v in j_normalize(ck, source).items()}))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    model = create_model(TINY_TEST_PRESET, device="cpu")
    model.load_state_dict(got, strict=True)


def test_spynet_converter_matches_jax():
    sd = torch.load(FIXTURE, map_location="cpu", weights_only=True)["state_dict"]
    spy = {k[len("module.spynet."):]: v.float() for k, v in sd.items()
           if k.startswith("module.spynet.")}
    got, want = convert_spynet_state_dict(spy), j_convert_spynet(spy)
    flat_got, flat_want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(flat_got) == len(flat_want) > 0
    for a, b in zip(flat_got, flat_want):
        np.testing.assert_array_equal(a, b)


def test_strict_refuses_extra_and_missing_keys():
    sd = load_reference_checkpoint(FIXTURE)
    extra = {**sd, "encoder_layers.0.not_a_layer.weight": torch.zeros(3)}
    with pytest.raises(KeyError, match="not_a_layer"):
        reference_state_dict(extra, strict=True)
    with pytest.raises(KeyError, match="not_a_layer"):
        j_convert({k: v.float() for k, v in extra.items()}, strict=True)
    reference_state_dict(extra, strict=False)  # dropped without strict

    missing = {k: v for k, v in sd.items() if "conv_last" not in k}
    model = create_model(TINY_TEST_PRESET, device="cpu")
    with pytest.raises(RuntimeError, match="conv_last"):
        model.load_state_dict(reference_state_dict(missing), strict=True)
    params = j_convert({k: v.float() for k, v in missing.items()})
    x = jax.ShapeDtypeStruct((1, 4, 64, 64, 3), jnp.float32)
    with pytest.raises(Exception, match="conv_last"):
        jax.eval_shape(j_create_model(J_TINY, is_train=False).apply, params, x)


# ---- trainer checkpoints ----------------------------------------------------

def _trainer(seed=0):
    model = create_model(TINY_TEST_PRESET, is_train=True, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    tcfg = TrainConfig(lr=1e-3, T_period=(10,), warmup_iter=1)
    return model, make_train_step(model, tcfg, flow_fix=1), torch.Generator().manual_seed(5)


def _batch():
    rng = np.random.default_rng(2)
    return {"LRs": torch.from_numpy(rng.random((1, 4, 64, 64, 3), dtype=np.float32)),
            "HRs": torch.from_numpy(rng.random((1, 4, 256, 256, 3), dtype=np.float32))}
