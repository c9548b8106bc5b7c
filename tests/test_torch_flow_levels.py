"""``flow_levels='shared'`` of the port against ``vmg_tpu``'s.

``TINY_TEST_PRESET`` with ``flow_levels='shared'``: SPyNet runs at level 0
only and the coarser levels are its flow average-pooled and scaled by
0.5**i.  The port's flow pyramid and its whole forward, with and without
``frames_mirror``, against the JAX model's on the port's seeded weights
(carried over by the reference converter), fp32 on CPU, at the tolerances
of ``tests/test_torch_model.py`` (the mdsc golden's).
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmg_tpu.ckpt.torch_convert import convert_torch_state_dict
from vmg_tpu.configs import TINY_TEST_PRESET as J_TINY
from vmg_tpu.models import create_model as j_create_model
import vmg_tpu_torch
from vmg_tpu_torch.configs import TINY_TEST_PRESET, VMGNetworkConfig


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch at full
    width in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shared():
    """(port model, JAX model, JAX params, input clip)."""
    cfg = dataclasses.replace(TINY_TEST_PRESET, flow_levels="shared")
    port = vmg_tpu_torch.create_model(cfg, device="cpu",
                                      generator=torch.Generator().manual_seed(0))
    params = convert_torch_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()}, strict=True)
    params = jax.tree.map(jnp.asarray, params)
    model = j_create_model(dataclasses.replace(J_TINY, flow_levels="shared"), is_train=False)
    x = np.random.default_rng(1).random((1, 4, 64, 64, 3)).astype(np.float32)
    return port, model, params, x


def _jax_flows(model, params, x, frames_mirror):
    """The JAX model's ``_compute_flows`` alone (its SPyNet is made inline,
    so it runs inside a compact method)."""

    class FlowsOnly(type(model)):
        @nn.compact
        def __call__(self, xp, mirror=False):
            return self._compute_flows(xp, mirror)

    fields = {f.name: getattr(model, f.name) for f in dataclasses.fields(model)
              if f.name not in ("parent", "name")}
    spynet = {"params": {"spynet": params["params"]["spynet"]}}
    return FlowsOnly(**fields).apply(spynet, jnp.asarray(x), frames_mirror)


@pytest.mark.parametrize("frames_mirror", [False, True])
def test_shared_forward_matches_jax(shared, frames_mirror):
    port, model, params, x = shared
    want = np.asarray(jax.jit(lambda p, v: model.apply(p, v, frames_mirror=frames_mirror))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), frames_mirror=frames_mirror).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_flow_levels_field():
    """Two values; the level-0 flows of both modes are the same, the coarser
    ones differ; create_model's keyword replaces the config's field."""
    with pytest.raises(ValueError, match="flow_levels"):
        VMGNetworkConfig(flow_levels="pooled")
    x = torch.from_numpy(np.random.default_rng(3).random((1, 3, 32, 32, 3), dtype=np.float32))
    flows = {}
    for levels in ("per_level", "shared"):
        model = vmg_tpu_torch.create_model(TINY_TEST_PRESET, device="cpu", flow_levels=levels,
                                           generator=torch.Generator().manual_seed(0))
        assert model.cfg.flow_levels == levels
        with torch.no_grad():
            flows[levels] = model._compute_flows(x, False)
    (pf, pb), (sf, sb) = flows["per_level"], flows["shared"]
    torch.testing.assert_close(sf[0], pf[0], rtol=0, atol=0)
    torch.testing.assert_close(sb[0], pb[0], rtol=0, atol=0)
    assert not torch.equal(sf[1], pf[1])
