"""The whole-model forward of the seven-stage, flow-free variant and one
training step of a variant against ``vmg_tpu`` (split from
``tests/test_torch_variants_model.py``, whose configurations, helpers and
tolerances it uses)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vmg_tpu.configs import VMGNetworkConfig as JConfig
from vmg_tpu.models import create_model as j_create_model
from vmg_tpu.train import loss as jloss
import vmg_tpu_torch
from vmg_tpu_torch.configs import TrainConfig, VMGNetworkConfig
from vmg_tpu_torch.train.train_step import loss_and_grads
from vmg_tpu_torch.weights import state_dict_from_jax

from test_torch_variants_model import (CONFIGS, _few_torch_threads, _jax_params,  # noqa: F401
                                       _keys, check_forward)


@pytest.mark.parametrize("name", ["seven_stage"])
def test_variant_forward_matches_jax(name):
    check_forward(name)


def test_variant_training_step_matches_jax():
    """Loss and gradients of one training step (drop_path 0, the module
    paths through autograd) on the flow-free variant against
    ``jax.value_and_grad`` of ``vmg_tpu``'s training loss."""
    name = "no_flow"
    cfg = dict(CONFIGS[name], drop_path_rate=0.0)
    rng = np.random.default_rng(4)
    lrs = rng.random((1, 3, 64, 64, 3), dtype=np.float32)
    hrs = rng.random((1, 3, 256, 256, 3), dtype=np.float32)
    jm = j_create_model(JConfig(**cfg), is_train=True)
    model = vmg_tpu_torch.create_model(VMGNetworkConfig(**cfg), is_train=True, device="cpu",
                                       generator=torch.Generator().manual_seed(0))
    params = _jax_params(model)

    def loss_fn(p):
        out = jm.apply(p, jnp.asarray(lrs), deterministic=False,
                       rngs={"droppath": jax.random.key(1)})
        return jloss.total_loss(out, jnp.asarray(hrs), eps=1e-6, if_aux=True)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    tc = TrainConfig(if_aux=True, eps=1e-6)
    loss, grads = loss_and_grads(model, torch.from_numpy(lrs), torch.from_numpy(hrs), tc)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = state_dict_from_jax(want_grads, **_keys(cfg))
    names = [n for n, _ in model.named_parameters()]
    norm = float(sum((w.double() ** 2).sum() for w in want.values())) ** 0.5
    got_norm = float(sum((g.double() ** 2).sum() for g in grads)) ** 0.5
    np.testing.assert_allclose(got_norm, norm, rtol=1e-5)
    checked = 0
    for n, g in zip(names, grads):
        if any(s in n for s in ("spatial_mixing.block0.dw", "traj_mixing.blocks.1.attn",
                                "spatial_mixing.proj", "channel_mixing.fc1", "conv_last")):
            w = want[n].numpy()
            err = np.abs(g.numpy() - w).max()
            assert err <= 1e-3 * np.abs(w).max(), (n, err, np.abs(w).max())
            checked += 1
    assert checked >= 8, checked
