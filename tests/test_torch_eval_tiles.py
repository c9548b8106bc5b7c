"""The device-tiled evaluation loop against host tiling, and the REDS4
clip-length refusal in both packages (split from ``tests/test_torch_eval.py``,
whose helpers it uses).
"""

import numpy as np
import pytest
import torch

from vmg_tpu_torch.configs import EVAL_PRESETS, TINY_TEST_PRESET
from vmg_tpu_torch.eval.device_tiled import make_device_tiled_forward
from vmg_tpu_torch.eval.inference import SlidingEvaluator
from vmg_tpu_torch.models.vmg import create_model

from test_torch_eval import _two_threads  # noqa: F401


def test_device_tiled_equals_host_tiling():
    model = create_model(TINY_TEST_PRESET, device="cpu", generator=torch.Generator().manual_seed(0))

    @torch.inference_mode()
    def apply(x):
        return model(x)

    # 2 x 2 tiles of 64 (the model's least size), overlaps trimmed on each side
    clip = np.random.default_rng(4).random((1, 4, 80, 96, 3), dtype=np.float32)
    host = SlidingEvaluator(lambda c: apply(torch.from_numpy(c)).numpy(), scale=4,
                            spatial_wins=(64, 64), overlapped_spatial_length=20)
    want = host.test_image(clip)
    got = make_device_tiled_forward(apply, 4, (64, 64), 20, (80, 96))(torch.from_numpy(clip))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_clip_length_refused_in_both_packages():
    """REDS4 evaluates clips of 50 frames with trajectory windows of 16 and
    32: neither divides 50, and both packages refuse such a clip (here a
    window of 4 and a clip of 6)."""
    import jax
    import jax.numpy as jnp
    from vmg_tpu.configs import TINY_TEST_PRESET as J_TINY
    from vmg_tpu.models import create_model as j_create_model

    for preset in ("reds4_full", "reds4_few_levels"):
        cfg = EVAL_PRESETS[preset]
        assert cfg.dataset.num_frames % cfg.network.traj_win[0]
    x = np.random.default_rng(0).random((1, 6, 64, 64, 3), dtype=np.float32)
    model = create_model(TINY_TEST_PRESET, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), pytest.raises(ValueError, match="must divide the clip length"):
        model(torch.from_numpy(x))
    jm = j_create_model(J_TINY, is_train=False)
    params = jax.eval_shape(jm.init, jax.random.key(0),
                            jax.ShapeDtypeStruct((1, 4, 64, 64, 3), jnp.float32))
    with pytest.raises(ValueError, match="must divide the clip length"):
        jax.eval_shape(jm.apply, params, jax.ShapeDtypeStruct(x.shape, jnp.float32))
