"""vmg_tpu_torch.ops plain tensor ops against vmg_tpu.ops (CPU, fp32).

The same seeded numpy inputs go through the JAX function and its port.
Tolerances: 2e-5 for sampling and resizing (the same function computed
with another summation / weight order in f32; nearest sampling picks
the same pixels, random grids almost surely missing the round-half
boundaries), exact for max pooling, pixel shuffle and the decay closed
forms.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vmg_tpu.ops import decay as jdecay
from vmg_tpu.ops.pixel_shuffle import pixel_shuffle as jpixel_shuffle
from vmg_tpu.ops import resize as jresize
from vmg_tpu.ops import warp as jwarp
from vmg_tpu_torch.ops import decay, pixel_shuffle, resize, warp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _grid(rng, n, h, w, margin=1.3):
    return ((rng.random((n, h, w, 2)) * 2 - 1) * margin).astype(np.float32)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample(rng, mode, padding):
    x = rng.standard_normal((2, 9, 13, 5)).astype(np.float32)
    g = _grid(rng, 2, 7, 11)
    want = np.asarray(jwarp.grid_sample(jnp.asarray(x), jnp.asarray(g), mode, padding))
    got = warp.grid_sample(_t(x), _t(g), mode, padding).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("interp,pad", [("bilinear", "border"), ("nearest", "border"),
                                        ("bilinear", "zeros"), ("nearest", "zeros")])
def test_flow_warp(rng, interp, pad):
    x = rng.standard_normal((2, 12, 10, 4)).astype(np.float32)
    flow = (rng.standard_normal((2, 12, 10, 2)) * 3).astype(np.float32)
    want = np.asarray(jwarp.flow_warp(jnp.asarray(x), jnp.asarray(flow), interp, pad))
    got = warp.flow_warp(_t(x), _t(flow), interp, pad).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_nearest_warp_keeps_dtype_and_is_exact(rng):
    """The keyframe-buffer warp moves bf16 values without rounding them."""
    x = torch.from_numpy(rng.standard_normal((1, 8, 12, 6)).astype(np.float32))
    x = x.to(torch.bfloat16)
    flow = torch.from_numpy((rng.integers(-3, 4, (1, 8, 12, 2))).astype(np.float32))
    y = warp.flow_warp(x, flow, "nearest", "border")
    assert y.dtype == torch.bfloat16
    want = warp.flow_warp(x.float(), flow, "nearest", "border")
    assert torch.equal(y.float(), want)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("shape", [(7, 9, 14, 20), (16, 12, 8, 6)])
def test_resize_bilinear(rng, align, shape):
    h, w, oh, ow = shape
    x = rng.standard_normal((2, 3, h, w, 4)).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), oh, ow, align))
    got = resize.resize_bilinear(_t(x), oh, ow, align).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_upsample_trilinear_frames(rng):
    x = rng.random((1, 3, 6, 10, 3)).astype(np.float32)
    want = np.asarray(jresize.upsample_trilinear_frames(jnp.asarray(x), 4))
    got = resize.upsample_trilinear_frames(_t(x), 4).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_avg_pool2d(rng):
    x = rng.standard_normal((2, 8, 12, 3)).astype(np.float32)
    want = np.asarray(jresize.avg_pool2d(jnp.asarray(x), 2))
    np.testing.assert_allclose(resize.avg_pool2d(_t(x), 2).numpy(), want,
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("out", [(4, 6), (5, 7)])  # divisible and general bins
def test_adaptive_pools(rng, out):
    x = rng.standard_normal((2, 12, 18, 3)).astype(np.float32)
    want = np.asarray(jresize.adaptive_avg_pool2d(jnp.asarray(x), *out))
    np.testing.assert_allclose(resize.adaptive_avg_pool2d(_t(x), *out).numpy(),
                               want, atol=2e-5, rtol=2e-5)
    want = np.asarray(jresize.adaptive_max_pool2d(jnp.asarray(x), *out))
    np.testing.assert_array_equal(resize.adaptive_max_pool2d(_t(x), *out).numpy(), want)


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle(rng, r):
    x = rng.standard_normal((2, 3, 4, 5, 2 * r * r)).astype(np.float32)
    want = np.asarray(jpixel_shuffle(jnp.asarray(x), r))
    np.testing.assert_array_equal(pixel_shuffle.pixel_shuffle(_t(x), r).numpy(), want)


def test_pixel_shuffle_matches_torch_nchw(rng):
    """Channels-last shuffle == torch's PixelShuffle on the NCHW view."""
    x = torch.from_numpy(rng.standard_normal((2, 4, 5, 12)).astype(np.float32))
    want = torch.pixel_shuffle(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    assert torch.equal(pixel_shuffle.pixel_shuffle(x, 2), want)


@pytest.mark.parametrize("chunk,seg", [(8, 14), (12, 19), (4, 4)])
def test_morphfc_decay(chunk, seg):
    np.testing.assert_array_equal(decay.morphfc_decay_np(chunk, seg),
                                  jdecay._morphfc_decay_np(chunk, seg))


@pytest.mark.parametrize("heads,t", [(4, 1), (4, 5), (2, 3)])
def test_ltam_decay(heads, t):
    np.testing.assert_array_equal(decay.ltam_decay_np(heads, t),
                                  jdecay._ltam_decay_np(heads, t))
