"""The port's conv chain and layout pin against ``vmg_tpu/ops/conv_chain.py``.

On CPU the wrapper takes its plain PyTorch version; it is held against the
JAX Pallas kernel in interpret mode (``rows=4``, several row blocks) on the
same seeded numpy inputs, at the JAX tests' own cases and tolerances
(``tests/test_conv_chain.py``: 1e-5, the sums 1e-4).  The JAX kernel takes
HWIO kernels; the port takes the taps :func:`pack_conv_taps` makes from the
PyTorch (OIHW) weights.  The CUDA kernels are checked in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vmg_tpu.ops.conv_chain import fused_conv_chain as j_chain
from vmg_tpu_torch.ops import conv_chain

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch at full
    width in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _mk(rng, shape):
    return (rng.standard_normal(shape) * 0.1).astype(np.float32)


def _case(rng, N, H, W, Cin, Cm):
    x = _mk(rng, (N, H, W, Cin))
    k1, b1 = _mk(rng, (3, 3, Cin, Cm)), _mk(rng, (Cm,))
    k2, b2 = _mk(rng, (3, 3, Cm, Cin)), _mk(rng, (Cin,))
    return x, k1, b1, k2, b2


def _port_operands(k1, b1, k2, b2):
    """HWIO kernels -> PyTorch Conv2d weights -> the packed taps."""
    def conv(k, b):
        return torch.from_numpy(k.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b)
    return (*conv_chain.pack_conv_taps(*conv(k1, b1)),
            *conv_chain.pack_conv_taps(*conv(k2, b2)))


# (N, H, W, Cin, Cm, kwargs): the JAX tests' cases -- 13 rows leave a
# partial row block; the RCAB form with Cin != Cm; the resblock form; lrelu
CASES = [
    (2, 16, 24, 16, 16, {}),
    (2, 13, 24, 16, 16, {}),
    (2, 11, 16, 24, 16, dict(emit_psum=True)),
    (1, 16, 24, 16, 16, dict(res_scale=0.1)),
    (1, 8, 16, 8, 8, dict(act1="lrelu")),
]


@pytest.mark.parametrize("N,H,W,Cin,Cm,kw", CASES)
def test_conv_chain_plain_matches_pallas(rng, N, H, W, Cin, Cm, kw):
    x, k1, b1, k2, b2 = _case(rng, N, H, W, Cin, Cm)
    want = j_chain(*map(jnp.asarray, (x, k1, b1, k2, b2)), rows=4, interpret=True, **kw)
    got = conv_chain.fused_conv_chain(torch.from_numpy(x), *_port_operands(k1, b1, k2, b2),
                                      **kw)
    if kw.get("emit_psum"):
        (got, psum), (want, wpsum) = got, want
        assert psum.dtype == torch.float32 and psum.shape == (N, Cin)
        np.testing.assert_allclose(psum.numpy(), np.asarray(wpsum), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_pack_conv_taps_pads_bf16_to_the_mma_width():
    """bf16 taps pad both channel dims to a multiple of 16 with zeros (the
    tensor-core path); float32 taps pad the input channels to the k8 step
    and the outputs to 16, as TF32 hi / lo images; the bias is f32."""
    w, b = torch.randn(24, 20, 3, 3), torch.randn(24)
    image, bias = conv_chain.pack_conv_taps(w.bfloat16(), b.bfloat16())
    assert image.shape == (9, 4, 32, 8) and image.dtype == torch.bfloat16
    taps = conv_chain.tap_matrices(image)
    assert taps.shape == (9, 32, 32) and taps.dtype == torch.bfloat16
    assert bias.shape == (32,) and bias.dtype == torch.float32
    assert not taps[:, 20:].any() and not taps[:, :, 24:].any() and not bias[24:].any()
    torch.testing.assert_close(taps[4, :20, :24], w[:, :, 1, 1].t().bfloat16())
    image, bias = conv_chain.pack_conv_taps(w, b)
    assert image.shape == (9, 3, 2, 2, 32, 4) and bias.shape == (32,)
    taps = conv_chain.tap_matrices(image)
    assert taps.shape == (9, 24, 32) and not taps[:, 20:].any() and not taps[:, :, 24:].any()
    assert not bias[24:].any()
    assert torch.equal(taps[2, :20, :24], w[:, :, 0, 2].t())
    taps, _ = conv_chain.pack_conv_taps(w.double(), None)  # other dtypes: the matrices
    assert taps.shape == (9, 20, 24) and conv_chain.tap_matrices(taps) is taps


@pytest.mark.parametrize("cin,cout", [(16, 16), (24, 24), (112, 112), (128, 128), (24, 112),
                                      (128, 16)])
def test_pack_conv_taps_bf16_image_gives_back_the_weight(cin, cout):
    """The bf16 B image, unpacked element by element as the kernel reads it
    (tap t, chunk c, output n, element e is input channel 8c + e), gives back
    the Conv2d weight exactly, zeros in the padding; each 8-row group of a
    chunk is one 128-byte core matrix."""
    w = torch.randn(cout, cin, 3, 3).bfloat16()
    image, _ = conv_chain.pack_conv_taps(w, None)
    cinp, coutp = -(-cin // 16) * 16, -(-cout // 16) * 16
    assert image.shape == (9, cinp // 8, coutp, 8) and image.is_contiguous()
    flat = image.reshape(-1)
    back = torch.zeros(coutp, cinp, 3, 3, dtype=torch.bfloat16)
    for t in range(9):
        for k in range(cinp):
            c, e = divmod(k, 8)
            # the byte offset the kernel's descriptor gives entry (k, n)
            offs = ((t * (cinp // 8) + c) * coutp + torch.arange(coutp)) * 8 + e
            back[:, k, t // 3, t % 3] = flat[offs]
    assert torch.equal(back[:cout, :cin], w)
    assert not back[cout:].any() and not back[:, cin:].any()
    torch.testing.assert_close(conv_chain._conv_weight(image, cin),
                               back[:, :cin].float(), rtol=0, atol=0)


def test_conv_chain_bf16_rounds_where_the_kernel_does(rng):
    """bf16: the plain version rounds conv1's output and conv2's output once
    each, and computes the residual in bf16 arithmetic -- the TPU kernel's
    rounding points."""
    x, k1, b1, k2, b2 = _case(rng, 1, 9, 11, 16, 16)
    ops = [conv_chain.tap_matrices(t).bfloat16() if t.ndim == 6 else t
           for t in _port_operands(k1, b1, k2, b2)]
    xb = torch.from_numpy(x).bfloat16()
    got = conv_chain.fused_conv_chain(xb, *ops, res_scale=0.1)
    w1 = torch.from_numpy(k1.transpose(3, 2, 0, 1).copy()).bfloat16().float()
    w2 = torch.from_numpy(k2.transpose(3, 2, 0, 1).copy()).bfloat16().float()
    y = torch.relu(torch.nn.functional.conv2d(xb.float().permute(0, 3, 1, 2), w1,
                                              torch.from_numpy(b1), padding=1))
    y = torch.nn.functional.conv2d(y.bfloat16().float(), w2, torch.from_numpy(b2), padding=1)
    want = xb + 0.1 * y.bfloat16().permute(0, 2, 3, 1)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_pin_is_an_equal_copy(dtype):
    x = torch.randn(2, 5, 7, 12).to(dtype)
    y = conv_chain.layout_pin(x)
    assert torch.equal(y, x) and y.dtype == dtype and y.is_contiguous()
    assert y.data_ptr() != x.data_ptr()
    y[0, 0, 0, 0] = 1e3
    assert x[0, 0, 0, 0] != y[0, 0, 0, 0]


def test_wrappers_refuse_unknown_activations():
    x = torch.zeros(1, 4, 4, 8)
    ops = conv_chain.pack_conv_taps(torch.zeros(8, 8, 3, 3), None) * 2
    with pytest.raises(ValueError, match="act"):
        conv_chain.fused_conv_chain(x, *ops, act1="gelu")


@pytest.mark.parametrize("kernel,cat", [
    ("void vmg::conv3x3_wgmma_kernel<112>(CUtensorMap_st, vmg::ConvArgs)", "conv chain kernel"),
    ("void vmg::conv3x3_tf32_kernel<112>(CUtensorMap_st, vmg::ConvTfArgs)", "conv chain kernel"),
    ("vmg::chain_psum_kernel(float const*, float*, int, int)", "conv chain kernel"),
    ("vmg::copy_vec_kernel(uint4 const*, uint4*, long long)", "layout pin kernel"),
    ("vmg::copy1_kernel(unsigned char const*, unsigned char*, long long)", "layout pin kernel"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc", "convolutions (cuDNN)"),
])
def test_profile_files_the_chain_and_pin_kernels_under_their_names(kernel, cat):
    """profile_serving's device-time breakdown counts the chain's wgmma conv
    and sums pass as the conv chain and the pin's copies as the pin, apart
    from cuDNN's convolutions and PyTorch's copies."""
    from vmg_tpu_torch.profile_serving import category
    assert category(kernel) == cat


def test_time_chain_pin_refuses_without_a_card():
    """The two-checkout timing tool imports the package from the root it is
    given and times only on a CUDA device: on the CPU it refuses."""
    from pathlib import Path

    from vmg_tpu_torch.tools import time_chain_pin
    root = Path(time_chain_pin.__file__).resolve().parents[2]
    with pytest.raises(RuntimeError, match="CUDA device"):
        time_chain_pin._side(root, 1)
