"""The axes op's token form, the port's plain version against JAX's
Pallas kernel in interpret mode (split from ``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import jax.numpy as jnp

from vmg_tpu.ops.morphfc_fused import fused_morphfc_axes as j_axes
from vmg_tpu_torch.ops import decay, morphfc_fused

from test_torch_kernels import _few_torch_threads, _t  # noqa: F401


@pytest.mark.parametrize("H,W,C,chunk,form", [(18, 32, 96, 16, None), (11, 16, 160, 8, None),
                                               (14, 16, 16, 4, "token")])
def test_morphfc_axes_token_plain_matches_pallas(rng, H, W, C, chunk, form):
    """The token form (JAX's ``_axes_kernel_token``): chunk * C = 1536 and
    1280 select it, with a partial last H-chunk each; at 64 it is forced,
    as ``tests/test_morphfc_fused.py`` forces it."""
    N = 2
    x, c = (rng.standard_normal((N, H, W, C)).astype(np.float32) for _ in range(2))
    kh, kw = ((rng.standard_normal((C, C)) * 0.05).astype(np.float32) for _ in range(2))
    bh, bw = ((rng.standard_normal((C,)) * 0.1).astype(np.float32) for _ in range(2))
    want = j_axes(*map(jnp.asarray, (x, c, kh, bh, kw, bw)), chunk_h=chunk, chunk_w=chunk,
                  decay=True, non_linear=True, interpret=True, form=form)
    g = decay.morphfc_decay_np(chunk, C // chunk)
    got = morphfc_fused.fused_morphfc_axes(_t(x), _t(c), _t(kh * g), _t(bh), _t(kw * g),
                                           _t(bw), chunk_h=chunk, chunk_w=chunk, form=form)
    assert (form or morphfc_fused.axes_form(C, chunk, chunk)) == "token"
    for gt, wnt in zip(got[:2], want[:2]):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wnt), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-3, rtol=1e-5)
