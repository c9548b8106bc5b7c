"""``flow_levels='shared'``: the flow pyramid against ``vmg_tpu``'s (split
from ``tests/test_torch_flow_levels.py``, whose fixture and helpers it uses).
"""

import numpy as np
import pytest
import torch

from vmg_tpu_torch.configs import TINY_TEST_PRESET
from vmg_tpu_torch.ops.resize import adaptive_avg_pool2d

from test_torch_flow_levels import _few_torch_threads, _jax_flows, shared  # noqa: F401


@pytest.mark.parametrize("frames_mirror", [False, True])
def test_shared_flows_match_jax(shared, frames_mirror):
    port, model, params, x = shared
    want_f, want_b = _jax_flows(model, params, x, frames_mirror)
    with torch.no_grad():
        got_f, got_b = port._compute_flows(torch.from_numpy(x), frames_mirror)
    assert len(got_f) == len(want_f) == TINY_TEST_PRESET.num_enc_layers
    for got, want in ((got_f, want_f), (got_b, want_b)):
        for i, (g, w) in enumerate(zip(got, want)):
            assert tuple(g.shape) == w.shape, i
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4,
                                       err_msg=f"level {i}")
    # levels above 0 are level 0 pooled and halved per level, no SPyNet run
    for flows in (got_f, got_b):
        B, S, h, w, _ = flows[1].shape
        pooled = adaptive_avg_pool2d(flows[0].reshape(B * S, *flows[0].shape[2:]), h, w)
        torch.testing.assert_close(flows[1], 0.5 * pooled.reshape(flows[1].shape),
                                   rtol=0, atol=0)
