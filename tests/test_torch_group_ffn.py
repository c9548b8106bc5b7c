"""The FFN kernel's packed weights (``pack_ffn_weights``) on the CPU:
packing then unpacking gives back the module's weights, at every path
width (borrowed channels at cg = 4 and 28, fg padded from 168 to 176, a
last hidden chunk of 32, groups = 1 at the few-levels C = 144, the output
channels split between the warpgroups above C = 224), in bf16 (the wgmma
kernel's stream) and f32.  The kernel itself is checked on the card
(``test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from vmg_tpu_torch.ops import group_conv


WIDTHS = [(16, 4, 6), (112, 4, 6), (144, 1, 2), (448, 4, 6), (256, 2, 6)]


def _round_trip(C, groups, ratio, dtype):
    rng = np.random.default_rng(C)
    Fh = ratio * C
    w1, b1, w2 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
                  for s in ((Fh, C // groups, 3, 3), (Fh,), (C, Fh)))
    w, b1p = group_conv.pack_ffn_weights(w1, b1, w2, groups)
    assert w.dtype == dtype and w.dim() == 1
    u1, u2 = group_conv.unpack_ffn_weights(w, b1p, C, groups)
    fg, cg = Fh // groups, C // groups
    fgp = b1p.numel() // groups
    assert fgp % (1 if dtype == torch.float32 else 16 if C <= 224 else 32) == 0
    # the module's weights: conv rows (dy, dx, ci), fc2 rows; zeros in the padding
    taps = u1.reshape(groups, 3, 3, -1, fgp)
    for b in range(groups):
        want = w1[b * fg:(b + 1) * fg].permute(2, 3, 1, 0)  # (3, 3, cg, fg)
        assert torch.equal(taps[b, :, :, :cg, :fg], want)
        assert not taps[b, :, :, cg:].any() and not taps[b, ..., fg:].any()
        assert torch.equal(u2[b, :fg], w2[:, b * fg:(b + 1) * fg].t())
        assert not u2[b, fg:].any()
    assert torch.equal(b1p.reshape(groups, fgp)[:, :fg], b1.reshape(groups, fg))


@pytest.mark.parametrize("C,groups,ratio", WIDTHS)
def test_ffn_stream_round_trip(C, groups, ratio):
    """bf16: the wgmma kernel's weight stream."""
    _round_trip(C, groups, ratio, torch.bfloat16)


@pytest.mark.parametrize("C,groups,ratio", WIDTHS)
def test_ffn_f32_weights_round_trip(C, groups, ratio):
    """f32: w1p then w2p, unpadded, in one buffer."""
    _round_trip(C, groups, ratio, torch.float32)
