"""``vmg_tpu_torch.ckpt.export``: the serving forward as a ``torch.export``
program with every hand kernel as a ``vmg::`` operator node.

``TINY_TEST_PRESET`` served as ``SRServer`` runs it in bf16 (tanh GELU,
bf16 SPyNet convolutions) with the RCAB chain and the fused norm in their
kernel forms and the trajectory in its barrier form (so the program holds
every operator the tiny model reaches: the FFN, the axes op, the combine,
LTAM, the conv chain, the norm and the pin), with ``frames_mirror``, on
CPU: exported, saved, loaded in place of the eager model, its output equals
the eager forward's exactly and its graph names each ``vmg::`` operator as
many times as the eager forward calls it.
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import vmg_tpu_torch
from vmg_tpu_torch.ckpt.export import export_program, load_program, operator_counts
from vmg_tpu_torch.configs import TINY_TEST_PRESET
from vmg_tpu_torch.serve import SRServer

FORMS = dict(rcab_impl="kernel", norm_impl="kernel", traj_conv_impl="barrier")


class _CountOperators(TorchDispatchMode):
    """Counts the ``vmg::`` operator calls under it."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "vmg":
            self.counts[func._schema.name.split("::")[1]] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_exported_program_equals_eager(tmp_path):
    sd = vmg_tpu_torch.create_model(TINY_TEST_PRESET, device="cpu",
                                    generator=torch.Generator().manual_seed(0)).state_dict()
    server = SRServer(TINY_TEST_PRESET, sd, "cpu", torch.bfloat16, **FORMS)
    x = torch.from_numpy(np.random.default_rng(1).random((1, 4, 64, 64, 3), dtype=np.float32))
    path = tmp_path / "tiny.pt2"
    program = export_program(server, tuple(x.shape), path, frames_mirror=True)
    forward = load_program(path)
    with torch.no_grad():
        with _CountOperators() as eager:
            want = server.model(x, frames_mirror=True)
        got = forward(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert set(eager.counts) == {"group_ffn", "morphfc_axes", "morphfc_combine", "ltam_fwd",
                                 "conv_chain", "fused_norm", "layout_pin"}
    assert operator_counts(program) == eager.counts
    assert operator_counts(forward) == eager.counts
    with pytest.raises(ValueError, match="eval mode"):
        export_program(vmg_tpu_torch.create_model(TINY_TEST_PRESET, device="cpu",
                                                  is_train=True), tuple(x.shape))


def test_variant_tails_export(tmp_path):
    """The tiny model (one TAB a stage) without a flow network, with the 3D
    window attention at every stage and linear, bias-free axis FCs, exports
    the same way: the tail is plain tensor code in the graph, the axes op's
    options ride on its node."""
    import dataclasses

    cfg = dataclasses.replace(TINY_TEST_PRESET, spynet=None, temporal_type=(None, None),
                              temporal_empty=False, non_linear=False, qkv_bias=False,
                              depths=(1, 1, 1))
    sd = vmg_tpu_torch.create_model(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(0)).state_dict()
    server = SRServer(cfg, sd, "cpu", torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(2).random((1, 2, 64, 64, 3), dtype=np.float32))
    path = tmp_path / "variant.pt2"
    program = export_program(server, tuple(x.shape), path)
    forward = load_program(path)
    with torch.no_grad():
        with _CountOperators() as eager:
            want = server.model(x)
        got = forward(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert eager.counts["morphfc_axes"] > 0
    assert operator_counts(program) == operator_counts(forward) == eager.counts
