"""The port's hand kernels as registered PyTorch operators (``vmg::``).

* ``torch.library.opcheck`` of every operator on CPU tensors at small
  shapes (schema, fake implementation, autograd registration, and the
  operator through AOT autograd with dynamic shapes), in each form the
  model paths use: the FFN (erf, tanh), both forms of the axes op, the
  reduce, the combine with and without its folded residual, the norm with
  and without bias (layer and RMS, with gradients), the conv chain with
  and without residual and sums, the pin, and the LTAM forward (with and
  without the denominator, with gradients) and backward;
* the written-out plain LTAM backward against autograd of the plain
  forward;
* every kernel of rows 1-9 of PERF.md's table is an operator, and
  importing ``vmg_tpu_torch`` registers them all.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import vmg_tpu_torch  # noqa: F401  (registers the operators)
from vmg_tpu_torch.ops import conv_chain, fused_norm, group_conv, ltam_attention, morphfc_fused

OPS = ("group_ffn", "morphfc_axes", "morphfc_reduce", "morphfc_combine", "fused_norm",
       "conv_chain", "layout_pin", "ltam_fwd", "ltam_bwd")


@pytest.fixture(autouse=True)
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch at full
    width in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _cases():
    rng = np.random.default_rng(11)
    x = _t(rng, 1, 4, 8, 16)
    w, b1p = group_conv.pack_ffn_weights(_t(rng, 32, 4, 3, 3, scale=0.2), _t(rng, 32),
                                         _t(rng, 16, 32, scale=0.1), 4)
    ffn = [(x, w, b1p, _t(rng, 16), 4, act) for act in ("erf", "tanh")]
    c, kh, kw = _t(rng, 1, 4, 8, 16, scale=0.1), _t(rng, 16, 16, scale=0.2), _t(rng, 16, 16)
    axes = [(x, c, kh, b, kw, b if b is None else _t(rng, 16), 4, 4, form, nl)
            for form in ("big", "token") for b, nl in ((_t(rng, 16), True), (None, False))]
    h, wb = _t(rng, 1, 4, 8, 16), _t(rng, 1, 4, 8, 16)
    a = torch.softmax(_t(rng, 1, 3, 16), dim=1)
    combine = [(x, h, wb, c, a, kh, _t(rng, 16), "tanh", res, 0.5)
               for res in (None, _t(rng, 1, 4, 8, 16))]
    xn = _t(rng, 2, 3, 16).requires_grad_()
    norm = [(xn, _t(rng, 16).requires_grad_(), bias, 1e-5, rms)
            for bias, rms in ((_t(rng, 16).requires_grad_(), False), (None, True))]
    taps = (*conv_chain.pack_conv_taps(_t(rng, 16, 16, 3, 3, scale=0.1), _t(rng, 16)),
            *conv_chain.pack_conv_taps(_t(rng, 16, 16, 3, 3, scale=0.1), _t(rng, 16)))
    chain = [(x, *taps, "relu", res, psum) for res, psum in ((None, False), (0.1, True))]
    K, heads, C = 2, 2, 16
    q = (_t(rng, 1, 4, 6, C) * 0.3)
    kv, pe = _t(rng, 1, 4, 6, K * 2 * C), torch.rand(K, 4, 4, heads) + 0.5
    g = _t(rng, 1, 4, 6, C)
    out, den = ltam_attention.ltam_fwd(q, kv, pe, K=K, heads=heads, with_den=True)
    ltam = [(q, kv, pe, K, heads, False),
            (q.clone().requires_grad_(), kv.clone().requires_grad_(), pe, K, heads, True)]
    return {"group_ffn": ffn, "morphfc_axes": axes, "morphfc_reduce": [(h, wb, c)],
            "morphfc_combine": combine, "fused_norm": norm, "conv_chain": chain,
            "layout_pin": [(x.permute(0, 2, 1, 3),)], "ltam_fwd": ltam,
            "ltam_bwd": [(q, kv, pe, den, out, g, K, heads)]}


CASES = _cases()


@pytest.mark.parametrize("name,i", [(n, i) for n in OPS for i in range(len(CASES[n]))])
def test_opcheck(name, i):
    torch.library.opcheck(getattr(torch.ops.vmg, name).default, CASES[name][i])


def test_every_kernel_is_an_operator():
    """Rows 1-9 of the kernel table: each wrapper's kernel is a ``vmg::``
    operator with CPU, CUDA and fake (Meta) implementations, and importing
    the package in a fresh process registers every one."""
    for name in OPS:
        op = getattr(torch.ops.vmg, name).default
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), key), (name, key)
    code = ("import torch, vmg_tpu_torch; "
            f"print(all(hasattr(torch.ops.vmg, n) for n in {OPS!r}))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert res.stdout.strip() == "True"


def test_ltam_plain_backward_matches_autograd():
    """The written-out plain LTAM backward (``vmg::ltam_bwd``'s CPU
    implementation) equals autograd of the plain forward."""
    rng = np.random.default_rng(12)
    K, heads, C = 3, 2, 8
    q, kv = _t(rng, 2, 4, 6, C) * 0.3, _t(rng, 2, 4, 6, K * 2 * C)
    pe, g = torch.rand(K, 4, 4, heads) + 0.5, _t(rng, 2, 4, 6, C)
    leaves = [t.clone().requires_grad_() for t in (q, kv, pe)]
    want = torch.autograd.grad(ltam_attention.ltam_attention_plain(*leaves, K=K, heads=heads),
                               leaves, g)
    got = ltam_attention.ltam_attention_bwd_plain(q, kv, pe, g, K=K, heads=heads)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_wrappers_count_no_cpu_launches():
    """The wrappers reach the operators; on CPU tensors no kernel is
    counted (the operators' CPU implementations are the plain versions)."""
    wrappers = (group_conv.fused_group_ffn, morphfc_fused.fused_morphfc_reduce,
                conv_chain.layout_pin)
    before = [f.launches for f in wrappers]
    x, w, b1p, b2, G, act = CASES["group_ffn"][0]
    torch.testing.assert_close(group_conv.fused_group_ffn(x, w, b1p, b2, groups=G, act=act),
                               group_conv.group_ffn_plain(x, w, b1p, b2, groups=G, act=act),
                               rtol=0, atol=0)
    morphfc_fused.fused_morphfc_reduce(*CASES["morphfc_reduce"][0])
    conv_chain.layout_pin(x)
    assert [f.launches for f in wrappers] == before
