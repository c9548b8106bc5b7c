"""The probe kernels' plain versions against the JAX probe tools' oracles.

The JAX tools (``tools/exp_mosaic_probe.py``, ``tools/exp_mosaic_probe2.py``)
keep their oracle expressions in closures inside ``main()``; each is
recomputed here with ``jnp`` on the same seeded numpy input as the port's
plain version.  Copies must be bit-exact; products agree within 1 bf16 ulp
of the largest output (8e-3 of it: f32 sums in another order, then one
rounding).  On CPU tensors the wrappers take the plain versions, so the
probe command lines run here with ``--device cpu``.  The kernels
themselves are checked in ``test_torch_cuda.py``.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmg_tpu_torch.ops import probes
from vmg_tpu_torch.tools import exp_probe, exp_probe2

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
ULP = 8e-3


def _inputs(shape, seed=0, scale=None):
    rng = np.random.default_rng(seed)
    a = (rng.random(shape, np.float32) if scale is None
         else rng.standard_normal(shape).astype(np.float32) * scale)
    return torch.from_numpy(a).to(torch.bfloat16), jnp.asarray(a, jnp.bfloat16)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _exact(got, want):
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(_np(got), _np(want))


def _ulp(got, want):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= ULP * np.abs(w).max()


@pytest.mark.parametrize("Wp,C", [(328, 112), (322, 112), (328, 28), (328, 128)])
def test_slab_copy_plain_matches_oracle(Wp, C):
    x, xj = _inputs((2, 20, Wp, C))
    R = 6
    _exact(probes.slab_copy_plain(x, R), jnp.stack([xj[0, 1:R - 1], xj[0, R - 1:2 * R - 3]]))


def _taps_oracle(xj):
    return jnp.concatenate([xj[:, t:t + 320] for t in range(9)], axis=-1)


@pytest.mark.parametrize("shape,layout,oracle", [
    ((8, 328, 128), probes.Layout("slice", rows=320, chans=128, row=1), lambda x: x[:, 1:321]),
    ((8, 328, 128), probes.Layout("slice", rows=320, chans=128, row=2), lambda x: x[:, 2:322]),
    ((8, 328, 28), probes.Layout("taps", rows=320, taps=9), _taps_oracle),
    ((8, 328, 32), probes.Layout("taps", rows=320, taps=9), _taps_oracle),
    ((8, 328, 128), probes.Layout("taps", rows=320, taps=9), _taps_oracle),
    ((8, 320, 112), probes.Layout("slice", rows=320, chans=28, ch=28), lambda x: x[:, :, 28:56]),
    ((8, 128, 384), probes.Layout("roll", shift=1), lambda x: jnp.roll(x, 1, 2)),
    ((1, 32, 384), probes.Layout("tile", taps=9), lambda x: jnp.tile(x[0], (9, 1))[None]),
], ids=["subshift1", "subshift2", "lane_store_cg28", "lane_store_cg32", "lane_store_cg128",
        "lane_read_off28", "roll_lane", "sublane_store_t32"])
def test_relayout_plain_matches_oracle(shape, layout, oracle):
    x, xj = _inputs(shape)
    _exact(probes.relayout_plain(x, layout), oracle(xj))
    _exact(probes.smem_relayout(x, layout), oracle(xj))  # the wrapper on a CPU tensor


def _dot(a, b, contract):
    return jax.lax.dot_general(a, b, (contract, ((), ())),
                               preferred_element_type=jnp.float32).astype(jnp.bfloat16)


@pytest.mark.parametrize("shape_lhs", [(8, 288, 384), (16, 288, 384), (2560, 252)])
def test_mm_plain_matches_oracle(shape_lhs):
    K = shape_lhs[-2] if len(shape_lhs) == 3 else shape_lhs[1]
    a, aj = _inputs(shape_lhs, seed=1)
    b, bj = _inputs((K, 168), seed=2)
    if len(shape_lhs) == 3:
        form = probes.GemmForm("cols", M=shape_lhs[2], K=K, batch=shape_lhs[0], lda=shape_lhs[2])
        want = _dot(aj, bj, ((1,), (0,)))
    else:
        form = probes.GemmForm("rows", M=shape_lhs[0], K=K, lda=K)
        want = _dot(aj, bj, ((1,), (0,)))[None]
    _ulp(probes.tile_gemm_plain(a, b, form), want)


R, W, CG, FG = 8, 320, 28, 168


def _tile_oracle(xj, wj):
    """The stage-0 tile as nine tap products accumulated in f32, rounded once."""
    acc = sum(jax.lax.dot_general(xj[dy:dy + R, dx:dx + W, :CG].reshape(R * W, CG),
                                  wj[dy * 3 + dx], (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.float32)
              for dy in range(3) for dx in range(3))
    return acc.astype(jnp.bfloat16)


def test_tile_forms_agree():
    """The three A-operand forms of the conv tile compute one function on
    the plain path, and JAX's tap sum; the stride-32 patch holds zeros in
    its gaps (the weight's gap rows hold junk that must not count)."""
    x, xj = _inputs((R + 2, 328, 128), seed=3)
    w, wj = _inputs((9, CG, FG), seed=4, scale=0.05)
    want = _tile_oracle(xj, wj)[None]
    taps = probes.GemmForm("taps", M=R * W, K=CG, taps=9, Wo=W, Cx=128)
    _ulp(probes.tile_gemm_plain(x, w, taps), want)
    s28 = probes.GemmForm("assembled", M=R * W, K=9 * CG, Wo=W, Cx=128, cg=CG, stride=CG)
    _ulp(probes.tile_gemm_plain(x, w.reshape(9 * CG, FG), s28), want)
    w32 = torch.cat([w, torch.full((9, 4, FG), 7.0, dtype=w.dtype)], dim=1)
    s32 = probes.GemmForm("assembled", M=R * W, K=9 * 32, Wo=W, Cx=128, cg=CG, stride=32)
    _ulp(probes.tile_gemm_plain(x, w32.reshape(9 * 32, FG), s32), want)
    patch = s32.operands(x)[0].reshape(R * W, 9, 32)
    assert not patch[..., CG:].any()


def test_tile_3dot_plain_matches_oracle():
    x, xj = _inputs((R + 2, W, 128), seed=5)
    w, wj = _inputs((3, 128, FG), seed=6, scale=0.05)
    acc = sum(jax.lax.dot_general(xj[dy:dy + R].reshape(R * W, 128), wj[dy],
                                  (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32)
              for dy in range(3))
    form = probes.GemmForm("rows", M=R * W, K=128, taps=3, lda=128, tap_stride=W * 128)
    _ulp(probes.tile_gemm_plain(x, w, form), acc.astype(jnp.bfloat16)[None])


def _jax_probe_names(path):
    """The probe names a JAX tool prints, from its source."""
    with open(os.path.join(REPO, path)) as f:
        return re.findall(r'probe\("(\w+)"', f.read())


@pytest.mark.parametrize("tool,path", [(exp_probe, "tools/exp_mosaic_probe.py"),
                                       (exp_probe2, "tools/exp_mosaic_probe2.py")])
def test_probe_cli_on_cpu(tool, path, capsys):
    """One JSON line per probe of the JAX tool, in its order and under its
    names, each with maxdiff 0 (the plain versions against themselves) and
    no time (no device); exit code 0."""
    assert tool.main(["--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    names = [next(iter(d)) for d in lines]
    assert names == _jax_probe_names(path)
    for d in lines:
        r = next(iter(d.values()))
        assert r["device"] == "cpu" and r["maxdiff"] == 0.0 and r["ms"] is None, r
        assert r["bound_ms"] > 0


def test_probe_cli_fails_on_a_failing_probe(capsys):
    """A probe that raises prints "ERR ..." under its name, and the tool
    exits 1."""
    def broken(dev, rng):
        raise RuntimeError("boom")

    assert exp_probe._main({"broken": broken}, ["--device", "cpu"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["broken"].startswith("ERR RuntimeError: boom")


def test_probe_wrappers_refuse_non_cpu_non_cuda_tensors():
    m = torch.empty((2, 20, 328, 112), device="meta", dtype=torch.bfloat16)
    counters = (probes.slab_copy, probes.smem_relayout, probes.tile_gemm)
    before = [f.launches for f in counters]
    with pytest.raises(ValueError, match="CUDA"):
        probes.slab_copy(m)
    with pytest.raises(ValueError, match="CUDA"):
        probes.smem_relayout(m[0], probes.Layout("roll", shift=1))
    with pytest.raises(ValueError, match="CUDA"):
        probes.tile_gemm(m[0, 0], m[0, 0, :112, :112],
                         probes.GemmForm("rows", M=328, K=112, lda=112))
    assert [f.launches for f in counters] == before
