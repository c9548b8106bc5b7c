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
import math
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


# ---- the kernels' plans and index arithmetic (pure Python: the CUDA
# kernels run only on the card, test_torch_cuda.py) ----------------------

_DMA = [(328, 112), (322, 112), (328, 28), (328, 128)]


@pytest.mark.parametrize("Wp,C", _DMA + [(331, 112), (326, 28), (64, 8), (5, 3), (4000, 8)])
@pytest.mark.parametrize("sms,slabs", [(132, 2), (114, 2), (132, 3)])
def test_slab_piece_spreads_over_the_card(Wp, C, sms, slabs):
    """A piece is a whole number of 16-byte units a row and stages at most
    SLAB_PIECE_BYTES; the pieces cover the row once (a ragged last piece
    included), and the grid (pieces x slabs) covers most of the SMs
    without exceeding them, unless the row or the byte cap runs out."""
    R = 6
    piece = probes.slab_piece(Wp, C, R, slabs, sms)
    unit = next(u for u in range(1, 9) if u * C * 2 % 16 == 0)
    assert piece >= unit and piece % unit == 0
    pieces = -(-Wp // piece)
    assert (pieces - 1) * piece < Wp <= pieces * piece
    assert R * piece * C * 2 <= max(probes.SLAB_PIECE_BYTES, R * unit * C * 2)
    assert pieces * slabs <= sms or piece == unit
    if (Wp, C) in _DMA:
        assert pieces * slabs >= 0.8 * sms


def test_slab_piece_at_the_primary_probe():
    """dma_sub328_lane112 on 132 SMs: 66 pieces of 5 columns a slab, one
    block on every SM (was 7 pieces of 64 KB a slab)."""
    assert probes.slab_piece(328, 112, 6, 2, 132) == 5


R8, W320 = 8, 320  # the stage-0 tile: 8 rows of 320 output columns


def _s28():
    return probes.GemmForm("assembled", M=R8 * W320, K=9 * 28, Wo=W320, Cx=128, cg=28, stride=28)


_PLAN_CASES = [  # (form, N, reps): every probe, the all-SM forms, odd shapes
    (_s28(), 168, 1), (_s28(), 168, 132),
    (probes.GemmForm("assembled", M=2560, K=288, Wo=320, Cx=128, cg=28, stride=32), 168, 132),
    (probes.GemmForm("taps", M=2560, K=28, taps=9, Wo=320, Cx=128), 168, 1),
    (probes.GemmForm("rows", M=2560, K=128, taps=3, lda=128, tap_stride=320 * 128), 168, 132),
    (probes.GemmForm("cols", M=384, K=288, batch=8, lda=384), 168, 1),
    (probes.GemmForm("cols", M=384, K=288, batch=16, lda=384), 168, 1),
    (probes.GemmForm("rows", M=2560, K=252, lda=252), 168, 1),
    (probes.GemmForm("rows", M=100, K=64, lda=64), 8, 1),
    (probes.GemmForm("rows", M=100, K=64, lda=64), 192, 3),
    (probes.GemmForm("taps", M=2 * 70, K=40, taps=9, Wo=70, Cx=40), 192, 1),
    (probes.GemmForm("cols", M=68, K=36, batch=2, lda=68), 56, 1),
    (probes.GemmForm("rows", M=1000, K=1000, lda=1000), 56, 1)]


@pytest.mark.parametrize("form,N,reps", _PLAN_CASES)
@pytest.mark.parametrize("tma", [True, False])
def test_gemm_plan_fits_and_is_whole(form, N, reps, tma):
    """The plan's width is compiled (whole 64-column atoms), its column
    tiles hold N (none empty), its grid is a multiple of the tiles and no
    larger than the units, a tap's K is padded to whole stages of 32 or 64
    columns, its B boxes divide Kp (at most 256 rows), its ring is deep
    enough for the path (4 stages by TMA, 5 by cp.async) and its shared
    memory fits a block."""
    plan = probes.gemm_plan(form, N, reps, sms=132, tma=tma)
    taps, Kt, R, W = probes.gemm_geometry(form)
    assert plan.nt in probes.GEMM_WIDTHS
    assert (plan.splits - 1) * plan.nt < N <= plan.splits * plan.nt
    assert plan.units == R * -(-W // 64) * form.batch * reps * plan.splits
    assert plan.grid % plan.splits == 0 and plan.splits <= plan.grid <= min(plan.units, 132)
    assert plan.kw in (32, 64) and plan.Kp % plan.kw == 0 and plan.Kp - plan.kw < Kt <= plan.Kp
    assert plan.kbox % 8 == 0 and plan.kbox <= 256 and plan.Kp % plan.kbox == 0
    assert (4 if tma else 5) <= plan.ring <= probes.GEMM_MAX_RING
    conv = form.kind in ("taps", "assembled")
    assert plan.smem == probes.gemm_smem(taps, plan.Kp, plan.nt, plan.kw, plan.ring, conv)
    assert plan.smem <= probes.SMEM_MAX


def test_gemm_plan_fills_the_card():
    """The stage-0 conv tile (2560 x 168) is cut into 40 row tiles x 3
    column tiles of 64 (120 blocks on 132 SMs), its nine taps as 32-column
    stages; run on every SM at once it keeps whole 192-column tiles, one
    persistent block an SM; the smaller cols probe (8 x 384 rows) splits
    in two."""
    one = probes.gemm_plan(_s28(), 168, sms=132)
    assert (one.nt, one.splits, one.grid, one.kw, one.Kp) == (64, 3, 120, 32, 32)
    many = probes.gemm_plan(_s28(), 168, reps=132, sms=132)
    assert (many.nt, many.splits, many.grid, many.units) == (192, 1, 132, 5280)
    cols = probes.GemmForm("cols", M=384, K=288, batch=8, lda=384)
    assert (probes.gemm_plan(cols, 168, sms=132).grid, probes.gemm_plan(cols, 168).nt) == (96, 128)


def test_gemm_plan_refuses_what_fits_nowhere():
    """A B that does not fit in shared memory even 64 columns wide raises
    (no fallback)."""
    form = probes.GemmForm("rows", M=64, K=256, taps=9, lda=256, tap_stride=64 * 256)
    with pytest.raises(ValueError, match="does not fit"):
        probes.gemm_plan(form, 64)


@pytest.mark.parametrize("form,ptr,want", [
    (_s28(), 0, True), (_s28(), 8, False),
    (probes.GemmForm("taps", M=74, K=28, taps=9, Wo=37, Cx=28), 0, False),
    (probes.GemmForm("rows", M=2560, K=128, taps=3, lda=128, tap_stride=320 * 128), 0, True),
    (probes.GemmForm("rows", M=2560, K=252, lda=252), 0, False),
    (probes.GemmForm("rows", M=64, K=64, taps=2, lda=64, tap_stride=100), 0, False),
    (probes.GemmForm("cols", M=384, K=288, batch=8, lda=384), 0, True),
    (probes.GemmForm("cols", M=68, K=36, batch=2, lda=68), 0, False)])
def test_gemm_tma_where_rows_align(form, ptr, want):
    """A comes by TMA where its rows (and taps) lie on 16-byte boundaries,
    else by the producer threads' cp.async: the probes' conv tiles, 3dot
    and cols by TMA, mm_2560x252's 504-byte rows by cp.async."""
    assert probes.gemm_tma(form, ptr) is want


# The kernel's shared-memory layouts, modelled byte for byte: TMA boxes
# and the cp.async fallback write swizzled rows, the wgmma descriptors read
# them back.  The 128-byte swizzle moves 16-byte chunk bits 4-6 by address
# bits 7-9, the 64-byte one bits 4-5 by bits 7-8, on absolute addresses
# (the card's wgmma unit and TMA agree on that: a conv tap's descriptor
# starts dx rows into a box, off the swizzle period, with no base offset).

def _swz(addr, mode):
    return addr ^ ((((addr >> 7) & (7 if mode == 1 else 3))) << 4)


def _tma_box(smem, base, rows, mode):
    """A TMA box landing at base: rows (lists of values, 64 or 128 bytes
    each) one after another, swizzled."""
    width = len(rows[0]) * 2
    for i, row in enumerate(rows):
        for e, v in enumerate(row):
            smem[_swz(base + i * width + 2 * e, mode)] = v


def _read_kmajor(smem, start, kw, rows=64):
    """A K-major operand (rows x 16, one k16 step) through its descriptor:
    8-row groups 8 * kw * 2 bytes apart, rows kw * 2 bytes, the swizzle of
    kw * 2-byte rows."""
    mode = 1 if kw == 64 else 2
    return [[smem.get(_swz(start + (i // 8) * 16 * kw + (i % 8) * kw * 2 + 2 * k, mode), "?")
             for k in range(16)] for i in range(rows)]


def _read_mnmajor(smem, start, lbo, cols):
    """An MN-major operand (16 k x cols) through its descriptor: 128-byte
    k rows, 8-row groups 1024 bytes apart, 64-column atoms lbo apart."""
    return [[smem.get(_swz(start + (k // 8) * 1024 + (k % 8) * 128 + (n // 64) * lbo
                           + 2 * (n % 64), 1), "?") for n in range(cols)] for k in range(16)]


def _a_stage_cp(form, a, plan, bi, t, r, w0, k0, base):
    """csrc/probes.cu gemm_stage_copy in Python: each 16-byte chunk the
    producer's threads copy (or zero), at its swizzled place."""
    taps, Kt, R, Wo = probes.gemm_geometry(form)
    flat, smem = a.reshape(-1).tolist(), {}
    kw = plan.kw
    if form.kind == "cols":
        for k in range(64):
            for i in range(8):
                gk, gm = k0 + k, w0 + 8 * i
                vals = [flat[bi * form.K * form.M + gk * form.lda + gm + e]
                        if gk < form.K and gm + e < form.M else 0.0 for e in range(8)]
                dst = base + k * 128 + ((i ^ (k & 7)) << 4)
                for e, v in enumerate(vals):
                    smem[dst + 2 * e] = v
        return smem
    conv = form.kind in ("taps", "assembled")
    rows = -(-taps // 3) * 72 if conv else 64
    for m in range(rows):
        for i in range(kw // 8):
            k = k0 + 8 * i
            w = w0 + (m % 72 if conv else m)
            sw = (m & 7) if kw == 64 else ((m >> 1) & 3)
            if conv:
                src = ((m // 72 + r) * a.shape[1] + w) * form.Cx
                ok = w < a.shape[1]
            else:
                src = t * form.tap_stride + w * form.lda
                ok = w < Wo
            vals = [flat[src + k + e] if ok and k + e < Kt else 0.0 for e in range(8)]
            dst = base + m * kw * 2 + ((i ^ sw) << 4)
            for e, v in enumerate(vals):
                smem[dst + 2 * e] = v
    return smem


def _a_stage_tma(form, a, plan, bi, t, r, w0, k0, base):
    """The A box of the same stage landing (zeros out of bounds)."""
    taps, Kt, R, Wo = probes.gemm_geometry(form)
    smem, kw = {}, plan.kw
    if form.kind == "cols":
        rows = [[float(a[bi, k0 + k, w0 + m]) if k0 + k < form.K and w0 + m < form.M else 0.0
                 for m in range(64)] for k in range(64)]
        _tma_box(smem, base, rows, 1)
        return smem
    if form.kind in ("taps", "assembled"):
        rows = [[float(a[r + dy, w0 + px, k0 + e])
                 if w0 + px < a.shape[1] and k0 + e < Kt and r + dy < a.shape[0] else 0.0
                 for e in range(kw)] for dy in range(-(-taps // 3)) for px in range(72)]
    else:
        flat = a.reshape(-1)
        arows = -(-flat.numel() // form.lda)
        row0 = t * (form.tap_stride // form.lda) + w0
        rows = [[float(flat[(row0 + m) * form.lda + k0 + e])
                 if row0 + m < arows and k0 + e < Kt else 0.0 for e in range(kw)]
                for m in range(64)]
    _tma_box(smem, base, rows, 1 if kw == 64 else 2)
    return smem


_FORMS = [
    ("assembled_s28", lambda: probes.GemmForm("assembled", M=2 * 37, K=9 * 28, Wo=37, Cx=32,
                                              cg=28, stride=28), (4, 80, 32)),
    ("assembled_s32", lambda: probes.GemmForm("assembled", M=2 * 37, K=9 * 32, Wo=37, Cx=32,
                                              cg=28, stride=32), (4, 80, 32)),
    ("taps_K28_Cx32", lambda: probes.GemmForm("taps", M=2 * 37, K=28, taps=9, Wo=37, Cx=32),
     (4, 80, 32)),
    ("taps_K40_Cx48", lambda: probes.GemmForm("taps", M=1 * 70, K=40, taps=9, Wo=70, Cx=48),
     (3, 80, 48)),
    ("rows_K72_3taps", lambda: probes.GemmForm("rows", M=70, K=72, taps=3, lda=72,
                                               tap_stride=80 * 72), (240, 72)),
    ("cols_batch2", lambda: probes.GemmForm("cols", M=72, K=40, batch=2, lda=72), (2, 40, 72)),
]


@pytest.mark.parametrize("path", ["tma", "cp.async"])
@pytest.mark.parametrize("name,form_of,shape", _FORMS, ids=[f[0] for f in _FORMS])
def test_gemm_a_stages_read_the_operand(name, form_of, shape, path):
    """Every A stage -- landed by TMA boxes or copied by the producer's
    threads -- read through the consumer's descriptors (a conv tap dx rows
    into its tap row, each k16 step 32 bytes along the rows, MN-major
    steps 2048 bytes) is the plain operand's block, zeros past M, past K
    and past a tap's channels: for each A form, ragged row tiles, each tap
    and K chunk and batch item."""
    form = form_of()
    a = torch.arange(1, math.prod(shape) + 1, dtype=torch.float32).reshape(shape)
    plan = probes.gemm_plan(form, 8, tma=path == "tma")
    taps, Kt, R, Wo = probes.gemm_geometry(form)
    conv = form.kind in ("taps", "assembled")
    if form.kind == "assembled":  # the nine taps of cg channels
        ops = probes.GemmForm("taps", M=form.M, K=form.cg, taps=9, Wo=form.Wo,
                              Cx=form.Cx).operands(a)
    else:
        ops = form.operands(a)
    stage = _a_stage_tma if path == "tma" else _a_stage_cp
    base = 4096
    for bi in range(form.batch):
        for r in range(R):
            for w0 in range(0, Wo, 64):
                for t0 in range(1 if conv else taps):
                    for c in range(plan.Kp // plan.kw):
                        smem = stage(form, a, plan, bi, t0, r, w0, c * plan.kw, base)
                        for t in (range(9) if conv else [t0]):
                            want_t = ops[t][bi if form.kind == "cols" else 0]
                            a0 = base + ((t // 3) * 72 + t % 3) * plan.kw * 2 if conv else base
                            for s in range(plan.kw // 16):
                                k = c * plan.kw + 16 * s
                                if form.kind == "cols":
                                    got = torch.tensor(_read_mnmajor(smem, a0 + 2048 * s, 0, 64)).T
                                else:
                                    got = torch.tensor(_read_kmajor(smem, a0 + 32 * s, plan.kw))
                                want = torch.zeros(64, 16)
                                m0 = r * Wo + w0
                                blk = want_t[m0:m0 + min(64, Wo - w0), k:k + 16]
                                want[:blk.shape[0], :blk.shape[1]] = blk
                                n = min(64, Wo - w0)  # rows past the image row are not stored
                                torch.testing.assert_close(got[:n], want[:n], rtol=0, atol=0)


@pytest.mark.parametrize("form,N", [(_s28(), 168),
                                    (probes.GemmForm("assembled", M=2560, K=288, Wo=320, Cx=128,
                                                     cg=28, stride=32), 168),
                                    (probes.GemmForm("rows", M=64, K=72, taps=3, lda=72,
                                                     tap_stride=64 * 72), 136),
                                    (probes.GemmForm("cols", M=64, K=300, lda=64), 24)])
def test_gemm_b_image_reads_b(form, N):
    """The B image a block loads (one TMA box of 64 columns x Kp rows x the
    taps an atom, from the (taps, K, N) map -- the assembled form's taps
    stride apart with cg rows each -- zeros out of bounds) read through the
    MN-major descriptors is B_t's block for every tap, K chunk and k16 step
    (zero rows past a tap's K, zero columns past N); the unit walk gives
    each (output, row tile, column tile) to exactly one block, which keeps
    its column tile."""
    plan = probes.gemm_plan(form, N, sms=132)
    taps, Kt, R, W = probes.gemm_geometry(form)
    ktap = form.stride if form.kind == "assembled" else form.K
    b = torch.arange(1, taps * ktap * N + 1, dtype=torch.float32).reshape(taps, ktap, N)
    b_atom = taps * plan.Kp * 128
    tb = taps if plan.kbox == plan.Kp else 1
    for split in range(plan.splits):
        n0, smem = split * plan.nt, {}
        for at in range(plan.nt // 64):
            for t in range(0, taps, tb):
                for k in range(0, plan.Kp, plan.kbox):
                    rows = [[float(b[t + tt, k + kk, n0 + 64 * at + e])
                             if k + kk < Kt and n0 + 64 * at + e < N else 0.0 for e in range(64)]
                            for tt in range(tb) for kk in range(plan.kbox)]
                    _tma_box(smem, at * b_atom + (t * plan.Kp + k) * 128, rows, 1)
        for t in range(taps):
            for k in range(0, plan.Kp, 16):
                got = torch.tensor(_read_mnmajor(smem, (t * plan.Kp + k) * 128, b_atom, plan.nt))
                want = torch.zeros(16, plan.nt)
                blk = b[t, k:min(k + 16, Kt), n0:n0 + plan.nt]
                want[:blk.shape[0], :blk.shape[1]] = blk
                torch.testing.assert_close(got, want, rtol=0, atol=0)
    seen = {}
    for blk in range(plan.grid):
        for u in range(blk, plan.units, plan.grid):
            assert u % plan.splits == blk % plan.splits
            seen[u] = seen.get(u, 0) + 1
    assert sorted(seen) == list(range(plan.units)) and set(seen.values()) == {1}


# ---- the relayout kernel's plan and index arithmetic -------------------------

_RELAY_PROBES = [  # (shape, layout): the eight distinct probes of both tools
    ((8, 328, 128), probes.Layout("slice", rows=320, chans=128, row=1)),
    ((8, 328, 128), probes.Layout("slice", rows=320, chans=128, row=2)),
    ((8, 328, 28), probes.Layout("taps", rows=320, taps=9)),
    ((8, 328, 32), probes.Layout("taps", rows=320, taps=9)),
    ((8, 328, 128), probes.Layout("taps", rows=320, taps=9)),
    ((8, 320, 112), probes.Layout("slice", rows=320, chans=28, ch=28)),
    ((8, 128, 384), probes.Layout("roll", shift=1)),
    ((1, 32, 384), probes.Layout("tile", taps=9))]
_RELAY_IDS = ["subshift1", "subshift2", "lane_store_cg28", "lane_store_cg32",
              "lane_store_cg128", "lane_read_off28", "roll_lane", "sublane_store_t32"]
# ragged shapes: row tiles that are not whole 16-byte units (odd Cout, Bout
# not a multiple of the tile), roll shifts 0, 1, C - 1 and past C, slice
# offsets at every residue mod 8 (rows and channels), taps 1 to 9, a tiling
# whose tile does not divide the input's rows, inputs whose byte count is
# not a whole number of 16-byte units (the staged tail)
_RELAY_RAGGED = (
    [((3, 21, 13), probes.Layout("slice", rows=13, chans=5, row=r, ch=r)) for r in range(8)]
    + [((2, 40, 24), probes.Layout("slice", rows=29, chans=24, row=r)) for r in range(8)]
    + [((2, 30, 7), probes.Layout("taps", rows=30 - t + 1, taps=t)) for t in range(1, 10)]
    + [((3, 11, 28), probes.Layout("taps", rows=3, taps=9))]
    + [((2, 9, 9), probes.Layout("roll", shift=s)) for s in (0, 1, 8, 13, -1)]
    + [((2, 5, 384), probes.Layout("roll", shift=1)), ((1, 7, 3), probes.Layout("roll", shift=2))]
    + [((1, 5, 11), probes.Layout("tile", taps=7)), ((2, 32, 384), probes.Layout("tile", taps=3)),
       ((1, 3, 5), probes.Layout("tile", taps=4))])


def _relay_vec(stage, s):
    """``relay_vec``: the 16 bytes at stage offset s from the two aligned
    16-byte words that hold them, shifted by whole words, then by a byte
    permute of 2 bytes."""
    q = s & ~15
    assert s % 2 == 0 and 0 <= q and q + 32 <= len(stage)
    u = [int(w) for w in stage[q:q + 32].view(np.uint32)]
    if s & 8:
        u = u[2:]
    if s & 4:
        u = u[1:]
    words = [(u[i] >> 16) | ((u[i + 1] & 0xFFFF) << 16) if s & 2 else u[i] for i in range(4)]
    return np.array(words, np.uint32).view(np.uint8)


def _relayout_model(x, layout, plan):
    """The relayout kernel's walk in bytes: each block of ``plan`` stages its
    span (``relayout_span``) from the 16-byte unit below it -- whole units by
    the bulk copy, the tail past the input's last whole unit element by
    element -- into a stage that holds junk elsewhere, tabulates its rows'
    runs (``relayout_row``) and writes the output's 16-byte vectors from them
    (``_relay_vec`` inside one run, element by element across a boundary or
    where a vector is shared with the next block).  Checks that every read
    stays inside what was staged and every output element is written
    once."""
    A, Bin, Cin = x.shape
    kind, p0, p1, Bout, Cout = probes.relayout_args(layout, x.shape)
    src = x.contiguous().view(torch.int16).numpy().view(np.uint8)
    src = src.reshape(-1)
    out = np.zeros(A * Bout * Cout * 2, np.uint8)
    written = np.zeros(A * Bout * Cout, np.int64)
    for a in range(A):
        for bx in range(plan.grid[0]):
            b0, b1 = bx * plan.rows, min(Bout, (bx + 1) * plan.rows)
            lo, hi = probes.relayout_span(kind, p0, p1, Bin, Cin, Cout, a, b0, b1)
            S0 = (2 * lo) & ~15
            S1 = min((2 * hi + 15) & ~15, src.size & ~15)  # src: the input's bytes
            assert S0 <= S1 <= 2 * hi + 15 and (S1 - S0) % 16 == 0
            stage = np.full(plan.stage, 0xCD, np.uint8)
            stage[:S1 - S0] = src[S0:S1]
            stage[S1 - S0:2 * hi - S0] = src[S1:2 * hi]
            staged = 2 * hi - S0
            table = []
            for b in range(b0, b1):
                s0, l0, s1 = probes.relayout_row(kind, p0, p1, Bin, Cin, Cout, a, b)
                assert lo <= s0 and s0 + l0 <= hi and (l0 == Cout or lo <= s1 <= hi - Cout + l0)
                table.append((2 * s0 - S0, l0, 2 * s1 - S0))

            def elem(rel):
                off0, len0, off1 = table[rel // Cout]
                c = rel % Cout
                off = off0 + 2 * c if c < len0 else off1 + 2 * (c - len0)
                assert 0 <= off and off + 2 <= staged
                return stage[off:off + 2]

            e0, e1 = (a * Bout + b0) * Cout, (a * Bout + b1) * Cout
            for k in range(e0 // 8, -(-e1 // 8)):
                v0 = 8 * k
                if v0 >= e0 and v0 + 8 <= e1:
                    rel = v0 - e0
                    off0, len0, off1 = table[rel // Cout]
                    c = rel % Cout
                    if c + 8 <= len0 or len0 <= c and c + 8 <= Cout:
                        s = off0 + 2 * c if c + 8 <= len0 else off1 + 2 * (c - len0)
                        assert s + 16 <= staged
                        vec = _relay_vec(stage, s)
                    else:
                        vec = np.concatenate([elem(rel + j) for j in range(8)])
                    out[2 * v0:2 * v0 + 16] = vec
                    written[v0:v0 + 8] += 1
                else:
                    for e in range(max(v0, e0), min(v0 + 8, e1)):
                        out[2 * e:2 * e + 2] = elem(e - e0)
                        written[e] += 1
    assert (written == 1).all()
    return torch.from_numpy(out.view(np.int16).copy()).view(torch.bfloat16).reshape(A, Bout, Cout)


@pytest.mark.parametrize("shape,layout", _RELAY_PROBES, ids=_RELAY_IDS)
def test_relayout_model_matches_plain_at_the_probes(shape, layout):
    """At every relayout probe's shape the plan's blocks, staged spans, run
    tables and 16-byte vectors reproduce relayout_plain bit for bit."""
    x, _ = _inputs(shape)
    plan = probes.relayout_plan(layout, shape, 132)
    _exact(_relayout_model(x, layout, plan), probes.relayout_plain(x, layout).contiguous())


@pytest.mark.parametrize("sms", [132, 3])
@pytest.mark.parametrize("shape,layout", _RELAY_RAGGED,
                         ids=[f"{lay.kind}{i}" for i, (_, lay) in enumerate(_RELAY_RAGGED)])
def test_relayout_model_matches_plain_ragged(shape, layout, sms):
    """Ragged shapes, on a full card and on three SMs (longer row tiles):
    the model reproduces relayout_plain bit for bit."""
    x, _ = _inputs(shape, seed=3)
    plan = probes.relayout_plan(layout, shape, sms)
    _exact(_relayout_model(x, layout, plan), probes.relayout_plain(x, layout).contiguous())


@pytest.mark.parametrize("shape,layout", _RELAY_PROBES, ids=_RELAY_IDS)
def test_relayout_plan_fills_the_card(shape, layout):
    """At the probes: row tiles of whole 16-byte units, at most
    RELAY_BLOCKS_PER_SM blocks an SM (more only where a block would write
    more than RELAY_MAX_VECTORS vectors) and at least one an SM where the
    output has the rows, shared memory within a block's, about
    RELAY_VECS_PER_THREAD vectors a thread."""
    plan = probes.relayout_plan(layout, shape, 132)
    kind, p0, _, Bout, Cout = probes.relayout_args(layout, shape)
    blocks = plan.grid[0] * plan.grid[1]
    vectors = plan.rows * Cout // 8
    assert plan.rows * Cout * 2 % 16 == 0 and vectors <= probes.RELAY_MAX_VECTORS
    assert min(132, shape[0] * Bout) <= blocks
    assert blocks <= probes.RELAY_BLOCKS_PER_SM * 132 or \
        (plan.rows + 1) * Cout > 8 * probes.RELAY_MAX_VECTORS
    assert plan.grid == (-(-Bout // plan.rows), shape[0])
    assert plan.stage == probes.relayout_stage_bytes(kind, p0, shape[1], shape[2], Cout, plan.rows)
    assert plan.smem == probes.relayout_smem(kind, p0, shape[1], shape[2], Cout, plan.rows)
    assert plan.smem <= probes.SMEM_MAX
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= probes.RELAY_MAX_THREADS
    assert plan.threads >= min(probes.RELAY_MAX_THREADS, vectors // probes.RELAY_VECS_PER_THREAD)


def test_relayout_plan_at_the_primary_probe():
    """lane_store_cg28 on 132 SMs: row tiles of 10 rows (5040 bytes: 315
    vectors), 32 a frame, 256 blocks of 160 threads; lane_store_cg128: 5
    rows (720 vectors, the most a block takes), 512 blocks of 256."""
    plan = probes.relayout_plan(probes.Layout("taps", rows=320, taps=9), (8, 328, 28), 132)
    assert (plan.rows, plan.grid, plan.threads) == (10, (32, 8), 160)
    plan = probes.relayout_plan(probes.Layout("taps", rows=320, taps=9), (8, 328, 128), 132)
    assert (plan.rows, plan.grid, plan.threads) == (5, (64, 8), 256)


@pytest.mark.parametrize("shape,layout,ptr,match", [
    ((8, 328, 28), probes.Layout("taps", rows=320, taps=9), 8, "16-byte"),
    ((8, 328, 28), probes.Layout("taps", rows=320, taps=9), 2, "16-byte"),
    ((2, 10, 8), probes.Layout("slice", rows=0, chans=8), 0, "empty"),
    ((2, 10, 8), probes.Layout("taps", rows=4, taps=0), 0, "empty"),
    ((2, 10, 8), probes.Layout("slice", rows=8, chans=8, row=3), 0, "outside"),
    ((2, 10, 8), probes.Layout("slice", rows=4, chans=5, ch=4), 0, "outside"),
    ((2, 10, 8), probes.Layout("taps", rows=8, taps=4), 0, "rows"),
    ((70000, 2, 8), probes.Layout("roll", shift=1), 0, "65535"),
    ((1, 2, 120000), probes.Layout("roll", shift=1), 0, "shared memory"),
    ((1, 4000, 40), probes.Layout("taps", rows=1000, taps=3000), 0, "shared memory"),
    ((2, 10, 8), probes.Layout("gather"), 0, "unknown")])
def test_relayout_plan_refuses(shape, layout, ptr, match):
    """What the kernel does not take raises from the plan, which the
    wrapper runs before every launch: a misaligned input, an empty output,
    a slice or taps outside the input, too many frames, a stage past a
    block's shared memory, an unknown map."""
    with pytest.raises(ValueError, match=match):
        probes.relayout_plan(layout, shape, 132, ptr)


def test_relayout_wrapper_refuses_an_unknown_map_on_the_cpu():
    x, _ = _inputs((2, 4, 8))
    with pytest.raises(ValueError, match="unknown"):
        probes.smem_relayout(x, probes.Layout("gather"))
