"""Probe kernels: the Hopper counterparts of the Mosaic probes.

The JAX package settled its grouped-conv kernel design with two probe
tools (``tools/exp_mosaic_probe.py``, ``tools/exp_mosaic_probe2.py``):
which copies and layouts its compiler takes, and how fast the candidate
inner products of a conv tile run.  Here they are three CUDA kernels of
``csrc/probes.cu`` (design notes there), each with its plain PyTorch
version beside it and a ``.launches`` counter; CPU tensors take the plain
version, CUDA tensors the kernel, which raises on what it does not take.
Every tensor is bf16.  ``vmg_tpu_torch.tools.exp_probe`` and
``exp_probe2`` drive them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from vmg_tpu_torch import _build

SLAB_PIECE_BYTES = 64 * 1024  # the largest slab piece one block stages


def _require_bf16(t, name):
    _build.require(t, name, dtype=torch.bfloat16)


def slab_copy_plain(x, R: int = 6, slabs: int = 2):
    """Rows 1 .. R-2 of the halo'd row slabs i * (R - 2) .. + R of frame 0:
    x (N, H2, Wp, C) -> (slabs, R - 2, Wp, C)."""
    return torch.stack([x[0, i * (R - 2) + 1:i * (R - 2) + R - 1] for i in range(slabs)])


def slab_piece(Wp: int, C: int, R: int) -> int:
    """Columns per slab piece: at most SLAB_PIECE_BYTES per piece, a whole
    number of 16-byte units per row (the bulk copy's rule)."""
    unit = 1
    while unit * C * 2 % 16:
        unit += 1
    return max(unit, SLAB_PIECE_BYTES // (R * C * 2) // unit * unit)


def slab_copy(x, R: int = 6, slabs: int = 2):
    """The slab copy of :func:`slab_copy_plain` through bulk asynchronous
    copies (TMA) into shared memory."""
    if x.device.type == "cpu":
        return slab_copy_plain(x, R, slabs)
    _require_bf16(x, "x")
    _, H2, Wp, C = x.shape
    if (slabs - 1) * (R - 2) + R > H2:
        raise ValueError(f"{slabs} slabs of {R} rows need {(slabs - 1) * (R - 2) + R} rows, "
                         f"x has {H2}")
    if Wp * C * 2 % 16:
        raise ValueError(f"a row of {Wp} x {C} bf16 is {Wp * C * 2} bytes; bulk copies move "
                         "multiples of 16 bytes from 16-byte aligned addresses")
    out = torch.empty((slabs, R - 2, Wp, C), dtype=x.dtype, device=x.device)
    code = _build.load_library().vmg_probe_slab_copy(
        x.data_ptr(), out.data_ptr(), Wp, C, R, slabs, slab_piece(Wp, C, R),
        _build.stream_of(x))
    _build.check(code, "vmg_probe_slab_copy")
    slab_copy.launches += 1
    return out


slab_copy.launches = 0

# the relayout maps: kind -> the C entry's code
_KINDS = {"slice": 0, "taps": 1, "roll": 2, "tile": 3}


@dataclasses.dataclass(frozen=True)
class Layout:
    """An index map of :func:`smem_relayout` over (A, B, C) tensors:
    "slice" (out[a, b, c] = in[a, b + row, c + ch], ``rows`` x ``chans``
    of it), "taps" (out[a, b, t * C + k] = in[a, b + t, k], t < ``taps``,
    ``rows`` rows), "roll" (out[a, b, c] = in[a, b, (c - shift) mod C]) or
    "tile" (out[a, b, c] = in[a, b mod B, c], ``taps`` copies of the rows)."""
    kind: str
    rows: int = 0
    chans: int = 0
    row: int = 0
    ch: int = 0
    taps: int = 0
    shift: int = 0

    def out_shape(self, A, B, C):
        if self.kind == "slice":
            return A, self.rows, self.chans
        if self.kind == "taps":
            return A, self.rows, self.taps * C
        if self.kind == "roll":
            return A, B, C
        return A, self.taps * B, C


def relayout_plain(x, layout: Layout):
    """x (A, B, C) -> the layout's output."""
    k = layout.kind
    if k == "slice":
        return x[:, layout.row:layout.row + layout.rows, layout.ch:layout.ch + layout.chans]
    if k == "taps":
        return torch.cat([x[:, t:t + layout.rows] for t in range(layout.taps)], dim=-1)
    if k == "roll":
        return torch.roll(x, layout.shift, 2)
    if k == "tile":
        return x.repeat(1, layout.taps, 1)
    raise ValueError(f"unknown layout {k!r}")


def smem_relayout(x, layout: Layout):
    """x (A, B, C) -> its copy in ``layout``, staged through shared memory."""
    if layout.kind not in _KINDS:
        raise ValueError(f"unknown layout {layout.kind!r}")
    if x.device.type == "cpu":
        return relayout_plain(x, layout).contiguous()
    _require_bf16(x, "x")
    A, B, C = x.shape
    if layout.kind == "slice" and (layout.row + layout.rows > B or layout.ch + layout.chans > C):
        raise ValueError(f"slice {layout} is outside x {tuple(x.shape)}")
    if layout.kind == "taps" and layout.rows + layout.taps - 1 > B:
        raise ValueError(f"{layout.taps} taps of {layout.rows} rows need "
                         f"{layout.rows + layout.taps - 1} rows, x has {B}")
    out = torch.empty(layout.out_shape(A, B, C), dtype=x.dtype, device=x.device)
    p0, p1 = {"slice": (layout.row, layout.ch), "taps": (layout.taps, 0),
              "roll": (layout.shift, 0), "tile": (0, 0)}[layout.kind]
    code = _build.load_library().vmg_probe_relayout(
        x.data_ptr(), out.data_ptr(), A, B, C, out.shape[1], out.shape[2],
        _KINDS[layout.kind], p0, p1, _build.stream_of(x))
    _build.check(code, "vmg_probe_relayout")
    smem_relayout.launches += 1
    return out


smem_relayout.launches = 0


@dataclasses.dataclass(frozen=True)
class GemmForm:
    """How :func:`tile_gemm` reads its A operand (M x K per tap and batch
    item): "rows" (a[t * tap_stride + m * lda + k]), "cols" (a[bi][k][m],
    lda = M: the contraction of a's dim 1), "taps" (tap t = (dy, dx) of a
    3x3 conv over an (R + 2, Wx, Cx) slab: row m = r * Wo + w reads
    a[dy + r, dx + w, :K], nine taps) or "assembled" (the nine taps as one
    operand of K = 9 * stride columns, tap t's cg channels at t * stride,
    zeros in the gaps)."""
    kind: str
    M: int
    K: int
    taps: int = 1
    batch: int = 1
    lda: int = 0
    tap_stride: int = 0
    Wo: int = 0
    Cx: int = 0
    cg: int = 0
    stride: int = 0

    def operands(self, a):
        """The plain A operands, one (batch, M, K) tensor per tap."""
        if self.kind == "rows":
            flat = a.flatten()
            return [flat[t * self.tap_stride:].as_strided((1, self.M, self.K), (0, self.lda, 1))
                    for t in range(self.taps)]
        if self.kind == "cols":
            return [a.transpose(1, 2)]
        R = self.M // self.Wo
        cols = [a[t // 3:t // 3 + R, t % 3:t % 3 + self.Wo] for t in range(9)]
        if self.kind == "taps":
            return [c[..., :self.K].reshape(1, self.M, self.K) for c in cols]
        gap = self.stride - self.cg
        return [torch.cat([F.pad(c[..., :self.cg], (0, gap)) for c in cols],
                          dim=-1).reshape(1, self.M, self.K)]


_GEMM_KINDS = {"rows": 0, "cols": 1, "taps": 2, "assembled": 3}


def tile_gemm_plain(a, b, form: GemmForm):
    """sum over taps of A_t @ b[t] in f32, rounded once: (batch, M, N)."""
    b = b.reshape(form.taps, form.K, -1)
    acc = sum(At.float() @ b[t].float() for t, At in enumerate(form.operands(a)))
    return acc.to(torch.bfloat16)


def tile_gemm(a, b, form: GemmForm, reps: int = 1):
    """The product of :func:`tile_gemm_plain` on the tensor cores;
    ``reps`` > 1 runs the same product that many times at once (one
    output each): (reps, batch, M, N), or (batch, M, N) for reps == 1."""
    if form.kind not in _GEMM_KINDS:
        raise ValueError(f"unknown A form {form.kind!r}")
    if a.device.type == "cpu":
        out = tile_gemm_plain(a, b, form)
        return out if reps == 1 else out.expand(reps, *out.shape).contiguous()
    _require_bf16(a, "a")
    _build.require(b, "b", dtype=torch.bfloat16, device=a.device)
    N = b.shape[-1]
    if b.numel() != form.taps * form.K * N:
        raise ValueError(f"b {tuple(b.shape)} is not {form.taps} x {form.K} x N")
    if N % 8 or N > 192:
        raise ValueError(f"N = {N}: the kernel takes N % 8 == 0, N <= 192")
    if any(v % 4 for v in (form.K, form.lda, form.tap_stride, form.Cx, form.cg, form.stride)) \
            or (form.kind == "cols" and form.M % 4):
        raise ValueError(f"{form}: the kernel reads A in 4-element units, so K, the strides "
                         "and the channel counts (M for 'cols') are multiples of 4")
    if form.kind in ("taps", "assembled"):
        R = form.M // form.Wo
        if form.M % form.Wo or a.dim() != 3 or a.shape[0] < R + 2 or a.shape[1] < form.Wo + 2 \
                or a.shape[2] != form.Cx:
            raise ValueError(f"a {tuple(a.shape)} is not an ({R + 2}, >= {form.Wo + 2}, "
                             f"{form.Cx}) slab")
    if form.kind == "cols" and tuple(a.shape) != (form.batch, form.K, form.M):
        raise ValueError(f"a {tuple(a.shape)} is not ({form.batch}, {form.K}, {form.M})")
    if form.kind == "rows" and a.numel() < (form.taps - 1) * form.tap_stride + \
            (form.M - 1) * form.lda + form.K:
        raise ValueError(f"a {tuple(a.shape)} is too small for {form}")
    out = torch.empty((reps, form.batch, form.M, N), dtype=a.dtype, device=a.device)
    Wx = a.shape[1] if form.kind in ("taps", "assembled") else 0
    code = _build.load_library().vmg_probe_tile_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), form.M, N, form.K, form.taps, form.batch,
        reps, _GEMM_KINDS[form.kind], form.lda, form.tap_stride,
        form.K * form.M if form.kind == "cols" else 0, form.Wo, Wx, form.Cx, form.cg,
        form.stride, _build.stream_of(a))
    _build.check(code, "vmg_probe_tile_gemm")
    tile_gemm.launches += 1
    return out[0] if reps == 1 else out


tile_gemm.launches = 0
