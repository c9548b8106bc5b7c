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
import math

import torch
import torch.nn.functional as F

from vmg_tpu_torch import _build

SLAB_PIECE_BYTES = 64 * 1024  # the largest slab piece one block stages
# the tile GEMM kernel's compiled column-tile widths (csrc/probes.cu:
# whole 64-column swizzle atoms), its row tile, its A stages at most, and
# the shared memory a block may use
GEMM_WIDTHS = (64, 128, 192)
GEMM_TILE_M = 64
GEMM_MAX_RING = 16
SMEM_MAX = 232448


def _require_bf16(t, name):
    _build.require(t, name, dtype=torch.bfloat16)


def slab_copy_plain(x, R: int = 6, slabs: int = 2):
    """Rows 1 .. R-2 of the halo'd row slabs i * (R - 2) .. + R of frame 0:
    x (N, H2, Wp, C) -> (slabs, R - 2, Wp, C)."""
    return torch.stack([x[0, i * (R - 2) + 1:i * (R - 2) + R - 1] for i in range(slabs)])


def slab_piece(Wp: int, C: int, R: int, slabs: int = 2, sms: int = 132) -> int:
    """Columns per slab piece, one block each: about ``sms // slabs``
    pieces a slab, so that the grid covers the card; at most
    SLAB_PIECE_BYTES staged a block; a whole number of 16-byte units a row
    (the bulk copy's rule)."""
    unit = 8 // math.gcd(8, C)
    units = -(-Wp // unit)
    piece = -(-units // max(1, sms // slabs)) * unit
    return min(piece, max(unit, SLAB_PIECE_BYTES // (R * C * 2) // unit * unit))


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
    piece = slab_piece(Wp, C, R, slabs, _build.sm_count(x.device.index))
    code = _build.load_library().vmg_probe_slab_copy(
        x.data_ptr(), out.data_ptr(), Wp, C, R, slabs, piece, _build.stream_of(x))
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


# the relayout kernel's cut (chosen on the card among 1-4 blocks an SM and
# 2-4 vectors a thread at the probes' shapes): blocks an SM at most (all
# resident at once), threads a block at most, 16-byte output vectors a
# thread (the aim) and a block (at most: three a thread)
RELAY_BLOCKS_PER_SM = 2
RELAY_MAX_THREADS = 256
RELAY_VECS_PER_THREAD = 2
RELAY_MAX_VECTORS = 3 * RELAY_MAX_THREADS


def relayout_args(layout: Layout, shape):
    """(kind code, p0, p1, Bout, Cout): the C entry's map parameters for an
    input of ``shape`` (A, B, C); a roll's shift taken mod C."""
    A, B, C = shape
    _, Bout, Cout = layout.out_shape(A, B, C)
    p0, p1 = {"slice": (layout.row, layout.ch), "taps": (layout.taps, 0),
              "roll": (layout.shift % C if C else 0, 0), "tile": (0, 0)}[layout.kind]
    return _KINDS[layout.kind], p0, p1, Bout, Cout


def relayout_span(kind, p0, p1, Bin, Cin, Cout, a, b0, b1):
    """Flat input elements [lo, hi) that output rows [b0, b1) of frame a
    read (``relay_span`` in csrc/probes.cu): one contiguous range; a
    tiling block that wraps past the last input row stages the whole
    frame."""
    f = a * Bin
    if kind == 0:
        return (f + b0 + p0) * Cin + p1, (f + b1 - 1 + p0) * Cin + p1 + Cout
    if kind == 1:
        return (f + b0) * Cin, (f + b1 - 1 + p0) * Cin
    if kind == 2:
        return (f + b0) * Cin, (f + b1) * Cin
    r0, n = b0 % Bin, b1 - b0
    if r0 + n > Bin:
        r0, n = 0, Bin
    return (f + r0) * Cin, (f + r0 + n) * Cin


def relayout_row(kind, p0, p1, Bin, Cin, Cout, a, b):
    """Output row b of frame a as runs of input (``relay_row``): (src0,
    len0, src1) -- element c < len0 is flat input element src0 + c, the
    rest src1 + c - len0 (a roll's two runs; one run elsewhere)."""
    f = a * Bin
    if kind == 0:
        return (f + b + p0) * Cin + p1, Cout, 0
    if kind == 1:
        return (f + b) * Cin, Cout, 0
    if kind == 2:
        return (f + b) * Cin + Cin - p0, p0, (f + b) * Cin
    return (f + b % Bin) * Cin, Cout, 0


def relayout_stage_bytes(kind, p0, Bin, Cin, Cout, rows) -> int:
    """A block's stage: its span at most (a full row tile's; the whole
    frame for a tiling whose blocks can wrap), from the 16-byte unit below
    its first element, and 48 bytes more for the aligned reads past it."""
    span = {0: (rows - 1) * Cin + Cout, 1: (rows - 1 + p0) * Cin, 2: rows * Cin,
            3: (Bin if rows > Bin or Bin % rows else rows) * Cin}[kind]
    return -(-2 * span // 16) * 16 + 48


def relayout_smem(kind, p0, Bin, Cin, Cout, rows) -> int:
    """A block's shared memory: the stage, the rows' run table (three ints
    a row), the mbarrier."""
    return relayout_stage_bytes(kind, p0, Bin, Cin, Cout, rows) + -(-12 * rows // 8) * 8 + 8


@dataclasses.dataclass(frozen=True)
class RelayPlan:
    """How :func:`smem_relayout`'s kernel cuts a copy: row tiles of
    ``rows`` output rows, a block each, ``grid`` = (row tiles, A);
    ``threads`` a block; ``stage`` bytes of staged input and ``smem`` bytes
    of shared memory a block (the C entry takes both and checks them)."""
    rows: int
    grid: tuple
    threads: int
    stage: int
    smem: int


def relayout_plan(layout: Layout, shape, sms: int = 132, ptr: int = 0) -> RelayPlan:
    """The relayout kernel's cut of ``layout`` over an input of ``shape``
    at address ``ptr``, from the shapes and the SM count only.  A row tile
    is a whole number of 16-byte units where it can be (rows a multiple of
    8 / gcd(8, Cout)), and the least such that the grid stays within
    RELAY_BLOCKS_PER_SM blocks an SM; fewer rows where the stage would not
    fit or a block would write more than RELAY_MAX_VECTORS 16-byte output
    vectors; RELAY_VECS_PER_THREAD vectors a thread, up to
    RELAY_MAX_THREADS threads.  Raises on what the kernel does
    not take: an empty output, an input that is not 16-byte aligned, a
    slice or taps outside the input, more than 65535 frames, a stage that
    does not fit a block's shared memory at any row tile."""
    if layout.kind not in _KINDS:
        raise ValueError(f"unknown layout {layout.kind!r}")
    A, Bin, Cin = shape
    kind, p0, p1, Bout, Cout = relayout_args(layout, shape)
    if min(A, Bin, Cin, Bout, Cout) < 1:
        raise ValueError(f"{layout} of an input {tuple(shape)} has an empty output")
    if ptr % 16:
        raise ValueError("the relayout stages its input by bulk copies, which read 16-byte "
                         f"aligned addresses; the input is at {ptr:#x}")
    if layout.kind == "slice" and (p0 < 0 or p1 < 0 or p0 + Bout > Bin or p1 + Cout > Cin):
        raise ValueError(f"slice {layout} is outside x {tuple(shape)}")
    if layout.kind == "taps" and Bout + p0 - 1 > Bin:
        raise ValueError(f"{p0} taps of {Bout} rows need {Bout + p0 - 1} rows, x has {Bin}")
    if A > 65535:
        raise ValueError(f"{A} frames: the kernel's grid takes at most 65535")
    unit = 8 // math.gcd(8, Cout)
    per_frame = max(1, RELAY_BLOCKS_PER_SM * sms // A)  # row tiles a frame at most
    rows = -(-Bout // per_frame)
    rows = -(-rows // unit) * unit
    while rows > unit and (relayout_smem(kind, p0, Bin, Cin, Cout, rows) > SMEM_MAX
                           or rows * Cout > 8 * RELAY_MAX_VECTORS):
        rows -= unit
    if layout.kind == "tile" and rows < Bin and Bin % rows:
        rows = max(d for d in range(1, rows + 1) if Bin % d == 0)  # no block wraps
    smem = relayout_smem(kind, p0, Bin, Cin, Cout, rows)
    if smem > SMEM_MAX:
        raise ValueError(f"{layout} of an input {tuple(shape)}: a block's stage ({smem} bytes "
                         f"at {rows} rows) does not fit its shared memory ({SMEM_MAX})")
    vectors = -(-rows * Cout // 8) + 1
    threads = min(RELAY_MAX_THREADS, 32 * -(-vectors // (32 * RELAY_VECS_PER_THREAD)))
    return RelayPlan(rows, (-(-Bout // rows), A), threads,
                     relayout_stage_bytes(kind, p0, Bin, Cin, Cout, rows), smem)


def smem_relayout(x, layout: Layout):
    """x (A, B, C) -> its copy in ``layout``, staged through shared memory
    (``csrc/probes.cu``: bulk copies in, 16-byte vectors out)."""
    if layout.kind not in _KINDS:
        raise ValueError(f"unknown layout {layout.kind!r}")
    if x.device.type == "cpu":
        return relayout_plain(x, layout).contiguous()
    _require_bf16(x, "x")
    A, B, C = x.shape
    plan = relayout_plan(layout, x.shape, _build.sm_count(x.device.index), x.data_ptr())
    kind, p0, p1, Bout, Cout = relayout_args(layout, x.shape)
    out = torch.empty((A, Bout, Cout), dtype=x.dtype, device=x.device)
    code = _build.load_library().vmg_probe_relayout(
        x.data_ptr(), out.data_ptr(), A, B, C, Bout, Cout, kind, p0, p1, plan.rows,
        plan.threads, plan.stage, plan.smem, _build.stream_of(x))
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


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    """How :func:`tile_gemm`'s kernel cuts a product: column tiles of
    ``nt`` (``splits`` of them); each tap's K padded to ``Kp``, streamed
    in A stages of ``kw`` columns (64 rows each, ``ring`` of them); B by
    TMA boxes of ``kbox`` rows; ``grid`` blocks over ``units`` (output,
    row tile, column tile); ``smem`` bytes of shared memory a block."""
    nt: int
    splits: int
    kw: int
    Kp: int
    kbox: int
    ring: int
    grid: int
    units: int
    smem: int


def gemm_slot_bytes(kw: int, taps: int, conv: bool) -> int:
    """An A stage's ring slot, 1024-byte aligned: 64 rows of kw columns, or
    for a conv form all its tap rows of 72 pixels (the 64 output columns
    and their halo) in one box."""
    rows = -(-taps // 3) * 72 if conv else GEMM_TILE_M
    return -(-rows * kw * 2 // 1024) * 1024


def gemm_smem(taps: int, Kp: int, nt: int, kw: int, ring: int, conv: bool) -> int:
    """A block's shared memory (``gemm_smem`` in csrc/probes.cu): the
    resident B image (nt / 64 column atoms of taps * Kp rows of 128 bytes),
    the A ring, the output tile, the mbarriers, 1024-byte alignment."""
    return ((nt // 64) * taps * Kp * 128 + ring * gemm_slot_bytes(kw, taps, conv)
            + (nt // 64) * GEMM_TILE_M * 128 + (1 + 2 * GEMM_MAX_RING) * 8 + 1024)


def gemm_geometry(form: GemmForm):
    """(taps, K of a tap, image rows R, row width W) as the kernel walks
    the form: the assembled form as nine conv taps of cg columns (its gaps
    never read), a conv form's rows as R image rows of Wo, rows and cols
    as one row of M."""
    if form.kind == "assembled":
        return 9, form.cg, form.M // form.Wo, form.Wo
    if form.kind == "taps":
        return form.taps, form.K, form.M // form.Wo, form.Wo
    return form.taps, form.K, 1, form.M


def gemm_tma(form: GemmForm, ptr: int) -> bool:
    """Whether the kernel can fetch ``form``'s A operand at address ``ptr``
    by TMA: 16-byte aligned rows (M for 'cols', lda for 'rows' with taps
    whole rows apart, the channel count for the conv forms); else its
    producer threads copy A with cp.async."""
    if ptr % 16:
        return False
    if form.kind == "cols":
        return form.M % 8 == 0
    if form.kind == "rows":
        return form.lda % 8 == 0 and (form.taps == 1 or form.tap_stride % form.lda == 0)
    return form.Cx % 8 == 0


def gemm_plan(form: GemmForm, N: int, reps: int = 1, sms: int = 132,
              tma: bool = True) -> GemmPlan:
    """The tile GEMM's cut, from the shapes, the SM count and the A path
    (``tma``, :func:`gemm_tma`) only.  A tap's K goes in 32-column stages
    (the 64-byte swizzle) where it fits 32, else in 64-column stages (the
    128-byte swizzle; always for 'cols').  Each block keeps its column
    tile's B (every tap) resident, so a width fits when that image, the A
    ring and the output tile do: four stages where A comes by TMA (the
    consumer keeps three chains in flight), five where the producer's
    threads copy it (they signal a stage one behind).  Among the widths
    that fit (up to the first that holds all N), take the least waves x
    (64 + nt x taps x Kp / 256): a fixed cost a tile plus its products, so
    a product that would leave SMs idle is cut into more column tiles and
    one that fills the card keeps them wide.  A block owns one column tile
    for its whole walk: the grid is a multiple of ``splits``.  Raises
    where no width fits."""
    taps, Kt, R, W = gemm_geometry(form)
    conv = form.kind in ("taps", "assembled")
    kw = 64 if form.kind == "cols" or Kt > 32 else 32
    Kp = -(-Kt // kw) * kw
    kbox = Kp if Kp <= 256 else max(d for d in range(8, 257, 8) if Kp % d == 0)
    rows = R * -(-W // GEMM_TILE_M) * form.batch * reps
    top = min(w for w in GEMM_WIDTHS if w >= N)
    best, best_cost = None, None
    for nt in (w for w in GEMM_WIDTHS if w <= top):
        splits = -(-N // nt)
        ring = min(GEMM_MAX_RING,
                   (SMEM_MAX - gemm_smem(taps, Kp, nt, kw, 0, conv))
                   // gemm_slot_bytes(kw, taps, conv))
        if ring < (4 if tma else 5):
            continue
        units = rows * splits
        grid = min(units, max(splits, sms // splits * splits))
        cost = -(-units // grid) * (64 + nt * taps * Kp / 256)
        if best_cost is None or cost <= best_cost:
            best_cost = cost
            best = GemmPlan(nt, splits, kw, Kp, kbox, ring, grid, units,
                            gemm_smem(taps, Kp, nt, kw, ring, conv))
    if best is None:
        raise ValueError(f"{form}: its B ({taps} taps x {Kp} rows) does not fit in shared memory "
                         f"at any column tile of {GEMM_WIDTHS}")
    return best


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
    if form.kind == "taps" and form.taps != 9:
        raise ValueError(f"{form}: a 'taps' form is the nine taps of a 3x3 conv")
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
    tma = gemm_tma(form, a.data_ptr())
    plan = gemm_plan(form, N, reps, _build.sm_count(a.device.index), tma)
    out = torch.empty((reps, form.batch, form.M, N), dtype=a.dtype, device=a.device)
    conv = form.kind in ("taps", "assembled")
    # rows of a the kernel's A map spans: the slab's, or a's in rows of lda
    arows = a.shape[0] if conv else -(-a.numel() // form.lda) if form.kind == "rows" else 0
    code = _build.load_library().vmg_probe_tile_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), form.M, N, form.K, form.taps, form.batch,
        reps, _GEMM_KINDS[form.kind], form.lda, form.tap_stride,
        form.K * form.M if form.kind == "cols" else 0, form.Wo, a.shape[1] if conv else 0,
        form.Cx, form.cg, form.stride, arows, plan.nt, plan.kw, plan.kbox, plan.ring, plan.grid,
        int(tma), _build.stream_of(a))
    _build.check(code, "vmg_probe_tile_gemm")
    tile_gemm.launches += 1
    return out[0] if reps == 1 else out


tile_gemm.launches = 0
