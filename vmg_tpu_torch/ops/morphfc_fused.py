"""MorphFC-decay mixer kernels: axis branches, reweight reduction, combine.

Port of ``fused_morphfc_axes``, ``fused_morphfc_reduce`` and
``fused_morphfc_combine`` of ``vmg_tpu/ops/morphfc_fused.py``.  The
wrappers call the operators ``vmg::morphfc_axes``, ``vmg::morphfc_reduce``
and ``vmg::morphfc_combine`` (``ops/library.py``), which launch the CUDA
kernels of ``csrc/morphfc.cu`` on CUDA tensors (design notes there) and
take the plain PyTorch versions beside them on CPU tensors.  Tensors are ``(N, H, W, C)``; ``a`` holds the per-frame
softmax branch weights ``(N, 3, C)``.  Weights come as the kernels take
them, packed once by the module (``MorphFCDecay.operands``): matrices
``(C_in, C_out)`` in the tensors' dtype (the axis weights with the decay
folded in; the combine's projection, on the card, as its kernel's wgmma B
image, :func:`pack_combine_weight`), biases float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vmg_tpu_torch import _build
from vmg_tpu_torch.ops import library
from vmg_tpu_torch.ops.group_conv import _tf32_image, _tf32_unimage


def axis_tokens(x, chunk: int, axis: int):
    """Token matrix of the axis FC along H (axis 1) or W (axis 2) of
    ``(N, H, W, C)``: a token is channel segment q (S = C / chunk channels)
    of a chunk of ``chunk`` positions, its C features (position p, s).
    Positions pad with zeros to a multiple of ``chunk``.  Returns
    ``(tokens, C)``, tokens ordered (n, other axis, chunk, q)."""
    if axis == 1:
        x = x.transpose(1, 2)
    N, A, L, C = x.shape
    Lp = -(-L // chunk) * chunk
    x = F.pad(x, (0, 0, 0, Lp - L))
    tok = x.reshape(N, A, Lp // chunk, chunk, chunk, C // chunk).transpose(3, 4)
    return tok.reshape(-1, C)


def axis_untokens(y, shape, chunk: int, axis: int):
    """Inverse of :func:`axis_tokens`: output feature (P, Z) of token q goes
    to position P of its chunk, channel q * S + Z; pad positions drop."""
    N, H, W, C = shape
    A, L = (W, H) if axis == 1 else (H, W)
    Lp = -(-L // chunk) * chunk
    y = y.reshape(N, A, Lp // chunk, chunk, chunk, C // chunk).transpose(3, 4)
    y = y.reshape(N, A, Lp, C)[:, :, :L]
    return y.transpose(1, 2) if axis == 1 else y


def morphfc_axes_plain(x, c, kh, bh, kw, bw, *, chunk_h: int, chunk_w: int,
                       non_linear: bool = True):
    """Both decayed axis branches, relu(tokens @ k + b) / C in f32 rounded
    once to x's dtype, and the f32 per-frame sums of h + w + c taken from
    the unrounded branches.  ``bh`` and ``bw`` None: no bias;
    ``non_linear`` False: no relu.  Returns (h, w, psum (N, C) f32)."""
    C = x.shape[-1]

    def branch(k, b, chunk, axis):
        y = axis_tokens(x, chunk, axis).float() @ k.float()
        if b is not None:
            y = y + b
        if non_linear:
            y = torch.relu(y)
        return axis_untokens(y * (1.0 / C), x.shape, chunk, axis)

    h = branch(kh, bh, chunk_h, 1)
    w = branch(kw, bw, chunk_w, 2)
    psum = h.sum(dim=(1, 2)) + w.sum(dim=(1, 2)) + c.float().sum(dim=(1, 2))
    return h.to(x.dtype), w.to(x.dtype), psum


FORMS = ("big", "token")
# Shared memory one block may use on Hopper (227 KB).
MAX_SMEM = 232_448


def axes_form(C: int, chunk_h: int, chunk_w: int) -> str:
    """The form ``form=None`` resolves to, as the JAX op selects it: the
    big-matrix form while chunk * C fits its 1024-lane budget, else the
    token form."""
    return "token" if chunk_h * C > 1024 or chunk_w * C > 1024 else "big"


def big_form_smem(M: int, C: int, dtype) -> int:
    """Bytes of shared memory the big-form kernel needs at least for slabs
    of M positions: one warpgroup with one slot (the x and c slabs) and one
    resident weight (:func:`axes_smem`), in f32 as its TF32 hi and lo
    images."""
    return axes_smem(C, _slab_bytes(M, C, dtype), 1, 1, 2, dtype)


# The big-form kernel (csrc/morphfc.cu ``morphfc_axes_wgmma_kernel``, bf16
# and f32): persistent blocks of 1-2 consumer warpgroups, each with a ring
# of up to AXES_RING_MAX slots holding a tile's x and c slabs.
AXES_RING_MAX = 4


def _pow2(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def _slab_bytes(positions: int, C: int, dtype=torch.bfloat16) -> int:
    return -(-positions * C * (2 if dtype == torch.bfloat16 else 4) // 128) * 128


def axes_slab_width(C: int, chunk_h: int, chunk_w: int) -> int:
    """WT of the big-form kernel's ch x WT slabs: the least multiple of chunk_w
    that gives a slab at least 64 positions (one m64 sub-tile of tokens a
    branch at the stage-0/6 chunks, 8 x 8)."""
    return chunk_w * -(-64 // (chunk_h * chunk_w))


def axes_smem(C: int, slab: int, nwg: int, ring: int, npass: int,
               dtype=torch.bfloat16) -> int:
    """Shared memory of the big-form kernel (``axes_smem`` in the source):
    nwg rings of ``ring`` slots of two slabs, the resident weights (both
    where one pass runs both branches; bf16, or f32 as their TF32 hi and
    lo images), the biases and the barriers."""
    wbytes = 2 if dtype == torch.bfloat16 else 8
    return (nwg * ring * 2 * slab + (2 if npass == 1 else 1) * C * C * wbytes + 2 * C * 4
            + nwg * AXES_RING_MAX * 8)


def axes_plan(C: int, chunk_h: int, chunk_w: int, dtype=torch.bfloat16):
    """(WT, npass, nwg, ring) of the big-form kernel in ``dtype``, or None
    where no plan fits a block: one pass over the tiles with both weights
    resident where the chunks are equal and they fit (else two, H then W,
    x read twice; in f32 at C = 112: 2 x 100 KB of images do not fit), two
    warpgroups with at least two slots each, else one with at least one,
    the most slots up to AXES_RING_MAX."""
    WT = axes_slab_width(C, chunk_h, chunk_w)
    if C > 240 or WT > 256 or chunk_h > 64 or chunk_w > 64:
        return None
    slab = _slab_bytes(chunk_h * WT, C, dtype)
    for npass in ((1, 2) if chunk_h == chunk_w else (2,)):
        for nwg, least in ((2, 2), (1, 1)):
            ring = min(AXES_RING_MAX, (MAX_SMEM - axes_smem(C, slab, nwg, 0, npass, dtype))
                       // (nwg * 2 * slab))
            if ring >= least:
                return WT, npass, nwg, ring
    return None


# The bf16 token form (csrc/morphfc.cu ``morphfc_axes_token_wgmma_kernel``):
# blocks of TOKEN_WG consumer warpgroups, each walking units of 64 tokens
# through a ring of up to TOKEN_RING_MAX x slots; weights as B images in
# column tiles, up to TOKEN_WMAX resident (or ring slots when streamed).
TOKEN_WG = 2
TOKEN_RING_MAX = 2
TOKEN_WMAX = 8
# The plan's fields as the C entry point reads them (``TokPlan`` in the
# source, in this order): the kernel's, then each branch's (H, then W).
TOKEN_PLAN_FIELDS = ("nt", "exact", "resident", "ring", "wring", "nws", "sc", "per_c", "stot")
TOKEN_BRANCH_FIELDS = ("L", "S", "lgu", "tpz", "ucols", "upf", "ntiles", "blocks", "wpf",
                       "fpw")


def token_nt(C: int, chunk_h: int, chunk_w: int) -> int:
    """Columns a weight tile of the bf16 token kernel: G chunk positions of
    8 channels, G = the chunks rounded up to powers of two (>= 2), at most
    the chunk at the compile-time path shapes (a tile a block of 8
    channels: 16 at stages 1/5, 8 at stage 3), else 4 above C = 224 (28 KB
    tiles stream beside the channel arrays) and 8 below."""
    g = min(max(2, _pow2(chunk_h)), max(2, _pow2(chunk_w)),
            (16 if C == 224 else 8) if token_exact(C, chunk_h, chunk_w) else
            4 if C > 224 else 8)
    return 8 * g


def token_exact(C: int, chunk_h: int, chunk_w: int) -> bool:
    """The path shapes the bf16 token kernel compiles for (stages 1/5: C =
    224, chunk 16; stage 3: C = 448, chunk 8): tiles of whole 8-channel
    blocks, the sums in registers (no channel arrays)."""
    return (C, chunk_h, chunk_w) in ((224, 16, 16), (448, 8, 8))


def token_branch(H: int, W: int, C: int, L: int, axis: int, nt: int) -> dict:
    """One branch's geometry in the bf16 token kernel: chunk L, S = C / L
    channels a segment, cp = L rounded up to a power of two (token rows a
    group), gu = 64 / cp = 2**lgu groups a unit; the unit grid of a frame (H: gu
    columns x one L-row chunk; W: gu rows x one L-column chunk); the
    image's column tiles: blocks of 8 channels (S padded to 8), each in
    ``tpz`` tiles of nt / 8 chunk positions."""
    cp = _pow2(L)
    gu = 64 // cp
    ucols = -(-W // gu) if axis == 1 else W // L
    urows = -(-H // L) if axis == 1 else -(-H // gu)
    tpz = -(-L // (nt // 8))
    return dict(L=L, S=C // L, cp=cp, gu=gu, lgu=gu.bit_length() - 1, ucols=ucols, urows=urows,
                upf=ucols * urows, tpz=tpz, ntiles=-(-(C // L) // 8) * tpz)


def token_smem(C: int, nt: int, ring: int, wtiles: int, nws: int) -> int:
    """Shared memory of the bf16 token kernel (``TokLayout`` in the
    source): TOKEN_WG rings of ``ring`` 64-token slots, ``wtiles`` weight
    tiles (C x nt), ``nws`` channel arrays a warpgroup, the barriers."""
    slot = -(-64 * C * 2 // 128) * 128
    return (TOKEN_WG * ring * slot + wtiles * C * nt * 2 + TOKEN_WG * nws * C * 4
            + (TOKEN_WG * TOKEN_RING_MAX + 2 * TOKEN_WMAX) * 8)


def _split_walkers(brs, N: int, sms: int, wpb: int) -> None:
    """Each branch's ``blocks`` (the grid, at most ``sms`` blocks, split by
    the branches' units) and walkers (``wpb`` a block): ``wpf`` walkers
    share each frame's units, or one walker takes ``fpw`` whole frames."""
    units = [N * b["upf"] for b in brs]
    caps = [-(-u // wpb) for u in units]
    grid = max(2, min(sms, sum(caps)))
    bh = min(caps[0], grid - 1, max(1, round(grid * units[0] / sum(units))))
    for b, blocks in zip(brs, (bh, min(caps[1], grid - bh))):
        G = wpb * blocks
        b.update(blocks=blocks, wpf=min(G // N, b["upf"]), fpw=0) if N <= G else \
            b.update(blocks=blocks, wpf=1, fpw=-(-N // G))


def token_plan(N: int, H: int, W: int, C: int, chunk_h: int, chunk_w: int, sms: int):
    """The bf16 token kernel's plan, or None where it has none: a dict
    with ``branches`` (:func:`token_branch` of H then W, each with its
    ``blocks`` and walkers: ``wpf`` walkers share each frame's units, or
    one walker takes ``fpw`` whole frames), ``nt``, ``exact`` (a
    compile-time path shape, :func:`token_exact`), ``resident`` (the
    image whole in shared memory beside two slots a warpgroup, which it
    is up to C = 224; else its tiles stream through ``wring`` slots),
    ``ring``, ``nws``, c's reduce plan (``sc`` slices of ``per_c``
    pixels) and ``stot`` partial rows a frame.  The grid (at most ``sms``
    blocks) is split between the branches by their units.  The C entry
    point takes the plan as it is (:func:`token_plan_ints`) and only
    checks it."""
    if C % 16 or C > 512 or chunk_h > 64 or chunk_w > 64:
        return None
    nt = token_nt(C, chunk_h, chunk_w)
    brs = [token_branch(H, W, C, chunk_h, 1, nt), token_branch(H, W, C, chunk_w, 2, nt)]
    ntmax = max(b["ntiles"] for b in brs)
    # channel arrays a warpgroup: none at the compile-time shapes (sums in
    # registers), one a warp where a unit has 32 or 64 groups
    nws = 0 if token_exact(C, chunk_h, chunk_w) else 4 if min(chunk_h, chunk_w) <= 2 else 1
    resident = ntmax <= TOKEN_WMAX and token_smem(C, nt, 2, ntmax, nws) <= MAX_SMEM
    ring = wring = None
    for r in (2, 1):
        fits = [w for w in range(TOKEN_WMAX, 1, -1)
                if token_smem(C, nt, r, ntmax if resident else w, nws) <= MAX_SMEM]
        if fits:
            ring, wring = r, fits[0]
            break
    if ring is None:
        return None
    _split_walkers(brs, N, sms, TOKEN_WG)
    sc, per_c = reduce_plan(N, H * W, C, 8, sms)
    slots = sum(b["wpf"] if b["fpw"] == 0 else 1 for b in brs)
    return dict(branches=brs, nt=nt, exact=token_exact(C, chunk_h, chunk_w),
                resident=resident, ring=ring, wring=wring, nws=nws, sc=sc, per_c=per_c,
                stot=slots + sc)


def token_plan_ints(plan, fields=TOKEN_PLAN_FIELDS) -> list:
    """A :func:`token_plan` (or, with TOKEN_F32_PLAN_FIELDS, a
    :func:`token_f32_plan`) as the C entry point reads it: the plan's
    fields, then each branch's TOKEN_BRANCH_FIELDS."""
    return ([int(plan[k]) for k in fields]
            + [int(b[k]) for b in plan["branches"] for k in TOKEN_BRANCH_FIELDS])


# The f32 token form (csrc/morphfc.cu ``morphfc_axes_token_tf32_kernel``):
# the bf16 kernel's units and branches on 3xTF32 wgmma, each weight's hi and
# lo images streamed in stages of ``kcs`` k8 steps (twice
# TOKEN_F32_STAGE_BYTES where three such stages fit, else once) of a column
# tile through rings of up to TOKEN_F32_STAGES slots.
TOKEN_F32_STAGES = 8
TOKEN_F32_STAGE_BYTES = 16384
TOKEN_F32_PLAN_FIELDS = ("nt", "exact", "shared", "ring", "kcs", "nst", "nws", "sc", "per_c",
                         "stot")


def token_f32_nt(C: int, chunk_h: int, chunk_w: int) -> int:
    """Columns a weight tile of the f32 token kernel: at the compile-time
    path shapes (:func:`token_exact`) an 8-channel block at every chunk
    position (128 at stages 1/5, 64 at stage 3); else 8 G, G = the chunks
    rounded up to powers of two (>= 2), at most 8."""
    if token_exact(C, chunk_h, chunk_w):
        return 8 * chunk_h
    return 8 * min(max(2, _pow2(chunk_h)), max(2, _pow2(chunk_w)), 8)


def token_f32_smem(C: int, nt: int, shared: bool, ring: int, kcs: int, nst: int,
                   nws: int) -> int:
    """Shared memory of the f32 token kernel (``TokF32Layout`` in the
    source): the x slots of 64 f32 tokens (``ring`` a warpgroup, or a block
    where ``shared``), the weight rings of ``nst`` stages of ``kcs`` k8
    steps' hi and lo images (one, or one a warpgroup where ``shared``),
    ``nws`` channel arrays a warpgroup, the barriers."""
    slot = -(-64 * C * 4 // 128) * 128
    return ((1 if shared else TOKEN_WG) * ring * slot
            + (TOKEN_WG if shared else 1) * nst * kcs * 64 * nt + TOKEN_WG * nws * C * 4
            + (TOKEN_WG * TOKEN_RING_MAX + TOKEN_RING_MAX + 4 * TOKEN_F32_STAGES) * 8)


def token_f32_plan(N: int, H: int, W: int, C: int, chunk_h: int, chunk_w: int, sms: int):
    """The f32 token kernel's plan, or None where it has none: the bf16
    plan's fields (:func:`token_plan`: ``branches`` with their ``blocks``
    and walkers, ``nt``, ``exact``, ``nws``, c's reduce plan, ``stot``)
    and the stream's: ``kcs`` k8 steps a stage (32 KB where three such
    stages fit, else 16 KB) and ``nst`` ring stages.  "Solo" where two x
    slots fit beside a ring of three stages (up to C = 336): each
    warpgroup walks its own units (a walker; ``ring`` slots each, two
    where they fit) and both read every stage.  Else ``shared``: a block
    is one walker whose warpgroups work on each unit together, warpgroup g
    on column tiles g, g + 2, ..., each with its own ring and its own
    partial row.  The grid (at most ``sms`` blocks) is split between the
    branches by their units.  The C entry point only checks the plan
    (:func:`token_plan_ints` with TOKEN_F32_PLAN_FIELDS)."""
    if C % 16 or C > 512 or chunk_h > 64 or chunk_w > 64:
        return None
    nt = token_f32_nt(C, chunk_h, chunk_w)
    brs = [token_branch(H, W, C, chunk_h, 1, nt), token_branch(H, W, C, chunk_w, 2, nt)]
    exact = token_exact(C, chunk_h, chunk_w)
    nws = 0 if exact else 4 if min(chunk_h, chunk_w) <= 2 else 1
    choice = None
    for least, target in ((3, 2 * TOKEN_F32_STAGE_BYTES), (3, TOKEN_F32_STAGE_BYTES),
                          (2, TOKEN_F32_STAGE_BYTES)):
        kcs = min(C // 8, max(2, target // (64 * nt)))
        for shared in (False, True):
            if shared and min(b["ntiles"] for b in brs) < 2:
                continue
            for ring in (2, 1):
                rest = MAX_SMEM - token_f32_smem(C, nt, shared, ring, kcs, 0, nws)
                nst = min(TOKEN_F32_STAGES,
                          rest // ((TOKEN_WG if shared else 1) * kcs * 64 * nt))
                if nst >= least:
                    choice = (shared, ring, kcs, nst)
                    break
            if choice:
                break
        if choice:
            break
    if choice is None:
        return None
    shared, ring, kcs, nst = choice
    _split_walkers(brs, N, sms, 1 if shared else TOKEN_WG)
    sc, per_c = reduce_plan(N, H * W, C, 4, sms)
    rows = sum(b["wpf"] if b["fpw"] == 0 else 1 for b in brs) * (2 if shared else 1)
    return dict(branches=brs, nt=nt, exact=exact, shared=shared, ring=ring, kcs=kcs, nst=nst,
                nws=nws, sc=sc, per_c=per_c, stot=rows + sc)


def fused_morphfc_axes(x, c, kh, bh, kw, bw, *, chunk_h: int, chunk_w: int,
                       form: str | None = None, non_linear: bool = True):
    """x, c (N, H, W, C) -> (h, w, psum); needs C % chunk_h == C % chunk_w
    == W % chunk_w == 0.  kh, kw are the axis weights with the decay
    already folded in, as ``MorphFCDecay`` packs them once per parameter
    state (the JAX op folds it per call).  ``bh`` and ``bw``: the (C,) f32
    biases, or both None (``qkv_bias`` off: the kernels then load no
    bias); ``non_linear`` False drops the relu, as the JAX op's
    ``non_linear`` does.  ``form``: "big" (the kernel
    that holds the whole C x C weight; it raises where that does not fit
    in shared memory), "token" (weight column tiles: any chunk * C) or
    None for :func:`axes_form`, or the token form where the big form's
    plan does not fit (f32 above C = 128: the weight's TF32 hi and lo
    images).  Both forms compute one function, so CPU tensors take the
    same plain version.  ``vmg::morphfc_axes``, with the form resolved
    here."""
    if form is None:
        form = axes_form(x.shape[-1], chunk_h, chunk_w)
        if form == "big" and axes_plan(x.shape[-1], chunk_h, chunk_w, x.dtype) is None:
            form = "token"  # f32 above C = 128: the hi and lo images do not fit
    elif form not in FORMS:
        raise ValueError(f"form must be one of {FORMS} or None, got {form!r}")
    if (bh is None) != (bw is None):
        raise ValueError("bh and bw: both biases or neither")
    return _morphfc_axes(x, c, kh, bh, kw, bw, chunk_h, chunk_w, form, bool(non_linear))


def _axes_cuda(x, c, kh, bh, kw, bw, chunk_h: int, chunk_w: int, form: str,
               non_linear: bool):
    N, H, W, C = x.shape
    dt, dev = x.dtype, x.device
    if C % chunk_h or C % chunk_w or W % chunk_w:
        raise ValueError(f"chunks ({chunk_h}, {chunk_w}) do not divide C={C}, W={W}")
    _build.require(x, "x")
    checks = [("c", c, x.shape, dt), ("kh", kh, (C, C), dt), ("kw", kw, (C, C), dt)]
    if bh is not None:
        checks += [("bh", bh, (C,), torch.float32), ("bw", bw, (C,), torch.float32)]
    for name, t, shape, dtype in checks:
        _build.require(t, name, shape=shape, dtype=dtype, device=dev)
    h, w = torch.empty_like(x), torch.empty_like(x)
    psum = torch.empty((N, C), dtype=torch.float32, device=dev)
    sms = _build.sm_count(dev.index or 0)
    if form == "big":
        plan = axes_plan(C, chunk_h, chunk_w, dt)
        if plan is None:
            need = big_form_smem(chunk_h * axes_slab_width(C, chunk_h, chunk_w), C, dt)
            raise ValueError(
                f"the big form needs {need} bytes of shared memory at C={C}, chunks "
                f"({chunk_h}, {chunk_w}); a block has {MAX_SMEM}: use form='token'")
        # persistent: walkers (warpgroups) on every SM, each a contiguous run
        # of slabs, one f32 partial per walker, pass and frame
        WT, npass, nwg, ring = plan
        tiles = N * -(-H // chunk_h) * -(-W // WT)
        grid = min(sms, -(-tiles // nwg))
        S = npass * grid * nwg
        scratch = torch.empty((grid * nwg, (C // 2 + 8) * 128), dtype=torch.float32,
                              device=dev)
        img = bimg = plan_ints = None
    else:
        # the token form: the pack, c's partials, the kernel, the sums pass;
        # bf16 images (C x NT a tile), f32 hi and lo images (2 C x NT)
        f32 = dt == torch.float32
        tp = (token_f32_plan if f32 else token_plan)(N, H, W, C, chunk_h, chunk_w, sms)
        if tp is None:
            raise ValueError(f"the token form takes C % 16 == 0, C <= 512 and chunks <= 64; "
                             f"got C={C}, chunks ({chunk_h}, {chunk_w})")
        tiles = sum(b["ntiles"] for b in tp["branches"])  # both images, back to back
        img = torch.empty(tiles * C * tp["nt"] * (2 if f32 else 1), dtype=dt, device=dev)
        bimg = None
        if bh is not None:  # no bias: no bias image
            bimg = torch.empty(tiles * tp["nt"], dtype=torch.float32, device=dev)
        S = tp["stot"]
        ints = token_plan_ints(tp, TOKEN_F32_PLAN_FIELDS if f32 else TOKEN_PLAN_FIELDS)
        plan_ints = (ctypes.c_int * len(ints))(*ints)
        WT, nwg, ring, npass, grid, scratch = 0, 0, 0, 0, 0, None
    partial = torch.empty((N, S, C), dtype=torch.float32, device=dev)
    pointers = (x.data_ptr(), c.data_ptr(), kh.data_ptr(), _build.ptr(bh), kw.data_ptr(),
                _build.ptr(bw), h.data_ptr(), w.data_ptr())
    relu = int(non_linear)
    if form == "big":
        code = _build.load_library().vmg_morphfc_axes(
            *pointers, partial.data_ptr(), psum.data_ptr(), _build.ptr(scratch), N, H, W, C,
            chunk_h, chunk_w, WT, nwg, ring, npass, grid, relu, _build.DTYPE_CODES[dt],
            _build.stream_of(x))
        _build.check(code, "vmg_morphfc_axes")
        fused_morphfc_axes.launches += 1
    else:
        code = _build.load_library().vmg_morphfc_axes_token(
            *pointers, _build.ptr(img), _build.ptr(bimg), partial.data_ptr(),
            psum.data_ptr(), plan_ints, N, H, W, C, chunk_h, chunk_w, WT, relu,
            _build.DTYPE_CODES[dt], _build.stream_of(x))
        _build.check(code, "vmg_morphfc_axes_token")
        fused_morphfc_axes.token_launches += 1
    return h, w, psum


def _axes_cpu(x, c, kh, bh, kw, bw, chunk_h: int, chunk_w: int, form: str,
              non_linear: bool):
    return morphfc_axes_plain(x, c, kh, bh, kw, bw, chunk_h=chunk_h, chunk_w=chunk_w,
                              non_linear=non_linear)


def _axes_fake(x, c, kh, bh, kw, bw, chunk_h: int, chunk_w: int, form: str,
               non_linear: bool):
    return (library.empty(x), library.empty(x),
            library.empty(x, (x.shape[0], x.shape[-1]), torch.float32))


_morphfc_axes = library.define(
    "morphfc_axes", "(Tensor x, Tensor c, Tensor kh, Tensor? bh, Tensor kw, Tensor? bw, "
    "int chunk_h, int chunk_w, str form, bool non_linear) -> (Tensor, Tensor, Tensor)",
    cpu=_axes_cpu, cuda=_axes_cuda, fake=_axes_fake)
fused_morphfc_axes.launches = 0  # the big form's kernel
fused_morphfc_axes.token_launches = 0  # the token form's kernel


def morphfc_reduce_plain(h, w, c):
    """f32 per-frame sums of h + w + c: (N, H, W, C) x3 -> (N, C)."""
    return (h.float() + w.float() + c.float()).sum(dim=(1, 2))


# The reduce's first pass (csrc/morphfc.cu ``morphfc_partial_kernel``):
# blocks of RED_THREADS threads, each lane walking RED_UNROLL pixels at a time.
RED_THREADS = 256
RED_UNROLL = 4


def reduce_vec(C: int, itemsize: int, ptrs=()) -> int:
    """Channels per load of the reduce: the widest of 16, 8, 4 or 2 bytes
    (1 element) that divides C and aligns every pointer in ``ptrs``."""
    nbytes = 16
    while nbytes > itemsize and (C * itemsize % nbytes
                                 or any(p % nbytes for p in ptrs)):
        nbytes //= 2
    return max(1, nbytes // itemsize)


def reduce_lanes(C: int, vec: int) -> int:
    """Pixel lanes a block of the reduce's first pass: RED_THREADS threads
    of C / vec vectors a pixel; one lane, whose threads walk more than one
    vector each, where a pixel has more vectors than a block has threads."""
    return max(1, RED_THREADS // (C // vec))


def reduce_plan(N: int, P: int, C: int, vec: int, sms: int):
    """(S, per) of the reduce's first pass: S slices of ``per`` pixels per
    frame, each a block, none empty.  At least two blocks per SM (N S >= 2
    sms) while a frame has a pixel for each of a block's lanes; fewer
    otherwise.  A function of the shape, the load width ``vec`` and the
    card's SM count only; ``vec`` (:func:`reduce_vec`) depends on the
    pointers' alignment too, so a view that starts off a 16-byte boundary
    sums in another order than a fresh tensor of its shape.  Fresh tensors
    of one shape repeat the partial sums, and the result, bit for bit."""
    lanes = reduce_lanes(C, vec)
    S = max(1, min(-(-2 * sms // N), P // lanes))
    per = -(-P // S)
    return -(-P // per), per


def _reduce_cuda(h, w, c):
    N, H, W, C = h.shape
    _build.require(h, "h")
    for name, t in (("w", w), ("c", c)):
        _build.require(t, name, shape=h.shape, dtype=h.dtype, device=h.device)
    P = H * W
    vec = reduce_vec(C, h.element_size(), [t.data_ptr() for t in (h, w, c)])
    S, per = reduce_plan(N, P, C, vec, _build.sm_count(h.device.index or 0))
    partial = torch.empty((N, S, C), dtype=torch.float32, device=h.device)
    out = torch.empty((N, C), dtype=torch.float32, device=h.device)
    code = _build.load_library().vmg_morphfc_reduce(
        h.data_ptr(), w.data_ptr(), c.data_ptr(), partial.data_ptr(),
        out.data_ptr(), N, P, C, S, per, vec, _build.DTYPE_CODES[h.dtype],
        _build.stream_of(h))
    _build.check(code, "vmg_morphfc_reduce")
    fused_morphfc_reduce.launches += 1
    return out


_morphfc_reduce = library.define(
    "morphfc_reduce", "(Tensor h, Tensor w, Tensor c) -> Tensor",
    cpu=morphfc_reduce_plain, cuda=_reduce_cuda,
    fake=lambda h, w, c: library.empty(h, (h.shape[0], h.shape[-1]), torch.float32))


def fused_morphfc_reduce(h, w, c):
    """f32 per-frame sums of h + w + c, (N, H, W, C) x3 -> (N, C):
    ``vmg::morphfc_reduce``, the kernel on CUDA tensors (its load width
    from the pointers' alignment, :func:`reduce_vec`), the plain version on
    CPU tensors."""
    return _morphfc_reduce(h, w, c)


fused_morphfc_reduce.launches = 0


# the combine kernel's gate codes
_GATES = {"tanh": 0, "sigmoid": 1, "relu": 2}


def symm_gate(p, act):
    """The mixer's symmetric gate activation."""
    if act == "tanh":
        return torch.tanh(p)
    if act == "sigmoid":
        return torch.sigmoid(p) - 0.5
    if act == "relu":
        return torch.relu(p)
    raise ValueError(f"unsupported gate act {act!r}")


def morphfc_combine_plain(x, h, w, c, a, pk, pb, *, act="tanh",
                          residual=None, res_scale=1.0):
    """(x + p) * act(p), p = round(y @ pk + pb), y = a0 h + a1 w + a2 c in
    the input dtype; optionally residual + res_scale * out."""
    a = a.to(x.dtype)[:, :, None, None, :]
    y = h * a[:, 0] + w * a[:, 1] + c * a[:, 2]
    p = (y.float() @ pk.float() + pb.float()).to(x.dtype)
    out = (x + p) * symm_gate(p, act)
    if residual is not None:
        out = residual + res_scale * out
    return out


# The combine kernels (csrc/morphfc.cu): 64-pixel tiles; each tensor's tile
# lands in a ring slot as TMA boxes of 128-byte rows x 64 pixels (8 KB: 64
# bf16 channels, ``morphfc_combine_wgmma_kernel``; 32 f32 channels,
# ``morphfc_combine_tf32_kernel``); a ring of such slots per consumer
# warpgroup.
COMBINE_BOX = 64
COMBINE_BOX_BYTES = 64 * 64 * 2
COMBINE_RING_MAX = 8
COMBINE_F32_RING_MAX = 24
COMBINE_F32_BAR_BYTES = 8 * (1 + 2 * COMBINE_F32_RING_MAX)
COMBINE_F32_RESIDENT = 128  # the f32 Pk image stays in shared memory up to this C


def combine_tile_n(C: int, dtype=torch.bfloat16) -> int:
    """Output channels per N-tile: all C up to 224; above, bf16 64 (Pk
    streams in column tiles of that width), f32 half of C rounded up to 32
    (the f32 kernel's work item is (pixel tile, N-tile): C = 448 is two
    N-tiles of 224)."""
    if C <= 224:
        return C
    return COMBINE_BOX if dtype == torch.bfloat16 else -(-C // 64) * 32


def combine_k_width(C: int) -> int:
    """Channels per h / w / c unit of the bf16 kernel: all C up to 160, else
    128 (two boxes)."""
    return C if C <= 160 else 2 * COMBINE_BOX


def combine_x_width(C: int) -> int:
    """Channels per x / res unit: as :func:`combine_k_width`, of an
    N-tile's."""
    nt = combine_tile_n(C)
    return nt if nt <= 160 else 2 * COMBINE_BOX


def combine_image_shape(C: int, dtype=torch.bfloat16):
    """Shape of the kernel's Pk operand: bf16 ``(ceil(C / NT), C / 8, NT,
    8)``, f32 ``(ceil(C / NT), C / 8, 2, 2, NT, 4)`` (columns past C, in the
    last N-tile, are zeros)."""
    nt = combine_tile_n(C, dtype)
    if dtype == torch.bfloat16:
        return (-(-C // nt), C // 8, nt, 8)
    return (-(-C // nt), C // 8, 2, 2, nt, 4)


def pack_combine_weight(pk):
    """(C_in, C_out) projection -> the kernel's wgmma B image in pk's dtype,
    each N-tile t of NT output channels contiguous (zero past C).  bf16:
    ``img[t, kg, n, ki] = pk[8 kg + ki, t NT + n]``, K-major 8 x 16-byte core
    matrices.  float32: per k8 step s its TF32 hi then its lo image,
    ``img[t, s, hilo, kb, n, e]`` holding row 8 s + 2 e + kb of column t NT +
    n (``group_conv._tf32_image``; hi + lo is the entry exactly).
    ``MorphFCDecay`` packs it once per parameter state, on the card."""
    C = pk.shape[0]
    if tuple(pk.shape) != (C, C) or C % 16:
        raise ValueError(f"pk must be (C, C) with C % 16 == 0, got {tuple(pk.shape)}")
    shape = combine_image_shape(C, pk.dtype)
    t, nt = shape[0], shape[-2]
    pk = F.pad(pk, (0, t * nt - C))
    if pk.dtype != torch.bfloat16:
        return torch.stack([_tf32_image(pk[:, i * nt:(i + 1) * nt])
                            for i in range(t)]).reshape(shape)
    return pk.reshape(C // 8, 8, t, nt).permute(2, 0, 3, 1).contiguous()


def unpack_combine_weight(img):
    """The (C_in, C_out) projection of a :func:`pack_combine_weight` image."""
    t, kg = img.shape[:2]
    C = kg * 8
    if img.dim() == 6:  # f32: hi + lo
        nt = img.shape[4]
        return torch.cat([_tf32_unimage(m.reshape(-1), kg, nt) for m in img], 1)[:, :C]
    nt = img.shape[2]
    return img.permute(1, 3, 0, 2).reshape(C, t * nt)[:, :C]


def _combine_slot_bytes(C: int, dtype=torch.bfloat16) -> int:
    if dtype != torch.bfloat16:  # a box of 32 f32 channels, or a streamed Pk step's hi and lo
        streamed = C > COMBINE_F32_RESIDENT
        return max(64 * 32 * 4, 64 * combine_tile_n(C, dtype) if streamed else 0)
    act = -(-combine_k_width(C) // COMBINE_BOX) * COMBINE_BOX_BYTES
    return max(act, C * COMBINE_BOX * 2 if C > 224 else 0)


def combine_smem(C: int, nwg: int, ring: int, dtype=torch.bfloat16) -> int:
    """Shared memory of the kernel (``combine_smem`` / ``combine_f32_smem``
    in the source): nwg rings of ``ring`` slots, the resident Pk image (bf16
    C <= 224: 2 C^2 bytes; f32 C <= 128: 8 C^2) and the barriers; f32
    also pb and each warpgroup's branch weights of its item's frame."""
    if dtype != torch.bfloat16:
        resident = 8 * C * C if C <= COMBINE_F32_RESIDENT else 0
        return (nwg * ring * _combine_slot_bytes(C, dtype) + resident + COMBINE_F32_BAR_BYTES
                + 4 * C * (1 + 3 * nwg))
    resident = C * C * 2 if C <= 224 else 0
    return nwg * ring * _combine_slot_bytes(C, dtype) + resident + 256


def combine_items(N: int, P: int, C: int) -> int:
    """Work items of the f32 kernel: (64-pixel tile, N-tile) pairs."""
    return N * -(-P // 64) * -(-C // combine_tile_n(C, torch.float32))


def combine_plan(C: int, dtype=torch.bfloat16, items=None, sms: int = 132):
    """(consumer warpgroups, ring slots) of the kernel at C.  bf16: the most
    warpgroups (3 where their registers allow, C <= 128; else 2) whose rings
    hold 3 slots each in shared memory, else the most with 2; at most
    ``COMBINE_RING_MAX`` slots.  float32: two warpgroups, or one where the
    call has no more work ``items`` than the card has SMs (each block then
    walks one item, and the second warpgroup would have none), as many
    slots as fit (at least 4; each refilled one unit behind), at most
    ``COMBINE_F32_RING_MAX``."""
    slot = _combine_slot_bytes(C, dtype)
    if dtype != torch.bfloat16:
        nwg = 1 if items is not None and items <= sms else 2
        ring = min(COMBINE_F32_RING_MAX,
                   (MAX_SMEM - combine_smem(C, nwg, 0, dtype)) // (nwg * slot))
        if ring >= 4:
            return nwg, ring
        raise ValueError(f"the f32 combine kernel has no plan at C={C}")
    fixed = combine_smem(C, 0, 0)
    options = (3, 2, 1) if C <= 128 else (2, 1)
    for least in (3, 2):
        for nwg in options:
            ring = min(COMBINE_RING_MAX, (MAX_SMEM - fixed) // (nwg * slot))
            if ring >= least:
                return nwg, ring
    raise ValueError(f"the combine kernel has no plan at C={C}")


def _combine_cuda(x, h, w, c, a, pk, pb, act: str, residual, res_scale: float):
    if act not in _GATES:
        raise ValueError(f"unsupported gate act {act!r}")
    N, H, W, C = x.shape
    dt, dev = x.dtype, x.device
    _build.require(x, "x")
    if C % 16 or C > 448:
        raise ValueError(f"the combine kernel takes C % 16 == 0, C <= 448; got C={C}")
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the combine kernel takes bf16 or float32, got {dt}")
    pk_shape = combine_image_shape(C, dt)
    checks = [("h", h, x.shape, dt), ("w", w, x.shape, dt),
              ("c", c, x.shape, dt), ("a", a, (N, 3, C), dt),
              ("pk", pk, pk_shape, dt), ("pb", pb, (C,), torch.float32)]
    if residual is not None:
        checks.append(("residual", residual, x.shape, dt))
    for name, t, shape, dtype in checks:
        _build.require(t, name, shape=shape, dtype=dtype, device=dev)
    nwg, ring = (combine_plan(C) if dt == torch.bfloat16 else
                 combine_plan(C, dt, combine_items(N, H * W, C),
                              _build.sm_count(dev.index or 0)))
    out = torch.empty_like(x)
    code = _build.load_library().vmg_morphfc_combine(
        x.data_ptr(), h.data_ptr(), w.data_ptr(), c.data_ptr(), a.data_ptr(),
        pk.data_ptr(), pb.data_ptr(), _build.ptr(residual), out.data_ptr(),
        N, H * W, C, float(res_scale), _GATES[act], nwg, ring,
        _build.DTYPE_CODES[dt], _build.stream_of(x))
    _build.check(code, "vmg_morphfc_combine")
    fused_morphfc_combine.launches += 1
    return out


def _combine_cpu(x, h, w, c, a, pk, pb, act: str, residual, res_scale: float):
    return morphfc_combine_plain(x, h, w, c, a, pk, pb, act=act, residual=residual,
                                 res_scale=res_scale)


_morphfc_combine = library.define(
    "morphfc_combine", "(Tensor x, Tensor h, Tensor w, Tensor c, Tensor a, Tensor pk, "
    "Tensor pb, str act, Tensor? residual, float res_scale) -> Tensor",
    cpu=_combine_cpu, cuda=_combine_cuda,
    fake=lambda x, h, w, c, a, pk, pb, act, residual, res_scale: library.empty(x))


def fused_morphfc_combine(x, h, w, c, a, pk, pb, *, act="tanh",
                          residual=None, res_scale=1.0):
    """pb (C,) f32; pk in x's dtype: (C_in, C_out) on CPU, the image
    :func:`pack_combine_weight` makes of it on CUDA; ``act``: the gate,
    ``"tanh"``, ``"sigmoid"`` (sigmoid(p) - 0.5) or ``"relu"``:
    ``vmg::morphfc_combine``."""
    return _morphfc_combine(x, h, w, c, a, pk, pb, act, residual, float(res_scale))


fused_morphfc_combine.launches = 0
