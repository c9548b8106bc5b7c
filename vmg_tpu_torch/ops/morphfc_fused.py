"""MorphFC-decay mixer kernels: axis branches, reweight reduction, combine.

Port of ``fused_morphfc_axes``, ``fused_morphfc_reduce`` and
``fused_morphfc_combine`` of ``vmg_tpu/ops/morphfc_fused.py``.  The
wrappers launch the CUDA kernels of ``csrc/morphfc.cu`` on CUDA tensors
(design notes there) and take the plain PyTorch versions beside them on
CPU tensors.  Tensors are ``(N, H, W, C)``; ``a`` holds the per-frame
softmax branch weights ``(N, 3, C)``.  Weights come as the kernels take
them, packed once by the module (``MorphFCDecay.operands``): matrices
``(C_in, C_out)`` in the tensors' dtype (the axis weights with the decay
folded in; the combine's projection, for the bf16 kernel, as its wgmma B
image, :func:`pack_combine_weight`), biases float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vmg_tpu_torch import _build


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


def morphfc_axes_plain(x, c, kh, bh, kw, bw, *, chunk_h: int, chunk_w: int):
    """Both decayed axis branches, relu(tokens @ k + b) / C in f32 rounded
    once to x's dtype, and the f32 per-frame sums of h + w + c taken from
    the unrounded branches.  Returns (h, w, psum (N, C) f32)."""
    C = x.shape[-1]

    def branch(k, b, chunk, axis):
        y = torch.relu(axis_tokens(x, chunk, axis).float() @ k.float() + b) * (1.0 / C)
        return axis_untokens(y, x.shape, chunk, axis)

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
    of M positions: f32, the C x C weight, the tokens and their projection
    (``AxesSmem`` in ``csrc/morphfc.cu``); bf16, one warpgroup with one
    slot (the x and c slabs) and one resident weight (:func:`axes_smem`)."""
    if dtype == torch.bfloat16:
        return axes_smem(C, _slab_bytes(M, C), 1, 1, 2)
    lanes = 256 // (C // 4)  # positions the epilogue's threads cover
    return -(-C * C * 4 // 128) * 128 + -(-max(M * C, lanes * C) * 4 // 128) * 128 + M * C * 4


# The bf16 big-form kernel (csrc/morphfc.cu ``morphfc_axes_wgmma_kernel``):
# persistent blocks of 1-2 consumer warpgroups, each with a ring of up to
# AXES_RING_MAX slots holding a tile's x and c slabs.
AXES_RING_MAX = 4


def _pow2(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def _slab_bytes(positions: int, C: int) -> int:
    return -(-positions * C * 2 // 128) * 128


def axes_slab_width(C: int, chunk_h: int, chunk_w: int) -> int:
    """WT of the bf16 kernel's ch x WT slabs: the least multiple of chunk_w
    that gives a slab at least 64 positions (one m64 sub-tile of tokens a
    branch at the stage-0/6 chunks, 8 x 8)."""
    return chunk_w * -(-64 // (chunk_h * chunk_w))


def axes_smem(C: int, slab: int, nwg: int, ring: int, npass: int) -> int:
    """Shared memory of the bf16 kernel (``axes_smem`` in the source): nwg
    rings of ``ring`` slots of two slabs, the resident weights (both where
    one pass runs both branches), the biases and the barriers."""
    return (nwg * ring * 2 * slab + (2 if npass == 1 else 1) * C * C * 2 + 2 * C * 4
            + nwg * AXES_RING_MAX * 8)


def axes_plan(C: int, chunk_h: int, chunk_w: int):
    """(WT, npass, nwg, ring) of the bf16 kernel, or None where no plan fits
    a block: one pass over the tiles with both weights resident where the
    chunks are equal and they fit (else two, H then W, x read twice), two
    warpgroups with at least two slots each, else one with at least one,
    the most slots up to AXES_RING_MAX."""
    WT = axes_slab_width(C, chunk_h, chunk_w)
    if C > 240 or WT > 256 or chunk_h > 64 or chunk_w > 64:
        return None
    slab = _slab_bytes(chunk_h * WT, C)
    for npass in ((1, 2) if chunk_h == chunk_w else (2,)):
        for nwg, least in ((2, 2), (1, 1)):
            ring = min(AXES_RING_MAX, (MAX_SMEM - axes_smem(C, slab, nwg, 0, npass))
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
    units = [N * b["upf"] for b in brs]
    caps = [-(-u // TOKEN_WG) for u in units]
    grid = max(2, min(sms, sum(caps)))
    bh = min(caps[0], grid - 1, max(1, round(grid * units[0] / sum(units))))
    for b, blocks in zip(brs, (bh, min(caps[1], grid - bh))):
        G = TOKEN_WG * blocks
        b.update(blocks=blocks, wpf=min(G // N, b["upf"]), fpw=0) if N <= G else \
            b.update(blocks=blocks, wpf=1, fpw=-(-N // G))
    sc, per_c = reduce_plan(N, H * W, C, 8, sms)
    slots = sum(b["wpf"] if b["fpw"] == 0 else 1 for b in brs)
    return dict(branches=brs, nt=nt, exact=token_exact(C, chunk_h, chunk_w),
                resident=resident, ring=ring, wring=wring, nws=nws, sc=sc, per_c=per_c,
                stot=slots + sc)


def token_plan_ints(plan) -> list:
    """A :func:`token_plan` as the C entry point reads it: the
    TOKEN_PLAN_FIELDS, then each branch's TOKEN_BRANCH_FIELDS."""
    return ([int(plan[k]) for k in TOKEN_PLAN_FIELDS]
            + [int(b[k]) for b in plan["branches"] for k in TOKEN_BRANCH_FIELDS])


def fused_morphfc_axes(x, c, kh, bh, kw, bw, *, chunk_h: int, chunk_w: int,
                       form: str | None = None):
    """x, c (N, H, W, C) -> (h, w, psum); needs C % chunk_h == C % chunk_w
    == W % chunk_w == 0.  kh, kw are the axis weights with the decay
    already folded in, as ``MorphFCDecay`` packs them once per parameter
    state (the JAX op folds it per call).  ``form``: "big" (the kernel
    that holds the whole C x C weight; it raises where that does not fit
    in shared memory), "token" (weight column tiles: any chunk * C) or
    None for :func:`axes_form`.  Both forms compute one function, so CPU tensors take the same plain
    version."""
    if form is None:
        form = axes_form(x.shape[-1], chunk_h, chunk_w)
    elif form not in FORMS:
        raise ValueError(f"form must be one of {FORMS} or None, got {form!r}")
    if x.device.type == "cpu":
        return morphfc_axes_plain(x, c, kh, bh, kw, bw, chunk_h=chunk_h,
                                  chunk_w=chunk_w)
    N, H, W, C = x.shape
    dt, dev = x.dtype, x.device
    if C % chunk_h or C % chunk_w or W % chunk_w:
        raise ValueError(f"chunks ({chunk_h}, {chunk_w}) do not divide C={C}, W={W}")
    _build.require(x, "x")
    for name, t, shape, dtype in (("c", c, x.shape, dt), ("kh", kh, (C, C), dt),
                                  ("bh", bh, (C,), torch.float32),
                                  ("kw", kw, (C, C), dt),
                                  ("bw", bw, (C,), torch.float32)):
        _build.require(t, name, shape=shape, dtype=dtype, device=dev)
    h, w = torch.empty_like(x), torch.empty_like(x)
    psum = torch.empty((N, C), dtype=torch.float32, device=dev)
    sms = _build.sm_count(dev.index or 0)
    if form == "big" and dt == torch.bfloat16:
        plan = axes_plan(C, chunk_h, chunk_w)
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
    else:
        # f32 big form and the token form: one block per slab of whole W
        # chunks, >= 64 tokens per branch, a multiple of 16 (the f32 slab
        # grid; the bf16 token kernel takes its own plan below)
        kg = -(-64 // (chunk_h * chunk_w))
        while chunk_h * chunk_w * kg % 16:
            kg += 1
        WT = chunk_w * kg
        if form == "big" and big_form_smem(chunk_h * WT, C, dt) > MAX_SMEM:
            raise ValueError(
                f"the big form needs {big_form_smem(chunk_h * WT, C, dt)} bytes of shared "
                f"memory at C={C}, chunks ({chunk_h}, {chunk_w}); a block has {MAX_SMEM}: "
                "use form='token'")
        S = -(-H // chunk_h) * -(-W // WT)
        scratch, nwg, ring, npass, grid = None, 0, 0, 0, 0
    # the bf16 token form: the pack, c's partials, the kernel, the sums pass
    img = bimg = plan_ints = None
    if form == "token" and dt == torch.bfloat16:
        tp = token_plan(N, H, W, C, chunk_h, chunk_w, sms)
        if tp is None:
            raise ValueError(f"the token form takes C % 16 == 0, C <= 512 and chunks <= 64 "
                             f"in bf16; got C={C}, chunks ({chunk_h}, {chunk_w})")
        tiles = sum(b["ntiles"] for b in tp["branches"])  # both images, back to back
        img = torch.empty(tiles * C * tp["nt"], dtype=dt, device=dev)
        bimg = torch.empty(tiles * tp["nt"], dtype=torch.float32, device=dev)
        S = tp["stot"]
        ints = token_plan_ints(tp)
        plan_ints = (ctypes.c_int * len(ints))(*ints)
    partial = torch.empty((N, S, C), dtype=torch.float32, device=dev)
    pointers = (x.data_ptr(), c.data_ptr(), kh.data_ptr(), bh.data_ptr(), kw.data_ptr(),
                bw.data_ptr(), h.data_ptr(), w.data_ptr())
    if form == "big":
        code = _build.load_library().vmg_morphfc_axes(
            *pointers, partial.data_ptr(), psum.data_ptr(), _build.ptr(scratch), N, H, W, C,
            chunk_h, chunk_w, WT, nwg, ring, npass, grid, _build.DTYPE_CODES[dt],
            _build.stream_of(x))
        _build.check(code, "vmg_morphfc_axes")
        fused_morphfc_axes.launches += 1
    else:
        code = _build.load_library().vmg_morphfc_axes_token(
            *pointers, _build.ptr(img), _build.ptr(bimg), partial.data_ptr(),
            psum.data_ptr(), plan_ints, N, H, W, C, chunk_h, chunk_w, WT,
            _build.DTYPE_CODES[dt], _build.stream_of(x))
        _build.check(code, "vmg_morphfc_axes_token")
        fused_morphfc_axes.token_launches += 1
    return h, w, psum


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


def fused_morphfc_reduce(h, w, c):
    if h.device.type == "cpu":
        return morphfc_reduce_plain(h, w, c)
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


# The bf16 combine kernel (csrc/morphfc.cu ``morphfc_combine_wgmma_kernel``):
# 64-pixel tiles; each tensor's tile lands in a ring slot as TMA boxes of 64
# channels x 64 pixels (8 KB); a ring of such slots per consumer warpgroup.
COMBINE_BOX = 64
COMBINE_BOX_BYTES = 64 * 64 * 2
COMBINE_RING_MAX = 8


def combine_tile_n(C: int) -> int:
    """Output channels per N-tile of the bf16 kernel: all C up to 224 (the
    Pk image stays in shared memory), else 64 -- Pk streams in column tiles
    of that width."""
    return C if C <= 224 else COMBINE_BOX


def combine_k_width(C: int) -> int:
    """Channels per h / w / c unit of the bf16 kernel: all C up to 160, else
    128 (two boxes)."""
    return C if C <= 160 else 2 * COMBINE_BOX


def combine_x_width(C: int) -> int:
    """Channels per x / res unit: as :func:`combine_k_width`, of an
    N-tile's."""
    nt = combine_tile_n(C)
    return nt if nt <= 160 else 2 * COMBINE_BOX


def combine_image_shape(C: int):
    """Shape of the bf16 kernel's Pk operand: ``(ceil(C / NT), C / 8, NT, 8)``
    (columns past C, in the last N-tile above C = 224, are zeros)."""
    nt = combine_tile_n(C)
    return (-(-C // nt), C // 8, nt, 8)


def pack_combine_weight(pk):
    """(C_in, C_out) projection -> the bf16 kernel's wgmma B image, per
    N-tile t of NT output channels ``img[t, kg, n, ki] = pk[8 kg + ki, t NT
    + n]`` (zero past C): K-major 8 x 16-byte core matrices, each N-tile
    contiguous.  ``MorphFCDecay`` packs it once per parameter state."""
    C = pk.shape[0]
    if tuple(pk.shape) != (C, C) or C % 16:
        raise ValueError(f"pk must be (C, C) with C % 16 == 0, got {tuple(pk.shape)}")
    t, _, nt, _ = combine_image_shape(C)
    pk = F.pad(pk, (0, t * nt - C))
    return pk.reshape(C // 8, 8, t, nt).permute(2, 0, 3, 1).contiguous()


def unpack_combine_weight(img):
    """The (C_in, C_out) projection of a :func:`pack_combine_weight` image."""
    t, kg, nt, _ = img.shape
    C = kg * 8
    return img.permute(1, 3, 0, 2).reshape(C, t * nt)[:, :C]


def _combine_slot_bytes(C: int) -> int:
    act = -(-combine_k_width(C) // COMBINE_BOX) * COMBINE_BOX_BYTES
    return max(act, C * COMBINE_BOX * 2 if C > 224 else 0)


def combine_smem(C: int, nwg: int, ring: int) -> int:
    """Shared memory of the bf16 kernel (``combine_smem`` in the source):
    nwg rings of ``ring`` slots, the resident Pk image (C <= 224) and the
    barriers."""
    return nwg * ring * _combine_slot_bytes(C) + (C * C * 2 if C <= 224 else 0) + 256


def combine_plan(C: int):
    """(consumer warpgroups, ring slots) of the bf16 kernel at C: the most
    warpgroups (3 where their registers allow, C <= 128; else 2) whose rings
    hold 3 slots each in shared memory, else the most with 2; at most
    ``COMBINE_RING_MAX`` slots."""
    fixed, slot = combine_smem(C, 0, 0), _combine_slot_bytes(C)
    options = (3, 2, 1) if C <= 128 else (2, 1)
    for least in (3, 2):
        for nwg in options:
            ring = min(COMBINE_RING_MAX, (MAX_SMEM - fixed) // (nwg * slot))
            if ring >= least:
                return nwg, ring
    raise ValueError(f"the combine kernel has no plan at C={C}")


def fused_morphfc_combine(x, h, w, c, a, pk, pb, *, act="tanh",
                          residual=None, res_scale=1.0):
    """pb (C,) f32; pk in x's dtype: (C_in, C_out), or in bf16 on CUDA the
    image :func:`pack_combine_weight` makes of it; ``act``: the gate,
    ``"tanh"``, ``"sigmoid"`` (sigmoid(p) - 0.5) or ``"relu"``."""
    if x.device.type == "cpu":
        return morphfc_combine_plain(x, h, w, c, a, pk, pb, act=act,
                                     residual=residual, res_scale=res_scale)
    if act not in _GATES:
        raise ValueError(f"unsupported gate act {act!r}")
    N, H, W, C = x.shape
    dt, dev = x.dtype, x.device
    _build.require(x, "x")
    if C % 16 or C > 448:
        raise ValueError(f"the combine kernel takes C % 16 == 0, C <= 448; got C={C}")
    pk_shape = combine_image_shape(C) if dt == torch.bfloat16 else (C, C)
    checks = [("h", h, x.shape, dt), ("w", w, x.shape, dt),
              ("c", c, x.shape, dt), ("a", a, (N, 3, C), dt),
              ("pk", pk, pk_shape, dt), ("pb", pb, (C,), torch.float32)]
    if residual is not None:
        checks.append(("residual", residual, x.shape, dt))
    for name, t, shape, dtype in checks:
        _build.require(t, name, shape=shape, dtype=dtype, device=dev)
    nwg, ring = combine_plan(C) if dt == torch.bfloat16 else (1, 2)
    out = torch.empty_like(x)
    code = _build.load_library().vmg_morphfc_combine(
        x.data_ptr(), h.data_ptr(), w.data_ptr(), c.data_ptr(), a.data_ptr(),
        pk.data_ptr(), pb.data_ptr(), _build.ptr(residual), out.data_ptr(),
        N, H * W, C, float(res_scale), _GATES[act], nwg, ring,
        _build.DTYPE_CODES[dt], _build.stream_of(x))
    _build.check(code, "vmg_morphfc_combine")
    fused_morphfc_combine.launches += 1
    return out


fused_morphfc_combine.launches = 0
