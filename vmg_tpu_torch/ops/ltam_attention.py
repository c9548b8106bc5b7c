"""LTAM 2x2-window trajectory attention, forward and backward.

Port of ``ltam_attention_2x2`` of ``vmg_tpu/ops/ltam_attention.py`` and of
its custom VJP, as two operators (``ops/library.py``): ``vmg::ltam_fwd``
-- on CUDA tensors the forward kernel of ``csrc/ltam.cu`` (design notes
there), which, when a gradient is needed, also writes the softmax
denominator; on CPU tensors :func:`ltam_attention_plain` -- and
``vmg::ltam_bwd`` -- the backward kernel (with a second launch that sums
the dpe partials), or :func:`ltam_attention_bwd_plain` -- bound together
by ``register_autograd`` (the custom VJP of
``vmg_tpu/ops/ltam_attention.py:344-362``).

Layout (the port's own; the TPU kernel padded every slot to 128 lanes):

  * q  (N, H, W, C) f32, L2-normalized and scaled;
  * kv (N, H, W, K*2*C) in the feature dtype: per keyframe slot, C value
    channels then C normalized-key channels;
  * pe (K, 4, 4, heads) f32 factors exp(decay * rpe), indexed
    [slot, key tap, query in-window position, head].

Returns (N, H, W, C) f32.  Tap t = 2*ki + kj of pixel (r, c) reads source
(2*(r//2) + ki, 2*(c//2) + kj); the query position is 2*(r%2) + c%2.
"""

from __future__ import annotations

import torch

from vmg_tpu_torch import _build
from vmg_tpu_torch.ops import library

# the largest head width C / heads the kernels take (csrc/ltam.cu: up to
# 32 lanes of 32 registers per (pixel, head)); every preset is below it
MAX_HEAD_WIDTH = 1024


def _tap(v: torch.Tensor, ki: int, kj: int) -> torch.Tensor:
    """(N, H, W, ...) -> per pixel, the value at its window's tap (ki, kj)."""
    s = v[:, ki::2, kj::2]
    return s.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _untap(g: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`_tap`'s repeat: (N, H, W, ...) -> (N, H/2, W/2,
    ...), each window's four pixels summed."""
    N, H, W = g.shape[:3]
    return g.reshape(N, H // 2, 2, W // 2, 2, *g.shape[3:]).sum(dim=(2, 4))


def _positions(H: int, W: int, device):
    """(H, W) in-window query position 2 (r % 2) + c % 2 of each pixel."""
    r = torch.arange(H, device=device) % 2
    c = torch.arange(W, device=device) % 2
    return 2 * r[:, None] + c[None, :]


def _taps(q, kv, pe, K: int, heads: int):
    """Per slot k and tap t: (val, key, s = exp(q . key), e = s pe) at every
    pixel, f32, by head."""
    N, H, W, C = q.shape
    d = C // heads
    kv6 = kv.reshape(N, H, W, K, 2, C)
    qh = q.reshape(N, H, W, heads, d)
    pos = _positions(H, W, q.device)
    for k in range(K):
        for t in range(4):
            ki, kj = divmod(t, 2)
            val = _tap(kv6[:, :, :, k, 0], ki, kj).float().reshape(N, H, W, heads, d)
            key = _tap(kv6[:, :, :, k, 1], ki, kj).float().reshape(N, H, W, heads, d)
            s = torch.exp((qh * key).sum(-1))
            yield k, t, val, key, s, s * pe[k, t][pos]


def _plain_forward(q, kv, pe, K: int, heads: int):
    """(out (N, H, W, C), den (N, H, W, heads)) f32: den is the unclamped
    softmax denominator the backward kernel reads."""
    N, H, W, C = q.shape
    num = torch.zeros((N, H, W, heads, C // heads), dtype=torch.float32, device=q.device)
    den = torch.zeros((N, H, W, heads), dtype=torch.float32, device=q.device)
    for _, _, val, _, _, e in _taps(q, kv, pe, K, heads):
        den = den + e
        num = num + e[..., None] * val
    return (num / den.clamp_min(1e-30)[..., None]).reshape(N, H, W, C), den


def ltam_attention_plain(q, kv, pe, *, K: int, heads: int):
    return _plain_forward(q, kv, pe, K, heads)[0]


def ltam_attention_bwd_plain(q, kv, pe, g, *, K: int, heads: int):
    """Gradients (dq, dkv, dpe) of ``sum(ltam_attention_plain(q, kv, pe) *
    g)``, each in its input's dtype, written out (the plain version of the
    backward kernel; autograd of :func:`ltam_attention_plain` gives the
    same up to f32 rounding).  With p = e / den and out = sum p val, a tap's
    logit gradient is p (g . val - g . out): dq sums it times the key, each
    source pixel's dkey its queries' times q and its dval their p g, and
    dpe[k, t, pos] the pixels' (g . val - g . out) s / den."""
    N, H, W, C = q.shape
    d = C // heads
    out, den = _plain_forward(q, kv, pe, K, heads)
    den = den.clamp_min(1e-30)
    gh = g.float().reshape(N, H, W, heads, d)
    qh = q.float().reshape(N, H, W, heads, d)
    go = (gh * out.reshape(N, H, W, heads, d)).sum(-1)
    pos = _positions(H, W, q.device)
    dq = torch.zeros_like(qh)
    dkv = torch.zeros((N, H, W, K, 2, heads, d), dtype=torch.float32, device=q.device)
    dpe = torch.zeros((K, 4, 4, heads), dtype=torch.float32, device=q.device)
    for k, t, val, key, s, e in _taps(q, kv, pe, K, heads):
        ki, kj = divmod(t, 2)
        de = ((gh * val).sum(-1) - go) / den
        dlogit = de * e
        dq = dq + dlogit[..., None] * key
        dkv[:, ki::2, kj::2, k, 1] += _untap(dlogit[..., None] * qh)
        dkv[:, ki::2, kj::2, k, 0] += _untap((e / den)[..., None] * gh)
        ds = de * s
        for p in range(4):
            dpe[k, t, p] = ds[:, pos == p].sum(dim=(0, 1))
    return (dq.reshape(q.shape).to(q.dtype), dkv.reshape(kv.shape).to(kv.dtype),
            dpe.to(pe.dtype))


def _check(q, kv, pe, K, heads):
    N, H, W, C = q.shape
    if H % 2 or W % 2:
        raise ValueError("2x2 windows need even H and W")
    if C % heads or C // heads > MAX_HEAD_WIDTH:
        raise ValueError(f"head width C/heads = {C}/{heads} unsupported")
    _build.require(q, "q", dtype=torch.float32)
    _build.require(kv, "kv", shape=(N, H, W, K * 2 * C), device=q.device)
    _build.require(pe, "pe", shape=(K, 4, 4, heads), dtype=torch.float32,
                   device=q.device)


def _lanes_for(d: int, R: int) -> int:
    """The least power of two L with L * R >= d (``ltam_lanes_for``)."""
    L = 1
    while L * R < d:
        L *= 2
    return L


def lanes(d: int) -> int:
    """Lanes per (pixel, head) of the forward kernel: the least power of two
    whose 32 registers a lane hold the head width d (``ltam_lanes``)."""
    return _lanes_for(d, 32)


def _pixel_stride(seg2: int, es: int) -> int:
    """The forward's kv pixel stride in shared memory (``ltam_pixel_stride``):
    the staged 2 HB d channels, padded in 16-byte steps so that two strides
    fall 16 banks apart."""
    if seg2 * es % 16:
        return seg2
    return seg2 + (8 - (seg2 * es // 4) % 16) % 16 * 4 // es


# kv slot buffers of the forward kernel's block (``kLtamBufs``): slots in flight
FWD_BUFFERS = 4


def fwd_smem(Wt: int, HB: int, d: int, dtype, nbuf: int = FWD_BUFFERS) -> int:
    """Shared memory of the forward kernel's block (``ltam_fwd_smem``): q /
    out as f32, ``nbuf`` kv slot buffers of two rows of Wt pixels each, and
    the mbarriers of the bulk copies."""
    es = 2 if dtype == torch.bfloat16 else 4
    kv = nbuf * 2 * Wt * _pixel_stride(2 * HB * d, es) * es
    return -(-2 * Wt * HB * d * 4 // 16) * 16 + -(-kv // 8) * 8 + (1 + nbuf) * 8


def fwd_plan(C: int, heads: int):
    """(Wt, HB) of the forward kernel: HB, the most heads that divide
    ``heads`` with HB * lanes <= 32, and Wt, the widest even column span that
    keeps the block's 2 Wt HB lane groups within 128 threads."""
    L = lanes(C // heads)
    HB = max(b for b in range(1, heads + 1) if heads % b == 0 and b * L <= 32)
    return 2 * (32 // (HB * L)), HB


def _den_shape(q, heads: int, with_den: bool):
    return (*q.shape[:3], heads) if with_den else (0,)


def _fwd_cuda(q, kv, pe, K: int, heads: int, with_den: bool):
    """Launch the forward kernel: out, and den (N, H, W, heads) f32 (the
    unclamped softmax denominator; empty unless ``with_den``)."""
    _check(q, kv, pe, K, heads)
    N, H, W, C = q.shape
    out = torch.empty_like(q)
    den = torch.empty(_den_shape(q, heads, with_den), dtype=torch.float32, device=q.device)
    Wt, HB = fwd_plan(C, heads)
    code = _build.load_library().vmg_ltam_fwd(
        q.data_ptr(), kv.data_ptr(), pe.data_ptr(), out.data_ptr(),
        den.data_ptr() if with_den else None, N, H, W, C, K, heads, Wt, HB,
        _build.DTYPE_CODES[kv.dtype], _build.stream_of(q))
    _build.check(code, "vmg_ltam_fwd")
    ltam_attention_2x2.launches += 1
    return out, den


def _fwd_cpu(q, kv, pe, K: int, heads: int, with_den: bool):
    out, den = _plain_forward(q, kv, pe, K, heads)
    return out, den if with_den else den.new_empty((0,))


def _fwd_fake(q, kv, pe, K: int, heads: int, with_den: bool):
    return (library.empty(q, dtype=torch.float32),
            library.empty(q, _den_shape(q, heads, with_den), torch.float32))


_ltam_fwd = library.define(
    "ltam_fwd", "(Tensor q, Tensor kv, Tensor pe, int K, int heads, bool with_den) "
    "-> (Tensor, Tensor)", cpu=_fwd_cpu, cuda=_fwd_cuda, fake=_fwd_fake)


# threads of the backward kernel's block (``kLtamBwdThreads``); shared memory
# one block may use on Hopper (227 KB)
BWD_THREADS = 256
MAX_SMEM = 232_448


def bwd_lanes(d: int) -> int:
    """Lanes per (pixel, head) of the backward kernel (``ltam_bwd_lanes``):
    the least power of two whose 8 registers a lane -- 12 where that halves
    the lanes, 32 above d = 256 -- hold the head width d: 4 at d = 28 (where
    the forward has 1) and at d = 36."""
    if d > 256:
        return _lanes_for(d, 32)
    return min(_lanes_for(d, 8), _lanes_for(d, 12))


def bwd_smem(Wt: int, HB: int, d: int, dtype, nbuf: int) -> int:
    """Shared memory of the backward kernel's block (``ltam_bwd_smem``): q
    and g as f32, the (p, dlogit, dpe term) exchange of 2 Wt HB queries x 4
    taps, ``nbuf`` kv slot buffers and their mbarriers."""
    es = 2 if dtype == torch.bfloat16 else 4
    q = -(-2 * Wt * HB * d * 4 // 16) * 16
    pd = -(-2 * Wt * HB * 4 * 3 * 4 // 16) * 16
    kv = nbuf * 2 * Wt * _pixel_stride(2 * HB * d, es) * es
    return 2 * q + pd + -(-kv // 8) * 8 + (1 + nbuf) * 8


def bwd_plan(C: int, heads: int, K: int, dtype):
    """(Wt, HB, nbuf) of the backward kernel: HB, the most heads that divide
    ``heads`` with two columns' 4 HB lane groups within a block; Wt, the
    widest even span within ``BWD_THREADS`` threads; min(K, 4) kv buffers,
    fewer (then narrower spans) where shared memory runs out."""
    d = C // heads
    L = bwd_lanes(d)
    HB = max(b for b in range(1, heads + 1)
             if heads % b == 0 and 4 * b * L <= BWD_THREADS)
    Wt = 2 * (BWD_THREADS // (4 * HB * L))
    nbuf = min(K, FWD_BUFFERS)
    while nbuf > 1 and bwd_smem(Wt, HB, d, dtype, nbuf) > MAX_SMEM:
        nbuf -= 1
    while Wt > 2 and bwd_smem(Wt, HB, d, dtype, nbuf) > MAX_SMEM:
        Wt -= 2
    return Wt, HB, nbuf


def _bwd_cuda(q, kv, pe, den, out, g, K: int, heads: int):
    _check(q, kv, pe, K, heads)
    N, H, W, C = q.shape
    for name, t, shape in (("den", den, (N, H, W, heads)), ("out", out, q.shape),
                           ("g", g, q.shape)):
        if t is None:
            raise ValueError(f"the backward kernel reads the forward's {name}")
        _build.require(t, name, shape=shape, dtype=torch.float32, device=q.device)
    Wt, HB, nbuf = bwd_plan(C, heads, K, kv.dtype)
    dq = torch.empty_like(q)
    dkv = torch.empty_like(kv)
    dpe = torch.empty_like(pe)
    # dpe: one partial per (bin, block of a head group), summed by a second
    # launch in block order
    nblk = N * (H // 2) * -(-W // Wt)
    partial = torch.empty((K * 16 * heads, nblk), dtype=torch.float32, device=q.device)
    code = _build.load_library().vmg_ltam_bwd(
        q.data_ptr(), kv.data_ptr(), pe.data_ptr(), den.data_ptr(), out.data_ptr(),
        g.data_ptr(), dq.data_ptr(), dkv.data_ptr(), dpe.data_ptr(), partial.data_ptr(),
        N, H, W, C, K, heads, Wt, HB, nbuf, _build.DTYPE_CODES[kv.dtype],
        _build.stream_of(q))
    _build.check(code, "vmg_ltam_bwd")
    ltam_attention_2x2.bwd_launches += 1
    return dq, dkv, dpe


def _bwd_cpu(q, kv, pe, den, out, g, K: int, heads: int):
    return ltam_attention_bwd_plain(q, kv, pe, g, K=K, heads=heads)


def _bwd_fake(q, kv, pe, den, out, g, K: int, heads: int):
    return library.empty(q), library.empty(kv), library.empty(pe)


_ltam_bwd = library.define(
    "ltam_bwd", "(Tensor q, Tensor kv, Tensor pe, Tensor? den, Tensor? out, Tensor g, int K, "
    "int heads) -> (Tensor, Tensor, Tensor)", cpu=_bwd_cpu, cuda=_bwd_cuda, fake=_bwd_fake)


def ltam_attention_2x2_bwd(q, kv, pe, den, out, g, *, K: int, heads: int):
    """Gradients (dq f32, dkv in kv's dtype, dpe f32) of the attention from
    the forward's saved q, kv, pe, den (unclamped), out and the f32
    cotangent g (``vmg::ltam_bwd``: the backward kernel on CUDA tensors,
    :func:`ltam_attention_bwd_plain` on CPU tensors)."""
    return _ltam_bwd(q, kv, pe, den, out, g, K, heads)


def _setup_context(ctx, inputs, output):
    q, kv, pe, K, heads, with_den = inputs
    ctx.save_for_backward(q, kv, pe, output[1], output[0])
    ctx.K, ctx.heads, ctx.with_den = K, heads, with_den


def _backward(ctx, g, _g_den):
    if not ctx.with_den:
        raise RuntimeError("ltam_fwd ran without the denominator its backward reads: "
                           "call it through ltam_attention_2x2")
    q, kv, pe, den, out = ctx.saved_tensors
    dq, dkv, dpe = _ltam_bwd(q, kv, pe, den, out, g.float().contiguous(), ctx.K, ctx.heads)
    return dq, dkv, dpe, None, None, None


library.register_autograd(_ltam_fwd, _backward, _setup_context)


def ltam_fwd(q, kv, pe, *, K: int, heads: int, with_den: bool = False):
    """``vmg::ltam_fwd`` itself: (out, den), den empty unless ``with_den``."""
    return _ltam_fwd(q, kv, pe, K, heads, with_den)


def ltam_attention_2x2(q, kv, pe, *, K: int, heads: int):
    """See the module docstring: ``vmg::ltam_fwd``, the forward kernel on
    CUDA tensors, the plain version on CPU tensors; it also writes the
    denominator (for the backward) when a gradient is needed."""
    with_den = torch.is_grad_enabled() and (q.requires_grad or kv.requires_grad
                                            or pe.requires_grad)
    return _ltam_fwd(q, kv, pe, K, heads, with_den)[0]


ltam_attention_2x2.launches = 0
ltam_attention_2x2.bwd_launches = 0
