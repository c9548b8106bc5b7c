"""LTAM 2x2-window trajectory attention, forward and backward.

Port of ``ltam_attention_2x2`` of ``vmg_tpu/ops/ltam_attention.py`` and of
its custom VJP.  On CUDA tensors the wrapper launches the kernels of
``csrc/ltam.cu`` (design notes there): a forward that, when a gradient is
needed, also writes the softmax denominator, and a backward kernel (with
a second launch that sums the dpe partials), bound together by a
``torch.autograd.Function``.  On CPU tensors it takes
:func:`ltam_attention_plain`, which autograd differentiates.

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

# the largest head width C / heads the kernels take (csrc/ltam.cu: up to
# 32 lanes of 32 registers per (pixel, head)); every preset is below it
MAX_HEAD_WIDTH = 1024


def _tap(v: torch.Tensor, ki: int, kj: int) -> torch.Tensor:
    """(N, H, W, ...) -> per pixel, the value at its window's tap (ki, kj)."""
    s = v[:, ki::2, kj::2]
    return s.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def ltam_attention_plain(q, kv, pe, *, K: int, heads: int):
    N, H, W, C = q.shape
    d = C // heads
    kv6 = kv.reshape(N, H, W, K, 2, C)
    qh = q.reshape(N, H, W, heads, d)
    r = torch.arange(H, device=q.device) % 2
    c = torch.arange(W, device=q.device) % 2
    pos = 2 * r[:, None] + c[None, :]  # (H, W)
    num = torch.zeros((N, H, W, heads, d), dtype=torch.float32, device=q.device)
    den = torch.zeros((N, H, W, heads), dtype=torch.float32, device=q.device)
    for k in range(K):
        for t in range(4):
            ki, kj = divmod(t, 2)
            val = _tap(kv6[:, :, :, k, 0], ki, kj).float().reshape(N, H, W, heads, d)
            key = _tap(kv6[:, :, :, k, 1], ki, kj).float().reshape(N, H, W, heads, d)
            e = torch.exp((qh * key).sum(-1)) * pe[k, t][pos]
            den = den + e
            num = num + e[..., None] * val
    return (num / den.clamp_min(1e-30)[..., None]).reshape(N, H, W, C)


def ltam_attention_bwd_plain(q, kv, pe, g, *, K: int, heads: int):
    """Gradients (dq, dkv, dpe) of ``sum(ltam_attention_plain(q, kv, pe) *
    g)`` by autograd, each in its input's dtype: the plain version of the
    backward kernel."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, kv, pe)]
        out = ltam_attention_plain(*leaves, K=K, heads=heads)
        return torch.autograd.grad(out, leaves, g)


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


def _forward_kernel(q, kv, pe, K, heads, with_den: bool):
    """Launch the forward kernel: out, and den (N, H, W, heads) f32 (the
    unclamped softmax denominator) when ``with_den``."""
    _check(q, kv, pe, K, heads)
    N, H, W, C = q.shape
    out = torch.empty_like(q)
    den = (torch.empty((N, H, W, heads), dtype=torch.float32, device=q.device)
           if with_den else None)
    Wt, HB = fwd_plan(C, heads)
    code = _build.load_library().vmg_ltam_fwd(
        q.data_ptr(), kv.data_ptr(), pe.data_ptr(), out.data_ptr(),
        _build.ptr(den), N, H, W, C, K, heads, Wt, HB, _build.DTYPE_CODES[kv.dtype],
        _build.stream_of(q))
    _build.check(code, "vmg_ltam_fwd")
    ltam_attention_2x2.launches += 1
    return out, den


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


def ltam_attention_2x2_bwd(q, kv, pe, den, out, g, *, K: int, heads: int):
    """Gradients (dq f32, dkv in kv's dtype, dpe f32) of the attention from
    the forward's saved q, kv, pe, den (unclamped), out and the f32
    cotangent g.  CPU tensors take :func:`ltam_attention_bwd_plain`."""
    if q.device.type == "cpu":
        return ltam_attention_bwd_plain(q, kv, pe, g, K=K, heads=heads)
    _check(q, kv, pe, K, heads)
    N, H, W, C = q.shape
    for name, t, shape in (("den", den, (N, H, W, heads)), ("out", out, q.shape),
                           ("g", g, q.shape)):
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


class _LtamAttention(torch.autograd.Function):
    """The kernel pair under autograd: the forward saves q, kv, pe, den and
    out, the backward launches the backward kernel (the custom VJP of
    ``vmg_tpu/ops/ltam_attention.py:344-362``)."""

    @staticmethod
    def forward(ctx, q, kv, pe, K, heads):
        out, den = _forward_kernel(q, kv, pe, K, heads, with_den=True)
        ctx.save_for_backward(q, kv, pe, den, out)
        ctx.K, ctx.heads = K, heads
        return out

    @staticmethod
    def backward(ctx, g):
        q, kv, pe, den, out = ctx.saved_tensors
        dq, dkv, dpe = ltam_attention_2x2_bwd(
            q, kv, pe, den, out, g.float().contiguous(), K=ctx.K, heads=ctx.heads)
        return dq, dkv, dpe, None, None


def ltam_attention_2x2(q, kv, pe, *, K: int, heads: int):
    """See the module docstring.  CPU tensors take the plain version; on
    CUDA tensors the forward kernel runs, through the autograd Function
    (which also writes the denominator) when a gradient is needed."""
    if q.device.type == "cpu":
        return ltam_attention_plain(q, kv, pe, K=K, heads=heads)
    if torch.is_grad_enabled() and (q.requires_grad or kv.requires_grad
                                    or pe.requires_grad):
        return _LtamAttention.apply(q, kv, pe, K, heads)
    return _forward_kernel(q, kv, pe, K, heads, with_den=False)[0]


ltam_attention_2x2.launches = 0
ltam_attention_2x2.bwd_launches = 0
