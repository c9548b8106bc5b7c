"""LTAM 2x2-window trajectory attention, forward.

Port of ``ltam_attention_2x2`` of ``vmg_tpu/ops/ltam_attention.py``.  The
wrapper launches the CUDA kernel ``csrc/ltam.cu`` on CUDA tensors (design
notes there) and takes :func:`ltam_attention_plain` on CPU tensors.

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
            den += e
            num += e[..., None] * val
    return (num / den.clamp_min(1e-30)[..., None]).reshape(N, H, W, C)


def ltam_attention_2x2(q, kv, pe, *, K: int, heads: int):
    if q.device.type == "cpu":
        return ltam_attention_plain(q, kv, pe, K=K, heads=heads)
    N, H, W, C = q.shape
    if H % 2 or W % 2:
        raise ValueError("2x2 windows need even H and W")
    if C % heads or C // heads > 32:
        raise ValueError(f"head width C/heads = {C}/{heads} unsupported")
    _build.require(q, "q", dtype=torch.float32)
    _build.require(kv, "kv", shape=(N, H, W, K * 2 * C), device=q.device)
    _build.require(pe, "pe", shape=(K, 4, 4, heads), dtype=torch.float32,
                   device=q.device)
    out = torch.empty_like(q)
    code = _build.load_library().vmg_ltam_fwd(
        q.data_ptr(), kv.data_ptr(), pe.data_ptr(), out.data_ptr(), N, H, W,
        C, K, heads, _build.DTYPE_CODES[kv.dtype], _build.stream_of(q))
    _build.check(code, "vmg_ltam_fwd")
    ltam_attention_2x2.launches += 1
    return out


ltam_attention_2x2.launches = 0
