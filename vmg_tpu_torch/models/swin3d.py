"""3D shifted-window cross-slice attention (``vmg_tpu/models/swin3d.py``).

The temporal tail of a U-Net stage where ``temporal_type`` is None and
``temporal_empty`` is false.  The reference loops over the window's time
slices, each slice's queries attending to the *other* slices' keys; that
is one N x N window attention with the same-slice keys masked out (an
additive -1e9, whose softmax weights are exactly 0 in float32), which is
how the JAX package writes it with XLA and how it is written here: torch
matmuls, a float32 softmax and additive masks.  No hand kernel: the JAX
package runs no TPU kernel on this tail either.

Channels-last ``(B, D, H, W, C)``; module attribute names follow the
reference state-dict keys (``traj_mixing.blocks.<i>.attn.q`` ...).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
from torch import nn

from vmg_tpu_torch.models.blocks import Mlp
from vmg_tpu_torch.models.norms import TorchLayerNorm
from vmg_tpu_torch.ops.warp import flow_warp
from vmg_tpu_torch.ops.window import (
    compute_shift_mask_3d,
    get_window_size,
    window_partition_3d,
    window_reverse_3d,
)


def _table_rows(window_size) -> int:
    wd, wh, ww = window_size
    return (2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1)


@functools.lru_cache(maxsize=None)
def _relative_position_index_3d(window_size: Tuple[int, int, int],
                                table_window: Tuple[int, int, int] | None = None) -> np.ndarray:
    """(N, N) index of each (query, key) offset of a ``window_size`` window
    into the relative-position table of a ``table_window`` window (default:
    the window itself), (2td-1)(2th-1)(2tw-1) rows."""
    wd, wh, ww = window_size
    td, th, tw = table_window or window_size
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += td - 1
    rel[:, :, 1] += th - 1
    rel[:, :, 2] += tw - 1
    rel[:, :, 0] *= (2 * th - 1) * (2 * tw - 1)
    rel[:, :, 1] *= 2 * tw - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def _cross_slice_mask(window_size: Tuple[int, int, int]) -> np.ndarray:
    """(N, N) additive mask excluding keys in the query's own time slice."""
    wd, wh, ww = window_size
    slice_id = np.arange(wd * wh * ww) // (wh * ww)
    same = slice_id[:, None] == slice_id[None, :]
    return np.where(same, -1e9, 0.0).astype(np.float32)


class RWindowAttention(nn.Module):
    """Cross-time-slice window attention with a 3D relative position bias.
    ``only_one``: the reference's hard-selection form (each query sums its
    top ``window_size[0] - 1`` keys, or with ``align_mask`` its argmax key,
    weighted by their probabilities); ``kv_src`` gives the keys and values
    their own source (the unfold-KV branch).

    The bias table has a row per relative offset of the nominal window.
    The JAX package sizes it for the window the input shrinks it to
    (``get_window_size``) where the input is smaller; such a table loads
    as it is (:meth:`_load_from_state_dict`), and either is indexed by the
    offsets of the window the call runs."""

    def __init__(self, dim, window_size, num_heads, qkv_bias=True, only_one=False,
                 align_mask=False, device=None):
        super().__init__()
        self.window_size = tuple(window_size)
        self.num_heads = num_heads
        self.only_one, self.align_mask = only_one, align_mask
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            _table_rows(self.window_size), num_heads, device=device))
        self.q = nn.Linear(dim, dim, bias=qkv_bias, device=device)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kw):
        key = prefix + "relative_position_bias_table"
        table = self.relative_position_bias_table
        if key in state_dict and state_dict[key].shape != table.shape:
            self.relative_position_bias_table = nn.Parameter(
                table.new_zeros(state_dict[key].shape))
        super()._load_from_state_dict(state_dict, prefix, *args, **kw)

    def _bias_index(self, ws) -> np.ndarray:
        """Table rows of the (query, key) offsets of the window ``ws``."""
        rows = self.relative_position_bias_table.shape[0]
        table_window = tuple(ws) if rows == _table_rows(ws) else self.window_size
        return _relative_position_index_3d(tuple(ws), table_window).reshape(-1)

    def forward(self, x, kv_src=None, mask=None, window_size=None):
        """x: (B_, N, C) windowed tokens of ``window_size`` windows (None:
        the nominal one); kv_src: (B_, N, C) or None (x); mask: (nW, N, N)
        shift mask or None."""
        ws = self.window_size if window_size is None else tuple(window_size)
        B_, N, C = x.shape
        h = self.num_heads
        d = C // h
        kv = self.kv(x if kv_src is None else kv_src)
        q = self.q(x).reshape(B_, N, h, d).transpose(1, 2)
        k = kv[..., :C].reshape(B_, N, h, d).transpose(1, 2)
        v = kv[..., C:].reshape(B_, N, h, d).transpose(1, 2)
        # the logits accumulate in float32 (bf16 products are exact there)
        attn = (q * d ** -0.5).float() @ k.float().transpose(-1, -2)
        idx = torch.from_numpy(self._bias_index(ws))
        bias = self.relative_position_bias_table[idx.to(x.device)].reshape(N, N, h)
        excl = torch.from_numpy(_cross_slice_mask(ws)).to(x.device)
        attn = attn + bias.permute(2, 0, 1).float()[None] + excl
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, h, N, N) + mask[None, :, None]).reshape(
                B_, h, N, N)
        attn = attn.softmax(dim=-1)
        if self.only_one:
            kk = 1 if self.align_mask else max(1, ws[0] - 1)
            w_top, i_top = attn.topk(kk, dim=-1)  # (B_, h, N, kk)
            g = torch.gather(v[:, :, None].expand(B_, h, N, N, d), 3,
                             i_top[..., None].expand(B_, h, N, kk, d))
            out = (g * w_top[..., None].to(v.dtype)).sum(dim=3)
        else:
            out = (attn @ v.float()).to(x.dtype)
        return self.proj(out.transpose(1, 2).reshape(B_, N, C))


def _unfold_kv_feature(x, wh: int, ww: int):
    """The reference's unfold-KV context (``unfold_feature``): per (wh, ww)
    window the surrounding (2wh, 2ww) patch (zero pad wh/2, ww/2), 2x2
    mean-pooled back to window size.  x: (N, H, W, C), H % wh == W % ww == 0."""
    N, H, W, C = x.shape
    nh, nw = H // wh, W // ww
    xp = torch.nn.functional.pad(x, (0, 0, ww // 2, ww // 2, wh // 2, wh // 2))
    rows = torch.from_numpy((np.arange(nh)[:, None] * wh + np.arange(2 * wh)).reshape(-1))
    cols = torch.from_numpy((np.arange(nw)[:, None] * ww + np.arange(2 * ww)).reshape(-1))
    y = xp[:, rows.to(x.device)][:, :, cols.to(x.device)]
    y = y.reshape(N, nh, wh, 2, nw, ww, 2, C).mean(dim=(3, 6))
    return y.reshape(N, H, W, C)


class EncoderBlockOnOnetoken(nn.Module):
    """Shifted-window block: cross-slice attention, then the reference's
    ``Mlp_GEGLU`` (fc1 -> GELU -> fc2), each with a residual.
    ``if_unfold``: the unfold-KV branch (a hard-selection attention over
    pooled context, fused through a 2C -> C linear); flows given to
    :meth:`forward` add the flow-aligned residual."""

    def __init__(self, dim, num_heads, window_size=(3, 8, 8), shift_size=(0, 0, 0),
                 mlp_ratio=2.0, qkv_bias=True, if_unfold=False, *, gelu_act="erf",
                 norm_impl="module", device=None):
        super().__init__()
        self.window_size, self.shift_size = tuple(window_size), tuple(shift_size)
        self.num_heads, self.if_unfold = num_heads, if_unfold
        self.norm1 = TorchLayerNorm(dim, impl=norm_impl, device=device)
        self.attn = RWindowAttention(dim, self.window_size, num_heads, qkv_bias,
                                     device=device)
        if if_unfold:
            self.attn1 = RWindowAttention(dim, self.window_size, num_heads, qkv_bias,
                                          only_one=True, align_mask=True, device=device)
            self.proj = nn.Linear(2 * dim, dim, device=device)
        if num_heads > 0:
            self.norm2 = TorchLayerNorm(dim, impl=norm_impl, device=device)
            self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, gelu_act=gelu_act, device=device)

    def forward(self, x, flow_f=None, flow_b=None):
        B, D, H, W, C = x.shape
        ws, ss = get_window_size((D, H, W), self.window_size, self.shift_size)
        y = self.norm1(x)
        flow_x = None if flow_f is None else _flow_alignment(y, flow_f, flow_b)
        pad = ((-D) % ws[0], (-H) % ws[1], (-W) % ws[2])
        y = torch.nn.functional.pad(y, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        _, Dp, Hp, Wp, _ = y.shape
        shifted = any(s > 0 for s in ss)
        mask = None
        if shifted:
            y = torch.roll(y, (-ss[0], -ss[1], -ss[2]), dims=(1, 2, 3))
            mask = compute_shift_mask_3d(Dp, Hp, Wp, ws, ss, device=x.device)
        windows = window_partition_3d(y, ws)
        attn = self.attn(windows, mask=mask, window_size=ws)
        if self.if_unfold:
            ctx = _unfold_kv_feature(y.reshape(B * Dp, Hp, Wp, C), ws[1], ws[2])
            kv = window_partition_3d(ctx.reshape(B, Dp, Hp, Wp, C), ws)
            attn1 = self.attn1(windows, kv_src=kv, mask=mask, window_size=ws)
            attn = self.proj(torch.cat([attn, attn1], dim=-1))
        y = window_reverse_3d(attn, ws, B, Dp, Hp, Wp)
        if shifted:
            y = torch.roll(y, ss, dims=(1, 2, 3))
        y = y[:, :D, :H, :W]
        if flow_x is not None:
            y = y + flow_x
        x = x + y
        if self.num_heads > 0:
            x = x + self.mlp(self.norm2(x))
        return x


def _flow_alignment(x, flow_f, flow_b):
    """Even and odd frames warped toward each other, re-interleaved:
    out[2i] = warp(x[2i+1], flow_b[i]), out[2i+1] = warp(x[2i], flow_f[i])
    (border padding).  flows: (B, D // 2, H, W, 2)."""
    B, D, H, W, C = x.shape
    F2 = flow_f.shape[1]
    if D != 2 * F2:
        raise ValueError(f"flow alignment needs D == 2 * flow frames, got {D} and {F2}")
    f1 = x[:, ::2].reshape(B * F2, H, W, C)
    f2 = x[:, 1::2].reshape(B * F2, H, W, C)
    right = flow_warp(f1, flow_f.reshape(B * F2, H, W, 2), "bilinear", "border")
    left = flow_warp(f2, flow_b.reshape(B * F2, H, W, 2), "bilinear", "border")
    return torch.stack([left.reshape(B, F2, H, W, C), right.reshape(B, F2, H, W, C)],
                       dim=2).reshape(B, D, H, W, C)


def _clip_index(idx, n: int) -> torch.Tensor:
    """Frame indices as the JAX package's gather reads them: a negative
    index wraps once, then the index clamps to [0, n - 1]."""
    idx = np.asarray(idx, dtype=np.int64)
    return torch.from_numpy(np.where(idx < 0, idx + n, idx).clip(0, n - 1))


class DecoderLayer(nn.Module):
    """``depth`` cross-slice blocks, alternately unshifted and shifted by half
    a window, with the reference's mirror extension of the frames when D is
    not a multiple of the window's length (its index arithmetic kept, the
    out-of-range indices a clip shorter than the window gives read as the
    JAX package reads them)."""

    def __init__(self, dim, depth, num_heads, window_size=(2, 4, 4), mlp_ratio=2.0,
                 qkv_bias=True, if_unfold=False, *, gelu_act="erf", norm_impl="module",
                 device=None):
        super().__init__()
        self.window_size = tuple(window_size)
        shift = tuple(w // 2 for w in self.window_size)
        self.blocks = nn.ModuleList(
            EncoderBlockOnOnetoken(dim, num_heads, self.window_size,
                                   (0, 0, 0) if i % 2 == 0 else shift, mlp_ratio, qkv_bias,
                                   if_unfold, gelu_act=gelu_act, norm_impl=norm_impl,
                                   device=device)
            for i in range(depth))

    def forward(self, x, flow_f=None, flow_b=None):
        D = x.shape[1]
        wt = self.window_size[0]
        seq_back = None
        if D % wt:
            delta = -(-D // wt) * wt - D
            k = (D // wt) * wt
            new_seq = list(range(k)) + list(range(k - delta, k)) + list(range(k, D))
            seq_back = list(range(k)) + list(range(D + delta - (D - k), D + delta))
            x = x[:, _clip_index(new_seq, D).to(x.device)]
        for blk in self.blocks:
            x = blk(x, flow_f, flow_b)
        if seq_back is not None:
            x = x[:, _clip_index(seq_back, x.shape[1]).to(x.device)]
        return x
