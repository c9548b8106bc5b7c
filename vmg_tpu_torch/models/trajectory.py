"""Trajectory-aware bidirectional propagation (``vmg_tpu/models/trajectory.py``).

The recurrence is a plain Python loop over the frames of each direction.
It carries the keyframe buffers themselves, nearest-warped along the
trajectory (the JAX package's ``carry_impl='warped'``): nearest
resampling composes exactly, so one wide nearest warp per step replaces
per-slot gathers.  Per slot the carried buffer holds C value channels
(the step's output at the keyframe) then C normalized-key channels (the
keyframe's input feature), the layout ``ops/ltam_attention`` reads.  A
slot is appended after every ``keyframe_stride``-th step, so a step sees
K = its number of past keyframes, exactly, with no masking.

In training with ``remat`` on, each step runs under
``torch.utils.checkpoint`` (the JAX package's per-step ``jax.checkpoint``):
its activations are recomputed in the backward pass, the LTAM forward
kernel included.

LTAM runs its CUDA kernel (``ops/ltam_attention``) where the JAX package
runs its TPU kernel: mode 'wins', 2x2 twins windows, ``ltam`` on, no
``en_field``, even H and W, the warped carry.  Elsewhere the windowed
module form runs ('wins' at any twins window, or 'max': a per-head hard
max over the slots), as the JAX package runs its XLA windows form.
``carry_impl='loc'`` is the JAX package's reference-shaped carry (per-slot
location maps, the keyframe buffers gathered every step), kept as the
oracle of the warped carry; it runs the module form.

``traj_conv_impl`` is the JAX package's ``VMG_TRAJCONV_KERNEL``, in eval
only (neither kernel has a backward): ``"module"`` (default) runs the
step's residual blocks as cuDNN convolutions; ``"kernel"`` runs each block
as one ``fused_conv_chain`` pass; ``"barrier"`` / ``"barrier_out"`` keep
the module blocks and pass the blocks' input / output through
``layout_pin``.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vmg_tpu_torch.models.blocks import PackedOperands, conv_cl
from vmg_tpu_torch.ops.conv_chain import fused_conv_chain, layout_pin, pack_conv_taps
from vmg_tpu_torch.ops.decay import ltam_decay_np
from vmg_tpu_torch.ops.ltam_attention import ltam_attention_2x2
from vmg_tpu_torch.ops.resize import adaptive_avg_pool2d
from vmg_tpu_torch.ops.warp import flow_warp, grid_sample
from vmg_tpu_torch.parallel.exchange import current_seq


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize over the last dim: v / max(||v||, eps)."""
    n2 = (v * v).sum(dim=-1, keepdim=True)
    return v * torch.rsqrt(n2.clamp_min(eps * eps))


TRAJ_CONV_IMPLS = ("module", "kernel", "barrier", "barrier_out")


class ResidualBlockNoBN(PackedOperands):
    """conv-ReLU-conv with scaled residual; ``forward(x, kernel=True)``
    (mid_channels <= 128) runs it as one ``fused_conv_chain`` pass on taps
    packed once per parameter state."""

    def __init__(self, mid_channels, res_scale=1.0, device=None):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = nn.Conv2d(mid_channels, mid_channels, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(mid_channels, mid_channels, 3, padding=1, device=device)

    def _sources(self):
        return self.conv1.weight, self.conv1.bias, self.conv2.weight, self.conv2.bias

    def _pack(self):
        return (*pack_conv_taps(self.conv1.weight, self.conv1.bias),
                *pack_conv_taps(self.conv2.weight, self.conv2.bias))

    def forward(self, x, kernel: bool = False):  # (N, H, W, C)
        if kernel and self.conv1.out_channels <= 128:
            return fused_conv_chain(x.contiguous(), *self.operands(),
                                    res_scale=self.res_scale)
        out = conv_cl(self.conv2, F.relu(conv_cl(self.conv1, x)))
        return x + out * self.res_scale


class ResidualBlocksWithInputConv(nn.Module):
    """conv + lrelu(0.1) + N residual blocks (``kernel``: each block in its
    kernel form)."""

    def __init__(self, in_channels, out_channels, num_blocks, res_scale=1.0,
                 device=None):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, device=device),
            nn.LeakyReLU(0.1),
            nn.Sequential(*(ResidualBlockNoBN(out_channels, res_scale, device)
                            for _ in range(num_blocks))))

    def forward(self, x, kernel: bool = False):  # (N, H, W, Cin)
        x = F.leaky_relu(conv_cl(self.main[0], x), 0.1)
        for block in self.main[2]:
            x = block(x, kernel)
        return x


def _field_context(feat, stride: int, ratio: float):
    """The en_field context of a keyframe (the reference's unfold -> fold to
    (ratio h, ratio w)): per stride-aligned patch the surrounding
    int(ratio * stride) patch (zero padded), adaptive-average-pooled back
    to (H, W).  feat: (N, H, W, C) with H % stride == W % stride == 0."""
    N, H, W, C = feat.shape
    k = int(ratio * stride)
    pad = (k - stride) // 2
    xp = F.pad(feat, (0, 0, pad, pad, pad, pad))
    # an index past the padded edge (odd k - stride) reads the edge, as the
    # JAX package's gather clamps it
    rows = (torch.arange(H // stride)[:, None] * stride + torch.arange(k)).reshape(-1)
    cols = (torch.arange(W // stride)[:, None] * stride + torch.arange(k)).reshape(-1)
    rows, cols = rows.clamp(max=xp.shape[1] - 1), cols.clamp(max=xp.shape[2] - 1)
    y = xp[:, rows.to(feat.device)][:, :, cols.to(feat.device)]
    return adaptive_avg_pool2d(y, H, W)


LTAM_MODES = ("wins", "max")


class LTAM(nn.Module):
    """Location-guided temporal attention over the warped keyframe buffers;
    a projection, then the anchor (propagated feature) added in float32.
    ``mode='wins'``: per head, softmax over K slots x the twins window's
    taps of (scaled with ``if_scale``) cosine logits plus RetNet decay x a
    learned relative position bias -- the CUDA kernel at 2x2 windows and
    even H, W (:meth:`kernel_ok`), else the windows module form.
    ``mode='max'``: per head the slot of the largest cosine similarity, its
    value scaled by that similarity; with ``en_field`` the same slot's two
    context features are fused with it (``fusion``, a 1x1 conv) before the
    scaling.  ``en_field`` with 'wins' is refused, as the JAX package
    refuses the reference's undefined ``mid_r``."""

    def __init__(self, embed_dim, head=4, mode="wins", if_scale=True, twins=(2, 2),
                 en_field=False, device=None):
        super().__init__()
        if mode not in LTAM_MODES:
            raise ValueError(f"unknown LTAM mode {mode!r}")
        if en_field and mode == "wins":
            raise NotImplementedError(
                "en_field with mode='wins' is a latent crash in the reference "
                "(trajectory.py:782 uses undefined mid_r); use mode='max'")
        self.head, self.mode, self.if_scale = head, mode, if_scale
        self.twins, self.en_field = tuple(twins), en_field
        if mode == "wins":
            q_n = self.twins[0] * self.twins[1]
            self.relative_pos_encoding = nn.Parameter(
                torch.zeros(head, q_n, q_n, device=device))
        self.proj = nn.Linear(embed_dim, embed_dim, device=device)
        if en_field:
            self.fusion = nn.Conv2d(3 * embed_dim, embed_dim, 1, device=device)
        self._slot_decay = {}  # (K, device) -> (head, K) float32 decay

    def _decay(self, K: int, device) -> torch.Tensor:
        key = (K, device)
        if key not in self._slot_decay:  # one host copy per K, not per step
            self._slot_decay[key] = torch.tensor(ltam_decay_np(self.head, K), device=device)
        return self._slot_decay[key]

    def kernel_ok(self, H: int, W: int) -> bool:
        """Where the JAX package runs its TPU kernel (``trajectory.py:637-644``)."""
        return (self.mode == "wins" and self.twins == (2, 2) and not self.en_field
                and H % 2 == 0 and W % 2 == 0)

    def forward(self, curr, anchor, kv, kernel: bool = True):
        """curr/anchor: (n, h, w, c); kv: (n, h, w, K*S*c), per slot [value |
        key] (S = 2) or [value | key | 1.5x field | 2x field] (S = 4,
        en_field), the keys normalized.  ``kernel``: the CUDA kernel where
        :meth:`kernel_ok` (the warped carry), else the module form."""
        n, h, w, c = curr.shape
        S = 4 if self.en_field else 2
        K = kv.shape[-1] // (S * c)
        d = c // self.head
        scale = d ** -0.5 if (self.if_scale and self.mode == "wins") else 1.0
        if kernel and self.kernel_ok(h, w):
            pef = torch.exp(torch.einsum("ek,ept->ktpe", self._decay(K, curr.device),
                                         self.relative_pos_encoding.float()))
            q = (_normalize(curr.float()) * scale).contiguous()
            out = ltam_attention_2x2(q, kv.contiguous(), pef.contiguous(), K=K,
                                     heads=self.head)
        elif self.mode == "wins":
            out = self._windows(curr, kv, K, scale)
        else:
            out = self._max(curr, kv, K)
        out = F.linear(out, self.proj.weight.float(), self.proj.bias.float())
        return (out + anchor.float()).to(curr.dtype)

    def _windows(self, curr, kv, K: int, scale: float):
        """The JAX package's windows form: per (window, head) one softmax
        over K x wh x ww keys, in the features' dtype up to the float32
        logits."""
        n, h, w, c = curr.shape
        head, d = self.head, c // self.head
        wh, ww = self.twins
        nh, nw, q_n = h // wh, w // ww, wh * ww
        kv6 = kv.reshape(n, h, w, K, 2, c)

        def keys(t):  # (n, h, w, K, c) -> (n, nWin, head, K*wh*ww, d), slot-major
            t = t.reshape(n, nh, wh, nw, ww, K, head, d).permute(0, 1, 3, 6, 5, 2, 4, 7)
            return t.reshape(n, nh * nw, head, K * q_n, d)

        q = _normalize(curr.float()).to(curr.dtype)
        q = q.reshape(n, nh, wh, nw, ww, head, d).permute(0, 1, 3, 5, 2, 4, 6)
        q = q.reshape(n, nh * nw, head, q_n, d)
        logits = (q * scale).float() @ keys(kv6[..., 1, :]).float().transpose(-1, -2)
        pe = self._decay(K, curr.device)[:, None, :, None] * \
            self.relative_pos_encoding.float()[:, :, None, :]
        attn = (logits + pe.reshape(head, q_n, K * q_n)).softmax(dim=-1)
        out = attn @ keys(kv6[..., 0, :]).float()
        out = out.reshape(n, nh, nw, head, wh, ww, d).permute(0, 1, 4, 2, 5, 3, 6)
        return out.reshape(n, h, w, c)

    def _max(self, curr, kv, K: int):
        """Per head: the slot of the largest cosine similarity, its value
        (and with en_field its two context features, fused) times that
        similarity."""
        n, h, w, c = curr.shape
        head, d = self.head, c // self.head
        S = 4 if self.en_field else 2
        kv6 = kv.reshape(n, h * w, K, S, head, d)
        qf = _normalize(curr.float()).reshape(n, h * w, head, d)
        sim = torch.einsum("bphd,bpkhd->bpkh", qf, kv6[:, :, :, 1].float())
        corr_soft, corr_idx = sim.max(dim=2)  # (n, hw, head)
        idx = corr_idx[:, :, None, None, :, None].expand(n, h * w, 1, S, head, d)
        g = torch.gather(kv6, 2, idx)[:, :, 0].float()  # (n, hw, S, head, d)
        if self.en_field:
            parts = torch.cat([g[:, :, 0], g[:, :, 2], g[:, :, 3]], dim=2).reshape(n, h * w, 3 * c)
            fw = self.fusion.weight[:, :, 0, 0].float()
            fused = F.linear(parts, fw, self.fusion.bias.float()).reshape(n, h * w, head, d)
            out = fused * corr_soft[..., None]
        else:
            out = g[:, :, 0] * corr_soft[..., None]
        return out.reshape(n, h, w, c)


CARRY_IMPLS = ("warped", "loc")


class TrajectoryMultiHead(nn.Module):
    """Bidirectional trajectory propagation over (B, T, H, W, C) with
    (B, T-1, H, W, 2) forward/backward flows.  ``ltam`` off: the step warps
    the propagated feature and attends to nothing; ``en_field``: each slot
    also carries the keyframe output's 1.5x and 2x context features
    (``field_stride``), for LTAM's 'max' mode."""

    def __init__(self, embed_dim, num_blocks=10, keyframe_stride=3, head=4,
                 r_scaling=1.0, traj_win=None, remat=False, traj_conv_impl="module",
                 mode="wins", head_scale=True, twins=(2, 2), ltam=True, en_field=False,
                 field_stride=4, carry_impl="warped", device=None):
        super().__init__()
        if traj_conv_impl not in TRAJ_CONV_IMPLS:
            raise ValueError(f"traj_conv_impl must be one of {TRAJ_CONV_IMPLS}, "
                             f"got {traj_conv_impl!r}")
        if carry_impl not in CARRY_IMPLS:
            raise ValueError(f"carry_impl must be one of {CARRY_IMPLS}, got {carry_impl!r}")
        self.traj_conv_impl = traj_conv_impl
        self.keyframe_stride = keyframe_stride
        self.traj_win = traj_win
        self.remat = remat
        self.ltam, self.en_field, self.field_stride = ltam, en_field, field_stride
        self.carry_impl = carry_impl
        self.resblocks = ResidualBlocksWithInputConv(
            2 * embed_dim, embed_dim, num_blocks, r_scaling, device)
        if ltam:
            self.LTAM = LTAM(embed_dim, head, mode, head_scale, twins, en_field, device)
        self.fusion = nn.Conv2d(3 * embed_dim, embed_dim, 1, device=device)

    def _step(self, lr, feat_prop, warped, flow):
        """One step after the first: warp the propagated feature and the
        history along ``flow``, attend, refine.  The first step (``flow``
        None) only refines.  ``warped``: the warped carry's buffers, or
        under the 'loc' carry the slots' location maps (n, h, w, K*2)."""
        if flow is not None:
            feat_prop = flow_warp(feat_prop, flow, "bilinear", "border")
            if self.ltam:
                warped = flow_warp(warped, flow, "nearest", "border")
                if self.carry_impl == "loc":
                    kv = self._gather(warped)
                    feat_prop = self.LTAM(lr, feat_prop, kv, kernel=False)
                else:
                    feat_prop = self.LTAM(lr, feat_prop, warped)
        impl = "module" if self.training else self.traj_conv_impl
        rb_in = torch.cat([lr, feat_prop], dim=-1)
        if impl == "barrier":
            rb_in = layout_pin(rb_in)
        feat_prop = self.resblocks(rb_in, kernel=impl == "kernel")
        if impl == "barrier_out":
            feat_prop = layout_pin(feat_prop)
        return feat_prop.to(lr.dtype), warped

    def _gather(self, loc):
        """The 'loc' carry's LTAM input: each slot's buffers gathered at its
        locations (nearest, zero padding) -> the warped carry's layout."""
        n, h, w = loc.shape[:3]
        K = loc.shape[-1] // 2
        loc = loc.reshape(n, h, w, K, 2).permute(0, 3, 1, 2, 4).reshape(n * K, h, w, 2)
        grid = torch.stack([2.0 * loc[..., 0] / max(w - 1, 1) - 1.0,
                            2.0 * loc[..., 1] / max(h - 1, 1) - 1.0], dim=-1)
        bufs = self._slots.permute(0, 3, 1, 2, 4).reshape(n * K, h, w, -1)
        out = grid_sample(bufs, grid, mode="nearest", padding_mode="zeros")
        return out.reshape(n, K, h, w, -1).permute(0, 2, 3, 1, 4).reshape(n, h, w, -1)

    def _direction(self, feats, flows, carry=None, s0: int = 0):
        """feats: T tensors (N, H, W, C); flows: T tensors (N, H, W, 2) or
        None (step s >= 1 warps with flows[s]).  ``carry``: the state to
        start from (:meth:`_direction`'s second result; None: the window's
        start), ``s0`` its step count within the window.  Returns the
        outputs and the state after the last step: [feat_prop, warped] and,
        under the 'loc' carry, the slots' buffers (N, H, W, K, S*C)."""
        N, H, W, C = feats[0].shape
        loc_mode = self.carry_impl == "loc"
        dev = feats[0].device
        if carry is None:
            feat_prop = torch.zeros_like(feats[0])
            warped = torch.zeros((N, H, W, 0), device=dev,
                                 dtype=torch.float32 if loc_mode else feats[0].dtype)
        else:
            feat_prop, warped = carry[0], carry[1]
        if loc_mode:  # the slots' buffers (self._slots, for _gather) and locations
            gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                                    torch.arange(W, dtype=torch.float32, device=dev),
                                    indexing="ij")
            grid0 = torch.stack([gx, gy], dim=-1).expand(N, H, W, 2)
            slots = [] if carry is None or carry[2].shape[3] == 0 else list(carry[2].unbind(3))
            if slots:
                self._slots = torch.stack(slots, dim=3)
        outs = []
        remat = self.remat and self.training and torch.is_grad_enabled()
        for s, (lr, flow) in enumerate(zip(feats, flows), start=s0):
            if remat:  # nothing random runs inside a step
                feat_prop, warped = checkpoint(self._step, lr, feat_prop, warped, flow,
                                               use_reentrant=False,
                                               preserve_rng_state=False)
            else:
                feat_prop, warped = self._step(lr, feat_prop, warped, flow)
            outs.append(feat_prop)
            if self.ltam and s % self.keyframe_stride == 0:
                entry = [feat_prop, _normalize(lr.float()).to(lr.dtype)]
                if self.en_field:
                    entry += [_field_context(feat_prop, self.field_stride, 1.5),
                              _field_context(feat_prop, self.field_stride, 2.0)]
                if loc_mode:  # a new slot starts at the identity locations
                    warped = torch.cat([warped, grid0], dim=-1)
                    slots.append(torch.cat(entry, dim=-1))
                    self._slots = torch.stack(slots, dim=3)
                else:
                    warped = torch.cat([warped, *entry], dim=-1)
        state = [feat_prop, warped]
        if loc_mode:
            state.append(self._slots if slots else
                         feat_prop.new_zeros((N, H, W, 0, (4 if self.en_field else 2) * C)))
        return outs, state

    def forward(self, x, flows_forward, flows_backward):
        """Both directions of the recurrence over ``x`` (B, T, H, W, C),
        fused with it.  In one process the flows are the clip's T - 1
        (frame i's forward flow ``flows_forward[:, i - 1]`` from i - 1, its
        backward flow ``flows_backward[:, i]`` from i + 1).  T sharded
        (``current_seq``), ``x`` holds this process's frames ``seq.a ..
        seq.b - 1`` and the flows are their one-a-frame views
        (``SeqShard.local_flows``: frame i's forward flow at i, backward at
        i).  The clip's ``traj_win`` windows are cut into this process's
        segments: whole windows run batched along B, and nothing crosses; a
        window that spans processes hands its carry over -- the forward
        direction's from the process before, the backward direction's from
        the one after -- sequentially in T, as the recurrence is.  A
        segment runs first the direction that waits for no carry, so two
        processes that share a window run both chains at once and swap
        their carries in one exchange; the receiver sizes each carry from
        its step count (:meth:`_carry_like`)."""
        seq = current_seq()
        B, Tl, H, W, C = x.shape
        a, T = (0, Tl) if seq is None else (seq.a, seq.T)
        off = -1 if seq is None else 0  # frame i's forward flow: flows_forward[:, i + off]
        tw = int(self.traj_win) if self.traj_win is not None and 0 < self.traj_win < T else T
        if T % tw:
            raise ValueError(f"traj_win={tw} must divide the clip length T={T}")
        segs, s = [], a
        while s < a + Tl:
            e = min((s // tw + 1) * tw, a + Tl)
            segs.append((s - a, e - a, s % tw))  # local start, end, step in the window
            s = e
        pieces = []  # (local start, backward outputs, forward outputs), (B, n, H, W, C) each
        whole = [i for i, j, k in segs if k == 0 and j - i == tw]
        if whole:  # whole windows (contiguous), batched along B
            i0, nw = whole[0], len(whole)
            xs = x[:, i0:i0 + nw * tw].reshape(B * nw, tw, H, W, C)

            def window_flows(f, d):
                """Each window's own tw - 1 flows (the flow crossing into the
                next window is dropped), the first at ``i0 + d``."""
                if nw == 1:
                    return f[:, i0 + d:i0 + d + tw - 1]
                idx = (torch.arange(nw)[:, None] * tw + torch.arange(tw - 1)[None, :]).reshape(-1)
                return f[:, idx + i0 + d].reshape(B * nw, tw - 1, *f.shape[2:])

            fs, bs = window_flows(flows_forward, 1 + off), window_flows(flows_backward, 0)
            frames = list(xs.unbind(1))
            # backward pass: frames tw-1 .. 0, bs[i] warps i+1 -> i
            bo = self._direction(frames[::-1], [None] + list(bs.unbind(1))[::-1])[0][::-1]
            # forward pass: frames 0 .. tw-1, fs[i-1] warps i-1 -> i
            fo = self._direction(frames, [None] + list(fs.unbind(1)))[0]
            pieces.append((i0, torch.stack(bo, 1).reshape(B, nw * tw, H, W, C),
                           torch.stack(fo, 1).reshape(B, nw * tw, H, W, C)))
        frames = None  # the frames of the segments that share a window with another process
        ff = lambda i: flows_forward[:, i + off]  # noqa: E731
        fb = lambda i: flows_backward[:, i]  # noqa: E731
        # a carry to hand over waits for this process's next receive and goes
        # out in the same exchange (one batch: see parallel.exchange.exchange)
        pending = {}

        def receive(src, steps):
            carry = self._carry_like(frames[0], steps)
            seq.exchange(pending, {src: carry}, "carry")
            pending.clear()
            return carry

        for i, j, k in segs:
            left, right = k > 0, k + (j - i) < tw  # the window goes on before / after
            if not (left or right):
                continue
            frames = frames or x.unbind(1)
            back, fwd = None, None
            # first the direction that waits for no carry, so two processes
            # that share a window hand their carries over in one exchange
            for direction in ("back", "fwd") if left and not right else ("fwd", "back"):
                if direction == "fwd":
                    carry = receive(seq.index - 1, k) if left else None
                    fwd, state = self._direction(
                        list(frames[i:j]), [ff(i) if left else None] +
                        [ff(t) for t in range(i + 1, j)], carry, k)
                    if right:
                        pending[seq.index + 1] = state
                else:
                    steps = tw - k - (j - i)  # backward steps already taken in the window
                    carry = receive(seq.index + 1, steps) if right else None
                    back, state = self._direction(
                        list(frames[i:j])[::-1], [fb(j - 1) if right else None] +
                        [fb(t) for t in range(j - 2, i - 1, -1)], carry, steps)
                    back = back[::-1]
                    if left:
                        pending[seq.index - 1] = state
            pieces.append((i, torch.stack(back, 1), torch.stack(fwd, 1)))
        if pending:
            seq.exchange(pending, {}, "carry")
        pieces.sort(key=lambda p: p[0])
        back, fwd = ((torch.cat([p[n] for p in pieces], dim=1) if len(pieces) > 1
                      else pieces[0][n]) for n in (1, 2))
        return self._fuse(x, back, fwd)

    def _fuse(self, x, back, fwd):
        B, T, H, W, C = x.shape
        fused = torch.cat([back, x, fwd], dim=-1)
        out = conv_cl(self.fusion, fused.reshape(B * T, H, W, 3 * C))
        return F.leaky_relu(out, 0.1).reshape(B, T, H, W, C)

    def _carry_like(self, frame, steps: int):
        """Empty tensors shaped as :meth:`_direction`'s state after ``steps``
        steps of a window from frames like ``frame`` (N, H, W, C): a slot
        is appended at every ``keyframe_stride``-th step."""
        N, H, W, C = frame.shape
        K = -(-steps // self.keyframe_stride) if self.ltam else 0
        S = 4 if self.en_field else 2
        if self.carry_impl == "loc":
            return [torch.empty_like(frame),
                    frame.new_empty((N, H, W, 2 * K), dtype=torch.float32),
                    frame.new_empty((N, H, W, K, S * C))]
        return [torch.empty_like(frame), frame.new_empty((N, H, W, K * S * C))]
