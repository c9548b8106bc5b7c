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
from vmg_tpu_torch.ops.warp import flow_warp


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


class LTAM(nn.Module):
    """Location-guided temporal attention over the warped keyframe buffers,
    'wins' mode with 2x2 twins windows: per head, softmax over K slots x 4
    window taps of scaled cosine logits plus RetNet decay x learned
    relative position bias, then a projection and the anchor (propagated
    feature) added in float32."""

    def __init__(self, embed_dim, head=4, device=None):
        super().__init__()
        self.head = head
        self.relative_pos_encoding = nn.Parameter(
            torch.zeros(head, 4, 4, device=device))
        self.proj = nn.Linear(embed_dim, embed_dim, device=device)
        self._slot_decay = {}  # (K, device) -> (head, K) float32 decay

    def _decay(self, K: int, device) -> torch.Tensor:
        key = (K, device)
        if key not in self._slot_decay:  # one host copy per K, not per step
            self._slot_decay[key] = torch.tensor(ltam_decay_np(self.head, K), device=device)
        return self._slot_decay[key]

    def forward(self, curr, anchor, kv):
        """curr/anchor: (n, h, w, c); kv: (n, h, w, K*2*c) [value | key]."""
        n, h, w, c = curr.shape
        K = kv.shape[-1] // (2 * c)
        scale = (c // self.head) ** -0.5
        pef = torch.exp(torch.einsum("ek,ept->ktpe", self._decay(K, curr.device),
                                     self.relative_pos_encoding.float()))
        q = (_normalize(curr.float()) * scale).contiguous()
        out = ltam_attention_2x2(q, kv.contiguous(), pef.contiguous(), K=K,
                                 heads=self.head)
        out = F.linear(out, self.proj.weight.float(), self.proj.bias.float())
        return (out + anchor.float()).to(curr.dtype)


class TrajectoryMultiHead(nn.Module):
    """Bidirectional trajectory propagation over (B, T, H, W, C) with
    (B, T-1, H, W, 2) forward/backward flows."""

    def __init__(self, embed_dim, num_blocks=10, keyframe_stride=3, head=4,
                 r_scaling=1.0, traj_win=None, remat=False, traj_conv_impl="module",
                 device=None):
        super().__init__()
        if traj_conv_impl not in TRAJ_CONV_IMPLS:
            raise ValueError(f"traj_conv_impl must be one of {TRAJ_CONV_IMPLS}, "
                             f"got {traj_conv_impl!r}")
        self.traj_conv_impl = traj_conv_impl
        self.keyframe_stride = keyframe_stride
        self.traj_win = traj_win
        self.remat = remat
        self.resblocks = ResidualBlocksWithInputConv(
            2 * embed_dim, embed_dim, num_blocks, r_scaling, device)
        self.LTAM = LTAM(embed_dim, head, device)
        self.fusion = nn.Conv2d(3 * embed_dim, embed_dim, 1, device=device)

    def _step(self, lr, feat_prop, warped, flow):
        """One step: warp the history along ``flow``, attend, refine."""
        if warped.shape[-1]:
            feat_prop = flow_warp(feat_prop, flow, "bilinear", "border")
            warped = flow_warp(warped, flow, "nearest", "border")
            feat_prop = self.LTAM(lr, feat_prop, warped)
        impl = "module" if self.training else self.traj_conv_impl
        rb_in = torch.cat([lr, feat_prop], dim=-1)
        if impl == "barrier":
            rb_in = layout_pin(rb_in)
        feat_prop = self.resblocks(rb_in, kernel=impl == "kernel")
        if impl == "barrier_out":
            feat_prop = layout_pin(feat_prop)
        return feat_prop.to(lr.dtype), warped

    def _direction(self, feats, flows):
        """feats: T tensors (N, H, W, C); flows: T tensors (N, H, W, 2) or
        None (step s >= 1 warps with flows[s])."""
        N, H, W, C = feats[0].shape
        feat_prop = torch.zeros_like(feats[0])
        warped = feats[0].new_zeros((N, H, W, 0))
        outs = []
        remat = self.remat and self.training and torch.is_grad_enabled()
        for s, (lr, flow) in enumerate(zip(feats, flows)):
            if remat:  # nothing random runs inside a step
                feat_prop, warped = checkpoint(self._step, lr, feat_prop, warped, flow,
                                               use_reentrant=False,
                                               preserve_rng_state=False)
            else:
                feat_prop, warped = self._step(lr, feat_prop, warped, flow)
            outs.append(feat_prop)
            if s % self.keyframe_stride == 0:
                key = _normalize(lr.float()).to(lr.dtype)
                warped = torch.cat([warped, feat_prop, key], dim=-1)
        return outs

    def forward(self, x, flows_forward, flows_backward):
        B_in, T_in = x.shape[:2]
        if self.traj_win is not None and 0 < self.traj_win < T_in:
            tw = int(self.traj_win)
            if T_in % tw:
                raise ValueError(f"traj_win={tw} must divide the clip length T={T_in}")
            s = T_in // tw
            x = x.reshape(B_in * s, tw, *x.shape[2:])
            # window i keeps flows i .. i+tw-2; the flow crossing into the
            # next window is dropped
            widx = (torch.arange(s)[:, None] * tw + torch.arange(tw - 1)[None, :]).reshape(-1)
            flows_forward = flows_forward[:, widx].reshape(B_in * s, tw - 1, *flows_forward.shape[2:])
            flows_backward = flows_backward[:, widx].reshape(B_in * s, tw - 1, *flows_backward.shape[2:])
        B, T, H, W, C = x.shape

        frames = list(x.unbind(1))
        # backward pass: frames T-1 .. 0, flows_backward[i] warps i+1 -> i
        back = self._direction(frames[::-1],
                               [None] + list(flows_backward.unbind(1))[::-1])[::-1]
        # forward pass: frames 0 .. T-1, flows_forward[i-1] warps i-1 -> i
        fwd = self._direction(frames, [None] + list(flows_forward.unbind(1)))
        fused = torch.cat([torch.stack(back, 1), x, torch.stack(fwd, 1)], dim=-1)
        out = conv_cl(self.fusion, fused.reshape(B * T, H, W, 3 * C))
        out = F.leaky_relu(out, 0.1)
        return out.reshape(B_in, T_in, H, W, C)
