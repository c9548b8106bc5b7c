"""The VMG video super-resolution U-Net in PyTorch (``vmg_tpu/models/vmg.py``).

Channels-last ``(B, T, H, W, 3)`` RGB in [0, 1] in, ``(B, T, 4H, 4W, 3)``
float32 out.  Eval mode is the serving forward (the JAX package's
deterministic path, on the kernels); training mode is its
``deterministic=False`` path: module forms of the TABs, stochastic depth
on the linear schedule a model built with ``is_train`` carries, and, with
``cfg.remat``, each TAB and trajectory step recomputed in the backward
pass.  Stage tails by ``temporal_type``: False, the trajectory recurrence;
True, flow-guided deformable alignment (:class:`DCNv2PackFlowGuided`);
None, 3D shifted-window attention (``models/swin3d``), or the identity
with ``temporal_empty``.  Every ``VMGNetworkConfig`` the JAX package's
model builds is built here; :func:`check_supported` refuses what it
cannot run.  Module attribute names follow the reference state-dict keys
(see ``vmg_tpu_torch.weights``).

Three switches select the JAX package's opt-in kernel forms
(:data:`KERNEL_FORMS` turns all three on); the defaults are its defaults,
the module forms:

* ``rcab_impl``: ``"module"`` | ``"kernel"`` -- the RCAB channel branch
  of the 'full' mixers (stages 0/6) as one conv-chain kernel pass, eval
  only (``VMG_RCAB_KERNEL=1``);
* ``traj_conv_impl``: ``"module"`` | ``"kernel"`` | ``"barrier"`` |
  ``"barrier_out"`` -- the trajectory step's residual blocks, eval only
  (``VMG_TRAJCONV_KERNEL``);
* ``norm_impl``: ``"module"`` | ``"kernel"`` -- every bf16 LayerNorm (the
  TABs' and the resamplers') through the fused norm, eval and training
  (``set_norm_impl('pallas')``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vmg_tpu_torch.configs import VMGNetworkConfig
from vmg_tpu_torch.models.blocks import TAB, conv_cl, conv_frames
from vmg_tpu_torch.models.norms import TorchLayerNorm
from vmg_tpu_torch.models.spynet import SPyNet
from vmg_tpu_torch.models.swin3d import DecoderLayer
from vmg_tpu_torch.models.trajectory import (ResidualBlockNoBN, ResidualBlocksWithInputConv,
                                             TrajectoryMultiHead)
from vmg_tpu_torch.ops.deform import modulated_deform_conv2d
from vmg_tpu_torch.ops.ltam_attention import MAX_HEAD_WIDTH
from vmg_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from vmg_tpu_torch.ops.warp import flow_warp
from vmg_tpu_torch.ops.resize import (
    adaptive_avg_pool2d,
    adaptive_max_pool2d,
    upsample_trilinear_frames,
)


# the three opt-in forms of the JAX package, all on (see the module docstring)
KERNEL_FORMS = dict(rcab_impl="kernel", traj_conv_impl="kernel", norm_impl="kernel")

def _stage_list(cfg: VMGNetworkConfig, li: int, lst):
    """Entry of a per-encoder-stage list for stage ``li``: encoder i ->
    lst[i], decoder j -> lst[-j-2] (the reference's indexing)."""
    n_enc = cfg.num_enc_layers
    return lst[li] if li < n_enc else lst[-(li - n_enc) - 2]


def check_supported(cfg: VMGNetworkConfig) -> None:
    """Refuse, before a forward starts, what the JAX package's model cannot
    run either: a stage tail that needs flows without a flow network
    (``spynet=None``), and an LTAM head width the kernel does not take on
    a stage where the kernel runs."""
    bad = []
    if cfg.spynet is None and any(t is not None for t in cfg.temporal_type):
        bad.append(f"spynet=None with temporal_type={cfg.temporal_type} (the trajectory "
                   "and DCN tails need flows)")
    kernel = cfg.traj_mode == "wins" and tuple(cfg.twins) == (2, 2) and cfg.ltam
    for li, C in enumerate(cfg.embed_dim):
        heads = _stage_list(cfg, li, cfg.traj_heads) or 4
        if kernel and _stage_list(cfg, li, cfg.temporal_type) is False and \
                (C % heads or C // heads > MAX_HEAD_WIDTH):
            bad.append(f"traj_heads={cfg.traj_heads} at C={C}")
    if bad:
        raise NotImplementedError(f"not supported: {', '.join(bad)}")


class InputProj(nn.Module):
    """Per-frame 3x3 conv + LeakyReLU(0.01)."""

    def __init__(self, in_chans, embed_dim, device=None):
        super().__init__()
        self.proj = nn.Sequential(
            nn.Conv2d(in_chans, embed_dim, 3, padding=1, device=device),
            nn.LeakyReLU(0.01))

    def forward(self, x):
        return F.leaky_relu(conv_frames(self.proj[0], x), 0.01)


class UpdownSampling(nn.Module):
    """Space-to-depth / depth-to-space + LayerNorm + Linear resampler
    (the 'down' and 'up' modes of the JAX package's UpdownkeepSampling).
    Channel order inside the 2x2 neighbourhood is (neiw, neih, c).  The
    projection runs in float32 whatever the model dtype (the JAX package
    pins it after a bf16 NaN on its TPU; kept for parity)."""

    def __init__(self, dim_in, dim_out, mode, *, norm_impl="module", device=None):
        super().__init__()
        self.mode = mode
        norm_dim = {"down": 4 * dim_in, "up": dim_in // 4}[mode]
        self.norm = TorchLayerNorm(norm_dim, impl=norm_impl, device=device)
        self.linear = nn.Linear(norm_dim, dim_out, device=device)

    def forward(self, x):
        B, T, H, W, C = x.shape
        if self.mode == "down":
            y = x.reshape(B, T, H // 2, 2, W // 2, 2, C)
            y = y.permute(0, 1, 2, 4, 5, 3, 6).reshape(B, T, H // 2, W // 2, 4 * C)
        else:
            y = x.reshape(B, T, H, W, 2, 2, C // 4)
            y = y.permute(0, 1, 2, 5, 3, 4, 6).reshape(B, T, 2 * H, 2 * W, C // 4)
        y = self.norm(y)
        y = F.linear(y.float(), self.linear.weight.float(), self.linear.bias.float())
        return y.to(x.dtype)


def _flow_smoothing(flow, region_range: int):
    """Region-average then nearest-upsample a (B, T, H, W, 2) flow field."""
    B, T, H, W, C2 = flow.shape
    r = region_range
    hf, wf = -(-H // r) * r, -(-W // r) * r
    f = flow.reshape(B * T, H, W, C2).permute(0, 3, 1, 2)
    f = F.pad(f, (0, wf - W, 0, hf - H), mode="reflect").permute(0, 2, 3, 1)
    f = adaptive_avg_pool2d(f, hf // r, wf // r)
    f = f.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)[:, :H, :W]
    return f.reshape(B, T, H, W, C2)


class DCNv2PackFlowGuided(nn.Module):
    """Flow-guided modulated deformable alignment (the reference's pa_frames
    = 2 path): offsets and masks from [warped, current, flow] through four
    3x3 convs (the last zero-initialised), the offsets a bounded residual
    (``max_residue_magnitude`` tanh) on the flow, then
    ``ops/deform.modulated_deform_conv2d`` with ``weight`` (C, C, 3, 3).
    The offset convs run in float32 whatever the model's dtype (the JAX
    package's concatenation with the float32 flow promotes them); the
    sampling and the product in the features' dtype."""

    def __init__(self, dim, deformable_groups, max_residue_magnitude=10.0, device=None):
        super().__init__()
        self.groups = deformable_groups
        self.max_residue_magnitude = max_residue_magnitude
        self.conv_offset = nn.Sequential(
            nn.Conv2d(2 * dim + 2, dim, 3, padding=1, device=device), nn.LeakyReLU(0.1),
            nn.Conv2d(dim, dim, 3, padding=1, device=device), nn.LeakyReLU(0.1),
            nn.Conv2d(dim, dim, 3, padding=1, device=device), nn.LeakyReLU(0.1),
            nn.Conv2d(dim, 27 * deformable_groups, 3, padding=1, device=device))
        self.weight = nn.Parameter(torch.zeros(dim, dim, 3, 3, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x, x_warped, x_current, flow):
        """x, x_warped, x_current: (N, H, W, C); flow: (N, H, W, 2) (x, y)."""
        N, H, W, C = x.shape
        G = self.groups
        y = torch.cat([x_warped.float(), x_current.float(), flow.float()], dim=-1)
        y = y.permute(0, 3, 1, 2)
        for i in range(0, 7, 2):
            conv = self.conv_offset[i]
            y = F.conv2d(y, conv.weight.float(), conv.bias.float(), padding=1)
            if i < 6:
                y = F.leaky_relu(y, 0.1)
        o1, o2, mask = y.permute(0, 2, 3, 1).chunk(3, dim=-1)
        # channel (g * 9 + k) * 2 + j of the offsets, j: 0 = dy, 1 = dx
        offset = self.max_residue_magnitude * torch.tanh(torch.cat([o1, o2], dim=-1))
        flow_yx = torch.stack([flow[..., 1], flow[..., 0]], dim=-1).float()
        offset = offset.reshape(N, H, W, G, 9, 2) + flow_yx[:, :, :, None, None, :]
        mask = torch.sigmoid(mask).reshape(N, H, W, G, 9)
        weight = self.weight.permute(2, 3, 1, 0).reshape(9, C, C)
        return modulated_deform_conv2d(x, offset, mask, weight, self.bias)


class MlpEncoderStage(nn.Module):
    """One U-Net stage: TAB stack, local fuse (``if_local_fuse``), temporal
    tail by ``temporal_type``: the trajectory recurrence (False), the
    flow-guided DCN alignment (True), the 3D window attention (None, unless
    ``temporal_empty``).  ``drop_path``: the stochastic-depth rate of each
    TAB."""

    def __init__(self, cfg: VMGNetworkConfig, layer_idx: int, *,
                 gelu_act="erf", drop_path=(), rcab_impl="module",
                 traj_conv_impl="module", norm_impl="module", device=None):
        super().__init__()
        self.cfg = cfg
        li = layer_idx

        def sp(lst):
            return _stage_list(cfg, li, lst)

        C = cfg.embed_dim[li]
        chunk_h = max(1, int(cfg.image_size[0] * sp(cfg.chunk_ratios)))
        chunk_w = max(1, int(cfg.image_size[1] * sp(cfg.chunk_ratios)))
        self.mlp_blocks = nn.ModuleList(
            TAB(C, chunk_h, chunk_w, cfg.mlp_ratio, cfg.n_groups,
                qkv_bias=cfg.qkv_bias, if_decay=cfg.ret_decay, non_linear=cfg.non_linear,
                gating=cfg.gating, symm=cfg.if_symm, symm_act=cfg.symm_act,
                relu_scale=cfg.relu_scale, relu_scale_norm=cfg.relu_scale_norm,
                ffn_type=cfg.ffn_type, mixer_type=sp(cfg.mixer_type), mixer_n=sp(cfg.mixer_n),
                channel_mixer=cfg.channel_mixer, mixer_scaling=cfg.m_scaling,
                gelu_act=gelu_act,
                drop_path=drop_path[b] if b < len(drop_path) else 0.0,
                rcab_impl=rcab_impl, norm_impl=norm_impl, device=device)
            for b in range(cfg.depths[li]))
        if cfg.if_local_fuse:
            self.local_cnn = nn.Conv2d(C, C, 3, padding=1, device=device)
        self.tail = sp(cfg.temporal_type)
        if self.tail is False:
            self.traj_mixing = TrajectoryMultiHead(
                C, num_blocks=cfg.traj_res_n[li],
                keyframe_stride=sp(cfg.traj_keyframes_n) or 3,
                head=sp(cfg.traj_heads) or 4, r_scaling=cfg.r_scaling,
                traj_win=sp(cfg.traj_win), remat=cfg.remat,
                traj_conv_impl=traj_conv_impl, mode=cfg.traj_mode,
                head_scale=cfg.traj_scale, twins=tuple(cfg.twins), ltam=cfg.ltam,
                device=device)
        elif self.tail is True:
            # deform_groups and max_res_scale by the same raw-list indexing,
            # not by the encoder stage a decoder stage mirrors (they differ
            # where a list has num_layers entries)
            self.pa_deform = DCNv2PackFlowGuided(
                C, sp(cfg.deform_groups), 10.0 / sp(cfg.max_res_scale), device=device)
            self.pa_fuse = ResidualBlocksWithInputConv(3 * C, C, cfg.traj_res_n[li],
                                                       device=device)
        elif not cfg.temporal_empty:
            self.traj_mixing = DecoderLayer(
                C, 2, cfg.num_heads[li], tuple(cfg.window_sizes[li]), cfg.mlp_ratio,
                cfg.qkv_bias, gelu_act=gelu_act, norm_impl=norm_impl, device=device)

    def forward(self, x, flow_forward, flow_backward, generator=None, drop_rows=None):
        shortcut = x
        remat = self.cfg.remat and self.training and torch.is_grad_enabled()
        for blk in self.mlp_blocks:
            keep = blk.drop_masks(x.shape[0], x.device, generator, rows=drop_rows)
            if remat:  # masks drawn outside: the recompute reuses them
                x = checkpoint(blk, x, keep, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = blk(x, keep)
        if self.cfg.if_local_fuse:
            x = shortcut + conv_frames(self.local_cnn, x)
        if self.tail is not None and self.cfg.flow_smooth:
            r = self.cfg.smooth_region_range
            flow_forward = _flow_smoothing(flow_forward, r)
            flow_backward = _flow_smoothing(flow_backward, r)
        if self.tail is False:
            return self.traj_mixing(x, flow_forward, flow_backward)
        if self.tail is True:
            return self._dcn_alignment(x, flow_forward, flow_backward)
        if hasattr(self, "traj_mixing"):
            return self.traj_mixing(x)
        return x

    def _dcn_alignment(self, x, flow_forward, flow_backward):
        """Both neighbours aligned to every frame by the DCN (frame i + 1 ->
        i backward, i - 1 -> i forward; zeros at the ends), fused with it by
        ``pa_fuse``."""
        B, T, H, W, C = x.shape
        zeros = x.new_zeros((B, 1, H, W, C))

        def align(src, cur, flow):
            src = src.reshape(B * (T - 1), H, W, C)
            flow = flow.reshape(B * (T - 1), H, W, 2)
            warped = flow_warp(src, flow, "bilinear", "zeros")
            out = self.pa_deform(src, warped, cur.reshape(src.shape), flow)
            return out.reshape(B, T - 1, H, W, C)

        x_backward = torch.cat([align(x[:, 1:], x[:, :-1], flow_backward), zeros], dim=1)
        x_forward = torch.cat([zeros, align(x[:, :-1], x[:, 1:], flow_forward)], dim=1)
        fused = torch.cat([x, x_backward, x_forward], dim=-1)
        return self.pa_fuse(fused.reshape(B * T, H, W, 3 * C)).reshape(B, T, H, W, C)


def drop_path_schedule(cfg: VMGNetworkConfig):
    """Per-stage TAB stochastic-depth rates (``vmg_tpu/models/vmg.py:394-407``):
    linear from 0 to ``drop_path_rate`` over the encoder's TABs, and the
    same over the decoder's, reversed."""
    n_enc = cfg.num_enc_layers
    enc, dec = cfg.depths[:n_enc], cfg.depths[n_enc:]
    enc_dpr = list(np.linspace(0, cfg.drop_path_rate, sum(enc)))
    dec_dpr = list(np.linspace(0, cfg.drop_path_rate, sum(dec)))[::-1]
    out = [tuple(float(r) for r in enc_dpr[sum(enc[:i]):sum(enc[:i + 1])])
           for i in range(n_enc)]
    out += [tuple(float(r) for r in dec_dpr[sum(dec[:j]):sum(dec[:j + 1])])
            for j in range(len(dec))]
    return out


class VMG(nn.Module):
    """U-Net over frames with per-stage temporal tails and a PixelShuffle
    x4 reconstruction head (after ``back_RBs`` residual blocks).  Skips add,
    or with ``if_concat`` concatenate and reduce by a 1x1 conv; with
    ``use_mdsc`` (more than 3 stages) the multi-scale shortcuts feed stages
    3 and 4.  ``spynet=None`` computes no flows.  ``is_train`` gives the
    TABs their stochastic-depth rates (applied in training mode only).  The
    kernel form switches are described at the top of this module."""

    def __init__(self, cfg: VMGNetworkConfig, *, gelu="erf", fast_flow=False,
                 is_train=False, rcab_impl="module", traj_conv_impl="module",
                 norm_impl="module", device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        E = cfg.embed_dim
        n_enc = cfg.num_enc_layers
        dpr = drop_path_schedule(cfg) if is_train else [()] * cfg.num_layers
        forms = dict(rcab_impl=rcab_impl, traj_conv_impl=traj_conv_impl,
                     norm_impl=norm_impl)
        if cfg.spynet is not None:
            self.spynet = SPyNet(fast_flow=fast_flow, device=device)
        self.input_proj = InputProj(cfg.in_chans, E[0], device)
        self.encoder_layers = nn.ModuleList(
            MlpEncoderStage(cfg, i, gelu_act=gelu, drop_path=dpr[i], **forms,
                            device=device)
            for i in range(n_enc))
        self.decoder_layers = nn.ModuleList(
            MlpEncoderStage(cfg, n_enc + j, gelu_act=gelu, drop_path=dpr[n_enc + j],
                            **forms, device=device)
            for j in range(cfg.num_dec_layers))
        self.downsample = nn.ModuleList(
            UpdownSampling(E[i], E[i + 1], "down", norm_impl=norm_impl, device=device)
            for i in range(n_enc - 1))
        self.upsample = nn.ModuleList(
            UpdownSampling(E[n_enc - 1 + i], E[n_enc + i], "up", norm_impl=norm_impl,
                           device=device)
            for i in range(cfg.num_dec_layers))
        if cfg.num_layers > 3 and cfg.use_mdsc:
            self.sc_64_16 = nn.Sequential(
                nn.Conv2d(E[0], E[2], 1, device=device),
                nn.GroupNorm(1, E[2], eps=1e-5, device=device))
            self.sc_32_8 = nn.Sequential(
                nn.Conv2d(E[1], E[3], 1, device=device),
                nn.GroupNorm(1, E[3], eps=1e-5, device=device))
        if cfg.num_layers > 3 and cfg.if_concat:
            # reduce<i>: [skip of encoder stage i, decoder stage 6 - i] -> C
            self.reduce0, self.reduce1, self.reduce2 = (
                nn.Conv2d(E[i] + E[6 - i], E[6 - i], 1, device=device) for i in range(3))
        if cfg.if_local_fuse:
            self.local_cnn = nn.Conv2d(E[-1], E[-1], 3, padding=1, device=device)
        Cf = E[-1]
        # the reference's residual trunk before the reconstruction (its
        # convs initialised at 0.1 x the default scale)
        self.recon_trunk = nn.ModuleList(
            ResidualBlockNoBN(Cf, device=device) for _ in range(cfg.back_RBs))
        self.upconv1 = nn.Conv2d(Cf, Cf * 4, 3, padding=1, device=device)
        self.upconv2 = nn.Conv2d(Cf, 64 * 4, 3, padding=1, device=device)
        self.HRconv = nn.Conv2d(64, 64, 3, padding=1, device=device)
        self.conv_last = nn.Conv2d(64, 3, 3, padding=1, device=device)

    @property
    def dtype(self) -> torch.dtype:
        return self.input_proj.proj[0].weight.dtype

    def forward(self, x, *, frames_mirror: bool = False, generator=None, drop_rows=None):
        """x: (B, T, H, W, 3) -> (B, T, 4H, 4W, 3) float32.
        ``frames_mirror``: the clip is a mirrored sequence (the dataset's
        ``use_mirrors``), so the backward flows are the forward flows
        reversed in time, and SPyNet runs once per level instead of twice.
        ``generator``: source of the stochastic-depth masks in training.
        ``drop_rows``: (rows, first): these B rows are rows first .. first +
        B - 1 of a batch of ``rows``, whose masks the generator draws (a
        data-parallel process's share of the global batch); None: the B
        rows are the batch."""
        cfg = self.cfg
        B, T, H, W, _ = x.shape
        if H < 64 or W < 64:
            raise ValueError("height and width must be at least 64")
        x = x.float()
        upsample_x = upsample_trilinear_frames(x, 4)
        scale = cfg.scale_factor
        Hp, Wp = -(-H // scale) * scale, -(-W // scale) * scale
        xp = F.pad(x.reshape(B * T, H, W, 3).permute(0, 3, 1, 2),
                   (0, Wp - W, 0, Hp - H), mode="replicate")
        xp = xp.permute(0, 2, 3, 1).reshape(B, T, Hp, Wp, 3)

        if cfg.spynet is not None:
            ff, fb = self._compute_flows(xp, frames_mirror)
        else:
            ff = fb = [None] * cfg.num_enc_layers
        feat = self.input_proj(xp.to(self.dtype))
        stages = [functools.partial(m, generator=generator, drop_rows=drop_rows)
                  for m in (*self.encoder_layers, *self.decoder_layers)]
        if cfg.num_layers > 3:
            y = self._forward_multi(stages, feat, ff, fb)
        else:
            y = self._forward_few(stages, feat, ff, fb)
        if cfg.if_local_fuse:
            y = feat + conv_frames(self.local_cnn, y)

        y = y[:, :, :H, :W]
        Bf, Tf, Hf, Wf, Cf = y.shape
        out = y.reshape(Bf * Tf, Hf, Wf, Cf)
        for block in self.recon_trunk:
            out = block(out)
        out = F.leaky_relu(pixel_shuffle(conv_cl(self.upconv1, out), 2), 0.1)
        out = F.leaky_relu(pixel_shuffle(conv_cl(self.upconv2, out), 2), 0.1)
        out = F.leaky_relu(conv_cl(self.HRconv, out), 0.1)
        out = conv_cl(self.conv_last, out)
        return out.reshape(Bf, Tf, 4 * Hf, 4 * Wf, 3).float() + upsample_x

    def _compute_flows(self, xp, frames_mirror: bool):
        """Per-stage flow pyramid: SPyNet on every level (``'per_level'``),
        or at level 0 only, whose flows are average-pooled down to level i
        and scaled by 0.5**i, the flow values halving with the resolution
        (``'shared'``)."""
        B, T, Hp, Wp, C = xp.shape
        shared = self.cfg.flow_levels == "shared"
        flows_f, flows_b = [], []
        for i in range(self.cfg.num_enc_layers):
            h, w = Hp // (2 ** i), Wp // (2 ** i)
            if shared and i > 0:
                flows_f.append(self._pool_flow(flows_f[0], h, w, 0.5 ** i))
                flows_b.append(self._pool_flow(flows_b[0], h, w, 0.5 ** i))
                continue
            lv = adaptive_avg_pool2d(xp.reshape(B * T, Hp, Wp, C), h, w)
            lv = lv.reshape(B, T, h, w, C)
            src_fwd = lv[:, :-1].reshape(B * (T - 1), h, w, C)
            src_bwd = lv[:, 1:].reshape(B * (T - 1), h, w, C)
            fwd = self.spynet(src_bwd, src_fwd).reshape(B, T - 1, h, w, 2)
            flows_f.append(fwd)
            flows_b.append(fwd.flip(1) if frames_mirror else
                           self.spynet(src_fwd, src_bwd).reshape(B, T - 1, h, w, 2))
        return flows_f, flows_b

    @staticmethod
    def _pool_flow(flow, h: int, w: int, scale: float):
        """(B, T-1, H, W, 2) -> (B, T-1, h, w, 2), pooled and scaled."""
        B, S = flow.shape[:2]
        p = adaptive_avg_pool2d(flow.reshape(B * S, *flow.shape[2:]), h, w) * scale
        return p.reshape(B, S, h, w, 2)

    def _mdsc(self, seq, x, div=4):
        B, T, H, W, C = x.shape
        p = adaptive_max_pool2d(x.reshape(B * T, H, W, C), H // div, W // div)
        p = seq[0](p.permute(0, 3, 1, 2))
        p = F.relu(seq[1](p)).permute(0, 2, 3, 1)
        return p.reshape(B, T, *p.shape[1:])

    def _merge(self, skip, dec, idx: int):
        if not self.cfg.if_concat:
            return dec + skip
        reduce = getattr(self, f"reduce{idx}")
        return conv_frames(reduce, torch.cat([skip, dec], dim=-1))

    def _forward_multi(self, stages, x, ff, fb):
        enc, dec = stages[:4], stages[4:]
        mdsc = self.cfg.use_mdsc
        x1 = enc[0](x, ff[0], fb[0])
        x2 = enc[1](self.downsample[0](x1), ff[1], fb[1])
        x3 = enc[2](self.downsample[1](x2), ff[2], fb[2])
        x4 = enc[3](self.downsample[2](x3 + self._mdsc(self.sc_64_16, x1) if mdsc else x3),
                    ff[3], fb[3])
        x4_ = self.upsample[0](x4 + self._mdsc(self.sc_32_8, x2) if mdsc else x4)
        x5 = dec[0](x4_, ff[2], fb[2])
        x6 = dec[1](self.upsample[1](self._merge(x3, x5, 2)), ff[1], fb[1])
        x7 = dec[2](self.upsample[2](self._merge(x2, x6, 1)), ff[0], fb[0])
        return self._merge(x1, x7, 0)

    def _forward_few(self, stages, x, ff, fb):
        x1 = stages[0](x, ff[0], fb[0])
        x2 = stages[1](self.downsample[0](x1), ff[1], fb[1])
        x3 = stages[2](self.upsample[0](x2), ff[0], fb[0])
        return x3 + x1


def _trunc_normal_(t, std, generator):
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def init_weights(model: VMG, generator: torch.Generator) -> None:
    """Initialise like the JAX package: convs U(+-1/sqrt(fan_in)) (SPyNet's
    convs lecun-normal, flax's default), linears and the LTAM relative
    position table trunc_normal(0.02), biases zero, norms ones/zeros; the
    window attention's bias table trunc_normal(0.02), the DCN's weight as a
    conv's and its offset head's last conv zero, the reconstruction
    trunk's convs at 0.1 x the default scale."""
    spy = set(model.spynet.modules()) if hasattr(model, "spynet") else set()
    trunk = {c for b in model.recon_trunk for c in (b.conv1, b.conv2)}
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            if m in spy:
                # flax lecun_normal: truncated normal, variance 1/fan_in
                _trunc_normal_(m.weight, 1.0 / math.sqrt(fan_in) / 0.87962566103423978,
                               generator)
            else:
                bound = (0.1 if m in trunk else 1.0) / math.sqrt(fan_in)
                nn.init.uniform_(m.weight, -bound, bound, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Linear):
            _trunc_normal_(m.weight, 0.02, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif hasattr(m, "relative_pos_encoding"):
            _trunc_normal_(m.relative_pos_encoding, 0.02, generator)
        elif hasattr(m, "relative_position_bias_table"):
            _trunc_normal_(m.relative_position_bias_table, 0.02, generator)
        elif isinstance(m, DCNv2PackFlowGuided):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            nn.init.uniform_(m.weight, -bound, bound, generator=generator)
            nn.init.zeros_(m.bias)
    for m in model.modules():
        if isinstance(m, DCNv2PackFlowGuided):
            nn.init.zeros_(m.conv_offset[6].weight)
            nn.init.zeros_(m.conv_offset[6].bias)


def cast_for_compute(model: VMG, dtype: torch.dtype) -> VMG:
    """Precision policy: every float parameter in ``dtype`` except the
    SPyNet subtree, which stays float32."""
    model.to(dtype)
    if hasattr(model, "spynet"):
        model.spynet.float()
    return model


def create_model(cfg: VMGNetworkConfig, *, is_train: bool = False,
                 dtype=torch.float32, device="cuda", gelu: str = "erf",
                 fast_flow: bool = False,
                 generator: torch.Generator | None = None,
                 rcab_impl: str = "module", traj_conv_impl: str = "module",
                 norm_impl: str = "module", flow_levels: str | None = None) -> VMG:
    """Build the model on ``device`` (the card unless the caller passes
    "cpu"; without CUDA the default raises) in ``dtype`` (SPyNet stays
    float32), in training mode with its stochastic-depth schedule when
    ``is_train``, else in eval mode.  ``generator`` seeds a JAX-like random
    init, drawn on the generator's device (a CPU generator gives the same
    weights whatever ``device`` is); without one the parameters keep
    torch's default init, to be overwritten by a state dict.  ``gelu``:
    'erf' (exact) or 'tanh' (serving fast-math); ``fast_flow``: bf16
    SPyNet convs; ``rcab_impl``, ``traj_conv_impl``, ``norm_impl``: the
    kernel form switches (see the module's docstring); ``flow_levels``, if
    given, replaces ``cfg.flow_levels`` ('per_level' or 'shared')."""
    if flow_levels is not None:
        cfg = dataclasses.replace(cfg, flow_levels=flow_levels)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_model: no CUDA device visible; pass "
                           "device='cpu' to build the model on the CPU")
    init_device = generator.device if generator is not None else device
    model = VMG(cfg, gelu=gelu, fast_flow=fast_flow, is_train=is_train,
                rcab_impl=rcab_impl, traj_conv_impl=traj_conv_impl,
                norm_impl=norm_impl, device=init_device)
    if generator is not None:
        init_weights(model, generator)
    return cast_for_compute(model.to(device), dtype).train(is_train)
