"""The VMG video super-resolution U-Net in PyTorch (``vmg_tpu/models/vmg.py``).

Channels-last ``(B, T, H, W, 3)`` RGB in [0, 1] in, ``(B, T, 4H, 4W, 3)``
float32 out.  Eval mode is the serving forward (the JAX package's
deterministic path, on the kernels); training mode is its
``deterministic=False`` path: module forms of the TABs, stochastic depth
on the linear schedule a model built with ``is_train`` carries, and, with
``cfg.remat``, each TAB and trajectory step recomputed in the backward
pass.  Stage tails: trajectory recurrence where ``temporal_type`` is
False, identity where it is None.  Module attribute names follow the
reference state-dict keys (see ``vmg_tpu_torch.weights``).  Settings
outside the ported slice raise (see :func:`check_supported`).

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
from vmg_tpu_torch.models.trajectory import TrajectoryMultiHead
from vmg_tpu_torch.ops.ltam_attention import MAX_HEAD_WIDTH
from vmg_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from vmg_tpu_torch.ops.resize import (
    adaptive_avg_pool2d,
    adaptive_max_pool2d,
    upsample_trilinear_frames,
)


# the three opt-in forms of the JAX package, all on (see the module docstring)
KERNEL_FORMS = dict(rcab_impl="kernel", traj_conv_impl="kernel", norm_impl="kernel")

# settings the ported slice implements; other values are not ported yet
# (DCN and 3D window-attention tails, the FFN zoo and mixer variants, ...)
_SLICE = dict(back_RBs=0, if_concat=False, temporal_empty=True, ret_decay=True,
              non_linear=True, gating=True, if_symm=True, relu_scale=True,
              relu_scale_norm=False, ffn_type="ffn_cnn", traj_mode="wins",
              twins=(2, 2), traj_scale=True, if_local_fuse=True,
              channel_mixer="rcab", qkv_bias=True, ltam=True, flow_smooth=True)


def check_supported(cfg: VMGNetworkConfig) -> None:
    bad = [f"{k}={getattr(cfg, k)!r}" for k, v in _SLICE.items()
           if getattr(cfg, k) != v]
    if cfg.spynet is None:
        bad.append("spynet=None")
    if any(t is True for t in cfg.temporal_type):
        bad.append(f"temporal_type={cfg.temporal_type}")
    if any(m != "mlps" for m in cfg.mixer_type):
        bad.append(f"mixer_type={cfg.mixer_type}")
    if cfg.symm_act not in ("tanh", "sigmoid", "relu"):
        bad.append(f"symm_act={cfg.symm_act!r}")
    if cfg.num_layers > 3 and not cfg.use_mdsc:
        bad.append("use_mdsc=False")
    n_enc = cfg.num_enc_layers
    for li, C in enumerate(cfg.embed_dim):
        # the trajectory stages' LTAM head width: the kernel takes any d up
        # to MAX_HEAD_WIDTH (refused here, before a forward starts); stage
        # li reads entry i of the per-encoder-stage lists (MlpEncoderStage)
        i = li if li < n_enc else -(li - n_enc) - 2
        heads = cfg.traj_heads[i] or 4
        if cfg.temporal_type[i] is False and (C % heads or C // heads > MAX_HEAD_WIDTH):
            bad.append(f"traj_heads={cfg.traj_heads} at C={C}")
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


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


class MlpEncoderStage(nn.Module):
    """One U-Net stage: TAB stack + local fuse + temporal tail.
    ``drop_path``: the stochastic-depth rate of each TAB."""

    def __init__(self, cfg: VMGNetworkConfig, layer_idx: int, *,
                 gelu_act="erf", drop_path=(), rcab_impl="module",
                 traj_conv_impl="module", norm_impl="module", device=None):
        super().__init__()
        self.cfg = cfg
        li = layer_idx
        n_enc = cfg.num_enc_layers

        def sp(lst):
            # encoder i -> lst[i], decoder j -> lst[-j-2]
            return lst[li] if li < n_enc else lst[-(li - n_enc) - 2]

        C = cfg.embed_dim[li]
        chunk_h = max(1, int(cfg.image_size[0] * sp(cfg.chunk_ratios)))
        chunk_w = max(1, int(cfg.image_size[1] * sp(cfg.chunk_ratios)))
        self.mlp_blocks = nn.ModuleList(
            TAB(C, chunk_h, chunk_w, cfg.mlp_ratio, cfg.n_groups,
                symm_act=cfg.symm_act, mixer_scaling=cfg.m_scaling,
                gelu_act=gelu_act,
                drop_path=drop_path[b] if b < len(drop_path) else 0.0,
                rcab_impl=rcab_impl, norm_impl=norm_impl, device=device)
            for b in range(cfg.depths[li]))
        self.local_cnn = nn.Conv2d(C, C, 3, padding=1, device=device)
        if sp(cfg.temporal_type) is False:
            self.traj_mixing = TrajectoryMultiHead(
                C, num_blocks=cfg.traj_res_n[li],
                keyframe_stride=sp(cfg.traj_keyframes_n) or 3,
                head=sp(cfg.traj_heads) or 4, r_scaling=cfg.r_scaling,
                traj_win=sp(cfg.traj_win), remat=cfg.remat,
                traj_conv_impl=traj_conv_impl, device=device)

    def forward(self, x, flow_forward, flow_backward, generator=None):
        shortcut = x
        remat = self.cfg.remat and self.training and torch.is_grad_enabled()
        for blk in self.mlp_blocks:
            keep = blk.drop_masks(x.shape[0], x.device, generator)
            if remat:  # masks drawn outside: the recompute reuses them
                x = checkpoint(blk, x, keep, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = blk(x, keep)
        x = shortcut + conv_frames(self.local_cnn, x)
        if hasattr(self, "traj_mixing"):
            r = self.cfg.smooth_region_range
            x = self.traj_mixing(x, _flow_smoothing(flow_forward, r),
                                 _flow_smoothing(flow_backward, r))
        return x


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
    """U-Net over frames with trajectory temporal mixing and a PixelShuffle
    x4 reconstruction head.  ``is_train`` gives the TABs their
    stochastic-depth rates (applied in training mode only).  The kernel
    form switches are described at the top of this module."""

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
        if cfg.num_layers > 3:
            self.sc_64_16 = nn.Sequential(
                nn.Conv2d(E[0], E[2], 1, device=device),
                nn.GroupNorm(1, E[2], eps=1e-5, device=device))
            self.sc_32_8 = nn.Sequential(
                nn.Conv2d(E[1], E[3], 1, device=device),
                nn.GroupNorm(1, E[3], eps=1e-5, device=device))
        self.local_cnn = nn.Conv2d(E[-1], E[-1], 3, padding=1, device=device)
        Cf = E[-1]
        self.upconv1 = nn.Conv2d(Cf, Cf * 4, 3, padding=1, device=device)
        self.upconv2 = nn.Conv2d(Cf, 64 * 4, 3, padding=1, device=device)
        self.HRconv = nn.Conv2d(64, 64, 3, padding=1, device=device)
        self.conv_last = nn.Conv2d(64, 3, 3, padding=1, device=device)

    @property
    def dtype(self) -> torch.dtype:
        return self.input_proj.proj[0].weight.dtype

    def forward(self, x, *, frames_mirror: bool = False, generator=None):
        """x: (B, T, H, W, 3) -> (B, T, 4H, 4W, 3) float32.
        ``frames_mirror``: the clip is a mirrored sequence (the dataset's
        ``use_mirrors``), so the backward flows are the forward flows
        reversed in time, and SPyNet runs once per level instead of twice.
        ``generator``: source of the stochastic-depth masks in training."""
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

        ff, fb = self._compute_flows(xp, frames_mirror)
        feat = self.input_proj(xp.to(self.dtype))
        stages = [functools.partial(m, generator=generator)
                  for m in (*self.encoder_layers, *self.decoder_layers)]
        if cfg.num_layers > 3:
            y = self._forward_multi(stages, feat, ff, fb)
        else:
            y = self._forward_few(stages, feat, ff, fb)
        y = feat + conv_frames(self.local_cnn, y)

        y = y[:, :, :H, :W]
        Bf, Tf, Hf, Wf, Cf = y.shape
        out = y.reshape(Bf * Tf, Hf, Wf, Cf)
        out = F.leaky_relu(pixel_shuffle(conv_cl(self.upconv1, out), 2), 0.1)
        out = F.leaky_relu(pixel_shuffle(conv_cl(self.upconv2, out), 2), 0.1)
        out = F.leaky_relu(conv_cl(self.HRconv, out), 0.1)
        out = conv_cl(self.conv_last, out)
        return out.reshape(Bf, Tf, 4 * Hf, 4 * Wf, 3).float() + upsample_x

    def _compute_flows(self, xp, frames_mirror: bool):
        """Per-stage flow pyramid: SPyNet rerun on every level."""
        B, T, Hp, Wp, C = xp.shape
        flows_f, flows_b = [], []
        for i in range(self.cfg.num_enc_layers):
            h, w = Hp // (2 ** i), Wp // (2 ** i)
            lv = adaptive_avg_pool2d(xp.reshape(B * T, Hp, Wp, C), h, w)
            lv = lv.reshape(B, T, h, w, C)
            src_fwd = lv[:, :-1].reshape(B * (T - 1), h, w, C)
            src_bwd = lv[:, 1:].reshape(B * (T - 1), h, w, C)
            fwd = self.spynet(src_bwd, src_fwd).reshape(B, T - 1, h, w, 2)
            flows_f.append(fwd)
            flows_b.append(fwd.flip(1) if frames_mirror else
                           self.spynet(src_fwd, src_bwd).reshape(B, T - 1, h, w, 2))
        return flows_f, flows_b

    def _mdsc(self, seq, x, div=4):
        B, T, H, W, C = x.shape
        p = adaptive_max_pool2d(x.reshape(B * T, H, W, C), H // div, W // div)
        p = seq[0](p.permute(0, 3, 1, 2))
        p = F.relu(seq[1](p)).permute(0, 2, 3, 1)
        return p.reshape(B, T, *p.shape[1:])

    def _forward_multi(self, stages, x, ff, fb):
        enc, dec = stages[:4], stages[4:]
        x1 = enc[0](x, ff[0], fb[0])
        x2 = enc[1](self.downsample[0](x1), ff[1], fb[1])
        x3 = enc[2](self.downsample[1](x2), ff[2], fb[2])
        x4 = enc[3](self.downsample[2](x3 + self._mdsc(self.sc_64_16, x1)), ff[3], fb[3])
        x4_ = self.upsample[0](x4 + self._mdsc(self.sc_32_8, x2))
        x5 = dec[0](x4_, ff[2], fb[2])
        x6 = dec[1](self.upsample[1](x5 + x3), ff[1], fb[1])
        x7 = dec[2](self.upsample[2](x6 + x2), ff[0], fb[0])
        return x7 + x1

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
    position table trunc_normal(0.02), biases zero, norms ones/zeros."""
    spy = set(model.spynet.modules())
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            if m in spy:
                # flax lecun_normal: truncated normal, variance 1/fan_in
                _trunc_normal_(m.weight, 1.0 / math.sqrt(fan_in) / 0.87962566103423978,
                               generator)
            else:
                bound = 1.0 / math.sqrt(fan_in)
                nn.init.uniform_(m.weight, -bound, bound, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Linear):
            _trunc_normal_(m.weight, 0.02, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif hasattr(m, "relative_pos_encoding"):
            _trunc_normal_(m.relative_pos_encoding, 0.02, generator)


def cast_for_compute(model: VMG, dtype: torch.dtype) -> VMG:
    """Precision policy: every float parameter in ``dtype`` except the
    SPyNet subtree, which stays float32."""
    model.to(dtype)
    model.spynet.float()
    return model


def create_model(cfg: VMGNetworkConfig, *, is_train: bool = False,
                 dtype=torch.float32, device="cuda", gelu: str = "erf",
                 fast_flow: bool = False,
                 generator: torch.Generator | None = None,
                 rcab_impl: str = "module", traj_conv_impl: str = "module",
                 norm_impl: str = "module") -> VMG:
    """Build the model on ``device`` (the card unless the caller passes
    "cpu"; without CUDA the default raises) in ``dtype`` (SPyNet stays
    float32), in training mode with its stochastic-depth schedule when
    ``is_train``, else in eval mode.  ``generator`` seeds a JAX-like random
    init, drawn on the generator's device (a CPU generator gives the same
    weights whatever ``device`` is); without one the parameters keep
    torch's default init, to be overwritten by a state dict.  ``gelu``:
    'erf' (exact) or 'tanh' (serving fast-math); ``fast_flow``: bf16
    SPyNet convs; ``rcab_impl``, ``traj_conv_impl``, ``norm_impl``: the
    kernel form switches (see the module's docstring)."""
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
