"""VMG block library: TAB with its MorphFC-decay mixer, RCAB and the
grouped-conv FFN (``vmg_tpu/models/blocks.py``).

Tensors are channels-last ``(B, T, H, W, C)``; convolutions run through
:func:`conv_cl`, which hands cuDNN a channels-last NCHW view, so no layout
copy is made around them.

Eval mode runs the serving (kernel) forms.  The MorphFC-decay mixer takes
the kernel form the JAX package selects for the shape: 'full' (both axis
branches and the reweight sums in the ``fused_morphfc_axes`` kernel)
where the chunks divide C and W and chunk * C <= 1024 -- stages 0 and 6
of the full preset -- else 'hybrid' (the axis FCs as plain matmuls, then
the reduce kernel); both end in the combine/projection/gate kernel.  The
FFN is the ``ops/group_conv`` kernel.  The block residual folds into the
mixer's combine pass.  The kernels' weight operands are packed once per
parameter state (:class:`PackedOperands`).

The JAX package's opt-in kernel forms are switches here: ``rcab_impl=
"kernel"`` runs the RCAB channel branch of the 'full' mixer as the
``ops/conv_chain`` kernel (both 3x3 convs and the channel-attention pool
sums in one pass; eval only, C <= 128); ``norm_impl="kernel"`` sends the
TAB's bf16 LayerNorms through ``ops/fused_norm`` (eval and training).
The defaults are the JAX package's: module forms.

Training mode runs the JAX package's module paths, which training pins
(``impl="xla"``): the mixer's decayed axis FCs, branch sums, reweight,
projection and gate as differentiable tensor code, the FFN as a grouped
convolution, and stochastic depth (:func:`drop_path`) on both residual
branches of a TAB, with keep masks drawn by the caller.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from vmg_tpu_torch.models.norms import TorchLayerNorm
from vmg_tpu_torch.ops.conv_chain import fused_conv_chain, pack_conv_taps
from vmg_tpu_torch.ops.decay import morphfc_decay_np
from vmg_tpu_torch.ops.group_conv import fused_group_ffn, gelu, pack_ffn_weights
from vmg_tpu_torch.ops.morphfc_fused import (
    axis_tokens,
    axis_untokens,
    fused_morphfc_axes,
    fused_morphfc_combine,
    fused_morphfc_reduce,
    pack_combine_weight,
    symm_gate,
)


def conv_cl(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply ``conv`` to channels-last ``(N, H, W, C)``."""
    y = conv(x.permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1)


def conv_frames(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Per-frame conv of ``(B, T, H, W, C)``."""
    B, T, H, W, C = x.shape
    y = conv_cl(conv, x.reshape(B * T, H, W, C))
    return y.reshape(B, T, *y.shape[1:])


class PackedOperands(nn.Module):
    """A module whose kernels take operands derived from its parameters
    (repacked, transposed, decay-folded).  ``_pack`` makes them from the
    tensors ``_sources`` lists; they are kept with those tensors' version
    counters and made again once any of them changed in place (an
    optimizer step, ``load_state_dict``), and dropped when the parameters
    are converted (``.to``, ``.cuda``, dtype casts).  So each parameter
    state is packed once, and a later forward pays one tuple compare."""

    _ops = None
    _ops_key = None

    def _sources(self):
        raise NotImplementedError

    def _pack(self):
        raise NotImplementedError

    def operands(self):
        key = tuple(t._version for t in self._sources())
        if self._ops is None or key != self._ops_key:
            with torch.no_grad():
                self._ops = self._pack()
            self._ops_key = key
        return self._ops

    def _apply(self, fn, *args, **kw):
        self._ops = None
        return super()._apply(fn, *args, **kw)


def drop_path(x: torch.Tensor, keep, rate: float) -> torch.Tensor:
    """Per-sample stochastic depth, timm semantics (scale by 1/keep):
    ``keep`` is a (B,) bool mask over the leading axis of ``x``, or None
    (no drop)."""
    if keep is None or rate == 0.0:
        return x
    mask = keep.reshape(-1, *(1,) * (x.ndim - 1))
    return torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2."""

    def __init__(self, dim, hidden, out, *, gelu_act="erf", device=None):
        super().__init__()
        self.gelu_act = gelu_act
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, out, device=device)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x), self.gelu_act))


class MlpCnn(PackedOperands):
    """Grouped 3x3 conv expand -> GELU -> linear project, as one kernel."""

    def __init__(self, dim, exp_r=4.0, n_groups=1, *, gelu_act="erf",
                 device=None):
        super().__init__()
        hidden = int(dim * exp_r)
        self.n_groups = n_groups
        self.gelu_act = gelu_act
        self.fc1 = nn.Conv2d(dim, hidden, 3, padding=1, groups=n_groups,
                             device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def _sources(self):
        return self.fc1.weight, self.fc1.bias, self.fc2.weight

    def _pack(self):
        return pack_ffn_weights(self.fc1.weight, self.fc1.bias, self.fc2.weight,
                                self.n_groups)

    def forward(self, x):
        B, T, H, W, C = x.shape
        if self.training:  # the JAX module path: grouped conv, GELU, dense
            y = gelu(conv_cl(self.fc1, x.reshape(B * T, H, W, C)), self.gelu_act)
            return self.fc2(y).reshape(B, T, H, W, C)
        y = fused_group_ffn(x.reshape(B * T, H, W, C).contiguous(), *self.operands(),
                            self.fc2.bias, groups=self.n_groups, act=self.gelu_act)
        return y.reshape(B, T, H, W, C)


class CALayer(nn.Module):
    def __init__(self, channel, reduction=16, device=None):
        super().__init__()
        self.conv_du = nn.Sequential(
            nn.Conv2d(channel, channel // reduction, 1, device=device),
            nn.ReLU(),
            nn.Conv2d(channel // reduction, channel, 1, device=device),
            nn.Sigmoid())

    def forward(self, x, mean=None):  # (N, H, W, C)
        """``mean``: the (N, 1, 1, C) global pool when the caller has it
        (the conv-chain kernel's sums); else pooled from x."""
        y = x.mean(dim=(1, 2), keepdim=True) if mean is None else mean
        return x * conv_cl(self.conv_du, y)


class RCAB(PackedOperands):
    """conv-ReLU-conv + channel attention, residual (reduction 8).
    ``forward(x, kernel=True)`` (eval, n_feat <= 128) runs both convs and
    the attention's pool sums as one ``fused_conv_chain`` pass, on taps
    packed once per parameter state."""

    def __init__(self, n_feat, reduction=8, device=None):
        super().__init__()
        self.body = nn.Sequential(
            nn.Conv2d(n_feat, n_feat, 3, padding=1, device=device),
            nn.ReLU(),
            nn.Conv2d(n_feat, n_feat, 3, padding=1, device=device),
            CALayer(n_feat, reduction, device))

    def _sources(self):
        return (self.body[0].weight, self.body[0].bias, self.body[2].weight,
                self.body[2].bias)

    def _pack(self):
        return (*pack_conv_taps(self.body[0].weight, self.body[0].bias),
                *pack_conv_taps(self.body[2].weight, self.body[2].bias))

    def forward(self, x, kernel: bool = False):  # (B, T, H, W, C)
        B, T, H, W, C = x.shape
        y = x.reshape(B * T, H, W, C)
        if kernel and C <= 128:
            res, psum = fused_conv_chain(y.contiguous(), *self.operands(), emit_psum=True)
            mean = (psum / float(H * W)).to(y.dtype).reshape(B * T, 1, 1, C)
            res = self.body[3](res, mean)
        else:
            res = conv_cl(self.body[2], F.relu(conv_cl(self.body[0], y)))
            res = self.body[3](res)
        return (y + res).reshape(B, T, H, W, C)


def _axis_mix(x, k, bias, chunk: int, axis: int):
    """Decayed axis FC along H (axis 1) or W (axis 2) of (N, H, W, C), the
    JAX package's XLA form ('hybrid' mode): channels pad to Cp = k's size,
    the matmul rounds to x's dtype before the bias, relu, then 1/Cp
    (relu_scale).  ``k`` (Cp, Cp) is the decayed weight, (in, out)."""
    N, H, W, C = x.shape
    Cp = k.shape[0]
    xp = F.pad(x, (0, Cp - C))
    y = F.relu(axis_tokens(xp, chunk, axis) @ k + bias) / Cp
    return axis_untokens(y, xp.shape, chunk, axis)[..., :C]


class MorphFCDecay(PackedOperands):
    """Enhanced MorphFCs with retention decay, in the JAX package's kernel
    forms: H-axis FC, W-axis FC and channel (RCAB) branches, each relu'd
    and scaled by 1/C; squeeze-mean softmax reweight; projection;
    symmetric gate ``(x + p) * act(p)``; optional folded block residual.
    ``rcab_impl="kernel"``: the RCAB branch in its kernel form where the
    'full' form runs (the JAX package's ``VMG_RCAB_KERNEL=1``)."""

    def __init__(self, dim, chunk_h=8, chunk_w=8, *, symm_act="tanh",
                 gelu_act="erf", rcab_impl="module", device=None):
        super().__init__()
        if rcab_impl not in ("module", "kernel"):
            raise ValueError(f"rcab_impl must be 'module' or 'kernel', got {rcab_impl!r}")
        self.dim, self.chunk_h, self.chunk_w = dim, chunk_h, chunk_w
        self.symm_act = symm_act
        self.rcab_impl = rcab_impl
        Ch = -(-dim // chunk_h) * chunk_h
        Cw = -(-dim // chunk_w) * chunk_w
        self.mlp_h = nn.Sequential(nn.Linear(Ch, Ch, device=device), nn.ReLU())
        self.mlp_w = nn.Sequential(nn.Linear(Cw, Cw, device=device), nn.ReLU())
        # the decay folded into the axis weights when they are packed (the
        # stored weights stay undecayed); constants, so not in the state dict
        for name, ch, f in (("gamma_h", chunk_h, Ch), ("gamma_w", chunk_w, Cw)):
            gamma = torch.tensor(morphfc_decay_np(ch, f // ch), device=device)
            self.register_buffer(name, gamma, persistent=False)
        self.mlp_c = RCAB(dim, device=device)
        self.reweight = Mlp(dim, dim // 4, dim * 3, gelu_act=gelu_act,
                            device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def _sources(self):
        fh, fw = self.mlp_h[0], self.mlp_w[0]
        return (fh.weight, fh.bias, fw.weight, fw.bias, self.proj.weight,
                self.proj.bias)

    def _decayed(self):
        """The axis-FC weights with the decay folded in, (in, out)."""
        return ((self.mlp_h[0].weight * self.gamma_h).t(),
                (self.mlp_w[0].weight * self.gamma_w).t())

    def _pack(self):
        fh, fw = self.mlp_h[0], self.mlp_w[0]
        kh, kw = self._decayed()
        pk = self.proj.weight.t().contiguous()
        if pk.is_cuda and pk.dtype == torch.bfloat16:  # the bf16 kernel's B image
            pk = pack_combine_weight(pk)
        return dict(kh=kh.contiguous(), kw=kw.contiguous(),
                    bh=fh.bias.float().contiguous(), bw=fw.bias.float().contiguous(),
                    pk=pk, pb=self.proj.bias.float().contiguous())

    def full_form(self, W: int) -> bool:
        """The JAX package's 'full' selection (``_pallas_mode``)."""
        C, ch, cw = self.dim, self.chunk_h, self.chunk_w
        return (C % ch == 0 and C % cw == 0 and W % cw == 0
                and ch * C <= 1024 and cw * C <= 1024)

    def train_forward(self, x):
        """The JAX module path (``blocks.py:874-952``, fused axis FCs):
        differentiable, no folded residual, every bf16 rounding where the
        module path rounds."""
        B, T, H, W, C = x.shape
        N = B * T
        kh, kw = self._decayed()
        xf = x.reshape(N, H, W, C)
        h = _axis_mix(xf, kh, self.mlp_h[0].bias, self.chunk_h, 1).reshape(x.shape)
        w = _axis_mix(xf, kw, self.mlp_w[0].bias, self.chunk_w, 2).reshape(x.shape)
        c = self.mlp_c(x) / C
        # squeeze-mean and branch softmax in float32
        a = (h + w + c).float().mean(dim=(1, 2, 3))
        a = self.reweight(a.to(h.dtype))
        a = a.reshape(B, C, 3).permute(2, 0, 1).float().softmax(dim=0)
        a = a.to(h.dtype)[:, :, None, None, None, :]
        p = self.proj(h * a[0] + w * a[1] + c * a[2])
        return (x + p) * symm_gate(p, self.symm_act)

    def forward(self, x, residual=None, res_scale: float = 1.0):
        B, T, H, W, C = x.shape
        N = B * T
        ops = self.operands()
        full = self.full_form(W)
        xf = x.reshape(N, H, W, C).contiguous()
        c = self.mlp_c(x, kernel=full and self.rcab_impl == "kernel")
        cf = (c / C).reshape(N, H, W, C).contiguous()
        if full:
            hf, wf, psum = fused_morphfc_axes(
                xf, cf, ops["kh"], ops["bh"], ops["kw"], ops["bw"],
                chunk_h=self.chunk_h, chunk_w=self.chunk_w)
        else:
            hf = _axis_mix(xf, ops["kh"], self.mlp_h[0].bias, self.chunk_h, 1).contiguous()
            wf = _axis_mix(xf, ops["kw"], self.mlp_w[0].bias, self.chunk_w, 2).contiguous()
            psum = fused_morphfc_reduce(hf, wf, cf)

        a = psum.reshape(B, T, C).sum(dim=1) / float(T * H * W)
        a = self.reweight(a.to(x.dtype))
        a = a.reshape(B, C, 3).permute(2, 0, 1).float().softmax(dim=0)
        a = a.to(x.dtype).permute(1, 0, 2)[:, None].expand(B, T, 3, C)
        res = None if residual is None else residual.reshape(N, H, W, C).contiguous()
        y = fused_morphfc_combine(
            xf, hf, wf, cf, a.reshape(N, 3, C).contiguous(), ops["pk"], ops["pb"],
            act=self.symm_act, residual=res, res_scale=res_scale)
        return y.reshape(B, T, H, W, C)


class TAB(nn.Module):
    """LayerNorm -> MorphFC-decay mixer -> LayerNorm -> grouped-conv FFN,
    each with a residual.  Eval: the serving block (the mixer folds the
    residual).  Training: the module paths, with stochastic depth at rate
    ``drop_path`` on both branches (keep masks from :meth:`drop_masks`).
    ``rcab_impl`` goes to the mixer, ``norm_impl`` to both LayerNorms."""

    def __init__(self, dim, chunk_h=8, chunk_w=8, mlp_ratio=2.0, n_groups=1,
                 *, symm_act="tanh", mixer_scaling=1.0, gelu_act="erf",
                 drop_path=0.0, rcab_impl="module", norm_impl="module", device=None):
        super().__init__()
        self.mixer_scaling = mixer_scaling
        self.drop_path = drop_path
        self.norm2 = TorchLayerNorm(dim, impl=norm_impl, device=device)
        self.spatial_mixing = MorphFCDecay(dim, chunk_h, chunk_w,
                                           symm_act=symm_act, gelu_act=gelu_act,
                                           rcab_impl=rcab_impl, device=device)
        self.norm3 = TorchLayerNorm(dim, impl=norm_impl, device=device)
        self.channel_mixing = MlpCnn(dim, mlp_ratio, n_groups,
                                     gelu_act=gelu_act, device=device)

    def drop_masks(self, batch: int, device, generator=None):
        """(2, batch) bool keep masks on ``device`` for the mixer and FFN
        branches, drawn from ``generator`` (the default generator if None),
        or None when this block drops nothing.  Drawn outside the block so
        a recomputed (checkpointed) forward reuses them."""
        if not self.training or self.drop_path == 0.0:
            return None
        dev = generator.device if generator is not None else device
        u = torch.rand((2, batch), generator=generator, device=dev)
        return (u < 1.0 - self.drop_path).to(device)

    def forward(self, x, keep=None):
        if self.training:
            y = self.spatial_mixing.train_forward(self.norm2(x))
            x = x + drop_path(y, None if keep is None else keep[0],
                              self.drop_path) * self.mixer_scaling
            y = self.channel_mixing(self.norm3(x))
            return x + drop_path(y, None if keep is None else keep[1],
                                 self.drop_path) * self.mixer_scaling
        x = self.spatial_mixing(self.norm2(x), residual=x,
                                res_scale=self.mixer_scaling)
        y = self.channel_mixing(self.norm3(x))
        return x + y * self.mixer_scaling
