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
from torch._subclasses.fake_tensor import is_fake
from torch.nn.utils import parametrize
from torch.utils._pytree import tree_flatten, tree_map

from vmg_tpu_torch.models.norms import RMSNorm, TorchLayerNorm
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
from vmg_tpu_torch.parallel.exchange import current_seq, mean_over_time


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
    state is packed once, and a later forward pays one tuple compare.

    Under ``torch.export`` (``ckpt/export.py``) the parameters are fake
    tensors: the operands packed from the real parameters by an eager
    forward are used as they are, and the export lifts them as constants
    of the program, with the weights baked in as the JAX package bakes
    ``params`` into its exported serving forward.  Packing inside the
    traced graph instead would run the packers' small ops (reshapes,
    pads, the TF32 split) in every call of the program."""

    _ops = None
    _ops_key = None

    def _sources(self):
        raise NotImplementedError

    def _pack(self):
        raise NotImplementedError

    def operands(self):
        sources = self._sources()
        if torch.compiler.is_compiling() or any(is_fake(t) for t in sources):
            if self._ops is None:
                raise RuntimeError(f"{type(self).__name__}: no packed operands to trace; run "
                                   "the model eagerly once before exporting it")
            return self._ops
        # a tensor-sharded leaf (parallel/tp.py) reads as a fresh gather:
        # its stored slice's version counts
        key = tuple(t._version for t in sources) + tuple(
            p._version for m in self.modules() if parametrize.is_parametrized(m)
            for p in m.parametrizations.parameters())
        if self._ops is None or key != self._ops_key:
            with torch.no_grad():
                ops = self._pack()
                if any(is_fake(t) for t in tree_flatten(ops)[0] if isinstance(t, torch.Tensor)):
                    return ops  # packed under a fake mode (a FLOP count): not kept
                # an operand that is a source tensor itself (a float32 bias)
                # is copied: the operands own their storage, as the
                # constants of an exported program must
                storages = {t.untyped_storage().data_ptr() for t in sources}
                self._ops = tree_map(
                    lambda t: t.clone() if isinstance(t, torch.Tensor)
                    and t.untyped_storage().data_ptr() in storages else t, ops)
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


class MlpGEGLU(nn.Module):
    """gelu(fc11) * fc12 -> fc2."""

    def __init__(self, dim, hidden=None, *, gelu_act="erf", device=None):
        super().__init__()
        hidden = hidden or dim
        self.gelu_act = gelu_act
        self.fc11 = nn.Linear(dim, hidden, device=device)
        self.fc12 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)

    def forward(self, x):
        return self.fc2(gelu(self.fc11(x), self.gelu_act) * self.fc12(x))


class MlpIr(nn.Module):
    """Linear expand -> + gelu(depthwise 3x3) residual -> project, at the
    intended hidden width dim * exp_r (the reference's TAB dispatch builds
    its fc1 from an undefaulted argument and crashes)."""

    def __init__(self, dim, exp_r=4.0, *, gelu_act="erf", device=None):
        super().__init__()
        hidden = int(dim * exp_r)
        self.gelu_act = gelu_act
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2 = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden, device=device)
        self.fc3 = nn.Linear(hidden, dim, device=device)

    def forward(self, x):
        B, T, H, W, _ = x.shape
        y = gelu(self.fc1(x), self.gelu_act)
        z = y.reshape(B * T, H, W, -1)
        z = z + gelu(conv_cl(self.fc2, z), self.gelu_act)
        return self.fc3(z.reshape(B, T, H, W, -1))


class MlpIrMulti(nn.Module):
    """Multi-kernel depthwise IR-FFN: the hidden split into len(stage_n)
    segments, each through a depthwise k x k conv, then z + gelu(z) ->
    project (the forward the reference's shadowing second ``forward`` hid)."""

    def __init__(self, dim, exp_r=4.0, stage_n=(1, 3, 5, 7), *, gelu_act="erf", device=None):
        super().__init__()
        hidden = int(dim * exp_r)
        self.cg = hidden // len(stage_n)
        self.gelu_act = gelu_act
        self.fc1 = nn.Linear(dim, hidden, device=device)
        self.fc2_multi = nn.ModuleList(
            nn.Conv2d(self.cg, self.cg, k, padding=k // 2, groups=self.cg, device=device)
            for k in stage_n)
        self.fc3 = nn.Linear(self.cg * len(stage_n), dim, device=device)

    def forward(self, x):
        B, T, H, W, _ = x.shape
        z = gelu(self.fc1(x), self.gelu_act).reshape(B * T, H, W, -1)
        cg = self.cg
        z = torch.cat([conv_cl(conv, z[..., i * cg:(i + 1) * cg])
                       for i, conv in enumerate(self.fc2_multi)], dim=-1)
        z = z + gelu(z, self.gelu_act)
        return self.fc3(z.reshape(B, T, H, W, -1))


_SHIFTS = ((1, 1), (1, 0), (1, -1), (0, 1), (0, 0), (0, -1), (-1, 1), (-1, 0), (-1, -1))


def patch_shift_2d(x, inv: bool = False):
    """9-way channel-chunk spatial shift of (B, T, H, W, C): H and W zero
    padded by one, C to a multiple of 9; chunk i rolled by its (dh, dw)
    (negated when ``inv``), then cropped back."""
    B, T, H, W, C = x.shape
    Cp = -(-C // 9) * 9
    x = F.pad(x, (0, Cp - C, 1, 1, 1, 1))
    m = -1 if inv else 1
    out = torch.cat([torch.roll(c, (m * sh, m * sw), dims=(-3, -2))
                     for c, (sh, sw) in zip(x.chunk(9, dim=-1), _SHIFTS)], dim=-1)
    return out[:, :, 1:H + 1, 1:W + 1, :C]


class MlpCnnShift(nn.Module):
    """Shift-FFN: two branches (patch shift around fc1, and fc2) reweighted
    by a squeeze-mean softmax, then projected."""

    def __init__(self, dim, exp_r=2.0, *, gelu_act="erf", device=None):
        super().__init__()
        hidden = int(dim * exp_r)
        self.gelu_act = gelu_act
        self.fc = nn.Linear(dim, hidden, device=device)
        self.fc1 = nn.Linear(hidden, dim, device=device)
        self.fc2 = nn.Linear(hidden, dim, device=device)
        self.reweight = Mlp(dim, dim // 4, dim * 2, gelu_act=gelu_act, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        B, T, H, W, C = x.shape
        g = self.gelu_act
        y = gelu(self.fc(x), g)
        h = patch_shift_2d(gelu(self.fc1(patch_shift_2d(y)), g), inv=True)
        w = gelu(self.fc2(y), g)
        s = h + w
        # the clip's mean: over every process's frames where T is sharded
        a = s.mean(dim=(1, 2, 3)) if current_seq() is None else mean_over_time(s).to(s.dtype)
        a = self.reweight(a)
        a = a.reshape(B, C, 2).permute(2, 0, 1).softmax(dim=0)[:, :, None, None, None, :]
        return self.proj(h * a[0] + w * a[1])


FFN_TYPES = ("vanilla", "ffn_cnn", "ffn_cnn_shift", "irffn_single", "irffn_multi")


def make_ffn(ffn_type: str, dim: int, mlp_ratio: float, n_groups: int, *, gelu_act="erf",
             device=None):
    """The TAB's channel mixer by name.  Only ``ffn_cnn`` has a kernel (the
    grouped FFN, in eval); the others are module forms, as in the JAX
    package."""
    if ffn_type == "vanilla":
        return Mlp(dim, int(dim * mlp_ratio), dim, gelu_act=gelu_act, device=device)
    if ffn_type == "ffn_cnn":
        return MlpCnn(dim, mlp_ratio, n_groups, gelu_act=gelu_act, device=device)
    if ffn_type == "ffn_cnn_shift":
        return MlpCnnShift(dim, mlp_ratio, gelu_act=gelu_act, device=device)
    if ffn_type == "irffn_single":
        return MlpIr(dim, mlp_ratio, gelu_act=gelu_act, device=device)
    if ffn_type == "irffn_multi":
        return MlpIrMulti(dim, mlp_ratio, gelu_act=gelu_act, device=device)
    raise ValueError(f"unknown ffn_type {ffn_type!r}")


class InvertedResidual(nn.Module):
    """MBConv: 1x1 expand, relu6, depthwise 3x3, relu6, 1x1 project, residual."""

    def __init__(self, dim, expansion=4, device=None):
        super().__init__()
        mid = int(dim * expansion)
        self.pw = nn.Conv2d(dim, mid, 1, device=device)
        self.dw = nn.Conv2d(mid, mid, 3, padding=1, groups=mid, device=device)
        self.pw_linear = nn.Conv2d(mid, dim, 1, device=device)

    def forward(self, x):
        B, T, H, W, C = x.shape
        y = F.relu6(conv_cl(self.pw, x.reshape(B * T, H, W, C)))
        y = conv_cl(self.pw_linear, F.relu6(conv_cl(self.dw, y)))
        return x + y.reshape(B, T, H, W, C)


class MultiMBConv(nn.Module):
    """``num_blocks`` inverted residuals (the spatial mixer ``'mbconv'``)."""

    def __init__(self, dim, num_blocks=10, expansion=4, device=None):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", InvertedResidual(dim, expansion, device))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"block{i}")(x)
        return x


def _linear(dim_in, dim_out, bias: bool, wrap: bool, relu: bool, device):
    """A Linear, inside ``nn.Sequential`` (reference key ``<name>.0``) when
    ``wrap``, followed there by a ReLU when ``relu``."""
    lin = nn.Linear(dim_in, dim_out, bias=bias, device=device)
    if not wrap:
        return lin
    return nn.Sequential(lin, nn.ReLU()) if relu else nn.Sequential(lin)


def _lin(m):
    return m[0] if isinstance(m, nn.Sequential) else m


def _axis_mix(x, k, bias, chunk: int, axis: int, *, relu: bool = True, scale=None):
    """Axis FC along H (axis 1) or W (axis 2) of (N, H, W, C), the JAX
    package's module form: channels pad to Cp = k's size, the matmul rounds
    to x's dtype before the bias, relu (``relu``), then ``scale`` (None:
    1/Cp, relu_scale; else a callable, e.g. an RMSNorm, or the identity).
    ``k`` (Cp, Cp) is the (decayed) weight, (in, out); ``bias`` may be None."""
    N, H, W, C = x.shape
    Cp = k.shape[0]
    xp = F.pad(x, (0, Cp - C))
    y = axis_tokens(xp, chunk, axis) @ k
    if bias is not None:
        y = y + bias
    if relu:
        y = F.relu(y)
    y = y / Cp if scale is None else scale(y)
    return axis_untokens(y, xp.shape, chunk, axis)[..., :C]


def _reweight(mix, h, w, c, B, C):
    """Squeeze-mean of the three branches in float32, the reweight MLP in
    the branches' dtype, and the branch softmax in float32 -> (3, B, 1, 1,
    1, C) weights in the branches' dtype."""
    a = mean_over_time(h + w + c)
    a = mix(a.to(h.dtype))
    a = a.reshape(B, C, 3).permute(2, 0, 1).float().softmax(dim=0)
    return a.to(h.dtype)[:, :, None, None, None, :]


class MorphFC(nn.Module):
    """Enhanced MorphFCs without decay or gating (``ret_decay=False``):
    linear H-axis, W-axis and channel FCs, squeeze-mean softmax reweight,
    projection.  Module form only, as in the JAX package; its fused and
    unfused forms (``morph_fused``) are one function, computed here in the
    token form.  ``wrap``: the axis FCs' reference key layout (``mlp_h.0``
    where the model's ``non_linear`` is set, as the JAX package exports)."""

    def __init__(self, dim, chunk_h=8, chunk_w=8, qkv_bias=True, *, wrap=True,
                 wrap_c=False, gelu_act="erf", device=None):
        super().__init__()
        self.dim, self.chunk_h, self.chunk_w = dim, chunk_h, chunk_w
        Ch = -(-dim // chunk_h) * chunk_h
        Cw = -(-dim // chunk_w) * chunk_w
        self.mlp_h = _linear(Ch, Ch, qkv_bias, wrap, False, device)
        self.mlp_w = _linear(Cw, Cw, qkv_bias, wrap, False, device)
        self.mlp_c = _linear(dim, dim, qkv_bias, wrap_c, False, device)
        self.reweight = Mlp(dim, dim // 4, dim * 3, gelu_act=gelu_act, device=device)
        self.proj = nn.Linear(dim, dim, device=device)

    def forward(self, x):
        B, T, H, W, C = x.shape
        xf = x.reshape(B * T, H, W, C)
        fh, fw = _lin(self.mlp_h), _lin(self.mlp_w)
        ident = lambda v: v  # noqa: E731
        h = _axis_mix(xf, fh.weight.t(), fh.bias, self.chunk_h, 1, relu=False, scale=ident)
        w = _axis_mix(xf, fw.weight.t(), fw.bias, self.chunk_w, 2, relu=False, scale=ident)
        h, w = h.reshape(x.shape), w.reshape(x.shape)
        c = self.mlp_c(x)
        a = _reweight(self.reweight, h, w, c, B, C)
        return self.proj(h * a[0] + w * a[1] + c * a[2])


SYMM_ACTS = ("tanh", "sigmoid", "relu", "gelu", "swish")


class MorphFCDecay(PackedOperands):
    """Enhanced MorphFCs with retention decay: H-axis FC, W-axis FC and
    channel (RCAB or linear) branches, each relu'd (``non_linear``) and
    scaled (1/C with ``relu_scale``, an RMSNorm with ``relu_scale_norm``);
    squeeze-mean softmax reweight; projection; gate -- the symmetric
    ``(x + p) * act(p)`` (``symm``), else ``silu(gating_fc(x)) * gelu(p)``,
    or none (``gating`` off); optional folded block residual.

    Eval takes the JAX package's route (``_pallas_mode``): the kernels run
    only with gating, symm and relu_scale on, relu_scale_norm off and a
    gate the combine kernel has (tanh, sigmoid, relu) -- 'full' (the axes
    kernel, in its ``non_linear`` and bias-free forms too) where the chunks
    divide C and W and chunk * C <= 1024, else 'hybrid' (the axis FCs as
    matmuls, then the reduce kernel), both ending in the combine kernel;
    elsewhere the module form runs, as in training.  ``rcab_impl="kernel"``:
    the RCAB branch in its kernel form where the 'full' form runs (the JAX
    package's ``VMG_RCAB_KERNEL=1``).  Parameter names follow the reference
    export: ``mlp_h.0`` with ``non_linear`` (else ``mlp_h``), ``mlp_c.0``
    for a non-linear linear channel branch, ``scale_h`` ... for the
    RMSNorms, ``gating_fc``."""

    def __init__(self, dim, chunk_h=8, chunk_w=8, *, qkv_bias=True, non_linear=True,
                 gating=True, symm=True, symm_act="tanh", relu_scale=True,
                 relu_scale_norm=False, channel_mixer="rcab", gelu_act="erf",
                 rcab_impl="module", norm_impl="module", device=None):
        super().__init__()
        if rcab_impl not in ("module", "kernel"):
            raise ValueError(f"rcab_impl must be 'module' or 'kernel', got {rcab_impl!r}")
        if gating and symm and symm_act not in SYMM_ACTS:
            raise ValueError(f"symm_act must be one of {SYMM_ACTS}, got {symm_act!r}")
        self.dim, self.chunk_h, self.chunk_w = dim, chunk_h, chunk_w
        self.non_linear, self.gating, self.symm = non_linear, gating, symm
        self.symm_act, self.gelu_act = symm_act, gelu_act
        self.relu_scale, self.relu_scale_norm = relu_scale, relu_scale_norm
        self.rcab_impl = rcab_impl
        Ch = -(-dim // chunk_h) * chunk_h
        Cw = -(-dim // chunk_w) * chunk_w
        self.mlp_h = _linear(Ch, Ch, qkv_bias, non_linear, non_linear, device)
        self.mlp_w = _linear(Cw, Cw, qkv_bias, non_linear, non_linear, device)
        # the decay folded into the axis weights when they are packed (the
        # stored weights stay undecayed); constants, so not in the state dict
        for name, ch, f in (("gamma_h", chunk_h, Ch), ("gamma_w", chunk_w, Cw)):
            gamma = torch.tensor(morphfc_decay_np(ch, f // ch), device=device)
            self.register_buffer(name, gamma, persistent=False)
        if channel_mixer == "rcab":
            self.mlp_c = RCAB(dim, device=device)
        else:
            self.mlp_c = _linear(dim, dim, qkv_bias, non_linear, non_linear, device)
        self.rcab = channel_mixer == "rcab"
        if relu_scale_norm:
            self.scale_h = RMSNorm(Ch, impl=norm_impl, device=device)
            self.scale_w = RMSNorm(Cw, impl=norm_impl, device=device)
            self.scale_c = RMSNorm(dim, impl=norm_impl, device=device)
        self.reweight = Mlp(dim, dim // 4, dim * 3, gelu_act=gelu_act, device=device)
        self.proj = nn.Linear(dim, dim, device=device)
        if gating and not symm:
            self.gating_fc = nn.Linear(dim, dim, device=device)

    def _sources(self):
        fh, fw = _lin(self.mlp_h), _lin(self.mlp_w)
        return tuple(t for t in (fh.weight, fh.bias, fw.weight, fw.bias, self.proj.weight,
                                 self.proj.bias) if t is not None)

    def _decayed(self):
        """The axis-FC weights with the decay folded in, (in, out)."""
        fh, fw = _lin(self.mlp_h), _lin(self.mlp_w)
        return (fh.weight * self.gamma_h).t(), (fw.weight * self.gamma_w).t()

    def _pack(self):
        fh, fw = _lin(self.mlp_h), _lin(self.mlp_w)
        kh, kw = self._decayed()
        pk = self.proj.weight.t().contiguous()
        if pk.is_cuda and pk.dtype in (torch.bfloat16, torch.float32):  # the kernel's B image
            pk = pack_combine_weight(pk)
        bias = fh.bias is not None
        return dict(kh=kh.contiguous(), kw=kw.contiguous(),
                    bh=fh.bias.float().contiguous() if bias else None,
                    bw=fw.bias.float().contiguous() if bias else None,
                    pk=pk, pb=self.proj.bias.float().contiguous())

    def kernel_mode(self, W: int):
        """The JAX package's ``_pallas_mode``: None (the module form),
        'full' (axes + combine kernels) or 'hybrid' (reduce + combine)."""
        if not (self.gating and self.symm and self.relu_scale and not self.relu_scale_norm
                and self.symm_act in ("tanh", "sigmoid", "relu")):
            return None
        return "full" if self.full_form(W) else "hybrid"

    def full_form(self, W: int) -> bool:
        """The JAX package's 'full' selection (``_pallas_mode``)."""
        C, ch, cw = self.dim, self.chunk_h, self.chunk_w
        return (C % ch == 0 and C % cw == 0 and W % cw == 0
                and ch * C <= 1024 and cw * C <= 1024)

    def _scales(self):
        if self.relu_scale_norm:
            return self.scale_h, self.scale_w, self.scale_c
        if self.relu_scale:
            return None, None, lambda v: v / self.dim
        ident = lambda v: v  # noqa: E731
        return ident, ident, ident

    def _branches(self, x, kh, kw):
        """The axis branches (module form) and the scaled channel branch,
        (N, H, W, C) each."""
        N = x.shape[0] * x.shape[1]
        xf = x.reshape(N, *x.shape[2:])
        sh, sw, sc = self._scales()
        fh, fw = _lin(self.mlp_h), _lin(self.mlp_w)
        h = _axis_mix(xf, kh, fh.bias, self.chunk_h, 1, relu=self.non_linear, scale=sh)
        w = _axis_mix(xf, kw, fw.bias, self.chunk_w, 2, relu=self.non_linear, scale=sw)
        c = sc(self.mlp_c(x)).reshape(xf.shape)
        return h, w, c

    def _gate(self, x, p):
        if not self.gating:
            return p
        if self.symm:
            if self.symm_act == "gelu":
                return (x + p) * gelu(p, self.gelu_act)
            if self.symm_act == "swish":
                return (x + p) * F.silu(p)
            return (x + p) * symm_gate(p, self.symm_act)
        return F.silu(self.gating_fc(x)) * gelu(p, self.gelu_act)

    def module_forward(self, x, residual=None, res_scale: float = 1.0):
        """The JAX module path: differentiable, every bf16 rounding where the
        module path rounds; ``residual``: the folded block residual."""
        B, T, H, W, C = x.shape
        kh, kw = self._decayed()
        h, w, c = (t.reshape(x.shape) for t in self._branches(x, kh, kw))
        a = _reweight(self.reweight, h, w, c, B, C)
        y = self._gate(x, self.proj(h * a[0] + w * a[1] + c * a[2]))
        return y if residual is None else residual + res_scale * y

    def forward(self, x, residual=None, res_scale: float = 1.0):
        B, T, H, W, C = x.shape
        mode = self.kernel_mode(W)
        if mode is None:
            return self.module_forward(x, residual, res_scale)
        N = B * T
        ops = self.operands()
        xf = x.reshape(N, H, W, C).contiguous()
        if self.rcab:
            c = self.mlp_c(x, kernel=mode == "full" and self.rcab_impl == "kernel")
        else:
            c = self.mlp_c(x)
        cf = (c / C).reshape(N, H, W, C).contiguous()
        if mode == "full":
            hf, wf, psum = fused_morphfc_axes(
                xf, cf, ops["kh"], ops["bh"], ops["kw"], ops["bw"],
                chunk_h=self.chunk_h, chunk_w=self.chunk_w, non_linear=self.non_linear)
        else:
            fh, fw = _lin(self.mlp_h), _lin(self.mlp_w)
            hf = _axis_mix(xf, ops["kh"], fh.bias, self.chunk_h, 1,
                           relu=self.non_linear).contiguous()
            wf = _axis_mix(xf, ops["kw"], fw.bias, self.chunk_w, 2,
                           relu=self.non_linear).contiguous()
            psum = fused_morphfc_reduce(hf, wf, cf)

        a = psum.reshape(B, T, C).sum(dim=1)
        seq = current_seq()  # T sharded: the per-frame sums of every process's frames
        a = a / float(T * H * W) if seq is None else seq.time_sum(a) / float(seq.T * H * W)
        a = self.reweight(a.to(x.dtype))
        a = a.reshape(B, C, 3).permute(2, 0, 1).float().softmax(dim=0)
        a = a.to(x.dtype).permute(1, 0, 2)[:, None].expand(B, T, 3, C)
        res = None if residual is None else residual.reshape(N, H, W, C).contiguous()
        y = fused_morphfc_combine(
            xf, hf, wf, cf, a.reshape(N, 3, C).contiguous(), ops["pk"], ops["pb"],
            act=self.symm_act, residual=res, res_scale=res_scale)
        return y.reshape(B, T, H, W, C)


MIXER_TYPES = ("mlps", "mbconv")


class TAB(nn.Module):
    """LayerNorm -> spatial mixer -> LayerNorm -> channel mixer (FFN), each
    with a residual.  The spatial mixer: MorphFC-decay (``mixer_type``
    'mlps' with ``if_decay``), plain MorphFC ('mlps' without), or MBConv
    blocks ('mbconv', ``mixer_n`` of them, 2 by default).  Eval: the
    serving block (the MorphFC-decay mixer folds the residual).  Training:
    the module paths, with stochastic depth at rate ``drop_path`` on both
    branches (keep masks from :meth:`drop_masks`).  ``rcab_impl`` goes to
    the mixer, ``norm_impl`` to the LayerNorms and RMSNorms."""

    def __init__(self, dim, chunk_h=8, chunk_w=8, mlp_ratio=2.0, n_groups=1,
                 *, qkv_bias=True, if_decay=True, non_linear=True, gating=True, symm=True,
                 symm_act="tanh", relu_scale=True, relu_scale_norm=False, ffn_type="ffn_cnn",
                 mixer_type="mlps", mixer_n=None, channel_mixer="rcab", mixer_scaling=1.0,
                 gelu_act="erf", drop_path=0.0, rcab_impl="module", norm_impl="module",
                 device=None):
        super().__init__()
        self.mixer_scaling = mixer_scaling
        self.drop_path = drop_path
        self.norm2 = TorchLayerNorm(dim, impl=norm_impl, device=device)
        if mixer_type == "mlps" and if_decay:
            self.spatial_mixing = MorphFCDecay(
                dim, chunk_h, chunk_w, qkv_bias=qkv_bias, non_linear=non_linear,
                gating=gating, symm=symm, symm_act=symm_act, relu_scale=relu_scale,
                relu_scale_norm=relu_scale_norm, channel_mixer=channel_mixer,
                gelu_act=gelu_act, rcab_impl=rcab_impl, norm_impl=norm_impl, device=device)
        elif mixer_type == "mlps":
            self.spatial_mixing = MorphFC(dim, chunk_h, chunk_w, qkv_bias, wrap=non_linear,
                                          wrap_c=non_linear and channel_mixer != "rcab",
                                          gelu_act=gelu_act, device=device)
        elif mixer_type == "mbconv":
            self.spatial_mixing = MultiMBConv(dim, num_blocks=mixer_n or 2, device=device)
        else:
            raise ValueError(f"unknown mixer_type {mixer_type!r}")
        self.norm3 = TorchLayerNorm(dim, impl=norm_impl, device=device)
        self.channel_mixing = make_ffn(ffn_type, dim, mlp_ratio, n_groups,
                                       gelu_act=gelu_act, device=device)

    def drop_masks(self, batch: int, device, generator=None, rows=None):
        """(2, batch) bool keep masks on ``device`` for the mixer and FFN
        branches, drawn from ``generator`` (the default generator if None),
        or None when this block drops nothing.  Drawn outside the block so
        a recomputed (checkpointed) forward reuses them.  ``rows``: (total,
        first): draw the masks of ``total`` rows and keep rows first ..
        first + batch - 1 (one process's share of a data-parallel batch)."""
        if not self.training or self.drop_path == 0.0:
            return None
        total, first = (batch, 0) if rows is None else rows
        dev = generator.device if generator is not None else device
        u = torch.rand((2, total), generator=generator, device=dev)[:, first:first + batch]
        return (u < 1.0 - self.drop_path).to(device)

    def forward(self, x, keep=None):
        mixer = self.spatial_mixing
        if self.training or not isinstance(mixer, MorphFCDecay):
            y = mixer.module_forward(self.norm2(x)) if isinstance(mixer, MorphFCDecay) \
                else mixer(self.norm2(x))
            x = x + drop_path(y, None if keep is None else keep[0],
                              self.drop_path) * self.mixer_scaling
            y = self.channel_mixing(self.norm3(x))
            return x + drop_path(y, None if keep is None else keep[1],
                                 self.drop_path) * self.mixer_scaling
        x = mixer(self.norm2(x), residual=x, res_scale=self.mixer_scaling)
        y = self.channel_mixing(self.norm3(x))
        return x + y * self.mixer_scaling
