"""MorphFC-decay mixer kernels: axis branches, reweight reduction, combine.

Port of ``fused_morphfc_axes``, ``fused_morphfc_reduce`` and
``fused_morphfc_combine`` of ``vmg_tpu/ops/morphfc_fused.py``.  The
wrappers launch the CUDA kernels of ``csrc/morphfc.cu`` on CUDA tensors
(design notes there) and take the plain PyTorch versions beside them on
CPU tensors.  Tensors are ``(N, H, W, C)``; ``a`` holds the per-frame
softmax branch weights ``(N, 3, C)``.  Weights come as the kernels take
them, packed once by the module (``MorphFCDecay.operands``): matrices
``(C_in, C_out)`` in the tensors' dtype (the axis weights with the decay
folded in), biases float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vmg_tpu_torch import _build


def axis_tokens(x, chunk: int, axis: int):
    """Token matrix of the axis FC along H (axis 1) or W (axis 2) of
    ``(N, H, W, C)``: a token is channel segment q (S = C / chunk channels)
    of a chunk of ``chunk`` positions, its C features (position p, s).
    Positions pad with zeros to a multiple of ``chunk``.  Returns
    ``(tokens, C)``, tokens ordered (n, other axis, chunk, q)."""
    if axis == 1:
        x = x.transpose(1, 2)
    N, A, L, C = x.shape
    Lp = -(-L // chunk) * chunk
    x = F.pad(x, (0, 0, 0, Lp - L))
    tok = x.reshape(N, A, Lp // chunk, chunk, chunk, C // chunk).transpose(3, 4)
    return tok.reshape(-1, C)


def axis_untokens(y, shape, chunk: int, axis: int):
    """Inverse of :func:`axis_tokens`: output feature (P, Z) of token q goes
    to position P of its chunk, channel q * S + Z; pad positions drop."""
    N, H, W, C = shape
    A, L = (W, H) if axis == 1 else (H, W)
    Lp = -(-L // chunk) * chunk
    y = y.reshape(N, A, Lp // chunk, chunk, chunk, C // chunk).transpose(3, 4)
    y = y.reshape(N, A, Lp, C)[:, :, :L]
    return y.transpose(1, 2) if axis == 1 else y


def morphfc_axes_plain(x, c, kh, bh, kw, bw, *, chunk_h: int, chunk_w: int):
    """Both decayed axis branches, relu(tokens @ k + b) / C in f32 rounded
    once to x's dtype, and the f32 per-frame sums of h + w + c taken from
    the unrounded branches.  Returns (h, w, psum (N, C) f32)."""
    C = x.shape[-1]

    def branch(k, b, chunk, axis):
        y = torch.relu(axis_tokens(x, chunk, axis).float() @ k.float() + b) * (1.0 / C)
        return axis_untokens(y, x.shape, chunk, axis)

    h = branch(kh, bh, chunk_h, 1)
    w = branch(kw, bw, chunk_w, 2)
    psum = h.sum(dim=(1, 2)) + w.sum(dim=(1, 2)) + c.float().sum(dim=(1, 2))
    return h.to(x.dtype), w.to(x.dtype), psum


FORMS = ("big", "token")
# Shared memory one block may use on Hopper (227 KB).
MAX_SMEM = 232_448


def axes_form(C: int, chunk_h: int, chunk_w: int) -> str:
    """The form ``form=None`` resolves to, as the JAX op selects it: the
    big-matrix form while chunk * C fits its 1024-lane budget, else the
    token form."""
    return "token" if chunk_h * C > 1024 or chunk_w * C > 1024 else "big"


def big_form_smem(M: int, C: int, dtype) -> int:
    """Bytes of shared memory the big-form kernel takes for M tokens per
    branch (``AxesSmem`` in ``csrc/morphfc.cu``): the C x C weight, the
    tokens and their f32 projection."""
    tc = dtype == torch.bfloat16
    es = 2 if tc else 4
    ld, ldo = (C + 8, C + 4) if tc else (C, C)
    lanes = 256 // (C // (16 // es))  # positions the epilogue's threads cover

    def up(b):
        return -(-b // 128) * 128

    return up(C * ld * es) + up(max(M * ld * es, lanes * C * 4)) + M * ldo * 4


def fused_morphfc_axes(x, c, kh, bh, kw, bw, *, chunk_h: int, chunk_w: int,
                       form: str | None = None):
    """x, c (N, H, W, C) -> (h, w, psum); needs C % chunk_h == C % chunk_w
    == W % chunk_w == 0.  kh, kw are the axis weights with the decay
    already folded in, as ``MorphFCDecay`` packs them once per parameter
    state (the JAX op folds it per call).  ``form``: "big" (the kernel
    that holds the whole C x C weight; it raises where that does not fit
    in shared memory), "token" (weight column tiles: any chunk * C) or
    None for :func:`axes_form`.  Both compute one function, so CPU
    tensors take the same plain version."""
    if form is None:
        form = axes_form(x.shape[-1], chunk_h, chunk_w)
    elif form not in FORMS:
        raise ValueError(f"form must be one of {FORMS} or None, got {form!r}")
    if x.device.type == "cpu":
        return morphfc_axes_plain(x, c, kh, bh, kw, bw, chunk_h=chunk_h,
                                  chunk_w=chunk_w)
    N, H, W, C = x.shape
    dt, dev = x.dtype, x.device
    if C % chunk_h or C % chunk_w or W % chunk_w:
        raise ValueError(f"chunks ({chunk_h}, {chunk_w}) do not divide C={C}, W={W}")
    _build.require(x, "x")
    for name, t, shape, dtype in (("c", c, x.shape, dt), ("kh", kh, (C, C), dt),
                                  ("bh", bh, (C,), torch.float32),
                                  ("kw", kw, (C, C), dt),
                                  ("bw", bw, (C,), torch.float32)):
        _build.require(t, name, shape=shape, dtype=dtype, device=dev)
    # slab width: whole W chunks, >= 64 tokens per branch, a multiple of 16
    kg = -(-64 // (chunk_h * chunk_w))
    while chunk_h * chunk_w * kg % 16:
        kg += 1
    WT = chunk_w * kg
    if form == "big" and big_form_smem(chunk_h * WT, C, dt) > MAX_SMEM:
        raise ValueError(
            f"the big form needs {big_form_smem(chunk_h * WT, C, dt)} bytes of shared "
            f"memory at C={C}, chunks ({chunk_h}, {chunk_w}); a block has {MAX_SMEM}: "
            "use form='token'")
    S = -(-H // chunk_h) * -(-W // WT)
    h, w = torch.empty_like(x), torch.empty_like(x)
    partial = torch.empty((N, S, C), dtype=torch.float32, device=dev)
    psum = torch.empty((N, C), dtype=torch.float32, device=dev)
    name = "vmg_morphfc_axes" if form == "big" else "vmg_morphfc_axes_token"
    code = getattr(_build.load_library(), name)(
        x.data_ptr(), c.data_ptr(), kh.data_ptr(), bh.data_ptr(), kw.data_ptr(),
        bw.data_ptr(), h.data_ptr(), w.data_ptr(), partial.data_ptr(),
        psum.data_ptr(), N, H, W, C, chunk_h, chunk_w, WT,
        _build.DTYPE_CODES[dt], _build.stream_of(x))
    _build.check(code, name)
    if form == "big":
        fused_morphfc_axes.launches += 1
    else:
        fused_morphfc_axes.token_launches += 1
    return h, w, psum


fused_morphfc_axes.launches = 0  # the big form's kernel
fused_morphfc_axes.token_launches = 0  # the token form's kernel


def morphfc_reduce_plain(h, w, c):
    """f32 per-frame sums of h + w + c: (N, H, W, C) x3 -> (N, C)."""
    return (h.float() + w.float() + c.float()).sum(dim=(1, 2))


def fused_morphfc_reduce(h, w, c):
    if h.device.type == "cpu":
        return morphfc_reduce_plain(h, w, c)
    N, H, W, C = h.shape
    _build.require(h, "h")
    for name, t in (("w", w), ("c", c)):
        _build.require(t, name, shape=h.shape, dtype=h.dtype, device=h.device)
    P = H * W
    # pixel slices per frame (pass 1): >= 64 pixels each, <= 64 slices, so
    # small frames still spread over the SMs
    S = max(1, min(64, -(-P // 64)))
    partial = torch.empty((N, S, C), dtype=torch.float32, device=h.device)
    out = torch.empty((N, C), dtype=torch.float32, device=h.device)
    code = _build.load_library().vmg_morphfc_reduce(
        h.data_ptr(), w.data_ptr(), c.data_ptr(), partial.data_ptr(),
        out.data_ptr(), N, P, C, S, _build.DTYPE_CODES[h.dtype],
        _build.stream_of(h))
    _build.check(code, "vmg_morphfc_reduce")
    fused_morphfc_reduce.launches += 1
    return out


fused_morphfc_reduce.launches = 0


# the combine kernel's gate codes
_GATES = {"tanh": 0, "sigmoid": 1, "relu": 2}


def symm_gate(p, act):
    """The mixer's symmetric gate activation."""
    if act == "tanh":
        return torch.tanh(p)
    if act == "sigmoid":
        return torch.sigmoid(p) - 0.5
    if act == "relu":
        return torch.relu(p)
    raise ValueError(f"unsupported gate act {act!r}")


def morphfc_combine_plain(x, h, w, c, a, pk, pb, *, act="tanh",
                          residual=None, res_scale=1.0):
    """(x + p) * act(p), p = round(y @ pk + pb), y = a0 h + a1 w + a2 c in
    the input dtype; optionally residual + res_scale * out."""
    a = a.to(x.dtype)[:, :, None, None, :]
    y = h * a[:, 0] + w * a[:, 1] + c * a[:, 2]
    p = (y.float() @ pk.float() + pb.float()).to(x.dtype)
    out = (x + p) * symm_gate(p, act)
    if residual is not None:
        out = residual + res_scale * out
    return out


def fused_morphfc_combine(x, h, w, c, a, pk, pb, *, act="tanh",
                          residual=None, res_scale=1.0):
    """pk (C_in, C_out) in x's dtype, pb (C,) f32; ``act``: the gate,
    ``"tanh"``, ``"sigmoid"`` (sigmoid(p) - 0.5) or ``"relu"``."""
    if x.device.type == "cpu":
        return morphfc_combine_plain(x, h, w, c, a, pk, pb, act=act,
                                     residual=residual, res_scale=res_scale)
    if act not in _GATES:
        raise ValueError(f"unsupported gate act {act!r}")
    N, H, W, C = x.shape
    dt, dev = x.dtype, x.device
    _build.require(x, "x")
    checks = [("h", h, x.shape, dt), ("w", w, x.shape, dt),
              ("c", c, x.shape, dt), ("a", a, (N, 3, C), dt),
              ("pk", pk, (C, C), dt), ("pb", pb, (C,), torch.float32)]
    if residual is not None:
        checks.append(("residual", residual, x.shape, dt))
    for name, t, shape, dtype in checks:
        _build.require(t, name, shape=shape, dtype=dtype, device=dev)
    out = torch.empty_like(x)
    code = _build.load_library().vmg_morphfc_combine(
        x.data_ptr(), h.data_ptr(), w.data_ptr(), c.data_ptr(), a.data_ptr(),
        pk.data_ptr(), pb.data_ptr(), _build.ptr(residual), out.data_ptr(),
        N, H * W, C, float(res_scale), _GATES[act], _build.DTYPE_CODES[dt],
        _build.stream_of(x))
    _build.check(code, "vmg_morphfc_combine")
    fused_morphfc_combine.launches += 1
    return out


fused_morphfc_combine.launches = 0
