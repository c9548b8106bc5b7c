"""Reference (PyTorch) checkpoints -> the port's ``state_dict``, and back.

Port of ``vmg_tpu/ckpt/torch_convert.py`` (its own copy of the
rules: the port reads nothing of the JAX package).  The reference can
save three containers ('mine', 'ST', 'KAIR'; :func:`normalize_torch_checkpoint`)
and DataParallel ``module.`` prefixes.  :func:`convert_torch_state_dict`
maps the reference keys onto the JAX package's param tree with the same
rules and layout transforms as the JAX converter (Linear (out, in) ->
kernel (in, out), Conv2d OIHW -> HWIO, norm weight -> scale; buffers --
SPyNet mean/std, LTAM decay_v, MorphFC gamma_* -- dropped, as constants
recomputed here); :func:`reference_state_dict` composes it with
:func:`vmg_tpu_torch.weights.state_dict_from_jax`, so a user's ``.pth``
reaches the port exactly as the JAX converter followed by
``state_dict_from_jax`` would bring it.  The other way,
:func:`export_torch_state_dict` writes the port's weights under the
reference's names and layouts (:func:`save_reference_checkpoint` as a
``.pth``), which the reference tester -- and this module's loader -- read
back exactly.  :func:`remap_ttvsr_pretrain` is the reference's TTVSR
partial-pretraining key surgery, :func:`verify_against` a diagnostic.

MorphFC decay: the reference multiplies ``mlp_h``/``mlp_w`` by the decay
matrix in place at every forward, so its checkpoint holds decayed
weights; loading them verbatim and applying the decay once at use time
(as the port does) reproduces the forward the reference computes next.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np


def normalize_torch_checkpoint(ckpt: Mapping, source: str = "mine") -> Dict:
    """Unwrap the three checkpoint containers the reference tester accepts
    (``tools/Tester.py:311-373``): 'mine' = plain state_dict (opt. with
    'module.' prefixes), 'ST' = {'state_dict': {'generator.<k>': v}},
    'KAIR' = {'params': {...}}."""
    if source == "mine":
        sd = ckpt.get("state_dict", ckpt)
        return strip_module_prefix(sd)
    if source == "ST":
        sd = ckpt["state_dict"]
        return {k[len("generator."):]: v for k, v in sd.items()
                if k.startswith("generator.")}
    if source == "KAIR":
        return dict(ckpt["params"])
    raise ValueError(f"unknown checkpoint source {source!r}")


def strip_module_prefix(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop a leading 'module.' (DataParallel wrap)."""
    out = {}
    for k, v in sd.items():
        out[k[7:] if k.startswith("module.") else k] = v
    return out


_SKIP = re.compile(
    r"(^|\.)(mean|std)$|\.decay_v$|\.gamma_h$|\.gamma_w$|relative_position_index$"
)

# (torch regex, flax path template). Applied to the *suffix* after the
# encoder/decoder layer prefix has been handled; \gN substitute groups.
_STAGE_RULES = [
    (r"^mlp_blocks\.(\d+)\.norm([23])\.(weight|bias)$",
     r"mlp_blocks\1/norm\2/{wb}"),
    (r"^mlp_blocks\.(\d+)\.spatial_mixing\.mlp_([hw])(?:\.0)?\.(weight|bias)$",
     r"mlp_blocks\1/spatial_mixing/mlp_\2/{kb}"),
    (r"^mlp_blocks\.(\d+)\.spatial_mixing\.mlp_c(?:\.0)?\.(weight|bias)$",
     r"mlp_blocks\1/spatial_mixing/mlp_c/{kb}"),
    (r"^mlp_blocks\.(\d+)\.spatial_mixing\.mlp_c\.body\.0\.(weight|bias)$",
     r"mlp_blocks\1/spatial_mixing/mlp_c/body0/{kb}"),
    (r"^mlp_blocks\.(\d+)\.spatial_mixing\.mlp_c\.body\.2\.(weight|bias)$",
     r"mlp_blocks\1/spatial_mixing/mlp_c/body1/{kb}"),
    (r"^mlp_blocks\.(\d+)\.spatial_mixing\.mlp_c\.body\.3\.conv_du\.0\.(weight|bias)$",
     r"mlp_blocks\1/spatial_mixing/mlp_c/ca/conv_du0/{kb}"),
    (r"^mlp_blocks\.(\d+)\.spatial_mixing\.mlp_c\.body\.3\.conv_du\.2\.(weight|bias)$",
     r"mlp_blocks\1/spatial_mixing/mlp_c/ca/conv_du1/{kb}"),
    (r"^mlp_blocks\.(\d+)\.spatial_mixing\.scale_([hwc])\.weight$",
     r"mlp_blocks\1/spatial_mixing/scale_\2/scale"),
    (r"^mlp_blocks\.(\d+)\.spatial_mixing\.reweight\.(fc[12])\.(weight|bias)$",
     r"mlp_blocks\1/spatial_mixing/reweight/\2/{kb}"),
    (r"^mlp_blocks\.(\d+)\.spatial_mixing\.proj\.(weight|bias)$",
     r"mlp_blocks\1/spatial_mixing/proj/{kb}"),
    (r"^mlp_blocks\.(\d+)\.spatial_mixing\.gating_fc\.(weight|bias)$",
     r"mlp_blocks\1/spatial_mixing/gating_fc/{kb}"),
    (r"^mlp_blocks\.(\d+)\.channel_mixing\.(fc1|fc2|fc3|fc11|fc12|fc|proj)\.(weight|bias)$",
     r"mlp_blocks\1/channel_mixing/\2/{kb}"),
    (r"^mlp_blocks\.(\d+)\.channel_mixing\.fc2_multi\.(\d+)\.(weight|bias)$",
     r"mlp_blocks\1/channel_mixing/fc2_multi\2/{kb}"),
    (r"^mlp_blocks\.(\d+)\.channel_mixing\.reweight\.(fc[12])\.(weight|bias)$",
     r"mlp_blocks\1/channel_mixing/reweight/\2/{kb}"),
    (r"^local_cnn\.(weight|bias)$", r"local_cnn/{kb}"),
    # trajectory tail
    (r"^traj_mixing\.resblocks\.main\.0\.(weight|bias)$",
     r"traj_mixing/step/resblocks/conv_in/{kb}"),
    (r"^traj_mixing\.resblocks\.main\.2\.(\d+)\.conv([12])\.(weight|bias)$",
     r"traj_mixing/step/resblocks/block\1/conv\2/{kb}"),
    (r"^traj_mixing\.fusion\.(weight|bias)$", r"traj_mixing/fusion/{kb}"),
    (r"^traj_mixing\.LTAM\.proj\.(weight|bias)$",
     r"traj_mixing/step/LTAM/proj/{kb}"),
    (r"^traj_mixing\.LTAM\.fusion\.(weight|bias)$",  # en_field s1/s2/s3 fuse
     r"traj_mixing/step/LTAM/fusion/{kb}"),
    (r"^traj_mixing\.LTAM\.relative_pos_encoding$",
     r"traj_mixing/step/LTAM/relative_pos_encoding"),
    # swin3d tail
    (r"^traj_mixing\.blocks\.(\d+)\.norm([12])\.(weight|bias)$",
     r"traj_mixing/blocks\1/norm\2/{wb}"),
    (r"^traj_mixing\.blocks\.(\d+)\.(attn1?)\.relative_position_bias_table$",
     r"traj_mixing/blocks\1/\2/relative_position_bias_table"),
    (r"^traj_mixing\.blocks\.(\d+)\.(attn1?)\.(q|kv|proj)\.(weight|bias)$",
     r"traj_mixing/blocks\1/\2/\3/{kb}"),
    (r"^traj_mixing\.blocks\.(\d+)\.proj\.(weight|bias)$",
     r"traj_mixing/blocks\1/proj/{kb}"),  # unfold-KV 2C->C fuse
    (r"^traj_mixing\.blocks\.(\d+)\.mlp\.(fc1|fc2)\.(weight|bias)$",
     r"traj_mixing/blocks\1/mlp/\2/{kb}"),
    # DCN alignment tail
    (r"^pa_deform\.weight$", r"pa_deform/weight"),
    (r"^pa_deform\.bias$", r"pa_deform/bias"),
    (r"^pa_deform\.conv_offset\.([0246])\.(weight|bias)$",
     lambda m: f"pa_deform/conv_offset{int(m.group(1)) // 2}/" + "{kb}"),
    (r"^pa_fuse\.main\.0\.(weight|bias)$", r"pa_fuse/conv_in/{kb}"),
    (r"^pa_fuse\.main\.2\.(\d+)\.conv([12])\.(weight|bias)$",
     r"pa_fuse/block\1/conv\2/{kb}"),
]

_TOP_RULES = [
    (r"^spynet\.basic_module\.(\d+)\.basic_module\.(\d+)\.conv\.(weight|bias)$",
     r"spynet/basic_module\1/conv\2/{kb}"),
    (r"^input_proj\.proj\.0\.(weight|bias)$", r"input_proj/proj/{kb}"),
    (r"^(downsample|upsample)\.(\d+)\.norm\.(weight|bias)$", r"\1\2/norm/{wb}"),
    (r"^(downsample|upsample)\.(\d+)\.linear\.(weight|bias)$", r"\1\2/linear/{kb}"),
    (r"^local_cnn\.(weight|bias)$", r"local_cnn/{kb}"),
    (r"^sc_(64_16|32_8)\.0\.(weight|bias)$", r"sc_\1_conv/{kb}"),
    (r"^sc_(64_16|32_8)\.1\.(weight|bias)$", r"sc_\1_gn/{wb}"),
    (r"^reduce([012])\.(weight|bias)$", r"reduce\1/{kb}"),
    (r"^recon_trunk\.(\d+)\.conv([12])\.(weight|bias)$",
     r"recon_trunk\1_conv\2/{kb}"),
    (r"^(upconv1|upconv2|HRconv|conv_last)\.(weight|bias)$", r"\1/{kb}"),
]


def _transform_value(flax_path: str, v: np.ndarray) -> np.ndarray:
    leaf = flax_path.rsplit("/", 1)[-1]
    if leaf == "kernel" or flax_path.endswith("pa_deform/weight"):
        if v.ndim == 4:  # conv OIHW -> HWIO
            return np.transpose(v, (2, 3, 1, 0))
        if v.ndim == 2:  # linear (out, in) -> (in, out)
            return np.transpose(v)
    return v


def _apply_rules(key: str, rules) -> str | None:
    for pat, tmpl in rules:
        m = re.match(pat, key)
        if m:
            out = tmpl(m) if callable(tmpl) else m.expand(tmpl)
            wb = "bias" if key.endswith("bias") else "scale"
            kb = "bias" if key.endswith("bias") else "kernel"
            return out.replace("{wb}", wb).replace("{kb}", kb)
    return None


def convert_torch_state_dict(
    sd: Mapping[str, "np.ndarray"], strict: bool = True
) -> Dict:
    """Full-model state_dict -> nested flax params dict {'params': ...}."""
    sd = strip_module_prefix({k: _np(v) for k, v in sd.items()})
    tree: Dict = {}
    unmatched = []
    for key, val in sd.items():
        if _SKIP.search(key):
            continue
        path = _apply_rules(key, _TOP_RULES)
        if path is None:
            m = re.match(r"^(encoder|decoder)_layers\.(\d+)\.(.+)$", key)
            if m:
                sub = _apply_rules(m.group(3), _STAGE_RULES)
                if sub is not None:
                    path = f"{m.group(1)}_layers{m.group(2)}/{sub}"
        if path is None:
            unmatched.append(key)
            continue
        _insert(tree, path, _transform_value(path, val))
    if unmatched and strict:
        raise KeyError(f"unmapped torch keys: {unmatched[:10]}"
                       f"{'...' if len(unmatched) > 10 else ''}")
    return {"params": tree}


def convert_spynet_state_dict(sd: Mapping[str, "np.ndarray"]) -> Dict:
    """OpenMMLab SPyNet checkpoint -> params for vmg_tpu.models.SPyNet."""
    sd = strip_module_prefix({k: _np(v) for k, v in sd.items()})
    if "state_dict" in sd:
        sd = sd["state_dict"]
    tree: Dict = {}
    for key, val in sd.items():
        if _SKIP.search(key):
            continue
        m = re.match(
            r"^basic_module\.(\d+)\.basic_module\.(\d+)\.conv\.(weight|bias)$", key
        )
        if not m:
            continue
        kb = "bias" if key.endswith("bias") else "kernel"
        path = f"basic_module{m.group(1)}/conv{m.group(2)}/{kb}"
        _insert(tree, path, _transform_value(path, val))
    return {"params": tree}


def _np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu()
        return (v.float() if v.is_floating_point() else v).numpy()
    return np.asarray(v)


def _insert(tree: Dict, path: str, value: np.ndarray):
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def remap_ttvsr_pretrain(
    sd: Mapping[str, "np.ndarray"], target_keys
) -> Dict[str, np.ndarray]:
    """TTVSR partial-pretraining key surgery (reference
    ``tools/Trainer.py:317-353`` load_model_with_pretraining).

    Given a TTVSR checkpoint state_dict, rename ``backbone.*`` ->
    ``align_t_down.*`` and keep only keys present in ``target_keys`` (the
    model's trajectory-alignment params, ``Trainer.py:36-44``); for stage-2
    entries the source sub-index remaps 0->4 / 1->5, and every accepted
    key is duplicated to the mirror ``align_t_up.*`` path.  Triggered in
    the reference when ``spynet is None`` and a pretrain_model is set
    (``Trainer.py:35,228``).

    The reference's VMG has no ``align_t_*`` modules, so against its
    models ``target_keys`` is empty and this returns {} -- the reference's
    runtime behaviour.  The surgery is kept for checkpoints of the older
    TTVSR-derived architecture.
    """
    sd = strip_module_prefix({k: _np(v) for k, v in sd.items()})
    if "state_dict" in sd:
        sd = sd["state_dict"]
    target = set(target_keys)
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if k.startswith("backbone"):
            k = k.replace("backbone", "align_t_down", 1)
        if k not in target:
            continue
        k_l = k.split(".")
        if len(k_l) > 4 and "2" in k_l[2]:
            if "0" in k_l[4]:
                k_l[4] = "4"
            elif "1" in k_l[4]:
                k_l[4] = "5"
            else:
                continue
            src = ".".join(k_l).replace("align_t_down", "backbone", 1)
            if src not in sd:
                continue
            v = sd[src]
            out[k] = v
            out[k.replace("align_t_down", "align_t_up", 1)] = v
        elif len(k_l) > 2 and ("0" in k_l[2] or "1" in k_l[2]):
            out[k] = v
            out[k.replace("align_t_down", "align_t_up", 1)] = v
        else:
            out[k] = v
    return out


def export_torch_state_dict(state_dict: Mapping, non_linear: bool = True,
                            channel_mixer: str = "rcab") -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` (any dtype, any device) -> the
    reference-named torch-style state dict as float32 numpy arrays, so
    models trained here can be consumed by the reference ecosystem (the
    JAX package's ``export_torch_state_dict`` of its param tree).  The
    port's parameter names and layouts are the reference's (Linear (out,
    in), Conv2d OIHW, norm weight), and its buffers (SPyNet mean / std,
    the MorphFC decay) are constants the reference recomputes, so the
    export is the parameters themselves; every key is checked against the
    loader's rules (a key no rule maps raises ``KeyError``: the MBConv
    mixer's, as in the JAX package), so :func:`reference_state_dict` reads
    the result back exactly.  ``non_linear`` and ``channel_mixer`` name the
    axis and channel FCs' key layout in the JAX export; the port's modules
    take that layout from the model's own switches, so the keys are written
    as they are, and a layout they contradict raises ``ValueError``."""
    out: Dict[str, np.ndarray] = {}
    for key, v in strip_module_prefix(state_dict).items():
        if _SKIP.search(key):
            continue
        m = re.search(r"\.spatial_mixing\.mlp_([hwc])(\.0)?\.(weight|bias)$", key)
        if m:
            wrapped = non_linear and (m.group(1) != "c" or channel_mixer != "rcab")
            if wrapped != bool(m.group(2)):
                raise ValueError(f"{key}: the key layout of non_linear={non_linear}, "
                                 f"channel_mixer={channel_mixer!r} does not match the model's")
        path = _apply_rules(key, _TOP_RULES)
        m = re.match(r"^(encoder|decoder)_layers\.(\d+)\.(.+)$", key)
        if path is None and m:
            path = _apply_rules(m.group(3), _STAGE_RULES)
        if path is None:
            raise KeyError(f"no export rule for the port's parameter {key}")
        out[key] = _np(v).astype(np.float32)
    return out


def save_reference_checkpoint(state_dict: Mapping, path: str) -> None:
    """Write :func:`export_torch_state_dict` of ``state_dict`` as a
    reference ('mine') ``.pth``: a plain dict of float32 CPU tensors."""
    import torch

    sd = export_torch_state_dict(state_dict)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


def verify_against(params, converted, prefix="") -> Tuple[list, list]:
    """Returns (missing_in_converted, shape_mismatches) for diagnostics:
    the leaves of the tree ``params`` (nested mappings, optionally under
    'params'; a flat state dict is a tree of depth one) that ``converted``
    lacks, and those whose shapes differ."""
    missing, bad = [], []

    def walk(p, c, pre):
        for k, v in p.items():
            if isinstance(v, Mapping):
                if k not in c:
                    missing.append(pre + k)
                else:
                    walk(v, c[k], pre + k + "/")
            else:
                if k not in c:
                    missing.append(pre + k)
                elif tuple(np.shape(c[k])) != tuple(np.shape(v)):
                    bad.append((pre + k, np.shape(c[k]), np.shape(v)))

    walk(params.get("params", params), converted.get("params", converted), prefix)
    return missing, bad


def load_reference_checkpoint(path: str, source: str = "mine"):
    """A reference checkpoint file -> its (unwrapped) state dict."""
    import torch

    return normalize_torch_checkpoint(torch.load(path, map_location="cpu", weights_only=True),
                                      source)


def reference_state_dict(sd: Mapping, strict: bool = True):
    """A reference state dict (any container unwrapped) -> the port's
    float32 ``state_dict``: :func:`convert_torch_state_dict`, then
    ``state_dict_from_jax``.  ``strict`` refuses keys no rule maps (a
    missing key is refused where the model loads it,
    ``load_state_dict(strict=True)``)."""
    from vmg_tpu_torch.weights import state_dict_from_jax

    return state_dict_from_jax(convert_torch_state_dict(sd, strict=strict))
