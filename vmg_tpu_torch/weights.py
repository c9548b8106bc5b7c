"""JAX parameter tree -> the port's ``state_dict``.

The port's module attribute names are the reference (PyTorch) state-dict
keys, so a ``vmg_tpu`` param tree (nested dicts of arrays, flax paths)
maps onto it by the reference export rules, for the slice's settings
(RCAB channel mixer, non-linear axis FCs):

  * Dense kernel (in, out)      -> Linear weight (out, in)
  * Conv kernel HWIO            -> Conv2d weight OIHW
  * LayerNorm/GroupNorm scale   -> weight

The rules are this module's own copy; it reads nothing of the JAX
package.  MorphFC axis weights load undecayed: the port folds the decay
in at use time, as the JAX package does.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

# (flax path regex, state-dict template); {wb} is "weight" or "bias" by the
# flax leaf name ("scale"/"kernel" -> weight)
_STAGE_RULES = [
    (r"^mlp_blocks(\d+)/norm([23])/(scale|bias)$", r"mlp_blocks.\1.norm\2.{wb}"),
    (r"^mlp_blocks(\d+)/spatial_mixing/mlp_([hw])/(kernel|bias)$",
     r"mlp_blocks.\1.spatial_mixing.mlp_\2.0.{wb}"),
    (r"^mlp_blocks(\d+)/spatial_mixing/mlp_c/body([01])/(kernel|bias)$",
     lambda m: f"mlp_blocks.{m.group(1)}.spatial_mixing.mlp_c.body.{int(m.group(2)) * 2}.{{wb}}"),
    (r"^mlp_blocks(\d+)/spatial_mixing/mlp_c/ca/conv_du([01])/(kernel|bias)$",
     lambda m: (f"mlp_blocks.{m.group(1)}.spatial_mixing.mlp_c.body.3.conv_du."
                f"{int(m.group(2)) * 2}.{{wb}}")),
    (r"^mlp_blocks(\d+)/spatial_mixing/reweight/(fc[12])/(kernel|bias)$",
     r"mlp_blocks.\1.spatial_mixing.reweight.\2.{wb}"),
    (r"^mlp_blocks(\d+)/spatial_mixing/proj/(kernel|bias)$",
     r"mlp_blocks.\1.spatial_mixing.proj.{wb}"),
    (r"^mlp_blocks(\d+)/channel_mixing/(fc1|fc2)/(kernel|bias)$",
     r"mlp_blocks.\1.channel_mixing.\2.{wb}"),
    (r"^local_cnn/(kernel|bias)$", r"local_cnn.{wb}"),
    (r"^traj_mixing/step/resblocks/conv_in/(kernel|bias)$",
     r"traj_mixing.resblocks.main.0.{wb}"),
    (r"^traj_mixing/step/resblocks/block(\d+)/conv([12])/(kernel|bias)$",
     r"traj_mixing.resblocks.main.2.\1.conv\2.{wb}"),
    (r"^traj_mixing/fusion/(kernel|bias)$", r"traj_mixing.fusion.{wb}"),
    (r"^traj_mixing/step/LTAM/proj/(kernel|bias)$", r"traj_mixing.LTAM.proj.{wb}"),
    (r"^traj_mixing/step/LTAM/relative_pos_encoding$",
     r"traj_mixing.LTAM.relative_pos_encoding"),
]
_TOP_RULES = [
    (r"^spynet/basic_module(\d+)/conv(\d+)/(kernel|bias)$",
     r"spynet.basic_module.\1.basic_module.\2.conv.{wb}"),
    (r"^input_proj/proj/(kernel|bias)$", r"input_proj.proj.0.{wb}"),
    (r"^(downsample|upsample)(\d+)/norm/(scale|bias)$", r"\1.\2.norm.{wb}"),
    (r"^(downsample|upsample)(\d+)/linear/(kernel|bias)$", r"\1.\2.linear.{wb}"),
    (r"^local_cnn/(kernel|bias)$", r"local_cnn.{wb}"),
    (r"^sc_(64_16|32_8)_conv/(kernel|bias)$", r"sc_\1.0.{wb}"),
    (r"^sc_(64_16|32_8)_gn/(scale|bias)$", r"sc_\1.1.{wb}"),
    (r"^(upconv1|upconv2|HRconv|conv_last)/(kernel|bias)$", r"\1.{wb}"),
]


def _apply(path: str, rules):
    for pat, tmpl in rules:
        m = re.match(pat, path)
        if m:
            out = tmpl(m) if callable(tmpl) else m.expand(tmpl)
            return out.replace("{wb}", "bias" if path.endswith("bias") else "weight")
    return None


def _state_name(path: str) -> str:
    name = _apply(path, _TOP_RULES)
    if name is None:
        m = re.match(r"^(encoder|decoder)_layers(\d+)/(.+)$", path)
        sub = _apply(m.group(3), _STAGE_RULES) if m else None
        if sub is not None:
            name = f"{m.group(1)}_layers.{m.group(2)}.{sub}"
    if name is None:
        raise KeyError(f"no export rule for flax param {path}")
    return name


def _flatten(node, path, out):
    for k, v in node.items():
        p = path + [k]
        if isinstance(v, Mapping):
            _flatten(v, p, out)
        else:
            out["/".join(p)] = np.array(v, dtype=np.float32)


def state_dict_from_jax(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX param tree (nested dict of arrays, optionally under 'params') ->
    reference-named float32 state dict of the port.  ``prefix`` keeps only
    the keys under it and strips it (a sub-module's state dict, e.g.
    ``"encoder_layers.0."``)."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(params.get("params", params), [], flat)
    sd = {}
    for path, v in flat.items():
        name = _state_name(path)
        if not name.startswith(prefix):
            continue
        if path.endswith("/kernel"):
            if v.ndim == 4:  # conv HWIO -> OIHW
                v = v.transpose(3, 2, 0, 1)
            elif v.ndim == 2:  # dense (in, out) -> (out, in)
                v = v.T
        sd[name[len(prefix):]] = torch.from_numpy(np.ascontiguousarray(v))
    return sd
