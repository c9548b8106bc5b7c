"""JAX parameter tree -> the port's ``state_dict``.

The port's module attribute names are the reference (PyTorch) state-dict
keys, so a ``vmg_tpu`` param tree maps onto it by the export rules of
``vmg_tpu/ckpt/torch_convert.py`` (``export_torch_state_dict``):

  * Dense kernel (in, out)      -> Linear weight (out, in)
  * Conv kernel HWIO            -> Conv2d weight OIHW
  * LayerNorm/GroupNorm scale   -> weight

That file uses only ``re`` and ``numpy``; it is loaded by path, because
importing the ``vmg_tpu.ckpt`` package pulls in orbax.  MorphFC axis
weights load undecayed: the port folds the decay in at use time, as the
JAX package does.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, Mapping

import numpy as np
import torch

_CONVERT = Path(__file__).resolve().parent.parent / "vmg_tpu" / "ckpt" / "torch_convert.py"


def _torch_convert():
    spec = importlib.util.spec_from_file_location("_vmg_torch_convert", _CONVERT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def state_dict_from_jax(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX param tree (nested dict of arrays, optionally under 'params') ->
    reference-named float32 state dict of the port (RCAB channel mixer,
    non-linear axis FCs: the slice's settings).  ``prefix`` keeps only the
    keys under it and strips it (a sub-module's state dict, e.g.
    ``"encoder_layers.0."``)."""
    sd = _torch_convert().export_torch_state_dict(params, channel_mixer="rcab")
    return {k[len(prefix):]: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items() if k.startswith(prefix)}
