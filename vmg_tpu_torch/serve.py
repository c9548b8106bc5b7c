"""Forward server for the serving configuration.

:class:`SRServer` answers clip requests with the contract of
``vmg_tpu.eval.inference.SlidingEvaluator.forward_fn``: a numpy float32
``(1, T, h, w, 3)`` RGB clip in [0, 1] in, ``(1, T, 4h, 4w, 3)`` float32
out.  The model runs on ``device`` (the card unless the caller passes
"cpu") in ``dtype`` (bf16 by default, SPyNet float32) with
the serving fast-math of the JAX package's bench protocol: tanh GELU and
bf16 SPyNet convolutions.  ``rcab_impl``, ``traj_conv_impl`` and
``norm_impl`` select the JAX package's opt-in kernel forms (module forms
by default; see ``vmg_tpu_torch.models.vmg``).  ``flow_levels``, if given,
replaces the config's: ``'shared'`` runs SPyNet at the finest level only
and pools its flow down to the coarser ones.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from vmg_tpu_torch.configs import VMGNetworkConfig
from vmg_tpu_torch.models.vmg import VMG, cast_for_compute


class SRServer:
    def __init__(self, cfg: VMGNetworkConfig, state_dict: Mapping[str, torch.Tensor],
                 device="cuda", dtype: torch.dtype = torch.bfloat16, *,
                 gelu: str = "tanh", fast_flow: bool = True, rcab_impl: str = "module",
                 traj_conv_impl: str = "module", norm_impl: str = "module",
                 flow_levels: str | None = None):
        if flow_levels is not None:
            cfg = dataclasses.replace(cfg, flow_levels=flow_levels)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SRServer: no CUDA device visible; pass "
                               "device='cpu' to serve on the CPU")
        model = VMG(cfg, gelu=gelu, fast_flow=fast_flow, rcab_impl=rcab_impl,
                    traj_conv_impl=traj_conv_impl, norm_impl=norm_impl,
                    device=self.device)
        model.load_state_dict(state_dict, strict=True)
        model = cast_for_compute(model, dtype).eval()
        # conv weights in channels-last, the layout every conv here sees
        self.model = model.to(memory_format=torch.channels_last)

    @torch.inference_mode()
    def __call__(self, clip: np.ndarray) -> np.ndarray:
        if clip.ndim != 5 or clip.shape[0] != 1 or clip.shape[-1] != 3:
            raise ValueError(f"expected a (1, T, h, w, 3) clip, got {clip.shape}")
        x = torch.from_numpy(np.ascontiguousarray(clip, dtype=np.float32))
        y = self.model(x.to(self.device))
        return y.cpu().numpy()
