"""SPyNet optical flow (``vmg_tpu/models/spynet.py``).

Six-level coarse-to-fine pyramid; each level refines an upsampled flow
with a 5-layer 7x7 conv stack over [ref, warp(supp, flow), flow].  Flow
arithmetic (upsampling, the residual add, warp coordinates) stays float32
whatever the model dtype; SPyNet's parameters stay float32 too.  With
``fast_flow`` the basic-module convolutions and the image pyramids run in
bf16, the serving setting of the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from vmg_tpu_torch.ops.resize import avg_pool2d, resize_bilinear
from vmg_tpu_torch.ops.warp import flow_warp

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class _ConvModule(nn.Module):
    def __init__(self, cin, cout, device=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 7, padding=3, device=device)


class SPyNetBasicModule(nn.Module):
    """conv(8->32->64->32->16->2), k=7, ReLU between (none after last)."""

    def __init__(self, device=None):
        super().__init__()
        widths = (8, 32, 64, 32, 16, 2)
        self.basic_module = nn.ModuleList(
            _ConvModule(widths[i], widths[i + 1], device)
            for i in range(len(widths) - 1))

    def forward(self, x: torch.Tensor, fast: bool) -> torch.Tensor:
        """x (N, H, W, 8) -> flow residual (N, H, W, 2) f32."""
        y = x.permute(0, 3, 1, 2)
        dt = torch.bfloat16 if fast else torch.float32
        y = y.to(dt)
        for i, m in enumerate(self.basic_module):
            y = F.conv2d(y, m.conv.weight.to(dt), m.conv.bias.to(dt), padding=3)
            if i < len(self.basic_module) - 1:
                y = F.relu(y)
        return y.permute(0, 2, 3, 1).float()


class SPyNet(nn.Module):
    """Flow from ref -> supp for (N, H, W, 3) RGB in [0, 1]; six levels."""

    def __init__(self, fast_flow: bool = False, device=None):
        super().__init__()
        self.fast_flow = fast_flow
        self.basic_module = nn.ModuleList(
            SPyNetBasicModule(device) for _ in range(6))

    def compute_flow(self, ref, supp):
        n, h, w, _ = ref.shape
        mean = torch.tensor(_MEAN, dtype=torch.float32, device=ref.device)
        std = torch.tensor(_STD, dtype=torch.float32, device=ref.device)
        refs = [(ref.float() - mean) / std]
        supps = [(supp.float() - mean) / std]
        for _ in range(len(self.basic_module) - 1):
            refs.append(avg_pool2d(refs[-1], 2))
            supps.append(avg_pool2d(supps[-1], 2))
        refs, supps = refs[::-1], supps[::-1]
        if self.fast_flow:
            refs = [r.to(torch.bfloat16) for r in refs]
            supps = [s.to(torch.bfloat16) for s in supps]

        flow = torch.zeros((n, h // 32, w // 32, 2), dtype=torch.float32,
                           device=ref.device)
        for level, module in enumerate(self.basic_module):
            if level == 0:
                flow_up = flow
            else:
                lh, lw = refs[level].shape[1:3]
                flow_up = resize_bilinear(flow, lh, lw, align_corners=True) * 2.0
            warped = flow_warp(supps[level], flow_up, padding_mode="border")
            feats = [refs[level], warped, flow_up]
            if self.fast_flow:
                feats = [f.to(torch.bfloat16) for f in feats]
            flow = flow_up + module(torch.cat(feats, dim=-1), self.fast_flow)
        return flow

    def forward(self, ref, supp):
        h, w = ref.shape[1:3]
        w_up = w if w % 32 == 0 else 32 * (w // 32 + 1)
        h_up = h if h % 32 == 0 else 32 * (h // 32 + 1)
        ref_r = resize_bilinear(ref, h_up, w_up, align_corners=False)
        supp_r = resize_bilinear(supp, h_up, w_up, align_corners=False)
        flow = self.compute_flow(ref_r, supp_r)
        flow = resize_bilinear(flow, h, w, align_corners=False)
        return flow * torch.tensor([w / w_up, h / h_up], dtype=torch.float32,
                                   device=flow.device)
