"""Mixed precision (``vmg_tpu/train/precision.py``): float32 master
weights, bf16 compute, float32 flow.

The optimizer keeps the master parameters in float32.  The forward and
backward run on a compute copy whose float parameters are bf16, except
the SPyNet subtree (flow fields feed sampling coordinates, where bf16
rounding moves samples).  The copy's bf16 gradients are upcast to float32
for the update -- what the JAX package's cast-on-use gets from the cast's
VJP -- and the updated masters are cast back into the copy after each
step.  A separate copy, rather than a cast inside the forward, keeps the
recomputation of checkpointed blocks on the same bf16 weights.
"""

from __future__ import annotations

import copy
from typing import List

import torch

from vmg_tpu_torch.models.vmg import cast_for_compute


def compute_model(master: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """The model the forward runs: ``master`` itself for float32, else a
    copy in ``dtype`` with SPyNet kept float32."""
    if dtype == torch.float32:
        return master
    return cast_for_compute(copy.deepcopy(master), dtype)


@torch.no_grad()
def sync_compute(master: torch.nn.Module, compute: torch.nn.Module) -> None:
    """Cast the master parameters into the compute copy."""
    if compute is master:
        return
    for p, c in zip(master.parameters(), compute.parameters()):
        c.copy_(p)


def float32_grads(compute: torch.nn.Module) -> List[torch.Tensor]:
    """The compute copy's gradients upcast to float32, in parameter order
    (zeros for a parameter the loss did not reach)."""
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if p.grad is None else p.grad.float() for p in compute.parameters()]
