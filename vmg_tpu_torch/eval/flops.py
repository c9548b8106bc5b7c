"""FLOP and cost accounting (``vmg_tpu/eval/flops.py``; the reference's
thop / fvcore counters, ``tools/Tester.py:447-457``).

The JAX package reads XLA's compiled cost analysis, whose ``flops`` also
counts elementwise work.  Here the count is PyTorch's ``FlopCounterMode``:
2 x the multiply-adds of every convolution and matrix product, and of every
``vmg::`` hand-kernel operator by its formula (``utils/profiling.py``), so
the kernel and its plain version count alike.  Elementwise work, resizes,
pools and warps count nothing.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import torch

from vmg_tpu_torch.utils.profiling import compiled_stats, register_vmg_flops


def cost_analysis(fn, *example_args) -> Dict[str, Any]:
    """{"flops", "bytes accessed", "peak_memory_bytes"} of one call of
    ``fn(*example_args)`` (``utils.profiling.compiled_stats``; the call
    runs)."""
    return compiled_stats(fn, *example_args)


@torch.no_grad()
def model_flops(model, x) -> float:
    """The forward FLOPs of ``model(x)``, counted on fake tensors of a copy
    of the model on the meta device and of ``x``'s shape: nothing is
    computed, so a full-size model counts in seconds on the CPU, and
    nothing the count makes (a cache of a module) reaches ``model``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    register_vmg_flops()
    meta = model if all(p.is_meta for p in model.parameters()) else \
        copy.deepcopy(model).to("meta")
    counter = FlopCounterMode(display=False)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fx = mode.from_tensor(x.to("meta"))
        with counter:
            meta(fx)
    return float(counter.get_total_flops())
