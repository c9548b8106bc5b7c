"""Multi-process helpers (``vmg_tpu/parallel/multihost.py``; they replace
the reference's evaluation-result collection through a temporary
directory or ``dist.all_gather``, ``mmedit/apis/test.py:128-228``, and its
torchrun bootstrap)."""

from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist


def initialize_distributed(backend: str | None = None, **kwargs) -> None:
    """Join the process group once per process, before any collective:
    ``torch.distributed.init_process_group`` from the usual environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) unless
    ``kwargs`` say otherwise (``init_method``, ``world_size``, ``rank``).
    ``backend``: NCCL where a card is visible, else gloo.  With NCCL the
    process takes card ``LOCAL_RANK`` (default 0)."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, **kwargs)


def _device() -> torch.device:
    """Where the group's collectives take their tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_host_values(values: Sequence[float]) -> np.ndarray:
    """Every process's metric vector on every process: (processes,
    len(values)) float32 (replaces collect_results_cpu).  ``values``: this
    process's metric list, as long on every process."""
    t = torch.as_tensor(np.asarray(values, np.float32), device=_device())
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def broadcast_from_host0(tree: Any) -> Any:
    """Process 0's value of ``tree`` (any picklable structure: nested dicts
    of arrays, tensors, numbers), made authoritative on every process, e.g.
    after a host-side checkpoint load."""
    obj = [tree]
    dist.broadcast_object_list(obj, src=0, device=_device())
    return obj[0]


def _equal(a: Any, b: Any) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
        b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def assert_same_across_hosts(x: Any, name: str = "value") -> None:
    """Raise on every process unless ``x`` equals process 0's on every
    process."""
    same = _equal(x, broadcast_from_host0(x))
    ok = torch.tensor([1.0 if same else 0.0], device=_device())
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    if ok.item() != 1.0:
        raise AssertionError(f"{name} differs across hosts")
