"""Host utilities (``vmg_tpu/utils/misc.py``; reference ``utils/misc.py``)."""

from __future__ import annotations

import os
import random
import time

import numpy as np
import torch


def set_random_seed(seed: int):
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def mkdir_and_rename(path: str):
    """Archive an existing directory under a timestamp suffix, then create
    it afresh (reference utils/misc.py:30-36)."""
    if os.path.exists(path):
        os.rename(path, path + "_archived_" + time.strftime("%Y%m%d-%H%M%S"))
    os.makedirs(path, exist_ok=True)


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
