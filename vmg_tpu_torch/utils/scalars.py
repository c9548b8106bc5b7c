"""Scalar metrics sink (``vmg_tpu/utils/scalars.py``): a JSONL file, one
``{"step": N, ...}`` object a line, always; TensorBoard event files as
well where ``use_tb`` and ``torch.utils.tensorboard`` imports (reference
``tools/train.py:88-97,230-234``)."""

from __future__ import annotations

import json
import os
from typing import Optional


class ScalarLogger:
    def __init__(self, log_dir: str, use_tb: bool = False, jsonl_name: str = "scalars.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, jsonl_name), "a", buffering=1)
        self._tb = None
        if use_tb:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:  # tensorboard not installed: JSONL only
                self._tb = None

    @property
    def tb_active(self) -> bool:
        return self._tb is not None

    def log(self, step: int, **scalars: float) -> None:
        rec = {"step": int(step)}
        for k, v in scalars.items():
            if v is None:
                continue
            rec[k] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(k, float(v), int(step))
        self._jsonl.write(json.dumps(rec) + "\n")

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def make_scalar_logger(exp_root: str, use_tb: bool = False,
                       enabled: bool = True) -> Optional[ScalarLogger]:
    """The rank-0 sink under ``exp_root/tb_logger``; None when not ``enabled``."""
    if not enabled:
        return None
    return ScalarLogger(os.path.join(exp_root, "tb_logger"), use_tb=use_tb)
