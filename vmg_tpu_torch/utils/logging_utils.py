"""Logging and running averages (port of ``vmg_tpu/utils/logging_utils.py``,
the reference's ``utils/logger.py`` and ``utils/average_meter.py``)."""

from __future__ import annotations

import logging
import os
import sys
import time


def setup_logger(name: str = "base", root: str = ".", phase: str = "train"):
    """An INFO logger writing to ``root/<phase>_<time>.log`` and stdout; a
    logger of this name that already has handlers is returned as it is."""
    logger = logging.getLogger(name)
    logger.propagate = False
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
                            "%y-%m-%d %H:%M:%S")
    logger.setLevel(logging.INFO)
    os.makedirs(root, exist_ok=True)
    for handler in (logging.FileHandler(os.path.join(root, f"{phase}_{int(time.time())}.log"),
                                        mode="w"), logging.StreamHandler(sys.stdout)):
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    return logger


class AverageMeter:
    """Weighted running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n

    def average(self):
        return self.sum / self.count if self.count else 0.0
