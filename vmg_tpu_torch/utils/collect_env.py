"""Runtime environment report (``vmg_tpu/utils/collect_env.py``; reference
``mmedit/utils/collect_env.py``): Python, torch, CUDA and cuDNN, the
card's name and power limit, the library versions and the commit.

    python -m vmg_tpu_torch.utils.collect_env
"""

from __future__ import annotations

import os
import platform
import subprocess
import sys

import numpy as np
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(cmd) -> str | None:
    try:
        out = subprocess.run(cmd, cwd=_REPO, capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def collect_env() -> dict:
    info = {"sys.platform": sys.platform, "Python": sys.version.replace("\n", ""),
            "CPU": platform.processor() or platform.machine(),
            "git": (_run(["git", "rev-parse", "HEAD"]) or "unknown")[:7],
            "torch": torch.__version__, "numpy": np.__version__,
            "CUDA (torch build)": torch.version.cuda,
            "cuDNN": torch.backends.cudnn.version() if torch.backends.cudnn.is_available()
            else None,
            "CUDA available": torch.cuda.is_available()}
    if torch.cuda.is_available():
        info["GPUs"] = torch.cuda.device_count()
        info["GPU 0"] = torch.cuda.get_device_name(0)
        info["nvidia-smi name, power.limit"] = _run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    for var in ("CUDA_VISIBLE_DEVICES", "CUDA_HOME", "OMP_NUM_THREADS"):
        if os.environ.get(var):
            info[var] = os.environ[var]
    return info


if __name__ == "__main__":
    for name, val in collect_env().items():
        print(f"{name}: {val}")
