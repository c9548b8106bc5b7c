"""Training hooks (``vmg_tpu/edit/hooks.py``; reference
``mmedit/core/evaluation/eval_hooks.py`` EvalIterHook and
``mmedit/core/hooks/visualization.py``).

``after_iter`` is called with (step, state, extras) after every training
step; each hook decides when to fire.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np

from vmg_tpu_torch.eval.png import write_png


def tensor2img(tensor, out_type=np.uint8, min_max=(0.0, 1.0)) -> np.ndarray:
    """An (..., H, W, C) RGB image in ``min_max`` -> (H, W, C) RGB, clipped,
    uint8 by rounding (``vmg_tpu/edit/misc.py``'s, without its swap to BGR
    for cv2: :func:`write_png` takes RGB)."""
    arr = np.asarray(tensor, dtype=np.float64)
    while arr.ndim > 3:
        arr = arr[0]
    lo, hi = min_max
    arr = np.clip((arr - lo) / (hi - lo), 0.0, 1.0)
    if out_type == np.uint8:
        return (arr * 255.0).round().astype(np.uint8)
    return arr.astype(out_type)


class Hook:
    def after_iter(self, step: int, state, extras: Dict):  # pragma: no cover
        pass


class HookList(Hook):
    def __init__(self, hooks: List[Hook]):
        self.hooks = list(hooks)

    def after_iter(self, step, state, extras):
        for h in self.hooks:
            h.after_iter(step, state, extras)


class EvalIterHook(Hook):
    """Run ``eval_fn(state)`` every ``interval`` steps and keep its latest
    results (reference eval_hooks.py:7-60)."""

    def __init__(self, eval_fn: Callable[[object], Dict], interval: int = 5000, logger=None):
        self.eval_fn = eval_fn
        self.interval = interval
        self.logger = logger
        self.latest: Optional[Dict] = None

    def after_iter(self, step, state, extras):
        if step % self.interval:
            return
        self.latest = self.eval_fn(state)
        if self.logger:
            msg = ", ".join(f"{k}: {v:.4f}" for k, v in self.latest.items())
            self.logger.info(f"[eval @ {step}] {msg}")


class VisualizationHook(Hook):
    """Every ``interval`` steps, write the ``keys`` images of ``extras``
    (lq / output / gt) as ``iter_<step>_<key>.png`` (reference
    visualization.py:11)."""

    def __init__(self, output_dir: str, interval: int = 1000, keys=("lq", "output", "gt")):
        self.output_dir = output_dir
        self.interval = interval
        self.keys = keys

    def after_iter(self, step, state, extras):
        if step % self.interval:
            return
        os.makedirs(self.output_dir, exist_ok=True)
        for k in self.keys:
            if k in extras:
                write_png(os.path.join(self.output_dir, f"iter_{step:08d}_{k}.png"),
                          tensor2img(np.asarray(extras[k])))
