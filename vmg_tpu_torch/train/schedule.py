"""Learning-rate schedules (``vmg_tpu/train/schedule.py``), plain functions
of the update count.

Cosine annealing with warm restarts, in closed form: within the period
that starts at restart r, with length T and weight w,

    lr(t) = eta_min + (base * w - eta_min) * (1 + cos(pi (t - r) / T)) / 2

Warmup scales the main group linearly below ``warmup_iter`` (the clean
form: update 0 is the smallest).  The SPyNet group is 0 while
``step <= flow_fix + 1``, then ``pre_lr_ratio`` times the main rate.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence


def cosine_annealing_restart(base_lr: float, T_period: Sequence[int],
                             restarts: Optional[Sequence[int]] = None,
                             restart_weights: Sequence[float] = (1.0,),
                             eta_min: float = 0.0):
    """Returns schedule(step) -> lr."""
    restarts = list(restarts) if restarts else [0]
    starts = [0] + [int(r) for r in restarts if r > 0]
    weights = [1.0] + [float(w) for w, r in zip(restart_weights, restarts) if r > 0]
    if len(starts) == 1:
        weights = [float(restart_weights[0])] if restart_weights else [1.0]
    periods = [int(t) for t in T_period]

    def schedule(step):
        idx = min(max(sum(step >= s for s in starts) - 1, 0), len(starts) - 1)
        cos = (1.0 + math.cos(math.pi * (step - starts[idx]) / periods[idx])) / 2.0
        return eta_min + (base_lr * weights[idx] - eta_min) * cos

    return schedule


def main_lr_schedule(train_cfg):
    """The main (and weight-decay) group's rate from a TrainConfig."""
    base = cosine_annealing_restart(train_cfg.lr, train_cfg.T_period,
                                    train_cfg.restarts, train_cfg.restart_weights,
                                    train_cfg.eta_min)

    def schedule(step):
        if 0 < train_cfg.warmup_iter and step < train_cfg.warmup_iter:
            return train_cfg.lr * step / train_cfg.warmup_iter
        return base(step)

    return schedule


def spynet_lr_schedule(train_cfg, flow_fix: Optional[int]):
    """SPyNet group: frozen through update ``flow_fix + 1``, then
    ``pre_lr_ratio`` x main."""
    main = main_lr_schedule(train_cfg)
    fix = flow_fix if flow_fix is not None else 0

    def schedule(step):
        return 0.0 if step <= fix + 1 else main(step) * train_cfg.pre_lr_ratio

    return schedule


def linear_decay(base_lr: float, total_iters: int, min_ratio: float = 0.0):
    def schedule(step):
        frac = min(max(step / total_iters, 0.0), 1.0)
        return base_lr * (1.0 - frac * (1.0 - min_ratio))

    return schedule
