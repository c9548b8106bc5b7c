"""RetNet-style retention decay matrices (``vmg_tpu/ops/decay.py``).

1. The MorphFC axis mixers scale the (Ch, Ch) axis-FC weight elementwise
   by a Toeplitz decay over spatial chunk distance: entry (a, b) is the
   mean over per-"head" rates gamma_q of gamma_q ** (|a//S - b//S| + 1),
   S the channel segment length.  The weight is stored undecayed and the
   decay is folded in at use time, once per forward.
2. LTAM biases keyframe logits by a per-head temporal decay: slot j of t
   keyframes (0 = oldest) is scaled by decay_v ** (t - j).

Both are numpy closed forms; callers move them to their device.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def morphfc_decay_np(chunk: int, seg: int) -> np.ndarray:
    # decay rates: gamma_q = 1 - 2^-(5 + chunk-1-q), q = 0..chunk-1
    gammas = 1.0 - 2.0 ** (-5.0 - np.arange(chunk - 1, -1, -1, dtype=np.float64))
    pos = np.arange(chunk * seg) // seg
    dist = np.abs(pos[:, None] - pos[None, :])  # (Ch, Ch)
    g = np.mean(gammas[:, None, None] ** (dist[None] + 1), axis=0)
    return g.astype(np.float32)


@functools.lru_cache(maxsize=None)
def ltam_decay_np(heads: int, t: int) -> np.ndarray:
    # decay_v[h] = 1 - 2^-(5 + heads-1-h); slot j (oldest first) gets
    # decay_v ** (t - j).
    decay_v = 1.0 - 2.0 ** (-5.0 - np.arange(heads - 1, -1, -1, dtype=np.float64))
    expo = t - np.arange(t)
    return (decay_v[:, None] ** expo[None, :]).astype(np.float32)
