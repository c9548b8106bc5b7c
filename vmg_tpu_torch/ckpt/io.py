"""Trainer checkpoints: the master parameters, the optimizer's moments, its
step count (the position on the learning-rate schedule) and the
stochastic-depth generator, as one ``torch.save`` file a step.

The counterpart of ``vmg_tpu/ckpt/orbax_io.py``: ``directory/<step>/state.pt``
for every saved step, the oldest removed past ``max_to_keep``.  A run
restored from step k and stepped N - k more times ends on the same
parameters, bit for bit, as one that ran N steps.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

_FILE = "state.pt"


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.isfile(os.path.join(directory, d, _FILE)))


def save_checkpoint(directory: str, step: int, state: Any, max_to_keep: int = 10) -> None:
    """Save ``state`` (tensors, numbers, lists and dicts of them) as step
    ``step``; keep the ``max_to_keep`` newest steps."""
    path = os.path.join(directory, str(int(step)))
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    for old in _steps(directory)[:-max_to_keep] if max_to_keep > 0 else []:
        shutil.rmtree(os.path.join(directory, str(old)))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None) -> Any:
    """The state saved at ``step`` (default: the latest), on the CPU."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    return torch.load(os.path.join(directory, str(int(step)), _FILE), map_location="cpu",
                      weights_only=True)


def trainer_state(model: torch.nn.Module, step_fn, generator: Optional[torch.Generator] = None):
    """The state of a trainer (``train.make_train_step``'s step function on
    the float32 master ``model``) to save: params, the optimizer's moments
    and count, the generator's state."""
    opt = step_fn.optimizer
    state = {"params": {k: v.detach().clone() for k, v in model.state_dict().items()},
             "opt": {"mu": [m.clone() for m in opt.mu], "nu": [n.clone() for n in opt.nu],
                     "count": opt.count},
             "step": opt.count}
    if generator is not None:
        state["generator"] = generator.get_state()
    return state


@torch.no_grad()
def load_trainer_state(state, model: torch.nn.Module, step_fn,
                       generator: Optional[torch.Generator] = None) -> int:
    """Load :func:`trainer_state`'s ``state`` into the master ``model``, the
    step function's optimizer and compute copy, and ``generator``; returns
    the step."""
    from vmg_tpu_torch.train.precision import sync_compute

    model.load_state_dict(state["params"], strict=True)
    opt = step_fn.optimizer
    for dst, src in zip(opt.mu + opt.nu, state["opt"]["mu"] + state["opt"]["nu"]):
        dst.copy_(src)
    opt.count = int(state["opt"]["count"])
    sync_compute(model, step_fn.compute_model)
    if generator is not None and "generator" in state:
        generator.set_state(state["generator"])
    return int(state["step"])
