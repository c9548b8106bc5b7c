"""AdamW over the reference's three parameter groups
(``vmg_tpu/train/optimizer.py``), with optax's semantics:

  * ``spynet`` -- the flow network: the SPyNet schedule (frozen through
    flow_fix), no weight decay;
  * ``wd``     -- parameters under ``mlp_blocks``: the main schedule and
    ``weight_decay``;
  * ``main``   -- everything else: the main schedule, no weight decay.

Each group is ``optax.adamw``: bias-corrected moments, eps added to the
square root, decoupled ``lr * wd * p``, and the rate taken from the
schedule at the update count before it is incremented.  A group at rate 0
still advances its moments.  ``optax.clip_by_global_norm`` runs first, over
all groups, when ``if_grad_clip`` is set.  Updates are in place on the
float32 master parameters.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from vmg_tpu_torch.train.schedule import main_lr_schedule, spynet_lr_schedule


def param_labels(model: torch.nn.Module) -> Dict[str, str]:
    """State-dict name -> 'spynet' | 'wd' | 'main'."""
    labels = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if any(p.startswith("spynet") for p in parts):
            labels[name] = "spynet"
        elif any(p.startswith("mlp_blocks") for p in parts):
            labels[name] = "wd"
        else:
            labels[name] = "main"
    return labels


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The 2-norm of all gradients together (``optax.global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: unchanged below ``max_norm``, else
    ``g / norm * max_norm``."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


class AdamW:
    """The grouped AdamW.  ``step(grads)`` takes one float32 gradient per
    parameter, in ``model.parameters()`` order."""

    def __init__(self, model: torch.nn.Module, train_cfg,
                 flow_fix: Optional[int] = None):
        self.cfg = train_cfg
        labels = param_labels(model)
        self.params = list(model.parameters())
        names = [n for n, _ in model.named_parameters()]
        main = main_lr_schedule(train_cfg)
        spynet = spynet_lr_schedule(train_cfg, flow_fix) if train_cfg.pre_training else main
        wd = train_cfg.weight_decay or 0.0
        # per group: (indices, schedule, weight decay)
        self.groups = []
        for label, sched, decay in (("spynet", spynet, 0.0), ("wd", main, wd),
                                    ("main", main, 0.0)):
            idx = [i for i, n in enumerate(names) if labels[n] == label]
            if idx:
                self.groups.append((idx, sched, decay))
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        cfg = self.cfg
        if cfg.if_grad_clip:
            grads = clip_by_global_norm(grads, cfg.grad_clip_up)
        b1, b2, eps = cfg.beta1, cfg.beta2, 1e-8
        t = self.count + 1
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for idx, sched, decay in self.groups:
            lr = sched(self.count)
            p = [self.params[i] for i in idx]
            g = [grads[i] for i in idx]
            mu = [self.mu[i] for i in idx]
            nu = [self.nu[i] for i in idx]
            # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
            # u = (mu / c1) / (sqrt(nu / c2) + eps) + decay * p;  p -= lr * u
            den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
            torch._foreach_add_(den, eps)
            u = torch._foreach_div(torch._foreach_div(mu, c1), den)
            if decay:
                torch._foreach_add_(u, torch._foreach_mul(p, decay))
            torch._foreach_add_(p, torch._foreach_mul(u, -lr))
        self.count += 1
