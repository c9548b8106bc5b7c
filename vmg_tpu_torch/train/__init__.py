"""Training of the port: losses, schedules, grouped AdamW, mixed
precision and the training step (``vmg_tpu/train``); ``python -m
vmg_tpu_torch.train`` times the step."""

from vmg_tpu_torch.train.loss import charbonnier_loss, edge_loss, total_loss
from vmg_tpu_torch.train.optimizer import AdamW, param_labels
from vmg_tpu_torch.train.train_step import loss_and_grads, make_train_step

__all__ = ["AdamW", "charbonnier_loss", "edge_loss", "loss_and_grads",
           "make_train_step", "param_labels", "total_loss"]
