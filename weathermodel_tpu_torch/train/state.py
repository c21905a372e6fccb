"""Optimizer (port of weathermodel_tpu/train/state.py:24-34).

Adam with torch's defaults (betas 0.9/0.999, eps 1e-8), which optax's
`adam` equals and the reference's `torch.optim.Adam(lr=init_lr)` uses
(base_trainer.py:317-351). The learning rate is set once per epoch
(reference semantics: flat within an epoch). Parameters stay fp32; the
model casts them to the compute dtype at each use.
"""

import torch


def make_optimizer(model: torch.nn.Module) -> torch.optim.Adam:
    """Adam over `model`'s parameters, learning rate 0 until an epoch sets
    it."""
    return torch.optim.Adam(model.parameters(), lr=0.0)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
