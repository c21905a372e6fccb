"""Learning-rate schedules (a copy of weathermodel_tpu/ops/schedules.py).

The reference steps its LambdaLR scheduler once per epoch (base_trainer.py:
254, utils.py:11-60): linear warmup for `num_warmup_epochs`, then cosine
annealing to zero (decay_factor=None) or exponential decay
`decay_factor**epochs_after_warmup`. The LR is flat within an epoch.
"""

import math
from typing import Optional


def epoch_lr_multiplier(
    epoch: int,
    num_warmup_epochs: int,
    total_epochs: int,
    decay_factor: Optional[float] = None,
) -> float:
    """LR multiplier for a given epoch (exact reference math)."""
    if epoch < num_warmup_epochs:
        return float(epoch) / float(max(1, num_warmup_epochs))
    if decay_factor is None:
        progress = (epoch - num_warmup_epochs) / (total_epochs - num_warmup_epochs)
        return 0.5 * (1.0 + math.cos(math.pi * progress))
    return decay_factor ** (epoch - num_warmup_epochs)


def epoch_lr_schedule(
    init_lr: float,
    num_warmup_epochs: int,
    total_epochs: int,
    decay_factor: Optional[float] = None,
):
    """Returns epoch -> learning rate."""

    def schedule(epoch: int) -> float:
        return init_lr * epoch_lr_multiplier(
            epoch, num_warmup_epochs, total_epochs, decay_factor
        )

    return schedule
