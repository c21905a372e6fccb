"""Leslie-Smith LR range test (a copy of weathermodel_tpu/train/lr_finder.py,
reference src/base_trainer/find_optimal_lr.py; numpy only).

Exponential LR ramp start_lr -> end_lr over <= num_iter steps on a THROWAWAY
copy of the model and optimizer, early exit on divergence (loss > 5x best),
then steepest-negative-gradient-of-loss selection / 10, floored at 10x
start_lr (reference :124-158).

The per-iteration work is the caller's train step. The reference's
distributed consensus (all_reduce(MAX) on the divergence flag,
find_optimal_lr.py:102-117) and its cross-rank LR average
(base_trainer.py:418-441) have no counterpart: the port trains on one
device, so one loss decides.
"""

import logging
from typing import Callable, Iterable, List, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def find_optimal_lr(
    run_step: Callable[..., float],
    batches: Iterable,
    start_lr: float = 1e-5,
    end_lr: float = 1.0,
    num_iter: int = 100,
) -> Tuple[float, List[float], List[float]]:
    """run_step(batch, lr) -> loss (float); must mutate only throwaway state.
    Returns (optimal_lr, lrs, losses)."""
    lr_mult = (end_lr / start_lr) ** (1.0 / (num_iter - 1))
    lrs: List[float] = []
    losses: List[float] = []
    best_loss = None
    current_lr = start_lr

    it = iter(batches)
    pool = []
    for i in range(num_iter):
        try:
            batch = next(it)
            pool.append(batch)
        except StopIteration:
            if not pool:
                raise ValueError("empty dataloader for LR finder")
            batch = pool[i % len(pool)]

        loss_val = float(run_step(batch, current_lr))
        lrs.append(current_lr)
        losses.append(loss_val)
        if best_loss is None or loss_val < best_loss:
            best_loss = loss_val
        if loss_val > 5 * best_loss:
            logger.info("LR finder: divergence at lr=%.2e (iter %d)",
                        current_lr, i)
            break
        current_lr *= lr_mult

    return select_optimal_lr(lrs, losses, start_lr), lrs, losses


def select_optimal_lr(lrs: List[float], losses: List[float],
                      start_lr: float) -> float:
    """Steepest-decline/10 selection (reference :124-158)."""
    min_loss = min(losses)
    min_loss_idx = losses.index(min_loss)
    diverge_idx = len(losses)
    for i in range(min_loss_idx, len(losses)):
        if losses[i] > 4 * min_loss:
            diverge_idx = i
            break

    gradients = np.gradient(losses) if len(losses) > 1 else np.zeros(1)
    search_region = gradients[:diverge_idx]
    if len(search_region) > 0:
        steepest_idx = int(np.argmin(search_region))
        optimal_lr = lrs[steepest_idx] / 10
        if optimal_lr < start_lr * 10:
            optimal_lr = start_lr * 10
    else:
        optimal_lr = start_lr * 10
        logger.warning("No clear steepest decline found; conservative default")
    logger.info("LR finder selected %.3e", optimal_lr)
    return optimal_lr
