"""Train and eval steps for masked-MSE pretraining (port of
weathermodel_tpu/train/steps.py:41-50,109-117,172-268).

One train step: per microbatch, draw the mask on the device, run the
forward in train mode (dropout seeds from the caller's CPU generator), the
masked MSE, and its backward; then one Adam update with the mean of the
microbatch gradients. The eval step is the deterministic forward under
`torch.no_grad()`.

Objectives ported: `masked_mse` (WeatherBERT, WeatherAutoencoder, SimMTM).
The ELBO family waits for WeatherFormer (ROADMAP.md queue A item 8).

Randomness: every draw comes from the CPU `torch.Generator` passed to the
step (the trainer seeds one per epoch), as integer seeds on the host, so
the step never copies a random number from the device. The mask of each
microbatch is drawn on the device from a generator seeded by one of them.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from weathermodel_tpu_torch.ops.dropout import draw_seed
from weathermodel_tpu_torch.ops.masking import make_mask
from weathermodel_tpu_torch.train.state import set_learning_rate


class Batch(NamedTuple):
    weather: object   # [B, T, F]
    coords: object    # [B, 2]
    year: object      # [B, T]
    interval: object  # [B, 1]
    # Optional per-sample weight [B] (None = all ones): the zero-padded
    # validation remainder has weight 0 on its padding rows.
    weight: Optional[object] = None


# model name -> (objective, masking policy), weathermodel_tpu/train/
# trainer.py:38-49, for the models the port has
OBJECTIVE_FOR_MODEL = {
    "weatherbert": ("masked_mse", "weatherbert"),
    "weatherautoencoder": ("masked_mse", "weatherformer"),
    "simmtm": ("masked_mse", "simmtm"),
}


def batch_to_device(batch: Batch, device) -> Batch:
    """numpy (or tensor) batch -> fp32 tensors on `device`."""
    return Batch(*(None if a is None else
                   torch.as_tensor(np.asarray(a, np.float32)).to(device)
                   for a in batch))


def masked_mse_losses(outputs, weather, mask, weight=None) -> dict:
    """MSE and MAE over the masked positions, weighting sample b by
    weight[b] (weathermodel_tpu/train/steps.py:85-117)."""
    b = weather.shape[0]
    w1 = (torch.ones(b, device=weather.device) if weight is None
          else weight.float())
    wm = mask * w1[:, None, None]
    msum = wm.sum().clamp(min=1)
    err = weather - outputs
    return {"total_loss": (err.square() * wm).sum() / msum,
            "mae": (err.abs() * wm).sum() / msum}


def _draw_mask(masking, generator, shape, device, masking_prob, n_masked):
    g = torch.Generator(device=device)
    g.manual_seed(draw_seed(generator))
    b, t, f = shape
    return make_mask(masking, g, b, t, f, device=device, prob=masking_prob,
                     n_masked=torch.as_tensor(n_masked, device=device))


def _forward_losses(model, batch: Batch, mask, generator, dropout_rate):
    outputs = model(batch.weather, batch.coords, batch.year, batch.interval,
                    mask, generator=generator, dropout_rate=dropout_rate)
    return masked_mse_losses(outputs, batch.weather, mask, batch.weight)


def make_train_step(model, optimizer, masking: str, *,
                    masking_prob: float = 0.15, grad_accum: int = 1):
    """Returns train_step(batch, generator, lr, n_masked, mask=None,
    dropout_rate=None) -> metrics (0-dim tensors on the device).

    grad_accum > 1 splits the batch into that many microbatches; each draws
    its own mask and dropout seeds and is normalised by its own masked
    count; the update uses the mean of their gradients and the metrics are
    the mean of theirs. `mask` ([B, T, F] bool) replaces the drawn masks and
    `dropout_rate` overrides the model's rate (the parity tests use both)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def train_step(batch: Batch, generator, lr: float, n_masked,
                   mask=None, dropout_rate=None):
        b = batch.weather.shape[0]
        if b % grad_accum != 0:
            raise ValueError(f"batch size {b} is not divisible by "
                             f"grad_accum={grad_accum}")
        mb = b // grad_accum
        model.train()
        optimizer.zero_grad(set_to_none=True)
        metrics = []
        for i in range(grad_accum):
            sl = slice(i * mb, (i + 1) * mb)
            micro = Batch(*(None if a is None else a[sl] for a in batch))
            m = (_draw_mask(masking, generator, micro.weather.shape,
                            micro.weather.device, masking_prob, n_masked)
                 if mask is None else mask[sl])
            losses = _forward_losses(model, micro, m, generator, dropout_rate)
            losses["total_loss"].backward()
            metrics.append({k: v.detach() for k, v in losses.items()})
        if grad_accum > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(grad_accum)
        set_learning_rate(optimizer, lr)
        optimizer.step()
        return {k: torch.stack([m[k] for m in metrics]).mean()
                for k in metrics[0]}

    return train_step


def make_eval_step(model, masking: str, *, masking_prob: float = 0.15):
    """Returns eval_step(batch, generator, n_masked, mask=None) -> metrics:
    the deterministic forward (dropout off, reference model.eval())."""

    def eval_step(batch: Batch, generator, n_masked, mask=None):
        model.eval()
        with torch.no_grad():
            if mask is None:
                mask = _draw_mask(masking, generator, batch.weather.shape,
                                  batch.weather.device, masking_prob,
                                  n_masked)
            return _forward_losses(model, batch, mask, generator, None)

    return eval_step
