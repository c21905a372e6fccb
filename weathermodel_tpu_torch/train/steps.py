"""Train and eval steps for pretraining (port of
weathermodel_tpu/train/steps.py:41-50,85-268).

One train step: per microbatch, draw the mask on the device, run the
forward in train mode (dropout seeds from the caller's CPU generator), the
objective, and its backward; then one Adam update with the mean of the
microbatch gradients. The eval step is the deterministic forward under
`torch.no_grad()`.

Objectives (weathermodel_tpu/train/steps.py:109-169):
  masked_mse    - WeatherBERT, WeatherAutoencoder, SimMTM: MSE and MAE over
                  the masked positions
  elbo          - WeatherFormer: recon = mean_b[-log N(x; mu, var)] /
                  n_masked, kl = beta * mean_b[KL(q || N(0, 1))] / n_masked,
                  n_masked the batch-mean masked count
  elbo_sinusoid - the KL against the model's sinusoidal prior
  elbo_mixture  - the one-sample mixture KL at z = mu + sqrt(var) * eps
  mlp_mse       - the MLP baseline: the full-sequence MSE on its six target
                  features, and one `feature_{f}_mse` each; the drawn mask
                  is ignored, as in JAX (steps.py:119-133)
The ELBO objectives also report `reconstruction`, `kl_term` and the `mae`
of mu. A model with MoE layers also reports `moe_aux`, the mean of its
layers' aux losses; the training total adds cfg.moe_aux_weight times it,
the validation total stays the task loss (steps.py:57-107).

Randomness: every draw comes from the CPU `torch.Generator` passed to the
step (the trainer seeds one per epoch), as integer seeds on the host, so
the step never copies a random number from the device. The mask of each
microbatch, and the mixture's eps, are drawn on the device from generators
seeded by them.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from weathermodel_tpu_torch.models.mlp import MLP_TARGET_FEATURES
from weathermodel_tpu_torch.ops.dropout import draw_seed
from weathermodel_tpu_torch.ops.losses import (
    gaussian_kl_divergence,
    gaussian_log_likelihood,
    mixture_kl_divergence,
)
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
    "weatherformer": ("elbo", "weatherformer"),
    "weatherformer_sinusoid": ("elbo_sinusoid", "weatherformer"),
    "weatherformer_mixture": ("elbo_mixture", "weatherformer"),
    # the mask is drawn and ignored, so the generator's draws are those of
    # the other models (trainer.py:45)
    "mlp": ("mlp_mse", "weatherbert"),
}


def batch_to_device(batch: Batch, device) -> Batch:
    """numpy (or tensor) batch -> fp32 tensors on `device`."""
    return Batch(*(None if a is None else
                   torch.as_tensor(np.asarray(a, np.float32)).to(device)
                   for a in batch))


def _sample_weights(weather, weight):
    return (torch.ones(weather.shape[0], device=weather.device)
            if weight is None else weight.float())


def masked_mse_losses(outputs, weather, mask, weight=None) -> dict:
    """MSE and MAE over the masked positions, weighting sample b by
    weight[b] (weathermodel_tpu/train/steps.py:109-117)."""
    wm = mask * _sample_weights(weather, weight)[:, None, None]
    msum = wm.sum().clamp(min=1)
    err = weather - outputs
    return {"total_loss": (err.square() * wm).sum() / msum,
            "mae": (err.abs() * wm).sum() / msum}


def mlp_mse_losses(outputs, weather, weight=None) -> dict:
    """The weighted full-sequence MSE of each MLP target feature and their
    mean (weathermodel_tpu/train/steps.py:119-133)."""
    w1 = _sample_weights(weather, weight)
    target = weather[:, :, list(MLP_TARGET_FEATURES)]
    t = target.shape[1]
    feature_losses = (((outputs - target).square() * w1[:, None, None])
                      .sum(dim=(0, 1)) / (w1.sum().clamp(min=1.0) * t))
    losses = {"total_loss": feature_losses.mean()}
    for i, feat in enumerate(MLP_TARGET_FEATURES):
        losses[f"feature_{feat}_mse"] = feature_losses[i]
    return losses


def elbo_losses(objective, outputs, weather, mask, weight=None,
                beta: float = 1.0, eps=None) -> dict:
    """The ELBO objectives on the model's output tuple, per-sample sums
    over the masked positions normalised by the batch-mean masked count
    (weathermodel_tpu/train/steps.py:136-169). `eps` [B, T, F] is the
    mixture's standard-normal sample."""
    w1 = _sample_weights(weather, weight)
    wsum = w1.sum().clamp(min=1.0)

    def wmean(per_sample):
        return (per_sample * w1).sum() / wsum

    n_masked = wmean(mask.sum(dim=(1, 2)).float()).clamp(min=1.0)
    mu_x, var_x = outputs[0], outputs[1]
    recon = wmean(-gaussian_log_likelihood(weather, mu_x, var_x, mask)
                  / n_masked)
    if objective == "elbo":
        kl = gaussian_kl_divergence(mask, mu_x, var_x, torch.zeros_like(mu_x),
                                    torch.ones_like(var_x))
    elif objective == "elbo_sinusoid":
        kl = gaussian_kl_divergence(mask, mu_x, var_x, *outputs[2:4])
    elif objective == "elbo_mixture":
        z = mu_x + torch.sqrt(var_x) * eps
        kl = mixture_kl_divergence(z, mask, mu_x, var_x, *outputs[2:5])
    else:
        raise ValueError(f"Unknown objective: {objective}")
    kl_term = beta * wmean(kl) / n_masked
    wm = mask * w1[:, None, None]
    mae = ((weather - mu_x).abs() * wm).sum() / wm.sum().clamp(min=1)
    return {"total_loss": recon + kl_term, "reconstruction": recon,
            "kl_term": kl_term, "mae": mae}


def _seeded(generator, device) -> torch.Generator:
    """A generator on `device` seeded by the next seed of the CPU one."""
    g = torch.Generator(device=device)
    g.manual_seed(draw_seed(generator))
    return g


def _draw_mask(masking, generator, shape, device, masking_prob, n_masked):
    b, t, f = shape
    return make_mask(masking, _seeded(generator, device), b, t, f,
                     device=device, prob=masking_prob,
                     n_masked=torch.as_tensor(n_masked, device=device))


def moe_aux_weight(model) -> float:
    """cfg.moe_aux_weight when the model carries MoE layers, else 0."""
    cfg = getattr(model, "cfg", None)
    if cfg is not None and cfg.num_experts > 0:
        return cfg.moe_aux_weight
    return 0.0


def _forward_losses(model, batch: Batch, mask, generator, dropout_rate,
                    objective, beta, eps, train: bool):
    moe_w = moe_aux_weight(model)
    outputs = model(batch.weather, batch.coords, batch.year, batch.interval,
                    mask, generator=generator, dropout_rate=dropout_rate,
                    return_moe_aux=bool(moe_w))
    if moe_w:
        outputs, moe_aux = outputs
    if objective == "masked_mse":
        losses = masked_mse_losses(outputs, batch.weather, mask, batch.weight)
    elif objective == "mlp_mse":
        losses = mlp_mse_losses(outputs, batch.weather, batch.weight)
    else:
        if objective == "elbo_mixture" and eps is None:
            eps = torch.randn(
                batch.weather.shape, device=batch.weather.device,
                generator=_seeded(generator, batch.weather.device))
        losses = elbo_losses(objective, outputs, batch.weather, mask,
                             batch.weight, beta, eps)
    if moe_w:
        losses["moe_aux"] = moe_aux
        if train:
            losses["total_loss"] = losses["total_loss"] + moe_w * moe_aux
    return losses


def make_train_step(model, optimizer, masking: str, *,
                    masking_prob: float = 0.15, grad_accum: int = 1,
                    objective: str = "masked_mse", beta: float = 1.0):
    """Returns train_step(batch, generator, lr, n_masked, mask=None,
    dropout_rate=None, eps=None) -> metrics (0-dim tensors on the device).

    grad_accum > 1 splits the batch into that many microbatches; each draws
    its own mask, dropout seeds (and eps) and is normalised by its own
    masked count; the update uses the mean of their gradients and the
    metrics are the mean of theirs. `mask` ([B, T, F] bool) replaces the
    drawn masks, `eps` ([B, T, F]) the mixture's drawn samples, and
    `dropout_rate` overrides the model's rate (the parity tests use them)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def train_step(batch: Batch, generator, lr: float, n_masked,
                   mask=None, dropout_rate=None, eps=None):
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
            losses = _forward_losses(model, micro, m, generator, dropout_rate,
                                     objective, beta,
                                     None if eps is None else eps[sl],
                                     train=True)
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


def make_eval_step(model, masking: str, *, masking_prob: float = 0.15,
                   objective: str = "masked_mse", beta: float = 1.0):
    """Returns eval_step(batch, generator, n_masked, mask=None, eps=None)
    -> metrics: the deterministic forward (dropout off, reference
    model.eval())."""

    def eval_step(batch: Batch, generator, n_masked, mask=None, eps=None):
        model.eval()
        with torch.no_grad():
            if mask is None:
                mask = _draw_mask(masking, generator, batch.weather.shape,
                                  batch.weather.device, masking_prob,
                                  n_masked)
            return _forward_losses(model, batch, mask, generator, None,
                                   objective, beta, eps, train=False)

    return eval_step
