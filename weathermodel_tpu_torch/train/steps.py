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

Under a (data, model) mesh (`mesh=`, parallel/mesh.py) every rank is given
the same global batch and draws the same seeds (the JAX package's
single-host semantics). Microbatch i is global rows [i mb, (i + 1) mb), as
JAX's reshape to [grad_accum, mb, ...] gives it (steps.py:223-246); each
rank draws that microbatch's mask (and eps) whole and keeps its data shard
of it. The objectives divide by the global microbatch's normalizers (the
masked count, the sample weights' sum, the ELBO's weighted masked count:
sums over the data group) and the MoE aux loss is the global batch's
(models/moe.py), so the sum of the ranks' losses is the one-process loss;
the gradients are summed over the data group before the update, and the
metrics returned are the global batch's. With a 'data' axis above 1 the
forward's dropout seeds come from a generator seeded by one draw of the
chain and the data index, so that data shards draw different masks and the
ranks of one data index the same. Parameters stored as shards
(`parallel.mesh.shard_params`: `--fsdp`, the dense split over 'model') are
gathered whole for the forward, and the gradients of those split over
'data' are summed as they are sliced back, in the backward. Without a mesh
the step is unchanged.
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
from weathermodel_tpu_torch.parallel import mesh as mesh_lib
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
    # the JAX package's redesign of the reference's CNN pretraining
    # (trainer.py:46-48: BERT masking "for consistency")
    "weathercnn": ("masked_mse", "weatherbert"),
}


def batch_to_device(batch: Batch, device) -> Batch:
    """numpy (or tensor) batch -> fp32 tensors on `device`."""
    return Batch(*(None if a is None else
                   torch.as_tensor(np.asarray(a, np.float32)).to(device)
                   for a in batch))


def _sample_weights(weather, weight):
    return (torch.ones(weather.shape[0], device=weather.device)
            if weight is None else weight.float())


def _identity(x):
    return x


def masked_mse_losses(outputs, weather, mask, weight=None,
                      total=_identity) -> dict:
    """MSE and MAE over the masked positions, weighting sample b by
    weight[b] (weathermodel_tpu/train/steps.py:109-117). `total` turns a
    rank's sum into the global batch's (the data group's; the identity
    without a mesh): the normalizers go through it, so a rank's values
    are its share of the global ones."""
    wm = mask * _sample_weights(weather, weight)[:, None, None]
    msum = total(wm.sum()).clamp(min=1)
    err = weather - outputs
    return {"total_loss": (err.square() * wm).sum() / msum,
            "mae": (err.abs() * wm).sum() / msum}


def mlp_mse_losses(outputs, weather, weight=None, total=_identity) -> dict:
    """The weighted full-sequence MSE of each MLP target feature and their
    mean (weathermodel_tpu/train/steps.py:119-133)."""
    w1 = _sample_weights(weather, weight)
    target = weather[:, :, list(MLP_TARGET_FEATURES)]
    t = target.shape[1]
    feature_losses = (((outputs - target).square() * w1[:, None, None])
                      .sum(dim=(0, 1)) / (total(w1.sum()).clamp(min=1.0) * t))
    losses = {"total_loss": feature_losses.mean()}
    for i, feat in enumerate(MLP_TARGET_FEATURES):
        losses[f"feature_{feat}_mse"] = feature_losses[i]
    return losses


def elbo_losses(objective, outputs, weather, mask, weight=None,
                beta: float = 1.0, eps=None, total=_identity) -> dict:
    """The ELBO objectives on the model's output tuple, per-sample sums
    over the masked positions normalised by the batch-mean masked count
    (weathermodel_tpu/train/steps.py:136-169). `eps` [B, T, F] is the
    mixture's standard-normal sample."""
    w1 = _sample_weights(weather, weight)
    wsum = total(w1.sum()).clamp(min=1.0)

    def wmean(per_sample):
        return (per_sample * w1).sum() / wsum

    n_masked = (total((mask.sum(dim=(1, 2)).float() * w1).sum())
                / wsum).clamp(min=1.0)
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
    mae = ((weather - mu_x).abs() * wm).sum() / total(wm.sum()).clamp(min=1)
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


class _Shard(NamedTuple):
    """How a rank's step sees a global microbatch: `mesh` (None without
    one) and `rows`, the slice of it the rank keeps."""
    mesh: object
    rows: slice

    def total(self, x):
        """The global batch's sum of a rank's sum (the data group's)."""
        return mesh_lib.data_total(self.mesh, x)


def _forward_generator(shard: _Shard, generator):
    """The generator of the forward's dropout seeds: the step's own, or
    with a 'data' axis above 1 one seeded by a draw of it and the data
    index (every data shard its own masks, a data index's ranks the
    same)."""
    mesh = shard.mesh
    if mesh is None or mesh.n_data == 1:
        return generator
    return torch.Generator().manual_seed(
        draw_seed(generator) * mesh.n_data + mesh.data_index)


def _forward_losses(model, batch: Batch, mask, generator, dropout_rate,
                    objective, beta, eps, train: bool, shard: _Shard):
    """(the objective to differentiate, its metrics): the metrics are the
    global batch's, detached; without a mesh the objective is the metrics'
    total_loss."""
    moe_w = moe_aux_weight(model)
    # the shards stored outside the encoder layers (which gather their own)
    # read whole for this forward
    with mesh_lib.activate(shard.mesh), mesh_lib.gathered(model):
        outputs = model(batch.weather, batch.coords, batch.year,
                        batch.interval, mask,
                        generator=_forward_generator(shard, generator),
                        dropout_rate=dropout_rate,
                        return_moe_aux=bool(moe_w))
    if moe_w:
        outputs, moe_aux = outputs
    total = shard.total
    if objective == "masked_mse":
        losses = masked_mse_losses(outputs, batch.weather, mask, batch.weight,
                                   total)
    elif objective == "mlp_mse":
        losses = mlp_mse_losses(outputs, batch.weather, batch.weight, total)
    else:
        if objective == "elbo_mixture" and eps is None:
            b = batch.weather.shape[0]
            if shard.mesh is not None:
                b *= shard.mesh.n_data
            eps = torch.randn(
                (b, *batch.weather.shape[1:]), device=batch.weather.device,
                generator=_seeded(generator, batch.weather.device))[
                    shard.rows]
        losses = elbo_losses(objective, outputs, batch.weather, mask,
                             batch.weight, beta, eps, total)
    objective_value = losses["total_loss"]
    if shard.mesh is not None:
        losses = _global_metrics(shard.mesh, losses)
    if moe_w:
        losses["moe_aux"] = moe_aux
        if train:
            objective_value = objective_value + moe_w * moe_aux
            losses["total_loss"] = losses["total_loss"] + moe_w * moe_aux
    return objective_value, {k: v.detach() for k, v in losses.items()}


def _global_metrics(mesh, losses: dict) -> dict:
    """A rank's shares of the metrics summed over the data group: one
    all_reduce of the stacked values."""
    keys = list(losses)
    stacked = torch.stack([losses[k].detach() for k in keys])
    stacked = mesh_lib.data_total(mesh, stacked)
    return {k: stacked[i] for i, k in enumerate(keys)}


def make_train_step(model, optimizer, masking: str, *,
                    masking_prob: float = 0.15, grad_accum: int = 1,
                    objective: str = "masked_mse", beta: float = 1.0,
                    mesh=None):
    """Returns train_step(batch, generator, lr, n_masked, mask=None,
    dropout_rate=None, eps=None) -> metrics (0-dim tensors on the device).

    grad_accum > 1 splits the batch into that many microbatches; each draws
    its own mask, dropout seeds (and eps) and is normalised by its own
    masked count; the update uses the mean of their gradients and the
    metrics are the mean of theirs. `mask` ([B, T, F] bool) replaces the
    drawn masks, `eps` ([B, T, F]) the mixture's drawn samples, and
    `dropout_rate` overrides the model's rate (the parity tests use them).
    With `mesh` the batch, `mask` and `eps` are the global ones (module
    docstring)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def train_step(batch: Batch, generator, lr: float, n_masked,
                   mask=None, dropout_rate=None, eps=None):
        b = batch.weather.shape[0]
        if b % grad_accum != 0:
            raise ValueError(f"batch size {b} is not divisible by "
                             f"grad_accum={grad_accum}")
        mb = b // grad_accum
        shard = _Shard(mesh, mesh_lib.data_rows(mesh, mb))
        model.train()
        optimizer.zero_grad(set_to_none=True)
        metrics = []
        for i in range(grad_accum):
            sl = slice(i * mb, (i + 1) * mb)
            micro = Batch(*(None if a is None else a[sl] for a in batch))
            m = (_draw_mask(masking, generator, micro.weather.shape,
                            micro.weather.device, masking_prob, n_masked)
                 if mask is None else mask[sl])
            micro = Batch(*(None if a is None else a[shard.rows]
                            for a in micro))
            loss, losses = _forward_losses(
                model, micro, m[shard.rows], generator, dropout_rate,
                objective, beta, None if eps is None else eps[sl][shard.rows],
                train=True, shard=shard)
            loss.backward()
            metrics.append(losses)
        if mesh is not None:
            mesh_lib.all_reduce_grads(model, mesh)
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
                   objective: str = "masked_mse", beta: float = 1.0,
                   mesh=None):
    """Returns eval_step(batch, generator, n_masked, mask=None, eps=None)
    -> metrics: the deterministic forward (dropout off, reference
    model.eval()); with `mesh`, of the global batch."""

    def eval_step(batch: Batch, generator, n_masked, mask=None, eps=None):
        model.eval()
        shard = _Shard(mesh, mesh_lib.data_rows(
            mesh, batch.weather.shape[0]))
        with torch.no_grad():
            if mask is None:
                mask = _draw_mask(masking, generator, batch.weather.shape,
                                  batch.weather.device, masking_prob,
                                  n_masked)
            local = Batch(*(None if a is None else a[shard.rows]
                            for a in batch))
            return _forward_losses(
                model, local, mask[shard.rows], generator, None, objective,
                beta, None if eps is None else eps[shard.rows], train=False,
                shard=shard)[1]

    return eval_step
