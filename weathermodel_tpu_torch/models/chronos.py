"""Chronos yield baseline, a time-series foundation model's encoder under a
yield head (port of weathermodel_tpu/models/chronos.py; reference
`src/crop_yield/models/chronos_yield_model.py:15-185`).

Each of the F weather variables is a univariate series through the
chronos-bolt-tiny encoder (`models/chronos_bolt.py`): weather * ~mask,
[B, T, F] -> [B * F, T] -> per-patch embeddings; the REG token dropped,
the variables' embeddings concatenated per patch ([B, P, F * D]), then an
attention pool (Linear(F * D, 16) -> exact GELU -> Linear(16, 1), softmax
over the patches) and the yield MLP (Linear(F * D + n_past_years + 1, 120)
-> GELU -> Linear(120, 1)) on [pooled ; y_past]. The model computes in fp32
whatever the configured compute dtype, as the JAX module does.

The encoder trains from its seeded init unless `load_chronos_torch_weights`
fills it from a chronos-bolt checkpoint file (the JAX package's key map;
no such file is in this repository, and the port downloads nothing).
`freeze_subtree_optimizer` takes the encoder's parameters out of an
optimizer's update, the JAX package's `freeze_subtree_optimizer` (its
frozen leaves get zero updates); the yield CLIs train it unfrozen, as the
JAX CLIs do.
"""

import logging

import torch
import torch.nn.functional as F
from torch import nn

from weathermodel_tpu_torch.models.blocks import torch_linear_init_
from weathermodel_tpu_torch.models.chronos_bolt import (
    CHRONOS_BOLT_TINY,
    ChronosBoltEncoder,
    load_torch_state_dict,
)
from weathermodel_tpu_torch.utils.config import ModelConfig

logger = logging.getLogger(__name__)

ENC_DIM = CHRONOS_BOLT_TINY.d_model
ENCODER = "chronos_encoder"


class ChronosYieldModel(nn.Module):
    """[B, T, F] weekly weather (+ y_past [B, n_past_years + 1]) -> [B, 1]
    yield; F is `cfg.weather_dim`. The keywords of the port's other yield
    models are taken: in `train()` mode the encoder drops with seeds from
    the CPU `generator` (`dropout_rate` overrides its 0.1); the sampling
    ones are ignored."""

    def __init__(self, cfg: ModelConfig, n_past_years: int,
                 attention_impl: str = "torch"):
        super().__init__()
        self.cfg, self.n_past_years = cfg, n_past_years
        total = cfg.weather_dim * ENC_DIM
        self.chronos_encoder = ChronosBoltEncoder(CHRONOS_BOLT_TINY)
        self.attn_fc1 = nn.Linear(total, 16)
        self.attn_fc2 = nn.Linear(16, 1)
        self.mlp_fc1 = nn.Linear(total + n_past_years + 1, 120)
        self.mlp_fc2 = nn.Linear(120, 1)

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        self.chronos_encoder.reset_parameters(generator)
        for fc in (self.attn_fc1, self.attn_fc2, self.mlp_fc1, self.mlp_fc2):
            torch_linear_init_(fc.weight, fc.bias, generator)

    def forward(self, weather, coords, year, interval, weather_feature_mask,
                y_past, soil=None, practices=None, generator=None,
                sample_generator=None, eps=None, dropout_rate=None):
        b, t, f = weather.shape
        weather = weather.float() * ~weather_feature_mask
        # F univariate series folded into the batch (reference :140-145)
        series = weather.transpose(1, 2).reshape(b * f, t)
        emb = self.chronos_encoder(series, generator, dropout_rate)
        if CHRONOS_BOLT_TINY.use_reg_token:
            emb = emb[:, :-1]                    # drop REG (reference :147)
        p = emb.shape[1]
        # the variables' embeddings concatenated per patch: [B, P, F * D]
        emb = emb.reshape(b, f, p, ENC_DIM).transpose(1, 2).reshape(
            b, p, f * ENC_DIM)
        attn = torch.softmax(self.attn_fc2(F.gelu(self.attn_fc1(emb))),
                             dim=1)
        pooled = (emb * attn).sum(dim=1)                      # [B, F * D]
        x = torch.cat([pooled, y_past.float()], dim=1)
        return self.mlp_fc2(F.gelu(self.mlp_fc1(x)))


def freeze_subtree_optimizer(optimizer: torch.optim.Optimizer,
                             model: nn.Module, subtree: str = ENCODER):
    """Take the parameters of `model.<subtree>` out of `optimizer`'s groups
    (and its state), so that its steps leave them unchanged while the rest
    trains; returns the optimizer."""
    held = {id(p) for p in model.get_submodule(subtree).parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            if id(p) in held:
                optimizer.state.pop(p, None)
        group["params"] = [p for p in group["params"] if id(p) not in held]
    return optimizer


def load_chronos_torch_weights(model: nn.Module, torch_ckpt_path: str):
    """Fill `model.chronos_encoder` from a chronos-bolt checkpoint file, a
    saved state dict. Unlike the JAX package's, it loads tensors only
    (`weights_only`): a pickled model object, which could run code as it
    is read, is refused. Raises on missing keys and shape mismatches; never
    leaves the model silently at its init."""
    sd = torch.load(torch_ckpt_path, weights_only=True, map_location="cpu")
    load_torch_state_dict(model, sd)
    logger.info("load_chronos_torch_weights: initialized chronos_encoder "
                "from %s (%d checkpoint tensors)", torch_ckpt_path, len(sd))
    return model
