"""Per-timestep MLP baseline (port of weathermodel_tpu/models/mlp.py,
reference src/pretraining/models/mlp.py:15-66).

Input: all 31 weather features (no masking); output: the 6 crop-relevant
features MLP_TARGET_FEATURES, in that order. fc1 (31 -> 512), exact-erf
GELU, fc2 (512 -> 6), in fp32. The pretraining objective is `mlp_mse`
(train/steps.py): the full-sequence MSE on those features plus one MSE per
feature. The mask, the generator and the dropout rate the train step passes
are ignored: the model has no dropout.
"""

import torch
import torch.nn.functional as F
from torch import nn

from weathermodel_tpu_torch.models.blocks import torch_linear_init_
from weathermodel_tpu_torch.utils.config import ModelConfig

MLP_TARGET_FEATURES = (1, 2, 7, 8, 11, 29)


class WeatherMLP(nn.Module):
    """`hidden_dim` 512 is the reference's runtime value (mlp_trainer.py:164),
    ~19.5K parameters."""

    def __init__(self, cfg: ModelConfig, hidden_dim: int = 512):
        super().__init__()
        self.cfg = cfg
        self.fc1 = nn.Linear(cfg.weather_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, len(MLP_TARGET_FEATURES))

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for every weight and bias, the
        JAX package's `torch_dense` init, drawn from `generator`."""
        for layer in (self.fc1, self.fc2):
            torch_linear_init_(layer.weight, layer.bias, generator)

    def forward(self, weather, coords=None, year=None, interval=None,
                weather_feature_mask=None, generator=None,
                dropout_rate=None, return_moe_aux=False):
        """weather [B, T, F] -> [B, T, 6] fp32."""
        if return_moe_aux:
            raise ValueError("the MLP has no MoE layers")
        return self.fc2(F.gelu(self.fc1(weather.float())))
