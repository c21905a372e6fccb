"""Model and training configuration for the port.

The same size table and defaults as weathermodel_tpu/utils/config.py
(reference utils.py:112-141), restated here so that the port imports
nothing of the JAX package. `tests/test_torch_port_imports.py` holds the
two equal. Only the model fields the ported paths read are carried.
"""

import dataclasses
from typing import Optional

from weathermodel_tpu_torch.utils.constants import (
    MAX_CONTEXT_LENGTH,
    TOTAL_WEATHER_VARS,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of the WeatherBERT/WeatherFormer family."""

    weather_dim: int = TOTAL_WEATHER_VARS
    output_dim: int = TOTAL_WEATHER_VARS
    num_heads: int = 20
    num_layers: int = 8
    hidden_dim_factor: int = 24
    max_len: int = MAX_CONTEXT_LENGTH
    dropout_rate: float = 0.1  # torch TransformerEncoderLayer default
    # prior components of the WeatherFormer sinusoid (k=4) and mixture (k=7)
    # models (reference weatherformer_sinusoid.py:22 / _mixture.py:24)
    k: int = 4
    # "float32" for reference-numerics parity, "bfloat16" for speed;
    # parameters stay float32 either way
    compute_dtype: str = "float32"

    @property
    def hidden_dim(self) -> int:
        return self.num_heads * self.hidden_dim_factor

    @property
    def ffn_dim(self) -> int:
        return 4 * self.hidden_dim

    @property
    def input_dim(self) -> int:
        # weather + normalized year + 2 coords
        return self.weather_dim + 1 + 2


MODEL_SIZES = {
    "mini": dict(num_heads=4, num_layers=2, hidden_dim_factor=12),
    "small": dict(num_heads=10, num_layers=4, hidden_dim_factor=20),
    "medium": dict(num_heads=12, num_layers=6, hidden_dim_factor=28),
    "large": dict(num_heads=16, num_layers=8, hidden_dim_factor=36),
}


def model_config_for_size(size: str, **overrides) -> ModelConfig:
    if size.lower() not in MODEL_SIZES:
        raise ValueError(f"Unknown model size: {size}")
    return ModelConfig(**{**MODEL_SIZES[size.lower()], **overrides})


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference pretraining_main.py:41-67
    defaults). `use_optimal_lr` and `checkpoint_every` are carried so the
    table stays the JAX package's; the port's trainer raises on the first
    and writes no full-state checkpoints yet (ROADMAP.md queue A item 7)."""

    batch_size: int = 256
    num_epochs: int = 100
    init_lr: float = 5e-4
    num_warmup_epochs: int = 10
    # None -> cosine annealing after warmup; otherwise exponential decay**e
    decay_factor: Optional[float] = 0.99
    masking_prob: float = 0.15
    n_masked_features: int = 1
    beta: float = 1.0
    use_optimal_lr: bool = False
    # Masking curriculum: +2 masked features every curriculum_every epochs,
    # capped at curriculum_cap (reference base_trainer.py:517-523).
    curriculum_every: int = 5
    curriculum_step: int = 2
    curriculum_cap: int = 25
    seed: int = 1234
    checkpoint_every: int = 5


def n_masked_features_for_epoch(cfg: TrainConfig, epoch: int,
                                base_n: int) -> int:
    """Masking curriculum (reference base_trainer.py:517-523): start at
    base_n, add `curriculum_step` every `curriculum_every` epochs, cap at
    `curriculum_cap`."""
    n = base_n + cfg.curriculum_step * (epoch // cfg.curriculum_every)
    return min(n, cfg.curriculum_cap)
