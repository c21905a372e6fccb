"""Model configuration for the port.

The same size table as weathermodel_tpu/utils/config.py (reference
utils.py:112-123), restated here so that the port imports nothing of the
JAX package. `tests/test_torch_port_model.py` holds the two tables equal.
Only the fields the ported serving path reads are carried.
"""

import dataclasses

# NASA POWER dataset geometry (weathermodel_tpu/utils/constants.py)
TOTAL_WEATHER_VARS = 31
MAX_CONTEXT_LENGTH = 365


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters of the WeatherBERT family."""

    weather_dim: int = TOTAL_WEATHER_VARS
    output_dim: int = TOTAL_WEATHER_VARS
    num_heads: int = 20
    num_layers: int = 8
    hidden_dim_factor: int = 24
    max_len: int = MAX_CONTEXT_LENGTH
    # "float32" for reference-numerics parity, "bfloat16" for serving speed;
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
