"""WeatherBERT, the masked-reconstruction weather encoder (port of
weathermodel_tpu/models/weatherbert.py, reference weatherbert.py:13-121).

input = concat[masked weather (31), normalized year (1), normalized coords
(2)] -> in_proj -> + sinusoidal PE -> post-LN transformer encoder ->
out_proj. Masked features are zeroed before the concat. WeatherAutoencoder
and SimMTM are the same architecture trained under other masking policies,
so they are aliases.

In `train()` mode the forward drops at the encoder layers' four sites with
`cfg.dropout_rate`, drawing its seeds from the CPU `generator` the caller
passes, as the JAX module does with deterministic=False; there is no dropout
after the positional encoding (weathermodel_tpu/models/weatherbert.py:63-98).
In `eval()` mode it is deterministic.

With `cfg.num_experts` > 0 every layer's FFN is the routed expert FFN
(models/moe.py, `cfg.moe_dispatch`); `return_moe_aux=True` makes the forward
return (outputs, the mean of the layers' aux losses), which the train step
adds to the objective (train/steps.py).

Submodules sit at the top level (`in_proj`, `transformer_encoder.layers`,
`out_proj`), so `state_dict()` has exactly the reference checkpoint's keys;
the PE table is a non-persistent buffer.
"""

import torch
from torch import nn

from weathermodel_tpu_torch.models.blocks import (
    TransformerEncoder,
    linear,
    sinusoidal_positional_encoding,
    torch_linear_init_,
)
from weathermodel_tpu_torch.models.moe import MoEFFN
from weathermodel_tpu_torch.ops.normalize import normalize_year_interval_coords
from weathermodel_tpu_torch.utils.config import ModelConfig


class WeatherEncoderCore(nn.Module):
    """in_proj + positional encoding + transformer trunk -> hidden states,
    computed in `cfg.compute_dtype` (parameters stay fp32). `remat`
    recomputes each encoder layer in the backward (models/blocks.py's
    TransformerEncoder; JAX weatherbert.py:39,89)."""

    def __init__(self, cfg: ModelConfig, attention_impl: str = "torch",
                 ffn_impl: str = "torch", gmm_impl: str = "kernel",
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.in_proj = nn.Linear(cfg.input_dim, cfg.hidden_dim)
        self.register_buffer(
            "pe", sinusoidal_positional_encoding(cfg.max_len, cfg.hidden_dim),
            persistent=False)
        moe = None
        if cfg.num_experts > 0:
            moe = dict(num_experts=cfg.num_experts, top_k=cfg.moe_top_k,
                       capacity_factor=cfg.moe_capacity_factor,
                       dispatch=cfg.moe_dispatch, remat=cfg.moe_remat,
                       gmm_impl=gmm_impl)
        self.transformer_encoder = TransformerEncoder(
            cfg.hidden_dim, cfg.num_heads, cfg.ffn_dim, cfg.num_layers,
            attention_impl, ffn_impl, moe, remat)

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """Re-initialize from `generator` with the init the modules are
        built with (the JAX package's): every Linear and the packed QKV
        projection U(-1/sqrt(fan_in), 1/sqrt(fan_in)), LayerNorm ones/zeros,
        the experts as MoEFFN.reset_parameters."""
        for module in self.modules():
            if isinstance(module, MoEFFN):
                module.reset_parameters(generator)
            elif isinstance(module, nn.Linear):
                torch_linear_init_(module.weight, module.bias, generator)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
        for layer in self.transformer_encoder.layers:
            torch_linear_init_(layer.self_attn.in_proj_weight,
                               layer.self_attn.in_proj_bias, generator)

    def encode(self, weather, coords, year, interval, weather_feature_mask,
               generator=None, dropout_rate=None):
        """weather [B, T, F] (z-scored), coords [B, 2] raw (lat, lon),
        year [B, T] raw, interval [B, 1], weather_feature_mask [B, T, F]
        bool (True = masked) -> (hidden [B, T, H] in the compute dtype, the
        mean MoE aux loss or None). In train mode, `generator` (a CPU
        torch.Generator) seeds the dropout; `dropout_rate` overrides
        cfg.dropout_rate."""
        cfg = self.cfg
        b, t, _ = weather.shape
        if t > cfg.max_len:
            raise ValueError(
                f"sequence length {t} exceeds max_len={cfg.max_len}; build "
                f"the model with max_len>={t} "
                "(model_config_for_size(..., max_len=...))")
        year, interval, coords = normalize_year_interval_coords(
            year, interval, coords)
        coords = coords[:, None, :].expand(b, t, 2)
        weather = weather * ~weather_feature_mask
        x = torch.cat([weather, year[..., None], coords], dim=-1)
        x = linear(x.to(self.compute_dtype), self.in_proj)
        x = x + self.pe[:t].to(self.compute_dtype)
        rate = 0.0
        if self.training:
            rate = cfg.dropout_rate if dropout_rate is None else dropout_rate
        if rate > 0.0 and generator is None:
            raise ValueError("training with dropout needs a generator (a "
                             "CPU torch.Generator for the dropout seeds)")
        return self.transformer_encoder(x, rate, generator)


class WeatherBERT(WeatherEncoderCore):
    """Masked-feature reconstruction encoder; returns [B, T, output_dim]
    in fp32 (and the MoE aux loss with `return_moe_aux`)."""

    def __init__(self, cfg: ModelConfig, attention_impl: str = "torch",
                 ffn_impl: str = "torch", gmm_impl: str = "kernel",
                 remat: bool = False):
        super().__init__(cfg, attention_impl, ffn_impl, gmm_impl, remat)
        self.out_proj = nn.Linear(cfg.hidden_dim, cfg.output_dim)

    def forward(self, weather, coords, year, interval, weather_feature_mask,
                generator=None, dropout_rate=None, return_moe_aux=False):
        hidden, aux = self.encode(weather, coords, year, interval,
                                  weather_feature_mask, generator,
                                  dropout_rate)
        out = linear(hidden, self.out_proj).float()
        return (out, aux) if return_moe_aux else out


# Identical architecture under other masking policies (reference
# weatherautoencoder.py:15-36, simmtm.py:16-37).
WeatherAutoencoder = WeatherBERT
SimMTM = WeatherBERT
