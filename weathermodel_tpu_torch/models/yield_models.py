"""Crop-yield prediction models, fine-tuning heads over pretrained encoders
(port of weathermodel_tpu/models/yield_models.py; reference
`src/crop_yield/models/*`):

* WeatherBERTYieldModel (reference weatherbert_yield_model.py:11-133): the
  encoder imputes the 25 weather features missing from the Khaki datasets
  (impute = orig*(~mask) + pred*mask), then a learned softmax attention
  pool over the sequence (Linear(31,16)-GELU-Linear(16,1)) and a yield MLP
  (Linear(31 + n_past_years + 1, 120)-GELU-Linear(120,1)).
* WeatherFormerYieldModel (+sinusoid, +mixture): variational encoder, the
  imputed signal is a reparameterized sample z = mu + sqrt(var)*eps; extra
  prior outputs are forwarded for the KL term.
* WeatherAutoencoderSineYieldModel / WeatherAutoencoderMixtureYieldModel:
  the WeatherBERT encoder with a post-hoc variational head and a learnable
  sinusoidal or Gaussian-mixture prior, as the JAX package re-designed them.
* LinearYieldModel (reference linear_yield_model.py:8-80): one Linear on the
  flattened masked weather + y_past.

Submodules carry the reference's names: `weather_model.*` (the encoder,
whose state dict is a pretrained checkpoint's), `weather_attention.{0,2}`
and `yield_mlp.{0,2}` (the head); the variational heads add `log_var_fc1`,
`log_var_fc2`, `theta_p` and the parameters `A_p`, `log_var_p`, `mu_k`,
`log_var_k`. The head and the priors compute in fp32 whatever the encoder's
compute dtype, as the JAX package's do.

`forward(weather, coords, year, interval, weather_feature_mask, y_past,
soil=None, practices=None, generator=None, sample_generator=None, eps=None,
dropout_rate=None)`: in `train()` mode the encoder drops with seeds from the
CPU `generator`, as the pretraining models do; the sampling models draw
their standard-normal eps [B, T, F] from `sample_generator`, a
torch.Generator on the tensors' device, or take it as `eps`.
"""

import logging
import math

import torch
import torch.nn.functional as F
from torch import nn

from weathermodel_tpu_torch.models.blocks import torch_linear_init_
from weathermodel_tpu_torch.models.transfer import load_pretrained
from weathermodel_tpu_torch.models.weatherbert import WeatherBERT
from weathermodel_tpu_torch.models.weatherformer import (
    WeatherFormer,
    WeatherFormerMixture,
    WeatherFormerSinusoid,
)
from weathermodel_tpu_torch.utils.config import ModelConfig

logger = logging.getLogger(__name__)

ENCODER = "weather_model"


def _impute(original, predicted, mask):
    """Keep observed features, fill masked ones with encoder predictions
    (reference weatherbert_yield_model.py:56-67)."""
    return original * ~mask + predicted * mask


def _draw_eps(like, sample_generator, eps):
    if eps is not None:
        return eps
    if sample_generator is None:
        raise ValueError("a sampling yield model needs `sample_generator` "
                         "(a torch.Generator on the tensors' device) or "
                         "`eps`")
    return torch.randn(like.shape, device=like.device,
                       generator=sample_generator)


class _YieldModel(nn.Module):
    """Attention pooling + yield MLP shared by all transformer yield models
    (the JAX `_YieldHead`), with the encoder built by the subclass."""

    def __init__(self, cfg: ModelConfig, n_past_years: int):
        super().__init__()
        self.cfg = cfg
        self.n_past_years = n_past_years
        f = cfg.weather_dim
        self.weather_attention = nn.Sequential(
            nn.Linear(f, 16), nn.GELU(), nn.Linear(16, 1))
        self.yield_mlp = nn.Sequential(
            nn.Linear(f + n_past_years + 1, 120), nn.GELU(),
            nn.Linear(120, 1))

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """The encoder's own init, then U(-1/sqrt(fan_in), 1/sqrt(fan_in))
        for every Linear outside it (torch_dense's), then the subclass's
        prior parameters."""
        self.weather_model.reset_parameters(generator)
        for name, module in self.named_modules():
            if isinstance(module, nn.Linear) and not name.startswith(ENCODER):
                torch_linear_init_(module.weight, module.bias, generator)
        self._reset_priors(generator)

    def _reset_priors(self, generator=None) -> None:
        pass

    def head(self, weather, y_past):
        attn = torch.softmax(self.weather_attention(weather), dim=1)
        pooled = (weather * attn).sum(dim=1)                   # [B, F]
        return self.yield_mlp(torch.cat([pooled, y_past], dim=1))

    def encode(self, weather, coords, year, interval, weather_feature_mask,
               generator, dropout_rate):
        return self.weather_model(weather, coords, year, interval,
                                  weather_feature_mask, generator=generator,
                                  dropout_rate=dropout_rate)


class WeatherBERTYieldModel(_YieldModel):
    """Returns the yield prediction [B, 1]."""

    def __init__(self, cfg: ModelConfig, n_past_years: int,
                 attention_impl: str = "torch"):
        super().__init__(cfg, n_past_years)
        self.weather_model = WeatherBERT(cfg, attention_impl)

    def forward(self, weather, coords, year, interval, weather_feature_mask,
                y_past, soil=None, practices=None, generator=None,
                sample_generator=None, eps=None, dropout_rate=None):
        predicted = self.encode(weather, coords, year, interval,
                                weather_feature_mask, generator, dropout_rate)
        imputed = _impute(weather, predicted, weather_feature_mask)
        return self.head(imputed, y_past)


class WeatherFormerYieldModel(_YieldModel):
    """Returns (yield_pred, z, mu_x, var_x) (reference
    weatherformer_yield_model.py:8-71).

    NOTE on z, as in the JAX package (reference inconsistency, preserved):
    this base model returns the IMPUTED z, while the sinusoid/mixture
    subclasses return the RAW reparameterized sample."""

    ENCODER_CLASS = WeatherFormer

    def __init__(self, cfg: ModelConfig, n_past_years: int,
                 attention_impl: str = "torch"):
        super().__init__(cfg, n_past_years)
        self.weather_model = self.ENCODER_CLASS(cfg, attention_impl)

    def sample(self, mu_x, var_x, weather, weather_feature_mask, y_past,
               sample_generator, eps):
        """(yield_pred, raw z, imputed z)."""
        z = mu_x + torch.sqrt(var_x) * _draw_eps(mu_x, sample_generator, eps)
        imputed = _impute(weather, z, weather_feature_mask)
        return self.head(imputed, y_past), z, imputed

    def forward(self, weather, coords, year, interval, weather_feature_mask,
                y_past, soil=None, practices=None, generator=None,
                sample_generator=None, eps=None, dropout_rate=None):
        mu_x, var_x, *prior = self.encode(weather, coords, year, interval,
                                          weather_feature_mask, generator,
                                          dropout_rate)
        out, z, imputed = self.sample(mu_x, var_x, weather,
                                      weather_feature_mask, y_past,
                                      sample_generator, eps)
        if not prior:
            return out, imputed, mu_x, var_x
        return (out, z, mu_x, var_x, *prior)


class WeatherFormerSinusoidYieldModel(WeatherFormerYieldModel):
    """Returns (yield, z, mu_x, var_x, mu_p, var_p)."""

    ENCODER_CLASS = WeatherFormerSinusoid


class WeatherFormerMixtureYieldModel(WeatherFormerYieldModel):
    """Returns (yield, z, mu_x, var_x, mu_k, var_k, log_w_k)."""

    ENCODER_CLASS = WeatherFormerMixture


class _AutoencoderVariational(_YieldModel):
    """Deterministic WeatherBERT encoder + post-hoc variational head:
    mu_x = impute(weather, encoder(x), mask), var_x = clip(exp(MLP(mu_x)),
    1e-8, 1), z = impute(weather, mu_x + sqrt(var_x) * eps, mask), the
    yield head on z."""

    def __init__(self, cfg: ModelConfig, n_past_years: int,
                 attention_impl: str = "torch"):
        super().__init__(cfg, n_past_years)
        f = cfg.weather_dim
        self.weather_model = WeatherBERT(cfg, attention_impl)
        self.log_var_fc1 = nn.Linear(f, 4 * f)
        self.log_var_fc2 = nn.Linear(4 * f, f)
        self._make_priors()
        self._reset_priors()

    def posterior(self, weather, coords, year, interval, weather_feature_mask,
                  y_past, generator, sample_generator, eps, dropout_rate):
        """(yield_pred, z, mu_x, var_x)."""
        pred = self.encode(weather, coords, year, interval,
                           weather_feature_mask, generator, dropout_rate)
        mu_x = _impute(weather, pred, weather_feature_mask)
        log_var_x = self.log_var_fc2(F.gelu(self.log_var_fc1(mu_x)))
        var_x = torch.clamp(torch.exp(log_var_x), 1e-8, 1.0)
        z = _impute(weather, mu_x + torch.sqrt(var_x)
                    * _draw_eps(mu_x, sample_generator, eps),
                    weather_feature_mask)
        return self.head(z, y_past), z, mu_x, var_x


class WeatherAutoencoderSineYieldModel(_AutoencoderVariational):
    """A learnable sinusoidal prior mu_p = A_p * sin(theta_p(pos)), var_p =
    clip(exp(log_var_p), 1e-8, 1) (reference
    weatherautoencoder_sine_yield_model.py:10-111, as the JAX package
    re-designed it with cfg.max_len). Returns (yield, z, mu_x, var_x, mu_p,
    var_p)."""

    def _make_priors(self):
        cfg = self.cfg
        self.theta_p = nn.Linear(1, cfg.weather_dim)
        self.A_p = nn.Parameter(torch.empty(1, cfg.max_len, cfg.weather_dim))
        self.log_var_p = nn.Parameter(
            torch.empty(1, cfg.max_len, cfg.weather_dim))

    def _reset_priors(self, generator=None) -> None:
        nn.init.normal_(self.A_p, 0.0, 0.1, generator=generator)
        nn.init.normal_(self.log_var_p, -1.0, 0.1, generator=generator)

    def forward(self, weather, coords, year, interval, weather_feature_mask,
                y_past, soil=None, practices=None, generator=None,
                sample_generator=None, eps=None, dropout_rate=None):
        b, t, f = weather.shape
        out, z, mu_x, var_x = self.posterior(
            weather, coords, year, interval, weather_feature_mask, y_past,
            generator, sample_generator, eps, dropout_rate)
        positions = torch.arange(self.cfg.max_len, dtype=torch.float32,
                                 device=weather.device)[None, :, None]
        theta = self.theta_p(positions)                        # [1, L, F]
        mu_p = (self.A_p * torch.sin(theta))[:, :t].expand(b, t, f)
        var_p = torch.clamp(torch.exp(self.log_var_p[:, :t]), 1e-8,
                            1.0).expand(b, t, f)
        return out, z, mu_x, var_x, mu_p, var_p


class WeatherAutoencoderMixtureYieldModel(_AutoencoderVariational):
    """A learnable Gaussian-mixture prior mu_k, var_k [k, max_len, F] with
    uniform log-weights log(1/k) (reference
    weatherautoencoder_mixture_yield_model.py:10-96, with the weights the
    JAX package added). Returns (yield, z, mu_x, var_x, mu_k, var_k,
    log_w_k)."""

    def _make_priors(self):
        cfg = self.cfg
        self.mu_k = nn.Parameter(torch.empty(cfg.k, cfg.max_len,
                                             cfg.weather_dim))
        self.log_var_k = nn.Parameter(torch.empty(cfg.k, cfg.max_len,
                                                  cfg.weather_dim))

    def _reset_priors(self, generator=None) -> None:
        nn.init.normal_(self.mu_k, 0.0, 0.1, generator=generator)
        nn.init.normal_(self.log_var_k, -1.0, 0.1, generator=generator)

    def forward(self, weather, coords, year, interval, weather_feature_mask,
                y_past, soil=None, practices=None, generator=None,
                sample_generator=None, eps=None, dropout_rate=None):
        b, t, f = weather.shape
        k = self.cfg.k
        out, z, mu_x, var_x = self.posterior(
            weather, coords, year, interval, weather_feature_mask, y_past,
            generator, sample_generator, eps, dropout_rate)
        mu_k = self.mu_k[None, :, :t].expand(b, k, t, f)
        var_k = torch.clamp(torch.exp(self.log_var_k[None, :, :t]), 1e-8,
                            1.0).expand(b, k, t, f)
        log_w_k = torch.full((b, k), -math.log(float(k)),
                             device=weather.device)
        return out, z, mu_x, var_x, mu_k, var_k, log_w_k


class LinearYieldModel(nn.Module):
    """Single Linear on flattened masked weather + y_past
    (reference linear_yield_model.py:8-80)."""

    def __init__(self, cfg: ModelConfig, n_past_years: int, seq_len: int):
        super().__init__()
        self.cfg = cfg
        self.linear = nn.Linear(seq_len * cfg.weather_dim + n_past_years + 1,
                                1)

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        torch_linear_init_(self.linear.weight, self.linear.bias, generator)

    def forward(self, weather, coords, year, interval, weather_feature_mask,
                y_past, soil=None, practices=None, generator=None,
                sample_generator=None, eps=None, dropout_rate=None):
        b = weather.shape[0]
        x = (weather * ~weather_feature_mask).reshape(b, -1)
        return self.linear(torch.cat([x, y_past], dim=1))


def transfer_encoder_into_yield(yield_state: dict,
                                encoder_state: dict) -> dict:
    """The yield model's state dict with its `weather_model.*` entries
    initialised from a pretrained encoder's state dict by the JAX rules
    (weathermodel_tpu/models/yield_models.py:296: `load_pretrained` with
    load_out_proj=True, so trunk AND out_proj transfer). A model with no
    encoder (LinearYieldModel) is returned unchanged, with a warning."""
    prefix = ENCODER + "."
    encoder = {k[len(prefix):]: v for k, v in yield_state.items()
               if k.startswith(prefix)}
    if not encoder:
        logger.warning("model has no weather_model subtree; skipping "
                       "pretrained transfer")
        return yield_state
    merged = load_pretrained(ENCODER, encoder, encoder_state,
                             load_out_proj=True)
    out = dict(yield_state)
    out.update({prefix + k: v for k, v in merged.items()})
    return out
