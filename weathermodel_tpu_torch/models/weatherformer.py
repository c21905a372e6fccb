"""The WeatherFormer family, variational weather encoders (port of
weathermodel_tpu/models/weatherformer.py):

* WeatherFormer (reference weatherformer.py:17-94): WeatherBERT's trunk with
  a doubled output head; the output, cast to fp32, splits into (mu,
  log var), and var = clamp(exp(log var), 1e-6, 1). Returns (mu_x, var_x).
* WeatherFormerSinusoid (reference weatherformer_sinusoid.py:16-125): adds
  a learnable sinusoidal prior mu_p = sum_k A_k sin(f_k * scaled_pos + phi_k),
  scaled_pos = pos * 2 pi * interval / 365, and a learnable log-variance
  prior. Returns (mu_x, var_x, mu_p, var_p).
* WeatherFormerMixture (reference weatherformer_mixture.py:17-147): K
  sinusoidal component means (not summed over k), per-component
  log-variances and mixture logits. Returns (mu_x, var_x, mu_k, var_k,
  log_w_k), log_w_k = log_softmax(logits).

The prior parameters are top-level parameters with the JAX package's names
and shapes ([1, k, max_len, F], ...), so a reference `.pth` loads as it is
(weathermodel_tpu/models/transfer.py:27-30). They and the prior's arithmetic
stay fp32 whatever the compute dtype, as in the JAX package.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from weathermodel_tpu_torch.models.blocks import linear
from weathermodel_tpu_torch.models.weatherbert import WeatherEncoderCore
from weathermodel_tpu_torch.utils.config import ModelConfig

VAR_MIN, VAR_MAX = 1e-6, 1.0


def _var(log_var):
    return torch.clamp(torch.exp(log_var), VAR_MIN, VAR_MAX)


class WeatherFormer(WeatherEncoderCore):
    """Encoder with a (mu, var) head; returns fp32 [B, T, output_dim] each."""

    def __init__(self, cfg: ModelConfig, attention_impl: str = "torch",
                 ffn_impl: str = "torch", gmm_impl: str = "kernel",
                 remat: bool = False):
        super().__init__(cfg, attention_impl, ffn_impl, gmm_impl, remat)
        self.out_proj = nn.Linear(cfg.hidden_dim, 2 * cfg.output_dim)

    def posterior(self, weather, coords, year, interval, weather_feature_mask,
                  generator=None, dropout_rate=None):
        """((mu_x, var_x), the MoE aux loss or None)."""
        hidden, aux = self.encode(weather, coords, year, interval,
                                  weather_feature_mask, generator,
                                  dropout_rate)
        out = linear(hidden, self.out_proj).float()
        mu_x, log_var_x = out.split(self.cfg.output_dim, dim=-1)
        return (mu_x, _var(log_var_x)), aux

    def forward(self, weather, coords, year, interval, weather_feature_mask,
                generator=None, dropout_rate=None, return_moe_aux=False):
        outputs, aux = self.posterior(weather, coords, year, interval,
                                      weather_feature_mask, generator,
                                      dropout_rate)
        return (outputs, aux) if return_moe_aux else outputs


class _SinusoidPrior(WeatherFormer):
    """frequency, phase and amplitude [1, k, max_len, F], N(0, 0.1^2) at
    init, and the subclass's log-variance parameter(s). F is the config
    field named by PRIOR_DIM, as in the JAX package."""

    PRIOR_DIM = "weather_dim"

    def __init__(self, cfg: ModelConfig, attention_impl: str = "torch",
                 ffn_impl: str = "torch", gmm_impl: str = "kernel",
                 remat: bool = False):
        super().__init__(cfg, attention_impl, ffn_impl, gmm_impl, remat)
        shape = (1, cfg.k, cfg.max_len, getattr(cfg, self.PRIOR_DIM))
        self.frequency = nn.Parameter(torch.empty(shape))
        self.phase = nn.Parameter(torch.empty(shape))
        self.amplitude = nn.Parameter(torch.empty(shape))
        self._make_prior_params()
        self._reset_prior()

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        """The trunk's and heads' init, then the prior's: N(0, 0.1^2) for
        the sinusoid parameters, N(-1, 0.1^2) for the log-variances
        (`_normal_init(0.1, shift)`)."""
        super().reset_parameters(generator)
        self._reset_prior(generator)

    def _reset_prior(self, generator=None) -> None:
        for name in ("frequency", "phase", "amplitude"):
            nn.init.normal_(getattr(self, name), 0.0, 0.1, generator=generator)

    def _sines(self, interval, t):
        """A_k sin(f_k * scaled_pos + phi_k) over the first t positions:
        [B, k, t, F] (reference weatherformer_sinusoid.py:113-116)."""
        pos = torch.arange(self.cfg.max_len, dtype=torch.float32,
                           device=interval.device)[:t]
        sp = (pos[None, None, :, None] * 2.0 * math.pi
              * interval.float().reshape(-1, 1, 1, 1) / 365.0)
        return self.amplitude[:, :, :t] * torch.sin(
            self.frequency[:, :, :t] * sp + self.phase[:, :, :t])


class WeatherFormerSinusoid(_SinusoidPrior):
    """Returns (mu_x, var_x, mu_p, var_p), each fp32 [B, T, F]."""

    def _make_prior_params(self):
        self.log_var_prior = nn.Parameter(
            torch.empty(1, self.cfg.max_len, self.cfg.weather_dim))

    def _reset_prior(self, generator=None) -> None:
        super()._reset_prior(generator)
        nn.init.normal_(self.log_var_prior, -1.0, 0.1, generator=generator)

    def forward(self, weather, coords, year, interval, weather_feature_mask,
                generator=None, dropout_rate=None, return_moe_aux=False):
        (mu_x, var_x), aux = self.posterior(weather, coords, year, interval,
                                            weather_feature_mask, generator,
                                            dropout_rate)
        b, t, f = weather.shape
        mu_p = self._sines(interval, t).sum(dim=1)
        var_p = _var(self.log_var_prior[:, :t]).expand(b, t, f)
        outputs = (mu_x, var_x, mu_p, var_p)
        return (outputs, aux) if return_moe_aux else outputs


class WeatherFormerMixture(_SinusoidPrior):
    """Returns (mu_x, var_x, mu_k, var_k, log_w_k): [B, T, F] twice,
    [B, k, T, F] twice and [B, k], all fp32."""

    PRIOR_DIM = "output_dim"

    def _make_prior_params(self):
        cfg = self.cfg
        self.log_var_k = nn.Parameter(
            torch.empty(1, cfg.k, cfg.max_len, cfg.output_dim))
        self.mixture_logits = nn.Parameter(torch.empty(1, cfg.k))

    def _reset_prior(self, generator=None) -> None:
        super()._reset_prior(generator)
        nn.init.normal_(self.log_var_k, -1.0, 0.1, generator=generator)
        nn.init.constant_(self.mixture_logits, -math.log(float(self.cfg.k)))

    def forward(self, weather, coords, year, interval, weather_feature_mask,
                generator=None, dropout_rate=None, return_moe_aux=False):
        (mu_x, var_x), aux = self.posterior(weather, coords, year, interval,
                                            weather_feature_mask, generator,
                                            dropout_rate)
        b, t, _ = weather.shape
        k, f = self.cfg.k, self.cfg.output_dim
        mu_k = self._sines(interval, t)
        var_k = _var(self.log_var_k[:, :, :t]).expand(b, k, t, f)
        log_w_k = F.log_softmax(self.mixture_logits, dim=1).expand(b, k)
        outputs = (mu_x, var_x, mu_k, var_k, log_w_k)
        return (outputs, aux) if return_moe_aux else outputs
