"""The port's yield models against the JAX package's, at mini with the JAX
parameters carried across (`yield_state_dict_from_jax_params`), dropout
off: every output of every model, the four objectives' losses, and
`transfer_encoder_into_yield`.

flax draws the sampling models' eps from `make_rng("sample")`, which folds
its key, so eps cannot be redrawn on the port's side: it is recovered from
the JAX outputs as eps = (z - mu) / sqrt(var) on the masked features and
passed as `eps=`. The raw z of the sinusoid and mixture models is compared
on those features; every other output everywhere. fp32 bars: 2e-5
(tests/test_torch_parity.py:109-111); the bf16 case at the bf16 model bars
(max|diff| <= 5e-2 RMS, RMS(diff) <= 1e-2 RMS). WeatherFormer runs JAX
`pallas` (in the interpreter) against the port's `flash` plain version;
the rest `xla` against `torch`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.models import WeatherBERT as JaxWeatherBERT
from weathermodel_tpu.models import WeatherFormer as JaxWeatherFormer
from weathermodel_tpu.models import yield_models as jax_models
from weathermodel_tpu.train import yield_trainer as jax_trainer
from weathermodel_tpu.utils.config import ModelConfig as JaxModelConfig
from weathermodel_tpu_torch.cli.pretrain import make_model
from weathermodel_tpu_torch.models import yield_models
from weathermodel_tpu_torch.models.transfer import (
    state_dict_from_jax_params,
    yield_state_dict_from_jax_params,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.train.yield_trainer import (
    YieldBatch,
    yield_losses,
)
from weathermodel_tpu_torch.utils.config import ModelConfig
from test_torch_port_jax_params import jax_compiled, jax_params_from_state

B, T, F, N_PAST = 4, 32, 31, 1
MINI = dict(num_heads=4, num_layers=2, hidden_dim_factor=12, max_len=T,
            dropout_rate=0.0, k=3)
BETA = 0.5
# model -> (objective, whether z is the raw sample, JAX impl, port impl)
MODELS = {
    "WeatherBERTYieldModel": ("mse", False, "xla", "torch"),
    "WeatherFormerYieldModel": ("elbo", False, "pallas", "flash"),
    "WeatherFormerSinusoidYieldModel": ("elbo_sinusoid", True, "xla",
                                        "torch"),
    "WeatherFormerMixtureYieldModel": ("elbo_mixture", True, "xla", "torch"),
    "WeatherAutoencoderSineYieldModel": ("elbo_sinusoid", False, "xla",
                                         "torch"),
    "WeatherAutoencoderMixtureYieldModel": ("elbo_mixture", False, "xla",
                                            "torch"),
    "LinearYieldModel": ("mse", False, None, None),
}


PORT_NAMES = {JaxWeatherBERT: "weatherbert", JaxWeatherFormer: "weatherformer"}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    weather = rng.normal(size=(B, T, F)).astype(np.float32)
    coords = rng.uniform(-90, 90, size=(B, 2)).astype(np.float32)
    year = (2005.0 + np.arange(T, dtype=np.float32) / 52
            + rng.integers(0, 5, (B, 1))).astype(np.float32)
    interval = np.full((B, 1), 7.0, np.float32)
    mask = np.ones((B, T, F), dtype=bool)   # the Khaki static mask
    mask[:, :, [7, 8, 11, 1, 2, 29]] = False
    y_past = rng.normal(size=(B, N_PAST + 1)).astype(np.float32)
    return weather, coords, year, interval, mask, y_past


def _models(name, compute_dtype="float32", impls=None):
    """(JAX model, its params, the port model with them loaded); `impls`
    (JAX, port) replaces the model's attention impls. The weights are the
    port's seeded init carried into the flax tree
    (test_torch_port_jax_params.py)."""
    jax_impl, port_impl = impls or MODELS[name][2:]
    jcfg = JaxModelConfig(**MINI, compute_dtype=compute_dtype)
    pcfg = ModelConfig(**MINI, compute_dtype=compute_dtype)
    if name == "LinearYieldModel":
        jm = jax_models.LinearYieldModel(jcfg, N_PAST, T)
        pm = yield_models.LinearYieldModel(pcfg, N_PAST, T)
    else:
        jm = getattr(jax_models, name)(jcfg, N_PAST, attention_impl=jax_impl)
        pm = getattr(yield_models, name)(pcfg, N_PAST, port_impl)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    params = jax_params_from_state(
        lambda: jm.init({"params": jax.random.PRNGKey(0),
                         "sample": jax.random.PRNGKey(1)},
                        *map(jnp.asarray, _inputs())),
        yield_state_dict_from_jax_params, pm.state_dict())
    return jm, params, pm.eval()


def _eps(outputs, mask):
    """eps recovered from the JAX (pred, z, mu, var, ...) on the mask."""
    z, mu, var = (np.asarray(a) for a in outputs[1:4])
    return np.where(mask, (z - mu) / np.sqrt(var), 0.0).astype(np.float32)


def _port(pm, inputs, eps=None):
    with torch.no_grad():
        return pm(*map(torch.from_numpy, inputs),
                  eps=None if eps is None else torch.from_numpy(eps))


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", list(MODELS))
def test_yield_model_outputs_match_jax(name):
    inputs = _inputs(1)
    jm, params, pm = _models(name)
    want = _as_tuple(jax_compiled(
        lambda p, *a: jm.apply(p, *a, rngs={"sample": jax.random.PRNGKey(2)}),
        params, *map(jnp.asarray, inputs)))
    eps = _eps(want, inputs[4]) if len(want) > 1 else None
    got = _as_tuple(_port(pm, inputs, eps))
    assert len(got) == len(want)
    assert got[0].shape == (B, 1)
    raw_z = MODELS[name][1]
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, i
        if i == 1 and raw_z:
            g, w = g[inputs[4]], w[inputs[4]]
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=0, err_msg=str(i))


def test_bf16_weatherformer_yield_model_at_the_bf16_bars():
    inputs = _inputs(2)
    jm, params, pm = _models("WeatherFormerSinusoidYieldModel", "bfloat16")
    want = jax_compiled(
        lambda p, *a: jm.apply(p, *a, rngs={"sample": jax.random.PRNGKey(3)}),
        params, *map(jnp.asarray, inputs))
    got = _port(pm, inputs, _eps(want, inputs[4]))
    for i in (0, 2, 3, 4, 5):   # prediction, mu, var and the prior
        w = np.asarray(want[i])
        diff = got[i].numpy() - w
        rms = np.sqrt(np.mean(w ** 2))
        assert np.abs(diff).max() <= 5e-2 * rms, i
        assert np.sqrt(np.mean(diff ** 2)) <= 1e-2 * rms, i


@pytest.mark.parametrize("name", ["WeatherBERTYieldModel",
                                  "WeatherFormerYieldModel",
                                  "WeatherFormerSinusoidYieldModel",
                                  "WeatherFormerMixtureYieldModel"])
def test_yield_losses_match_jax(name):
    """The objective of each family (mse, elbo, elbo_sinusoid,
    elbo_mixture) on a batch whose last row is padding (weight 0), with
    plain attention on both sides."""
    objective = MODELS[name][0]
    inputs = _inputs(3)
    weather, coords, year, interval, mask, y_past = inputs
    rng = np.random.default_rng(4)
    y = rng.normal(size=(B, 1)).astype(np.float32)
    weights = np.array([1, 1, 1, 0], np.float32)
    soil = np.zeros((B, N_PAST + 1, 11, 6), np.float32)
    practices = np.zeros((B, N_PAST + 1, 14), np.float32)
    jm, params, pm = _models(name, impls=("xla", "torch"))
    key = jax.random.PRNGKey(5)
    rngs = None if objective == "mse" else {"sample": key}
    jbatch = jax_trainer.YieldBatch(*map(jnp.asarray, (
        weather, coords, year, interval, mask, y_past, y, weights, soil,
        practices)))
    want = jax_compiled(lambda p, b: jax_trainer._yield_losses(
        jm, objective, p, b, BETA, True, rngs), params, jbatch)
    eps = None
    if rngs:
        eps = _eps(jax_compiled(lambda p, *a: jm.apply(p, *a, rngs=rngs),
                                params, *map(jnp.asarray, inputs)), mask)
    batch = YieldBatch(*map(torch.from_numpy, (
        weather, coords, year, interval, mask, y_past, y, weights, soil,
        practices)))
    got = yield_losses(objective, _port(pm, inputs, eps), batch, BETA)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=2e-5,
                                   atol=2e-5, err_msg=k)
    if objective != "mse":
        assert float(want["kl_term"]) > 1e-3


@pytest.mark.parametrize("yield_name,encoder", [
    ("WeatherFormerYieldModel", JaxWeatherFormer),
    ("WeatherFormerYieldModel", JaxWeatherBERT),
    ("WeatherBERTYieldModel", JaxWeatherBERT),
    ("LinearYieldModel", JaxWeatherBERT)])
def test_transfer_encoder_into_yield_matches_jax(yield_name, encoder):
    """Trunk and out_proj from a pretrained encoder (out_proj only where its
    shape matches: not a WeatherBERT's into a WeatherFormer); a model with
    no encoder keeps its state."""
    _, params, _ = _models(yield_name)
    port_encoder = make_model(PORT_NAMES[encoder], ModelConfig(**MINI),
                              "torch")
    port_encoder.reset_parameters(torch.Generator().manual_seed(9))
    enc = jax_params_from_state(
        lambda: encoder(JaxModelConfig(**MINI)).init(
            jax.random.PRNGKey(9), *map(jnp.asarray, _inputs()[:5])),
        state_dict_from_jax_params, port_encoder.state_dict())
    want = yield_state_dict_from_jax_params(
        jax_models.transfer_encoder_into_yield(params, enc))
    got = yield_models.transfer_encoder_into_yield(
        yield_state_dict_from_jax_params(params),
        state_dict_from_jax_params(enc))
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    if yield_name != "LinearYieldModel":
        assert torch.equal(got["weather_model.in_proj.weight"],
                           state_dict_from_jax_params(enc)["in_proj.weight"])
