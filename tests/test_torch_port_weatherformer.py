"""The WeatherFormer family in the port against the JAX package: the eval
forward of the three models at mini and small on the same weights and
inputs, and the weight converter's round trip with the prior parameters."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.models import WeatherFormer as JaxWeatherFormer
from weathermodel_tpu.models import WeatherFormerMixture as JaxMixture
from weathermodel_tpu.models import WeatherFormerSinusoid as JaxSinusoid
from weathermodel_tpu.models.transfer import convert_torch_state_dict
from weathermodel_tpu.utils.config import (
    model_config_for_size as jax_config_for_size,
)
from weathermodel_tpu_torch.cli.pretrain import make_model
from weathermodel_tpu_torch.models.transfer import state_dict_from_jax_params
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.utils.config import model_config_for_size

T = 24
JAX_MODELS = {"weatherformer": JaxWeatherFormer,
              "weatherformersinusoid": JaxSinusoid,
              "weatherformermixture": JaxMixture}
# prior components: the sinusoid's default and the mixture's (the CLI's k)
K = {"weatherformer": 4, "weatherformersinusoid": 4,
     "weatherformermixture": 7}


def _inputs(b=3, t=T, seed=0):
    rng = np.random.default_rng(seed)
    weather = rng.normal(size=(b, t, 31)).astype(np.float32)
    coords = rng.uniform(-90, 90, size=(b, 2)).astype(np.float32)
    year = (1985.0 + np.arange(t, dtype=np.float32) / 52.0
            + rng.integers(0, 15, size=(b, 1))).astype(np.float32)
    interval = rng.choice([1.0, 7.0, 30.0], size=(b, 1)).astype(np.float32)
    mask = rng.random((b, t, 31)) < 0.15
    return weather, coords, year, interval, mask


@functools.cache
def _jax_params(name, size, max_len=T, seed=0):
    cfg = jax_config_for_size(size, max_len=max_len, k=K[name])
    params = JAX_MODELS[name](cfg).init(
        jax.random.PRNGKey(seed), *(jnp.asarray(a) for a in _inputs(1,
                                                                   max_len)))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name", list(JAX_MODELS))
def test_converter_round_trip_is_bit_exact(name):
    params = _jax_params(name, "mini", max_len=8)
    sd = state_dict_from_jax_params(params)
    back = convert_torch_state_dict(sd, 2)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    # the keys and shapes are exactly the port model's
    model = make_model(name, model_config_for_size("mini", max_len=8,
                                                   k=K[name]), "torch")
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}


# fp32 bars of tests/test_torch_port_model.py: 2e-5 against "xla" (the
# reference torch encoder's bar), 5e-5 against the Pallas kernel. The
# plain attention path runs the same code at every width, so mini covers
# it; small holds the flash path against the Pallas kernel at the default
# run's head dim (20).
@pytest.mark.parametrize("size,port_impl,jax_impl,atol", [
    ("mini", "torch", "xla", 2e-5), ("mini", "flash", "pallas", 5e-5),
    ("small", "flash", "pallas", 5e-5)])
@pytest.mark.parametrize("name", list(JAX_MODELS))
def test_forward_matches_jax_fp32(name, size, port_impl, jax_impl, atol):
    params = _jax_params(name, size)
    inputs = _inputs()
    cfg = jax_config_for_size(size, max_len=T, k=K[name])
    # jitted: one compile instead of the interpreted kernels' op-by-op
    # dispatch (1-3 s less a case on the CPU)
    want = jax.jit(JAX_MODELS[name](cfg, attention_impl=jax_impl).apply)(
        params, *(jnp.asarray(a) for a in inputs))
    model = make_model(name, model_config_for_size(size, max_len=T,
                                                   k=K[name]), port_impl)
    model.load_state_dict(state_dict_from_jax_params(params))
    with torch.inference_mode():
        got = model.eval()(*(torch.from_numpy(a) for a in inputs))
    assert len(got) == len(want)
    for i, (a, e) in enumerate(zip(got, want)):
        assert a.dtype == torch.float32 and a.shape == e.shape, i
        np.testing.assert_allclose(a.numpy(), np.asarray(e), atol=atol,
                                   rtol=1e-4, err_msg=f"output {i}")


def test_reset_parameters_draws_the_priors_from_the_generator():
    cfg = model_config_for_size("mini", max_len=T, k=7)
    a, b = (make_model("weatherformermixture", cfg, "torch")
            for _ in range(2))
    for m in (a, b):
        m.reset_parameters(torch.Generator().manual_seed(3))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert torch.allclose(a.mixture_logits, torch.full((1, 7), -np.log(7.0)))
    assert abs(a.log_var_k.mean().item() + 1.0) < 0.01
    assert abs(a.frequency.std().item() - 0.1) < 0.01
