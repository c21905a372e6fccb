"""WeatherBERT in the port against the JAX package: the weight converter,
and the eval forward at mini and small on the same weights and inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.models import WeatherBERT as JaxWeatherBERT
from weathermodel_tpu.models.transfer import convert_torch_state_dict
from weathermodel_tpu.utils.config import (
    model_config_for_size as jax_config_for_size,
)
from weathermodel_tpu_torch.cli.pretrain import make_model
from weathermodel_tpu_torch.models.transfer import state_dict_from_jax_params
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.utils.config import model_config_for_size
from test_torch_port_jax_params import jax_compiled, jax_params_from_state

T = 24


def _inputs(b=3, t=T, seed=0):
    rng = np.random.default_rng(seed)
    weather = rng.normal(size=(b, t, 31)).astype(np.float32)
    coords = rng.uniform(-90, 90, size=(b, 2)).astype(np.float32)
    year = (1985.0 + np.arange(t, dtype=np.float32) / 52.0
            + rng.integers(0, 15, size=(b, 1))).astype(np.float32)
    interval = np.full((b, 1), 7.0, np.float32)
    mask = rng.random((b, t, 31)) < 0.15
    return weather, coords, year, interval, mask


def _jax_params(size, max_len=T, seed=0):
    """The port's init from `seed` as a flax tree: the tree's structure from
    flax's init (traced, not run), the values through the inverse of
    `state_dict_from_jax_params` (test_torch_port_jax_params.py)."""
    cfg = jax_config_for_size(size, max_len=max_len)
    init_inputs = [jnp.asarray(a) for a in _inputs(1, max_len)]
    model = make_model("weatherbert", model_config_for_size(
        size, max_len=max_len), "torch")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return jax_params_from_state(
        lambda: JaxWeatherBERT(cfg).init(jax.random.PRNGKey(seed),
                                         *init_inputs),
        state_dict_from_jax_params, model.state_dict())


def _port_forward(size, params, impl, dtype, inputs):
    cfg = model_config_for_size(size, max_len=T, compute_dtype=dtype)
    model = make_model("weatherbert", cfg, impl).eval()  # dropout off
    model.load_state_dict(state_dict_from_jax_params(params))
    with torch.inference_mode():
        out = model(*(torch.from_numpy(a) for a in inputs))
    assert out.dtype == torch.float32
    return out.numpy()


def _jax_forward(size, params, impl, dtype, inputs):
    cfg = jax_config_for_size(size, max_len=T, compute_dtype=dtype)
    model = JaxWeatherBERT(cfg, attention_impl=impl)
    return np.asarray(jax_compiled(model.apply, params,
                                   *(jnp.asarray(a) for a in inputs)))


@pytest.mark.parametrize("size", ["mini", "large"])
def test_converter_round_trip_is_bit_exact(size):
    params = _jax_params(size, max_len=8)
    sd = state_dict_from_jax_params(params)
    n_layers = model_config_for_size(size).num_layers
    back = convert_torch_state_dict(sd, n_layers)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    # the keys are exactly the port model's state dict
    model = make_model("weatherbert", model_config_for_size(size), "torch")
    assert set(sd) == set(model.state_dict())


# fp32 tolerances: vs "xla" the bar of tests/test_torch_parity.py (the
# reference torch encoder vs the JAX model); vs "pallas_qkv" the JAX
# package's own bar for the fused kernel (tests/test_pallas_fused_qkv.py)
@pytest.mark.parametrize("size", ["mini", "small"])
@pytest.mark.parametrize("port_impl,jax_impl,atol", [
    ("torch", "xla", 2e-5), ("fused_qkv", "pallas_qkv", 5e-5)])
def test_forward_matches_jax_fp32(size, port_impl, jax_impl, atol):
    params = _jax_params(size)
    inputs = _inputs()
    want = _jax_forward(size, params, jax_impl, "float32", inputs)
    got = _port_forward(size, params, port_impl, "float32", inputs)
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-4)


@pytest.mark.parametrize("port_impl,jax_impl", [("torch", "xla"),
                                                ("fused_qkv", "pallas_qkv")])
def test_forward_matches_jax_bf16(port_impl, jax_impl):
    """bf16: both sides round at the same points (norm1 statistics in fp32,
    norm2's in bf16, as blocks.py:285,391-396 do), but the two frameworks'
    bf16 matmuls and reductions sum in other orders, so a value near a
    rounding boundary can land one bf16 ulp (2^-8 relative) apart, and that
    spreads through the layers. Bound: max|diff| <= 5e-2 * RMS(JAX) and
    RMS(diff) <= 1e-2 * RMS(JAX)."""
    params = _jax_params("mini")
    inputs = _inputs()
    want = _jax_forward("mini", params, jax_impl, "bfloat16", inputs)
    got = _port_forward("mini", params, port_impl, "bfloat16", inputs)
    rms = np.sqrt(np.mean(want ** 2))
    diff = got - want
    assert np.abs(diff).max() <= 5e-2 * rms
    assert np.sqrt(np.mean(diff ** 2)) <= 1e-2 * rms


def test_unported_options_raise():
    cfg = model_config_for_size("mini")
    with pytest.raises(ValueError, match="Unknown model type"):
        make_model("nosuchmodel", cfg, "torch")
