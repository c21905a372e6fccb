"""JAX parameter trees from the port's seeded init, for the parity tests.

flax's `init` draws its parameters op by op outside `jit`: in a fresh test
worker that compiles one small program an op, seconds a model, and each
parity test pays it again on every worker it lands on. The parity tests
need the same weights on both sides, not flax's draws, so they take the
port's init (the JAX package's distributions, `reset_parameters`) and carry
it into a flax tree with `jax_params_from_state`: the tree's structure from
`jax.eval_shape` of the init (traced, never run) and each leaf from the
port's state dict through the inverse of the converter the tests already
hold (models/transfer.py). The tests below hold that inverse exact. `jax_compiled` runs flax's
`apply` as one compiled program for the same reason."""

import jax
import numpy as np
import pytest
import torch

from weathermodel_tpu.models import WeatherBERT as JaxWeatherBERT
from weathermodel_tpu.models import WeatherFormerMixture as JaxMixture
from weathermodel_tpu.models import cnn as jax_cnn
from weathermodel_tpu.models import yield_models as jax_yield_models
from weathermodel_tpu.utils.config import ModelConfig as JaxModelConfig
from weathermodel_tpu_torch.cli.pretrain import make_model
from weathermodel_tpu_torch.models import cnn, yield_models
from weathermodel_tpu_torch.models.transfer import (
    cnn_state_dict_from_jax_params,
    state_dict_from_jax_params,
    yield_state_dict_from_jax_params,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.utils.config import ModelConfig


def jax_params_from_state(init, to_port, state_dict):
    """The flax tree whose image under `to_port` (a JAX-to-port converter
    that only moves and transposes entries, or adds zeros) is `state_dict`.
    `init()` returns the flax tree; only its shapes are traced. Each leaf
    entry is labelled with its index + 1 and sent through `to_port`, which
    says where every entry lands in the state dict."""
    leaves, treedef = jax.tree.flatten(jax.eval_shape(init))
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves]
    starts = np.cumsum([0] + sizes)
    probe = treedef.unflatten([
        np.arange(a + 1, a + 1 + n, dtype=np.float64).reshape(leaf.shape)
        for a, n, leaf in zip(starts, sizes, leaves)])
    flat = np.zeros(starts[-1])
    covered = np.zeros(starts[-1], bool)
    for key, ids in to_port(probe).items():
        ids = ids.numpy().astype(np.int64).ravel()
        value = state_dict[key].detach().double().numpy().ravel()
        flat[ids[ids > 0] - 1] = value[ids > 0]
        covered[ids[ids > 0] - 1] = True
    if not covered.all():
        raise ValueError(f"{int((~covered).sum())} entries of the flax tree "
                         "have no place in the state dict")
    return treedef.unflatten([
        flat[a:a + n].reshape(leaf.shape).astype(leaf.dtype)
        for a, n, leaf in zip(starts, sizes, leaves)])


def jax_compiled(fn, *args):
    """fn(*args) through one XLA program: flax's `apply` outside `jit`
    compiles an op at a time, seconds a model in a fresh worker. Compiled
    with `xla_allow_excess_precision` off, so that every bf16 operation
    rounds where it is written, as op by op."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def encoder_layer_state_dict(params) -> dict:
    """A flax encoder layer's tree -> the port layer's state dict, through
    the model converter (the layer as layer 0 of a model)."""
    p = params["params"] if "params" in params else params
    stub = {"kernel": np.zeros((1, 1), np.float32),
            "bias": np.zeros(1, np.float32)}
    sd = state_dict_from_jax_params({"core": {
        "in_proj": stub, "encoder": {"layer_0": p}}})
    prefix = "transformer_encoder.layers.0."
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def seeded_encoder_layer(layer, seed=0):
    """The JAX package's init distributions on a port encoder layer, drawn
    from `seed`: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for each weight and its
    bias, the LayerNorms at ones and zeros."""
    g = torch.Generator().manual_seed(seed)
    sd = layer.state_dict()
    with torch.no_grad():
        for k, v in sd.items():
            if k.startswith("norm"):
                v.fill_(1.0 if k.endswith("weight") else 0.0)
            else:
                bound = sd[k.replace("bias", "weight")].shape[1] ** -0.5
                v.uniform_(-bound, bound, generator=g)
    return layer


def moe_ffn_state_dict(params) -> dict:
    """A flax `MoEFFN` layer's tree (weathermodel_tpu/models/moe.py) -> the
    port's `MoEFFN` state dict: the router's kernel transposed, the expert
    weights as they are (models/transfer.py does the same inside a
    model)."""
    p = params["params"] if "params" in params else params
    return {"router.weight": torch.tensor(np.asarray(p["router"]["kernel"]).T),
            "router.bias": torch.tensor(np.asarray(p["router"]["bias"])),
            **{k: torch.tensor(np.asarray(p[k])) for k in (
                "expert_w1", "expert_b1", "expert_w2", "expert_b2")}}


def _seeded(model, seed=0):
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def _inputs(b=2, t=16, f=31):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(b, t, f)).astype(np.float32),
            np.zeros((b, 2), np.float32), np.full((b, t), 1990.0, np.float32),
            np.full((b, 1), 7.0, np.float32), np.zeros((b, t, f), bool))


MINI = dict(num_heads=4, num_layers=2, hidden_dim_factor=12, max_len=16,
            dropout_rate=0.0, k=3)


def _cases():
    key = jax.random.PRNGKey(0)
    y_past = np.zeros((2, 2), np.float32)
    yield ("weatherbert-moe",
           lambda: JaxWeatherBERT(JaxModelConfig(**MINI, num_experts=4)).init(
               key, *_inputs()),
           state_dict_from_jax_params,
           _seeded(make_model("weatherbert", ModelConfig(
               **MINI, num_experts=4), "torch")))
    yield ("weatherformermixture",
           lambda: JaxMixture(JaxModelConfig(**MINI)).init(key, *_inputs()),
           state_dict_from_jax_params,
           _seeded(make_model("weatherformermixture", ModelConfig(**MINI),
                              "torch")))
    yield ("yield-sinusoid",
           lambda: jax_yield_models.WeatherFormerSinusoidYieldModel(
               JaxModelConfig(**MINI), 1).init(
               {"params": key, "sample": key}, *_inputs(), y_past),
           yield_state_dict_from_jax_params,
           _seeded(yield_models.WeatherFormerSinusoidYieldModel(
               ModelConfig(**MINI), 1, "torch")))
    yield ("cnnrnn",
           lambda: jax_cnn.CNNRNNYieldModel(31, 1).init(
               key, *_inputs(t=104), y_past),
           cnn_state_dict_from_jax_params,
           _seeded(cnn.CNNRNNYieldModel(31, 1)))


@pytest.mark.parametrize("case", list(_cases()), ids=lambda c: c[0])
def test_params_from_the_port_state_invert_the_converter(case):
    """The tree has flax's structure and dtypes, and the converter takes it
    back to the port's state dict bit for bit."""
    _, init, to_port, model = case
    params = jax_params_from_state(init, to_port, model.state_dict())
    want = jax.eval_shape(init)
    assert jax.tree.structure(params) == jax.tree.structure(want)
    for got, leaf in zip(jax.tree.leaves(params), jax.tree.leaves(want)):
        assert got.shape == leaf.shape and got.dtype == leaf.dtype
    back = to_port(params)
    for k, v in back.items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_an_entry_without_a_place_raises():
    init = (lambda: JaxWeatherBERT(JaxModelConfig(**MINI)).init(
        jax.random.PRNGKey(0), *_inputs()))
    model = _seeded(make_model("weatherbert", ModelConfig(**MINI), "torch"))

    def drops_a_layer(params):
        sd = state_dict_from_jax_params(params)
        return {k: v for k, v in sd.items() if "layers.1." not in k}

    with pytest.raises(ValueError, match="no place"):
        jax_params_from_state(init, drops_a_layer, model.state_dict())
