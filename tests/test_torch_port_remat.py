"""Per-layer rematerialization (`--remat`: models/blocks.py's
TransformerEncoder runs each layer under `torch.utils.checkpoint`) against
the JAX package's `remat=True` (JAX tests/test_tensor_parallel.py's
`test_remat_encoder_matches_plain`) and against the port without it.

fp32, dropout off: the forward and every gradient of WeatherBERT and
WeatherFormer at mini against JAX's at 2e-5. With dropout on and the
kernels' autograd Functions (their plain versions here), remat gives the
outputs and gradients of the run without it bit for bit in fp32 and bf16,
and leaves the caller's generator where the run without it leaves it. A
model with MoE layers refuses remat with JAX's text."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.models import WeatherBERT as JaxWeatherBERT
from weathermodel_tpu.models import WeatherFormer as JaxWeatherFormer
from weathermodel_tpu.utils.config import (
    model_config_for_size as jax_config_for_size,
)
from weathermodel_tpu_torch.cli.pretrain import make_model
from weathermodel_tpu_torch.models.transfer import state_dict_from_jax_params
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.utils.config import model_config_for_size

from test_torch_port_jax_params import jax_compiled, jax_params_from_state

T, B = 16, 3
JAX_MODELS = {"weatherbert": JaxWeatherBERT, "weatherformer": JaxWeatherFormer}
# the attention kernels' autograd Functions of each family (B1 train and
# B2, B3f and B3b: their plain versions on the CPU)
KERNEL_IMPLS = {"weatherbert": "fused_qkv", "weatherformer": "flash"}


def _inputs():
    rng = np.random.default_rng(0)
    weather = rng.normal(size=(B, T, 31)).astype(np.float32)
    coords = rng.uniform(-90, 90, (B, 2)).astype(np.float32)
    year = (1990.0 + np.arange(T, dtype=np.float32) * 7 / 365
            + rng.integers(0, 10, (B, 1))).astype(np.float32)
    interval = np.full((B, 1), 7.0, np.float32)
    mask = rng.random((B, T, 31)) < 0.3
    return weather, coords, year, interval, mask


def _port(name, impl, remat, **overrides):
    cfg = model_config_for_size("mini", max_len=T, **overrides)
    model = make_model(name, cfg, impl, remat=remat)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.train()


def _port_run(model, generator=None):
    """The outputs and every gradient of sum(out * cot) over the model's
    outputs."""
    out = model(*(torch.from_numpy(a) for a in _inputs()),
                generator=generator)
    outs = out if isinstance(out, tuple) else (out,)
    rng = np.random.default_rng(1)
    loss = sum((o.float() * torch.from_numpy(rng.normal(
        size=o.shape).astype(np.float32))).sum() for o in outs)
    loss.backward()
    return ([o.detach() for o in outs],
            {k: p.grad for k, p in model.named_parameters()})


@pytest.mark.parametrize("name", list(JAX_MODELS))
def test_remat_matches_jax_remat(name):
    """fp32, dropout off: the port with remat against JAX's model built
    with remat=True on the same weights, the forward and every gradient at
    2e-5 (one layer, to keep JAX's compile short)."""
    model = _port(name, "torch", True, dropout_rate=0.0,
                  compute_dtype="float32", num_layers=1)
    outs, grads = _port_run(model)
    cfg = jax_config_for_size("mini", max_len=T, dropout_rate=0.0,
                              compute_dtype="float32", num_layers=1)
    jmodel = JAX_MODELS[name](cfg, attention_impl="xla", remat=True)
    args = [jnp.asarray(a) for a in _inputs()]
    params = jax_params_from_state(
        lambda: jmodel.init(jax.random.PRNGKey(0), *args),
        state_dict_from_jax_params, model.state_dict())
    rng = np.random.default_rng(1)
    cots = [jnp.asarray(rng.normal(size=o.shape).astype(np.float32))
            for o in outs]

    def loss(p):
        out = jmodel.apply(p, *args)
        jouts = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * c) for o, c in zip(jouts, cots)), jouts

    (_, jouts), jgrads = jax_compiled(jax.value_and_grad(loss, has_aux=True),
                                      params)
    for got, want in zip(outs, jouts):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(grads)
    for k, g in want.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(KERNEL_IMPLS))
def test_remat_gradients_are_bitwise(name, dtype):
    """Dropout 0.1 from one generator, the attention kernels' Functions:
    the recomputed layers draw the forward's masks (the region starts from
    a snapshot of the generator), so the outputs and gradients equal the
    run without remat bit for bit, and the generator ends where that run
    leaves it."""
    runs = []
    for remat in (False, True):
        generator = torch.Generator().manual_seed(7)
        outs, grads = _port_run(_port(name, KERNEL_IMPLS[name], remat,
                                      compute_dtype=dtype), generator)
        runs.append((outs, grads, torch.randint(0, 2 ** 30, (4,),
                                                generator=generator)))
    (o1, g1, n1), (o2, g2, n2) = runs
    assert all(torch.equal(a, b) for a, b in zip(o1, o2))
    assert g1.keys() == g2.keys()
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k
    assert torch.equal(n1, n2)


def test_remat_with_moe_layers_raises_jax_text():
    """Remat with MoE layers is refused with the JAX model's error (flax
    would drop the aux loss sown inside nn.remat)."""
    cfg = jax_config_for_size("mini", max_len=T, num_experts=4)
    with pytest.raises(ValueError) as want:
        jax.eval_shape(JaxWeatherBERT(cfg, remat=True).init,
                       jax.random.PRNGKey(0),
                       *(jnp.asarray(a) for a in _inputs()))
    with pytest.raises(ValueError) as got:
        _port("weatherbert", "torch", True, num_experts=4)
    assert str(got.value) == str(want.value)
