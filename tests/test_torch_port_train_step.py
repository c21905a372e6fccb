"""The port's train step against the JAX package's: a 20-step Adam
trajectory from the same weights on the same batches and injected masks,
fp32, dropout off (the pattern of tests/test_training_parity.py), with the
fused attention (its plain path on the CPU) against `pallas_qkv` in
interpret mode, the flash attention against `pallas` and plain attention
against `xla`; the ELBO objectives of the WeatherFormer family the same way
(the mixture's in one step with the same injected eps); then gradient
accumulation and the validation weights, in the port alone."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from weathermodel_tpu.models import WeatherBERT as JaxWeatherBERT
from weathermodel_tpu.models import WeatherFormer as JaxWeatherFormer
from weathermodel_tpu.models import WeatherFormerMixture as JaxMixture
from weathermodel_tpu.models import WeatherFormerSinusoid as JaxSinusoid
from weathermodel_tpu.ops.schedules import epoch_lr_schedule as jax_schedule
from weathermodel_tpu.train.steps import Batch as JaxBatch
from weathermodel_tpu.train.steps import _objective_losses
from weathermodel_tpu.utils.config import (
    model_config_for_size as jax_config_for_size,
)
from weathermodel_tpu_torch.cli.pretrain import make_model
from weathermodel_tpu_torch.models.transfer import state_dict_from_jax_params
from weathermodel_tpu_torch.ops.schedules import epoch_lr_schedule
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.train.state import make_optimizer
from weathermodel_tpu_torch.train.steps import (
    Batch,
    batch_to_device,
    make_eval_step,
    make_train_step,
)
from weathermodel_tpu_torch.utils.config import model_config_for_size

B, T, F = 8, 16, 31
LR = 1e-3
N_STEPS = 20
# small keeps its widths (H=200, 10 heads of 20) at 2 of its 4 layers: the
# JAX side's interpret-mode kernels compile once per layer
LAYERS = {"small": 2}


def _sized(config_for_size, size):
    overrides = {"num_layers": LAYERS[size]} if size in LAYERS else {}
    return config_for_size(size, max_len=T, **overrides)


def _data(seed=0, n=N_STEPS, b=B):
    rng = np.random.default_rng(seed)
    weather = rng.normal(size=(n, b, T, F)).astype(np.float32)
    coords = rng.uniform(-90, 90, size=(b, 2)).astype(np.float32)
    year = (1990.0 + np.arange(T, dtype=np.float32) * 7 / 365
            + rng.integers(0, 10, (b, 1))).astype(np.float32)
    interval = np.full((b, 1), 7.0, np.float32)
    masks = rng.random((n, b, T, F)) < 0.15
    return weather, coords, year, interval, masks


# port model name -> (JAX model class, objective)
MODELS = {"weatherbert": (JaxWeatherBERT, "masked_mse"),
          "weatherformer": (JaxWeatherFormer, "elbo"),
          "weatherformersinusoid": (JaxSinusoid, "elbo_sinusoid"),
          "weatherformermixture": (JaxMixture, "elbo_mixture")}
BETA = 0.5


def _jax_params(name, size, data):
    init = [jnp.asarray(a[0]) if a.ndim == 4 else jnp.asarray(a)
            for a in data]
    params = MODELS[name][0](_sized(jax_config_for_size, size)).init(
        jax.random.PRNGKey(0), *init)
    return jax.tree.map(np.asarray, params)


def _jax_run(size, impl, params, data, name="weatherbert"):
    """(losses, step-0 grads) of N_STEPS optax-Adam steps."""
    weather, coords, year, interval, masks = data
    jax_model, objective = MODELS[name]
    model = jax_model(_sized(jax_config_for_size, size),
                      attention_impl=impl)
    tx = optax.adam(LR)

    @jax.jit
    def step(params, opt_state, w, m):
        batch = JaxBatch(w, jnp.asarray(coords), jnp.asarray(year),
                         jnp.asarray(interval))

        def loss_fn(p):
            return _objective_losses(model, objective, p, batch, m, BETA,
                                     deterministic=True, rngs=None,
                                     sample_key=None)["total_loss"]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    opt_state = tx.init(params)
    losses, grads0 = [], None
    for i in range(N_STEPS):
        params, opt_state, loss, grads = step(
            params, opt_state, jnp.asarray(weather[i]), jnp.asarray(masks[i]))
        losses.append(float(loss))
        if i == 0:
            grads0 = state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                             grads))
    return np.asarray(losses), grads0


def _port_run(size, impl, params, data, name="weatherbert"):
    weather, coords, year, interval, masks = data
    model = make_model(name, _sized(model_config_for_size, size), impl)
    model.load_state_dict(state_dict_from_jax_params(params))
    step = make_train_step(model, make_optimizer(model), "weatherbert",
                           objective=MODELS[name][1], beta=BETA)
    gen = torch.Generator().manual_seed(0)
    losses, grads0 = [], None
    for i in range(N_STEPS):
        batch = batch_to_device(Batch(weather[i], coords, year, interval),
                                "cpu")
        out = step(batch, gen, LR, 1, mask=torch.from_numpy(masks[i]),
                   dropout_rate=0.0)
        losses.append(float(out["total_loss"]))
        if i == 0:
            grads0 = {k: p.grad.clone() for k, p in model.named_parameters()}
    return np.asarray(losses), grads0


def _check_trajectories(port, jax_run):
    (port_losses, port_grads), (jax_losses, jax_grads) = port, jax_run
    # the same weights, batch and mask: step 0 agrees to fp32 precision
    np.testing.assert_allclose(port_losses[0], jax_losses[0], rtol=1e-5)
    assert set(port_grads) == set(jax_grads)
    for k, g in port_grads.items():
        np.testing.assert_allclose(g.numpy(), jax_grads[k].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    # the trajectories track (the bar of tests/test_training_parity.py)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-2)
    assert port_losses[-1] < port_losses[0]


@pytest.mark.parametrize("size", ["mini", "small"])
@pytest.mark.parametrize("port_impl,jax_impl", [("fused_qkv", "pallas_qkv"),
                                                ("torch", "xla"),
                                                ("flash", "pallas")])
def test_20_step_trajectory_matches_jax(size, port_impl, jax_impl):
    data = _data()
    params = _jax_params("weatherbert", size, data)
    _check_trajectories(_port_run(size, port_impl, params, data),
                        _jax_run(size, jax_impl, params, data))


@pytest.mark.parametrize("name", ["weatherformer", "weatherformersinusoid"])
def test_20_step_elbo_trajectory_matches_jax(name):
    """WeatherFormer's ELBO and the sinusoid prior's, beta 0.5, through the
    flash attention against `pallas` (the path `auto` takes at mini/small
    training), at the bars of the WeatherBERT trajectory above."""
    data = _data(4)
    params = _jax_params(name, "mini", data)
    _check_trajectories(_port_run("mini", "flash", params, data, name),
                        _jax_run("mini", "pallas", params, data, name))


def test_elbo_mixture_step_matches_jax_with_the_same_eps():
    """One step of the mixture's ELBO: the JAX formula draws eps from its
    sample key; the port takes the same eps injected. Loss, its parts and
    every gradient at the trajectory test's step-0 bars."""
    weather, coords, year, interval, masks = _data(5, n=1)
    data = (weather, coords, year, interval, masks)
    params = _jax_params("weatherformermixture", "mini", data)
    cfg = jax_config_for_size("mini", max_len=T)
    model = JaxMixture(cfg, attention_impl="xla")
    batch = JaxBatch(*(jnp.asarray(a) for a in (weather[0], coords, year,
                                                interval)))
    key = jax.random.PRNGKey(7)

    def loss_fn(p):
        out = _objective_losses(model, "elbo_mixture", p, batch,
                                jnp.asarray(masks[0]), BETA,
                                deterministic=True, rngs=None,
                                sample_key=key)
        return out["total_loss"], out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    want_grads = state_dict_from_jax_params(jax.tree.map(np.asarray, grads))
    eps = np.array(jax.random.normal(key, weather[0].shape))

    port = make_model("weatherformermixture",
                      model_config_for_size("mini", max_len=T), "torch")
    port.load_state_dict(state_dict_from_jax_params(params))
    step = make_train_step(port, make_optimizer(port), "weatherformer",
                           objective="elbo_mixture", beta=BETA)
    got = step(batch_to_device(Batch(weather[0], coords, year, interval),
                               "cpu"), torch.Generator().manual_seed(0), 0.0,
               1, mask=torch.from_numpy(masks[0]), dropout_rate=0.0,
               eps=torch.from_numpy(eps))
    assert set(got) == {"total_loss", "reconstruction", "kl_term", "mae"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


def _mini_model(seed=0):
    model = make_model("weatherbert", model_config_for_size("mini",
                                                            max_len=T),
                       "fused_qkv")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def test_grad_accum_is_the_mean_of_microbatch_gradients():
    """Two microbatches with dropout on: the accumulated gradient is the
    mean of the two single-microbatch gradients drawn with the same
    generator stream (masks injected, so the stream is all dropout)."""
    weather, coords, year, interval, masks = _data(1, n=1)
    batch = batch_to_device(Batch(weather[0], coords, year, interval), "cpu")
    mask = torch.from_numpy(masks[0])
    model = _mini_model()
    step = make_train_step(model, make_optimizer(model), "weatherbert",
                           grad_accum=2)
    out = step(batch, torch.Generator().manual_seed(5), 0.0, 1, mask=mask)
    got = {k: p.grad.clone() for k, p in model.named_parameters()}

    ref = _mini_model()
    ref.train()
    gen = torch.Generator().manual_seed(5)
    half = B // 2
    sums, losses = {}, []
    for i in range(2):
        sl = slice(i * half, (i + 1) * half)
        ref.zero_grad()
        pred = ref(batch.weather[sl], batch.coords[sl], batch.year[sl],
                   batch.interval[sl], mask[sl], generator=gen)
        m = mask[sl].float()
        loss = ((batch.weather[sl] - pred).square() * m).sum() / m.sum()
        loss.backward()
        losses.append(loss.item())
        for k, p in ref.named_parameters():
            sums[k] = sums.get(k, 0) + p.grad
    for k, g in got.items():
        torch.testing.assert_close(g, sums[k] / 2, atol=1e-6, rtol=1e-6,
                                   msg=k)
    assert abs(out["total_loss"].item() - np.mean(losses)) < 1e-6
    with pytest.raises(ValueError, match="divisible"):
        make_train_step(model, make_optimizer(model), "weatherbert",
                        grad_accum=3)(batch, gen, 0.0, 1)


def test_eval_step_honours_the_padding_weights():
    weather, coords, year, interval, masks = _data(2, n=1)
    mask = torch.from_numpy(masks[0])
    model = _mini_model()
    evaluate = make_eval_step(model, "weatherbert")
    full = batch_to_device(Batch(weather[0], coords, year, interval), "cpu")
    weight = torch.tensor([1.0] * 5 + [0.0] * 3)
    padded = full._replace(weight=weight)
    real = Batch(*(a[:5] for a in full[:4]))
    got = evaluate(padded, None, 1, mask=mask)
    want = evaluate(real, None, 1, mask=mask[:5])
    for k in ("total_loss", "mae"):
        torch.testing.assert_close(got[k], want[k])
    assert not model.training
    # a train-mode forward with dropout needs its generator
    model.train()
    with pytest.raises(ValueError, match="generator"):
        model(*full[:4], mask)


@pytest.mark.parametrize("warmup,decay", [(0, 0.99), (10, 0.99), (3, None)])
def test_lr_schedule_matches_jax(warmup, decay):
    port = epoch_lr_schedule(5e-4, warmup, 40, decay)
    ref = jax_schedule(5e-4, warmup, 40, decay)
    assert [port(e) for e in range(40)] == [ref(e) for e in range(40)]
