"""The CNN baselines (`weathermodel_tpu_torch/models/cnn.py`) against the
JAX package's (weathermodel_tpu/models/cnn.py) on the CPU: the forwards of
WeatherCNNPretrain and CNNRNNYieldModel at 2e-5 in fp32 with the JAX
parameters carried across (`cnn_state_dict_from_jax_params`), one training
step's loss and gradients of each objective, and `wm-pretrain-torch --model
weathercnn`, `wm-yield-torch` / `wm-cropnet-torch --model cnnrnn` end to
end."""

import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.models import cnn as jax_cnn
from weathermodel_tpu.train import yield_trainer as jax_yield_trainer
from weathermodel_tpu.train.steps import Batch as JaxBatch
from weathermodel_tpu.train.steps import _objective_losses
from weathermodel_tpu_torch.cli import cropnet_main, pretrain, yield_main
from weathermodel_tpu_torch.data.chunks import write_synthetic_dataset
from weathermodel_tpu_torch.data.cropnet_data import synthetic_cropnet_df
from weathermodel_tpu_torch.data.yield_data import synthetic_yield_df
from weathermodel_tpu_torch.models import cnn
from weathermodel_tpu_torch.models.transfer import (
    cnn_state_dict_from_jax_params,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.train.state import make_optimizer
from weathermodel_tpu_torch.train.steps import (
    Batch,
    batch_to_device,
    make_train_step,
)
from weathermodel_tpu_torch.train.yield_trainer import (
    YieldBatch,
    yield_losses,
)
from test_torch_port_jax_params import jax_params_from_state

B, F, N_PAST = 3, 31, 1
T_YIELD = (N_PAST + 1) * 52
# a pretraining window that is not a whole number of years: zero-padded to
# two years inside both models
T_PRE = 60


def _pretrain_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T_PRE, F)).astype(np.float32),
            rng.random((B, T_PRE, F)) < 0.15)


def _yield_inputs(seed=0):
    rng = np.random.default_rng(seed)
    weather = rng.normal(size=(B, T_YIELD, F)).astype(np.float32)
    coords = rng.uniform(-90, 90, size=(B, 2)).astype(np.float32)
    year = (2005.0 + np.arange(T_YIELD, dtype=np.float32) / 52
            + rng.integers(0, 5, (B, 1))).astype(np.float32)
    interval = np.full((B, 1), 7.0, np.float32)
    mask = np.ones((B, T_YIELD, F), dtype=bool)  # the Khaki static mask
    mask[:, :, [7, 8, 11, 1, 2, 29]] = False
    y_past = rng.normal(size=(B, N_PAST + 1)).astype(np.float32)
    soil = rng.normal(size=(B, N_PAST + 1, 11, 6)).astype(np.float32)
    return weather, coords, year, interval, mask, y_past, soil


@functools.cache
def _models(name):
    """(the JAX model's jitted apply, its params, the port model): the
    port's seeded init in the flax tree (test_torch_port_jax_params.py), the
    apply shared by the tests (one compile a shape)."""
    if name == "pretrain":
        jm, pm = (jax_cnn.WeatherCNNPretrain(F, T_PRE),
                  cnn.WeatherCNNPretrain(F, T_PRE))
        w, m = _pretrain_inputs()
        init = (lambda: jm.init(jax.random.PRNGKey(0), w, None, None, None,
                                m))
    else:
        jm, pm = (jax_cnn.CNNRNNYieldModel(F, N_PAST),
                  cnn.CNNRNNYieldModel(F, N_PAST))
        *args, soil = _yield_inputs()
        init = lambda: jm.init(jax.random.PRNGKey(1), *args, soil=soil)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    params = jax_params_from_state(init, cnn_state_dict_from_jax_params,
                                   pm.state_dict())
    return jm, jax.jit(jm.apply), params, pm


def _pretrain_models():
    """(JAX model, its jitted apply, params, a fresh port model)."""
    jm, apply, params, pm = _models("pretrain")
    return jm, apply, params, copy.deepcopy(pm)


def _yield_models():
    jm, apply, params, pm = _models("cnnrnn")
    return jm, apply, params, copy.deepcopy(pm)


def test_state_dict_keys_and_shapes_are_the_port_models():
    for (_, _, params, _), model in (
            (_pretrain_models(), cnn.WeatherCNNPretrain(F, T_PRE)),
            (_yield_models(), cnn.CNNRNNYieldModel(F, N_PAST))):
        sd = cnn_state_dict_from_jax_params(params)
        assert {k: tuple(v.shape) for k, v in sd.items()} == {
            k: tuple(v.shape) for k, v in model.state_dict().items()}
        # flax's input kernels have no bias: nn.LSTM's input bias is zero
        if "lstm.bias_ih_l0" in sd:
            assert not sd["lstm.bias_ih_l0"].any()
    with pytest.raises(ValueError, match="CNN-family"):
        cnn_state_dict_from_jax_params({"params": {"core": {}}})


@pytest.mark.parametrize("seed", [1, 2])
def test_weathercnn_pretrain_forward_matches_jax(seed):
    _, apply, params, pm = _pretrain_models()
    w, m = _pretrain_inputs(seed)
    want = apply(params, w, None, None, None, m)
    with torch.no_grad():
        got = pm(torch.from_numpy(w), weather_feature_mask=torch.from_numpy(m))
    assert got.shape == (B, T_PRE, F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("with_soil", [True, False])
def test_cnnrnn_forward_matches_jax(with_soil):
    _, apply, params, pm = _yield_models()
    *args, soil = _yield_inputs(3)
    soil = soil if with_soil else None
    want = apply(params, *args, soil=soil)
    with torch.no_grad():
        got = pm(*map(torch.from_numpy, args),
                 soil=None if soil is None else torch.from_numpy(soil))
    assert got.shape == (B, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def _close_grads(port_model, want_grads):
    """Every trained parameter's gradient against JAX's; nn.LSTM's input
    bias, which flax's cell lacks, is not trained."""
    got = {k: p.grad for k, p in port_model.named_parameters()
           if p.requires_grad}
    want = cnn_state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                       want_grads))
    if "lstm.bias_ih_l0" in want:
        assert port_model.lstm.bias_ih_l0.grad is None
        del want["lstm.bias_ih_l0"]
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_weathercnn_train_step_matches_jax():
    """One masked-MSE step (the JAX trainer's objective for weathercnn) on
    the same batch and mask: the loss, its mae and every gradient."""
    jm, _, params, pm = _pretrain_models()
    w, m = _pretrain_inputs(4)
    rng = np.random.default_rng(5)
    coords = rng.uniform(-90, 90, size=(B, 2)).astype(np.float32)
    year = np.full((B, T_PRE), 1990.0, np.float32)
    interval = np.full((B, 1), 7.0, np.float32)

    def loss_fn(p):
        out = _objective_losses(jm, "masked_mse", p, JaxBatch(
            jnp.asarray(w), coords, year, interval), jnp.asarray(m), 1.0,
            deterministic=True, rngs=None, sample_key=None)
        return out["total_loss"], out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    step = make_train_step(pm, make_optimizer(pm), "weathercnn")
    got = step(batch_to_device(Batch(w, coords, year, interval), "cpu"),
               torch.Generator().manual_seed(0), 0.0, 1,
               mask=torch.from_numpy(m), dropout_rate=0.0)
    assert set(got) == set(want) == {"total_loss", "mae"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    _close_grads(pm, grads["params"])


def test_cnnrnn_yield_loss_and_gradients_match_jax():
    """The yield MSE on a batch whose last row is padding (weight 0)."""
    jm, _, params, pm = _yield_models()
    weather, coords, year, interval, mask, y_past, soil = _yield_inputs(6)
    rng = np.random.default_rng(7)
    y = rng.normal(size=(B, 1)).astype(np.float32)
    weights = np.array([1, 1, 0], np.float32)
    practices = np.zeros((B, N_PAST + 1, 14), np.float32)
    arrays = (weather, coords, year, interval, mask, y_past, y, weights,
              soil, practices)
    jbatch = jax_yield_trainer.YieldBatch(*map(jnp.asarray, arrays))
    want, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_yield_trainer._yield_losses(
            jm, "mse", p, jbatch, 1.0, True, None)["total_loss"]))(params)
    batch = YieldBatch(*map(torch.from_numpy, arrays))
    got = yield_losses("mse", pm(
        batch.weather, batch.coords, batch.year, batch.interval, batch.mask,
        batch.y_past, soil=batch.soil, practices=batch.practices), batch,
        1.0)["total_loss"]
    got.backward()
    got = got.detach()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close_grads(pm, grads["params"])


def test_reset_parameters_follows_the_jax_inits():
    model = cnn.CNNRNNYieldModel(F, 6)
    model.reset_parameters(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    again = cnn.CNNRNNYieldModel(F, 6)
    again.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in sd.items())
    bound = 1 / 9 ** 0.5     # conv1: 1 channel x kernel 9
    assert sd["cnn.conv1.weight"].abs().max() <= bound
    w_hh = sd["lstm.weight_hh_l0"]
    for gate in w_hh.split(64):   # orthogonal a gate
        torch.testing.assert_close(gate @ gate.T, torch.eye(64), atol=1e-5,
                                   rtol=0)
    assert not sd["lstm.bias_hh_l0"].any()


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("store")
    write_synthetic_dataset(str(root), n_chunks=8, n_samples=24, seq_len=24,
                            seed=0)
    return str(root)


def test_pretrain_cli_trains_weathercnn(store, tmp_path):
    """`wm-pretrain-torch --model weathercnn`: the masked-MSE record (the
    JAX trainer's key for the model, its loss names) with finite losses,
    and a best.pth of the CNN's parameters; --moe-experts is refused."""
    result = pretrain.run(pretrain.build_parser().parse_args([
        "--model", "weathercnn", "--batch-size", "8", "--n-epochs", "2",
        "--n-warmup-epochs", "0", "--data-dir", store, "--workdir",
        str(tmp_path), "--device", "cpu"]))
    with open(tmp_path / "weathercnn_output.json") as f:
        record = json.load(f)
    for scope in ("train", "val"):
        losses = record["losses"][scope]
        assert set(losses) == {"total_loss", "mae"}
        assert len(losses["total_loss"]) == 2
        assert np.isfinite(losses["total_loss"]).all()
    assert result["best_val_loss"] == min(record["losses"]["val"][
        "total_loss"])
    best = torch.load(tmp_path / "best.pth")
    assert set(best) == set(cnn.WeatherCNNPretrain(F, 24).state_dict())


@pytest.fixture(scope="module")
def crop_df():
    return synthetic_yield_df(seed=0, n_locs=6)


def test_yield_and_cropnet_clis_train_cnnrnn(crop_df):
    args = yield_main.build_parser().parse_args([
        "--model", "cnnrnn", "--device", "cpu", "--country", "synthetic",
        "--n-past-years", "1", "--n-train-years", "4", "--test-year", "2016",
        "--n-epochs", "2", "--batch-size", "8"])
    args.crop_df = crop_df
    result = yield_main.run(args)
    (trainer,) = result["trainers"]
    assert isinstance(trainer.model, cnn.CNNRNNYieldModel)
    assert trainer.model.n_past_years == 1
    assert np.isfinite(trainer.loss_history["train"]["total_loss"]).all()
    assert np.isfinite(result["avg_rmse_bu_acre"])
    args = cropnet_main.build_parser().parse_args([
        "--model", "cnnrnn", "--device", "cpu", "--crop-type", "Corn",
        "--n-past-years", "1", "--n-train-years", "2", "--n-epochs", "1",
        "--batch-size", "8"])
    args.cropnet_df = synthetic_cropnet_df(seed=0, n_counties=4)
    out = cropnet_main.run(args)
    assert np.isfinite(out["Corn"][0])
