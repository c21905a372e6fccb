"""The port's MLP baseline (models/mlp.py) and its `mlp_mse` objective held
against the JAX package's WeatherMLP and objective on the same seeded
inputs and parameters (fp32, within 2e-5), and `wm-pretrain-torch --model
mlp` end to end on the CPU against `wm-pretrain --model mlp`'s record."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.cli import pretrain as jax_pretrain
from weathermodel_tpu.models.mlp import WeatherMLP as JaxWeatherMLP
from weathermodel_tpu.train.steps import Batch as JaxBatch
from weathermodel_tpu.train.steps import _objective_losses
from weathermodel_tpu.utils.config import ModelConfig as JaxModelConfig
from weathermodel_tpu_torch.cli import pretrain
from weathermodel_tpu_torch.data.chunks import write_synthetic_dataset
from weathermodel_tpu_torch.models.mlp import MLP_TARGET_FEATURES, WeatherMLP
from weathermodel_tpu_torch.models.transfer import state_dict_from_jax_params
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.train.steps import Batch, make_eval_step
from weathermodel_tpu_torch.utils.config import ModelConfig
from test_torch_port_jax_params import jax_compiled, jax_params_from_state
from test_torch_port_pretrain_cli import keys_only_jax_runs

B, T, F = 6, 24, 31
TOL = 2e-5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    weather = rng.normal(size=(B, T, F)).astype(np.float32)
    coords = rng.uniform(-90, 90, size=(B, 2)).astype(np.float32)
    year = (1990.0 + np.arange(T, dtype=np.float32) * 7 / 365
            + rng.integers(0, 10, (B, 1))).astype(np.float32)
    interval = np.full((B, 1), 7.0, np.float32)
    mask = rng.random((B, T, F)) < 0.15
    return weather, coords, year, interval, mask


def _jax_params(seed=0):
    """The flax tree of the port's init from `seed`
    (test_torch_port_jax_params.py)."""
    weather, coords, year, interval, mask = (jnp.asarray(a)
                                             for a in _inputs(seed))
    model = WeatherMLP(ModelConfig())
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return jax_params_from_state(
        lambda: JaxWeatherMLP(JaxModelConfig()).init(
            jax.random.PRNGKey(seed), weather, coords, year, interval, mask),
        state_dict_from_jax_params, model.state_dict())


def _port_model(params):
    model = WeatherMLP(ModelConfig())
    model.load_state_dict(state_dict_from_jax_params(params))
    return model.eval()


def test_params_carry_across_with_the_reference_keys():
    params = _jax_params()
    sd = state_dict_from_jax_params(params)
    model = WeatherMLP(ModelConfig())
    assert sd.keys() == model.state_dict().keys()
    assert sd["fc1.weight"].shape == (512, F)
    assert sd["fc2.weight"].shape == (len(MLP_TARGET_FEATURES), 512)
    model.reset_parameters(torch.Generator().manual_seed(0))
    bound = 1 / np.sqrt(512)
    assert model.fc2.weight.abs().max() <= bound
    assert model.fc2.bias.abs().max() <= bound


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(seed):
    params = _jax_params(seed)
    weather, coords, year, interval, mask = _inputs(seed)
    want = np.asarray(jax_compiled(
        JaxWeatherMLP(JaxModelConfig()).apply, params, jnp.asarray(weather),
        jnp.asarray(coords), jnp.asarray(year), jnp.asarray(interval),
        jnp.asarray(mask)))
    with torch.no_grad():
        got = _port_model(params)(
            *(torch.from_numpy(a) for a in (weather, coords, year,
                                            interval, mask))).numpy()
    assert got.shape == want.shape == (B, T, len(MLP_TARGET_FEATURES))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_mlp_mse_matches_jax(weighted):
    """Every metric of the objective, through the port's eval step (the
    drawn mask is ignored), against JAX's `_objective_losses`; `weighted`
    gives two rows weight 0, as the zero-padded validation remainder."""
    params = _jax_params()
    weather, coords, year, interval, mask = _inputs()
    weight = (np.array([1, 1, 1, 1, 0, 0], np.float32) if weighted
              else None)
    jax_batch = JaxBatch(*(None if a is None else jnp.asarray(a) for a in
                           (weather, coords, year, interval, weight)))
    want = _objective_losses(JaxWeatherMLP(JaxModelConfig()), "mlp_mse",
                             params, jax_batch, jnp.asarray(mask), 0.5,
                             deterministic=True, rngs=None, sample_key=None)
    step = make_eval_step(_port_model(params), "weatherbert",
                          objective="mlp_mse")
    got = step(Batch(*(None if a is None else torch.from_numpy(a) for a in
                       (weather, coords, year, interval, weight))),
               torch.Generator().manual_seed(0), 1)
    assert set(got) == set(want) == {"total_loss", *(
        f"feature_{f}_mse" for f in MLP_TARGET_FEATURES)}
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=TOL,
                                   atol=TOL, err_msg=k)


def _keys(tree, prefix=""):
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
    return out


def test_pretrain_cli_trains_the_mlp(tmp_path, monkeypatch):
    store = tmp_path / "store"
    write_synthetic_dataset(str(store), n_chunks=8, n_samples=24, seq_len=T,
                            seed=0)
    argv = ["--model", "mlp", "--batch-size", "8", "--n-epochs", "2",
            "--n-warmup-epochs", "0", "--init-lr", "1e-2",
            "--data-dir", str(store)]
    result = pretrain.run(pretrain.build_parser().parse_args(
        argv + ["--workdir", str(tmp_path / "port"), "--device", "cpu"]))
    keys_only_jax_runs(monkeypatch)
    jax_pretrain.run(jax_pretrain.build_parser().parse_args(
        argv + ["--workdir", str(tmp_path / "jax")]))
    with open(tmp_path / "port" / "mlp_output.json") as f:
        record = json.load(f)
    with open(tmp_path / "jax" / "mlp_output.json") as f:
        jax_record = json.load(f)
    assert _keys(record) == _keys(jax_record)
    for scope in ("train", "val"):
        assert set(record["losses"][scope]) == {"total_loss", *(
            f"feature_{f}_mse" for f in MLP_TARGET_FEATURES)}
        for v in record["losses"][scope].values():
            assert len(v) == 2 and np.isfinite(v).all()
    train = record["losses"]["train"]["total_loss"]
    assert train[1] < train[0]
    assert result["best_val_loss"] == min(record["losses"]["val"]
                                          ["total_loss"])
    best = torch.load(tmp_path / "port" / "best.pth", weights_only=True)
    assert set(best) == {"fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"}
    # the last epoch's full train state
    assert (tmp_path / "port" / "checkpoints" / "1" / "state.pt").exists()
