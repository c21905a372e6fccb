"""The port's yield trainer against the JAX package's: one Adam step of the
mse and elbo objectives (losses and parameters) against
`make_yield_train_step`, then `YieldTrainer.train()` over 2 epochs of
WeatherBERT-mini (mse, dropout 0) from the same initial parameters on the
same batches (per-epoch train and validation losses within 1e-4 relative);
the fold tables, the CV aggregation, the LR range test on scripted losses,
and the grid search's TSV resume and best-config pick."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.cli import best_config as jax_best_config
from weathermodel_tpu.cli import grid_search as jax_grid_search
from weathermodel_tpu.data.yield_data import YieldStats as JaxYieldStats
from weathermodel_tpu.models import yield_models as jax_models
from weathermodel_tpu.train import lr_finder as jax_lr_finder
from weathermodel_tpu.train import yield_trainer as jax_trainer
from weathermodel_tpu.train.state import create_train_state
from weathermodel_tpu.utils.config import ModelConfig as JaxModelConfig
from weathermodel_tpu.utils.config import TrainConfig as JaxTrainConfig
from weathermodel_tpu_torch.cli import best_config, grid_search
from weathermodel_tpu_torch.data.yield_data import (
    YieldStats,
    get_train_test_arrays,
    synthetic_yield_df,
)
from weathermodel_tpu_torch.models import yield_models
from weathermodel_tpu_torch.models.transfer import (
    yield_state_dict_from_jax_params,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from test_torch_port_jax_params import jax_params_from_state
from weathermodel_tpu_torch.train import lr_finder, yield_trainer
from weathermodel_tpu_torch.train.state import make_optimizer
from weathermodel_tpu_torch.utils.config import ModelConfig, TrainConfig

B, T, F, N_PAST = 4, 32, 31, 1
MINI = dict(num_heads=4, num_layers=2, hidden_dim_factor=12,
            dropout_rate=0.0)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T, F), dtype=bool)
    mask[:, :, [7, 8, 11, 1, 2, 29]] = False
    return (rng.normal(size=(B, T, F)).astype(np.float32),
            rng.uniform(-90, 90, (B, 2)).astype(np.float32),
            np.full((B, T), 2010.0, np.float32),
            np.full((B, 1), 7.0, np.float32), mask,
            rng.normal(size=(B, N_PAST + 1)).astype(np.float32),
            rng.normal(size=(B, 1)).astype(np.float32),
            np.array([1, 1, 1, 0], np.float32),
            np.zeros((B, N_PAST + 1, 11, 6), np.float32),
            np.zeros((B, N_PAST + 1, 14), np.float32))


@pytest.mark.parametrize("name,objective", [
    ("WeatherBERTYieldModel", "mse"), ("WeatherFormerYieldModel", "elbo")])
def test_one_adam_step_matches_jax(name, objective):
    lr, beta, data = 1e-3, 0.5, _batch(1)
    jm = getattr(jax_models, name)(JaxModelConfig(**MINI, max_len=T),
                                   N_PAST, attention_impl="xla")
    # the port's seeded init in the flax tree (test_torch_port_jax_params.py)
    seeded = getattr(yield_models, name)(ModelConfig(**MINI, max_len=T),
                                         N_PAST, "torch")
    seeded.reset_parameters(torch.Generator().manual_seed(0))
    params = jax_params_from_state(
        lambda: jm.init({"params": jax.random.PRNGKey(0),
                         "sample": jax.random.PRNGKey(1)},
                        *map(jnp.asarray, data[:6])),
        yield_state_dict_from_jax_params, seeded.state_dict())
    start = yield_state_dict_from_jax_params(params)
    key = jax.random.PRNGKey(3)
    step = jax_trainer.make_yield_train_step(jm, objective, beta)
    state, want = jax.jit(step)(
        create_train_state(params),
        jax_trainer.YieldBatch(*map(jnp.asarray, data)), key,
        jnp.float32(lr))
    eps = None
    if objective != "mse":
        dropout_key, sample_key = jax.random.split(key)
        z, mu, var = (np.asarray(a) for a in jm.apply(
            params, *map(jnp.asarray, data[:6]), deterministic=False,
            rngs={"dropout": dropout_key, "sample": sample_key})[1:4])
        eps = torch.from_numpy(np.where(data[4], (z - mu) / np.sqrt(var),
                                        0.0).astype(np.float32))

    pm = getattr(yield_models, name)(ModelConfig(**MINI, max_len=T), N_PAST,
                                     "torch")
    pm.load_state_dict(start)
    port_step = yield_trainer.make_yield_train_step(
        pm, make_optimizer(pm), objective, beta)
    got = port_step(yield_trainer.YieldBatch(*map(torch.from_numpy, data)),
                    torch.Generator().manual_seed(0), lr, eps=eps,
                    dropout_rate=0.0)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=2e-5,
                                   atol=2e-5, err_msg=k)
    new = yield_state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                        state.params))
    # Adam's first step moves each entry by lr * g / (|g| + 1e-8): by at
    # most lr, and, where |g| > 1e-6, by the same amount on both sides. A
    # gradient that is 0 in exact arithmetic (the pooling logit's bias, the
    # keys' bias: softmaxes are invariant to them) is rounding noise,
    # which the step scales to +-lr on either side.
    held = total = 0
    for k, p in pm.named_parameters():
        for a in (p.detach(), new[k]):
            assert (a - start[k]).abs().max() <= lr * (1 + 1e-3), k
        assert not torch.equal(new[k], start[k]), k
        well = p.grad.abs() > 1e-6
        np.testing.assert_allclose(p.detach()[well].numpy(),
                                   new[k][well].numpy(), atol=2e-6, rtol=0,
                                   err_msg=k)
        held += int(well.sum())
        total += well.numel()
    assert set(new) == set(dict(pm.named_parameters()))
    assert held >= 0.9 * total


@pytest.fixture(scope="module")
def fold():
    df = synthetic_yield_df(seed=2, n_locs=5)
    return get_train_test_arrays(df, 4, 2016, N_PAST, "soybean", "usa")


def test_two_epoch_trainer_matches_jax(fold, tmp_path, monkeypatch):
    """WeatherBERT-mini mse, dropout 0, batch 8 (three steps an epoch, the
    third padded), lr 1e-3 flat: the two trainers' loss histories. The JAX
    trainer draws its initial parameters through a jitted init (one compile
    in place of flax's op-by-op draws); the port starts from them."""
    real_init = jax_models.WeatherBERTYieldModel.init
    monkeypatch.setattr(
        jax_models.WeatherBERTYieldModel, "init",
        lambda self, rngs, *args: jax.jit(
            lambda r, *a: real_init(self, r, *a))(rngs, *args))
    train, test, _, n_past = fold
    cfg = dict(batch_size=8, num_epochs=2, init_lr=1e-3, num_warmup_epochs=0,
               decay_factor=1.0, seed=7)
    max_len = train.weather.shape[1]
    jm = jax_models.WeatherBERTYieldModel(
        JaxModelConfig(**MINI, max_len=max_len), n_past,
        attention_impl="xla")
    jt = jax_trainer.YieldTrainer(jm, None, JaxTrainConfig(**cfg), "mse",
                                  train, test, n_past,
                                  init_key=jax.random.PRNGKey(7))
    start = yield_state_dict_from_jax_params(
        jax.tree.map(np.asarray, jt.state.params))
    pt = yield_trainer.YieldTrainer(
        yield_models.WeatherBERTYieldModel(ModelConfig(**MINI,
                                                       max_len=max_len),
                                           n_past, "torch"),
        None, TrainConfig(**cfg), "mse", train, test, n_past,
        workdir=str(tmp_path), device="cpu")
    pt.model.load_state_dict(start)
    want_best, got_best = jt.train(), pt.train()
    assert train.weather.shape[0] % 8 != 0
    for scope in ("train", "val"):
        np.testing.assert_allclose(
            pt.loss_history[scope]["total_loss"],
            jt.loss_history[scope]["total_loss"], rtol=1e-4, err_msg=scope)
    np.testing.assert_allclose(got_best, want_best, rtol=1e-4)
    assert (tmp_path / "best.pth").exists()
    assert (tmp_path / "yield_output.json").exists()
    assert [len(s) for s in pt.train_step_seconds] == [3, 3]


def test_fold_tables_and_aggregation():
    assert yield_trainer.TEST_YEARS == jax_trainer.TEST_YEARS
    assert yield_trainer.EXTREME_YEARS == jax_trainer.EXTREME_YEARS
    for test_type in ("extreme", "overall", "ahead_pred"):
        for country in ("usa", "brazil", "synthetic", "mexico"):
            for crop in ("soybean", "corn", "beans"):
                try:
                    want = jax_trainer.select_test_years(test_type, country,
                                                         crop)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)[:20]):
                        yield_trainer.select_test_years(test_type, country,
                                                        crop)
                    continue
                assert yield_trainer.select_test_years(
                    test_type, country, crop) == want
    with pytest.raises(ValueError, match="Unknown test_type"):
        yield_trainer.select_test_years("nope", "usa", "corn")

    folds = [(2014, 0.41, 50.0, 6.5), (2015, 0.63, 48.0, 7.25),
             (2016, 0.37, 52.5, 5.75)]
    got = yield_trainer.aggregate_cv_results([
        yield_trainer.YieldFoldResult(y, v, YieldStats(m, s), {})
        for y, v, m, s in folds])
    want = jax_trainer.aggregate_cv_results([
        jax_trainer.YieldFoldResult(y, v, JaxYieldStats(m, s), {})
        for y, v, m, s in folds])
    got.pop("details")
    want.pop("details")
    assert got == want


def _scripted(curve):
    """run_step(batch, lr) -> curve(lr), counting the batches it saw."""
    seen = []

    def run_step(batch, lr):
        seen.append(batch)
        return curve(lr)

    return run_step, seen


@pytest.mark.parametrize("curve,n_batches", [
    (lambda lr: 2.0 - np.log10(lr) / 5 + (lr > 0.05) * 50 * lr, 200),
    (lambda lr: 1.0 / (1.0 + 1e3 * lr) + lr ** 2, 7),
    (lambda lr: 1.0 + 0.0 * lr, 3),
])
def test_lr_finder_on_scripted_losses(curve, n_batches):
    results = []
    for module in (lr_finder, jax_lr_finder):
        run_step, seen = _scripted(curve)
        results.append((module.find_optimal_lr(run_step, range(n_batches),
                                               num_iter=60), seen))
    (got, got_seen), (want, want_seen) = results
    assert got == want and got_seen == want_seen
    lrs, losses = want[1], want[2]
    assert lr_finder.select_optimal_lr(lrs, losses, 1e-5) == \
        jax_lr_finder.select_optimal_lr(lrs, losses, 1e-5)
    assert lr_finder.select_optimal_lr([1e-3], [1.0], 1e-5) == \
        jax_lr_finder.select_optimal_lr([1e-3], [1.0], 1e-5)
    with pytest.raises(ValueError, match="empty"):
        lr_finder.find_optimal_lr(run_step, [], num_iter=3)


def test_tsv_resume_and_best_config_match_jax(tmp_path):
    assert grid_search.TSV_COLUMNS == jax_grid_search.TSV_COLUMNS
    assert grid_search.BETAS == jax_grid_search.BETAS
    assert grid_search.BATCH_SIZES == jax_grid_search.BATCH_SIZES
    assert grid_search.LRS == jax_grid_search.LRS
    base = {"model": "weatherformer", "crop_type": "soybean",
            "country": "usa", "test_type": "overall", "n_train_years": 15}
    rows = [dict(base, beta=b, batch_size=bs, init_lr=lr, rmse=rmse, r2=r2,
                 status=st)
            for b, bs, lr, rmse, r2, st in (
                (0.0, 32, 5e-4, "5.1000 ± 0.2000", "0.6100 ± 0.0100", "OK"),
                (1e-4, 64, 1e-3, "FAILED", "FAILED", "FAILED: ValueError"),
                (1e-3, 16, 2.5e-4, "4.9000 ± 0.1000", "0.7300 ± 0.0200",
                 "OK"),
                (1e-4, 32, 5e-4, "4.8000", "0.9000", "OK"))]
    paths = []
    for module, name in ((grid_search, "port.tsv"),
                         (jax_grid_search, "jax.tsv")):
        paths.append(str(tmp_path / name))
        for row in rows:
            module.append_row(paths[-1], row)
    with open(paths[0]) as f, open(paths[1]) as g:
        assert f.read() == g.read()
    done = grid_search.read_completed(paths[0])
    assert done == jax_grid_search.read_completed(paths[0])
    assert done == {grid_search._cell_key(rows[0]),
                    grid_search._cell_key(rows[2])}
    for row in rows:
        assert grid_search._cell_key(row) == jax_grid_search._cell_key(row)
    assert best_config.pick_best_config(paths[0]) == \
        jax_best_config.pick_best_config(paths[0])
    assert best_config.pick_best_config(paths[0])["init_lr"] == "0.00025"
    assert best_config.grid_search_tsv_path("d", "m", "c", "usa", "overall",
                                            True) == \
        jax_best_config.grid_search_tsv_path("d", "m", "c", "usa", "overall",
                                             True)
