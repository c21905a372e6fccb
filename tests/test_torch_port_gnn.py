"""The GNN-RNN baseline (`weathermodel_tpu_torch/models/gnn.py`,
`data/gnnrnn_data.py`, `train/gnn_trainer.py`) against the JAX package's on
the CPU: the adjacency and the per-year graph arrays bit for bit, the
forward at 2e-5 with the port's seeded init carried into the flax tree, the
masked MSE with its gradients and one Adam step, the trainer's 2-epoch loss
history at 1e-4 (dropout 0), and `wm-yield-torch --model gnnrnn` with the
grid search end to end."""

import functools
import json
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from weathermodel_tpu.data import gnnrnn_data as jax_data
from weathermodel_tpu.models import gnn as jax_gnn
from weathermodel_tpu.train import gnn_trainer as jax_trainer
from weathermodel_tpu.train.state import create_train_state
from weathermodel_tpu.utils.config import TrainConfig as JaxTrainConfig
from weathermodel_tpu_torch.cli import grid_search, yield_main
from weathermodel_tpu_torch.data import gnnrnn_data
from weathermodel_tpu_torch.data.yield_data import synthetic_yield_df
from weathermodel_tpu_torch.models import gnn
from weathermodel_tpu_torch.models.transfer import (
    gnn_state_dict_from_jax_params,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.train import checkpoint, gnn_trainer
from weathermodel_tpu_torch.train.state import make_optimizer
from weathermodel_tpu_torch.utils import constants
from weathermodel_tpu_torch.utils.config import TrainConfig
from test_torch_port_jax_params import jax_params_from_state

N, N_PAST, Z = 12, 2, 16
Y = N_PAST + 1


@pytest.fixture(scope="module")
def crop_df():
    """One synthetic Khaki frame, with rows taken out so that some graphs
    have NaN cells and counties that are not valid."""
    df = synthetic_yield_df(seed=3, n_locs=N)
    gone = ((df["loc_ID"] == 4) & (df["year"] == 2012)) | \
        ((df["loc_ID"] == 9) & (df["year"] >= 2014))
    return df[~gone].reset_index(drop=True)


def _graph(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, Y, 6, 52)).astype(np.float32),
            rng.normal(size=(n, Y, 11, 6)).astype(np.float32),
            np.stack([rng.uniform(30, 48, n), rng.uniform(-120, -80, n)],
                     axis=1).astype(np.float32),
            rng.normal(size=(n, Y)).astype(np.float32),
            gnn.build_county_adjacency(n))


@functools.cache
def _models():
    """(the JAX model's compiled apply at _graph()'s shapes, its params, the
    port model): the port's seeded init in the flax tree
    (test_torch_port_jax_params.py)."""
    jm = jax_gnn.GNNRNNYieldModel(n_past_years=N_PAST, z_dim=Z, dropout=0.0)
    pm = gnn.GNNRNNYieldModel(N_PAST, Z, dropout=0.0)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    params = jax_params_from_state(
        lambda: jm.init(jax.random.PRNGKey(0), *_graph()),
        gnn_state_dict_from_jax_params, pm.state_dict())
    apply = jax.jit(jm.apply).lower(params, *_graph()).compile()
    return apply, params, pm


@pytest.mark.parametrize("n", [1, 2, 3, 5, 12])
def test_adjacency_is_the_jax_packages(n):
    got = gnn.build_county_adjacency(n)
    want = jax_gnn.build_county_adjacency(n)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n_train_years,n_past", [(6, N_PAST), (2, 5)])
def test_graph_arrays_are_the_jax_packages(crop_df, n_train_years, n_past):
    """Train and test graphs bit for bit, the yield stats and the effective
    n_past_years; (2, 5) clamps n_past_years to 1."""
    got = gnnrnn_data.get_gnn_train_test_arrays(
        crop_df, n_train_years, 2016, n_past, "soybean", "usa")
    want = jax_data.get_gnn_train_test_arrays(
        crop_df, n_train_years, 2016, n_past, "soybean", "usa")
    assert got[3] == want[3] == min(n_past, n_train_years - 1)
    assert tuple(got[2]) == tuple(want[2])
    for g, w in zip(got[:2], want[:2]):
        assert g._fields == w._fields
        for name, a, b in zip(g._fields, g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    train = got[0]
    # the holes: invalid counties, and a target year's y_past holding the
    # year before's yield
    assert not train.valid.all() and train.valid.any()
    assert np.array_equal(train.y_past[:, :, -1], train.y_past[:, :, -2])


def test_converter_round_trip_and_state_dict():
    _, params, pm = _models()
    sd = gnn_state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in pm.state_dict().items()}
    for k, v in pm.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert not sd["lstm.bias_ih_l0"].any()
    with pytest.raises(ValueError, match="GNN-RNN"):
        gnn_state_dict_from_jax_params({"params": {"cnn": {}}})


@pytest.mark.parametrize("seed", [1, 2])
def test_forward_matches_jax(seed):
    apply, params, pm = _models()
    inputs = _graph(seed)
    want = apply(params, *inputs)
    pm.eval()
    with torch.no_grad():
        got = pm(*map(torch.from_numpy, inputs))
    assert got.shape == (N, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("n_valid", [0, 1, 9])
def test_masked_mse_matches_jax(n_valid):
    rng = np.random.default_rng(n_valid)
    pred, y = (rng.normal(size=(N, 1)).astype(np.float32),
               rng.normal(size=N).astype(np.float32))
    valid = np.zeros(N, bool)
    valid[rng.permutation(N)[:n_valid]] = True
    got = gnn_trainer._masked_mse(*map(torch.from_numpy, (pred, y, valid)))
    want = jax_trainer._masked_mse(pred, y, valid)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.fixture(scope="module")
def trainers(crop_df, tmp_path_factory):
    """(the JAX trainer on one fold, dropout 0, lr 1e-3 flat; the port's
    seeded initial parameters as its flax tree; port_trainer(), a fresh
    port GNNYieldTrainer on the same fold, which draws those parameters).
    The JAX trainer's init takes the port's parameters in place of flax's
    draws; its jitted step and evaluation compile once for the module."""
    train, test, _, n_past = gnnrnn_data.get_gnn_train_test_arrays(
        crop_df, 6, 2016, N_PAST, "soybean", "usa")
    cfg = dict(batch_size=8, num_epochs=2, init_lr=1e-3, num_warmup_epochs=0,
               decay_factor=1.0, seed=7)
    root = tmp_path_factory.mktemp("gnn_trainers")

    def port_trainer():
        return gnn_trainer.GNNYieldTrainer(
            gnn.GNNRNNYieldModel(n_past, Z, dropout=0.0), TrainConfig(**cfg),
            train, test, workdir=str(root / "port"), device="cpu")

    seeded = gnn.GNNRNNYieldModel(n_past, Z, dropout=0.0)
    seeded.reset_parameters(torch.Generator().manual_seed(cfg["seed"]))
    real_init = jax_gnn.GNNRNNYieldModel.init

    def init(self, rngs, *args):
        return jax_params_from_state(
            lambda: real_init(self, rngs, *args),
            gnn_state_dict_from_jax_params, seeded.state_dict())

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gnn.GNNRNNYieldModel, "init", init)
        jt = jax_trainer.GNNYieldTrainer(
            jax_gnn.GNNRNNYieldModel(n_past_years=n_past, z_dim=Z,
                                     dropout=0.0),
            JaxTrainConfig(**cfg), train, test, workdir=str(root / "jax"))
    return jt, jax.tree.map(np.asarray, jt.state.params), port_trainer


def test_one_adam_step_matches_jax(trainers):
    """The masked MSE and the parameters after one Adam step at lr 1e-3 on
    one graph with invalid counties, through the JAX trainer's step."""
    jt, params, _ = trainers
    weather, soil, coords, y_past, adj = _graph(3)
    rng = np.random.default_rng(4)
    y = rng.normal(size=N).astype(np.float32)
    valid = rng.random(N) < 0.7
    lr = 1e-3
    state, want = jt._train_step(
        create_train_state(params), weather, soil, coords, y_past, adj, y,
        valid, jax.random.PRNGKey(0), np.float32(lr))
    start = gnn_state_dict_from_jax_params(params)
    new = gnn_state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                      state.params))

    model = gnn.GNNRNNYieldModel(N_PAST, Z, dropout=0.0)
    model.load_state_dict(start)
    step = gnn_trainer.make_gnn_train_step(model, make_optimizer(model))
    graphs = gnn_trainer.GraphYears(*(torch.from_numpy(a[None]) for a in (
        weather, soil, y_past, y, valid)))
    got = step(graphs, 0, torch.from_numpy(coords), torch.from_numpy(adj),
               None, lr)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5)
    assert model.lstm.bias_ih_l0.grad is None
    for k, p in model.named_parameters():
        if not p.requires_grad:
            continue
        assert not torch.equal(new[k], start[k]), k
        # Adam's first step moves an entry by lr * g / (|g| + 1e-8): by at
        # most lr, and by the same amount on both sides where the gradient
        # is well above Adam's eps (the wide convs' gradients are mostly
        # below 1e-6 at this loss; many are 0, behind ReLUs that are off)
        for a in (p.detach(), new[k]):
            assert (a - start[k]).abs().max() <= lr * (1 + 1e-3), k
        well = p.grad.abs() > 1e-8
        np.testing.assert_allclose(p.detach()[well].numpy(),
                                   new[k][well].numpy(), atol=2e-6, rtol=0,
                                   err_msg=k)


def test_two_epoch_trainer_matches_jax(trainers, monkeypatch):
    """From the same initial parameters, dropout 0: the permutation of the
    target years, Adam and the schedule are all that is compared. The JAX
    record goes through the port's copy of write_output_json and its orbax
    save is stubbed (only the record's keys are read)."""
    jt, params, port_trainer = trainers
    pt = port_trainer()
    monkeypatch.setitem(sys.modules, "weathermodel_tpu.train.checkpoint",
                        types.SimpleNamespace(
                            write_output_json=checkpoint.write_output_json))
    monkeypatch.setattr(jt, "_save_best", lambda: None)
    jt.state = create_train_state(params)
    want_best, got_best = jt.train(), pt.train()
    for scope in ("train", "val"):
        np.testing.assert_allclose(
            pt.loss_history[scope]["total_loss"],
            jt.loss_history[scope]["total_loss"], rtol=1e-4, err_msg=scope)
    np.testing.assert_allclose(got_best, want_best, rtol=1e-4)
    assert [len(s) for s in pt.train_step_seconds] == [len(jt._usable())] * 2
    records = [json.loads((Path(t.workdir) / "yield_output.json").read_text())
               for t in (pt, jt)]

    def keys(tree):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in tree.items()}

    assert keys(records[0]) == keys(records[1])
    assert records[0]["model_config"]["model"] == "gnnrnn"
    assert (Path(pt.workdir) / "best.pth").exists()


def test_yield_cli_and_grid_search_train_gnnrnn(tmp_path, monkeypatch):
    """`wm-yield-torch --model gnnrnn --use-optimal-lr` on one fold of a
    small frame (the CLI's model: z_dim 128, 3 layers, dropout 0.1), then
    one grid-search cell of it."""
    monkeypatch.setattr(constants, "DRY_RUN", True)
    df = synthetic_yield_df(seed=5, n_locs=5, years=(2008, 2016))
    argv = ["--model", "gnnrnn", "--device", "cpu", "--country", "synthetic",
            "--n-past-years", "2", "--n-train-years", "4", "--test-year",
            "2016", "--n-epochs", "2", "--n-warmup-epochs", "0"]
    args = yield_main.build_parser().parse_args(
        argv + ["--use-optimal-lr", "--workdir", str(tmp_path / "run")])
    args.crop_df = df
    result = yield_main.run(args)
    (trainer,) = result["trainers"]
    assert isinstance(trainer, gnn_trainer.GNNYieldTrainer)
    assert isinstance(trainer.model, gnn.GNNRNNYieldModel)
    assert trainer.model.z_dim == 128 and len(trainer.model.sage) == 3
    assert len(trainer.lr_range[0]) == 5
    assert np.isfinite(trainer.loss_history["train"]["total_loss"]).all()
    assert np.isfinite(result["avg_rmse_bu_acre"])
    assert np.isfinite(result["avg_r_squared"])
    assert result["test_years"] == [2016]
    fold_dir = tmp_path / "run" / "fold_0_year_2016"
    assert (fold_dir / "best.pth").exists()
    assert json.loads((fold_dir / "yield_output.json").read_text())[
        "model_config"]["model"] == "gnnrnn"

    args = grid_search.build_parser().parse_args(
        argv + ["--n-epochs", "1", "--out-dir", str(tmp_path / "grid")])
    args.crop_df = df
    tsv = grid_search.GridSearch(args, str(tmp_path / "grid"),
                                 betas=(0.0,), batch_sizes=(8,),
                                 lrs=(1e-3,), n_train_years_list=(4,)).run()
    rows = open(tsv).read().strip().split("\n")
    assert len(rows) == 2 and "±" in rows[1], rows
