"""GNN-RNN trainer, one full-graph step per target year (port of
weathermodel_tpu/train/gnn_trainer.py; reference
`gnnrnn_yield_trainer.py:18-292`).

The trainer contract is the other yield trainers': `train()` returns the
best validation RMSE, `loss_history` is {"train": {"total_loss"}, "val":
{"total_loss"}}, a workdir gets the best parameters (`best.pth`) and
`yield_output.json`, and `use_optimal_lr` runs the LR range test on a
throwaway copy. A step is the masked MSE over the valid counties of one
target year's whole graph; an epoch visits the usable target years in
`np.random.default_rng(seed).permutation` order; validation is the test
year's RMSE.

Randomness: the dropout seeds come from a CPU torch.Generator seeded with
`seed` for the training passes and `seed + 999` for the range test, as the
JAX trainer keys them; the permutation is the JAX trainer's.
"""

import copy
import itertools
import logging
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from weathermodel_tpu_torch.data.gnnrnn_data import (
    GNNArrays,
    get_gnn_train_test_arrays,
)
from weathermodel_tpu_torch.ops.schedules import epoch_lr_schedule
from weathermodel_tpu_torch.train.checkpoint import (
    save_best_params,
    write_output_json,
)
from weathermodel_tpu_torch.train.state import (
    make_optimizer,
    set_learning_rate,
)
from weathermodel_tpu_torch.train.yield_trainer import YieldCrossValidator
from weathermodel_tpu_torch.utils.config import TrainConfig

logger = logging.getLogger(__name__)


def _masked_mse(pred, y, valid):
    w = valid.float()
    return (w * (pred[:, 0] - y).square()).sum() / w.sum().clamp(min=1.0)


class GraphYears(NamedTuple):
    """A GNNArrays' per-target-year tensors on the device."""
    weather: torch.Tensor   # [T_years, N, n_years, 6, 52]
    soil: torch.Tensor      # [T_years, N, n_years, 11, 6]
    y_past: torch.Tensor    # [T_years, N, n_years]
    y: torch.Tensor         # [T_years, N]
    valid: torch.Tensor     # [T_years, N] bool


def graph_years_to_device(arrays: GNNArrays, device) -> GraphYears:
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return GraphYears(put(arrays.weather), put(arrays.soil),
                      put(arrays.y_past), put(arrays.y), put(arrays.valid))


def make_gnn_train_step(model, optimizer):
    """Returns train_step(graphs, ti, coords, adj, generator, lr,
    dropout_rate=None) -> the loss (a 0-dim tensor on the device): the
    forward in train mode on target year `ti`'s graph, the masked MSE, its
    backward and one Adam step at `lr`."""

    def train_step(graphs: GraphYears, ti: int, coords, adj, generator,
                   lr: float, dropout_rate=None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        pred = model(graphs.weather[ti], graphs.soil[ti], coords,
                     graphs.y_past[ti], adj, generator=generator,
                     dropout_rate=dropout_rate)
        loss = _masked_mse(pred, graphs.y[ti], graphs.valid[ti])
        loss.backward()
        set_learning_rate(optimizer, lr)
        optimizer.step()
        return loss.detach()

    return train_step


class GNNYieldTrainer:
    """One fold: the model initialised from `train_cfg.seed`
    (reset_parameters with a seeded CPU generator), the train and test
    years' graphs on `device`."""

    def __init__(self, model: torch.nn.Module, train_cfg: TrainConfig,
                 train_arrays: GNNArrays, test_arrays: GNNArrays,
                 workdir: Optional[str] = None, device="cuda"):
        self.cfg = train_cfg
        self.train_arrays = train_arrays
        self.test_arrays = test_arrays
        self.workdir = workdir
        self.device = torch.device(device)
        model.reset_parameters(torch.Generator().manual_seed(train_cfg.seed))
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(self.model)
        self._train_step = make_gnn_train_step(self.model, self.optimizer)
        self.train_graphs = graph_years_to_device(train_arrays, self.device)
        self.test_graphs = graph_years_to_device(test_arrays, self.device)
        self.coords = torch.from_numpy(train_arrays.coords).to(self.device)
        self.adj = torch.from_numpy(train_arrays.adj_norm).to(self.device)
        self.lr_schedule = epoch_lr_schedule(
            train_cfg.init_lr, train_cfg.num_warmup_epochs,
            train_cfg.num_epochs, train_cfg.decay_factor)
        # the same nested shape as YieldTrainer.loss_history
        self.loss_history: Dict[str, Dict[str, list]] = {
            "train": {"total_loss": []}, "val": {"total_loss": []}}
        self.optimal_lr: Optional[float] = None
        self.lr_range: Optional[Tuple[List[float], List[float]]] = None
        # per epoch, the host seconds of each step (each ends in a device
        # sync as its loss is read)
        self.train_step_seconds: List[List[float]] = []

    def _usable(self) -> List[int]:
        a = self.train_arrays
        return [ti for ti in range(len(a.target_years)) if a.valid[ti].any()]

    def evaluate(self) -> float:
        """The test year's RMSE, dropout off."""
        self.model.eval()
        g = self.test_graphs
        with torch.no_grad():
            pred = self.model(g.weather[0], g.soil[0], self.coords,
                              g.y_past[0], self.adj)
            return float(torch.sqrt(_masked_mse(pred, g.y[0], g.valid[0])))

    def _maybe_find_optimal_lr(self):
        """The LR range test over full-graph year steps on a throwaway deep
        copy of the model and its optimizer (reference
        find_optimal_lr.py:18-168)."""
        if not self.cfg.use_optimal_lr:
            return
        from weathermodel_tpu_torch.train.lr_finder import find_optimal_lr
        from weathermodel_tpu_torch.utils.constants import DRY_RUN

        model, optimizer = copy.deepcopy((self.model, self.optimizer))
        step = make_gnn_train_step(model, optimizer)
        generator = torch.Generator().manual_seed(self.cfg.seed + 999)

        def run_step(ti, lr):
            return float(step(self.train_graphs, ti, self.coords, self.adj,
                              generator, lr))

        optimal, lrs, losses = find_optimal_lr(
            run_step, itertools.cycle(self._usable()),
            num_iter=5 if DRY_RUN else 100)
        del model, optimizer
        logger.info("GNN LR finder selected %.3e", optimal)
        self.optimal_lr = optimal
        self.lr_range = (lrs, losses)
        self.lr_schedule = epoch_lr_schedule(
            optimal, self.cfg.num_warmup_epochs, self.cfg.num_epochs,
            self.cfg.decay_factor)

    def train(self) -> float:
        generator = torch.Generator().manual_seed(self.cfg.seed)
        rng = np.random.default_rng(self.cfg.seed)
        best = float("inf")
        usable = self._usable()
        self._maybe_find_optimal_lr()
        for epoch in range(self.cfg.num_epochs):
            lr = self.lr_schedule(epoch)
            losses, seconds = [], []
            for ti in rng.permutation(usable):
                t0 = time.perf_counter()
                losses.append(float(self._train_step(
                    self.train_graphs, int(ti), self.coords, self.adj,
                    generator, lr)))
                seconds.append(time.perf_counter() - t0)
            self.train_step_seconds.append(seconds)
            val = self.evaluate()
            self.loss_history["train"]["total_loss"].append(
                float(np.mean(losses)))
            self.loss_history["val"]["total_loss"].append(val)
            if val < best:
                best = val
                if self.workdir:
                    save_best_params(self.workdir, self.model)
        if self.workdir:
            write_output_json(self.workdir, "yield", {
                "model_config": {"objective": "mse", "model": "gnnrnn",
                                 "batch_size": self.cfg.batch_size,
                                 "init_lr": self.cfg.init_lr},
                "losses": self.loss_history,
            })
        return best


class GNNCrossValidator(YieldCrossValidator):
    """GNN-RNN cross-validation through the other yield models' fold loop,
    artifacts and aggregation; only the fold's trainer differs.
    `make_model(n_past_years)` gets the fold's effective n_past_years."""

    def _fold_trainer(self, test_year, fold_dir):
        train_arr, test_arr, stats, n_past = get_gnn_train_test_arrays(
            self.crop_df, self.n_train_years, test_year, self.n_past_years,
            self.crop_type, self.country)
        trainer = GNNYieldTrainer(self.make_model(n_past), self.train_cfg,
                                  train_arr, test_arr, workdir=fold_dir,
                                  device=self.device)
        return trainer, stats
