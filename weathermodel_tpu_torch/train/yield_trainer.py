"""Crop-yield fine-tuning: steps, trainer, k-fold cross-validation (port of
weathermodel_tpu/train/yield_trainer.py; reference
`src/crop_yield/trainers/*` + `src/base_trainer/cross_validator.py`):

* objectives: "mse" (WeatherBERT/autoencoder/SimMTM/linear: train MSE,
  val RMSE) and "elbo"/"elbo_sinusoid"/"elbo_mixture" (yield MSE + beta *
  KL on the static missing-feature mask, reconstruction term disabled);
* per-batch validation RMSE averaged over batches (reference quirk: mean
  of sqrt(batch MSE), preserved for metric parity);
* fold -> test-year mapping (TEST_YEARS / EXTREME_YEARS) handled
  explicitly by the cross-validator;
* per-fold yield stats from the data layer drive the RMSE-bushels/acre and
  R^2 = 1 - (RMSE/sigma)^2 aggregation.

Batches are padded to a fixed size with 0/1 sample weights; every loss is
weight-averaged so padding never contributes.

Randomness: each pass seeds a CPU torch.Generator with
seed + epoch * 7919 + (0 train | 1 validation), as the JAX trainer seeds
its key; each step draws from it the seed of a generator on the device for
the sampling models' eps, then (training) the encoder's dropout seeds. The
loader's shuffle takes seed + epoch, as in the JAX trainer, so the two see
the same batches in the same order.
"""

import copy
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from weathermodel_tpu_torch.data.yield_data import (
    YieldArrays,
    YieldStats,
    get_train_test_arrays,
    yield_batches,
)
from weathermodel_tpu_torch.models.yield_models import (
    transfer_encoder_into_yield,
)
from weathermodel_tpu_torch.ops.dropout import draw_seed
from weathermodel_tpu_torch.ops.losses import (
    gaussian_kl_divergence,
    mixture_kl_divergence,
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
from weathermodel_tpu_torch.utils.config import ModelConfig, TrainConfig

logger = logging.getLogger(__name__)

# Fold -> test-year tables (reference weatherbert_yield_trainer.py:22-49)
TEST_YEARS = (2014, 2015, 2016, 2017, 2018)
EXTREME_YEARS = {
    "usa": {
        "corn": (2002, 2004, 2009, 2012, 2014),
        "soybean": (2003, 2004, 2009, 2012, 2016),
    },
    "argentina": {
        "corn": (2004, 2005, 2007, 2009, 2015),
        "soybean": (2003, 2006, 2007, 2009, 2015),
        "wheat": (2002, 2003, 2005, 2009, 2011),
        "sunflower": (2002, 2007, 2008, 2009, 2011),
    },
    "brazil": {
        "corn": (2001, 2003, 2007, 2010, 2015),
        "soybean": (2001, 2003, 2005, 2011, 2017),
        "sugarcane": (2002, 2003, 2008, 2012, 2017),
        "wheat": (2001, 2003, 2010, 2015, 2016),
        "cotton": (2004, 2008, 2013, 2017, 2018),
    },
    "mexico": {
        "beans": (2016, 2017, 2018, 2021, 2023),
        "corn": (2014, 2017, 2019, 2022, 2023),
        "sugarcane": (2013, 2014, 2018, 2020, 2021),
        "wheat": (2013, 2021, 2022, 2023, 2024),
    },
}
YIELD_OBJECTIVES = ("mse", "elbo", "elbo_sinusoid", "elbo_mixture")


def select_test_years(test_type: str, country: str,
                      crop_type: str) -> Tuple[int, ...]:
    if test_type == "extreme":
        if country == "synthetic":
            # the synthetic corpus has no extreme-year table: fall back to
            # the overall fold years, as the JAX trainer does
            return TEST_YEARS
        years = EXTREME_YEARS.get(country, {}).get(crop_type)
        if years is None:
            raise ValueError(
                f"No extreme years found for {crop_type} in {country}.")
        return years
    if test_type in ("overall", "ahead_pred"):
        return TEST_YEARS
    raise ValueError(
        f"Unknown test_type: {test_type}. "
        "Choose 'extreme', 'overall', or 'ahead_pred'.")


class YieldBatch(NamedTuple):
    weather: torch.Tensor    # [B, T, 31]
    coords: torch.Tensor     # [B, 2]
    year: torch.Tensor       # [B, T]
    interval: torch.Tensor   # [B, 1]
    mask: torch.Tensor       # [B, T, 31] bool (static missing features)
    y_past: torch.Tensor     # [B, n_years]
    y: torch.Tensor          # [B, 1]
    weights: torch.Tensor    # [B] 1 = real sample, 0 = padding
    soil: torch.Tensor       # [B, n_years, 11, 6]
    practices: torch.Tensor  # [B, n_years, 14]


def yield_batch_to_device(arrays: YieldArrays, weights: np.ndarray,
                          device) -> YieldBatch:
    """One numpy batch of `yield_batches` -> tensors on `device` (the mask
    bool, the rest fp32)."""
    def put(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return YieldBatch(
        weather=put(arrays.weather), coords=put(arrays.coords),
        year=put(arrays.year), interval=put(arrays.interval),
        mask=put(arrays.mask, bool), y_past=put(arrays.y_past),
        y=put(arrays.y), weights=put(weights), soil=put(arrays.soil),
        practices=put(arrays.practices))


def _wmean(x, w):
    return (x * w).sum() / w.sum().clamp(min=1.0)


def _sample_generator(generator, device, objective):
    """A generator on `device` seeded from the CPU one, for the sampling
    models' eps; None for "mse", whose models draw none."""
    if objective == "mse":
        return None
    g = torch.Generator(device=device)
    g.manual_seed(draw_seed(generator))
    return g


def _forward(model, batch: YieldBatch, generator=None, sample_generator=None,
             eps=None, dropout_rate=None):
    return model(batch.weather, batch.coords, batch.year, batch.interval,
                 batch.mask, batch.y_past, soil=batch.soil,
                 practices=batch.practices, generator=generator,
                 sample_generator=sample_generator, eps=eps,
                 dropout_rate=dropout_rate)


def yield_losses(objective: str, outputs, batch: YieldBatch,
                 beta: float) -> Dict[str, torch.Tensor]:
    """The objective on the model's outputs (the JAX `_yield_losses` after
    its forward): the weighted yield MSE, plus beta times the weighted KL on
    the static mask for the ELBO objectives."""
    w = batch.weights
    if objective == "mse":
        return {"total_loss": _wmean((outputs[:, 0] - batch.y[:, 0]).square(),
                                     w)}
    pred, z, mu_x, var_x = outputs[:4]
    yield_loss = _wmean((pred[:, 0] - batch.y[:, 0]).square(), w)
    if objective == "elbo":
        kl = gaussian_kl_divergence(batch.mask, mu_x, var_x,
                                    torch.zeros_like(mu_x),
                                    torch.ones_like(var_x))
    elif objective == "elbo_sinusoid":
        kl = gaussian_kl_divergence(batch.mask, mu_x, var_x, *outputs[4:6])
    elif objective == "elbo_mixture":
        kl = mixture_kl_divergence(z, batch.mask, mu_x, var_x, *outputs[4:7])
    else:
        raise ValueError(f"Unknown objective: {objective}")
    kl_term = beta * _wmean(kl, w)
    return {"total_loss": yield_loss + kl_term, "yield": yield_loss,
            "reconstruction": torch.zeros((), device=pred.device),
            "kl_term": kl_term}


def make_yield_train_step(model, optimizer, objective: str,
                          beta: float = 0.0):
    """Returns train_step(batch, generator, lr, eps=None, dropout_rate=None)
    -> losses (0-dim tensors on the device): the forward in train mode, the
    objective, its backward and one Adam step at `lr`. `eps` replaces the
    drawn sample and `dropout_rate` the model's rate (the parity tests use
    them)."""
    if objective not in YIELD_OBJECTIVES:
        raise ValueError(f"Unknown objective: {objective}")

    def train_step(batch: YieldBatch, generator, lr: float, eps=None,
                   dropout_rate=None):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        sample = (None if eps is not None else
                  _sample_generator(generator, batch.weather.device,
                                    objective))
        losses = yield_losses(
            objective, _forward(model, batch, generator, sample, eps,
                                dropout_rate), batch, beta)
        losses["total_loss"].backward()
        set_learning_rate(optimizer, lr)
        optimizer.step()
        return {k: v.detach() for k, v in losses.items()}

    return train_step


def make_yield_eval_step(model, objective: str):
    """Returns eval_step(batch, generator, eps=None) -> {"total_loss": the
    batch RMSE of the weighted yield MSE} (reference
    weatherbert_yield_trainer.py:245-250: loss ** 0.5), dropout off."""

    def eval_step(batch: YieldBatch, generator, eps=None):
        model.eval()
        with torch.no_grad():
            sample = (None if eps is not None else
                      _sample_generator(generator, batch.weather.device,
                                        objective))
            outputs = _forward(model, batch, generator, sample, eps)
            pred = outputs if objective == "mse" else outputs[0]
            mse = _wmean((pred[:, 0] - batch.y[:, 0]).square(),
                         batch.weights)
        return {"total_loss": torch.sqrt(mse)}

    return eval_step


@dataclasses.dataclass
class YieldFoldResult:
    test_year: int
    best_val_rmse: float          # normalized units
    yield_stats: YieldStats
    loss_history: Dict[str, Any]

    @property
    def rmse_bu_acre(self) -> float:
        return self.best_val_rmse * self.yield_stats.std

    @property
    def r_squared(self) -> float:
        return 1.0 - (self.rmse_bu_acre / self.yield_stats.std) ** 2


class YieldTrainer:
    """One fold: fixed test year, cached arrays, epoch loop on `device`.

    The model is initialised from `train_cfg.seed` (reset_parameters with a
    seeded CPU generator), then its encoder from `pretrained_state` (a
    reference-format encoder state dict) by `transfer_encoder_into_yield`.
    load_state_dict copies, so folds built from one pretrained state share
    no tensor."""

    def __init__(
        self,
        model: torch.nn.Module,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        objective: str,
        train_arrays: YieldArrays,
        test_arrays: YieldArrays,
        n_past_years: int,
        pretrained_state: Optional[dict] = None,
        workdir: Optional[str] = None,
        device="cuda",
    ):
        self.cfg = train_cfg
        self.objective = objective
        self.train_arrays = train_arrays
        self.test_arrays = test_arrays
        self.workdir = workdir
        self.device = torch.device(device)
        model.reset_parameters(torch.Generator().manual_seed(train_cfg.seed))
        if pretrained_state is not None:
            model.load_state_dict(transfer_encoder_into_yield(
                model.state_dict(), pretrained_state))
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(self.model)
        self._train_step = make_yield_train_step(
            self.model, self.optimizer, objective, train_cfg.beta)
        self._eval_step = make_yield_eval_step(self.model, objective)
        self.lr_schedule = epoch_lr_schedule(
            train_cfg.init_lr, train_cfg.num_warmup_epochs,
            train_cfg.num_epochs, train_cfg.decay_factor)
        # the LR range test's choice and its (lrs, losses), when it ran
        self.optimal_lr: Optional[float] = None
        self.lr_range: Optional[Tuple[List[float], List[float]]] = None
        self.loss_history: Dict[str, Any] = {"train": {}, "val": {}}
        # per epoch: the host seconds of each training step, each ending in
        # a device sync as its losses are read, and of the whole training
        # pass, the loader included
        self.train_step_seconds: List[List[float]] = []
        self.train_pass_seconds: List[float] = []

    def _batches(self, arrays, shuffle, seed):
        for arr_batch, weights in yield_batches(arrays, self.cfg.batch_size,
                                                shuffle, seed):
            yield yield_batch_to_device(arr_batch, weights, self.device)

    def _epoch(self, epoch: int, train: bool) -> Dict[str, float]:
        cfg = self.cfg
        arrays = self.train_arrays if train else self.test_arrays
        generator = torch.Generator().manual_seed(
            cfg.seed + epoch * 7919 + (0 if train else 1))
        lr = self.lr_schedule(epoch)
        sums: Dict[str, float] = {}
        seconds = []
        start = time.perf_counter()
        for batch in self._batches(arrays, train, cfg.seed + epoch):
            t0 = time.perf_counter()
            if train:
                losses = self._train_step(batch, generator, lr)
            else:
                losses = self._eval_step(batch, generator)
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            seconds.append(time.perf_counter() - t0)
        if not seconds:
            raise RuntimeError("empty yield loader")
        if train:
            self.train_pass_seconds.append(time.perf_counter() - start)
            self.train_step_seconds.append(seconds)
        return {k: v / len(seconds) for k, v in sums.items()}

    def _maybe_find_optimal_lr(self):
        """The LR range test on a throwaway deep copy of the model and its
        optimizer (reference base_trainer.py:418-441)."""
        if not self.cfg.use_optimal_lr:
            return
        from weathermodel_tpu_torch.train.lr_finder import find_optimal_lr
        from weathermodel_tpu_torch.utils.constants import DRY_RUN

        model, optimizer = copy.deepcopy((self.model, self.optimizer))
        step = make_yield_train_step(model, optimizer, self.objective,
                                     self.cfg.beta)
        generator = torch.Generator().manual_seed(self.cfg.seed + 999)

        def run_step(batch, lr):
            return float(step(batch, generator, lr)["total_loss"])

        optimal, lrs, losses = find_optimal_lr(
            run_step, self._batches(self.train_arrays, True, self.cfg.seed),
            num_iter=5 if DRY_RUN else 100)
        del model, optimizer
        logger.info("Yield LR finder selected %.3e", optimal)
        self.optimal_lr = optimal
        self.lr_range = (lrs, losses)
        self.lr_schedule = epoch_lr_schedule(
            optimal, self.cfg.num_warmup_epochs, self.cfg.num_epochs,
            self.cfg.decay_factor)

    def train(self) -> float:
        best = float("inf")
        self._maybe_find_optimal_lr()
        for epoch in range(self.cfg.num_epochs):
            tr = self._epoch(epoch, train=True)
            va = self._epoch(epoch, train=False)
            for scope, losses in (("train", tr), ("val", va)):
                for k, v in losses.items():
                    self.loss_history[scope].setdefault(k, []).append(v)
            if va["total_loss"] < best:
                best = va["total_loss"]
                if self.workdir:
                    save_best_params(self.workdir, self.model)
        if self.workdir:
            write_output_json(self.workdir, "yield", {
                "model_config": {"objective": self.objective,
                                 "batch_size": self.cfg.batch_size,
                                 "init_lr": self.cfg.init_lr,
                                 "beta": self.cfg.beta},
                "losses": self.loss_history,
            })
        return best


class YieldCrossValidator:
    """k-fold CV over test years (reference cross_validator.py:46-116 +
    fold->year mapping). Each fold re-standardizes the frame on its own
    train years and builds its model from the SAME init seed (the reference
    reseeds 1234 per fold, cross_validator.py:64-70). `make_model(n)` builds
    the model for n past years, the number the fold's data clamped
    n_past_years to. `test_year` pins one fold to that year instead of the
    test-type table."""

    def __init__(
        self,
        make_model: Callable[[int], torch.nn.Module],
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        objective: str,
        crop_df: pd.DataFrame,
        country: str,
        crop_type: str,
        n_train_years: int,
        n_past_years: int,
        test_type: str = "overall",
        k_folds: int = 5,
        pretrained_state: Optional[dict] = None,
        workdir: Optional[str] = None,
        test_year: Optional[int] = None,
        device="cuda",
    ):
        self.make_model = make_model
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.objective = objective
        self.crop_df = crop_df
        self.country = country
        self.crop_type = crop_type
        self.n_train_years = n_train_years
        self.n_past_years = n_past_years
        self.test_type = test_type
        self.k_folds = k_folds
        self.pretrained_state = pretrained_state
        self.workdir = workdir
        self.test_year = test_year
        self.device = device
        # each fold's trainer, in order, for callers that read its timings
        self.trainers: List[YieldTrainer] = []

    def _fold_trainer(self, test_year: int, fold_dir: Optional[str]):
        test_gap = 4 if self.test_type == "ahead_pred" else 0
        train_arr, test_arr, stats, eff_n_past = get_train_test_arrays(
            self.crop_df, self.n_train_years, test_year,
            self.n_past_years, self.crop_type, self.country, test_gap)
        trainer = YieldTrainer(
            self.make_model(eff_n_past), self.model_cfg, self.train_cfg,
            self.objective, train_arr, test_arr, eff_n_past,
            pretrained_state=self.pretrained_state, workdir=fold_dir,
            device=self.device)
        return trainer, stats

    def run(self) -> Dict[str, Any]:
        if self.test_year is not None:
            years, n_folds = (self.test_year,), 1
        else:
            years = select_test_years(self.test_type, self.country,
                                      self.crop_type)
            n_folds = self.k_folds
        fold_results: List[YieldFoldResult] = []
        for fold in range(n_folds):
            test_year = years[fold % len(years)]
            t0 = time.time()
            fold_dir = (f"{self.workdir}/fold_{fold}_year_{test_year}"
                        if self.workdir else None)
            trainer, stats = self._fold_trainer(test_year, fold_dir)
            best = trainer.train()
            self.trainers.append(trainer)
            fold_results.append(YieldFoldResult(
                test_year=test_year, best_val_rmse=best, yield_stats=stats,
                loss_history=trainer.loss_history))
            logger.info(
                "Fold [%d/%d] test_year=%d best val RMSE (norm) %.4f "
                "=> %.2f bu/acre, R^2 %.3f (%.1fs)",
                fold + 1, n_folds, test_year, best,
                fold_results[-1].rmse_bu_acre, fold_results[-1].r_squared,
                time.time() - t0)
        return aggregate_cv_results(fold_results)


def aggregate_cv_results(fold_results: List[YieldFoldResult]) -> Dict[str, Any]:
    """RMSE bu/acre and R^2 aggregation (reference yield_main.py:230-253)."""
    rmses = [f.rmse_bu_acre for f in fold_results]
    r2s = [f.r_squared for f in fold_results]
    vals = [f.best_val_rmse for f in fold_results]
    return {
        "fold_results": vals,
        "avg_best_val_loss": float(np.mean(vals)),
        "std_best_val_loss": float(np.std(vals)),
        "n_folds": len(fold_results),
        "rmse_bu_acre": [float(x) for x in rmses],
        "avg_rmse_bu_acre": float(np.mean(rmses)),
        "std_rmse_bu_acre": float(np.std(rmses)),
        "r_squared": [float(x) for x in r2s],
        "avg_r_squared": float(np.mean(r2s)),
        "std_r_squared": float(np.std(r2s)),
        "test_years": [f.test_year for f in fold_results],
        "details": fold_results,
    }
