"""Epoch-driven pretraining trainer (port of the single-device path of
weathermodel_tpu/train/trainer.py:52-358,429-502).

Per epoch: the learning rate of the per-epoch schedule, the masking
curriculum's n_masked, a training pass, a validation pass, the best
parameters saved on a better validation loss, and `output_json` with the
JAX trainer's keys. Each pass seeds its loader shuffle and a CPU
`torch.Generator` (masks and dropout) from
seed_base = seed + (2 * epoch + split) * 100003, split 0 = train,
1 = validation, as the JAX trainer does.

Not ported yet, and raising or absent until then: SIGTERM with mid-epoch
resume and full-state checkpoints (ROADMAP.md queue A item 7), the LR range
test (`use_optimal_lr`, item 10), the profiler hook, and mesh/parallel
options (item 14).
"""

import logging
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from weathermodel_tpu_torch.ops.schedules import epoch_lr_schedule
from weathermodel_tpu_torch.train.checkpoint import (
    save_best_params,
    write_output_json,
)
from weathermodel_tpu_torch.train.state import make_optimizer
from weathermodel_tpu_torch.train.steps import (
    OBJECTIVE_FOR_MODEL,
    Batch,
    batch_to_device,
    make_eval_step,
    make_train_step,
)
from weathermodel_tpu_torch.utils.config import (
    ModelConfig,
    TrainConfig,
    n_masked_features_for_epoch,
)

logger = logging.getLogger(__name__)


class PretrainTrainer:
    def __init__(
        self,
        model: torch.nn.Module,
        model_name: str,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        make_loaders: Callable[[str, bool, int], Iterator[Batch]],
        workdir: str = "checkpoints/pretraining",
        device="cuda",
        pretrained_state: Optional[dict] = None,
        grad_accum: int = 1,
    ):
        """make_loaders(split, shuffle, seed) -> iterator of numpy Batch.

        `model_name` is the JAX trainer's key (`weatherformer_sinusoid`,
        not the CLI's `weatherformersinusoid`): it picks the objective and
        the masking policy and names the output json. The model is
        initialised from `train_cfg.seed` (or loaded from
        `pretrained_state`, a state dict with the model's keys) and moved
        to `device`."""
        if model_name not in OBJECTIVE_FOR_MODEL:
            raise NotImplementedError(
                f"pretraining {model_name!r} is not ported yet; see "
                "ROADMAP.md queue A items 8 (mlp) and 11 (weathercnn)")
        if train_cfg.use_optimal_lr:
            raise NotImplementedError(
                "use_optimal_lr (the LR range test, train/lr_finder.py) is "
                "not ported yet; see ROADMAP.md queue A item 10")
        self.model_name = model_name
        self.cfg = train_cfg
        self.make_loaders = make_loaders
        self.workdir = workdir
        self.device = torch.device(device)
        objective, self.masking = OBJECTIVE_FOR_MODEL[model_name]

        model.reset_parameters(torch.Generator().manual_seed(train_cfg.seed))
        if pretrained_state is not None:
            missing = [k for k in model.state_dict()
                       if k not in pretrained_state]
            if missing:
                raise ValueError(f"pretrained state lacks {len(missing)} "
                                 f"parameters of the model (first: "
                                 f"{missing[:3]})")
            model.load_state_dict({k: pretrained_state[k]
                                   for k in model.state_dict()})
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(self.model)
        self._train_step = make_train_step(
            self.model, self.optimizer, self.masking,
            masking_prob=train_cfg.masking_prob, grad_accum=grad_accum,
            objective=objective, beta=train_cfg.beta)
        self._eval_step = make_eval_step(
            self.model, self.masking, masking_prob=train_cfg.masking_prob,
            objective=objective, beta=train_cfg.beta)
        self.lr_schedule = epoch_lr_schedule(
            train_cfg.init_lr, train_cfg.num_warmup_epochs,
            train_cfg.num_epochs, train_cfg.decay_factor)
        self.best_val_loss = float("inf")
        self._last_epoch_batches = 0
        self.output_json = {
            "model_config": {
                "model": model_name,
                "hidden_dim": model_cfg.hidden_dim,
                "num_layers": model_cfg.num_layers,
                "num_heads": model_cfg.num_heads,
                "batch_size": train_cfg.batch_size,
                "init_lr": train_cfg.init_lr,
                "num_warmup_epochs": train_cfg.num_warmup_epochs,
                "decay_factor": train_cfg.decay_factor,
                "beta": train_cfg.beta,
                "masking_prob": train_cfg.masking_prob,
                "n_masked_features": train_cfg.n_masked_features,
                "n_devices": 1,
                # stringified architecture (reference output_json contract,
                # base_trainer.py:353-381 embeds str(model))
                "architecture": str(model),
            },
            "losses": {"train": {}, "val": {}},
        }

    def _run_epoch(self, epoch: int, split: str):
        """One pass over `split`: (mean metrics, host seconds per step, each
        ending in a device sync as the metrics are read)."""
        train = split == "train"
        cfg = self.cfg
        n_masked = n_masked_features_for_epoch(cfg, epoch,
                                               cfg.n_masked_features)
        lr = self.lr_schedule(epoch)
        seed_base = cfg.seed + (epoch * 2 + (0 if train else 1)) * 100003
        generator = torch.Generator().manual_seed(seed_base)
        sums: Dict[str, float] = {}
        step_seconds = []
        for batch in self.make_loaders(split, train, seed_base):
            t0 = time.perf_counter()
            batch = batch_to_device(batch, self.device)
            if train:
                losses = self._train_step(batch, generator, lr, n_masked)
            else:
                losses = self._eval_step(batch, generator, n_masked)
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            step_seconds.append(time.perf_counter() - t0)
        if not step_seconds:
            raise RuntimeError(f"empty {split} loader at epoch {epoch}")
        if train:
            self._last_epoch_batches = len(step_seconds)
        n = len(step_seconds)
        return {k: v / n for k, v in sums.items()}, step_seconds

    def train(self) -> dict:
        """Run the epoch loop. Returns the best validation loss and, per
        epoch, the seconds of each training step and the number of
        validation batches."""
        cfg = self.cfg
        result = {"best_val_loss": self.best_val_loss,
                  "train_step_seconds": [], "val_batches": []}
        for epoch in range(cfg.num_epochs):
            t0 = time.time()
            train_losses, step_seconds = self._run_epoch(epoch, "train")
            train_time = time.time() - t0
            val_losses, val_seconds = self._run_epoch(epoch, "validation")
            dt = time.time() - t0
            samples = self._last_epoch_batches * cfg.batch_size
            m = self.output_json.setdefault("metrics", {})
            m.setdefault("train_samples_per_sec_per_chip", []).append(
                samples / max(train_time, 1e-9))
            m.setdefault("epoch_seconds", []).append(dt)
            for scope, losses in (("train", train_losses),
                                  ("val", val_losses)):
                for k, v in losses.items():
                    self.output_json["losses"][scope].setdefault(
                        k, []).append(v)
            logger.info(
                "epoch %d: train %.6f val %.6f lr %.2e n_masked %d (%.1fs)",
                epoch, train_losses["total_loss"], val_losses["total_loss"],
                self.lr_schedule(epoch),
                n_masked_features_for_epoch(cfg, epoch,
                                            cfg.n_masked_features), dt)
            if val_losses["total_loss"] < self.best_val_loss:
                self.best_val_loss = val_losses["total_loss"]
                save_best_params(self.workdir, self.model)
            write_output_json(self.workdir, self.model_name,
                              self.output_json)
            result["train_step_seconds"].append(step_seconds)
            result["val_batches"].append(len(val_seconds))
        result["best_val_loss"] = self.best_val_loss
        return result
