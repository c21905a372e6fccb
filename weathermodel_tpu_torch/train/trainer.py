"""Epoch-driven pretraining trainer (port of the single-device path of
weathermodel_tpu/train/trainer.py:52-502).

Per epoch: the learning rate of the per-epoch schedule, the masking
curriculum's n_masked, a training pass, a validation pass, the best
parameters saved on a better validation loss, a full train-state checkpoint
on the JAX cadence (epoch % checkpoint_every == 1, and the last epoch),
written in the background, and `output_json` with the JAX trainer's keys.
Each pass seeds its loader shuffle and a CPU `torch.Generator` (masks and
dropout) from seed_base = seed + (2 * epoch + split) * 100003, split 0 =
train, 1 = validation, as the JAX trainer does. The record's losses are
every metric the step returns (`moe_aux` too for a MoE model), per scope.

With `use_optimal_lr` the LR range test (train/lr_finder.py) runs first on a
throwaway deep copy of the model and optimizer (JAX trainer.py:360-390); the
LR it finds is recorded as `model_config.optimal_lr` in output_json, and the
epoch schedule takes its base LR from that record, so a resumed run keeps it
(trainer.py:279-288).

Preemption (trainer.py:396-501): `train()` installs a SIGTERM handler that
only asks for a stop. The step in flight finishes, a checkpoint of the state
inside the epoch is written (`mid_epoch`: the completed steps, the running
metric sums, and the training pass's generator as it stood after the last
step), and `train()` returns with "preempted": True; a signal during
validation stops after that epoch's boundary save. `resume=True` restores
the newest checkpoint of `workdir` and continues: inside the saved epoch
(the loader skips the completed batches on the host, the generator is
restored) or after it, so the resumed run ends bitwise equal to an
uninterrupted one. Neither the LR range test nor a re-seeded epoch runs
again.

With WEATHERMODEL_PROFILE_DIR set, a `torch.profiler` run (CPU, and CUDA on
the card) covers epoch start_epoch + 1's training pass and writes a Chrome
trace into that directory (trainer.py:437-458).

Under `torchrun` the trainer runs on a (data, model) mesh (parallel/mesh.py;
JAX trainer.py:91-196): `tensor_parallel=N` puts N ranks on 'model' and the
rest on 'data'. Every rank builds the same model from the seed and keeps its
blocks of the parameters the JAX sharding rules split
(`parallel.mesh.shard_params`), before the optimizer is made, so Adam's
state is the blocks too: under `tensor_parallel` > 1 the MoE experts (which
run where they are stored: expert parallelism, for every dispatch) and the
dense attention and FFN weights (the Megatron column/row split of their
storage; their compute is gathered, as JAX's is for its attention kernels),
and with `fsdp` every parameter of at least 2^14 entries over 'data' as
well (`fsdp` alone: a world x 1 mesh, ZeRO-3). The steps run the global
batch's objective and the metrics are the global batch's. Rank 0 alone
logs, writes output_json and best.pth, and writes the checkpoints, whose
parameters and Adam moments every rank first gathers whole: the files are
those a one-process run writes, and `resume` slices them again. A stop
asked for by SIGTERM is agreed over all ranks at each step boundary, so that
no rank enters a collective alone. Sequence parallelism and the pipeline
are not ported (ROADMAP.md queue A item 14).
"""

import contextlib
import copy
import logging
import os
import signal
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from weathermodel_tpu_torch.models.transfer import load_pretrained
from weathermodel_tpu_torch.ops.schedules import epoch_lr_schedule
from weathermodel_tpu_torch.parallel import mesh as mesh_lib
from weathermodel_tpu_torch.train.checkpoint import (
    Checkpointer,
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
        resume: bool = False,
        tensor_parallel: int = 1,
        fsdp: bool = False,
    ):
        """make_loaders(split, shuffle, seed) -> iterator of numpy Batch.

        `model_name` is the JAX trainer's key (`weatherformer_sinusoid`,
        not the CLI's `weatherformersinusoid`): it picks the objective and
        the masking policy and names the output json. The model is
        initialised from `train_cfg.seed` (or loaded from
        `pretrained_state`, a reference-format state dict, through the JAX
        trainer's transfer rules, models/transfer.py's `load_pretrained`)
        and moved to `device`. `resume` restores the newest checkpoint of
        `workdir`, if there is one.

        `tensor_parallel=N` runs the ranks of the process group on a
        (world / N) x N (data, model) mesh; `fsdp` splits the parameters'
        storage over 'data' too (module docstring)."""
        if model_name not in OBJECTIVE_FOR_MODEL:
            raise ValueError(
                f"no pretraining objective for {model_name!r}; one of "
                + ", ".join(OBJECTIVE_FOR_MODEL))
        self.model_name = model_name
        self.cfg = train_cfg
        self.make_loaders = make_loaders
        self.workdir = workdir
        self.device = torch.device(device)
        objective, self.masking = OBJECTIVE_FOR_MODEL[model_name]
        self.mesh = _make_mesh(tensor_parallel)
        self.is_primary = self.mesh.is_primary

        model.reset_parameters(torch.Generator().manual_seed(train_cfg.seed))
        if pretrained_state is not None:
            model.load_state_dict(load_pretrained(
                model_name, model.state_dict(), pretrained_state))
        self.model = model.to(self.device)
        # each rank keeps its blocks, before the optimizer: Adam's state is
        # the blocks too
        self.sharded = mesh_lib.shard_params(self.model, self.mesh,
                                             fsdp=fsdp)
        self.optimizer = make_optimizer(self.model)
        step_mesh = self.mesh if self.mesh.world > 1 else None

        def train_step_for(model, optimizer):
            return make_train_step(
                model, optimizer, self.masking,
                masking_prob=train_cfg.masking_prob, grad_accum=grad_accum,
                objective=objective, beta=train_cfg.beta, mesh=step_mesh)

        self._train_step_for = train_step_for
        self._train_step = train_step_for(self.model, self.optimizer)
        self._eval_step = make_eval_step(
            self.model, self.masking, masking_prob=train_cfg.masking_prob,
            objective=objective, beta=train_cfg.beta, mesh=step_mesh)
        self.checkpointer = Checkpointer(workdir, mesh=self.mesh,
                                         sharded=self.sharded)
        self.start_epoch = 0
        self.best_val_loss = float("inf")
        self._last_epoch_batches = 0
        # graceful preemption: SIGTERM -> checkpoint at the step boundary
        self._stop_requested = False
        self._resume_mid: Optional[dict] = None
        self.fast_forward_seconds: Optional[float] = None
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
                "n_devices": self.mesh.world,
                # stringified architecture (reference output_json contract,
                # base_trainer.py:353-381 embeds str(model))
                "architecture": str(model),
            },
            "losses": {"train": {}, "val": {}},
        }
        if resume:
            self._resume()

    def _resume(self):
        if self.checkpointer.latest_epoch() is None:
            self._log("No checkpoint to resume from in %s", self.workdir)
            return
        (epoch, self.best_val_loss, self.output_json, mid,
         generator_state) = self.checkpointer.restore(self.model,
                                                      self.optimizer)
        optimal = self.output_json["model_config"].get("optimal_lr")
        if optimal is not None:
            self._log("Restored optimal LR %.3e from checkpoint", optimal)
        if mid is not None:
            # a preemption checkpoint taken inside `epoch`: continue that
            # epoch at the recorded step
            self.start_epoch = epoch
            self._resume_mid = dict(mid, generator=generator_state)
            self._log("Resumed mid-epoch %d at batch %d (best val %.6f)",
                      epoch, mid["batch_idx"], self.best_val_loss)
        else:
            self.start_epoch = epoch + 1
            self._log("Resumed from epoch %d (best val %.6f)", epoch,
                      self.best_val_loss)

    def _log(self, *args, level=logging.INFO):
        if self.is_primary:
            logger.log(level, *args)

    def lr_schedule(self, epoch: int) -> float:
        """The epoch's LR: the schedule from init_lr, or from the LR range
        test's result where output_json records one."""
        cfg = self.cfg
        base = self.output_json["model_config"].get("optimal_lr",
                                                    cfg.init_lr)
        return epoch_lr_schedule(base, cfg.num_warmup_epochs,
                                 cfg.num_epochs, cfg.decay_factor)(epoch)

    def _maybe_find_optimal_lr(self):
        """LR range test on a throwaway copy of the model and optimizer
        (reference base_trainer.py:418-441 + find_optimal_lr.py), at the
        base n_masked_features, its generator seeded with seed + 999."""
        if not self.cfg.use_optimal_lr:
            return
        from weathermodel_tpu_torch.train.lr_finder import find_optimal_lr
        from weathermodel_tpu_torch.utils.constants import DRY_RUN

        model, optimizer = copy.deepcopy((self.model, self.optimizer))
        step = self._train_step_for(model, optimizer)
        generator = torch.Generator().manual_seed(self.cfg.seed + 999)

        def run_step(batch, lr):
            batch = batch_to_device(batch, self.device)
            return float(step(batch, generator, lr,
                              self.cfg.n_masked_features)["total_loss"])

        optimal, _, _ = find_optimal_lr(
            run_step, self.make_loaders("train", True, self.cfg.seed),
            num_iter=5 if DRY_RUN else 100)
        del model, optimizer
        self._log("Using optimal LR %.3e (was %.3e)", optimal,
                  self.cfg.init_lr)
        self.output_json["model_config"]["optimal_lr"] = optimal

    def _run_epoch(self, epoch: int, split: str, mid: Optional[dict] = None):
        """One pass over `split`: (mean metrics, host seconds per step, each
        ending in a device sync as the metrics are read). `mid` (training
        only) continues the epoch after a preemption checkpoint: the loader
        skips the completed batches and the generator takes its saved
        state. Returns None when a stop was requested during the pass; the
        preemption checkpoint is then written."""
        train = split == "train"
        cfg = self.cfg
        n_masked = n_masked_features_for_epoch(cfg, epoch,
                                               cfg.n_masked_features)
        lr = self.lr_schedule(epoch)
        seed_base = cfg.seed + (epoch * 2 + (0 if train else 1)) * 100003
        generator = torch.Generator().manual_seed(seed_base)
        loader = iter(self.make_loaders(split, train, seed_base))
        sums: Dict[str, float] = {}
        n_batches = 0
        if mid is not None:
            t0 = time.perf_counter()
            n_batches = int(mid["batch_idx"])
            sums = dict(mid["sums"])
            for _ in range(n_batches):
                next(loader)  # host-side skip
            generator.set_state(mid["generator"])
            self.fast_forward_seconds = time.perf_counter() - t0
        step_seconds = []
        for batch in loader:
            t0 = time.perf_counter()
            batch = batch_to_device(batch, self.device)
            if train:
                losses = self._train_step(batch, generator, lr, n_masked)
            else:
                losses = self._eval_step(batch, generator, n_masked)
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n_batches += 1
            step_seconds.append(time.perf_counter() - t0)
            if train and self._stop_agreed():
                self.checkpointer.save(
                    epoch, self.model, self.optimizer, self.best_val_loss,
                    self.output_json,
                    mid_epoch={"batch_idx": n_batches, "sums": sums},
                    generator=generator)
                self._log(
                    "Preemption checkpoint written: epoch %d, batch %d "
                    "(--resume-from-checkpoint continues here exactly)",
                    epoch, n_batches, level=logging.WARNING)
                return None
        if n_batches == 0:
            raise RuntimeError(f"empty {split} loader at epoch {epoch}")
        if train:
            self._last_epoch_batches = n_batches
        return {k: v / n_batches for k, v in sums.items()}, step_seconds

    def _stop_agreed(self) -> bool:
        """Whether any rank was asked to stop (this rank's flag without a
        process group); every rank calls it at the same step boundary."""
        self._stop_requested = mesh_lib.all_reduce_flag(self._stop_requested,
                                                        self.device)
        return self._stop_requested

    def _profiler(self, epoch: int, profile_dir: Optional[str]):
        """A torch.profiler context over epoch start_epoch + 1's training
        pass when `profile_dir` is set (rank 0's under a mesh), else a null
        context."""
        if not (profile_dir and epoch == self.start_epoch + 1
                and self.is_primary):
            return contextlib.nullcontext()
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def train(self) -> dict:
        """Run the epoch loop. Returns the best validation loss and, per
        completed epoch, the seconds of each training step and the number
        of validation batches; "preempted": True when a SIGTERM stopped it
        (a checkpoint then holds the state to resume from);
        "checkpoint_saves", the Checkpointer's record of each save;
        "stored_elements", the parameter and optimizer-state entries this
        rank holds; and "fast_forward_seconds" after a mid-epoch resume."""
        old_handlers = {}

        def on_signal(signum, frame):
            logger.warning("signal %d received: checkpointing at the next "
                           "step boundary, then stopping", signum)
            self._stop_requested = True

        # a previous preempted train() must not stop this one at once
        self._stop_requested = False
        try:
            old_handlers[signal.SIGTERM] = signal.signal(signal.SIGTERM,
                                                         on_signal)
        except ValueError:  # not the main thread: no handler, no stop
            pass
        try:
            return self._train_loop()
        finally:
            # settle the background write before the caller reads the files
            self.checkpointer.wait_until_finished()
            for sig, handler in old_handlers.items():
                signal.signal(sig, handler)

    def _train_loop(self) -> dict:
        cfg = self.cfg
        result = {"best_val_loss": self.best_val_loss,
                  "train_step_seconds": [], "val_batches": [],
                  "checkpoint_saves": self.checkpointer.saves}
        # a resumed run keeps the LR its record holds; a run preempted
        # inside epoch 0 must not re-run the range test from its state
        if self.start_epoch == 0 and self._resume_mid is None:
            self._maybe_find_optimal_lr()
        profile_dir = os.environ.get("WEATHERMODEL_PROFILE_DIR")
        for epoch in range(self.start_epoch, cfg.num_epochs):
            t0 = time.time()
            mid, self._resume_mid = self._resume_mid, None
            with self._profiler(epoch, profile_dir) as prof:
                train_out = self._run_epoch(epoch, "train", mid)
            if prof is not None:
                os.makedirs(profile_dir, exist_ok=True)
                path = os.path.join(profile_dir,
                                    f"{self.model_name}_epoch{epoch}.json")
                prof.export_chrome_trace(path)
                self._log("profiler trace written to %s", path)
            if train_out is None:  # preempted; the checkpoint is written
                if self.is_primary:
                    write_output_json(self.workdir, self.model_name,
                                      self.output_json)
                result["preempted"] = True
                break
            train_losses, step_seconds = train_out
            train_time = time.time() - t0
            val_losses, val_seconds = self._run_epoch(epoch, "validation")
            dt = time.time() - t0
            samples = self._last_epoch_batches * cfg.batch_size
            m = self.output_json.setdefault("metrics", {})
            m.setdefault("train_samples_per_sec_per_chip", []).append(
                samples / max(train_time, 1e-9) / self.mesh.world)
            m.setdefault("epoch_seconds", []).append(dt)
            for scope, losses in (("train", train_losses),
                                  ("val", val_losses)):
                for k, v in losses.items():
                    self.output_json["losses"][scope].setdefault(
                        k, []).append(v)
            self._log(
                "epoch %d: train %.6f val %.6f lr %.2e n_masked %d (%.1fs)",
                epoch, train_losses["total_loss"], val_losses["total_loss"],
                self.lr_schedule(epoch),
                n_masked_features_for_epoch(cfg, epoch,
                                            cfg.n_masked_features), dt)
            if val_losses["total_loss"] < self.best_val_loss:
                self.best_val_loss = val_losses["total_loss"]
                save_best_params(self.workdir, self.model, self.mesh,
                                 self.sharded)
            # the reference cadence (base_trainer.py:110), in the background
            saved = (epoch % cfg.checkpoint_every == 1
                     or epoch == cfg.num_epochs - 1)
            if saved:
                self.checkpointer.save(epoch, self.model, self.optimizer,
                                       self.best_val_loss, self.output_json,
                                       wait=False)
            if self.is_primary:
                write_output_json(self.workdir, self.model_name,
                                  self.output_json)
            result["train_step_seconds"].append(step_seconds)
            result["val_batches"].append(len(val_seconds))
            if self._stop_agreed():  # the signal came during validation
                if not saved:
                    self.checkpointer.save(
                        epoch, self.model, self.optimizer,
                        self.best_val_loss, self.output_json)
                self._log("Stopping after completed epoch %d (checkpoint "
                          "written)", epoch, level=logging.WARNING)
                result["preempted"] = True
                break
        result["best_val_loss"] = self.best_val_loss
        result["stored_elements"] = mesh_lib.stored_elements(self.model,
                                                             self.optimizer)
        if self.fast_forward_seconds is not None:
            result["fast_forward_seconds"] = self.fast_forward_seconds
        return result


def _make_mesh(tensor_parallel: int) -> mesh_lib.Mesh:
    """The trainer's (world / tensor_parallel) x tensor_parallel mesh, with
    the JAX trainer's divisibility check and error text
    (trainer.py:103-111)."""
    if tensor_parallel > 1:
        n_dev = mesh_lib.world_size()
        if n_dev % tensor_parallel:
            raise ValueError(
                f"{n_dev} devices not divisible by parallel degree "
                f"{tensor_parallel}")
    return mesh_lib.make_mesh(n_model=tensor_parallel)
