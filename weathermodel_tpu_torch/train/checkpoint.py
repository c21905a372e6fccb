"""What the trainer writes (port of weathermodel_tpu/train/checkpoint.py),
with the JAX package's split between the resume state and the transfer
parameters:

* `Checkpointer` - the full train state under
  `{workdir}/checkpoints/{epoch}/`, the 3 newest epochs kept:
    state.pt          {"model": the model's state_dict, "optimizer": the
                      optimizer's state_dict, and for a mid-epoch save
                      "generator": the pass's CPU torch.Generator state}
    meta.json         {"epoch", "best_val_loss", and for a mid-epoch save
                      "mid_epoch": {"batch_idx", "sums"}}
    output_json.json  the experiment record as of the save
  Each save is written into a temporary directory and renamed into place,
  so a reader never sees a partial checkpoint; a second save of an epoch
  replaces the first (a preemption inside epoch N, then N's boundary save).
  The port reads and writes only these torch files, never the JAX trainer's
  orbax directories (that would need JAX or tensorstore on the card's host).
* `write_output_json` - the per-epoch experiment record
  `{workdir}/{name}_output.json` (reference base_trainer.py:475-489).
* `save_best_params` - the model's `state_dict()` as a reference-format
  `.pth` (`{workdir}/best.pth`), which `wm-serve-torch --checkpoint` and
  `--pretrained-model-path` load unchanged.

Under a mesh (parallel/mesh.py) each rank holds blocks of the parameters
the sharding rules split (the experts, the dense weights over 'model', with
`--fsdp` the large ones over 'data') and of their Adam moments. Every rank
gathers them whole (a collective: all ranks save together) and rank 0 alone
writes, so the files are those of a one-process run; `restore` loads them on
every rank and keeps the rank's blocks.
"""

import copy
import json
import os
import shutil
import threading
import time
from typing import List, Optional

import torch

from weathermodel_tpu_torch.parallel import mesh as mesh_lib

BEST_PARAMS = "best.pth"
STATE, META, OUTPUT_JSON = "state.pt", "meta.json", "output_json.json"


def _host_copy(obj):
    """`obj` (nested dicts/lists/tuples of tensors and plain values) with
    every tensor copied to the host: the snapshot a background write may
    hold while training goes on updating the originals in place."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _full_state(model: torch.nn.Module, mesh, sharded) -> dict:
    """The model's state dict with the split parameters gathered."""
    state = model.state_dict()
    if mesh is None or not sharded:
        return state
    return mesh_lib.gather_params(state, sharded, mesh)


class Checkpointer:
    def __init__(self, workdir: str, max_to_keep: int = 3,
                 mesh: Optional[mesh_lib.Mesh] = None,
                 sharded: Optional[dict] = None):
        """`mesh` and `sharded` ({name: spec} of the split parameters, as
        `parallel.mesh.shard_params` returns it): the rank's place in a mesh
        run (module docstring)."""
        self.mesh = mesh
        self.sharded = dict(sharded or {})
        self.primary = mesh is None or mesh.is_primary
        self.workdir = os.path.abspath(workdir)
        self.root = os.path.join(self.workdir, "checkpoints")
        self.max_to_keep = max_to_keep
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        # one entry a save: {"epoch", "wait", "blocked_s" (the caller's
        # time in save()), "write_s" (the files' time), "bytes" (state.pt)}
        self.saves: List[dict] = []

    def save(self, epoch: int, model: torch.nn.Module,
             optimizer: torch.optim.Optimizer, best_val_loss: float,
             output_json: dict, mid_epoch: Optional[dict] = None,
             generator: Optional[torch.Generator] = None,
             wait: bool = True) -> None:
        """Save the full train state at `epoch`. `mid_epoch` ({"batch_idx":
        completed steps, "sums": running metric sums}) and `generator` mark a
        preemption checkpoint taken inside the epoch.

        `wait=False` returns once every tensor is copied to the host and
        writes the files on a background thread, so the next epoch's compute
        overlaps the write: Adam updates the parameters and its moments in
        place, and a writer holding the device tensors would save a later
        step's state. Preemption saves keep wait=True: the process exits
        next."""
        t0 = time.perf_counter()
        self.wait_until_finished()
        optimizer_state = optimizer.state_dict()
        if self.sharded:
            optimizer_state = mesh_lib.gather_optimizer_state(
                optimizer_state, model, self.sharded, self.mesh)
        state = {"model": _full_state(model, self.mesh, self.sharded),
                 "optimizer": optimizer_state}
        if not self.primary:
            return
        if generator is not None:
            state["generator"] = generator.get_state()
        state = _host_copy(state)
        meta = {"epoch": epoch, "best_val_loss": float(best_val_loss)}
        if mid_epoch is not None:
            meta["mid_epoch"] = copy.deepcopy(mid_epoch)
        record = {"epoch": epoch, "wait": wait}
        self.saves.append(record)
        args = (epoch, state, meta, copy.deepcopy(output_json), record)
        if wait:
            self._write(*args)
        else:
            self._writer = threading.Thread(
                target=self._write_in_background, args=args,
                name=f"checkpoint-{epoch}", daemon=True)
            self._writer.start()
        record["blocked_s"] = time.perf_counter() - t0

    def _write_in_background(self, *args):
        try:
            self._write(*args)
        except Exception as e:  # re-raised by wait_until_finished
            self._error = e

    def _write(self, epoch, state, meta, output_json, record):
        t0 = time.perf_counter()
        os.makedirs(self.root, exist_ok=True)
        final = os.path.join(self.root, str(epoch))
        tmp = os.path.join(self.root, f".tmp-{epoch}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE))
        for name, obj in ((META, meta), (OUTPUT_JSON, output_json)):
            with open(os.path.join(tmp, name), "w") as f:
                json.dump(obj, f)
        if os.path.exists(final):
            # the newer state wins; move the old one aside first, so the
            # epoch's directory is always one whole checkpoint
            old = os.path.join(self.root, f".old-{epoch}")
            shutil.rmtree(old, ignore_errors=True)
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old)
        else:
            os.rename(tmp, final)
        for stale in self.all_epochs()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.root, str(stale)))
        record["bytes"] = os.path.getsize(os.path.join(final, STATE))
        record["write_s"] = time.perf_counter() - t0

    def wait_until_finished(self) -> None:
        """Block until the background write has finished; re-raise its
        error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def all_epochs(self) -> List[int]:
        if not os.path.isdir(self.root):
            return []
        return sorted(int(name) for name in os.listdir(self.root)
                      if name.isdigit())

    def latest_epoch(self) -> Optional[int]:
        self.wait_until_finished()
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def restore(self, model: torch.nn.Module,
                optimizer: torch.optim.Optimizer,
                epoch: Optional[int] = None):
        """Load the newest (or `epoch`'s) checkpoint into `model` and
        `optimizer` in place. Returns (epoch, best_val_loss, output_json,
        mid_epoch or None, the generator state or None)."""
        self.wait_until_finished()
        epoch = self.latest_epoch() if epoch is None else epoch
        path = os.path.join(self.root, str(epoch))
        state = torch.load(os.path.join(path, STATE), map_location="cpu",
                           weights_only=True)
        if self.sharded:
            state["model"] = mesh_lib.slice_params(state["model"],
                                                   self.sharded, self.mesh)
            state["optimizer"] = mesh_lib.slice_optimizer_state(
                state["optimizer"], model, self.sharded, self.mesh)
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        with open(os.path.join(path, META)) as f:
            meta = json.load(f)
        with open(os.path.join(path, OUTPUT_JSON)) as f:
            output_json = json.load(f)
        return (meta["epoch"], meta["best_val_loss"], output_json,
                meta.get("mid_epoch"), state.get("generator"))


def write_output_json(workdir: str, name: str, output_json: dict) -> str:
    path = os.path.join(workdir, f"{name}_output.json")
    os.makedirs(workdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(output_json, f, indent=2)
    return path


def save_best_params(workdir: str, model: torch.nn.Module,
                     mesh: Optional[mesh_lib.Mesh] = None,
                     sharded: Optional[dict] = None) -> str:
    """Write the model's parameters (CPU copies) to `{workdir}/best.pth`,
    through a temporary file so a reader never sees a partial one. Under a
    mesh every rank calls it (the split parameters are gathered) and rank 0
    writes."""
    path = os.path.join(workdir, BEST_PARAMS)
    state = _full_state(model, mesh, sharded)
    if mesh is not None and not mesh.is_primary:
        return path
    os.makedirs(workdir, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in state.items()}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path
