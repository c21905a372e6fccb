"""One train step, or one `wm-pretrain-torch` run, on every rank of a mesh:
the worker that the port's tests and `chip_smoke.py` launch to hold a mesh
run against a one-process run.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m weathermodel_tpu_torch.parallel.step_check job.json

`job.json` is {"device": "cpu" | "cuda" | "cuda:N", "tasks": [...]}; the
ranks join one process group (parallel/multihost.py) and run the tasks in
order:
  {"kind": "step", "mesh": [n_data, n_model], "inputs": npz, "state": pth,
   "config": {...}, "out": npz, "fsdp": bool, "storage": "rules" |
   "experts", ...}
      one train step (`step_task`) of a model of the given config from the
      state dict, on the npz's global batch and mask, dropout off, its
      parameters stored as JAX's rules split them (with "fsdp", over 'data'
      too) or, with "storage": "experts", only the experts split (a mesh
      run without sharded storage); rank 0 writes the global metrics, the
      gathered gradients and updated parameters, and each rank's masked
      count, stored parameter entries (and those its blocks hold by the
      rules) and the kernels' launches; with "digest" a hash of each
      gradient and parameter too (-0.0 read as 0.0), and with "arrays":
      false only those hashes.
  {"kind": "pretrain", "argv": [...], "out": json, "sigterm": [epoch, step]}
      `wm-pretrain-torch`'s run(args) with the kernels' counts at 0; rank 0
      is sent a real SIGTERM as that training step starts (when given);
      each rank writes `{out}.rank{r}.json` with the result, its launches
      and its peak device memory.
`step_task` is also the one-process reference, called in the caller's own
process without a process group. Rank 0 logs each task's seconds. Imports
nothing of JAX.
"""

import hashlib
import json
import logging
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from weathermodel_tpu_torch.parallel import mesh as mesh_lib
from weathermodel_tpu_torch.parallel import multihost

logger = logging.getLogger(__name__)


def counted_kernels():
    """The wrappers whose launches a mesh run reports: B4 and B4t, their
    window forms B4s and B4ts, and the attention kernels."""
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention,
        fused_qkv_attention_bwd,
        fused_qkv_attention_train,
    )
    from weathermodel_tpu_torch.ops.gmm import (
        gmm,
        gmm_sharded,
        tgmm,
        tgmm_sharded,
    )

    return (gmm_sharded, tgmm_sharded, gmm, tgmm, fused_qkv_attention,
            fused_qkv_attention_train, fused_qkv_attention_bwd)


def _reset(kernels):
    for fn in kernels:
        fn.launches = 0


def _launches(kernels) -> dict:
    return {fn.__name__: fn.launches for fn in kernels}


def _gathered(model, specs, mesh, grads: bool) -> dict:
    """Each parameter (or its gradient), its blocks gathered whole, on the
    host."""
    out = {}
    for name, p in model.named_parameters():
        t = p.grad if grads else p.detach()
        if mesh is not None and name in specs:
            t = mesh_lib.gather(t, specs[name], mesh)
        out[name] = t.detach().float().cpu().numpy()
    return out


def _split_experts(model, mesh) -> dict:
    """Keep this rank's block of the expert weights alone, every other
    parameter whole: the layout of a mesh run without sharded storage,
    where only expert parallelism splits a parameter (its compute needs
    it). Returns {name: spec}, as `shard_params`."""
    specs = {}
    for name, p in list(model.named_parameters()):
        spec = mesh_lib.param_sharding_rules(name, p.shape, mesh)
        if "expert_" not in name or not mesh_lib.is_split(spec):
            continue
        specs[name] = spec
        parent, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent), attr, torch.nn.Parameter(
            mesh_lib.local_slice(p.detach(), spec, mesh).clone()))
    return specs


def step_task(task: dict, device) -> dict:
    """One train step of task["config"] (a model_config_for_size size and
    overrides, an attention and grouped-matmul impl, a dtype) from the state
    dict task["state"] on task["inputs"] (weather, coords, year, interval
    and the mask, global), with SGD or Adam at task["lr"], dropout off.
    Under a process group the ranks run it on a task["mesh"] mesh. Returns
    the host results (rank 0's are the ones to read)."""
    from weathermodel_tpu_torch.cli.pretrain import make_model
    from weathermodel_tpu_torch.train.steps import (
        Batch,
        batch_to_device,
        make_train_step,
    )
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    c = task["config"]
    cfg = model_config_for_size(c["size"], **c.get("overrides", {}))
    model = make_model(c.get("model", "weatherbert"), cfg,
                       c.get("attention_impl", "torch"),
                       gmm_impl=c.get("gmm_impl", "kernel"))
    model.load_state_dict(torch.load(task["state"], map_location="cpu",
                                     weights_only=True))
    model = model.to(device)
    mesh = None
    specs = {}
    if multihost.launched():
        mesh = mesh_lib.make_mesh(*task["mesh"])
        if task.get("storage") == "experts":
            specs = _split_experts(model, mesh)
        else:
            specs = mesh_lib.shard_params(model, mesh,
                                          fsdp=bool(task.get("fsdp")))
    params = list(model.parameters())
    opt = (torch.optim.SGD(params, lr=task["lr"])
           if task.get("optimizer", "sgd") == "sgd"
           else torch.optim.Adam(params, lr=task["lr"]))
    step = make_train_step(model, opt, "weatherbert",
                           objective=c.get("objective", "masked_mse"),
                           grad_accum=task.get("grad_accum", 1),
                           mesh=mesh)
    data = np.load(task["inputs"])
    batch = batch_to_device(Batch(data["weather"], data["coords"],
                                  data["year"], data["interval"]),
                            device)
    mask = torch.from_numpy(data["mask"]).to(device)
    kernels = counted_kernels()
    _reset(kernels)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    metrics = step(batch, torch.Generator().manual_seed(0), task["lr"],
                   1, mask=mask, dropout_rate=0.0)
    metrics = {k: float(v) for k, v in metrics.items()}
    seconds = time.perf_counter() - t0
    launches = _launches(kernels)
    out = {f"metric/{k}": np.float64(v) for k, v in metrics.items()}
    out.update({f"grad/{k}": v for k, v in
                _gathered(model, specs, mesh, grads=True).items()})
    out.update({f"param/{k}": v for k, v in
                _gathered(model, specs, mesh, grads=False).items()})
    if task.get("digest"):
        for k in [k for k in out if k.startswith(("grad/", "param/"))]:
            out[f"hash/{k}"] = digest(out[k])
    world = 1 if mesh is None else mesh.world
    rank = 0 if mesh is None else mesh.rank
    # this rank's masked count (its data shard of the mask), stored
    # entries, those the rules give it, and launches, one column each rank,
    # summed over the ranks
    rows = mesh_lib.shard_batch(mesh, mask)
    shapes = {k[len("param/"):]: v.shape for k, v in out.items()
              if k.startswith("param/")}
    per_rank = torch.zeros(3 + len(kernels), world, dtype=torch.float64,
                           device=device)
    per_rank[0, rank] = float(rows.sum())
    per_rank[1, rank] = sum(p.numel() for p in model.parameters())
    per_rank[2, rank] = mesh_lib.expected_elements(shapes, specs, mesh)
    for i, fn in enumerate(kernels):
        per_rank[3 + i, rank] = launches[fn.__name__]
    if mesh is not None:
        dist.all_reduce(per_rank)
    per_rank = per_rank.cpu().numpy()
    out["mask_counts"] = per_rank[0]
    out["stored/params"] = per_rank[1]
    out["stored/by_rules"] = per_rank[2]
    for i, fn in enumerate(kernels):
        out[f"launches/{fn.__name__}"] = per_rank[3 + i]
    out["seconds"] = np.float64(seconds)
    if not task.get("arrays", True):
        out = {k: v for k, v in out.items()
               if not k.startswith(("grad/", "param/"))}
    return out


def digest(a: np.ndarray) -> np.ndarray:
    """A hash of an fp32 array's bits, with -0.0 read as 0.0 (x + 0.0): two
    arrays of one shape have one digest iff they are equal as numbers."""
    a = np.ascontiguousarray(a, np.float32) + np.float32(0.0)
    return np.frombuffer(hashlib.blake2b(a.tobytes(), digest_size=16)
                         .digest(), np.uint8).copy()


def pretrain_task(task: dict) -> dict:
    """`wm-pretrain-torch`'s run(args) on task["argv"], the kernels' counts
    at 0 just before; rank 0 is sent a SIGTERM as training step
    task["sigterm"] = [epoch, step] starts, when given."""
    import contextlib

    from weathermodel_tpu_torch.cli import pretrain

    args = pretrain.build_parser().parse_args(task["argv"])
    kernels = counted_kernels()
    stop = contextlib.nullcontext()
    rank = dist.get_rank() if dist.is_initialized() else 0
    if task.get("sigterm") and rank == 0:
        from weathermodel_tpu_torch.testing import sigterm_during_step

        stop = sigterm_during_step(*task["sigterm"])
    device = multihost.rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _reset(kernels)
    t0 = time.perf_counter()
    with stop:
        result = pretrain.run(args)
    seconds = time.perf_counter() - t0
    return {"rank": rank, "result": {k: v for k, v in result.items()
                                     if k != "checkpoint_saves"},
            "launches": _launches(kernels), "seconds": seconds,
            "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None)}


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        job = json.load(f)
    multihost.initialize(job["device"])
    device = multihost.rank_device(job["device"])
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        for i, task in enumerate(job["tasks"]):
            t0 = time.perf_counter()
            if task["kind"] == "step":
                out = step_task(task, device)
                if rank == 0:
                    np.savez(task["out"], **out)
            elif task["kind"] == "pretrain":
                out = pretrain_task(task)
                with open(f"{task['out']}.rank{rank}.json", "w") as f:
                    json.dump(out, f)
            else:
                raise ValueError(f"unknown task kind {task['kind']!r}")
            if dist.is_initialized():
                dist.barrier()
            if rank == 0:
                logger.info("step_check: task %d (%s) took %.1f s", i,
                            task["kind"], time.perf_counter() - t0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
