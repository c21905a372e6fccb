"""The port's (data, model) mesh on torch.distributed, with ranks started by
`torchrun` on the CPU under gloo (`--device cpu`), against the JAX package.

Two spawned jobs (weathermodel_tpu_torch/parallel/step_check.py), run once
for the session and read by the parametrised asserts: two ranks run one
train step on a 1 x 2 mesh and three `wm-pretrain-torch --tensor-parallel 2`
runs (uninterrupted, stopped by a SIGTERM to rank 0 alone, resumed), and
the step again with --moe-remat; four ranks run the step on 2 x 2 and 1 x 4
meshes (E = 4: two experts a rank, then one). Sharded storage rides on the
same two jobs: the dense WeatherBERT-small layer under --fsdp on 2 x 1, the
MoE under --fsdp on 2 x 2, each beside the same mesh without sharded
storage, the sort and scatter dispatches' expert split on 1 x 2 (against
the one-process step and JAX's step of that dispatch on 1 x 2), and
`wm-pretrain-torch --fsdp --remat` (WeatherBERT-small) uninterrupted,
preempted and resumed on two ranks. The children import nothing of JAX: they read the
JAX-initialised parameters and the batch from files. The step (fp32, dropout
off, SGD) is held against JAX's EP step on the same mesh shape and JAX's
single-device ragged step (losses, aux, gradients and updated parameters at
2e-5), with
JAX's grouped matmul through its plain reference (`_gmm_offset_ref`,
`ragged_dot`; the kernels' forms are held in test_torch_port_ep.py). The
pins of the trouble spots: the gradients are JAX's, not n_model times them,
and so are the router's and every layer's below the experts (the partial
row gradients are summed); the data ranks' masked counts differ and the
loss is still the global one; the mesh run's gathered best.pth and last
checkpoint equal a one-process run's bit for bit (1 x 2: the same draws)
and load in `wm-serve-torch`; the preempted and resumed mesh run ends
bitwise equal to the uninterrupted one. Then the JAX trainer's error text
for the parallel flags, the sharding rules against JAX's, and the backend
and device rules."""

import fcntl
import functools
import json
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weathermodel_tpu.models import WeatherBERT as JaxWeatherBERT
from weathermodel_tpu.models.moe import (
    configure_expert_parallel as jax_configure_ep,
)
from weathermodel_tpu.ops import pallas_gmm
from weathermodel_tpu.parallel.mesh import make_mesh as jax_make_mesh
from weathermodel_tpu.parallel.mesh import (
    combined_sharding_rules as jax_combined_rules,
)
from weathermodel_tpu.parallel.mesh import (
    param_sharding_rules as jax_rules,
)
from weathermodel_tpu.parallel.mesh import shard_batch as jax_shard_batch
from weathermodel_tpu.parallel.mesh import shard_params as jax_shard_params
from weathermodel_tpu.train.steps import Batch as JaxBatch
from weathermodel_tpu.train.steps import _objective_losses
from weathermodel_tpu.utils.config import (
    model_config_for_size as jax_config_for_size,
)
from weathermodel_tpu_torch.cli import pretrain, serve
from weathermodel_tpu_torch.data.chunks import write_synthetic_dataset
from weathermodel_tpu_torch.models.transfer import state_dict_from_jax_params
from weathermodel_tpu_torch.parallel import mesh as mesh_lib
from weathermodel_tpu_torch.parallel import multihost
from weathermodel_tpu_torch.parallel.step_check import step_task
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.utils.config import model_config_for_size

from test_torch_port_jax_params import jax_params_from_state

ROOT = Path(__file__).resolve().parents[1]
T, B, LR = 16, 8, 0.05
MODEL = dict(max_len=T, num_layers=1, num_experts=4, moe_top_k=2,
             moe_dispatch="ragged", dropout_rate=0.0,
             compute_dtype="float32")
MESHES = [(1, 2), (2, 2), (1, 4)]
CLI_T = 24
# the dense model of the --fsdp steps: one WeatherBERT-small layer, whose
# attention and FFN weights are past FSDP_MIN_ELEMS (mini's are not), one of
# them square (out_proj: JAX's tie)
DENSE, DENSE_SIZE = dict(max_len=T, num_layers=1, dropout_rate=0.0,
                         compute_dtype="float32"), "small"
DISPATCHES = ("sort", "scatter")
# sharded storage: the step task of each case (its tag) and the one of the
# same mesh without sharded storage
STORAGE_CASES = {"fsdp-2x1": ("2x1-dense-fsdp", "2x1-dense"),
                 "fsdp-2x2": ("2x2-fsdp", "2x2-experts"),
                 "split-1x2": ("1x2", "1x2-experts"),
                 "split-2x2": ("2x2", "2x2-experts")}


def _shared(tmp_path_factory, name, compute):
    """compute(dir) run once for the whole session, under a file lock in a
    directory the session's xdist workers share; the others load its
    pickled result."""
    run_id = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run_id is None:
        root = tmp_path_factory.mktemp(name)
    else:
        root = tmp_path_factory.getbasetemp().parent / f"{name}-{run_id}"
        root.mkdir(exist_ok=True)
    with open(root / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = root / "result.pkl"
        if not done.exists():
            result = compute(root)
            with open(done, "wb") as f:
                pickle.dump(result, f)
        with open(done, "rb") as f:
            return pickle.load(f)


def _inputs(root: Path):
    rng = np.random.default_rng(0)
    data = dict(
        weather=rng.normal(size=(B, T, 31)).astype(np.float32),
        coords=rng.uniform(-90, 90, (B, 2)).astype(np.float32),
        year=(1990.0 + np.arange(T, dtype=np.float32) * 7 / 365
              + rng.integers(0, 10, (B, 1))).astype(np.float32),
        interval=np.full((B, 1), 7.0, np.float32),
        mask=rng.random((B, T, 31)) < 0.3)
    np.savez(root / "inputs.npz", **data)
    cfg = jax_config_for_size("mini", **MODEL)
    params = jax.jit(JaxWeatherBERT(cfg).init)(
        jax.random.PRNGKey(0), *(jnp.asarray(data[k]) for k in (
            "weather", "coords", "year", "interval", "mask")))
    params = jax.tree.map(np.asarray, params)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                state_dict_from_jax_params(params).items()},
               root / "state.pth")
    # the dense model from the port's seeded init (its flax tree:
    # `_dense_jax_params`)
    dense = pretrain.make_model(
        "weatherbert", model_config_for_size(DENSE_SIZE, **DENSE), "torch")
    dense.reset_parameters(torch.Generator().manual_seed(0))
    torch.save(dense.state_dict(), root / "dense.pth")
    return data, params


def _jax_mesh(n_data, n_model):
    return jax_make_mesh(n_data, n_model,
                         devices=jax.devices()[:n_data * n_model])


def _dense_jax_params(root: Path, data):
    """The dense model's flax tree: the port's seeded init that `_inputs`
    saved, through the inverse of `state_dict_from_jax_params`."""
    return jax_params_from_state(
        lambda: JaxWeatherBERT(jax_config_for_size(DENSE_SIZE, **DENSE)).init(
            jax.random.PRNGKey(0), *(jnp.asarray(data[k]) for k in (
                "weather", "coords", "year", "interval", "mask"))),
        state_dict_from_jax_params,
        torch.load(root / "dense.pth", weights_only=True))


def _step_task(root, mesh, tag="", model=MODEL, state="state.pth",
               size="mini", **options):
    return dict(kind="step", mesh=list(mesh), inputs=str(root / "inputs.npz"),
                state=str(root / state), lr=LR,
                config=dict(size=size, overrides=model),
                out=str(root / f"step-{mesh[0]}x{mesh[1]}{tag}.npz"),
                **options)


def _dense_task(root, mesh, tag, **options):
    return _step_task(root, mesh, tag, DENSE, "dense.pth", DENSE_SIZE,
                      **options)


def _cli_argv(store, workdir, *extra):
    return ["--model", "weatherbert", "--model-size", "mini",
            "--moe-experts", "4", "--batch-size", "8", "--n-epochs", "1",
            "--n-warmup-epochs", "0", "--masking-prob", "0.15",
            "--data-dir", str(store), "--workdir", str(workdir),
            "--compute-dtype", "float32", "--device", "cpu", *extra]


def _launch(root, name, n, tasks):
    with open(root / f"{name}.json", "w") as f:
        json.dump({"device": "cpu", "tasks": tasks}, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    log = open(root / f"{name}.log", "w")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m",
         "weathermodel_tpu_torch.parallel.step_check",
         str(root / f"{name}.json")], cwd=ROOT, env=env, stdout=log,
        stderr=subprocess.STDOUT)


def _fsdp_argv(store, workdir, *extra):
    return ["--model", "weatherbert", "--model-size", DENSE_SIZE,
            "--batch-size", "8", "--n-epochs", "1", "--n-warmup-epochs", "0",
            "--masking-prob", "0.15", "--data-dir", str(store), "--workdir",
            str(workdir), "--compute-dtype", "float32", "--device", "cpu",
            "--fsdp", "--remat", *extra]


def _jax_step(params, data, mesh, fsdp=False, model=MODEL, size="mini"):
    """JAX's train-step objective and its gradients (deterministic=False,
    dropout 0: the aux loss is in the total), on `mesh` with the EP
    shard_map (the parameters placed by `shard_params`, with `fsdp` over
    'data' too) or on one device."""
    cfg = jax_config_for_size(size, **model)
    model = JaxWeatherBERT(cfg, attention_impl="xla")
    jax_configure_ep(mesh)
    batch = JaxBatch(*(jnp.asarray(data[k]) for k in (
        "weather", "coords", "year", "interval")))
    mask = jnp.asarray(data["mask"])
    if mesh is not None:
        params = jax_shard_params(params, mesh, fsdp=fsdp)
        batch = JaxBatch(*(jax_shard_batch(mesh, np.asarray(a))
                           for a in batch[:4]))
        mask = jax_shard_batch(mesh, data["mask"])

    def loss_fn(p):
        losses = _objective_losses(
            model, "masked_mse", p, batch, mask, 1.0, deterministic=False,
            rngs={"dropout": jax.random.PRNGKey(1)}, sample_key=None)
        return losses["total_loss"], losses

    # compiled without LLVM's optimisations: a third less compile time, the
    # same sums to a few ulps
    (_, losses), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True),
        compiler_options={"xla_backend_optimization_level": 0})(params)
    grads = state_dict_from_jax_params(jax.tree.map(np.asarray, grads))
    return ({k: float(v) for k, v in losses.items()},
            {k: np.asarray(v) for k, v in grads.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two jobs' results, the JAX steps and the one-process runs."""
    return _shared(tmp_path_factory, "torch_port_mesh", _compute)


def _jax_steps(root: Path, data, params) -> dict:
    """JAX's steps: one device, each mesh's EP step, the sort and scatter
    dispatches on 1 x 2 and the --fsdp steps."""
    out = {}
    pallas_gmm.set_interpret(False)
    try:
        out[None] = _jax_step(params, data, None)
        for n_data, n_model in MESHES:
            out[n_data, n_model] = _jax_step(params, data,
                                             _jax_mesh(n_data, n_model))
        for d in DISPATCHES:
            out[f"1x2-{d}"] = _jax_step(params, data, _jax_mesh(1, 2),
                                        model=dict(MODEL, moe_dispatch=d))
        out["fsdp-2x1"] = _jax_step(
            _dense_jax_params(root, data), data, _jax_mesh(2, 1), fsdp=True,
            model=DENSE, size=DENSE_SIZE)
        out["fsdp-2x2"] = _jax_step(params, data, _jax_mesh(2, 2),
                                    fsdp=True)
    finally:
        pallas_gmm.set_interpret(True)
        jax_configure_ep(None)
    return out


def _one_process(root: Path, store) -> dict:
    """The port's one-process steps (ragged, sort, scatter) and its
    one-process `wm-pretrain-torch` run, on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu = torch.device("cpu")
        out = {None: step_task(_step_task(root, (1, 1)), cpu)}
        for d in DISPATCHES:
            out[f"one-{d}"] = step_task(_step_task(
                root, (1, 1), f"-{d}", dict(MODEL, moe_dispatch=d)), cpu)
        pretrain.run(pretrain.build_parser().parse_args(
            _cli_argv(store, root / "one")))
    finally:
        torch.set_num_threads(threads)
    return out


def _compute(root: Path) -> dict:
    data, params = _inputs(root)
    store = root / "store"
    write_synthetic_dataset(str(store), n_chunks=8, n_samples=6,
                            seq_len=CLI_T, seed=0)
    jobs = {
        "two": _launch(root, "two", 2, [
            _step_task(root, (1, 2)),
            _step_task(root, (1, 2), "-remat", dict(MODEL, moe_remat=True)),
            _step_task(root, (1, 2), "-experts", storage="experts"),
            *(_step_task(root, (1, 2), f"-{d}", dict(MODEL, moe_dispatch=d))
              for d in DISPATCHES),
            _dense_task(root, (2, 1), "-dense"),
            _dense_task(root, (2, 1), "-dense-fsdp", fsdp=True),
            dict(kind="pretrain", out=str(root / "cli-base"),
                 argv=_cli_argv(store, root / "mesh-base",
                                "--tensor-parallel", "2")),
            dict(kind="pretrain", out=str(root / "cli-pre"), sigterm=[0, 2],
                 argv=_cli_argv(store, root / "mesh-pre",
                                "--tensor-parallel", "2")),
            dict(kind="pretrain", out=str(root / "cli-res"),
                 argv=_cli_argv(store, root / "mesh-pre",
                                "--tensor-parallel", "2",
                                "--resume-from-checkpoint",
                                str(root / "mesh-pre"))),
            dict(kind="pretrain", out=str(root / "cli-fsdp-base"),
                 argv=_fsdp_argv(store, root / "fsdp-base")),
            dict(kind="pretrain", out=str(root / "cli-fsdp-pre"),
                 sigterm=[0, 2], argv=_fsdp_argv(store, root / "fsdp-pre")),
            dict(kind="pretrain", out=str(root / "cli-fsdp-res"),
                 argv=_fsdp_argv(store, root / "fsdp-pre",
                                 "--resume-from-checkpoint",
                                 str(root / "fsdp-pre")))]),
        "four": _launch(root, "four", 4, [
            *(_step_task(root, m) for m in MESHES[1:]),
            _step_task(root, (2, 2), "-fsdp", fsdp=True),
            _step_task(root, (2, 2), "-experts", storage="experts")])}
    out = {"jax": _jax_steps(root, data, params),
           "port": _one_process(root, store)}
    for name, proc in jobs.items():
        if proc.wait(timeout=300) != 0:
            raise AssertionError((root / f"{name}.log").read_text()[-4000:])
    for mesh in MESHES:
        with np.load(root / f"step-{mesh[0]}x{mesh[1]}.npz") as z:
            out["port"][mesh] = dict(z)
    for tag in ("1x2-remat", "1x2-experts", "1x2-sort", "1x2-scatter",
                "2x1-dense", "2x1-dense-fsdp", "2x2-fsdp", "2x2-experts"):
        with np.load(root / f"step-{tag}.npz") as z:
            out["port"][tag] = dict(z)
    out["port"]["remat"] = out["port"]["1x2-remat"]
    out["cli"] = {}
    for run in ("base", "pre", "res", "fsdp-base", "fsdp-pre", "fsdp-res"):
        out["cli"][run] = [json.loads((root / f"cli-{run}.rank{r}.json")
                                      .read_text()) for r in range(2)]
    out["root"] = root
    return out


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5, err_msg=what)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("against", ["jax_ep", "jax_single"])
def test_ep_step_matches_jax(runs, mesh, against):
    """Loss, aux, every gradient (experts gathered) and every updated
    parameter of the port's mesh step against JAX's EP step on the same
    mesh shape, and against JAX's single-device ragged step."""
    port = runs["port"][mesh]
    losses, grads = runs["jax"][mesh if against == "jax_ep" else None]
    for k in ("total_loss", "moe_aux", "mae"):
        _close(port[f"metric/{k}"], losses[k], k)
    before = torch.load(runs["root"] / "state.pth", weights_only=True)
    assert {k[5:] for k in port if k.startswith("grad/")} == set(grads)
    for k, g in grads.items():
        _close(port[f"grad/{k}"], g, k)
        _close(port[f"param/{k}"], before[k].numpy() - LR * g, k)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ep_step_matches_the_one_process_step(runs, mesh):
    """Against the port's own one-process step: the metrics to 2e-5, and
    bit for bit on the 1 x 2 mesh, where each rank sees the rows a single
    process sees (a row's output is one rank's, plus zeros)."""
    port, one = runs["port"][mesh], runs["port"][None]
    keys = [k for k in one if k.startswith(("metric/", "grad/", "param/"))]
    for k in keys:
        _close(port[k], one[k], k)
    if mesh == (1, 2):
        assert all(np.array_equal(port[k], one[k]) for k in keys)


def test_ep_step_with_moe_remat_replays_the_collectives(runs):
    """--moe-remat under the 1 x 2 mesh: the backward recomputes the
    expert block, all_reduce included, in the same order on both ranks, and
    the step equals the one without remat bit for bit."""
    remat, plain = runs["port"]["remat"], runs["port"][(1, 2)]
    keys = [k for k in plain if k.startswith(("metric/", "grad/", "param/"))]
    assert all(np.array_equal(remat[k], plain[k]) for k in keys)


def _keys(step):
    return [k for k in step if k.startswith(("metric/", "grad/", "param/"))]


def test_sharded_storage_step_matches_jax(runs):
    """Loss, every gradient and every updated parameter (blocks gathered)
    of the port's step under --fsdp against JAX's step on the same mesh
    with `shard_params(..., fsdp=True)`: the dense small layer on 2 x 1, the
    MoE on 2 x 2."""
    for case, tag, state in (("fsdp-2x1", "2x1-dense-fsdp", "dense.pth"),
                             ("fsdp-2x2", "2x2-fsdp", "state.pth")):
        port = runs["port"][tag]
        losses, grads = runs["jax"][case]
        for k in ("total_loss", "mae",
                  *(("moe_aux",) if "moe_aux" in losses else ())):
            _close(port[f"metric/{k}"], losses[k], f"{case} {k}")
        before = torch.load(runs["root"] / state, weights_only=True)
        assert {k[5:] for k in port if k.startswith("grad/")} == set(grads)
        for k, g in grads.items():
            _close(port[f"grad/{k}"], g, f"{case} {k}")
            _close(port[f"param/{k}"], before[k].numpy() - LR * g,
                   f"{case} {k}")


def test_sharded_storage_step_is_bitwise(runs):
    """A step with parameters stored as blocks (--fsdp over 'data', the
    dense weights over 'model') gives the metrics, gradients and updated
    parameters of the same mesh with them whole (only the experts split),
    bit for bit (-0.0 = 0.0): the gathers are exact, and the sums over
    'data' add the same two values. Each rank stores the parameter entries
    its blocks hold by the rules, fewer than one process's (the sort
    dispatch's split on 1 x 2 too)."""
    for case, (tag, plain) in STORAGE_CASES.items():
        got = runs["port"][(1, 2) if tag == "1x2" else (2, 2) if tag == "2x2"
                           else tag]
        want = runs["port"][plain]
        keys = _keys(want)
        assert keys == _keys(got), case
        assert all(np.array_equal(got[k], want[k]) for k in keys), case
    for tag in ((1, 2), "2x1-dense-fsdp", "2x2-fsdp", "1x2-sort"):
        port = runs["port"][tag]
        full = sum(port[k].size for k in port if k.startswith("param/"))
        assert (port["stored/params"] == port["stored/by_rules"]).all(), tag
        assert (port["stored/params"] < full).all(), tag


def test_capacity_dispatch_split_matches_the_one_process_step(runs):
    """--tensor-parallel 2 with the sort and scatter dispatches (each rank
    its two experts' window of the capacity buffer, the combine summed over
    'model') against the port's one-process step and JAX's step of that
    dispatch on the 1 x 2 mesh (its expert weights on P('model'), GSPMD's
    split): the loss, aux, every gradient and every updated parameter to
    2e-5."""
    before = torch.load(runs["root"] / "state.pth", weights_only=True)
    for dispatch in DISPATCHES:
        port = runs["port"][f"1x2-{dispatch}"]
        one = runs["port"][f"one-{dispatch}"]
        assert _keys(port) == _keys(one)
        for k in _keys(one):
            _close(port[k], one[k], f"{dispatch} {k}")
        losses, grads = runs["jax"][f"1x2-{dispatch}"]
        for k in ("total_loss", "moe_aux", "mae"):
            _close(port[f"metric/{k}"], losses[k], f"{dispatch} {k}")
        assert {k[5:] for k in port if k.startswith("grad/")} == set(grads)
        for k, g in grads.items():
            _close(port[f"grad/{k}"], g, f"{dispatch} {k}")
            _close(port[f"param/{k}"], before[k].numpy() - LR * g,
                   f"{dispatch} {k}")


def test_fsdp_remat_cli_resumes_bitwise(runs):
    """`wm-pretrain-torch --fsdp --remat` on two ranks (WeatherBERT-small,
    dropout 0.1): each rank holds the parameter and Adam entries of its
    blocks; best.pth and the checkpoints are the one-process files (full
    shapes); stopped by a SIGTERM at step 2 and resumed, the run ends with
    the uninterrupted run's record, best.pth and last checkpoint bit for
    bit."""
    root = runs["root"]
    base, res = root / "fsdp-base", root / "fsdp-pre"
    cfg = model_config_for_size(DENSE_SIZE, max_len=CLI_T)
    model = pretrain.make_model("weatherbert", cfg, "torch")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    mesh = mesh_lib.Mesh(2, 1)
    specs = {k: mesh_lib.combined_sharding_rules(k, v, mesh, fsdp=True)
             for k, v in shapes.items()}
    want = mesh_lib.expected_elements(shapes, specs, mesh)
    assert want < sum(int(np.prod(v)) for v in shapes.values())
    for run in ("fsdp-base", "fsdp-res"):
        for r in runs["cli"][run]:
            assert r["result"]["stored_elements"] == {
                "params": want, "optimizer": 2 * want}
    assert all(r["result"].get("preempted") is True
               for r in runs["cli"]["fsdp-pre"])
    assert (_load(base / "weatherbert_output.json")["losses"]
            == _load(res / "weatherbert_output.json")["losses"])
    best = _load(base / "best.pth")
    assert {k: tuple(v.shape) for k, v in best.items()} == shapes
    _equal_states(best, _load(res / "best.pth"))
    a = _load(base / "checkpoints/0/state.pt")
    b = _load(res / "checkpoints/0/state.pt")
    _equal_states(a["model"], b["model"])
    for i, entry in a["optimizer"]["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(entry[k], b["optimizer"]["state"][i][k])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ep_step_launches_and_local_counts(runs, mesh):
    """Every rank ran the window forms' path (their plain versions here:
    the wrappers count launches on the card only), no rank B4/B4t; the data
    ranks of the 2 x 2 mesh hold different masked counts, whose sum is the
    batch's."""
    port = runs["port"][mesh]
    for name in ("gmm", "tgmm", "gmm_sharded", "tgmm_sharded"):
        assert not port[f"launches/{name}"].any()
    counts = port["mask_counts"]
    assert len(counts) == mesh[0] * mesh[1]
    per_data = counts.reshape(mesh)[:, 0]
    assert per_data.sum() == runs["port"][None]["mask_counts"].sum()
    if mesh[0] > 1:
        assert len(set(per_data.tolist())) > 1


def _load(path: Path):
    if path.suffix == ".json":
        return json.loads(path.read_text())
    return torch.load(path, weights_only=True)


def _equal_states(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("run", ["mesh-base", "mesh-pre"])
def test_mesh_run_writes_the_one_process_files(runs, run):
    """`wm-pretrain-torch --tensor-parallel 2` on two ranks (dropout 0.1)
    writes the files of a one-process run, bit for bit: output_json's
    losses, best.pth and the last checkpoint's parameters and Adam state,
    the expert weights and moments gathered whole; the preempted and
    resumed run ("mesh-pre") too."""
    root = runs["root"]
    one, mesh = root / "one", root / run
    assert (_load(one / "weatherbert_output.json")["losses"]
            == _load(mesh / "weatherbert_output.json")["losses"])
    assert _load(mesh / "weatherbert_output.json")["model_config"][
        "n_devices"] == 2
    _equal_states(_load(one / "best.pth"), _load(mesh / "best.pth"))
    want = _load(one / "checkpoints/0/state.pt")
    got = _load(mesh / "checkpoints/0/state.pt")
    _equal_states(want["model"], got["model"])
    for i, entry in want["optimizer"]["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(entry[k], got["optimizer"]["state"][i][k])


def test_mesh_preemption_is_agreed_and_resumes(runs):
    """A SIGTERM to rank 0 alone stops both ranks at the same step boundary
    (the flag is all-reduced): both return "preempted" after 2 steps, and
    the resumed run finishes the epoch from there on both ranks (its
    boundary save replaces the mid-epoch checkpoint)."""
    pre, res = runs["cli"]["pre"], runs["cli"]["res"]
    assert all(r["result"].get("preempted") is True for r in pre)
    assert [len(s) for r in pre for s in r["result"]["train_step_seconds"]
            ] == []
    meta = _load(runs["root"] / "mesh-pre" / "checkpoints/0/meta.json")
    assert meta["epoch"] == 0 and "mid_epoch" not in meta
    assert all("preempted" not in r["result"] for r in res)
    steps = [len(r["result"]["train_step_seconds"][0]) for r in res]
    base = len(runs["cli"]["base"][0]["result"]["train_step_seconds"][0])
    assert steps == [base - 2, base - 2]


def test_mesh_best_params_serve(runs, tmp_path):
    """The mesh run's gathered best.pth loads in `wm-serve-torch
    --moe-experts 4` and serves finite outputs."""
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "w.npz",
             weather=rng.normal(size=(3, CLI_T, 31)).astype(np.float32))
    served = serve.run(serve.build_parser().parse_args([
        "--checkpoint", str(runs["root"] / "mesh-base" / "best.pth"),
        "--model-size", "mini", "--moe-experts", "4", "--input",
        str(tmp_path / "w.npz"), "--output", str(tmp_path / "o.npz"),
        "--batch-size", "4", "--compute-dtype", "float32", "--device",
        "cpu"]))
    assert served["n"] == 3
    with np.load(tmp_path / "o.npz") as z:
        assert np.isfinite(z["output"]).all()


def test_backend_and_device_rules(runs, monkeypatch):
    """One card a rank -> nccl; ranks pinned to one card or on the CPU ->
    gloo, which rank 0 of the jobs logged once each; a card that does not
    exist raises; outside torchrun the bootstrap is the identity; a failed
    init_process_group raises."""
    for job, n in (("two", 2), ("four", 4)):
        lines = [ln for ln in (runs["root"] / f"{job}.log").read_text()
                 .splitlines() if "multihost:" in ln]
        assert len(lines) == 1 and f"{n} ranks, backend gloo" in lines[0]
    assert multihost.backend_for(torch.device("cuda", 1), "cuda") == "nccl"
    assert multihost.backend_for(torch.device("cuda", 0), "cuda:0") == "gloo"
    assert multihost.backend_for(torch.device("cpu"), "cpu") == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.rank_device("cuda")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize("cpu") == multihost.HostInfo(0, 1)
    assert mesh_lib.make_mesh().shape == {"data": 1, "model": 1}

    def refuse(*args, **kwargs):
        raise RuntimeError("rendezvous refused")

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(multihost.dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="rendezvous refused"):
        multihost.initialize("cpu")


def _messages(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_parallel_flag_errors_mirror_the_jax_trainer(tmp_path):
    """Flag exclusivity and sequence parallelism with a ragged MoE (the
    CLI's checks, made before the unported flags exit), the world / degree
    divisibility (the trainer's) and the experts / 'model' divisibility
    (the sharding rules') raise the JAX trainer's error text."""
    from weathermodel_tpu.models.moe import get_ep_mesh as jax_get_ep_mesh
    from weathermodel_tpu.train.trainer import PretrainTrainer as JaxTrainer
    from weathermodel_tpu.utils.config import ModelConfig as JaxModelConfig
    from weathermodel_tpu.utils.config import TrainConfig as JaxTrainConfig
    from weathermodel_tpu_torch.train.trainer import PretrainTrainer
    from weathermodel_tpu_torch.utils.config import (
        TrainConfig,
        model_config_for_size,
    )

    cfg = model_config_for_size("mini", **MODEL)
    jcfg = JaxModelConfig(num_heads=4, num_layers=1, hidden_dim_factor=4,
                          max_len=T, num_experts=4, moe_dispatch="ragged")

    def port(**kw):
        flags = []
        for k, v in kw.items():
            flags += [f"--{k.replace('_', '-')}"] + ([] if v is True
                                                      else [str(v)])
        pretrain.check_parallel_flags(pretrain.build_parser().parse_args(
            _cli_argv(tmp_path, tmp_path, *flags)))

    def port_trainer(tensor_parallel):
        return PretrainTrainer(
            pretrain.make_model("weatherbert", cfg, "torch"), "weatherbert",
            cfg, TrainConfig(), lambda *a: iter(()), workdir=str(tmp_path),
            device="cpu", tensor_parallel=tensor_parallel)

    def jax_trainer(impl="xla", **kw):
        return JaxTrainer(JaxWeatherBERT(jcfg, attention_impl=impl),
                          "weatherbert", jcfg, JaxTrainConfig(),
                          lambda *a: iter(()), workdir=str(tmp_path), **kw)

    from weathermodel_tpu.ops import attention as jax_attention

    before = jax_get_ep_mesh(), dict(jax_attention._RING_CTX)
    try:
        for kw in (dict(seq_parallel=2, tensor_parallel=2),
                   dict(pipeline_stages=2, tensor_parallel=2),
                   dict(fsdp=True, seq_parallel=2)):
            assert _messages(lambda: port(**kw)) == _messages(
                lambda: jax_trainer(**kw))
        assert _messages(lambda: port(seq_parallel=2)) == _messages(
            lambda: jax_trainer("ring", seq_parallel=2))
        pattern = r"\d+ devices not divisible by parallel degree \d+"
        assert re.fullmatch(pattern, _messages(lambda: port_trainer(2)))
        assert re.fullmatch(pattern, _messages(
            lambda: jax_trainer(tensor_parallel=3)))
    finally:
        jax_configure_ep(before[0])
        jax_attention._RING_CTX.update(before[1])
    shape = (6, 8, 16)
    assert _messages(lambda: mesh_lib.param_sharding_rules(
        "transformer_encoder.layers.0.moe.expert_w1", shape,
        mesh_lib.Mesh(2, 4))) == _messages(lambda: jax_rules(
            ("params", "layer_0", "moe", "expert_w1"), shape,
            jax_make_mesh(2, 4)))
    with pytest.raises(SystemExit, match="ROADMAP.md queue A item 14"):
        pretrain.run(pretrain.build_parser().parse_args(
            _cli_argv(tmp_path, tmp_path, "--fsdp", "--tensor-parallel",
                      "2", "--pipeline-microbatches", "8")))


@pytest.mark.parametrize("experts", [0, 4])
def test_sharding_rules_match_jax(experts):
    """The port's rules give each parameter JAX's split, in the port's
    layout: a JAX leaf that varies along its split dim (and is constant
    where replicated), carried over by state_dict_from_jax_params, varies
    along the dim the port's rule splits."""
    cfg = jax_config_for_size("mini", max_len=T, num_layers=2,
                              num_experts=experts)
    params = jax.eval_shape(
        JaxWeatherBERT(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, T, 31)), jnp.zeros((1, 2)), jnp.zeros((1, T)),
        jnp.zeros((1, 1)), jnp.zeros((1, T, 31), bool))
    mesh = jax_make_mesh(4, 2)

    def encode(path, leaf):
        keys = tuple(getattr(k, "key", getattr(k, "idx", str(k)))
                     for k in path)
        spec = tuple(jax_rules(keys, leaf.shape, mesh))
        if "model" not in spec:
            return np.zeros(leaf.shape, np.float32)
        dim = spec.index("model")
        shape = [1] * leaf.ndim
        shape[dim] = leaf.shape[dim]
        return np.broadcast_to(np.arange(leaf.shape[dim], dtype=np.float32)
                               .reshape(shape), leaf.shape).copy()

    encoded = state_dict_from_jax_params(
        jax.tree_util.tree_map_with_path(encode, params))
    port_mesh = mesh_lib.Mesh(4, 2)
    split = 0
    for name, t in encoded.items():
        t = np.asarray(t)
        varies = tuple(d for d in range(t.ndim)
                       if t.shape[d] > 1 and np.ptp(t, axis=d).any())
        spec = mesh_lib.param_sharding_rules(name, t.shape, port_mesh)
        assert varies == tuple(d for d, a in enumerate(spec)
                               if a == "model"), name
        split += bool(spec)
    assert split > 0


@functools.cache
def _jax_shapes(size, experts):
    cfg = jax_config_for_size(size, max_len=T, num_layers=2,
                              num_experts=experts)
    return jax.eval_shape(
        JaxWeatherBERT(cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, T, 31)), jnp.zeros((1, 2)), jnp.zeros((1, T)),
        jnp.zeros((1, 1)), jnp.zeros((1, T, 31), bool))


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("model", [("mini", 0), ("mini", 4), ("small", 0)],
                         ids=["mini", "mini-moe", "small"])
def test_combined_sharding_rules_match_jax(model, mesh, fsdp):
    """`combined_sharding_rules` gives every parameter JAX's spec over both
    axes, in the port's layout (the transposed kernels, the fused in_proj
    against qkv_proj, JAX's tie on a square weight): for each axis, a JAX
    leaf that varies along that axis's dim, carried over by
    state_dict_from_jax_params, varies along the dim the port's spec gives
    that axis; on a mesh without 'model', `fsdp_sharding_rules` (what JAX's
    trainer applies for --fsdp alone) gives the same. WeatherBERT-small's
    dense weights are past FSDP_MIN_ELEMS (dense mini's are not) and its
    attention out-projection is square."""
    params = _jax_shapes(*model)
    jmesh = jax_make_mesh(*mesh, devices=jax.devices()[:mesh[0] * mesh[1]])
    port_mesh = mesh_lib.Mesh(*mesh)

    def encoded(axis):
        def encode(path, leaf):
            keys = tuple(getattr(k, "key", getattr(k, "idx", str(k)))
                         for k in path)
            spec = tuple(jax_combined_rules(keys, leaf.shape, jmesh,
                                            fsdp=fsdp))
            if axis not in spec:
                return np.zeros(leaf.shape, np.float32)
            dim = spec.index(axis)
            shape = [1] * leaf.ndim
            shape[dim] = leaf.shape[dim]
            return np.broadcast_to(np.arange(leaf.shape[dim],
                                             dtype=np.float32).reshape(shape),
                                   leaf.shape).copy()

        return state_dict_from_jax_params(
            jax.tree_util.tree_map_with_path(encode, params))

    split = set()
    for axis in ("model", "data"):
        for name, t in encoded(axis).items():
            t = np.asarray(t)
            varies = tuple(d for d in range(t.ndim)
                           if t.shape[d] > 1 and np.ptp(t, axis=d).any())
            spec = mesh_lib.combined_sharding_rules(name, t.shape, port_mesh,
                                                    fsdp=fsdp)
            assert varies == tuple(d for d, a in enumerate(spec)
                                   if a == axis), (axis, name)
            if fsdp and mesh[1] == 1:   # --fsdp alone: the pure FSDP rules
                assert mesh_lib.fsdp_sharding_rules(
                    name, t.shape, port_mesh) == spec, name
            if varies:
                split.add((axis, name))
    # dense mini has no parameter past FSDP_MIN_ELEMS
    assert bool(split) == (mesh[1] > 1 or (fsdp and model != ("mini", 0)))
