"""`wm-pretrain-torch` end to end on the CPU (`--device cpu`, mini): the
JAX `wm-pretrain`'s output_json keys, a best `.pth` that `wm-serve-torch`
serves, the unported flags, and the device rule of both entry points."""

import json

import numpy as np
import pytest
import torch

from weathermodel_tpu.cli import pretrain as jax_pretrain
from weathermodel_tpu_torch.cli import pretrain, serve
from weathermodel_tpu_torch.data.chunks import write_synthetic_dataset
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401

T = 24


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("store")
    write_synthetic_dataset(str(root), n_chunks=8, n_samples=24, seq_len=T,
                            seed=0)
    return str(root)


class _NoCheckpoints:
    """Stands in for the JAX trainer's orbax `Checkpointer` in the JAX runs
    whose record keys these tests read: the checkpoint files are not
    compared, and orbax's first save costs seconds."""

    def __init__(self, *args, **kwargs):
        pass

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def keys_only_jax_runs(monkeypatch):
    """The JAX trainer as these tests use it, for its record's keys: no
    orbax checkpoints, and its initial parameters drawn by a jitted init
    (one compile) in place of flax's op-by-op init (a compile an op, ~9 s
    in a fresh worker); the keys depend on neither."""
    import jax
    import jax.numpy as jnp

    from weathermodel_tpu.train import trainer as jax_trainer

    monkeypatch.setattr(jax_trainer, "Checkpointer", _NoCheckpoints)

    def jitted(self):   # PretrainTrainer._init_params, under jit
        cfg = self.model_cfg
        b, t = 2, cfg.max_len
        dummy = (jnp.zeros((b, t, cfg.weather_dim)), jnp.zeros((b, 2)),
                 jnp.full((b, t), 1990.0), jnp.full((b, 1), 7.0),
                 jnp.zeros((b, t, cfg.weather_dim), dtype=bool))
        self.rng, key = jax.random.split(self.rng)
        return jax.jit(self.model.init)(key, *dummy)

    monkeypatch.setattr(jax_trainer.PretrainTrainer, "_init_params", jitted)


@pytest.fixture
def no_jax_checkpoints(monkeypatch):
    keys_only_jax_runs(monkeypatch)


def _argv(store, workdir):
    return ["--model", "weatherbert", "--model-size", "mini",
            "--batch-size", "8", "--n-epochs", "2", "--n-warmup-epochs", "0",
            "--masking-prob", "0.15", "--data-dir", store,
            "--workdir", str(workdir), "--compute-dtype", "float32"]


def _keys(tree, prefix=""):
    """The key paths of a nested dict."""
    out = set()
    for k, v in tree.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
    return out


def test_pretrain_writes_the_jax_record_and_a_servable_checkpoint(
        store, tmp_path, no_jax_checkpoints):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    result = pretrain.run(pretrain.build_parser().parse_args(
        _argv(store, port_dir) + ["--grad-accum", "2", "--attention-impl",
                                  "fused_qkv", "--device", "cpu"]))
    jax_pretrain.run(jax_pretrain.build_parser().parse_args(
        _argv(store, jax_dir) + ["--attention-impl", "xla"]))
    with open(port_dir / "weatherbert_output.json") as f:
        port_record = json.load(f)
    with open(jax_dir / "weatherbert_output.json") as f:
        jax_record = json.load(f)
    assert _keys(port_record) == _keys(jax_record)
    losses = port_record["losses"]["train"]["total_loss"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert result["best_val_loss"] == min(
        port_record["losses"]["val"]["total_loss"])
    assert len(result["train_step_seconds"]) == 2

    # wm-serve-torch serves the best parameters unchanged
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "w.npz",
             weather=rng.normal(size=(5, T, 31)).astype(np.float32))
    served = serve.run(serve.build_parser().parse_args([
        "--checkpoint", str(port_dir / "best.pth"), "--model-size", "mini",
        "--input", str(tmp_path / "w.npz"), "--output",
        str(tmp_path / "o.npz"), "--batch-size", "8", "--compute-dtype",
        "float32", "--device", "cpu"]))
    assert served["n"] == 5
    with np.load(tmp_path / "o.npz") as z:
        assert z["output"].shape == (5, T, 31)
        assert np.isfinite(z["output"]).all()


def test_pretrained_state_initialises_the_trainer(tmp_path):
    from weathermodel_tpu_torch.train.trainer import PretrainTrainer
    from weathermodel_tpu_torch.utils.config import (
        TrainConfig,
        model_config_for_size,
    )

    cfg = model_config_for_size("mini", max_len=T)
    source = pretrain.make_model("weatherbert", cfg, "torch")
    source.reset_parameters(torch.Generator().manual_seed(9))
    torch.save(source.state_dict(), tmp_path / "init.pth")
    trainer = PretrainTrainer(
        pretrain.make_model("weatherbert", cfg, "torch"), "weatherbert", cfg,
        TrainConfig(), lambda *a: iter(()), workdir=str(tmp_path),
        device="cpu", pretrained_state=pretrain.load_pretrained_params(
            str(tmp_path / "init.pth")))
    for k, v in source.state_dict().items():
        assert torch.equal(trainer.model.state_dict()[k], v), k
    with pytest.raises(ValueError, match="lacks"):
        PretrainTrainer(
            pretrain.make_model("weatherbert", model_config_for_size(
                "small", max_len=T), "torch"), "weatherbert", cfg,
            TrainConfig(), lambda *a: iter(()), device="cpu",
            pretrained_state={})


@pytest.mark.parametrize("flag", [
    ["--remat", "--prng", "threefry2x32"],
    ["--seq-parallel", "2"], ["--pipeline-stages", "2"],
    ["--pipeline-microbatches", "8"],
    ["--fsdp", "--tensor-parallel", "2", "--pipeline-microbatches", "8"],
    ["--fsdp", "--prng", "threefry2x32"], ["--prng", "threefry2x32"]])
def test_unported_flags_exit_naming_the_roadmap(store, tmp_path, flag):
    """The flags whose feature is not ported exit naming their item, also
    beside the ported --remat and --fsdp."""
    args = pretrain.build_parser().parse_args(
        _argv(store, tmp_path) + ["--device", "cpu"] + flag)
    with pytest.raises(SystemExit, match="ROADMAP.md queue A item"):
        pretrain.run(args)


@pytest.mark.parametrize("dispatch", ["sort", "scatter"])
def test_tensor_parallel_with_a_capacity_dispatch_names_the_roadmap(
        store, tmp_path, dispatch):
    """--tensor-parallel splits the experts of the capacity dispatches too
    (their mesh runs: tests/test_torch_port_mesh.py): with sort or scatter
    it is no longer refused, and in one process it stops only at the JAX
    trainer's check of the world against the degree, as the ragged
    dispatch does."""
    args = pretrain.build_parser().parse_args(
        _argv(store, tmp_path) + ["--device", "cpu", "--moe-experts", "4",
                                  "--moe-dispatch", dispatch,
                                  "--tensor-parallel", "2"])
    with pytest.raises(ValueError,
                       match="1 devices not divisible by parallel degree 2"):
        pretrain.run(args)


@pytest.mark.parametrize("flags,experts", [
    (["--moe-dispatch", "sort", "--moe-capacity-factor", "0.5"], 4),
    (["--moe-dispatch", "scatter"], 4),
    (["--moe-dispatch", "sort", "--moe-remat"], 4),
    (["--moe-dispatch", "scatter", "--moe-remat"], 0)],
    ids=["sort", "scatter", "sort-remat", "no-experts"])
def test_moe_capacity_dispatch_and_remat_train(store, tmp_path, monkeypatch,
                                               flags, experts):
    """One mini epoch with each capacity layout and with --moe-remat: a
    finite loss and moe_aux, and the layout in the model; without
    experts the three flags are ignored (a dense model), as in
    wm-pretrain."""
    from weathermodel_tpu_torch.models.moe import MoEFFN

    built = []
    real = pretrain.make_model

    def spy(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    args = pretrain.build_parser().parse_args(
        _argv(store, tmp_path) + ["--n-epochs", "1", "--device", "cpu",
                                  "--moe-experts", str(experts)] + flags)
    monkeypatch.setattr(pretrain, "make_model", spy)
    result = pretrain.run(args)
    with open(tmp_path / "weatherbert_output.json") as f:
        losses = json.load(f)["losses"]["train"]
    assert np.isfinite(losses["total_loss"]).all()
    moes = [m for m in built[0].modules() if isinstance(m, MoEFFN)]
    assert len(moes) == (2 if experts else 0)
    assert ("moe_aux" in losses) == bool(experts)
    for m in moes:
        assert (m.dispatch, m.remat, m.capacity_factor) == (
            args.moe_dispatch, args.moe_remat, args.moe_capacity_factor)
    assert np.isfinite(result["best_val_loss"])


def test_resume_from_checkpoint_continues_from_the_workdir(store, tmp_path,
                                                          caplog):
    """`wm-pretrain-torch` with its defaults (WeatherFormer-small, ELBO, bf16,
    attention auto -> the flash kernels' plain versions here), stopped by a
    real SIGTERM while step 3 of epoch 1 runs, then run again with
    `--resume-from-checkpoint`: as in `wm-pretrain`, any value turns resume
    on and the run resumes from --workdir (a warning names the difference).
    The resumed run ends bitwise equal to an uninterrupted one: every loss
    of the record, best.pth, and the last checkpoint's parameters and Adam
    state."""
    from weathermodel_tpu_torch.testing import sigterm_during_step

    def run(workdir, *extra):
        return pretrain.run(pretrain.build_parser().parse_args([
            "--batch-size", "8", "--n-epochs", "3", "--n-warmup-epochs",
            "0", "--data-dir", store, "--workdir", str(workdir),
            "--device", "cpu", *extra]))

    assert "preempted" not in run(tmp_path / "base")
    with sigterm_during_step(epoch=1, step=3):
        assert run(tmp_path / "pre")["preempted"] is True
    with open(tmp_path / "pre" / "checkpoints" / "1" / "meta.json") as f:
        assert json.load(f)["mid_epoch"]["batch_idx"] == 3
    with caplog.at_level("WARNING"):
        result = run(tmp_path / "pre", "--resume-from-checkpoint",
                     str(tmp_path / "elsewhere"))
    assert "resumes from --workdir" in caplog.text
    assert "preempted" not in result and len(result["val_batches"]) == 2

    def load(workdir, name):
        if name.endswith(".json"):
            with open(workdir / name) as f:
                return json.load(f)
        return torch.load(workdir / name, weights_only=True)

    base, res = tmp_path / "base", tmp_path / "pre"
    assert (load(base, "weatherformer_output.json")["losses"]
            == load(res, "weatherformer_output.json")["losses"])
    for a, b in ((load(base, "best.pth"), load(res, "best.pth")),
                 (load(base, "checkpoints/2/state.pt")["model"],
                  load(res, "checkpoints/2/state.pt")["model"])):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    want = load(base, "checkpoints/2/state.pt")["optimizer"]["state"]
    got = load(res, "checkpoints/2/state.pt")["optimizer"]["state"]
    assert want.keys() == got.keys()
    for i in want:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(want[i][k], got[i][k]), (i, k)


def test_use_optimal_lr_runs_the_range_test_and_records_its_lr(
        store, tmp_path, monkeypatch):
    """--use-optimal-lr runs the LR range test on a throwaway copy (5 steps
    under DRY_RUN), records the LR in output_json's model_config, as
    `wm-pretrain` does, and the epochs train at the schedule from it."""
    from weathermodel_tpu_torch.train import lr_finder
    from weathermodel_tpu_torch.train.trainer import PretrainTrainer
    from weathermodel_tpu_torch.utils import constants

    monkeypatch.setattr(constants, "DRY_RUN", True)
    found = []
    real = lr_finder.find_optimal_lr

    def spy(run_step, batches, **kw):
        out = real(run_step, batches, **kw)
        found.append((out, kw["num_iter"]))
        return out

    monkeypatch.setattr(lr_finder, "find_optimal_lr", spy)
    seen = []
    real_epoch = PretrainTrainer._run_epoch

    def run_epoch(self, epoch, split, mid=None):
        seen.append(self.lr_schedule(epoch))
        return real_epoch(self, epoch, split, mid)

    monkeypatch.setattr(PretrainTrainer, "_run_epoch", run_epoch)
    pretrain.run(pretrain.build_parser().parse_args(
        _argv(store, tmp_path) + ["--device", "cpu", "--use-optimal-lr",
                                  "--n-epochs", "1"]))
    ((optimal, lrs, losses), num_iter), = found
    assert num_iter == 5 and len(lrs) == len(losses) <= 5
    with open(tmp_path / "weatherbert_output.json") as f:
        record = json.load(f)
    assert record["model_config"]["optimal_lr"] == optimal
    assert record["model_config"]["init_lr"] == 5e-4
    # warmup 0, so epoch 0 trains at the found LR itself
    assert seen == [optimal, optimal]


def test_unported_models_and_sizes_raise(store, tmp_path):
    """Every model of `wm-pretrain` is ported (weathercnn in
    test_torch_port_cnn.py); an unknown model and size raise as in JAX."""
    args = pretrain.build_parser().parse_args(
        _argv(store, tmp_path) + ["--device", "cpu", "--model", "nope"])
    with pytest.raises(ValueError, match="Unknown model type"):
        pretrain.run(args)
    args = pretrain.build_parser().parse_args(
        _argv(store, tmp_path) + ["--device", "cpu", "--model-size", "huge"])
    with pytest.raises(ValueError, match="Unknown model size"):
        pretrain.run(args)


def test_defaults_train_weatherformer_small_with_the_elbo(
        store, tmp_path, no_jax_checkpoints):
    """With no --model/--model-size `wm-pretrain-torch` trains what
    `wm-pretrain` does (WeatherFormer-small, ELBO, beta 0.5, 10 masked
    features, attention "auto" -> the flash kernels' plain versions here),
    and its record has the JAX record's keys, the ELBO's parts included."""
    from weathermodel_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    argv = ["--batch-size", "8", "--n-epochs", "1", "--n-warmup-epochs",
            "0", "--data-dir", store, "--compute-dtype", "float32"]
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    result = pretrain.run(pretrain.build_parser().parse_args(
        argv + ["--workdir", str(tmp_path / "port"), "--device", "cpu"]))
    # on CPU tensors the wrappers run the plain versions: no launch
    assert (flash_attention_fwd.launches,
            flash_attention_bwd.launches) == before
    jax_pretrain.run(jax_pretrain.build_parser().parse_args(
        argv + ["--workdir", str(tmp_path / "jax"), "--model-size", "mini",
                "--attention-impl", "xla"]))
    with open(tmp_path / "port" / "weatherformer_output.json") as f:
        record = json.load(f)
    with open(tmp_path / "jax" / "weatherformer_output.json") as f:
        jax_record = json.load(f)
    assert _keys(record) == _keys(jax_record)
    assert record["model_config"]["hidden_dim"] == 200
    assert record["model_config"]["beta"] == 0.5
    for scope in ("train", "val"):
        losses = record["losses"][scope]
        assert set(losses) == {"total_loss", "reconstruction", "kl_term",
                               "mae"}
        np.testing.assert_allclose(
            losses["total_loss"], np.add(losses["reconstruction"],
                                         losses["kl_term"]), rtol=1e-5)
    assert result["best_val_loss"] == record["losses"]["val"]["total_loss"][0]


@pytest.mark.parametrize("model,key,prior,k", [
    ("weatherformersinusoid", "weatherformer_sinusoid", "frequency", 4),
    ("weatherformermixture", "weatherformer_mixture", "mixture_logits", 7)])
def test_prior_models_take_the_jax_k_rule(store, tmp_path, monkeypatch, model,
                                          key, prior, k):
    """--n-mixture-components 1 gives the model's own k, as `wm-pretrain`
    does (weathermodel_tpu/cli/pretrain.py:194-198), and the trainer (its
    objective and its record's name) gets the JAX trainer's key. The run
    stops where training would start: the epochs are the defaults test's."""
    from weathermodel_tpu_torch.train.trainer import PretrainTrainer

    monkeypatch.setattr(PretrainTrainer, "train", lambda self: self)
    trainer = pretrain.run(pretrain.build_parser().parse_args([
        "--model", model, "--model-size", "mini", "--n-mixture-components",
        "1", "--data-dir", store, "--workdir", str(tmp_path), "--device",
        "cpu"]))
    assert trainer.model_name == key == jax_pretrain.TRAINER_KEY[model]
    assert trainer.output_json["model_config"]["model"] == key
    assert getattr(trainer.model, prior).shape[1] == k


def test_entry_points_need_a_card_unless_asked_for_the_cpu(store, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a CUDA device")
    with pytest.raises(SystemExit, match="--device cpu"):
        pretrain.run(pretrain.build_parser().parse_args(
            _argv(store, tmp_path) + ["--attention-impl", "fused_qkv"]))
    with pytest.raises(SystemExit, match="--device cpu"):
        serve.run(serve.build_parser().parse_args([
            "--checkpoint", "m.pth", "--input", "w.npz", "--output",
            str(tmp_path / "o.npz")]))
