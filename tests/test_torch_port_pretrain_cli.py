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

T = 24


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = tmp_path_factory.mktemp("store")
    write_synthetic_dataset(str(root), n_chunks=8, n_samples=24, seq_len=T,
                            seed=0)
    return str(root)


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


def test_pretrain_writes_the_jax_record_and_a_servable_checkpoint(store,
                                                                  tmp_path):
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
    ["--resume-from-checkpoint", "x"], ["--use-optimal-lr"], ["--remat"],
    ["--seq-parallel", "2"], ["--pipeline-stages", "2"],
    ["--pipeline-microbatches", "8"], ["--tensor-parallel", "2"],
    ["--moe-experts", "4"], ["--moe-top-k", "1"], ["--moe-dispatch", "sort"],
    ["--moe-capacity-factor", "2"], ["--moe-remat"], ["--fsdp"],
    ["--prng", "threefry2x32"], ["--n-mixture-components", "3"],
    ["--beta", "1.0"]])
def test_unported_flags_exit_naming_the_roadmap(store, tmp_path, flag):
    args = pretrain.build_parser().parse_args(
        _argv(store, tmp_path) + ["--device", "cpu"] + flag)
    with pytest.raises(SystemExit, match="ROADMAP.md queue A item"):
        pretrain.run(args)


def test_unported_models_and_sizes_raise(store, tmp_path):
    args = pretrain.build_parser().parse_args(
        _argv(store, tmp_path) + ["--device", "cpu", "--model",
                                  "weatherformer"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pretrain.run(args)
    # mini training under "auto" needs kernel B3, not ported yet
    args = pretrain.build_parser().parse_args(
        _argv(store, tmp_path) + ["--device", "cpu"])
    with pytest.raises(NotImplementedError, match="B3"):
        pretrain.run(args)


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
