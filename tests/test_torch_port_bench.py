"""The port's bench (`python -m weathermodel_tpu_torch.bench`) on the CPU:
one parseable JSON line with the keys of the JAX package's bench.py for
each FFN impl and for the ELBO objective, its analytic FLOP count equal to
bench.py's, its grad-accum rule, and its refusals of what is not ported."""

import json

import pytest
import torch

import bench as jax_bench
from weathermodel_tpu.utils.config import (
    model_config_for_size as jax_config_for_size,
)
from weathermodel_tpu_torch import bench
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.utils.config import model_config_for_size

# the keys of bench.py's JSON line (bench.py:249-271)
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "tflops", "mfu",
            "flops_per_sample", "mfu_note", "effective_batch", "grad_accum",
            "microbatch", "regime", "baseline_note"}
MINI = {"BENCH_MODEL_SIZE": "mini", "BENCH_BATCH_PER_CHIP": "2",
        "BENCH_STEPS": "1"}


@pytest.mark.parametrize("env", [
    {"BENCH_FFN_IMPL": "torch"},
    {"BENCH_FFN_IMPL": "fused_ffn_ln", "BENCH_GRAD_ACCUM": "2"},
    {"BENCH_FFN_IMPL": "fused_ffn", "BENCH_MODE": "eval"},
    {"BENCH_OBJECTIVE": "elbo", "BENCH_FFN_IMPL": "fused_ffn"},
], ids=["torch", "fused_ffn_ln-accum2", "fused_ffn-eval", "elbo"])
def test_run_prints_one_json_line(env, capsys):
    record = bench.run({**MINI, **env}, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == record
    assert JAX_KEYS <= set(record)
    impl = env["BENCH_FFN_IMPL"]
    assert record["ffn_impl"] == impl and record["device"] == "cpu"
    kind = "eval" if env.get("BENCH_MODE") == "eval" else "pretrain"
    name = "weatherformer" if "BENCH_OBJECTIVE" in env else "weatherbert"
    tag = name if impl == "torch" else f"{name}_{impl}"
    assert record["metric"] == \
        f"{kind}_samples_per_sec_per_gpu_torch_{tag}_mini"
    assert "_per_chip_" not in record["metric"]  # never the JAX bench's name
    assert record["vs_baseline"] is None and record["mfu"] is None  # no card
    accum = int(env.get("BENCH_GRAD_ACCUM", 1))
    assert (record["effective_batch"], record["grad_accum"],
            record["microbatch"]) == (2, accum, 2 // accum)
    assert record["value"] > 0 and record["loss"] == record["loss"]  # finite


@pytest.mark.parametrize("size", ["mini", "large"])
@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("experts", [0, 8])
def test_flop_count_is_bench_py_s(size, mode, experts):
    got = bench.analytic_flops_per_sample(
        model_config_for_size(size, num_experts=experts), mode)
    want = jax_bench.analytic_flops_per_sample(
        jax_config_for_size(size, num_experts=experts), mode)
    assert got == want


def test_grad_accum_rule_is_bench_py_s():
    rule = bench.default_grad_accum
    assert rule({}, "large", 0) == 2
    assert rule({"BENCH_BATCH_PER_CHIP": "288"}, "large", 0) == 1
    assert rule({}, "large", 8) == 1
    assert rule({}, "small", 0) == 1
    assert rule({"BENCH_GRAD_ACCUM": "3"}, "large", 8) == 3


@pytest.mark.parametrize("name,value", [
    ("BENCH_FFN_IMPL", "int8"), ("BENCH_FFN_IMPL", "int8_static"),
    ("BENCH_ATTENTION", "pallas_qkv_op"), ("BENCH_MOE_DISPATCH", "sort"),
    ("BENCH_MOE_DISPATCH", "scatter"), ("BENCH_MOE_REMAT", "1")])
def test_unported_values_raise(name, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bench.run({**MINI, name: value}, device="cpu")


def test_command_line_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        bench.main()
    with pytest.raises(ValueError, match="BENCH_FFN_IMPL"):
        bench.run({**MINI, "BENCH_FFN_IMPL": "xla"}, device="cpu")
