"""Benchmark: pretraining train-step throughput of the port on one GPU
(port of the repo's root `bench.py`, which times the JAX package on a TPU).

    python -m weathermodel_tpu_torch.bench
    BENCH_FFN_IMPL=fused_ffn_ln python -m weathermodel_tpu_torch.bench

Times the whole train step (mask drawn on the device, forward, loss,
backward, Adam update) of WeatherBERT-large by default, bf16 compute with
fp32 params, on the same random batch from numpy seed 0: 3 warm-up steps,
then BENCH_STEPS timed steps, each ending in a read of the loss. Prints ONE
JSON line with the keys of bench.py:
  {"metric": ..., "value": N, "unit": "samples/sec/gpu", "vs_baseline": null,
   "tflops": ..., "mfu": ..., ...}
The metric name carries `_per_gpu_torch_`, so it is never read as the JAX
bench's. `mfu` is the analytic matmul TFLOP/s (bench.py:35-54, restated
here) over the H100's dense bf16 peak of 989 TFLOP/s. There is no estimated
PyTorch denominator: `vs_baseline` is null.

The variables are bench.py's, with the port's impl names:
  BENCH_MODEL_SIZE      mini/small/medium/large (default large)
  BENCH_BATCH_PER_CHIP  the batch (default by size, bench.py's table)
  BENCH_GRAD_ACCUM      microbatches per update (default 2 at large when
                        neither the batch nor MoE is set, else 1)
  BENCH_STEPS           timed steps (default 20)
  BENCH_ATTENTION       auto/fused_qkv/flash/torch (JAX auto/pallas_qkv/
                        pallas/xla); pallas_qkv_op is not ported
  BENCH_OBJECTIVE       masked_mse (WeatherBERT) or elbo (WeatherFormer)
  BENCH_MODE            train or eval (the forward only, no grad)
  BENCH_DROPOUT_RATE    overrides the model's dropout rate
  BENCH_MOE_EXPERTS     > 0: the dropless MoE FFN (ragged dispatch)
  BENCH_MOE_TOP_K       experts per token (default 2)
  BENCH_FFN_IMPL        torch/fused_ffn_ln/fused_ffn (JAX xla/pallas/
                        pallas2); int8 and int8_static are not ported
BENCH_MOE_DISPATCH sort/scatter and BENCH_MOE_REMAT=1 are not ported either;
each unported value raises naming its ROADMAP.md item. BENCH_MOE_CF sizes
only those capacity dispatches and is not read. BENCH_PRNG and
BENCH_COMPILE_CACHE are JAX-only (its PRNG and its compile cache) and are
not read. The command line always runs on the card and raises without one;
`run(env, device="cpu")` runs the kernels' plain versions on the CPU (the
tests use it).
"""

import json
import sys
import time

import numpy as np
import torch

from weathermodel_tpu_torch.cli.pretrain import make_model
from weathermodel_tpu_torch.models.blocks import FFN_IMPLS
from weathermodel_tpu_torch.ops.attention import resolve_attention_impl
from weathermodel_tpu_torch.train.state import make_optimizer
from weathermodel_tpu_torch.train.steps import (
    Batch,
    batch_to_device,
    make_eval_step,
    make_train_step,
)
from weathermodel_tpu_torch.utils.config import model_config_for_size

# NVIDIA H100 SXM, dense bf16 tensor-core peak (data sheet), TFLOP/s
H100_BF16_PEAK_TFLOPS = 989.0
# bench.py:90-91
DEFAULT_BATCH = {"mini": 1024, "small": 512, "medium": 384, "large": 576}
DEFAULT_ACCUM = {"large": 2}
# values of bench.py's variables the port does not have yet
_UNPORTED = {
    ("BENCH_ATTENTION", "pallas_qkv_op"):
        "the fused attention + out-projection kernel B5 (ROADMAP.md queue B)",
    ("BENCH_FFN_IMPL", "int8"): "int8 serving (ROADMAP.md queue A item 13)",
    ("BENCH_FFN_IMPL", "int8_static"):
        "int8 serving (ROADMAP.md queue A item 13)",
    ("BENCH_MOE_DISPATCH", "sort"):
        "the MoE capacity dispatches (ROADMAP.md queue A item 12)",
    ("BENCH_MOE_DISPATCH", "scatter"):
        "the MoE capacity dispatches (ROADMAP.md queue A item 12)",
}


def analytic_flops_per_sample(cfg, mode: str, out_dim=None) -> float:
    """Matmul FLOPs per sample of the encoder stack (bench.py:35-54): per
    layer qkv 3Th^2, scores and AV 2T^2h, out projection Th^2, FFN 8Th^2
    MACs (k expert FFNs and the router per token for a MoE), plus in_proj
    and the output head (`out_dim`, default cfg.output_dim); train = 3x the
    forward. Elementwise work excluded, the MFU convention."""
    t, h, n_layers = cfg.max_len, cfg.hidden_dim, cfg.num_layers
    ffn_macs = 8 * t * h * h
    if cfg.num_experts > 0:
        ffn_macs = cfg.moe_top_k * 8 * t * h * h + t * h * cfg.num_experts
    macs = n_layers * (4 * t * h * h + ffn_macs + 2 * t * t * h)
    macs += cfg.input_dim * t * h + t * h * (out_dim or cfg.output_dim)
    fwd_flops = 2.0 * macs
    return fwd_flops if mode == "eval" else 3.0 * fwd_flops


def _check_ported(env) -> None:
    for (name, value), what in _UNPORTED.items():
        if env.get(name) == value:
            raise NotImplementedError(f"{name}={value}: {what} is not ported "
                                      "to weathermodel_tpu_torch yet")
    if env.get("BENCH_MOE_REMAT", "0") != "0":
        raise NotImplementedError("BENCH_MOE_REMAT: MoE rematerialization "
                                  "(ROADMAP.md queue A item 12) is not "
                                  "ported to weathermodel_tpu_torch yet")


def default_grad_accum(env, size: str, moe_experts: int) -> int:
    """BENCH_GRAD_ACCUM, else bench.py's rule: 2 at large when neither the
    batch nor the MoE variant is set (the effective 576 as 2 x 288), else
    1."""
    if "BENCH_GRAD_ACCUM" in env:
        return int(env["BENCH_GRAD_ACCUM"])
    if "BENCH_BATCH_PER_CHIP" in env or moe_experts > 0:
        return 1
    return DEFAULT_ACCUM.get(size, 1)


def run(env, device: str = "cuda") -> dict:
    """Run the bench configured by the mapping `env` (BENCH_* variables) on
    `device`; returns the JSON record (also printed as one line)."""
    _check_ported(env)
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("weathermodel_tpu_torch.bench needs a CUDA device")
    size = env.get("BENCH_MODEL_SIZE", "large")
    batch_size = int(env.get("BENCH_BATCH_PER_CHIP",
                             DEFAULT_BATCH.get(size, 512)))
    n_steps = int(env.get("BENCH_STEPS", "20"))
    objective = env.get("BENCH_OBJECTIVE", "masked_mse")
    mode = env.get("BENCH_MODE", "train")
    if objective not in ("masked_mse", "elbo") or mode not in ("train",
                                                               "eval"):
        raise ValueError(f"BENCH_OBJECTIVE={objective!r} / BENCH_MODE="
                         f"{mode!r}: masked_mse or elbo / train or eval")
    attention_impl = resolve_attention_impl(env.get("BENCH_ATTENTION",
                                                    "auto"), size, mode)
    ffn_impl = env.get("BENCH_FFN_IMPL", "torch")
    if ffn_impl not in FFN_IMPLS:
        raise ValueError(f"BENCH_FFN_IMPL={ffn_impl!r}: one of {FFN_IMPLS}")
    moe_experts = int(env.get("BENCH_MOE_EXPERTS", "0"))
    overrides = {}
    if "BENCH_DROPOUT_RATE" in env:
        overrides["dropout_rate"] = float(env["BENCH_DROPOUT_RATE"])
    cfg = model_config_for_size(
        size, compute_dtype="bfloat16", num_experts=moe_experts,
        moe_top_k=int(env.get("BENCH_MOE_TOP_K", "2")), **overrides)
    name = "weatherformer" if objective == "elbo" else "weatherbert"
    model = make_model(name, cfg, attention_impl, ffn_impl)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(device)
    masking = "weatherformer" if objective == "elbo" else "weatherbert"
    t, f = cfg.max_len, cfg.weather_dim
    rng = np.random.default_rng(0)
    batch = batch_to_device(Batch(
        weather=rng.normal(size=(batch_size, t, f)).astype(np.float32),
        coords=rng.uniform(-90, 90, size=(batch_size, 2)).astype(np.float32),
        year=np.full((batch_size, t), 1990.0, dtype=np.float32),
        interval=np.full((batch_size, 1), 7.0, dtype=np.float32)), device)
    generator = torch.Generator().manual_seed(1)
    n_masked = 10 if objective == "elbo" else 1
    if mode == "eval":
        grad_accum = 1
        eval_fn = make_eval_step(model, masking, objective=objective)

        def step():
            return eval_fn(batch, generator, n_masked)
    else:
        grad_accum = default_grad_accum(env, size, moe_experts)
        train_fn = make_train_step(model, make_optimizer(model), masking,
                                   grad_accum=grad_accum, objective=objective)

        def step():
            return train_fn(batch, generator, 5e-4, n_masked)

    for _ in range(3):  # warm-up: lazy CUDA module loads, kernel build
        loss = float(step()["total_loss"])
    t0 = time.perf_counter()
    for _ in range(n_steps):
        loss = float(step()["total_loss"])
    dt = time.perf_counter() - t0

    samples_per_sec = batch_size * n_steps / dt
    model_tag = name if ffn_impl == "torch" else f"{name}_{ffn_impl}"
    if moe_experts > 0:
        model_tag += f"_moe{moe_experts}"
    on_gpu = device != "cpu"
    kind = torch.cuda.get_device_name(0) if on_gpu else "cpu"
    print(f"[bench] {model_tag}-{size} B={batch_size} T={t} device={kind} "
          f"attention={attention_impl} ffn={ffn_impl} mode={mode} "
          f"grad_accum={grad_accum} steps={n_steps} wall={dt:.3f}s "
          f"loss={loss:.4f}", file=sys.stderr)
    flops_per_sample = analytic_flops_per_sample(cfg, mode)
    tflops = samples_per_sec * flops_per_sample / 1e12
    metric_kind = "eval" if mode == "eval" else "pretrain"
    record = {
        "metric": f"{metric_kind}_samples_per_sec_per_gpu_torch_{model_tag}_"
                  f"{size}",
        "value": round(samples_per_sec, 2),
        "unit": "samples/sec/gpu",
        "vs_baseline": None,
        "tflops": round(tflops, 2),
        # a peak is the card's: no MFU for a run on the CPU
        "mfu": round(tflops / H100_BF16_PEAK_TFLOPS, 4) if on_gpu else None,
        "flops_per_sample": flops_per_sample,
        "mfu_note": f"achieved dense TFLOP/s vs {H100_BF16_PEAK_TFLOPS:g} "
                    "TF/s H100 bf16 peak; analytic matmul FLOPs, no padding "
                    "counted",
        "effective_batch": batch_size,
        "grad_accum": grad_accum,
        "microbatch": batch_size // grad_accum,
        "regime": f"effective batch {batch_size} = {grad_accum} x "
                  f"{batch_size // grad_accum}-sample microbatches, T={t}, "
                  f"{mode}, bf16 compute",
        "baseline_note": "no PyTorch-estimate denominator",
        "device": kind,
        "attention_impl": attention_impl,
        "ffn_impl": ffn_impl,
        "loss": loss,
    }
    print(json.dumps(record), flush=True)
    return record


def main():
    import os

    run(os.environ, device="cuda")


if __name__ == "__main__":
    sys.exit(main())
