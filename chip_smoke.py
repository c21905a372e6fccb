"""Drive the PyTorch/CUDA port (weathermodel_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero:
  1. device  - requires CUDA; prints the card and its power limit
  2. build   - compiles csrc/*.cu with nvcc for sm_90a; build time and the
               ptxas report (registers, spills)
  3. kernel  - the fused QKV attention kernel vs its plain PyTorch version at
               WeatherBERT-large's serving shapes (B=256, T=365, H=576, 16
               heads) in fp32 and bf16, with CUDA-event times of both
  4. kernel_outproj - the fused QKV attention + out-projection kernel B5 vs
               its plain version at the same shapes in fp32 and bf16, and with
               dropout 0.1 at B=32 (the same seed on both sides); CUDA-event
               times of the kernel, the plain version, the library call
               (F.linear + scaled_dot_product_attention + F.linear) and B1's
               eval form + F.linear
  5. serve   - a seeded WeatherBERT-large saved as a reference .pth and 300
               seeded windows served through the `wm-serve-torch` entry point
               in bf16 (a 256 chunk + 44 rows padded to the 128 bucket), with
               --attention-impl auto (B1 eval must launch 16 times: 8 layers x
               2 chunks) and fused_qkv_op (B5 16 times, B1 none); both agree
               with the plain attention path, in bf16 and in fp32
  6. serve_daemon - `python -m weathermodel_tpu_torch.cli.serve --daemon` as
               a process serving the same .pth through B5 (fused_qkv_op,
               --batch-size 256, --allow-reload): 8 client threads x 4
               requests x 32 windows, each answer held against the offline
               predictor's for the same windows; /stats must show 1024 rows
               coalesced into batches of more than 32 (p50/p95/p99 latency and
               windows/s printed); POST /reload of a second checkpoint, after
               which an answer matches the new weights; SIGTERM, after which
               the process must exit 0
  7. kernel_train - the fused QKV attention kernel's training form (B1
               train) and its backward kernel (B2) vs their plain versions at
               the training microbatch (B=288, T=365, H=576, 16 heads) in fp32
               and bf16, dropout 0.1 (the same seed on both sides) and 0; CUDA-
               event times of the kernel, the plain version and the library
               call (F.linear + scaled_dot_product_attention, forward; forward
               and backward for B2), naming the SDPA backend
  8. train   - a seeded synthetic chunk store written by the port's writer;
               `wm-pretrain-torch`'s run(args) trains WeatherBERT-large in
               bf16, --batch-size 576 --grad-accum 2, dropout 0.1, 2 epochs:
               16 launches of each training kernel per step and 8 of the eval
               form per validation batch, finite losses that fall; ms per
               step, samples/s, TFLOP/s and peak memory; a torch.profiler
               capture of one step; one step of the kernel path against the
               plain attention path at 16 windows, dropout off, fp32 and bf16
  9. kernel_flash - the attention kernels on separate q, k, v, B3f and its
               backward B3b, vs their plain versions at WeatherFormer-small's
               batch (B=256, T=365, H=200, 10 heads), on the column slices of
               a packed projection as the model passes them, fp32 and bf16,
               dropout 0.1 (the same seed on both sides) and 0; CUDA-event
               times of the kernel, the plain version and SDPA (forward;
               forward and backward for B3b)
  10. train_former - `wm-pretrain-torch`'s run(args) with the JAX CLI's
               defaults (WeatherFormer-small, ELBO, beta 0.5, 10 masked
               features, --attention-impl auto) in bf16 at --batch-size 256,
               2 epochs, on the same synthetic store: 4 launches of B3f per
               training step and per validation batch, 4 of B3b per step,
               none of B1/B2; finite losses, the train loss falls; the same
               timings, profile and one-step comparison as phase 8
  11. kernel_gmm - the grouped matmul B4 (forward, and with rhs^T as the
               backward's d_lhs) and its weight gradient B4t vs their plain
               versions at the MoE microbatch's shapes (S = 96 x 365 x 2 =
               70080 routed rows, E=8, K x N = 576 x 2304 and 2304 x 576),
               with the group sizes of a top-2 routing of seeded activations
               through a seeded router, in bf16 and fp32; then the edge cases
               (empty first/middle/last groups, boundaries inside a tile, S
               not a multiple of 128, tiny groups sharing a tile); CUDA-event
               times of the kernel, the plain version and the library
               yardstick (torch._grouped_mm where it takes the inputs, else
               one cuBLAS matmul per group)
  12. train_moe - `wm-pretrain-torch`'s run(args) for the flagship MoE
               configuration: WeatherBERT-large, --moe-experts 8 --moe-top-k 2
               (ragged dispatch), bf16, --batch-size 288 --grad-accum 3,
               dropout 0.1, 2 epochs, on the same store: per step 96 launches
               of B4, 48 of B4t, 24 of B1 train and 24 of B2; per validation
               batch 16 of B4 and 8 of B1 eval; finite losses and moe_aux, the
               train loss falls; the same timings (TFLOP/s from the MoE
               analytic count), profile and one-step comparison with the plain
               path (plain grouped matmuls, plain attention) as phase 8
  13. kernel_ffn - the fused FFN + residual + LayerNorm B6f, its backward
               B6b and the fused FFN B7 (with and without its hidden output)
               vs their plain versions at the bench microbatch's shapes (M =
               288 x 365 = 105120 rows, H=576, F=2304) in bf16 and fp32,
               dropout 0.1 (the same seeds on both sides) and 0, then at the
               edge shapes H=200/F=800 and H=48/F=192 with M not a multiple
               of the 32-row block; CUDA-event times of the kernel, the plain
               version and the yardstick (the port's "torch" FFN: F.linear,
               ReLU, F.linear, and for B6 the residual and F.layer_norm; its
               autograd backward for B6b)
  14. kernel_maskgen - the keep-mask family at the FFN hidden site of the
               bench microbatch (M = 105120 rows, C = 2304, rate 0.1): B8
               (forward and backward) and B8m launched through their public
               functions `kernel_dropout` and `random_keep_mask` with the
               counts at 0 (they have no other path), then B9b, B9p, B8m and
               B8 (bf16 and fp32) held bitwise against their plain versions
               (B9p unpacked against B9b, B8 and its gradient against B8m's
               mask x the dtype-rounded scale x x or dy), keep rates within
               1e-3 of 0.9; CUDA-event times of the kernel, the plain version
               and the library call (bernoulli_ for the bool masks,
               F.dropout for B8, none for B9p) and both bounds (bytes, the
               hash's integer operations)
  15. bench - `python -m weathermodel_tpu_torch.bench`'s run(env) at
               WeatherBERT-large, 2 x 288, bf16, dropout 0.1, for
               BENCH_FFN_IMPL torch, fused_ffn_ln and fused_ffn (each JSON
               line printed): per step 16 launches of B1 train and B2 in all
               three, of B6f and B6b with fused_ffn_ln, of B7 with fused_ffn;
               the torch FFN again under the dropout impls maskgen and
               maskgen_bool (ops.dropout.set_impl, as the JAX ablation
               scripts select them): 16 launches per step of B9p or B9b at
               the FFN hidden sites, none of the other kernels of the family
               (the sites with C = 576 take "auto"), and a torch.profiler
               step of maskgen_bool with B9b's and torch.rand's device time;
               BENCH_MODE=eval runs of the two fused impls (8 launches of B6f
               or B7, without its hidden output, per batch) and a
               BENCH_ATTENTION=fused_qkv_op eval run at batch 576 (8 launches
               of B5 per batch, none of B1); finite losses; a
               torch.profiler step of each fused impl; one step of each fused
               path against the plain path (plain attention and FFN) at 16
               windows, dropout off, fp32 and bf16
The seconds each phase took are printed after the phases; the card's name
and power limit are printed by phase 1 and again before the kernels' JSON
record; the last line is {"ok": true, "device": {...}}.
"""

import io
import json
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
N_WINDOWS, SEQ_LEN, N_FEATURES = 300, 365, 31
BATCH = 256
MODEL_SIZE = "large"
# kernel vs plain, same inputs: only the fp32 summation order differs; in
# bf16 that can flip a rounding of q/k/v or of a softmax weight (one bf16
# ulp is 2^-8 relative), hence the wider bf16 bound on O(1) outputs.
KERNEL_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-3),
              torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# and against each output's own scale: max|kernel - plain| <= SCALE_TOL x
# max|plain|. The kernel phases' outputs are far below 1 (a near-uniform
# softmax over 365 keys: |o| ~ 0.04 and |dq|, |dk| ~ 0.015 in kernel_flash),
# where KERNEL_TOL's atol alone would pass a kernel that scaled a gradient
# by 0.8. A flipped bf16 rounding moves an output by one ulp, at most 2^-7 of
# its value; fp32 sums in another order only (about 1e-6 of the largest).
SCALE_TOL = {torch.float32: 2.0 ** -16, torch.bfloat16: 2.0 ** -6}
# served output, kernel path vs plain attention path, as (max|diff|, RMS of
# diff) over the RMS of the plain path's output. In bf16 the two paths round
# the QKV projection at different points (the kernel once after an fp32
# sum plus bias, the plain path as F.linear does), as the JAX package's
# pallas_qkv and xla paths do, and that propagates through 8 layers: on the
# CPU at 10 windows the two differ by 0.039 (max) and 0.0068 (RMS).
SERVE_TOL = {"bfloat16": (0.15, 2e-2), "float32": (1e-4, 1e-5)}
# training: the effective batch as 2 microbatches of 288 (the north-star
# configuration of bench.py:90-91), the reference's dropout rate
TRAIN_BATCH, GRAD_ACCUM, DROPOUT = 576, 2, 0.1
MICRO = TRAIN_BATCH // GRAD_ACCUM
# one step, kernel path vs plain attention path, same weights, batch and
# mask, dropout off: fp32 sums in another order only, so the loss agrees to
# 1e-5 relative and each parameter's gradient to 1e-3 in the L2 norm. Not
# entrywise: the key bias's gradient is zero in exact arithmetic (softmax
# ignores a per-row shift), so its entries are rounding noise. The first
# layers' weight gradients sum, over 16 x 365 rows, a gradient that came
# back through 8 layers: the plain path alone, on the card and on the CPU,
# differs by about 1e-4 there (printed beside the result). bf16 rounds the
# QKV projection at other points on the two paths (see SERVE_TOL).
STEP_WINDOWS = 16
STEP_TOL = {"float32": dict(loss=1e-5, grad=1e-3),
            "bfloat16": dict(loss=1e-2)}
# the flagship MoE configuration (BASELINE.md:836-915): WeatherBERT-large,
# 8 experts, top-2, the effective batch 288 as 3 microbatches of 96
MOE = dict(num_experts=8, moe_top_k=2)
MOE_BATCH, MOE_ACCUM = 288, 3
MOE_MICRO = MOE_BATCH // MOE_ACCUM
# WeatherFormer-small pretraining with the JAX CLI's defaults
# (weathermodel_tpu/cli/pretrain.py:29-56): batch 256, 10 masked features,
# beta 0.5
FORMER_SIZE, FORMER_BATCH = "small", 256
# the card's published peaks (NVIDIA H100 SXM data sheet): dense bf16
# tensor-core rate, fp32 rate outside the tensor cores, HBM bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# B5 with dropout on is checked at a smaller batch: its plain version builds
# the int64 keep-mask of [B, 16, 365, 365]
OUTPROJ_DROPOUT_BATCH = 32
# the online daemon: client threads x requests each x windows a request, and
# the seconds it may take to answer /healthz and to exit after SIGTERM
DAEMON_CLIENTS, DAEMON_REQUESTS, DAEMON_WINDOWS = 8, 4, 32
DAEMON_START_S, DAEMON_STOP_S = 180, 60


def train_flops_per_sample(cfg, out_dim=None) -> float:
    """Matmul FLOPs per sample of one training step (forward + backward) of
    the encoder with an output head of `out_dim` (default cfg.output_dim;
    2F for the WeatherFormer's (mu, log var)): the bench's analytic count
    (77.2 GFLOP for WeatherBERT-large, T=365; with 8 experts, top-2: 123.8)."""
    from weathermodel_tpu_torch.bench import analytic_flops_per_sample

    return analytic_flops_per_sample(cfg, "train", out_dim)


def _bound(flops: float, nbytes: float, dtype):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of the operations at the peak rate of `dtype` and the bytes
    at the memory rate (each input read once, each output written once)."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _attention_bound(b, t, h, nh, dtype, train: bool):
    """B1's bound: the projection and the attention products; it reads x,
    w and b and writes o (the training form also writes qkv)."""
    flops = 2.0 * b * t * h * 3 * h + 4.0 * b * nh * t * t * (h // nh)
    elems = 2 * b * t * h + 3 * h * h + 3 * h + (3 * b * t * h if train else 0)
    return _bound(flops, elems * dtype.itemsize, dtype)


def _outproj_bound(b, t, h, nh, dtype):
    """B5's bound: B1's projection and attention products and the
    out-projection's 2 B T H^2; it reads x, w, b, wo and bo and writes y."""
    flops = (2.0 * b * t * h * 3 * h + 4.0 * b * nh * t * t * (h // nh)
             + 2.0 * b * t * h * h)
    elems = 2 * b * t * h + 4 * h * h + 4 * h
    return _bound(flops, elems * dtype.itemsize, dtype)


def _flash_bound(b, t, h, nh, dtype):
    """B3f's bound: two T x T x hd products per (row, head); it reads q, k
    and v and writes o."""
    return _bound(4.0 * b * nh * t * t * (h // nh), 4 * b * t * h *
                  dtype.itemsize, dtype)


def _bwd_bound(b, t, h, nh, dtype):
    """B2's and B3b's bound: five T x T x hd products per (row, head); it
    reads q, k, v and dO and writes dq, dk and dv."""
    return _bound(5 * 2.0 * b * nh * t * t * (h // nh),
                  7 * b * t * h * dtype.itemsize, dtype)


def _heads(a, nh):
    b, t, h = a.shape
    return a.view(b, t, nh, h // nh).transpose(1, 2)


def _library_attention(x, w, b, nh, dropout_p=0.0):
    """The library call beside B1: F.linear for the projection, then
    scaled_dot_product_attention (timed only, never the port's path)."""
    q, k, v = (_heads(a, nh) for a in F.linear(x, w, b).chunk(3, dim=-1))
    return F.scaled_dot_product_attention(q, k, v, dropout_p=dropout_p)


def _library_attention_outproj(x, w, b, wo, bo, nh):
    """The library call beside B5: F.linear, scaled_dot_product_attention and
    F.linear (timed only, never the port's path)."""
    o = _library_attention(x, w, b, nh).transpose(1, 2).reshape(x.shape)
    return F.linear(o, wo, bo)


def _sdpa_backend(q, k, v):
    """The first of SDPA's backends, in the order flash, memory-efficient,
    cuDNN, math, that takes these inputs (forward and backward)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = (a.detach().requires_grad_() for a in (q, k, v))
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # each refusal warns
                F.scaled_dot_product_attention(q, k, v).sum().backward()
            return name.lower()
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend takes these inputs")


def _check_kernel(what, got, want, dtype):
    """A kernel's output against its plain version's, at KERNEL_TOL
    entrywise and at SCALE_TOL of the plain output's largest magnitude:
    (max|diff|, RMS of the plain output, its max magnitude)."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, **KERNEL_TOL[dtype],
                               msg=lambda m: f"{what}: {m}")
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    if not err <= SCALE_TOL[dtype] * peak:
        raise AssertionError(f"{what}: max|kernel - plain| {err:.3g} exceeds "
                             f"{SCALE_TOL[dtype]:.3g} x max|plain| {peak:.3g}")
    return err, want.square().mean().sqrt().item(), peak


def _errs_text(errs):
    return ", ".join(f"{name} {err:.3g} (RMS {rms:.3g}, max {peak:.3g})"
                     for name, (err, rms, peak) in errs.items())


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"count {torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    return smi


def phase_build():
    from weathermodel_tpu_torch.kernels import build

    built = build.load_library()
    report = [ln.strip() for ln in built.ptxas_log.splitlines()
              if "Used" in ln or "spill" in ln]
    print(f"build: {built.seconds:.1f} s nvcc -> {built.path.name}; ptxas: "
          + " | ".join(report), flush=True)


def _cuda_ms(fn, iters=5, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel():
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention,
        fused_qkv_attention_reference,
    )
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_config_for_size(MODEL_SIZE)
    h, nh = cfg.hidden_dim, cfg.num_heads
    g = torch.Generator(device="cuda").manual_seed(SEED)
    bound = 1.0 / h ** 0.5
    x = torch.randn(BATCH, SEQ_LEN, h, device="cuda", generator=g)
    w = (torch.rand(3 * h, h, device="cuda", generator=g) * 2 - 1) * bound
    b = (torch.rand(3 * h, device="cuda", generator=g) * 2 - 1) * bound
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = (x.to(dtype), w.to(dtype), b.to(dtype), nh)
        out = fused_qkv_attention(*args)
        ref = fused_qkv_attention_reference(*args)
        torch.cuda.synchronize()
        err, rms, peak = _check_kernel(f"o {dtype}", out, ref, dtype)
        bound_ms, bound_by = _attention_bound(BATCH, SEQ_LEN, h, nh, dtype,
                                              train=False)
        results[dtype] = dict(
            max_abs_err=err, errs=_errs_text({"o": (err, rms, peak)}),
            ms=_cuda_ms(lambda: fused_qkv_attention(*args)),
            plain_ms=_cuda_ms(lambda: fused_qkv_attention_reference(*args)),
            library_ms=_cuda_ms(lambda: _library_attention(*args)),
            bound_ms=bound_ms, bound_by=bound_by)
    print("kernel: fused_qkv_attention B=%d T=%d H=%d heads=%d | " % (
        BATCH, SEQ_LEN, h, nh) + " | ".join(
        f"{str(d).split('.')[1]}: max|err| {r['errs']} (tol {KERNEL_TOL[d]}"
        f", {SCALE_TOL[d]:.3g} x max), kernel {r['ms']:.3f} ms, plain "
        f"{r['plain_ms']:.3f} ms, F.linear+SDPA {r['library_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.3f} ms by {r['bound_by']}"
        for d, r in results.items()), flush=True)
    return results[torch.bfloat16]


def phase_kernel_outproj():
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention,
        fused_qkv_attention_outproj,
        fused_qkv_attention_outproj_reference,
    )
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE)
    h, nh = cfg.hidden_dim, cfg.num_heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    bound = 1.0 / h ** 0.5

    def uniform(*shape):
        return (torch.rand(*shape, device="cuda", generator=g) * 2 - 1) * bound

    x = torch.randn(BATCH, SEQ_LEN, h, device="cuda", generator=g)
    params = (uniform(3 * h, h), uniform(3 * h), uniform(h, h), uniform(h))
    seed = 20260105
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = (x.to(dtype), *(a.to(dtype) for a in params))
        errs = {"y": _check_kernel(
            f"B5 y {dtype}", fused_qkv_attention_outproj(*args, nh),
            fused_qkv_attention_outproj_reference(*args, nh), dtype)}
        small = (args[0][:OUTPROJ_DROPOUT_BATCH], *args[1:])
        errs[f"y dropout {DROPOUT} B={OUTPROJ_DROPOUT_BATCH}"] = _check_kernel(
            f"B5 y {dtype} dropout {DROPOUT}",
            fused_qkv_attention_outproj(*small, nh, DROPOUT, seed),
            fused_qkv_attention_outproj_reference(*small, nh, DROPOUT, seed),
            dtype)
        torch.cuda.empty_cache()
        bound_ms, bound_by = _outproj_bound(BATCH, SEQ_LEN, h, nh, dtype)
        results[dtype] = dict(
            max_abs_err=errs["y"][0], errs=_errs_text(errs),
            ms=_cuda_ms(lambda: fused_qkv_attention_outproj(*args, nh)),
            plain_ms=_cuda_ms(lambda: fused_qkv_attention_outproj_reference(
                *args, nh)),
            library_ms=_cuda_ms(lambda: _library_attention_outproj(*args,
                                                                   nh)),
            b1_ms=_cuda_ms(lambda: F.linear(
                fused_qkv_attention(*args[:3], nh), args[3], args[4])),
            bound_ms=bound_ms, bound_by=bound_by)
    print("kernel_outproj: fused_qkv_attention_outproj B=%d T=%d H=%d "
          "heads=%d | " % (BATCH, SEQ_LEN, h, nh) + " | ".join(
              f"{str(d).split('.')[1]}: max|err| {r['errs']} (tol "
              f"{KERNEL_TOL[d]}, {SCALE_TOL[d]:.3g} x max), kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"F.linear+SDPA+F.linear {r['library_ms']:.3f} ms, B1 eval + "
              f"F.linear {r['b1_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms by "
              f"{r['bound_by']}" for d, r in results.items()), flush=True)
    return results[torch.bfloat16]


def _windows(rng, n):
    """n seeded windows with every input of the request schema."""
    t = SEQ_LEN
    return dict(
        weather=rng.standard_normal((n, t, N_FEATURES), dtype=np.float32),
        coords=np.stack([rng.uniform(-60, 60, n), rng.uniform(-180, 180, n)],
                        axis=-1).astype(np.float32),
        year=(rng.integers(1984, 2002, (n, 1)) + np.arange(t) / t
              ).astype(np.float32),
        interval=np.full((n, 1), 1.0, np.float32),
        mask=rng.random((n, t, N_FEATURES)) < 0.15)


def _write_checkpoint(path: Path, seed: int):
    from weathermodel_tpu_torch.models.weatherbert import WeatherBERT
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    model = WeatherBERT(model_config_for_size(MODEL_SIZE, max_len=SEQ_LEN))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), path)


def _write_inputs(tmp: Path):
    _write_checkpoint(tmp / "weatherbert_large.pth", SEED)
    np.savez(tmp / "windows.npz",
             **_windows(np.random.default_rng(SEED), N_WINDOWS))


def _serve(tmp: Path, impl: str, dtype: str):
    from weathermodel_tpu_torch.cli import serve

    out_path = tmp / f"out_{impl}_{dtype}.npz"
    args = serve.build_parser().parse_args([
        "--checkpoint", str(tmp / "weatherbert_large.pth"),
        "--model", "weatherbert", "--model-size", MODEL_SIZE,
        "--input", str(tmp / "windows.npz"), "--output", str(out_path),
        "--batch-size", str(BATCH), "--compute-dtype", dtype,
        "--attention-impl", impl, "--device", "cuda"])
    t0 = time.perf_counter()
    res = serve.run(args)
    wall = time.perf_counter() - t0
    with np.load(out_path) as z:
        out = z["output"]
    return out, res["predict_s"], wall


def _serve_err(got, want):
    """(max, RMS) of |got - want| over the RMS of want."""
    diff = got - want
    rms = float(np.sqrt(np.mean(np.square(want))))
    return (float(np.abs(diff).max()) / rms,
            float(np.sqrt(np.mean(np.square(diff)))) / rms)


def _check_serve_err(what, err, dtype):
    if not all(e <= tol for e, tol in zip(err, SERVE_TOL[dtype])):
        raise AssertionError(f"{what} {dtype}: (max, RMS) of |diff| / RMS = "
                             f"{err} exceeds {SERVE_TOL[dtype]}")


def phase_serve(smi: str, tmp: Path):
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention,
        fused_qkv_attention_outproj,
    )
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    n_layers = model_config_for_size(MODEL_SIZE).num_layers
    expected = n_layers * -(-N_WINDOWS // BATCH)
    counted = (fused_qkv_attention, fused_qkv_attention_outproj)
    launches, outs, rates = {}, {}, {}
    _serve(tmp, "auto", "bfloat16")  # warm-up: lazy CUDA module loads
    for impl in ("auto", "fused_qkv_op"):
        for fn in counted:
            fn.launches = 0
        out, predict_s, wall = _serve(tmp, impl, "bfloat16")
        launches[impl] = {fn.__name__: fn.launches for fn in counted}
        if out.shape != (N_WINDOWS, SEQ_LEN, N_FEATURES):
            raise AssertionError(f"{impl}: output shape {out.shape}")
        if not np.isfinite(out).all():
            raise AssertionError(f"{impl}: non-finite served output")
        outs[impl, "bfloat16"] = out
        rates[impl] = (N_WINDOWS / predict_s, predict_s, wall)
    want = {"auto": dict(fused_qkv_attention=expected,
                         fused_qkv_attention_outproj=0),
            "fused_qkv_op": dict(fused_qkv_attention=0,
                                 fused_qkv_attention_outproj=expected)}
    if launches != want:
        raise AssertionError(f"kernel launches on the serve path {launches}, "
                             f"expected {want}")
    errs = {}
    for dtype in ("bfloat16", "float32"):
        ref, ref_s, _ = _serve(tmp, "torch", dtype)
        if dtype == "bfloat16":
            rates["torch"] = (N_WINDOWS / ref_s, ref_s, None)
        for impl, key in (("fused_qkv", "auto"),
                          ("fused_qkv_op", "fused_qkv_op")):
            got = outs.get((key, dtype))
            if got is None:
                got = _serve(tmp, impl, dtype)[0]
            errs[impl, dtype] = _serve_err(got, ref)
            _check_serve_err(f"served output of {impl} vs the plain path",
                             errs[impl, dtype], dtype)
    print(f"serve: {N_WINDOWS} windows WeatherBERT-{MODEL_SIZE} bf16 "
          f"--batch-size {BATCH}: kernel launches {launches}; "
          + "; ".join(f"{impl} {r[0]:.1f} windows/s (predict {r[1]:.3f} s)"
                      for impl, r in rates.items())
          + f"; |kernel - plain| (max, RMS)/RMS {errs} (bars {SERVE_TOL}); "
          f"card {smi}", flush=True)
    return launches


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http(port, method, path, body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _npz_bytes(arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _predict(port, arrays):
    status, data = _http(port, "POST", "/predict", _npz_bytes(arrays))
    if status != 200:
        raise AssertionError(f"/predict answered {status}: {data[:300]}")
    with np.load(io.BytesIO(data)) as z:
        return z["output"]


def _wait_healthy(proc, port, log_path):
    deadline = time.perf_counter() + DAEMON_START_S
    while True:
        try:
            if _http(port, "GET", "/healthz")[0] == 200:
                return
        except OSError:
            pass
        if proc.poll() is not None:
            raise AssertionError(f"the daemon exited with {proc.returncode}: "
                                 f"{log_path.read_text()[-2000:]}")
        if time.perf_counter() > deadline:
            raise AssertionError(f"no /healthz within {DAEMON_START_S} s")
        time.sleep(0.5)


def _offline(path: Path, windows):
    """The offline predictor's bf16 answers through B5 for `windows`."""
    from weathermodel_tpu_torch.serve import load_weather_predictor

    predictor = load_weather_predictor(
        str(path), MODEL_SIZE, attention_impl="fused_qkv_op",
        max_len=SEQ_LEN, buckets=(8, 32, 128, BATCH), device="cuda")
    return predictor(windows["weather"], windows["coords"], windows["year"],
                     windows["interval"], windows["mask"])


def phase_serve_daemon(smi: str, tmp: Path):
    first, second = tmp / "weatherbert_large.pth", tmp / "second.pth"
    _write_checkpoint(second, SEED + 1)
    n = DAEMON_CLIENTS * DAEMON_REQUESTS * DAEMON_WINDOWS
    windows = _windows(np.random.default_rng(SEED + 3), n)
    port = _free_port()
    log_path = tmp / "daemon.log"
    cmd = [sys.executable, "-m", "weathermodel_tpu_torch.cli.serve",
           "--daemon", "--checkpoint", str(first), "--model", "weatherbert",
           "--model-size", MODEL_SIZE, "--attention-impl", "fused_qkv_op",
           "--batch-size", str(BATCH), "--seq-len", str(SEQ_LEN),
           "--allow-reload", "--port", str(port), "--device", "cuda"]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=Path(__file__).resolve().parent)
    try:
        _wait_healthy(proc, port, log_path)
        start_s = time.perf_counter() - t0
        answers, errors = {}, []

        def client(c):
            try:
                for r in range(DAEMON_REQUESTS):
                    i0 = (c * DAEMON_REQUESTS + r) * DAEMON_WINDOWS
                    answers[i0] = _predict(port, {
                        k: v[i0:i0 + DAEMON_WINDOWS]
                        for k, v in windows.items()})
            except Exception as e:  # re-raised below, in the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(DAEMON_CLIENTS)]
        t1 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t1
        if errors:
            raise errors[0]
        got = np.concatenate([answers[i] for i in sorted(answers)])
        err = _serve_err(got, _offline(first, windows))
        _check_serve_err("daemon answers vs the offline predictor", err,
                         "bfloat16")
        stats = json.loads(_http(port, "GET", "/stats")[1])
        if stats["n_rows"] != n or not stats["rows_per_batch"] > \
                DAEMON_WINDOWS:
            raise AssertionError(f"/stats {stats}: expected {n} rows in "
                                 f"batches of more than {DAEMON_WINDOWS}")
        status, data = _http(port, "POST", "/reload", json.dumps(
            {"checkpoint": str(second)}).encode())
        if status != 200:
            raise AssertionError(f"/reload answered {status}: {data[:300]}")
        head = {k: v[:DAEMON_WINDOWS] for k, v in windows.items()}
        reloaded = _predict(port, head)
        reload_err = _serve_err(reloaded, _offline(second, head))
        _check_serve_err("daemon answer after /reload vs the new weights",
                         reload_err, "bfloat16")
        if np.allclose(reloaded, got[:DAEMON_WINDOWS]):
            raise AssertionError("/reload did not change the answers")
        t2 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=DAEMON_STOP_S)
        if rc != 0:
            raise AssertionError(f"the daemon exited with {rc} on SIGTERM: "
                                 f"{log_path.read_text()[-2000:]}")
        stop_s = time.perf_counter() - t2
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lat = stats["latency_ms"]
    print(f"serve_daemon: wm-serve-torch --daemon WeatherBERT-{MODEL_SIZE} "
          f"bf16 --attention-impl fused_qkv_op --batch-size {BATCH}: "
          f"/healthz after {start_s:.1f} s (start, load, warm-up of buckets "
          f"8/32/128/{BATCH}); {DAEMON_CLIENTS} clients x {DAEMON_REQUESTS} "
          f"requests x {DAEMON_WINDOWS} windows: {n / wall:.1f} windows/s "
          f"({wall:.3f} s), latency p50 {lat['p50']} ms, p95 {lat['p95']} "
          f"ms, p99 {lat['p99']} ms, {stats['n_batches']} batches of "
          f"{stats['rows_per_batch']} rows; vs the offline predictor "
          f"(max, RMS)/RMS {err}, after /reload {reload_err} (bar "
          f"{SERVE_TOL['bfloat16']}); exit 0 {stop_s:.1f} s after SIGTERM; "
          f"card {smi}", flush=True)
    return stats


def _train_kernels_case(x, w, b, do, nh, dtype, rate, seed, timed: bool):
    """B1 train and B2 against their plain versions on one set of inputs
    (B2 on the plain forward's qkv, so both see the same residual)."""
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention_bwd,
        fused_qkv_attention_bwd_reference,
        fused_qkv_attention_train,
        fused_qkv_attention_train_reference,
    )

    args = (x.to(dtype), w.to(dtype), b.to(dtype), nh)
    g = do.to(dtype)
    o, qkv = fused_qkv_attention_train(*args, rate, seed)
    o_ref, qkv_ref = fused_qkv_attention_train_reference(*args, rate, seed)
    dqkv = fused_qkv_attention_bwd(qkv_ref, g, nh, rate, seed)
    dqkv_ref = fused_qkv_attention_bwd_reference(qkv_ref, g, nh, rate, seed)
    torch.cuda.synchronize()
    errs = {name: _check_kernel(f"{name} {dtype} dropout {rate}", got, want,
                                dtype)
            for name, got, want in (("o", o, o_ref), ("qkv", qkv, qkv_ref),
                                    ("dqkv", dqkv, dqkv_ref))}
    r = dict(fwd_err=max(errs["o"][0], errs["qkv"][0]),
             bwd_err=errs["dqkv"][0], errs=_errs_text(errs))
    del o, qkv, o_ref, dqkv, dqkv_ref
    if not timed:
        return r
    torch.cuda.empty_cache()
    q, k, v = (_heads(a, nh).detach().requires_grad_()
               for a in qkv_ref.chunk(3, dim=-1))
    g_heads = _heads(g, nh)

    def library_bwd():
        out = F.scaled_dot_product_attention(q, k, v, dropout_p=rate)
        return torch.autograd.grad(out, (q, k, v), g_heads)

    r.update(
        fwd_ms=_cuda_ms(lambda: fused_qkv_attention_train(*args, rate, seed)),
        fwd_plain_ms=_cuda_ms(lambda: fused_qkv_attention_train_reference(
            *args, rate, seed), iters=3, warmup=1),
        fwd_library_ms=_cuda_ms(lambda: _library_attention(*args, rate)),
        bwd_ms=_cuda_ms(lambda: fused_qkv_attention_bwd(qkv_ref, g, nh, rate,
                                                        seed)),
        bwd_plain_ms=_cuda_ms(lambda: fused_qkv_attention_bwd_reference(
            qkv_ref, g, nh, rate, seed), iters=3, warmup=1),
        bwd_library_ms=_cuda_ms(library_bwd),
        sdpa_backend=_sdpa_backend(q, k, v))
    return r


def phase_kernel_train():
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE)
    h, nh = cfg.hidden_dim, cfg.num_heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bound = 1.0 / h ** 0.5
    x = torch.randn(MICRO, SEQ_LEN, h, device="cuda", generator=g)
    w = (torch.rand(3 * h, h, device="cuda", generator=g) * 2 - 1) * bound
    b = (torch.rand(3 * h, device="cuda", generator=g) * 2 - 1) * bound
    do = torch.randn(MICRO, SEQ_LEN, h, device="cuda", generator=g)
    seed = 20260101
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for rate in (DROPOUT, 0.0):
            results[dtype, rate] = _train_kernels_case(
                x, w, b, do, nh, dtype, rate, seed, timed=rate == DROPOUT)
    lines = []
    for (dtype, rate), r in results.items():
        line = (f"{str(dtype).split('.')[1]} dropout {rate}: max|err| "
                f"{r['errs']}")
        if "fwd_ms" in r:
            r["fwd_bound"] = _attention_bound(MICRO, SEQ_LEN, h, nh, dtype,
                                              train=True)
            r["bwd_bound"] = _bwd_bound(MICRO, SEQ_LEN, h, nh, dtype)
            line += (
                f"; B1 train kernel {r['fwd_ms']:.3f} ms, plain "
                f"{r['fwd_plain_ms']:.3f}, F.linear+SDPA "
                f"{r['fwd_library_ms']:.3f}, bound {r['fwd_bound'][0]:.3f} "
                f"by {r['fwd_bound'][1]}; B2 kernel {r['bwd_ms']:.3f} ms, "
                f"plain {r['bwd_plain_ms']:.3f}, SDPA fwd+bwd "
                f"{r['bwd_library_ms']:.3f}, bound {r['bwd_bound'][0]:.3f} by "
                f"{r['bwd_bound'][1]}; SDPA backend {r['sdpa_backend']}")
        lines.append(line)
    print(f"kernel_train: B={MICRO} T={SEQ_LEN} H={h} heads={nh} (tol "
          f"{KERNEL_TOL}, {SCALE_TOL} x max) | " + " | ".join(lines),
          flush=True)
    return results[torch.bfloat16, DROPOUT]


def _windows_batch(n, seed):
    """A numpy Batch of n seeded windows (z-scored weather, coords, years,
    weekly interval) and a bool [n, T, F] mask at p=0.15."""
    from weathermodel_tpu_torch.train.steps import Batch

    rng = np.random.default_rng(seed)
    batch = Batch(
        rng.standard_normal((n, SEQ_LEN, N_FEATURES), dtype=np.float32),
        np.stack([rng.uniform(-55, 60, n), rng.uniform(-170, 170, n)],
                 axis=1).astype(np.float32),
        (rng.integers(1984, 1995, (n, 1)) + np.arange(SEQ_LEN) * 7 / 365
         ).astype(np.float32),
        np.full((n, 1), 7.0, np.float32))
    return batch, rng.random((n, SEQ_LEN, N_FEATURES)) < 0.15


def _device_ms(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    if us is None:
        us = event.self_cuda_time_total
    return us / 1e3


def _kernel_events(prof):
    """The profile's device kernels (not the host-side ops that launched
    them: the fused kernels' time would count twice, under the autograd
    Function's name too), by device time."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(kernels, key=_device_ms, reverse=True)


def _train_step_fn(name, cfg, impl, device, grad_accum=1, gmm_impl="kernel",
                   ffn_impl="torch"):
    """A seeded model `name` on `device` and its train step with the
    model's objective (beta 0.5, the CLI's default)."""
    from weathermodel_tpu_torch.cli.pretrain import make_model
    from weathermodel_tpu_torch.train.state import make_optimizer
    from weathermodel_tpu_torch.train.steps import (
        OBJECTIVE_FOR_MODEL,
        make_train_step,
    )

    model = make_model(name, cfg, impl, ffn_impl, gmm_impl)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model = model.to(device)
    objective, masking = OBJECTIVE_FOR_MODEL[name]
    return model, make_train_step(model, make_optimizer(model), masking,
                                  grad_accum=grad_accum, objective=objective,
                                  beta=0.5)


def _profile_step(name, cfg, impl, batch_size, grad_accum=1,
                  ffn_impl="torch", named=()):
    """torch.profiler over one train step (after a warm-up step): device
    time by op and the device's busy share of the step; for each
    (label, substring) in `named`, the device time and count of the kernels
    whose name holds the substring."""
    from weathermodel_tpu_torch.train.steps import batch_to_device

    _, step = _train_step_fn(name, cfg, impl, "cuda", grad_accum,
                             ffn_impl=ffn_impl)
    batch = batch_to_device(_windows_batch(batch_size, SEED)[0], "cuda")
    gen = torch.Generator().manual_seed(SEED)
    float(step(batch, gen, 1e-4, 10)["total_loss"])  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(step(batch, gen, 1e-4, 10)["total_loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _kernel_events(prof)
    total = sum(_device_ms(e) for e in events)
    top = ", ".join(f"{e.key[:60]} {_device_ms(e):.1f} ms x{e.count}"
                    for e in events[:12])
    picked = "".join(
        f"; {label}: "
        f"{sum(_device_ms(e) for e in events if sub in e.key):.2f} ms x"
        f"{sum(e.count for e in events if sub in e.key)}"
        for label, sub in named)
    return (f"profile of one step: kernels {total:.1f} ms of device time in "
            f"{wall_ms:.1f} ms profiled (busy {total / wall_ms:.2f}){picked}; "
            f"top: {top or 'none'}")


def _grad_rel(a, b):
    """The worst parameter's ||grad_a - grad_b|| / ||grad_b|| and its name."""
    return max((((pa.grad.cpu() - pb.grad.cpu()).norm()
                 / pb.grad.cpu().norm()).item(), name)
               for (name, pa), pb in zip(a.named_parameters(),
                                         b.parameters()))


def _step_parity(name, size, impl, dtype: str, moe=None, ffn_impl="torch"):
    """One train step of the kernel path `impl` (with `ffn_impl`) against the
    plain path (plain attention and FFN; with `moe`, the MoE config, also the
    plain grouped matmuls) at STEP_WINDOWS windows, full width, the same
    weights, batch and mask, dropout off: (loss rel diff, worst gradient rel
    diff, its parameter, and in fp32 the same worst gradient diff between
    the plain path on the card and on the CPU: the noise floor of two plain
    fp32 runs)."""
    from weathermodel_tpu_torch.train.steps import batch_to_device
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(size, compute_dtype=dtype, **(moe or {}))
    batch, mask = _windows_batch(STEP_WINDOWS, SEED + 2)
    runs = [(impl, ffn_impl, "kernel", "cuda"),
            ("torch", "torch", "plain", "cuda")]
    if dtype == "float32":
        runs.append(("torch", "torch", "plain", "cpu"))
    models, losses = [], []
    for run_impl, run_ffn, gmm_impl, device in runs:
        model, step = _train_step_fn(name, cfg, run_impl, device,
                                     gmm_impl=gmm_impl, ffn_impl=run_ffn)
        out = step(batch_to_device(batch, device),
                   torch.Generator().manual_seed(SEED), 0.0, 10,
                   mask=torch.from_numpy(mask).to(device), dropout_rate=0.0)
        models.append(model)
        losses.append(float(out["total_loss"]))
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    floor = _grad_rel(models[1], models[2])[0] if len(models) > 2 else None
    return (loss_rel, *_grad_rel(models[0], models[1]), floor)


def _check_step_parity(name, size, impl, moe=None, ffn_impl="torch"):
    parity = {}
    for dtype in ("float32", "bfloat16"):
        parity[dtype] = _step_parity(name, size, impl, dtype, moe, ffn_impl)
        loss_rel, grad_rel, _, _ = parity[dtype]
        tol = STEP_TOL[dtype]
        if loss_rel > tol["loss"] or grad_rel > tol.get("grad", np.inf):
            raise AssertionError(
                f"{name} {dtype}: one step, kernel path vs plain path (loss "
                f"rel, worst gradient, its parameter) {parity[dtype]}, bars "
                f"{tol}")
    what = ("attention and grouped matmuls" if moe else "attention"
            if ffn_impl == "torch" else f"attention and {ffn_impl}")
    return (f"one step at {STEP_WINDOWS} windows, kernel path vs plain "
            f"path ({what}), dropout off, (loss rel, worst gradient "
            "||diff||/||grad||, its parameter, the plain path's card-vs-CPU "
            f"worst gradient diff): {parity}; bars {STEP_TOL}")


def _write_store(root: Path) -> Path:
    """A seeded synthetic chunk store written by the port's writer: 8 chunks
    (train 0-6, validation 7) of 1000 windows, of which the cutoff year
    keeps about 2/3."""
    from weathermodel_tpu_torch.data.chunks import write_synthetic_dataset

    data = root / "data"
    write_synthetic_dataset(str(data), n_chunks=8, n_samples=1000,
                            seq_len=SEQ_LEN, seed=SEED)
    return data


def _store_batches(data: Path, batch_size: int):
    """(train batches, validation windows) per epoch of the store."""
    from weathermodel_tpu_torch.data.pretraining import (
        PretrainDataConfig,
        pretrain_batches,
    )

    dcfg = PretrainDataConfig(data_dir=str(data), batch_size=batch_size)
    n_train = sum(1 for _ in pretrain_batches("train", dcfg))
    n_val = sum(int(bt.weight.sum()) if bt.weight is not None
                else batch_size for bt in pretrain_batches("validation",
                                                           dcfg))
    if n_train < 4 or n_val < batch_size:
        raise AssertionError(f"synthetic store too small: {n_train} train "
                             f"batches, {n_val} validation windows")
    return n_train, n_val


def _run_pretrain(argv, counted):
    """`wm-pretrain-torch`'s run(args) on argv with every wrapper in
    `counted` set to 0 just before: (result, launches by wrapper name,
    wall seconds, peak GB, the output json)."""
    from weathermodel_tpu_torch.cli import pretrain

    args = pretrain.build_parser().parse_args(argv)
    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = pretrain.run(args)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    workdir = Path(args.workdir)
    records = list(workdir.glob("*_output.json"))
    if len(records) != 1 or not (workdir / "best.pth").exists():
        raise AssertionError(f"wm-pretrain-torch wrote {records} and "
                             "no best.pth")
    with open(records[0]) as f:
        record = json.load(f)
    return result, launches, wall, peak_gb, record


def _all_kernels():
    from weathermodel_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention,
        fused_qkv_attention_bwd,
        fused_qkv_attention_outproj,
        fused_qkv_attention_train,
    )
    from weathermodel_tpu_torch.ops.fused_ffn import fused_ffn
    from weathermodel_tpu_torch.ops.fused_ffn_ln import (
        fused_ffn_ln,
        fused_ffn_ln_bwd,
    )
    from weathermodel_tpu_torch.ops.gmm import gmm, tgmm
    from weathermodel_tpu_torch.ops.kernel_dropout import (
        lane_dropout,
        random_keep_mask,
    )
    from weathermodel_tpu_torch.ops.maskgen import (
        bool_keep_mask,
        packed_keep_mask,
    )

    return (fused_qkv_attention, fused_qkv_attention_train,
            fused_qkv_attention_bwd, flash_attention_fwd, flash_attention_bwd,
            gmm, tgmm, fused_ffn_ln, fused_ffn_ln_bwd, fused_ffn,
            fused_qkv_attention_outproj, packed_keep_mask, bool_keep_mask,
            lane_dropout, random_keep_mask)


# the kernels no training run launches: the FFN kernels (the bench's only),
# B5 (serving and the bench's eval mode only) and the keep-mask family (the
# maskgen dropout impls, which only the bench's maskgen lines select, and
# B8/B8m, which no layer calls)
NOT_IN_TRAINING = {"fused_ffn_ln": 0, "fused_ffn_ln_bwd": 0, "fused_ffn": 0,
                   "fused_qkv_attention_outproj": 0, "packed_keep_mask": 0,
                   "bool_keep_mask": 0, "lane_dropout": 0,
                   "random_keep_mask": 0}


def _check_record(record, keys=("total_loss",)):
    """The losses of both scopes are finite and the train loss falls from
    epoch 1 to epoch 2; returns (train loss, validation loss)."""
    losses = record["losses"]
    for scope in ("train", "val"):
        for k in keys:
            if not np.all(np.isfinite(losses[scope][k])):
                raise AssertionError(f"non-finite {scope} {k}: "
                                     f"{losses[scope][k]}")
    train_loss = losses["train"]["total_loss"]
    if not train_loss[1] < train_loss[0]:
        raise AssertionError(f"train loss did not fall: {train_loss}")
    return train_loss, losses["val"]["total_loss"]


def _check_launches(launches, expected, steps, val_batches):
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} on the train path, "
                             f"expected {expected} ({steps} steps, "
                             f"{val_batches} validation batches)")


def _throughput(result, cfg, batch_size, out_dim=None):
    """Epoch 2's median step: (ms, samples/s, TFLOP/s, GFLOP/sample)."""
    step_s = float(np.median(result["train_step_seconds"][-1]))
    flops = train_flops_per_sample(cfg, out_dim)
    return (step_s * 1e3, batch_size / step_s,
            flops * batch_size / step_s / 1e12, flops / 1e9)


def phase_train(smi: str, data: Path):
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE, compute_dtype="bfloat16")
    n_train, n_val = _store_batches(data, TRAIN_BATCH)
    with tempfile.TemporaryDirectory() as workdir:
        result, launches, wall, peak_gb, record = _run_pretrain([
            "--model", "weatherbert", "--model-size", MODEL_SIZE,
            "--batch-size", str(TRAIN_BATCH), "--grad-accum", str(GRAD_ACCUM),
            "--n-epochs", "2", "--n-warmup-epochs", "0",
            "--masking-prob", "0.15", "--data-dir", str(data),
            "--workdir", workdir, "--compute-dtype", "bfloat16",
            "--device", "cuda"], _all_kernels())
    steps = sum(len(s) for s in result["train_step_seconds"])
    val_batches = sum(result["val_batches"])
    per_step = GRAD_ACCUM * cfg.num_layers
    _check_launches(launches, {
        "fused_qkv_attention": cfg.num_layers * val_batches,
        "fused_qkv_attention_train": per_step * steps,
        "fused_qkv_attention_bwd": per_step * steps,
        "flash_attention_fwd": 0, "flash_attention_bwd": 0, "gmm": 0,
        "tgmm": 0, **NOT_IN_TRAINING}, steps, val_batches)
    train_loss, val_loss = _check_record(record)
    ms, rate, tflops, gflop = _throughput(result, cfg, TRAIN_BATCH)
    print(f"train: wm-pretrain-torch WeatherBERT-{MODEL_SIZE} bf16 "
          f"--batch-size {TRAIN_BATCH} --grad-accum {GRAD_ACCUM}, dropout "
          f"{cfg.dropout_rate}, 2 epochs, lr 5e-4: {n_train} train batches "
          f"and {n_val} validation windows per epoch; train loss "
          f"{train_loss}, val loss {val_loss}; {launches}; epoch 2 median "
          f"{ms:.1f} ms/step, {rate:.1f} samples/s, {tflops:.1f} TFLOP/s "
          f"({gflop:.1f} GFLOP/sample); epoch seconds "
          f"{record['metrics']['epoch_seconds']}; run {wall:.1f} s; peak "
          f"memory {peak_gb:.1f} GB; card {smi}", flush=True)
    print("train: " + _profile_step("weatherbert", cfg, "fused_qkv",
                                    TRAIN_BATCH, GRAD_ACCUM), flush=True)
    print("train: " + _check_step_parity("weatherbert", MODEL_SIZE,
                                         "fused_qkv"), flush=True)
    return launches


def _flash_case(qkv, do, nh, dtype, rate, seed, timed: bool):
    """B3f and B3b against their plain versions on the column slices of
    one packed projection, as the model passes them."""
    from weathermodel_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    q, k, v = qkv.to(dtype).chunk(3, dim=-1)
    g = do.to(dtype)
    args = (q, k, v, nh, rate, seed)
    bwd_args = (q, k, v, g, nh, rate, seed)
    o = flash_attention_fwd(*args)
    o_ref = flash_attention_fwd_reference(*args)
    grads = flash_attention_bwd(*bwd_args)
    grads_ref = flash_attention_bwd_reference(*bwd_args)
    torch.cuda.synchronize()
    errs = {name: _check_kernel(f"{name} {dtype} dropout {rate}", got, want,
                                dtype)
            for name, got, want in (("o", o, o_ref),
                                    *zip(("dq", "dk", "dv"), grads,
                                         grads_ref))}
    r = dict(fwd_err=errs["o"][0],
             bwd_err=max(errs[n][0] for n in ("dq", "dk", "dv")),
             errs=_errs_text(errs))
    del o, o_ref, grads, grads_ref
    if not timed:
        return r
    torch.cuda.empty_cache()
    heads = [_heads(a, nh) for a in (q, k, v)]
    qh, kh, vh = (a.detach().requires_grad_() for a in heads)
    g_heads = _heads(g, nh)

    def library_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(*heads, dropout_p=rate)

    def library_bwd():
        out = F.scaled_dot_product_attention(qh, kh, vh, dropout_p=rate)
        return torch.autograd.grad(out, (qh, kh, vh), g_heads)

    r.update(
        fwd_ms=_cuda_ms(lambda: flash_attention_fwd(*args)),
        fwd_plain_ms=_cuda_ms(lambda: flash_attention_fwd_reference(*args),
                              iters=3, warmup=1),
        fwd_library_ms=_cuda_ms(library_fwd),
        bwd_ms=_cuda_ms(lambda: flash_attention_bwd(*bwd_args)),
        bwd_plain_ms=_cuda_ms(lambda: flash_attention_bwd_reference(
            *bwd_args), iters=3, warmup=1),
        bwd_library_ms=_cuda_ms(library_bwd),
        sdpa_backend=_sdpa_backend(qh, kh, vh))
    return r


def phase_kernel_flash():
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(FORMER_SIZE)
    h, nh = cfg.hidden_dim, cfg.num_heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    bound = 1.0 / h ** 0.5
    x = torch.randn(FORMER_BATCH, SEQ_LEN, h, device="cuda", generator=g)
    w = (torch.rand(3 * h, h, device="cuda", generator=g) * 2 - 1) * bound
    b = (torch.rand(3 * h, device="cuda", generator=g) * 2 - 1) * bound
    qkv = F.linear(x, w, b)  # the model's packed projection
    do = torch.randn(FORMER_BATCH, SEQ_LEN, h, device="cuda", generator=g)
    del x
    seed = 20260102
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for rate in (DROPOUT, 0.0):
            results[dtype, rate] = _flash_case(qkv, do, nh, dtype, rate, seed,
                                               timed=rate == DROPOUT)
    lines = []
    for (dtype, rate), r in results.items():
        line = (f"{str(dtype).split('.')[1]} dropout {rate}: max|err| "
                f"{r['errs']}")
        if "fwd_ms" in r:
            r["fwd_bound"] = _flash_bound(FORMER_BATCH, SEQ_LEN, h, nh, dtype)
            r["bwd_bound"] = _bwd_bound(FORMER_BATCH, SEQ_LEN, h, nh, dtype)
            line += (
                f"; B3f kernel {r['fwd_ms']:.3f} ms, plain "
                f"{r['fwd_plain_ms']:.3f}, SDPA {r['fwd_library_ms']:.3f}, "
                f"bound {r['fwd_bound'][0]:.3f} by {r['fwd_bound'][1]}; B3b "
                f"kernel {r['bwd_ms']:.3f} ms, plain {r['bwd_plain_ms']:.3f}, "
                f"SDPA fwd+bwd {r['bwd_library_ms']:.3f}, bound "
                f"{r['bwd_bound'][0]:.3f} by {r['bwd_bound'][1]}; SDPA "
                f"backend {r['sdpa_backend']}")
        lines.append(line)
    print(f"kernel_flash: B={FORMER_BATCH} T={SEQ_LEN} H={h} heads={nh} (tol "
          f"{KERNEL_TOL}, {SCALE_TOL} x max) | " + " | ".join(lines),
          flush=True)
    return results[torch.bfloat16, DROPOUT]


def phase_train_former(smi: str, data: Path):
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(FORMER_SIZE, compute_dtype="bfloat16")
    n_train, n_val = _store_batches(data, FORMER_BATCH)
    with tempfile.TemporaryDirectory() as workdir:
        # the JAX CLI's defaults; --attention-impl left at auto
        result, launches, wall, peak_gb, record = _run_pretrain([
            "--model", "weatherformer", "--model-size", FORMER_SIZE,
            "--batch-size", str(FORMER_BATCH), "--n-masked-features", "10",
            "--beta", "0.5", "--compute-dtype", "bfloat16", "--n-epochs", "2",
            "--n-warmup-epochs", "0", "--data-dir", str(data),
            "--workdir", workdir, "--device", "cuda"], _all_kernels())
    steps = sum(len(s) for s in result["train_step_seconds"])
    val_batches = sum(result["val_batches"])
    n = cfg.num_layers
    _check_launches(launches, {
        "fused_qkv_attention": 0, "fused_qkv_attention_train": 0,
        "fused_qkv_attention_bwd": 0,
        "flash_attention_fwd": n * (steps + val_batches),
        "flash_attention_bwd": n * steps, "gmm": 0, "tgmm": 0,
        **NOT_IN_TRAINING}, steps, val_batches)
    train_loss, val_loss = _check_record(
        record, ("total_loss", "reconstruction", "kl_term"))
    out_dim = 2 * cfg.output_dim
    ms, rate, tflops, gflop = _throughput(result, cfg, FORMER_BATCH, out_dim)
    kl = record["losses"]["train"]["kl_term"]
    print(f"train_former: wm-pretrain-torch WeatherFormer-{FORMER_SIZE} bf16 "
          f"--batch-size {FORMER_BATCH}, ELBO beta 0.5, 10 masked features, "
          f"dropout {cfg.dropout_rate}, 2 epochs, lr 5e-4: {n_train} train "
          f"batches and {n_val} validation windows per epoch; train loss "
          f"{train_loss} (kl_term {kl}), val loss {val_loss}; {launches}; "
          f"epoch 2 median {ms:.1f} ms/step, {rate:.1f} samples/s, "
          f"{tflops:.1f} TFLOP/s ({gflop:.2f} GFLOP/sample); epoch seconds "
          f"{record['metrics']['epoch_seconds']}; run {wall:.1f} s; peak "
          f"memory {peak_gb:.1f} GB; card {smi}", flush=True)
    print("train_former: " + _profile_step("weatherformer", cfg, "flash",
                                           FORMER_BATCH), flush=True)
    print("train_former: " + _check_step_parity("weatherformer", FORMER_SIZE,
                                                "flash"), flush=True)
    return launches


# grouped-matmul edge cases (rows per group): boundaries inside a 128-row
# tile, empty first/middle/last groups, S not a multiple of 128, tiny groups
# sharing one tile; at (K, N) = (80, 200), partial slabs and tiles
GMM_EDGE_GROUPS = [[100, 60, 96], [0, 256, 0], [128, 0, 44, 128],
                   [1, 1, 1, 127], [0, 333, 0, 367, 0]]
GMM_EDGE_DIMS = (80, 200)


def _moe_group_sizes(cfg):
    """The per-expert row counts of the MoE microbatch: a top-2 routing of
    MOE_MICRO windows of seeded activations through a seeded router, on the
    device."""
    from weathermodel_tpu_torch.models.moe import MoEFFN, ragged_routing

    ffn = MoEFFN(cfg.hidden_dim, cfg.ffn_dim, cfg.num_experts, cfg.moe_top_k)
    ffn.reset_parameters(torch.Generator().manual_seed(SEED))
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn(MOE_MICRO, SEQ_LEN, cfg.hidden_dim, device="cuda",
                    generator=g)
    with torch.no_grad():
        idx = ffn.cuda().route(x)[3]
    return ragged_routing(idx.reshape(MOE_MICRO, -1), cfg.num_experts)[2]


def _gmm_library(op, lhs, other, gs):
    """One PyTorch call computing what B4 ("gmm", "gmm_t" for rhs^T) or B4t
    ("tgmm") computes, timed beside the kernel and never the port's path:
    torch._grouped_mm where it takes the inputs (bf16), else one cuBLAS
    matmul per group with the sizes read here, outside the timed region.
    Returns (fn, its name)."""
    ends = torch.cumsum(gs, 0).to(torch.int32)
    grouped = {"gmm": lambda: torch._grouped_mm(lhs, other, offs=ends),
               "gmm_t": lambda: torch._grouped_mm(
                   lhs, other.transpose(1, 2), offs=ends),
               "tgmm": lambda: torch._grouped_mm(lhs.t(), other, offs=ends)}
    if hasattr(torch, "_grouped_mm") and lhs.dtype == torch.bfloat16:
        try:
            grouped[op]()
            torch.cuda.synchronize()
            return grouped[op], "torch._grouped_mm"
        except RuntimeError as err:
            print(f"kernel_gmm: torch._grouped_mm refused {op}: "
                  f"{str(err).splitlines()[0]}", flush=True)
    bounds = torch.cat([ends.new_zeros(1), ends]).tolist()
    slices = list(zip(range(len(gs)), bounds[:-1], bounds[1:]))
    loops = {"gmm": lambda: torch.cat([lhs[a:b] @ other[e]
                                       for e, a, b in slices]),
             "gmm_t": lambda: torch.cat([lhs[a:b] @ other[e].T
                                         for e, a, b in slices]),
             "tgmm": lambda: torch.stack([lhs[a:b].T @ other[a:b]
                                          for _, a, b in slices])}
    return loops[op], "a cuBLAS matmul per group"


def _gmm_cases(s, k, n, e, dtype, seed):
    """The B4/B4t calls of one MoE layer's training step, on seeded inputs
    of the layer's shapes: name -> (op, lhs, other). fwd1/fwd2 are the two
    expert matmuls, dlhs1/dlhs2 their d_lhs (B4 against rhs^T), dw1/dw2
    their weight gradients (B4t). Activations are N(0, 1), weights
    U(+-1/sqrt(fan_in)) and cotangents N(0, E/S): a mean loss's gradient is
    small, and at that scale the weight gradients, sums over S/E rows, come
    out O(1) like the forward's outputs, the scale KERNEL_TOL is set for."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    def uniform(fan_in, *shape):
        return ((torch.rand(*shape, device="cuda", generator=g) * 2 - 1)
                / fan_in ** 0.5).to(dtype)

    x, hdn = normal(s, k), normal(s, n)
    dhdn, dout = ((torch.randn(s, c, device="cuda", generator=g)
                   * (e / s) ** 0.5).to(dtype) for c in (n, k))
    w1, w2 = uniform(k, e, k, n), uniform(n, e, n, k)
    return {"fwd1": ("gmm", x, w1), "fwd2": ("gmm", hdn, w2),
            "dlhs1": ("gmm_t", dhdn, w1), "dlhs2": ("gmm_t", dout, w2),
            "dw1": ("tgmm", x, dhdn), "dw2": ("tgmm", hdn, dout)}


def _gmm_call(op, lhs, other, gs, plain=False):
    from weathermodel_tpu_torch.ops.gmm import (
        gmm,
        gmm_reference,
        tgmm,
        tgmm_reference,
    )

    if op == "tgmm":
        return (tgmm_reference if plain else tgmm)(lhs, other, gs)
    return (gmm_reference if plain else gmm)(lhs, other, gs,
                                             trans_rhs=op == "gmm_t")


def _gmm_bound(op, lhs, other, e, dtype):
    """The least time of one call: 2 S K N operations; it reads lhs and the
    other operand once and writes the output ([S, N], or [E, K, N] for B4t)
    once."""
    s, k = lhs.shape
    if op == "tgmm":
        n = other.shape[1]
        out = e * k * n
    else:
        n = other.shape[1] if op == "gmm_t" else other.shape[2]
        out = s * n
    return _bound(2.0 * s * k * n,
                  (lhs.numel() + other.numel() + out) * dtype.itemsize, dtype)


def phase_kernel_gmm():
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE, **MOE)
    gs = _moe_group_sizes(cfg)
    s, e = int(gs.sum()), cfg.num_experts
    results = {}
    print(f"kernel_gmm: S={s} (top-2 routing of {MOE_MICRO} x {SEQ_LEN} "
          f"seeded windows, group sizes {gs.tolist()}), E={e}, K x N = "
          f"{cfg.hidden_dim} x {cfg.ffn_dim} and back (tol {KERNEL_TOL}, "
          f"{SCALE_TOL} x max)", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        cases = _gmm_cases(s, cfg.hidden_dim, cfg.ffn_dim, e, dtype, SEED + 5)
        for name, (op, lhs, other) in cases.items():
            got = _gmm_call(op, lhs, other, gs)
            want = _gmm_call(op, lhs, other, gs, plain=True)
            torch.cuda.synchronize()
            err = _check_kernel(f"{name} {dtype}", got, want, dtype)
            del got, want
            library, library_name = _gmm_library(op, lhs, other, gs)
            r = dict(op=op, err=err,
                     bound=_gmm_bound(op, lhs, other, e, dtype),
                     ms=_cuda_ms(lambda: _gmm_call(op, lhs, other, gs)),
                     plain_ms=_cuda_ms(lambda: _gmm_call(op, lhs, other, gs,
                                                         plain=True)),
                     library_ms=_cuda_ms(library), library=library_name)
            results[dtype, name] = r
            print(f"kernel_gmm: {str(dtype).split('.')[1]} {name} ({op}): "
                  f"max|err| {_errs_text({'out': err})}; kernel "
                  f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f}, "
                  f"{library_name} {r['library_ms']:.3f}, bound "
                  f"{r['bound'][0]:.3f} by {r['bound'][1]}", flush=True)
        del cases
        torch.cuda.empty_cache()
    edge = []
    for dtype in (torch.float32, torch.bfloat16):
        for groups in GMM_EDGE_GROUPS:
            gsz = torch.tensor(groups, device="cuda")
            cases = _gmm_cases(sum(groups), *GMM_EDGE_DIMS, len(groups),
                               dtype, SEED + 6)
            for name, (op, lhs, other) in cases.items():
                got = _gmm_call(op, lhs, other, gsz)
                want = _gmm_call(op, lhs, other, gsz, plain=True)
                torch.cuda.synchronize()
                edge.append(_check_kernel(f"edge {groups} {name} {dtype}",
                                          got, want, dtype)[0])
                if op == "tgmm":
                    for g, size in enumerate(groups):
                        if size == 0 and torch.count_nonzero(got[g]):
                            raise AssertionError(f"edge {groups}: B4t wrote "
                                                 f"non-zeros for empty group "
                                                 f"{g}")
    print(f"kernel_gmm: edge cases, {len(edge)} checks of {GMM_EDGE_GROUPS} "
          f"at K x N = {GMM_EDGE_DIMS} in fp32 and bf16: max|err| "
          f"{max(edge):.3g}", flush=True)

    def record(ops):
        """Mean per call over a layer's calls of the kernel, bf16."""
        rs = [r for (d, _), r in results.items()
              if d == torch.bfloat16 and r["op"] in ops]
        mean = {key: sum(r[key] for r in rs) / len(rs)
                for key in ("ms", "plain_ms", "library_ms")}
        return dict(max_abs_err=max(r["err"][0] for r in rs),
                    bound_ms=sum(r["bound"][0] for r in rs) / len(rs),
                    bound_by=rs[0]["bound"][1], **mean)

    return record(("gmm", "gmm_t")), record(("tgmm",))


def _check_moe_no_host_sync(cfg):
    """One training forward and backward of the MoE kernel path at full
    width, STEP_WINDOWS windows, dropout on, under torch's sync debug mode
    "error": any operation that waits on the host (a group size read back,
    a `bincount` or `nonzero` in the routing) raises."""
    from weathermodel_tpu_torch.train.steps import batch_to_device

    model, _ = _train_step_fn("weatherbert", cfg, "fused_qkv", "cuda")
    batch, mask = _windows_batch(STEP_WINDOWS, SEED + 3)
    batch = batch_to_device(batch, "cuda")
    mask = torch.from_numpy(mask).to("cuda")
    model.train()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = model(*batch[:4], mask,
                         generator=torch.Generator().manual_seed(SEED),
                         return_moe_aux=True)
        (out.square().mean() + cfg.moe_aux_weight * aux).backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return (f"one training forward and backward at {STEP_WINDOWS} windows "
            "under torch.cuda.set_sync_debug_mode('error'): no host sync")


def phase_train_moe(smi: str, data: Path):
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE, compute_dtype="bfloat16", **MOE)
    n_train, n_val = _store_batches(data, MOE_BATCH)
    with tempfile.TemporaryDirectory() as workdir:
        result, launches, wall, peak_gb, record = _run_pretrain([
            "--model", "weatherbert", "--model-size", MODEL_SIZE,
            "--moe-experts", str(cfg.num_experts), "--moe-top-k",
            str(cfg.moe_top_k), "--batch-size", str(MOE_BATCH),
            "--grad-accum", str(MOE_ACCUM), "--n-epochs", "2",
            "--n-warmup-epochs", "0", "--masking-prob", "0.15",
            "--data-dir", str(data), "--workdir", workdir,
            "--compute-dtype", "bfloat16", "--device", "cuda"], _all_kernels())
    steps = sum(len(s) for s in result["train_step_seconds"])
    val_batches = sum(result["val_batches"])
    per_step = MOE_ACCUM * cfg.num_layers
    _check_launches(launches, {
        "fused_qkv_attention": cfg.num_layers * val_batches,
        "fused_qkv_attention_train": per_step * steps,
        "fused_qkv_attention_bwd": per_step * steps,
        "flash_attention_fwd": 0, "flash_attention_bwd": 0,
        "gmm": 4 * per_step * steps + 2 * cfg.num_layers * val_batches,
        "tgmm": 2 * per_step * steps, **NOT_IN_TRAINING}, steps,
        val_batches)
    train_loss, val_loss = _check_record(record, ("total_loss", "moe_aux"))
    ms, rate, tflops, gflop = _throughput(result, cfg, MOE_BATCH)
    aux = record["losses"]["train"]["moe_aux"]
    print(f"train_moe: wm-pretrain-torch WeatherBERT-{MODEL_SIZE} MoE "
          f"E={cfg.num_experts} top-{cfg.moe_top_k} ragged bf16 --batch-size "
          f"{MOE_BATCH} --grad-accum {MOE_ACCUM}, dropout {cfg.dropout_rate}, "
          f"2 epochs, lr 5e-4: {n_train} train batches and {n_val} validation "
          f"windows per epoch; train loss {train_loss} (moe_aux {aux}), val "
          f"loss {val_loss}; {launches}; epoch 2 median {ms:.1f} ms/step, "
          f"{rate:.1f} samples/s, {tflops:.1f} TFLOP/s ({gflop:.1f} "
          f"GFLOP/sample); epoch seconds {record['metrics']['epoch_seconds']}"
          f"; run {wall:.1f} s; peak memory {peak_gb:.1f} GB; card {smi}",
          flush=True)
    print("train_moe: " + _profile_step("weatherbert", cfg, "fused_qkv",
                                        MOE_BATCH, MOE_ACCUM), flush=True)
    print("train_moe: " + _check_step_parity("weatherbert", MODEL_SIZE,
                                             "fused_qkv", MOE), flush=True)
    print("train_moe: " + _check_moe_no_host_sync(cfg), flush=True)
    return launches


# the bench microbatch's FFN rows (2 x 288 windows of 365 steps: 288 x 365)
# and the edge shapes (M, H, F): M not a multiple of the 32-row block, H and
# F not multiples of 16 or 128
FFN_ROWS = MICRO * SEQ_LEN
FFN_EDGE_SHAPES = [(1001, 200, 800), (333, 48, 192)]
FFN_SEEDS = (20260103, 20260104)


def _ffn_inputs(m, h, f, dtype, seed):
    """x [m, h] N(0, 1), weights and biases U(+-1/sqrt(fan_in)) (fp32
    vectors), LN scale 1 + 0.1 N, bias 0.1 N, and a cotangent N(0, 1/m), a
    mean loss's scale, at which the weight gradients (sums over m rows) come
    out O(1) like the other outputs, the scale KERNEL_TOL is set for."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale

    def uniform(fan_in, *shape):
        return (torch.rand(*shape, device="cuda", generator=g) * 2 - 1) \
            / fan_in ** 0.5

    return dict(x=normal(m, h).to(dtype), w1=uniform(h, h, f).to(dtype),
                b1=uniform(h, f), w2=uniform(f, f, h).to(dtype),
                b2=uniform(f, h), ls=1 + normal(h, scale=0.1),
                lb=normal(h, scale=0.1),
                do=normal(m, h, scale=m ** -0.5).to(dtype))


def _ffn_bounds(m, h, f, dtype):
    """(B6f, B6b, B7 with its hidden output) bounds: 4 M H F operations
    forward, 12 backward; each reads x and the parameters once and writes
    its outputs once (B6b also reads do and writes dx and the parameters'
    gradients; B7 writes f and h)."""
    e = dtype.itemsize
    params = 2 * h * f * e + (f + 3 * h) * 4
    flops = 4.0 * m * h * f
    return dict(
        fwd_bound=_bound(flops, 2 * m * h * e + params, dtype),
        bwd_bound=_bound(3 * flops, 3 * m * h * e + 2 * params, dtype),
        b7_bound=_bound(flops, (2 * m * h + m * f) * e + params - 2 * h * 4,
                        dtype))


def _ffn_yardstick(t, train: bool, ln: bool):
    """The port's "torch" FFN in the compute dtype on the same inputs (no
    dropout): F.linear, ReLU, F.linear, and for B6 the residual and
    F.layer_norm; with `train`, forward and autograd backward. Timed beside
    the kernels, never the port's path."""
    dtype = t["x"].dtype
    w1, w2 = t["w1"].T.contiguous(), t["w2"].T.contiguous()
    b1, b2 = t["b1"].to(dtype), t["b2"].to(dtype)
    leaves = [a.detach().requires_grad_(train) for a in (t["x"], w1, w2)]

    def run():
        x, a, b = leaves
        y = F.linear(F.relu(F.linear(x, a, b1)), b, b2)
        if ln:
            y = F.layer_norm(x + y, y.shape[-1:], t["ls"].to(dtype),
                             t["lb"].to(dtype), 1e-5)
        if train:
            return torch.autograd.grad(y, leaves, t["do"])
        return y

    return run


def _ffn_case(t, rate, timed: bool):
    """B6f, B6b and B7 (with and without h) against their plain versions on
    one set of inputs."""
    from weathermodel_tpu_torch.ops.fused_ffn import (
        fused_ffn,
        fused_ffn_reference,
    )
    from weathermodel_tpu_torch.ops.fused_ffn_ln import (
        fused_ffn_ln,
        fused_ffn_ln_bwd,
        fused_ffn_ln_bwd_reference,
        fused_ffn_ln_reference,
    )

    dtype = t["x"].dtype
    ln_args = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"], t["ls"], t["lb"])
    ffn_args = ln_args[:5]
    bwd_args = (*ln_args, t["do"])
    errs = {"out": _check_kernel(
        f"B6f {dtype} dropout {rate}", fused_ffn_ln(*ln_args, rate, FFN_SEEDS),
        fused_ffn_ln_reference(*ln_args, rate, FFN_SEEDS), dtype)}
    got = fused_ffn_ln_bwd(*bwd_args, rate, FFN_SEEDS)
    want = fused_ffn_ln_bwd_reference(*bwd_args, rate, FFN_SEEDS)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2", "dls", "dlb"),
                          got, want):
        errs[name] = _check_kernel(f"B6b {name} {dtype} dropout {rate}", a,
                                   b, dtype)
    del got, want
    f_k, h_k = fused_ffn(*ffn_args, rate, FFN_SEEDS, want_h=True)
    f_p, h_p = fused_ffn_reference(*ffn_args, rate, FFN_SEEDS, True)
    errs["f"] = _check_kernel(f"B7 f {dtype} dropout {rate}", f_k, f_p, dtype)
    errs["h"] = _check_kernel(f"B7 h {dtype} dropout {rate}", h_k, h_p, dtype)
    f_only = fused_ffn(*ffn_args, rate, FFN_SEEDS)
    torch.cuda.synchronize()
    if f_only[1] is not None or not torch.equal(f_only[0], f_k):
        raise AssertionError("B7 without its hidden output differs from B7 "
                             "with it")
    del f_k, h_k, f_p, h_p, f_only
    r = dict(fwd_err=errs["out"][0],
             bwd_err=max(errs[n][0] for n in ("dx", "dw1", "db1", "dw2",
                                               "db2", "dls", "dlb")),
             b7_err=max(errs["f"][0], errs["h"][0]), errs=_errs_text(errs))
    if not timed:
        return r
    torch.cuda.empty_cache()
    r.update(
        fwd_ms=_cuda_ms(lambda: fused_ffn_ln(*ln_args, rate, FFN_SEEDS)),
        fwd_plain_ms=_cuda_ms(lambda: fused_ffn_ln_reference(
            *ln_args, rate, FFN_SEEDS), iters=3, warmup=1),
        fwd_library_ms=_cuda_ms(_ffn_yardstick(t, False, True)),
        bwd_ms=_cuda_ms(lambda: fused_ffn_ln_bwd(*bwd_args, rate, FFN_SEEDS)),
        bwd_plain_ms=_cuda_ms(lambda: fused_ffn_ln_bwd_reference(
            *bwd_args, rate, FFN_SEEDS), iters=3, warmup=1),
        bwd_library_ms=_cuda_ms(_ffn_yardstick(t, True, True)),
        b7_ms=_cuda_ms(lambda: fused_ffn(*ffn_args, rate, FFN_SEEDS,
                                         want_h=True)),
        b7_plain_ms=_cuda_ms(lambda: fused_ffn_reference(
            *ffn_args, rate, FFN_SEEDS, True), iters=3, warmup=1),
        b7_library_ms=_cuda_ms(_ffn_yardstick(t, False, False)),
        b7_eval_ms=_cuda_ms(lambda: fused_ffn(*ffn_args, rate, FFN_SEEDS)))
    return r


def phase_kernel_ffn():
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE)
    h, f = cfg.hidden_dim, cfg.ffn_dim
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        t = _ffn_inputs(FFN_ROWS, h, f, dtype, SEED + 7)
        for rate in (DROPOUT, 0.0):
            r = _ffn_case(t, rate, timed=rate == DROPOUT)
            results[dtype, rate] = r
            line = (f"kernel_ffn: M={FFN_ROWS} H={h} F={f} "
                    f"{str(dtype).split('.')[1]} dropout {rate}: max|err| "
                    f"{r['errs']}")
            if "fwd_ms" in r:
                r.update(_ffn_bounds(FFN_ROWS, h, f, dtype))
                line += "".join(
                    f"; {name} kernel {r[k + '_ms']:.3f} ms, plain "
                    f"{r[k + '_plain_ms']:.3f}, {lib} "
                    f"{r[k + '_library_ms']:.3f}, bound "
                    f"{r[k + '_bound'][0]:.3f} by {r[k + '_bound'][1]}"
                    for name, k, lib in (
                        ("B6f", "fwd", "torch FFN+LN"),
                        ("B6b", "bwd", "torch FFN+LN fwd+bwd"),
                        ("B7 with h", "b7", "torch FFN")))
                line += f"; B7 without h {r['b7_eval_ms']:.3f} ms"
            print(line, flush=True)
        del t
        torch.cuda.empty_cache()
    edge = []
    for m, h_e, f_e in FFN_EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            t = _ffn_inputs(m, h_e, f_e, dtype, SEED + 8)
            for rate in (DROPOUT, 0.0):
                r = _ffn_case(t, rate, timed=False)
                edge.append(max(r["fwd_err"], r["bwd_err"], r["b7_err"]))
    print(f"kernel_ffn: edge shapes (M, H, F) {FFN_EDGE_SHAPES}, fp32 and "
          f"bf16, dropout {DROPOUT} and 0: {len(edge)} cases, max|err| "
          f"{max(edge):.3g} (tol {KERNEL_TOL}, {SCALE_TOL} x max)", flush=True)
    return results[torch.bfloat16, DROPOUT]


# the keep-mask family at the bench microbatch's FFN hidden site (288 x 365
# rows of 2304): seeds of the masks and of B8's input
MASK_SEEDS = (20260201, 20260202)
# 32-bit integer instructions per second: one per lane and clock on each of
# the 128 lanes of the 132 SMs, the data sheet's fp32 rate off the tensor
# cores (67 TFLOP/s, which counts an FMA as two operations) counted in
# instructions
INT_OPS_PER_S = PEAK_FLOPS[torch.float32] / 2
# integer operations per element (mix32 is 8: three shift-xors and two
# multiplies; one xor with the column key; the compare), plus B9p's shift
# and or, B8's multiply and select; a row's key costs 18 more per row
MASK_OPS, PACK_OPS, APPLY_OPS, KEY_OPS = 10, 2, 2, 18


def _mask_bound(elements, rows, ops_per_element, nbytes):
    """(ms, "operations" or "bytes"), and both times: the hash's integer
    operations at INT_OPS_PER_S against the bytes at the memory rate."""
    ops_ms = (elements * ops_per_element + rows * KEY_OPS) / INT_OPS_PER_S * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                                "bytes")
    return bound, ops_ms, bytes_ms


def _check_equal(what, got, want):
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        raise AssertionError(f"{what}: {bad} of {want.numel()} elements "
                             "differ from the plain version")


def _keep_rate(what, keep):
    rate = keep.float().mean().item()
    if abs(rate - (1 - DROPOUT)) > 1e-3:
        raise AssertionError(f"{what}: keep rate {rate}, want "
                             f"{1 - DROPOUT} +- 1e-3")
    return rate


def phase_kernel_maskgen():
    """B9b, B9p, B8m and B8 at the FFN hidden site of the bench microbatch
    [105120, 2304]: B8 (forward and backward) and B8m launched once each
    through their public functions with the counts at 0 (their only path),
    then each kernel held bitwise against its plain version, keep rates,
    CUDA-event times of kernel, plain version and library call, bounds."""
    from weathermodel_tpu_torch.ops import kernel_dropout as kd
    from weathermodel_tpu_torch.ops import maskgen as mg
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    m, c = FFN_ROWS, model_config_for_size(MODEL_SIZE).ffn_dim
    shape, n, rate = (MICRO, SEQ_LEN, c), FFN_ROWS * c, DROPOUT
    s1, s2 = MASK_SEEDS
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
    dy = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)

    for fn in (kd.lane_dropout, kd.random_keep_mask):
        fn.launches = 0
    leaf = x.detach().requires_grad_()
    y = kd.kernel_dropout(leaf, rate, s1)
    y.backward(dy)
    keep8 = kd.random_keep_mask(shape, rate, s1, "cuda")
    torch.cuda.synchronize()
    launches = dict(lane_dropout=kd.lane_dropout.launches,
                    random_keep_mask=kd.random_keep_mask.launches)
    if launches != dict(lane_dropout=2, random_keep_mask=1):
        raise AssertionError(f"kernel_dropout forward + backward and "
                             f"random_keep_mask launched {launches}")

    r = {"launches": launches}
    _check_equal("B8m", keep8, kd.random_keep_mask_reference(shape, rate, s1,
                                                             "cuda"))
    scale = torch.tensor(1 / (1 - rate), dtype=torch.bfloat16, device="cuda")
    zero = torch.zeros((), dtype=torch.bfloat16, device="cuda")
    _check_equal("B8 bf16 vs its mask x scale", y, torch.where(keep8,
                                                               x * scale, zero))
    _check_equal("B8 gradient vs its forward mask x scale x dy", leaf.grad,
                 torch.where(keep8, dy * scale, zero))
    del leaf, y
    rates = {"B8m": _keep_rate("B8m", keep8)}
    r["b8m_ms"] = _cuda_ms(lambda: kd.random_keep_mask(shape, rate, s1,
                                                      "cuda"))
    r["b8m_plain_ms"] = _cuda_ms(lambda: kd.random_keep_mask_reference(
        shape, rate, s1, "cuda"), iters=3, warmup=1)
    r["b8m_library_ms"] = _cuda_ms(lambda: torch.empty(
        shape, dtype=torch.bool, device="cuda").bernoulli_(1 - rate))
    r["b8m_bound"], r["b8m_ops_ms"], r["b8m_bytes_ms"] = _mask_bound(
        n, -(-n // kd.LANES), MASK_OPS, n)
    del keep8

    keep = mg.bool_keep_mask(m, c, rate, s2, "cuda")
    _check_equal("B9b", keep, mg.bool_keep_mask_reference(m, c, rate, s2,
                                                          "cuda"))
    packed = mg.packed_keep_mask(m, c, rate, s2, "cuda")
    _check_equal("B9p", packed, mg.packed_keep_mask_reference(m, c, rate, s2,
                                                              "cuda"))
    _check_equal("B9p unpacked vs B9b", mg.unpack_keep(packed, m), keep)
    rates["B9b"] = _keep_rate("B9b", keep)
    del keep, packed
    for key, fn, lib, nbytes, ops in (
            ("b9b", mg.bool_keep_mask, lambda: torch.empty(
                m, c, dtype=torch.bool, device="cuda").bernoulli_(1 - rate),
             m * c, MASK_OPS),
            ("b9p", mg.packed_keep_mask, None, m * c // 8,
             MASK_OPS + PACK_OPS)):
        ref = getattr(mg, fn.__name__ + "_reference")
        r[key + "_ms"] = _cuda_ms(lambda: fn(m, c, rate, s2, "cuda"))
        r[key + "_plain_ms"] = _cuda_ms(lambda: ref(m, c, rate, s2, "cuda"),
                                        iters=3, warmup=1)
        r[key + "_library_ms"] = _cuda_ms(lib) if lib else None
        r[key + "_bound"], r[key + "_ops_ms"], r[key + "_bytes_ms"] = \
            _mask_bound(m * c, m, ops, nbytes)

    for dtype in (torch.bfloat16, torch.float32):
        xd = x.to(dtype)
        got = kd.lane_dropout(xd, rate, s1)
        _check_equal(f"B8 {dtype}", got, kd.lane_dropout_reference(xd, rate,
                                                                   s1))
        rates[f"B8 {dtype}"] = _keep_rate(f"B8 {dtype}", got != 0)
        del got
        k = "b8" if dtype == torch.bfloat16 else "b8_fp32"
        r[k + "_ms"] = _cuda_ms(lambda: kd.lane_dropout(xd, rate, s1))
        r[k + "_plain_ms"] = _cuda_ms(lambda: kd.lane_dropout_reference(
            xd, rate, s1), iters=3, warmup=1)
        r[k + "_library_ms"] = _cuda_ms(lambda: F.dropout(xd, rate,
                                                          training=True))
        r[k + "_bound"], r[k + "_ops_ms"], r[k + "_bytes_ms"] = _mask_bound(
            n, -(-n // kd.LANES), MASK_OPS + APPLY_OPS, 2 * n * dtype.itemsize)
        del xd
    for key in ("b9b", "b9p", "b8m", "b8", "b8_fp32"):
        r[key + "_err"] = 0.0  # held bitwise above
    torch.cuda.empty_cache()
    print(f"kernel_maskgen: [{m}, {c}] (B8/B8m on {list(shape)}), rate "
          f"{rate}: every kernel bitwise equal to its plain version, B8's "
          f"gradient its forward mask x scale x dy; keep rates {rates}; "
          f"launches of the public functions {launches}; " + "; ".join(
              f"{name} kernel {r[k + '_ms']:.4f} ms, plain "
              f"{r[k + '_plain_ms']:.3f}, {lib} "
              + ("none" if r[k + "_library_ms"] is None
                 else f"{r[k + '_library_ms']:.4f}")
              + f", bound {r[k + '_bound'][0]:.4f} by {r[k + '_bound'][1]} "
              f"(operations {r[k + '_ops_ms']:.4f}, bytes "
              f"{r[k + '_bytes_ms']:.4f})"
              for name, k, lib in (
                  ("B9b", "b9b", "bernoulli_"), ("B9p", "b9p", "library"),
                  ("B8m", "b8m", "bernoulli_"), ("B8 bf16", "b8", "F.dropout"),
                  ("B8 fp32", "b8_fp32", "F.dropout"))), flush=True)
    return r


# bench steps timed per run (after its 3 warm-up steps)
BENCH_STEPS = 3


def _bench(env, counted):
    """The port's bench run(env) with every wrapper in `counted` set to 0
    just before: (its record, launches by wrapper name, steps run)."""
    from weathermodel_tpu_torch import bench

    for fn in counted:
        fn.launches = 0
    record = bench.run({"BENCH_MODEL_SIZE": MODEL_SIZE,
                        "BENCH_DROPOUT_RATE": str(DROPOUT),
                        "BENCH_STEPS": str(BENCH_STEPS), **env}, "cuda")
    if not np.isfinite(record["loss"]):
        raise AssertionError(f"bench {env}: non-finite loss {record}")
    launches = {fn.__name__: fn.launches for fn in counted}
    return record, launches, 3 + BENCH_STEPS


def _nonzero(launches):
    return {run: {k: n for k, n in got.items() if n}
            for run, got in launches.items()}


def phase_bench(smi: str):
    from weathermodel_tpu_torch.ops import dropout
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE, compute_dtype="bfloat16")
    per_step = GRAD_ACCUM * cfg.num_layers
    counted = _all_kernels()
    zero = {fn.__name__: 0 for fn in counted}
    launches, lines = {}, []
    for impl in ("torch", "fused_ffn_ln", "fused_ffn"):
        record, got, steps = _bench({"BENCH_FFN_IMPL": impl}, counted)
        n = per_step * steps
        ffn = {"torch": {}, "fused_ffn_ln": dict(fused_ffn_ln=n,
                                                 fused_ffn_ln_bwd=n),
               "fused_ffn": dict(fused_ffn=n)}[impl]
        _check_launches(got, {**zero, "fused_qkv_attention_train": n,
                              "fused_qkv_attention_bwd": n, **ffn}, steps, 0)
        launches[impl] = got
        lines.append(f"{impl}: {record['value']} samples/s, "
                     f"{record['tflops']} TFLOP/s, mfu {record['mfu']}, loss "
                     f"{record['loss']:.4f}")
    for impl, kernel in (("maskgen", "packed_keep_mask"),
                         ("maskgen_bool", "bool_keep_mask")):
        dropout.set_impl(impl)
        try:
            record, got, steps = _bench({"BENCH_FFN_IMPL": "torch"}, counted)
        finally:
            dropout.set_impl("auto")
        n = per_step * steps
        # the FFN hidden site of each layer and microbatch; the attention-out
        # and FFN-out sites (C = 576, not a multiple of 128) take "auto"
        _check_launches(got, {**zero, "fused_qkv_attention_train": n,
                              "fused_qkv_attention_bwd": n, kernel: n},
                        steps, 0)
        launches[impl] = got
        lines.append(f"torch + dropout {impl}: {record['value']} samples/s, "
                     f"{record['tflops']} TFLOP/s, mfu {record['mfu']}, loss "
                     f"{record['loss']:.4f}")
    for name, env, kernels in (
            ("fused_ffn_ln", {"BENCH_FFN_IMPL": "fused_ffn_ln"},
             ("fused_qkv_attention", "fused_ffn_ln")),
            ("fused_ffn", {"BENCH_FFN_IMPL": "fused_ffn"},
             ("fused_qkv_attention", "fused_ffn")),
            ("fused_qkv_op", {"BENCH_ATTENTION": "fused_qkv_op"},
             ("fused_qkv_attention_outproj",))):
        record, got, steps = _bench({**env, "BENCH_MODE": "eval"}, counted)
        n = cfg.num_layers * steps
        _check_launches(got, {**zero, **dict.fromkeys(kernels, n)}, steps, 0)
        launches[name + " eval"] = got
        lines.append(f"{name} eval: {record['value']} samples/s, "
                     f"{record['tflops']} TFLOP/s, loss {record['loss']:.4f}")
    print(f"bench: WeatherBERT-{MODEL_SIZE} bf16, {TRAIN_BATCH} = {GRAD_ACCUM} "
          f"x {MICRO}, dropout {DROPOUT}, 3 warm-up + {BENCH_STEPS} timed "
          f"steps a run: " + "; ".join(lines) + "; launches (the nonzero "
          f"counts; every other kernel 0) {_nonzero(launches)}; card {smi}",
          flush=True)
    dropout.set_impl("maskgen_bool")
    try:
        print("bench: torch + dropout maskgen_bool " + _profile_step(
            "weatherbert", cfg, "fused_qkv", TRAIN_BATCH, GRAD_ACCUM,
            named=(("B9b at the FFN hidden sites", "bool_mask_kernel"),
                   ("torch's distribution kernels (the auto sites' "
                    "torch.rand and the step's own draws)",
                    "distribution_"))),
            flush=True)
    finally:
        dropout.set_impl("auto")
    for impl in ("fused_ffn_ln", "fused_ffn"):
        print(f"bench: {impl} " + _profile_step(
            "weatherbert", cfg, "fused_qkv", TRAIN_BATCH, GRAD_ACCUM,
            ffn_impl=impl), flush=True)
        print(f"bench: {impl} " + _check_step_parity(
            "weatherbert", MODEL_SIZE, "fused_qkv", ffn_impl=impl), flush=True)
    return launches


def _record(name, source, replaces, launches, k, prefix):
    """One kernel's entry of the JSON line: `replaces` is "file:line" under
    weathermodel_tpu/ops/, `k` a kernel phase's result and `prefix` ("fwd",
    "bwd", ...) picks the kernel's numbers in it."""
    bound_ms, bound_by = k[prefix + "_bound"]
    return dict(name=name, route="cuda",
                source="weathermodel_tpu_torch/csrc/" + source,
                replaces="weathermodel_tpu/ops/" + replaces,
                launches=launches, max_abs_err=k[prefix + "_err"],
                ms=k[prefix + "_ms"], plain_ms=k[prefix + "_plain_ms"],
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=k[prefix + "_library_ms"])


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    kernel = timed("kernel", phase_kernel)
    outproj_kernel = timed("kernel_outproj", phase_kernel_outproj)
    with tempfile.TemporaryDirectory() as tmp:
        _write_inputs(Path(tmp))
        serve_launches = timed("serve", phase_serve, smi, Path(tmp))
        timed("serve_daemon", phase_serve_daemon, smi, Path(tmp))
    train_kernels = timed("kernel_train", phase_kernel_train)
    with tempfile.TemporaryDirectory() as tmp:
        data = _write_store(Path(tmp))
        train_launches = timed("train", phase_train, smi, data)
        flash_kernels = timed("kernel_flash", phase_kernel_flash)
        former_launches = timed("train_former", phase_train_former, smi, data)
        gmm_kernel, tgmm_kernel = timed("kernel_gmm", phase_kernel_gmm)
        moe_launches = timed("train_moe", phase_train_moe, smi, data)
    ffn_kernels = timed("kernel_ffn", phase_kernel_ffn)
    mask_kernels = timed("kernel_maskgen", phase_kernel_maskgen)
    bench_launches = timed("bench", phase_bench, smi)
    tk, fk = train_kernels, flash_kernels
    records = [
        dict(name="fused_qkv_attention", route="cuda",
             source="weathermodel_tpu_torch/csrc/fused_qkv_attention.cu",
             replaces="weathermodel_tpu/ops/pallas_attention.py:242",
             launches=serve_launches["auto"]["fused_qkv_attention"],
             max_abs_err=kernel["max_abs_err"],
             ms=kernel["ms"], plain_ms=kernel["plain_ms"],
             bound_ms=kernel["bound_ms"], bound_by=kernel["bound_by"],
             library_ms=kernel["library_ms"]),
        _record("fused_qkv_attention_train", "fused_qkv_attention.cu",
                "pallas_attention.py:242",
                train_launches["fused_qkv_attention_train"], tk, "fwd"),
        _record("fused_qkv_attention_bwd", "fused_qkv_attention_bwd.cu",
                "pallas_attention.py:391", train_launches["fused_qkv_attention_bwd"], tk, "bwd"),
        _record("flash_attention_fwd", "flash_attention.cu",
                "pallas_attention.py:199",
                former_launches["flash_attention_fwd"], fk, "fwd"),
        _record("flash_attention_bwd", "flash_attention_bwd.cu",
                "pallas_attention.py:288",
                former_launches["flash_attention_bwd"], fk, "bwd"),
        *(dict(name=name, route="cuda",
               source=f"weathermodel_tpu_torch/csrc/{name}.cu",
               replaces=f"weathermodel_tpu/ops/pallas_gmm.py:{line}",
               launches=moe_launches[name], **k)
          for name, line, k in (("gmm", 155, gmm_kernel),
                                ("tgmm", 233, tgmm_kernel))),
        _record("fused_ffn_ln", "fused_ffn_ln.cu", "pallas_ffn.py:63",
                bench_launches["fused_ffn_ln"]["fused_ffn_ln"], ffn_kernels,
                "fwd"),
        _record("fused_ffn_ln_bwd", "fused_ffn_ln_bwd.cu", "pallas_ffn.py:94",
                bench_launches["fused_ffn_ln"]["fused_ffn_ln_bwd"],
                ffn_kernels, "bwd"),
        _record("fused_ffn", "fused_ffn.cu", "pallas_ffn2.py:55",
                bench_launches["fused_ffn"]["fused_ffn"], ffn_kernels, "b7"),
        dict(name="fused_qkv_attention_outproj", route="cuda",
             source="weathermodel_tpu_torch/csrc/"
                    "fused_qkv_attention_outproj.cu",
             replaces="weathermodel_tpu/ops/pallas_attention.py:258",
             launches=serve_launches["fused_qkv_op"][
                 "fused_qkv_attention_outproj"],
             **{k: outproj_kernel[k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")}),
        # B9p and B9b launched by the bench's maskgen lines; B8 and B8m by
        # their public functions in kernel_maskgen, their only path
        _record("packed_keep_mask", "keep_mask.cu", "pallas_maskgen.py:35",
                bench_launches["maskgen"]["packed_keep_mask"], mask_kernels,
                "b9p"),
        _record("bool_keep_mask", "keep_mask.cu", "pallas_maskgen.py:113",
                bench_launches["maskgen_bool"]["bool_keep_mask"],
                mask_kernels, "b9b"),
        _record("lane_dropout", "keep_mask.cu", "pallas_dropout.py:38",
                mask_kernels["launches"]["lane_dropout"], mask_kernels, "b8"),
        _record("random_keep_mask", "keep_mask.cu", "pallas_dropout.py:89",
                mask_kernels["launches"]["random_keep_mask"], mask_kernels,
                "b8m"),
    ]
    print(f"phase seconds: {seconds}")
    print(f"card: {smi}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
