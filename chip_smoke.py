"""Drive the PyTorch/CUDA port (weathermodel_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero:
  1. device  - requires CUDA; prints the card and its power limit
  2. build   - compiles csrc/*.cu with nvcc for sm_90a; build time and the
               ptxas report (registers, spills)
  3. kernel  - the fused QKV attention kernel vs its plain PyTorch version at
               WeatherBERT-large's serving shapes (B=256, T=365, H=576, 16
               heads) in fp32 and bf16, with CUDA-event times of both
  4. serve   - a seeded WeatherBERT-large saved as a reference .pth and 300
               seeded windows served through the `wm-serve-torch` entry point
               in bf16 (a 256 chunk + 44 rows padded to the 128 bucket); the
               kernel must launch 16 times (8 layers x 2 chunks) and agree with
               the plain attention path, in bf16 and in fp32
  5. kernel_train - the fused QKV attention kernel's training form (B1
               train) and its backward kernel (B2) vs their plain versions at
               the training microbatch (B=288, T=365, H=576, 16 heads) in fp32
               and bf16, dropout 0.1 (the same seed on both sides) and 0; CUDA-
               event times of the kernel, the plain version and the library
               call (F.linear + scaled_dot_product_attention, forward; forward
               and backward for B2), naming the SDPA backend
  6. train   - a seeded synthetic chunk store written by the port's writer;
               `wm-pretrain-torch`'s run(args) trains WeatherBERT-large in
               bf16, --batch-size 576 --grad-accum 2, dropout 0.1, 2 epochs:
               16 launches of each training kernel per step and 8 of the eval
               form per validation batch, finite losses that fall; ms per
               step, samples/s, TFLOP/s and peak memory; a torch.profiler
               capture of one step; one step of the kernel path against the
               plain attention path at 16 windows, dropout off, fp32 and bf16
The card's name and power limit are printed by phase 1 and again before the
kernels' JSON record; the last line is {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import tempfile
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
# the card's published peaks (NVIDIA H100 SXM data sheet): dense bf16
# tensor-core rate, fp32 rate outside the tensor cores, HBM bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12


def train_flops_per_sample(cfg) -> float:
    """Matmul FLOPs per sample of one training step (forward + backward =
    3x forward) of the dense WeatherBERT encoder: the analytic count of
    bench.py:35-54, restated here (77.2 GFLOP at large, T=365)."""
    t, h, n_layers = cfg.max_len, cfg.hidden_dim, cfg.num_layers
    macs = n_layers * (4 * t * h * h + 8 * t * h * h + 2 * t * t * h)
    macs += cfg.input_dim * t * h + t * h * cfg.output_dim
    return 3.0 * 2.0 * macs


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


def _bwd_bound(b, t, h, nh, dtype):
    """B2's bound: five T x T x hd products per (row, head); it reads qkv
    and dO and writes dqkv."""
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
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(),
                                   **KERNEL_TOL[dtype])
        bound_ms, bound_by = _attention_bound(BATCH, SEQ_LEN, h, nh, dtype,
                                              train=False)
        results[dtype] = dict(
            max_abs_err=err,
            ms=_cuda_ms(lambda: fused_qkv_attention(*args)),
            plain_ms=_cuda_ms(lambda: fused_qkv_attention_reference(*args)),
            library_ms=_cuda_ms(lambda: _library_attention(*args)),
            bound_ms=bound_ms, bound_by=bound_by)
    print("kernel: fused_qkv_attention B=%d T=%d H=%d heads=%d | " % (
        BATCH, SEQ_LEN, h, nh) + " | ".join(
        f"{str(d).split('.')[1]}: max|err| {r['max_abs_err']:.3g} (tol "
        f"{KERNEL_TOL[d]}), kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}"
        f" ms, F.linear+SDPA {r['library_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.3f} ms by {r['bound_by']}"
        for d, r in results.items()), flush=True)
    return results[torch.bfloat16]


def _write_inputs(tmp: Path):
    from weathermodel_tpu_torch.models.weatherbert import WeatherBERT
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    model = WeatherBERT(model_config_for_size(MODEL_SIZE, max_len=SEQ_LEN))
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    torch.save(model.state_dict(), tmp / "weatherbert_large.pth")
    rng = np.random.default_rng(SEED)
    n, t = N_WINDOWS, SEQ_LEN
    np.savez(
        tmp / "windows.npz",
        weather=rng.standard_normal((n, t, N_FEATURES), dtype=np.float32),
        coords=np.stack([rng.uniform(-60, 60, n), rng.uniform(-180, 180, n)],
                        axis=-1).astype(np.float32),
        year=(rng.integers(1984, 2002, (n, 1)) + np.arange(t) / t
              ).astype(np.float32),
        interval=np.full((n, 1), 1.0, np.float32),
        mask=rng.random((n, t, N_FEATURES)) < 0.15)


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


def phase_serve(smi: str):
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention,
    )
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    n_layers = model_config_for_size(MODEL_SIZE).num_layers
    expected = n_layers * -(-N_WINDOWS // BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _write_inputs(tmp)
        _serve(tmp, "auto", "bfloat16")  # warm-up: lazy CUDA module loads
        fused_qkv_attention.launches = 0
        out, predict_s, wall = _serve(tmp, "auto", "bfloat16")
        launches = fused_qkv_attention.launches
        if launches != expected:
            raise AssertionError(f"kernel launched {launches} times on the "
                                 f"serve path, expected {expected}")
        if out.shape != (N_WINDOWS, SEQ_LEN, N_FEATURES):
            raise AssertionError(f"output shape {out.shape}")
        if not np.isfinite(out).all():
            raise AssertionError("non-finite served output")
        errs = {}
        plain_predict_s = None
        for dtype in ("bfloat16", "float32"):
            got = out if dtype == "bfloat16" else _serve(tmp, "fused_qkv",
                                                         dtype)[0]
            ref, ref_s, _ = _serve(tmp, "torch", dtype)
            if dtype == "bfloat16":
                plain_predict_s = ref_s
            diff = got - ref
            rms = float(np.sqrt(np.mean(np.square(ref))))
            errs[dtype] = (float(np.abs(diff).max()) / rms,
                           float(np.sqrt(np.mean(np.square(diff)))) / rms)
            if not all(e <= tol for e, tol in zip(errs[dtype],
                                                  SERVE_TOL[dtype])):
                raise AssertionError(
                    f"{dtype}: served output (max, RMS) of |kernel - plain| "
                    f"/ RMS = {errs[dtype]} exceeds {SERVE_TOL[dtype]}")
    print(f"serve: {N_WINDOWS} windows WeatherBERT-{MODEL_SIZE} bf16 "
          f"--batch-size {BATCH}: {launches} kernel launches; "
          f"{N_WINDOWS / predict_s:.1f} windows/s (predict {predict_s:.3f} s,"
          f" run {wall:.3f} s), plain attention path "
          f"{N_WINDOWS / plain_predict_s:.1f} windows/s; |kernel - plain| "
          f"(max, RMS)/RMS bf16 {errs['bfloat16']}, fp32 {errs['float32']};"
          f" card {smi}", flush=True)
    return launches


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
    errs = {}
    for name, got, want in (("o", o, o_ref), ("qkv", qkv, qkv_ref),
                            ("dqkv", dqkv, dqkv_ref)):
        errs[name] = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(),
                                   **KERNEL_TOL[dtype], msg=lambda m: (
                                       f"{name} {dtype} dropout {rate}: {m}"))
    r = dict(fwd_err=max(errs["o"], errs["qkv"]), bwd_err=errs["dqkv"])
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
        line = (f"{str(dtype).split('.')[1]} dropout {rate}: max|err| B1 "
                f"{r['fwd_err']:.3g} B2 {r['bwd_err']:.3g}")
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
          f"{KERNEL_TOL}) | " + " | ".join(lines), flush=True)
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


def _profile_step(cfg):
    """torch.profiler over one train step at 2 x 288 (after a warm-up
    step): device time by op and the device's busy share of the step."""
    from weathermodel_tpu_torch.cli.pretrain import make_model
    from weathermodel_tpu_torch.train.state import make_optimizer
    from weathermodel_tpu_torch.train.steps import (
        batch_to_device,
        make_train_step,
    )

    model = make_model("weatherbert", cfg, "fused_qkv")
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model = model.cuda()
    step = make_train_step(model, make_optimizer(model), "weatherbert",
                           grad_accum=GRAD_ACCUM)
    batch = batch_to_device(_windows_batch(TRAIN_BATCH, SEED)[0], "cuda")
    gen = torch.Generator().manual_seed(SEED)
    float(step(batch, gen, 1e-4, 1)["total_loss"])  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(step(batch, gen, 1e-4, 1)["total_loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _kernel_events(prof)
    total = sum(_device_ms(e) for e in events)
    top = ", ".join(f"{e.key[:60]} {_device_ms(e):.1f} ms x{e.count}"
                    for e in events[:12])
    return (f"profile of one step: kernels {total:.1f} ms of device time in "
            f"{wall_ms:.1f} ms profiled (busy {total / wall_ms:.2f}); top: "
            f"{top or 'none'}")


def _grad_rel(a, b):
    """The worst parameter's ||grad_a - grad_b|| / ||grad_b|| and its name."""
    return max((((pa.grad.cpu() - pb.grad.cpu()).norm()
                 / pb.grad.cpu().norm()).item(), name)
               for (name, pa), pb in zip(a.named_parameters(),
                                         b.parameters()))


def _step_parity(dtype: str):
    """One train step of the kernel path against the plain attention path
    at STEP_WINDOWS windows, large width, the same weights, batch and mask,
    dropout off: (loss rel diff, worst gradient rel diff, its parameter,
    and in fp32 the same worst gradient diff between the plain path on the
    card and on the CPU: the noise floor of two plain fp32 runs)."""
    from weathermodel_tpu_torch.cli.pretrain import make_model
    from weathermodel_tpu_torch.train.state import make_optimizer
    from weathermodel_tpu_torch.train.steps import (
        batch_to_device,
        make_train_step,
    )
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE, compute_dtype=dtype)
    batch, mask = _windows_batch(STEP_WINDOWS, SEED + 2)
    runs = [("fused_qkv", "cuda"), ("torch", "cuda")]
    if dtype == "float32":
        runs.append(("torch", "cpu"))
    models, losses = [], []
    for impl, device in runs:
        model = make_model("weatherbert", cfg, impl)
        model.reset_parameters(torch.Generator().manual_seed(SEED))
        model = model.to(device)
        step = make_train_step(model, make_optimizer(model), "weatherbert")
        out = step(batch_to_device(batch, device),
                   torch.Generator().manual_seed(SEED), 0.0, 1,
                   mask=torch.from_numpy(mask).to(device), dropout_rate=0.0)
        models.append(model)
        losses.append(float(out["total_loss"]))
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    floor = _grad_rel(models[1], models[2])[0] if len(models) > 2 else None
    return (loss_rel, *_grad_rel(models[0], models[1]), floor)


def phase_train(smi: str):
    from weathermodel_tpu_torch.cli import pretrain
    from weathermodel_tpu_torch.data.chunks import write_synthetic_dataset
    from weathermodel_tpu_torch.data.pretraining import (
        PretrainDataConfig,
        pretrain_batches,
    )
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention,
        fused_qkv_attention_bwd,
        fused_qkv_attention_train,
    )
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE, compute_dtype="bfloat16")
    with tempfile.TemporaryDirectory() as tmp:
        data, workdir = Path(tmp) / "data", Path(tmp) / "run"
        # 8 chunks (train 0-6, validation 7) of 1000 windows; the cutoff
        # year keeps about 2/3 of them
        write_synthetic_dataset(str(data), n_chunks=8, n_samples=1000,
                                seq_len=SEQ_LEN, seed=SEED)
        dcfg = PretrainDataConfig(data_dir=str(data), batch_size=TRAIN_BATCH)
        n_train = sum(1 for _ in pretrain_batches("train", dcfg))
        n_val = sum(int(bt.weight.sum()) if bt.weight is not None
                    else TRAIN_BATCH for bt in pretrain_batches("validation",
                                                                dcfg))
        if n_train < 4 or n_val < TRAIN_BATCH:
            raise AssertionError(f"synthetic store too small: {n_train} "
                                 f"train batches, {n_val} validation windows")
        args = pretrain.build_parser().parse_args([
            "--model", "weatherbert", "--model-size", MODEL_SIZE,
            "--batch-size", str(TRAIN_BATCH), "--grad-accum", str(GRAD_ACCUM),
            "--n-epochs", "2", "--n-warmup-epochs", "0",
            "--masking-prob", "0.15", "--data-dir", str(data),
            "--workdir", str(workdir), "--compute-dtype", "bfloat16",
            "--device", "cuda"])
        for fn in (fused_qkv_attention, fused_qkv_attention_train,
                   fused_qkv_attention_bwd):
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = pretrain.run(args)
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in (
            fused_qkv_attention, fused_qkv_attention_train,
            fused_qkv_attention_bwd)}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with open(workdir / "weatherbert_output.json") as f:
            record = json.load(f)
        best = workdir / "best.pth"
        if not best.exists():
            raise AssertionError("wm-pretrain-torch wrote no best.pth")
    steps = sum(len(s) for s in result["train_step_seconds"])
    val_batches = sum(result["val_batches"])
    per_step = GRAD_ACCUM * cfg.num_layers
    expected = {"fused_qkv_attention": cfg.num_layers * val_batches,
                "fused_qkv_attention_train": per_step * steps,
                "fused_qkv_attention_bwd": per_step * steps}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} on the train path, "
                             f"expected {expected} ({steps} steps, "
                             f"{val_batches} validation batches)")
    train_loss = record["losses"]["train"]["total_loss"]
    val_loss = record["losses"]["val"]["total_loss"]
    if not np.all(np.isfinite(train_loss + val_loss)):
        raise AssertionError(f"non-finite losses {train_loss} {val_loss}")
    if not train_loss[1] < train_loss[0]:
        raise AssertionError(f"train loss did not fall: {train_loss}")
    step_s = float(np.median(result["train_step_seconds"][-1]))
    tflops = train_flops_per_sample(cfg) * TRAIN_BATCH / step_s / 1e12
    print(f"train: wm-pretrain-torch WeatherBERT-{MODEL_SIZE} bf16 "
          f"--batch-size {TRAIN_BATCH} --grad-accum {GRAD_ACCUM}, dropout "
          f"{cfg.dropout_rate}, 2 epochs, lr 5e-4: {n_train} train batches "
          f"and {n_val} validation windows per epoch; train loss "
          f"{train_loss}, val loss {val_loss}; {launches}; epoch 2 median "
          f"{step_s * 1e3:.1f} ms/step, {TRAIN_BATCH / step_s:.1f} samples/s, "
          f"{tflops:.1f} TFLOP/s ({train_flops_per_sample(cfg) / 1e9:.1f} "
          f"GFLOP/sample); epoch seconds {record['metrics']['epoch_seconds']};"
          f" run {wall:.1f} s; peak memory {peak_gb:.1f} GB; card {smi}",
          flush=True)
    print("train: " + _profile_step(cfg), flush=True)
    parity = {}
    for dtype in ("float32", "bfloat16"):
        parity[dtype] = _step_parity(dtype)
        loss_rel, grad_rel, _, _ = parity[dtype]
        tol = STEP_TOL[dtype]
        if loss_rel > tol["loss"] or grad_rel > tol.get("grad", np.inf):
            raise AssertionError(
                f"{dtype}: one step, kernel path vs plain path (loss rel, "
                f"worst gradient, its parameter) {parity[dtype]}, bars {tol}")
    print(f"train: one step at {STEP_WINDOWS} windows, kernel path vs plain "
          "attention path, dropout off, (loss rel, worst gradient "
          "||diff||/||grad||, its parameter, the plain path's card-vs-CPU "
          f"worst gradient diff): {parity}; bars {STEP_TOL}",
          flush=True)
    return launches


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    phase_build()
    kernel = phase_kernel()
    serve_launches = phase_serve(smi)
    train_kernels = phase_kernel_train()
    train_launches = phase_train(smi)
    src = "weathermodel_tpu_torch/csrc/"
    replaces = "weathermodel_tpu/ops/pallas_attention.py:"
    tk = train_kernels
    records = [
        dict(name="fused_qkv_attention", source=src + "fused_qkv_attention.cu",
             replaces=replaces + "242", launches=serve_launches,
             max_abs_err=kernel["max_abs_err"], ms=kernel["ms"],
             plain_ms=kernel["plain_ms"], bound_ms=kernel["bound_ms"],
             bound_by=kernel["bound_by"], library_ms=kernel["library_ms"]),
        dict(name="fused_qkv_attention_train",
             source=src + "fused_qkv_attention.cu", replaces=replaces + "242",
             launches=train_launches["fused_qkv_attention_train"],
             max_abs_err=tk["fwd_err"], ms=tk["fwd_ms"],
             plain_ms=tk["fwd_plain_ms"], bound_ms=tk["fwd_bound"][0],
             bound_by=tk["fwd_bound"][1], library_ms=tk["fwd_library_ms"]),
        dict(name="fused_qkv_attention_bwd",
             source=src + "fused_qkv_attention_bwd.cu",
             replaces=replaces + "391",
             launches=train_launches["fused_qkv_attention_bwd"],
             max_abs_err=tk["bwd_err"], ms=tk["bwd_ms"],
             plain_ms=tk["bwd_plain_ms"], bound_ms=tk["bwd_bound"][0],
             bound_by=tk["bwd_bound"][1], library_ms=tk["bwd_library_ms"]),
    ]
    print(f"card: {smi}")
    print(json.dumps({"kernels": [{"route": "cuda", **r} for r in records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
