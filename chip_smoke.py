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
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

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
        results[dtype] = dict(
            max_abs_err=err,
            ms=_cuda_ms(lambda: fused_qkv_attention(*args)),
            plain_ms=_cuda_ms(lambda: fused_qkv_attention_reference(*args)))
    print("kernel: fused_qkv_attention B=%d T=%d H=%d heads=%d | " % (
        BATCH, SEQ_LEN, h, nh) + " | ".join(
        f"{str(d).split('.')[1]}: max|err| {r['max_abs_err']:.3g} (tol "
        f"{KERNEL_TOL[d]}), kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f}"
        " ms" for d, r in results.items()), flush=True)
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
        "--attention-impl", impl])
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


def main():
    smi = phase_device()
    phase_build()
    kernel = phase_kernel()
    launches = phase_serve(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_qkv_attention",
        "route": "cuda",
        "source": "weathermodel_tpu_torch/csrc/fused_qkv_attention.cu",
        "replaces": "weathermodel_tpu/ops/pallas_attention.py:242",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
