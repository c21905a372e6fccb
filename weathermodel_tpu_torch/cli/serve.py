"""Batch inference and the online daemon (port of
weathermodel_tpu/cli/serve.py): load a reference-format `.pth` encoder
checkpoint and run the bucketed `WeatherPredictor`
(weathermodel_tpu_torch/serve.py) over an input `.npz` of weather windows,
writing the reconstructions to an output `.npz` with the JAX entry point's
keys: `output`, or `mu` and `var` for the WeatherFormer family.

    wm-serve-torch --checkpoint wb_large.pth --model weatherbert \
                   --model-size large --input windows.npz --output preds.npz

`--daemon` serves online over HTTP instead, with request micro-batching,
load shedding, hot reload and a SIGTERM drain (serving_daemon.py):

    wm-serve-torch --daemon --port 8476 --checkpoint wb_large.pth \
                   --model weatherbert --model-size large --allow-reload
    # clients: POST /predict with .npz bytes; GET /healthz /stats

`--daemon --bundle model.wmx` serves a bundle of `wm-export-torch`
(export_artifact.py) instead of a checkpoint: no model code, the programs'
padding buckets and sequence length; with `--allow-reload`, POST /reload
{"bundle": "<.wmx>"} hot-swaps it for a bundle of the same geometry:

    wm-serve-torch --daemon --port 8476 --bundle model.wmx --allow-reload

`--attention-impl fused_qkv_op` runs each layer's projection, attention and
out-projection as one kernel (B5, inference only).

`--quantize int8` serves the FFN matmuls W8A8 with dynamic activation
scales; `--quantize int8_static --calibrate-input windows.npz` with static
per-channel scales calibrated offline on those windows (a MoE checkpoint's
experts too, through the sort layout); `WM_QUANT_ATTN_OUT=1` extends
int8_static to the attention out-projection (ops/quant.py):

    wm-serve-torch --checkpoint wb_large.pth --model-size large \
        --quantize int8_static --calibrate-input calib.npz \
        --input windows.npz --output preds.npz

Input schema: weather [N, T, F] (+ optional coords [N, 2], year [N, T],
interval [N, 1], mask [N, T, F]; missing ones get the pretraining
defaults). A Mixture-of-Experts checkpoint needs `--moe-experts` (and
`--moe-top-k`) as it was trained; a mismatch either way raises. The model
runs on the CUDA device; without one the entry point exits unless
`--device cpu` asks for the CPU (the kernels' plain versions).
"""

import argparse
import logging
import sys
import time

import numpy as np

logger = logging.getLogger(__name__)

# flags of the JAX entry point whose feature the port does not have yet
_UNPORTED = {
    "tensor_parallel": "tensor-parallel serving (ROADMAP.md queue A item 14)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", help="reference-format .pth/.pt file")
    p.add_argument("--model", default="weatherbert")
    p.add_argument("--model-size", default="small")
    p.add_argument("--input", help=".npz with weather [N,T,F] (+ optional "
                                   "coords/year/interval/mask); required "
                                   "unless --daemon")
    p.add_argument("--output", help="output .npz path; required unless "
                                    "--daemon")
    p.add_argument("--daemon", action="store_true",
                   help="serve online over HTTP instead of one offline "
                        "batch: POST /predict with .npz bytes; concurrent "
                        "requests are micro-batched onto the device "
                        "(serving_daemon.py)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", default=8476, type=int)
    p.add_argument("--max-wait-ms", default=5.0, type=float,
                   help="micro-batching window: max extra latency a lone "
                        "request pays waiting to be coalesced")
    p.add_argument("--max-queue-rows", default=None, type=int,
                   help="daemon mode: bound on pending request rows "
                        "(default 8 x --batch-size); beyond it /predict "
                        "sheds load with 429 + Retry-After")
    p.add_argument("--request-timeout-s", default=None, type=float,
                   help="daemon mode: end-to-end budget for any accepted "
                        "request; expiry answers 503 and abandons the "
                        "rows (default: no timeout)")
    p.add_argument("--allow-reload", action="store_true",
                   help="daemon mode: enable POST /reload "
                        '{"checkpoint": path}: hot-swap the served '
                        "weights (same architecture, no dropped traffic)")
    p.add_argument("--no-warmup", action="store_true",
                   help="daemon mode: skip running every padding bucket "
                        "at startup (the first request of each bucket then "
                        "pays the kernels' build and load)")
    p.add_argument("--seq-len", default=365, type=int,
                   help="daemon mode: the model's max_len (requests must "
                        "have T <= this; offline mode infers it from "
                        "--input)")
    p.add_argument("--attention-impl", default="auto",
                   choices=("auto", "fused_qkv", "fused_qkv_op", "flash",
                            "torch"),
                   help="auto = the fused QKV CUDA kernel (plain PyTorch "
                        "ops on a CPU tensor); fused_qkv_op also runs the "
                        "out-projection inside the kernel (B5)")
    p.add_argument("--batch-size", default=256, type=int,
                   help="max padding bucket (see serve.DEFAULT_BUCKETS)")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="float32 for exact numerics parity")
    p.add_argument("--moe-experts", default=0, type=int,
                   help="must match the checkpoint's --moe-experts")
    p.add_argument("--moe-top-k", default=2, type=int)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) needs a card; cpu runs the kernels' "
                        "plain versions")
    p.add_argument("--bundle",
                   help="daemon mode: serve a wm-export-torch bundle "
                        "(.wmx) instead of --checkpoint; its programs fix "
                        "the buckets and the sequence length")
    p.add_argument("--quantize", default="none",
                   choices=("none", "int8", "int8_static"),
                   help="int8: dynamic W8A8 FFN matmuls (ops/quant.py); "
                        "int8_static: calibrated per-channel activation "
                        "scales (no on-the-fly absmax; needs "
                        "--calibrate-input)")
    p.add_argument("--calibrate-input",
                   help="int8_static: .npz of representative windows (same "
                        "schema as --input) used to calibrate the static "
                        "activation scales offline")
    p.add_argument("--tensor-parallel", default=1, type=int,
                   help="not ported yet (only 1)")
    return p


def _load_windows_npz(path: str) -> tuple:
    """(weather, coords, year, interval, mask) from a windows .npz —
    missing side inputs are synthesized with the pretraining defaults."""
    with np.load(path) as z:
        weather = np.asarray(z["weather"], np.float32)
        n, t, f = weather.shape
        coords = (np.asarray(z["coords"], np.float32) if "coords" in z
                  else np.zeros((n, 2), np.float32))
        year = (np.asarray(z["year"], np.float32) if "year" in z
                else np.full((n, t), 1990.0, np.float32))
        interval = (np.asarray(z["interval"], np.float32)
                    if "interval" in z else np.full((n, 1), 7.0, np.float32))
        mask = (np.asarray(z["mask"], bool) if "mask" in z
                else np.zeros((n, t, f), bool))
    return weather, coords, year, interval, mask


def _make_predictor(args: argparse.Namespace, t: int, device):
    from weathermodel_tpu_torch.ops.attention import resolve_attention_impl
    from weathermodel_tpu_torch.serve import (
        DEFAULT_BUCKETS,
        load_weather_predictor,
    )

    # cap the padding buckets at --batch-size
    buckets = tuple(b for b in DEFAULT_BUCKETS if b < args.batch_size)
    buckets = buckets + (args.batch_size,)
    calibration_batches = None
    if args.quantize == "int8_static":
        if not args.calibrate_input:
            raise SystemExit("--quantize int8_static requires "
                             "--calibrate-input (representative windows "
                             ".npz for offline scale calibration)")
        calib = _load_windows_npz(args.calibrate_input)
        if calib[0].shape[1] != t:
            raise SystemExit(
                f"--calibrate-input has T={calib[0].shape[1]} but the "
                f"serving sequence length is {t}")
        calibration_batches = [calib]
    logger.info("serving on %s", device)
    return load_weather_predictor(
        args.checkpoint, model_size=args.model_size, model_name=args.model,
        attention_impl=resolve_attention_impl(
            args.attention_impl, args.model_size, mode="eval"),
        max_len=t, buckets=buckets, num_experts=args.moe_experts,
        moe_top_k=args.moe_top_k, quantize=args.quantize,
        compute_dtype=args.compute_dtype, device=device,
        calibration_batches=calibration_batches)


def run(args: argparse.Namespace) -> dict:
    defaults = build_parser().parse_args([])
    for flag, what in _UNPORTED.items():
        if getattr(args, flag) != getattr(defaults, flag):
            raise SystemExit(f"--{flag.replace('_', '-')}: {what} is not "
                             "ported to weathermodel_tpu_torch yet")
    if (args.checkpoint is None) == (args.bundle is None):
        raise SystemExit("pass exactly one of --checkpoint / --bundle")
    if args.bundle and not args.daemon:
        raise SystemExit("--bundle is daemon-only (offline batch "
                         "inference on a bundle: use "
                         "export_artifact.ExportedPredictor directly)")
    from weathermodel_tpu_torch.cli.pretrain import resolve_device

    device = resolve_device(args.device)
    if args.daemon:
        return _run_daemon(args, device)
    if not (args.input and args.output):
        raise SystemExit("--input and --output are required (or pass "
                         "--daemon)")
    weather, coords, year, interval, mask = _load_windows_npz(args.input)
    n, t, _ = weather.shape
    predictor = _make_predictor(args, t, device)
    t0 = time.perf_counter()
    output = predictor(weather, coords, year, interval,
                       weather_feature_mask=mask)
    predict_s = time.perf_counter() - t0
    if isinstance(output, tuple):  # variational heads: (mu, var, ...)
        out = {"mu": output[0], "var": output[1]}
        summary = float(np.mean(out["mu"]))
    else:
        out = {"output": output}
        summary = float(np.mean(output))
    np.savez(args.output, **out)
    logger.info("wrote %s: %s for %d windows in %.3f s (mean %.4f)",
                args.output, list(out), n, predict_s, summary)
    return {"n": n, "keys": list(out), "mean": summary,
            "predict_s": predict_s}


def _run_daemon(args: argparse.Namespace, device) -> dict:
    """Serve `args.checkpoint` or `args.bundle` over HTTP until
    SIGTERM/SIGINT."""
    from weathermodel_tpu_torch.serving_daemon import serve_forever

    if args.bundle:
        from weathermodel_tpu_torch.export_artifact import (
            BundleServingPredictor,
        )

        predictor = BundleServingPredictor(args.bundle, device.type)
        seq_len, max_batch = predictor.seq_len, max(predictor.buckets)
        reload_fn = predictor.reload_bundle if args.allow_reload else None
    else:
        from weathermodel_tpu_torch.serve import reload_predictor_params

        predictor = _make_predictor(args, args.seq_len, device)
        seq_len, max_batch = args.seq_len, args.batch_size
        reload_fn = None
        if args.allow_reload:
            def reload_fn(path):
                return reload_predictor_params(predictor, path)

    serve_forever(predictor, args.host, args.port,
                  max_batch=max_batch, max_wait_ms=args.max_wait_ms,
                  do_warmup=not args.no_warmup, seq_len=seq_len,
                  reload_fn=reload_fn,
                  checkpoint=args.bundle or args.checkpoint,
                  max_queue_rows=args.max_queue_rows,
                  request_timeout_s=args.request_timeout_s)
    return {"daemon": True}


def main():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    run(build_parser().parse_args())


if __name__ == "__main__":
    sys.exit(main())
