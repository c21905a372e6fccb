"""Offline batch inference (port of weathermodel_tpu/cli/serve.py):
load a reference-format `.pth` encoder checkpoint and run the bucketed
`WeatherPredictor` (weathermodel_tpu_torch/serve.py) over an input `.npz`
of weather windows, writing the reconstructions to an output `.npz` with
the JAX entry point's keys: `output`, or `mu` and `var` for the
WeatherFormer family.

    wm-serve-torch --checkpoint wb_large.pth --model weatherbert \
                   --model-size large --input windows.npz --output preds.npz

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
    "daemon": "the online HTTP daemon (ROADMAP.md queue A item 13)",
    "bundle": "exported bundles (ROADMAP.md queue A item 13)",
    "quantize": "int8 serving (ROADMAP.md queue A item 13)",
    "tensor_parallel": "tensor-parallel serving (ROADMAP.md queue A item 14)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", help="reference-format .pth/.pt file")
    p.add_argument("--model", default="weatherbert")
    p.add_argument("--model-size", default="small")
    p.add_argument("--input", help=".npz with weather [N,T,F] (+ optional "
                                   "coords/year/interval/mask)")
    p.add_argument("--output", help="output .npz path")
    p.add_argument("--attention-impl", default="auto",
                   choices=("auto", "fused_qkv", "flash", "torch"),
                   help="auto = the fused QKV CUDA kernel (plain PyTorch "
                        "ops on a CPU tensor)")
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
    p.add_argument("--daemon", action="store_true", help="not ported yet")
    p.add_argument("--bundle", help="not ported yet")
    p.add_argument("--quantize", default="none",
                   choices=("none", "int8", "int8_static"),
                   help="not ported yet (only 'none')")
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
    logger.info("serving on %s", device)
    return load_weather_predictor(
        args.checkpoint, model_size=args.model_size, model_name=args.model,
        attention_impl=resolve_attention_impl(
            args.attention_impl, args.model_size, mode="eval"),
        max_len=t, buckets=buckets, num_experts=args.moe_experts,
        moe_top_k=args.moe_top_k, compute_dtype=args.compute_dtype,
        device=device)


def run(args: argparse.Namespace) -> dict:
    defaults = build_parser().parse_args([])
    for flag, what in _UNPORTED.items():
        if getattr(args, flag) != getattr(defaults, flag):
            raise SystemExit(f"--{flag.replace('_', '-')}: {what} is not "
                             "ported to weathermodel_tpu_torch yet")
    if not (args.checkpoint and args.input and args.output):
        raise SystemExit("--checkpoint, --input and --output are required")
    from weathermodel_tpu_torch.cli.pretrain import resolve_device

    device = resolve_device(args.device)
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


def main():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    run(build_parser().parse_args())


if __name__ == "__main__":
    sys.exit(main())
