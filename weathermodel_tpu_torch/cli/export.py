"""AOT export CLI, `wm-export-torch` (port of weathermodel_tpu/cli/export.py):
freeze a checkpoint into a standalone `torch.export` bundle that serves
without the checkpoint or the port's model code (export_artifact.py).

    wm-export-torch --checkpoint run/best.pth --model weatherbert \\
        --model-size large --output model.wmx \\
        [--buckets 1,32,256] [--seq-len 365] [--platforms cuda,cpu]

Deploy side needs only torch and the bundle:

    from weathermodel_tpu_torch.export_artifact import ExportedPredictor
    pred = ExportedPredictor("model.wmx")
    out = pred(weather, coords, year, interval, mask)

or `wm-serve-torch --daemon --bundle model.wmx`. The attention is forced to
the plain `torch` implementation (JAX's `xla`): the attention kernels'
launches are opaque to `torch.export`. A MoE checkpoint's ragged experts
keep kernel B4 inside the program (the op `wm::gmm`, ops/gmm.py). A "cuda"
program is traced on the card, so the default `--platforms cuda,cpu` needs
one; `--platforms cpu` exports without. The checkpoint is a `.pth` (the
port reads no orbax directory: ROADMAP.md queue A item 16).
"""

import argparse
import logging
import os
import sys
import time

import torch

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--checkpoint", required=True,
                   help="reference-format .pth/.pt file")
    p.add_argument("--model", default="weatherbert")
    p.add_argument("--model-size", default="small")
    p.add_argument("--output", required=True, help="bundle path (.wmx)")
    p.add_argument("--seq-len", default=365, type=int)
    p.add_argument("--buckets", default="1,32,256",
                   help="comma-separated batch buckets, one program each")
    p.add_argument("--platforms", default="cuda,cpu",
                   help="comma-separated targets (cuda, cpu), one program "
                        "each per bucket; cuda is traced on the card")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--moe-experts", default=0, type=int)
    p.add_argument("--moe-top-k", default=2, type=int)
    p.add_argument("--quantize", default="none",
                   choices=("none", "int8", "int8_static"),
                   help="bake a W8A8 FFN into the programs (ops/quant.py). "
                        "int8_static needs --calibrate-input")
    p.add_argument("--calibrate-input",
                   help="int8_static: .npz of representative windows used "
                        "to calibrate the static activation scales, which "
                        "are frozen into the bundle")
    return p


def run(args) -> dict:
    from weathermodel_tpu_torch.cli.serve import _load_windows_npz
    from weathermodel_tpu_torch.export_artifact import PLATFORMS, write_bundle
    from weathermodel_tpu_torch.serve import load_weather_predictor

    buckets = tuple(int(b) for b in args.buckets.split(","))
    platforms = tuple(p.strip() for p in args.platforms.split(","))
    for platform in platforms:
        if platform not in PLATFORMS:
            raise SystemExit(f"--platforms: {platform!r} is not one of "
                             f"{', '.join(PLATFORMS)}")
    calibration_batches = None
    if args.quantize == "int8_static":
        if not args.calibrate_input:
            raise SystemExit("--quantize int8_static requires "
                             "--calibrate-input (representative windows "
                             ".npz for offline scale calibration)")
        calib = _load_windows_npz(args.calibrate_input)
        if calib[0].shape[1] != args.seq_len:
            raise SystemExit(
                f"--calibrate-input has T={calib[0].shape[1]} but the "
                f"export sequence length is {args.seq_len}")
        calibration_batches = [calib]
    if "cuda" in platforms and not torch.cuda.is_available():
        raise SystemExit("--platforms cuda traces its programs on the card "
                         "and no CUDA device is available; pass --platforms "
                         "cpu to export for the CPU only")
    # calibrate (int8_static) on the first platform's device; the scales
    # are buffers that move with the model to the other platforms
    predictor = load_weather_predictor(
        args.checkpoint, model_size=args.model_size, model_name=args.model,
        attention_impl="torch", max_len=args.seq_len, buckets=buckets,
        num_experts=args.moe_experts, moe_top_k=args.moe_top_k,
        compute_dtype=args.compute_dtype, quantize=args.quantize,
        device=platforms[0], calibration_batches=calibration_batches)
    t0 = time.perf_counter()
    manifest = write_bundle(
        args.output, predictor.model, None, buckets, args.seq_len,
        platforms=platforms,
        meta={"model": args.model, "model_size": args.model_size,
              "checkpoint": args.checkpoint,
              "compute_dtype": args.compute_dtype,
              "quantize": args.quantize})
    manifest["write_seconds"] = time.perf_counter() - t0
    manifest["mb"] = os.path.getsize(args.output) / 1e6
    logger.info("wrote %s (%.1f MB in %.1f s, buckets %s, platforms %s, "
                "ops %s)", args.output, manifest["mb"],
                manifest["write_seconds"], manifest["buckets"],
                manifest["platforms"], manifest["ops"])
    return manifest


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    return run(build_parser().parse_args(argv))


def cli() -> None:
    """Console-script entry: setuptools does sys.exit(fn()), so the
    manifest main() returns must not become the process exit code."""
    main()


if __name__ == "__main__":
    sys.exit(cli())
