"""Pretraining entry point, `wm-pretrain-torch` (port of
weathermodel_tpu/cli/pretrain.py): the same flag names and defaults for the
ported features, the WeatherBERT family with the masked-MSE objective and
the WeatherFormer family with the ELBO objectives, on one CUDA device
unless `--device cpu` is given. With no flags it trains what `wm-pretrain`
does: WeatherFormer-small, ELBO with beta 0.5, 10 masked features.

    wm-pretrain-torch --data-dir data/ --workdir run/
    wm-pretrain-torch --model weatherbert --model-size large \\
        --batch-size 576 --grad-accum 2 --data-dir data/ --workdir run/

It writes `{workdir}/{model}_output.json` every epoch and the best
parameters as a reference-format `{workdir}/best.pth`, which
`wm-serve-torch --checkpoint` serves. The module also holds `make_model`
and `load_pretrained_params`, which the serving path shares. Flags of the
JAX entry point whose feature is not ported exit non-zero when set, naming
their ROADMAP.md item.
"""

import argparse
import logging
import sys

import torch

from weathermodel_tpu_torch.models.transfer import load_reference_checkpoint
from weathermodel_tpu_torch.models.weatherbert import (
    SimMTM,
    WeatherAutoencoder,
    WeatherBERT,
)
from weathermodel_tpu_torch.models.weatherformer import (
    WeatherFormer,
    WeatherFormerMixture,
    WeatherFormerSinusoid,
)
from weathermodel_tpu_torch.utils.config import ModelConfig

logger = logging.getLogger(__name__)

PORTED_MODELS = {
    "weatherbert": WeatherBERT,
    "weatherformer": WeatherFormer,
    "weatherformersinusoid": WeatherFormerSinusoid,
    "weatherformermixture": WeatherFormerMixture,
    "weatherautoencoder": WeatherAutoencoder,
    "simmtm": SimMTM,
}
# models of the JAX package that the port does not have yet
UNPORTED_MODELS = ("mlp", "weathercnn")
# CLI model name -> the trainer's key (weathermodel_tpu/cli/pretrain.py:161-170)
TRAINER_KEY = {"weatherformersinusoid": "weatherformer_sinusoid",
               "weatherformermixture": "weatherformer_mixture"}

# flags of the JAX entry point whose feature the port does not have yet
_UNPORTED = {
    "resume_from_checkpoint": "resume from a full train-state checkpoint "
                              "(ROADMAP.md queue A item 7)",
    "use_optimal_lr": "the LR range test (ROADMAP.md queue A item 10)",
    "remat": "layer rematerialization (ROADMAP.md queue A item 14)",
    "seq_parallel": "sequence parallelism (ROADMAP.md queue A item 14)",
    "pipeline_stages": "pipeline parallelism (ROADMAP.md queue A item 14)",
    "pipeline_microbatches": "pipeline parallelism (ROADMAP.md queue A "
                             "item 14)",
    "tensor_parallel": "tensor parallelism (ROADMAP.md queue A item 14)",
    "fsdp": "FSDP sharding (ROADMAP.md queue A item 14)",
    "moe_experts": "the MoE FFN (ROADMAP.md queue A item 12)",
    "moe_top_k": "the MoE FFN (ROADMAP.md queue A item 12)",
    "moe_dispatch": "the MoE FFN (ROADMAP.md queue A item 12)",
    "moe_capacity_factor": "the MoE FFN (ROADMAP.md queue A item 12)",
    "moe_remat": "the MoE FFN (ROADMAP.md queue A item 12)",
    "prng": "JAX's PRNG choice; the port draws from torch.Generator "
            "(ROADMAP.md queue A item 14)",
}


def make_model(name: str, cfg: ModelConfig, attention_impl: str,
               ffn_impl: str = "torch", num_experts: int = 0):
    if name in UNPORTED_MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported yet; see ROADMAP.md queue A "
            "items 8 (mlp) and 11 (weathercnn)")
    if name not in PORTED_MODELS:
        raise ValueError(f"Unknown model type: {name}. Choose one of "
                         + ", ".join((*PORTED_MODELS, *UNPORTED_MODELS)))
    return PORTED_MODELS[name](cfg, attention_impl=attention_impl,
                               ffn_impl=ffn_impl, num_experts=num_experts)


def load_pretrained_params(path: str) -> dict:
    """State dict of a reference torch checkpoint (.pth / .pt)."""
    if path.endswith((".pth", ".pt")):
        return load_reference_checkpoint(path)
    raise NotImplementedError(
        f"{path} is not a .pth/.pt file. Orbax checkpoint directories (the "
        "JAX trainer's output) cannot be read without JAX; see ROADMAP.md "
        "queue A item 16")


def resolve_device(device: str) -> torch.device:
    """The device an entry point runs on: `cuda` (the default) needs a
    card, and without one the entry point exits; `cpu` is asked for."""
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu "
                         "to run on the CPU")
    return torch.device(device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", default="weatherformer",
                   help="one of: " + ", ".join(PORTED_MODELS)
                        + " (mlp and weathercnn are not ported yet)")
    p.add_argument("--resume-from-checkpoint", default=None,
                   help="not ported yet")
    p.add_argument("--pretrained-model-path", default=None,
                   help="reference-format .pth to initialise from")
    p.add_argument("--batch-size", default=256, type=int)
    p.add_argument("--n-masked-features", default=10, type=int)
    p.add_argument("--n-epochs", default=100, type=int)
    p.add_argument("--init-lr", default=5e-4, type=float)
    p.add_argument("--use-optimal-lr", action="store_true",
                   help="not ported yet")
    p.add_argument("--n-warmup-epochs", default=10, type=int)
    p.add_argument("--decay-factor", default=0.99, type=float)
    p.add_argument("--model-size", default="small",
                   help="mini (60K), small (2M), medium (8M), large (56M)")
    p.add_argument("--masking-prob", default=0.30, type=float)
    p.add_argument("--n-mixture-components", default=1, type=int,
                   help="prior components k; 1 keeps the model's default "
                        "(sinusoid 4, mixture 7)")
    p.add_argument("--beta", default=0.5, type=float,
                   help="KL weight of the ELBO objectives")
    p.add_argument("--freqs", default="weekly",
                   help="comma-separated granularities to stream together "
                        "(daily,weekly,monthly)")
    p.add_argument("--data-dir", default=None,
                   help="chunk-store root (default: WEATHERMODEL_DATA_DIR)")
    p.add_argument("--workdir", default="checkpoints/pretraining")
    p.add_argument("--attention-impl", default="auto",
                   choices=("auto", "fused_qkv", "flash", "torch"),
                   help="auto = the fused QKV CUDA kernels at medium/large, "
                        "the flash attention kernels on separate q, k, v at "
                        "mini/small (their plain PyTorch versions on the "
                        "CPU); torch = plain attention")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--grad-accum", default=1, type=int,
                   help="split each batch into N microbatches and apply one "
                        "update with the mean gradient")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) needs a card; cpu runs the kernels' "
                        "plain versions")
    for flag in ("--remat", "--fsdp", "--moe-remat"):
        p.add_argument(flag, action="store_true", help="not ported yet")
    for flag, default in (("--seq-parallel", 1), ("--pipeline-stages", 1),
                          ("--pipeline-microbatches", 4),
                          ("--tensor-parallel", 1), ("--moe-experts", 0),
                          ("--moe-top-k", 2)):
        p.add_argument(flag, default=default, type=int, help="not ported yet")
    p.add_argument("--moe-dispatch", default="ragged",
                   choices=("sort", "ragged", "scatter"),
                   help="not ported yet")
    p.add_argument("--moe-capacity-factor", default=1.25, type=float,
                   help="not ported yet")
    p.add_argument("--prng", default="rbg", choices=("rbg", "threefry2x32"),
                   help="not ported (JAX only)")
    return p


def run(args: argparse.Namespace) -> dict:
    from weathermodel_tpu_torch.data.pretraining import (
        PretrainDataConfig,
        pretrain_batches,
    )
    from weathermodel_tpu_torch.ops.attention import resolve_attention_impl
    from weathermodel_tpu_torch.train.trainer import PretrainTrainer
    from weathermodel_tpu_torch.utils import constants
    from weathermodel_tpu_torch.utils.config import (
        TrainConfig,
        model_config_for_size,
    )

    defaults = build_parser().parse_args([])
    for flag, what in _UNPORTED.items():
        if getattr(args, flag) != getattr(defaults, flag):
            raise SystemExit(f"--{flag.replace('_', '-')}: {what} is not "
                             "ported to weathermodel_tpu_torch yet")
    device = resolve_device(args.device)
    k = args.n_mixture_components
    if args.model == "weatherformersinusoid" and k == 1:
        k = 4  # the model's default (reference weatherformer_sinusoid.py:22)
    if args.model == "weatherformermixture" and k == 1:
        k = 7  # reference weatherformer_mixture.py:24
    mcfg = model_config_for_size(args.model_size, k=k,
                                 compute_dtype=args.compute_dtype)
    tcfg = TrainConfig(
        batch_size=args.batch_size,
        num_epochs=args.n_epochs,
        init_lr=args.init_lr,
        num_warmup_epochs=int(args.n_warmup_epochs),
        decay_factor=args.decay_factor,
        masking_prob=args.masking_prob,
        n_masked_features=args.n_masked_features,
        beta=args.beta,
    )
    dcfg = PretrainDataConfig(
        data_dir=args.data_dir or constants.DATA_DIR,
        batch_size=args.batch_size,
        freqs=tuple(f.strip() for f in args.freqs.split(",") if f.strip()),
    )

    def make_loaders(split, shuffle, seed):
        return pretrain_batches(split, dcfg, shuffle=shuffle, seed=seed)

    attention_impl = resolve_attention_impl(args.attention_impl,
                                            args.model_size)
    model = make_model(args.model, mcfg, attention_impl)
    pretrained = None
    if args.pretrained_model_path:
        pretrained = load_pretrained_params(args.pretrained_model_path)
    trainer = PretrainTrainer(
        model, TRAINER_KEY.get(args.model, args.model), mcfg, tcfg,
        make_loaders, workdir=args.workdir,
        device=device, pretrained_state=pretrained,
        grad_accum=args.grad_accum)
    return trainer.train()


def main():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args()
    logger.info("Command-line arguments:")
    for k, v in vars(args).items():
        logger.info("%s: %s", k, v)
    result = run(args)
    logger.info("Training complete: best val loss %.6f",
                result["best_val_loss"])


if __name__ == "__main__":
    sys.exit(main())
