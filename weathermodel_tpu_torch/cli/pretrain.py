"""Pretraining entry point, `wm-pretrain-torch` (port of
weathermodel_tpu/cli/pretrain.py): the same flag names and defaults for the
ported features, the WeatherBERT family with the masked-MSE objective and
the WeatherFormer family with the ELBO objectives, on one CUDA device
unless `--device cpu` is given. With no flags it trains what `wm-pretrain`
does: WeatherFormer-small, ELBO with beta 0.5, 10 masked features.
`--moe-experts N` swaps every layer's FFN for a top-k routed expert FFN
with the dropless ragged dispatch (the grouped-matmul kernels B4/B4t), or
with `--moe-dispatch sort|scatter` a capacity layout of
`--moe-capacity-factor` (over-capacity tokens drop); `--moe-remat`
recomputes the expert computation in the backward. Without experts these
three are ignored, as in `wm-pretrain`.

    wm-pretrain-torch --data-dir data/ --workdir run/
    wm-pretrain-torch --model weatherbert --model-size large \\
        --batch-size 576 --grad-accum 2 --data-dir data/ --workdir run/
    wm-pretrain-torch --model weatherbert --model-size large \\
        --moe-experts 8 --moe-top-k 2 --batch-size 288 --grad-accum 3 \\
        --data-dir data/ --workdir run/
    wm-pretrain-torch --model weatherbert --model-size large \\
        --moe-experts 8 --moe-dispatch sort --moe-remat \\
        --batch-size 288 --grad-accum 3 --data-dir data/ --workdir run/

It writes `{workdir}/{model}_output.json` every epoch, the best
parameters as a reference-format `{workdir}/best.pth`, which
`wm-serve-torch --checkpoint` serves, and full train-state checkpoints
under `{workdir}/checkpoints/{epoch}/` (train/checkpoint.py). SIGTERM stops
a run at the next step boundary with a checkpoint of the state inside the
epoch; `--resume-from-checkpoint` continues it from `--workdir`, bitwise as
if it had not stopped:

    wm-pretrain-torch --data-dir data/ --workdir run/ \
        --resume-from-checkpoint run/

`--remat` recomputes each encoder layer in the backward instead of keeping
its activations (not with `--moe-experts`, as in wm-pretrain).

Under `torchrun` the ranks train one model on a (data, model) mesh
(parallel/): `--tensor-parallel N` puts N ranks on 'model' and the rest on
'data'; without it every rank is on 'data'. Over 'model' the MoE experts
split (expert parallelism, every `--moe-dispatch`) and so does the storage
of the dense attention and FFN weights (gathered for their use). `--fsdp`
splits every large parameter, and its Adam moments, over 'data' too
(ZeRO-3; alone, a world x 1 mesh). Every rank reads the same batches and
keeps its rows of each; rank 0 logs and writes. `--device cuda`
gives each rank its own card (cuda:LOCAL_RANK, NCCL); `--device cuda:0`
pins every rank to card 0 (gloo: ranks that share a card); `--device cpu`
runs the ranks on the CPU (gloo):

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m weathermodel_tpu_torch.cli.pretrain --model weatherbert \
        --model-size large --moe-experts 8 --moe-top-k 2 \
        --tensor-parallel 2 --batch-size 288 --data-dir data/ --workdir run/
    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m weathermodel_tpu_torch.cli.pretrain --model weatherbert \
        --model-size large --fsdp --remat --batch-size 576 \
        --grad-accum 2 --data-dir data/ --workdir run/

`--model mlp` trains the per-timestep MLP baseline (models/mlp.py) and
`--model weathercnn` the CNN baseline's masked-MSE pretraining
(models/cnn.py, in fp32; neither takes `--moe-experts`). The
module also holds `make_model` and `load_pretrained_params`, which the
serving path shares. Flags of the JAX entry point whose feature is not
ported exit non-zero when set, naming their ROADMAP.md item.
"""

import argparse
import logging
import os
import sys

import torch

from weathermodel_tpu_torch.models.cnn import WeatherCNNPretrain
from weathermodel_tpu_torch.models.mlp import WeatherMLP
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
from weathermodel_tpu_torch.parallel import multihost
from weathermodel_tpu_torch.utils.config import ModelConfig

logger = logging.getLogger(__name__)

PORTED_MODELS = {
    "weatherbert": WeatherBERT,
    "weatherformer": WeatherFormer,
    "weatherformersinusoid": WeatherFormerSinusoid,
    "weatherformermixture": WeatherFormerMixture,
    "weatherautoencoder": WeatherAutoencoder,
    "simmtm": SimMTM,
    "mlp": WeatherMLP,
    "weathercnn": WeatherCNNPretrain,
}
# models without a transformer encoder trunk
# (weathermodel_tpu/cli/pretrain.py:200-206)
NO_ENCODER_MODELS = ("mlp", "weathercnn")
# CLI model name -> the trainer's key (weathermodel_tpu/cli/pretrain.py:161-170)
TRAINER_KEY = {"weatherformersinusoid": "weatherformer_sinusoid",
               "weatherformermixture": "weatherformer_mixture"}

# flags of the JAX entry point whose feature the port does not have yet
_UNPORTED = {
    "seq_parallel": "sequence parallelism (ROADMAP.md queue A item 14)",
    "pipeline_stages": "pipeline parallelism (ROADMAP.md queue A item 14)",
    "pipeline_microbatches": "pipeline parallelism (ROADMAP.md queue A "
                             "item 14)",
    "prng": "JAX's PRNG choice; the port draws from torch.Generator "
            "(ROADMAP.md queue A item 14)",
}


def check_parallel_flags(args: argparse.Namespace) -> None:
    """The JAX trainer's checks of the parallel flags, with its error text
    (weathermodel_tpu/train/trainer.py:92-101,143-152), made before the
    unported flags exit: the combinations JAX refuses raise what JAX
    raises."""
    sp, pp, tp = args.seq_parallel, args.pipeline_stages, args.tensor_parallel
    if (sp > 1) + (pp > 1) + (tp > 1) > 1:
        raise ValueError(
            "--seq-parallel, --pipeline-stages and --tensor-parallel "
            "claim the same mesh 'model' axis and are mutually "
            "exclusive")
    if args.fsdp and (sp > 1 or pp > 1):
        raise ValueError(
            "--fsdp cannot combine with --seq-parallel/"
            "--pipeline-stages (use --tensor-parallel for 2-D "
            "sharding)")
    if args.moe_experts > 0 and args.moe_dispatch == "ragged" and sp > 1:
        raise ValueError(
            "--seq-parallel with a ragged-dispatch MoE is not "
            "supported; pass --moe-dispatch sort")


def make_model(name: str, cfg: ModelConfig, attention_impl: str,
               ffn_impl: str = "torch", gmm_impl: str = "kernel",
               remat: bool = False):
    """The model `name` at `cfg` (MoE layers when cfg.num_experts > 0;
    `gmm_impl` "plain" runs their grouped matmuls as the plain versions on
    any device, the reference path; `remat` recomputes each encoder layer
    in the backward, and the models without one ignore it, as JAX's
    `make_model` does)."""
    if name not in PORTED_MODELS:
        raise ValueError(f"Unknown model type: {name}. Choose one of "
                         + ", ".join(PORTED_MODELS))
    if name == "mlp":
        return WeatherMLP(cfg)
    if name == "weathercnn":
        # the JAX package's working redesign of the reference's CNN
        # pretraining (models/cnn.py)
        return WeatherCNNPretrain(cfg.weather_dim, cfg.max_len)
    return PORTED_MODELS[name](cfg, attention_impl=attention_impl,
                               ffn_impl=ffn_impl, gmm_impl=gmm_impl,
                               remat=remat)


def load_pretrained_params(path: str) -> dict:
    """State dict of a reference torch checkpoint (.pth / .pt). The port
    reads no orbax directory (the JAX trainer's output): that would need JAX
    or tensorstore beside the card (ROADMAP.md queue A item 16, decided)."""
    if path.endswith((".pth", ".pt")):
        return load_reference_checkpoint(path)
    raise NotImplementedError(
        f"{path} is not a .pth/.pt file. The port reads no orbax checkpoint "
        "directory (the JAX trainer's output): that would need JAX or "
        "tensorstore on the card's host; see ROADMAP.md queue A item 16 "
        "(decided)")


def resolve_device(device: str) -> torch.device:
    """The device an entry point runs on: `cuda` (the default) or `cuda:N`
    needs a card, and without one the entry point exits; `cpu` is asked
    for."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu "
                         "to run on the CPU")
    return torch.device(device)


def _device_arg(value: str) -> str:
    device = torch.device(value)  # raises on anything torch does not name
    if device.type not in ("cuda", "cpu") or (device.type == "cpu"
                                              and device.index is not None):
        raise argparse.ArgumentTypeError(f"--device must be cuda, cuda:N or "
                                         f"cpu, got {value!r}")
    return value


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", default="weatherformer",
                   help="one of: " + ", ".join(PORTED_MODELS))
    p.add_argument("--resume-from-checkpoint", default=None,
                   help="resume the full train state from --workdir's "
                        "newest checkpoint; as in wm-pretrain, any value "
                        "turns resume on and --workdir is read")
    p.add_argument("--pretrained-model-path", default=None,
                   help="reference-format .pth to initialise from")
    p.add_argument("--batch-size", default=256, type=int)
    p.add_argument("--n-masked-features", default=10, type=int)
    p.add_argument("--n-epochs", default=100, type=int)
    p.add_argument("--init-lr", default=5e-4, type=float)
    p.add_argument("--use-optimal-lr", action="store_true",
                   help="run the LR range test (train/lr_finder.py) on a "
                        "throwaway copy first and train at the LR it finds")
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
    p.add_argument("--device", default="cuda", type=_device_arg,
                   help="cuda (default) needs a card, under torchrun one a "
                        "rank (cuda:LOCAL_RANK); cuda:N pins every rank to "
                        "card N; cpu runs the kernels' plain versions")
    p.add_argument("--moe-experts", default=0, type=int,
                   help="num_experts > 0 swaps the dense FFN for a top-k "
                        "routed Mixture-of-Experts FFN (models/moe.py)")
    p.add_argument("--moe-top-k", default=2, type=int)
    p.add_argument("--moe-dispatch", default="ragged",
                   choices=("sort", "ragged", "scatter"),
                   help="ragged: dropless grouped matmul (B4/B4t); sort: "
                        "stable-argsort capacity layout (gathers); scatter: "
                        "per-row scatter capacity layout; sort and scatter "
                        "compute the same function")
    p.add_argument("--moe-capacity-factor", default=1.25, type=float,
                   help="per-expert capacity = cf * top_k * T / E (sort/"
                        "scatter; over-capacity tokens drop); ragged "
                        "ignores it")
    p.add_argument("--moe-remat", action="store_true",
                   help="recompute the expert computation in the backward "
                        "(torch.utils.checkpoint) instead of saving its "
                        "activations")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize encoder layers in the backward "
                        "(torch.utils.checkpoint: trade FLOPs for memory; "
                        "not with --moe-experts)")
    p.add_argument("--tensor-parallel", default=1, type=int,
                   help="ranks on the mesh's 'model' axis: the MoE experts "
                        "split over them (expert parallelism) and the "
                        "dense attention and FFN weights' storage "
                        "(Megatron column/row, gathered for their use)")
    p.add_argument("--fsdp", action="store_true",
                   help="shard parameters and Adam moments over the mesh's "
                        "'data' axis (ZeRO-3: gathered for each layer's "
                        "use); composes with --tensor-parallel (2-D)")
    for flag, default in (("--seq-parallel", 1), ("--pipeline-stages", 1),
                          ("--pipeline-microbatches", 4)):
        p.add_argument(flag, default=default, type=int, help="not ported yet")
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
    check_parallel_flags(args)
    for flag, what in _UNPORTED.items():
        if getattr(args, flag) != getattr(defaults, flag):
            raise SystemExit(f"--{flag.replace('_', '-')}: {what} is not "
                             "ported to weathermodel_tpu_torch yet")
    if args.moe_experts > 0 and args.model in NO_ENCODER_MODELS:
        # these models have no transformer FFN to replace
        raise ValueError(
            f"--moe-experts is not supported for --model {args.model} "
            "(no transformer encoder trunk)")
    resume = args.resume_from_checkpoint is not None
    if resume and (os.path.abspath(args.resume_from_checkpoint)
                   != os.path.abspath(args.workdir)):
        logger.warning(
            "--resume-from-checkpoint %s: the run resumes from --workdir %s, "
            "as wm-pretrain does; the value only turns resume on",
            args.resume_from_checkpoint, args.workdir)
    if multihost.launched():
        multihost.initialize(args.device)
        device = multihost.rank_device(args.device)
    else:
        device = resolve_device(args.device)
    k = args.n_mixture_components
    if args.model == "weatherformersinusoid" and k == 1:
        k = 4  # the model's default (reference weatherformer_sinusoid.py:22)
    if args.model == "weatherformermixture" and k == 1:
        k = 7  # reference weatherformer_mixture.py:24
    mcfg = model_config_for_size(
        args.model_size, k=k, compute_dtype=args.compute_dtype,
        num_experts=args.moe_experts, moe_top_k=args.moe_top_k,
        moe_remat=args.moe_remat, moe_dispatch=args.moe_dispatch,
        moe_capacity_factor=args.moe_capacity_factor)
    tcfg = TrainConfig(
        batch_size=args.batch_size,
        num_epochs=args.n_epochs,
        init_lr=args.init_lr,
        num_warmup_epochs=int(args.n_warmup_epochs),
        decay_factor=args.decay_factor,
        masking_prob=args.masking_prob,
        n_masked_features=args.n_masked_features,
        beta=args.beta,
        use_optimal_lr=args.use_optimal_lr,
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
    model = make_model(args.model, mcfg, attention_impl, remat=args.remat)
    pretrained = None
    if args.pretrained_model_path:
        pretrained = load_pretrained_params(args.pretrained_model_path)
    trainer = PretrainTrainer(
        model, TRAINER_KEY.get(args.model, args.model), mcfg, tcfg,
        make_loaders, workdir=args.workdir,
        device=device, pretrained_state=pretrained,
        grad_accum=args.grad_accum, resume=resume,
        tensor_parallel=args.tensor_parallel, fsdp=args.fsdp)
    return trainer.train()


def main():
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args()
    logger.info("Command-line arguments:")
    for k, v in vars(args).items():
        logger.info("%s: %s", k, v)
    result = run(args)
    if result.get("preempted"):
        logger.info("Stopped by a signal: resume with "
                    "--resume-from-checkpoint %s", args.workdir)
    else:
        logger.info("Training complete: best val loss %.6f",
                    result["best_val_loss"])


if __name__ == "__main__":
    sys.exit(main())
