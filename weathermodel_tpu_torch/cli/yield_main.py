"""Crop-yield entry point, `wm-yield-torch` (port of
weathermodel_tpu/cli/yield_main.py; reference `src/crop_yield/yield_main.py:
12-253`): the same flags and defaults, the same model dispatch, k-fold
cross-validation over the fold -> test-year tables (or one `--test-year`),
and the RMSE-bu/acre + R^2 aggregation, on one CUDA device unless
`--device cpu` is given. With no flags it fine-tunes WeatherFormer-small
with the ELBO (beta 1e-4), batch 64, fp32, `--attention-impl auto`, which
resolves as the JAX CLI does (mode "train"): the flash attention kernels
B3f/B3b at mini/small, the fused QKV kernels B1/B2 at medium/large.

    wm-yield-torch --country synthetic --n-train-years 15 --test-year 2016 \\
        --n-epochs 2 --pretrained-model-path run/best.pth

`--pretrained-model-path` reads a reference-format `.pth` (what
`wm-pretrain-torch` writes). `--workdir` gets, per fold, the best
parameters as `best.pth` and `yield_output.json`. The baselines: `--model
cnnrnn` trains the Khaki CNN-RNN (models/cnn.py) on the weekly frame and its
soil, `--model gnnrnn` the GraphSAGE + LSTM model over the county graph
(models/gnn.py, train/gnn_trainer.py: one full-graph step per target year,
fp32) and `--model chronos` the chronos-bolt-tiny encoder under a yield
head (models/chronos.py, fp32, from its seeded init: a chronos-bolt
checkpoint is not in this repository). gnnrnn ignores `--compute-dtype`,
`--beta` and `--pretrained-model-path`, as the JAX CLI does. The JAX-only
`--prng` exits naming its ROADMAP.md item.
"""

import argparse
import logging

from weathermodel_tpu_torch.utils.config import (
    TrainConfig,
    model_config_for_size,
)

logger = logging.getLogger(__name__)

YIELD_MODELS = (
    "weatherbert", "weatherformer", "weatherformersinusoid",
    "weatherformermixture", "weatherautoencoder", "weatherautoencodersine",
    "weatherautoencodermixture", "simmtm", "linear", "cnnrnn", "gnnrnn",
    "chronos",
)
# The reference grid search offers --model weatherautoencodersinusoid while
# its yield CLI dispatches only "weatherautoencodersine"; both are accepted,
# as in the JAX CLI.
MODEL_ALIASES = {"weatherautoencodersinusoid": "weatherautoencodersine"}


def model_table():
    """Model name -> (yield model class, objective), for the models that
    go through YieldCrossValidator (gnnrnn has its own, as in the JAX
    CLI)."""
    from weathermodel_tpu_torch.models.chronos import ChronosYieldModel
    from weathermodel_tpu_torch.models.cnn import CNNRNNYieldModel
    from weathermodel_tpu_torch.models.yield_models import (
        LinearYieldModel,
        WeatherAutoencoderMixtureYieldModel,
        WeatherAutoencoderSineYieldModel,
        WeatherBERTYieldModel,
        WeatherFormerMixtureYieldModel,
        WeatherFormerSinusoidYieldModel,
        WeatherFormerYieldModel,
    )

    return {
        "weatherbert": (WeatherBERTYieldModel, "mse"),
        "weatherautoencoder": (WeatherBERTYieldModel, "mse"),
        "simmtm": (WeatherBERTYieldModel, "mse"),
        "weatherformer": (WeatherFormerYieldModel, "elbo"),
        "weatherformersinusoid": (WeatherFormerSinusoidYieldModel,
                                  "elbo_sinusoid"),
        "weatherformermixture": (WeatherFormerMixtureYieldModel,
                                 "elbo_mixture"),
        "weatherautoencodersine": (WeatherAutoencoderSineYieldModel,
                                   "elbo_sinusoid"),
        "weatherautoencodermixture": (WeatherAutoencoderMixtureYieldModel,
                                      "elbo_mixture"),
        "linear": (LinearYieldModel, "mse"),
        "cnnrnn": (CNNRNNYieldModel, "mse"),
        "chronos": (ChronosYieldModel, "mse"),
    }


def check_model(name: str) -> str:
    """The canonical model name; raises the JAX CLI's text for an unknown
    name."""
    name = MODEL_ALIASES.get(name, name)
    if name not in YIELD_MODELS:
        raise ValueError(f"Unknown model type: {name}. Choose one of "
                         + ", ".join(YIELD_MODELS))
    return name


def check_prng(prng: str) -> None:
    if prng != "rbg":
        raise SystemExit("--prng: JAX's PRNG choice is not ported; the port "
                         "draws from torch.Generator (ROADMAP.md queue A "
                         "item 14)")


def prior_k(model: str, k: int) -> int:
    """--n-mixture-components 1 keeps the model's own k (sinusoid 4,
    mixture 7), as the JAX CLI does."""
    if model == "weatherformersinusoid" and k == 1:
        return 4
    if model == "weatherformermixture" and k == 1:
        return 7
    return k


def model_factory(name: str, mcfg, attention_impl: str):
    """make_model(n_past_years) for `name`: the port's layers take their
    input widths at construction, so a fold builds its model with the
    n_past_years its data clamped to (flax infers them at init)."""
    model_cls, _ = model_table()[name]

    def make_model(n_past_years: int):
        if name == "linear":
            return model_cls(mcfg, n_past_years, (n_past_years + 1) * 52)
        if name == "cnnrnn":
            return model_cls(mcfg.weather_dim, n_past_years)
        return model_cls(mcfg, n_past_years, attention_impl)

    return make_model


def _run_gnnrnn_cv(args, crop_df, country: str, device) -> dict:
    """GNN-RNN through the other yield models' cross-validation
    (GNNCrossValidator subclasses YieldCrossValidator): the fold table,
    per-fold best.pth and yield_output.json, the LR range test and the
    RMSE/R^2 aggregation are shared."""
    from weathermodel_tpu_torch.models.gnn import GNNRNNYieldModel
    from weathermodel_tpu_torch.train.gnn_trainer import GNNCrossValidator

    tcfg = TrainConfig(
        batch_size=args.batch_size, num_epochs=args.n_epochs,
        init_lr=args.init_lr, num_warmup_epochs=args.n_warmup_epochs,
        decay_factor=args.decay_factor, seed=args.seed,
        use_optimal_lr=args.use_optimal_lr)
    cv = GNNCrossValidator(
        make_model=lambda n_past: GNNRNNYieldModel(n_past_years=n_past),
        model_cfg=None, train_cfg=tcfg, objective="mse", crop_df=crop_df,
        country=country, crop_type=args.crop_type,
        n_train_years=args.n_train_years, n_past_years=args.n_past_years,
        test_type=args.test_type, k_folds=args.cross_validation_k,
        workdir=args.workdir, test_year=args.test_year, device=device)
    results = cv.run()
    results["trainers"] = cv.trainers
    return results


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", default="weatherformer",
                   help="one of: " + ", ".join(YIELD_MODELS))
    p.add_argument("--batch-size", default=64, type=int)
    p.add_argument("--n-past-years", default=6, type=int)
    p.add_argument("--n-epochs", default=40, type=int)
    p.add_argument("--init-lr", default=5e-4, type=float)
    p.add_argument("--decay_factor", "--decay-factor", dest="decay_factor",
                   default=None, type=float)
    p.add_argument("--n-warmup-epochs", default=10, type=int)
    p.add_argument("--pretrained-model-path", default=None,
                   help="reference-format encoder .pth to initialise from")
    p.add_argument("--model-size", default="small")
    p.add_argument("--n-train-years", default=5, type=int)
    p.add_argument("--beta", default=1e-4, type=float)
    p.add_argument("--n-mixture-components", default=1, type=int)
    p.add_argument("--crop-type", default="soybean")
    p.add_argument("--country", default="usa")
    p.add_argument("--test-type", default="extreme",
                   choices=("overall", "extreme", "ahead_pred"),
                   help="extreme (per-country/crop extreme-year table, the "
                        "reference default), overall (2014-18), or "
                        "ahead_pred (2014-18, test_gap=4)")
    p.add_argument("--test-year", default=None, type=int,
                   help="pin a single test year (one fold) instead of the "
                        "test-type fold table")
    p.add_argument("--cross-validation-k", default=5, type=int)
    p.add_argument("--use-optimal-lr", action="store_true",
                   help="run the LR range test before training each fold")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--attention-impl", default="auto",
                   choices=("auto", "flash", "fused_qkv", "torch"),
                   help="auto = the flash attention kernels at mini/small, "
                        "the fused QKV kernels at medium/large (their plain "
                        "PyTorch versions on the CPU); torch = plain "
                        "attention")
    p.add_argument("--compute-dtype", default="float32",
                   choices=("bfloat16", "float32"))
    p.add_argument("--seed", default=1234, type=int)
    p.add_argument("--workdir", default=None,
                   help="save per-fold best params + yield_output.json here")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) needs a card; cpu runs the kernels' "
                        "plain versions")
    p.add_argument("--prng", default="rbg", choices=("rbg", "threefry2x32"),
                   help="not ported (JAX only)")
    return p


def run(args) -> dict:
    """The aggregated CV dict (reference yield_main.py:230-253 contract).
    A frame passed as `args.crop_df` replaces the one the flags name."""
    from weathermodel_tpu_torch.cli.pretrain import (
        load_pretrained_params,
        resolve_device,
    )
    from weathermodel_tpu_torch.data.yield_data import (
        read_non_us_dataset,
        read_usa_dataset,
        synthetic_yield_df,
    )
    from weathermodel_tpu_torch.ops.attention import resolve_attention_impl
    from weathermodel_tpu_torch.train.yield_trainer import YieldCrossValidator
    from weathermodel_tpu_torch.utils import constants

    args.model = check_model(args.model)
    check_prng(args.prng)
    device = resolve_device(args.device)
    data_dir = args.data_dir or constants.DATA_DIR
    if getattr(args, "crop_df", None) is not None:
        crop_df = args.crop_df  # injected (grid search / tests)
    elif args.country.lower() == "usa":
        crop_df = read_usa_dataset(data_dir)
    elif args.country.lower() == "synthetic":
        crop_df = synthetic_yield_df(seed=args.seed)
    else:
        crop_df = read_non_us_dataset(data_dir, args.country.lower())

    seq_len = (args.n_past_years + 1) * 52
    mcfg = model_config_for_size(
        args.model_size, k=prior_k(args.model, args.n_mixture_components),
        max_len=seq_len, compute_dtype=args.compute_dtype)
    tcfg = TrainConfig(
        batch_size=args.batch_size,
        num_epochs=args.n_epochs,
        init_lr=args.init_lr,
        num_warmup_epochs=args.n_warmup_epochs,
        decay_factor=args.decay_factor,
        beta=args.beta,
        use_optimal_lr=args.use_optimal_lr,
        seed=args.seed,
    )

    # synthetic data standardizes like USA (in-dataset z-score), but its
    # folds must not come from USA's extreme-year table, whose first year
    # predates the synthetic corpus: --test-type extreme falls back to the
    # overall fold years, as in the JAX CLI
    country = ("usa" if args.country.lower() == "synthetic"
               else args.country.lower())
    if args.country.lower() == "synthetic" and args.test_type == "extreme":
        args.test_type = "overall"

    if args.model == "gnnrnn":
        results = _run_gnnrnn_cv(args, crop_df, country, device)
        logger.info("Final average best RMSE for %s: %.3f +/- %.3f",
                    args.crop_type, results["avg_rmse_bu_acre"],
                    results["std_rmse_bu_acre"])
        return results

    _, objective = model_table()[args.model]
    attention_impl = resolve_attention_impl(args.attention_impl,
                                            args.model_size)
    pretrained = None
    if args.pretrained_model_path:
        pretrained = load_pretrained_params(args.pretrained_model_path)

    cv = YieldCrossValidator(
        make_model=model_factory(args.model, mcfg, attention_impl),
        model_cfg=mcfg, train_cfg=tcfg, objective=objective,
        crop_df=crop_df, country=country, crop_type=args.crop_type,
        n_train_years=args.n_train_years, n_past_years=args.n_past_years,
        test_type=args.test_type, k_folds=args.cross_validation_k,
        pretrained_state=pretrained, workdir=args.workdir,
        test_year=args.test_year, device=device)
    results = cv.run()
    results["trainers"] = cv.trainers
    logger.info("Final average best RMSE for %s: %.3f +/- %.3f",
                args.crop_type, results["avg_rmse_bu_acre"],
                results["std_rmse_bu_acre"])
    logger.info("Final average R^2 for %s: %.3f +/- %.3f", args.crop_type,
                results["avg_r_squared"], results["std_r_squared"])
    return results


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    return run(build_parser().parse_args(argv))


def cli() -> None:
    """Console-script entry: setuptools does sys.exit(fn()), so the result
    of main() must not become the process exit code."""
    main()


if __name__ == "__main__":
    cli()
