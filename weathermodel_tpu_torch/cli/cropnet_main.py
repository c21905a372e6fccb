"""CropNet entry point, `wm-cropnet-torch` (port of
weathermodel_tpu/cli/cropnet_main.py; reference
`src/crop_yield/cropnet_main.py:182-260`): a per-crop loop over
Cotton/Corn/Soybeans/WinterWheat (or one `--crop-type`), a single fold (k =
1) with test year 2021, per-crop try/except so one failure does not kill
the run, and an RMSE summary in original units. `--country synthetic`
trains on the in-repo synthetic CropNet frame.

Unlike the JAX CLI, `--attention-impl auto` is resolved before the model
is built (as `wm-yield` resolves it): the JAX CLI passes it on unresolved,
so with its defaults every crop fails and is reported FAILED. As in the JAX
CLI, `--model gnnrnn` has no CropNet path: the model table lacks it, so
every crop logs the KeyError and is reported FAILED, and the exit code is
0; `--model chronos` trains.
"""

import logging
from typing import Dict, Optional, Tuple

from weathermodel_tpu_torch.utils.config import (
    TrainConfig,
    model_config_for_size,
)

logger = logging.getLogger(__name__)


def build_parser():
    from weathermodel_tpu_torch.cli.yield_main import build_parser as yp

    p = yp()
    # the reference cropnet_main.py defaults: mini models over 3 past / 4
    # train years with a 0.95 decay and k=3 mixture components
    p.set_defaults(crop_type=None, n_train_years=4, n_past_years=3,
                   model_size="mini", decay_factor=0.95,
                   n_mixture_components=3)
    return p


def train_single_crop(crop_type: str, args) -> Tuple[float, float]:
    from weathermodel_tpu_torch.cli.pretrain import (
        load_pretrained_params,
        resolve_device,
    )
    from weathermodel_tpu_torch.cli.yield_main import (
        check_model,
        check_prng,
        model_factory,
        model_table,
        prior_k,
    )
    from weathermodel_tpu_torch.data.cropnet_data import (
        CROPNET_TEST_YEAR,
        get_cropnet_train_test_arrays,
        read_cropnet_dataset,
        synthetic_cropnet_df,
    )
    from weathermodel_tpu_torch.ops.attention import resolve_attention_impl
    from weathermodel_tpu_torch.train.yield_trainer import YieldTrainer
    from weathermodel_tpu_torch.utils import constants

    model = check_model(args.model)
    check_prng(args.prng)
    device = resolve_device(args.device)
    if getattr(args, "cropnet_df", None) is not None:
        df = args.cropnet_df
    elif args.country.lower() == "synthetic":
        df = synthetic_cropnet_df(seed=args.seed)
    else:
        df = read_cropnet_dataset(args.data_dir or constants.DATA_DIR)

    train_arr, test_arr, stats, n_past = get_cropnet_train_test_arrays(
        df, crop_type, args.n_train_years, CROPNET_TEST_YEAR,
        args.n_past_years)

    seq_len = (n_past + 1) * 52
    mcfg = model_config_for_size(
        args.model_size, k=prior_k(model, args.n_mixture_components),
        max_len=seq_len, compute_dtype=args.compute_dtype)
    tcfg = TrainConfig(
        batch_size=args.batch_size, num_epochs=args.n_epochs,
        init_lr=args.init_lr, num_warmup_epochs=args.n_warmup_epochs,
        decay_factor=args.decay_factor, beta=args.beta,
        use_optimal_lr=args.use_optimal_lr, seed=args.seed)
    _, objective = model_table()[model]
    attention_impl = resolve_attention_impl(args.attention_impl,
                                            args.model_size)
    pretrained = None
    if args.pretrained_model_path:
        pretrained = load_pretrained_params(args.pretrained_model_path)

    trainer = YieldTrainer(
        model_factory(model, mcfg, attention_impl)(n_past), mcfg, tcfg,
        objective, train_arr, test_arr, n_past, pretrained_state=pretrained,
        device=device)
    best_norm_rmse = trainer.train()
    rmse = best_norm_rmse * stats.std
    logger.info("%s: test RMSE %.3f (original units), normalized %.4f",
                crop_type, rmse, best_norm_rmse)
    return rmse, 0.0  # single fold -> std 0 (reference k=1)


def run(args) -> Dict[str, Optional[Tuple[float, float]]]:
    """crop -> (RMSE in original units, 0.0), or None where its training
    raised (logged, and the loop goes on)."""
    from weathermodel_tpu_torch.data.cropnet_data import CROPNET_CROPS

    crops = [args.crop_type] if args.crop_type else list(CROPNET_CROPS)
    all_results: Dict[str, Optional[Tuple[float, float]]] = {}
    for crop in crops:
        try:
            logger.info("=" * 50)
            logger.info("Training %s", crop)
            all_results[crop] = train_single_crop(crop, args)
        except Exception as e:  # continue other crops (reference :236-238)
            logger.exception("Failed to train %s: %s", crop, e)
            all_results[crop] = None
    logger.info("=" * 60)
    logger.info("CROPNET TRAINING SUMMARY")
    for crop, result in all_results.items():
        if result is not None:
            logger.info("%s: RMSE = %.3f ± %.3f", crop, result[0], result[1])
        else:
            logger.info("%s: FAILED", crop)
    return all_results


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    return run(build_parser().parse_args(argv))


def cli() -> None:
    """Console-script entry: the result of main() must not become the
    process exit code."""
    main()


if __name__ == "__main__":
    cli()
