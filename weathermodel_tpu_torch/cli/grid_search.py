"""Hyperparameter grid search, `wm-grid-search-torch` (port of
weathermodel_tpu/cli/grid_search.py; reference
`src/crop_yield/grid_search.py:31-533`), on `wm-yield-torch`:

* sweep beta x batch-size x lr x n_train_years (same default grid values,
  grid_search.py:48-53; Mexico uses 10 train years);
* calls the yield CLI's `run()` IN-PROCESS per cell;
* writes a TSV with "mean ± std" cells and a detailed JSON with per-fold
  R^2 values and runtime_seconds;
* crash-tolerant resume: cells already present in the TSV with a "±" are
  skipped (reference :97-130); failed cells record FAILED and the sweep
  continues (reference :191-195).
"""

import argparse
import itertools
import json
import logging
import os
import time
from typing import Dict

logger = logging.getLogger(__name__)

# Reference grid values (grid_search.py:48-53)
BETAS = (0.0, 1e-4, 1e-3)
BATCH_SIZES = (16, 32, 64)
LRS = (2.5e-4, 5e-4, 1e-3)

# --load-pretrained checkpoint convention (reference grid_search.py:14-28
# PRETRAINED_MODEL_PATHS: fixed per-model paths the user's pretraining
# runs are expected to have produced). These point at `wm-pretrain-torch`'s
# best parameters under its workdir ({workdir}/best.pth); as in the JAX
# package, chronos has no pretrained path.
PRETRAINED_MODEL_PATHS = {
    "weatherbert": "checkpoints/pretraining/weatherbert/best.pth",
    "weatherformer": "checkpoints/pretraining/weatherformer/best.pth",
    "weatherautoencoder":
        "checkpoints/pretraining/weatherautoencoder/best.pth",
    "weatherformersinusoid":
        "checkpoints/pretraining/weatherformersinusoid/best.pth",
    "weatherformermixture":
        "checkpoints/pretraining/weatherformermixture/best.pth",
    "weatherautoencodermixture":
        "checkpoints/pretraining/weatherautoencoder/best.pth",
    "weatherautoencodersinusoid":
        "checkpoints/pretraining/weatherautoencoder/best.pth",
    "simmtm": "checkpoints/pretraining/simmtm/best.pth",
    "cnnrnn": None,
    "gnnrnn": None,
    "linear": None,
    "chronos": None,
}

TSV_COLUMNS = ("model", "crop_type", "country", "test_type", "beta",
               "batch_size", "init_lr", "n_train_years", "rmse", "r2",
               "status")


def _cell_key(row: Dict) -> tuple:
    return (str(row["model"]), str(row["crop_type"]), str(row["country"]),
            str(row["test_type"]), f'{float(row["beta"]):g}',
            str(int(row["batch_size"])), f'{float(row["init_lr"]):g}',
            str(int(row["n_train_years"])))


def read_completed(tsv_path: str) -> set:
    """Cells whose rmse column contains '±' count as complete
    (reference resume semantics, grid_search.py:124-130)."""
    done = set()
    if not os.path.exists(tsv_path):
        return done
    with open(tsv_path) as f:
        header = f.readline().rstrip("\n").split("\t")
        for line in f:
            row = dict(zip(header, line.rstrip("\n").split("\t")))
            if "±" in row.get("rmse", ""):
                done.add(_cell_key(row))
    return done


def append_row(tsv_path: str, row: Dict) -> None:
    new = not os.path.exists(tsv_path)
    with open(tsv_path, "a") as f:
        if new:
            f.write("\t".join(TSV_COLUMNS) + "\n")
        f.write("\t".join(str(row[c]) for c in TSV_COLUMNS) + "\n")


class GridSearch:
    def __init__(self, base_args: argparse.Namespace, out_dir: str,
                 betas=BETAS, batch_sizes=BATCH_SIZES, lrs=LRS,
                 n_train_years_list=None):
        self.base = base_args
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        tag = (f"{base_args.model}_{base_args.crop_type}_"
               f"{base_args.country}_{base_args.test_type}")
        if base_args.pretrained_model_path:
            tag += "_pretrained"
        self.tsv_path = os.path.join(out_dir, f"grid_search_{tag}.tsv")
        self.json_path = os.path.join(out_dir, f"grid_search_{tag}.json")
        self.betas = betas
        self.batch_sizes = batch_sizes
        self.lrs = lrs
        if n_train_years_list is None:
            # Mexico has a shorter record (reference grid_search.py:48-53)
            n_train_years_list = (10,) if base_args.country == "mexico" \
                else (15,)
        self.n_train_years_list = n_train_years_list
        self.details: Dict[str, Dict] = {}
        if os.path.exists(self.json_path):
            with open(self.json_path) as f:
                self.details = json.load(f)

    def _run_cell(self, beta, batch_size, lr, n_train_years) -> Dict:
        from weathermodel_tpu_torch.cli.yield_main import run as yield_run

        args = argparse.Namespace(**vars(self.base))
        args.beta = beta
        args.batch_size = batch_size
        args.init_lr = lr
        args.n_train_years = n_train_years
        return yield_run(args)

    def run(self) -> str:
        completed = read_completed(self.tsv_path)
        cells = list(itertools.product(
            self.betas, self.batch_sizes, self.lrs, self.n_train_years_list
        ))
        logger.info("Grid search: %d cells (%d already complete)",
                    len(cells), len(completed))
        for beta, batch_size, lr, n_train_years in cells:
            row = {
                "model": self.base.model, "crop_type": self.base.crop_type,
                "country": self.base.country,
                "test_type": self.base.test_type,
                "beta": beta, "batch_size": batch_size, "init_lr": lr,
                "n_train_years": n_train_years,
            }
            if _cell_key(row) in completed:
                logger.info("skip (complete): %s", _cell_key(row))
                continue
            t0 = time.time()
            try:
                res = self._run_cell(beta, batch_size, lr, n_train_years)
                row["rmse"] = (f'{res["avg_rmse_bu_acre"]:.4f} ± '
                               f'{res["std_rmse_bu_acre"]:.4f}')
                row["r2"] = (f'{res["avg_r_squared"]:.4f} ± '
                             f'{res["std_r_squared"]:.4f}')
                row["status"] = "OK"
                self.details["|".join(_cell_key(row))] = {
                    "r_squared": res["r_squared"],
                    "rmse_bu_acre": res["rmse_bu_acre"],
                    "test_years": res["test_years"],
                    "avg_r_squared": res["avg_r_squared"],
                    "runtime_seconds": time.time() - t0,
                }
            except Exception as e:  # sweep continues (reference :191-195)
                logger.exception("cell failed: %s", e)
                row["rmse"] = "FAILED"
                row["r2"] = "FAILED"
                row["status"] = f"FAILED: {type(e).__name__}"
            append_row(self.tsv_path, row)
            with open(self.json_path, "w") as f:
                json.dump(self.details, f, indent=2)
        return self.tsv_path


def build_parser() -> argparse.ArgumentParser:
    from weathermodel_tpu_torch.cli.yield_main import build_parser as yield_parser

    p = yield_parser()
    p.add_argument("--out-dir", "--output-dir", dest="out_dir",
                   default="data/grid_search",
                   help="directory for TSV/JSON results (reference "
                        "grid_search.py --output-dir)")
    p.add_argument("--load-pretrained", action="store_true",
                   help="initialize each cell from the per-model pretrained "
                        "checkpoint convention (PRETRAINED_MODEL_PATHS; "
                        "reference grid_search.py:14-28,155-165)")
    p.add_argument("--betas", default=None,
                   help="comma-separated override, e.g. 0,1e-4")
    p.add_argument("--grid-batch-sizes", default=None)
    p.add_argument("--grid-lrs", default=None)
    p.add_argument("--grid-n-train-years", default=None)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)

    if getattr(args, "load_pretrained", False) \
            and not args.pretrained_model_path:
        path = PRETRAINED_MODEL_PATHS.get(args.model)
        if path is not None:
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"--load-pretrained: no checkpoint at {path!r} — run "
                    f"wm-pretrain-torch --model {args.model} --workdir "
                    f"{os.path.dirname(path)!r} first, or pass "
                    "--pretrained-model-path explicitly")
            args.pretrained_model_path = path
        else:
            logger.info("--load-pretrained: %s has no pretrained "
                        "checkpoint convention; training from scratch",
                        args.model)

    def parse_list(s, typ):
        return tuple(typ(x) for x in s.split(",")) if s else None

    gs = GridSearch(
        args, args.out_dir,
        betas=parse_list(args.betas, float) or BETAS,
        batch_sizes=parse_list(args.grid_batch_sizes, int) or BATCH_SIZES,
        lrs=parse_list(args.grid_lrs, float) or LRS,
        n_train_years_list=parse_list(args.grid_n_train_years, int),
    )
    path = gs.run()
    logger.info("Grid search TSV: %s", path)
    return path


def cli() -> None:
    """Console-script entry: setuptools does sys.exit(fn()), so the
    programmatic result of main() (dict/path) must not leak into the
    process exit code."""
    main()


if __name__ == "__main__":
    cli()