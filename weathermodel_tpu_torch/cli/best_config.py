"""Best-config re-tests, `wm-best-config-torch` (port of
weathermodel_tpu/cli/best_config.py; reference
`src/crop_yield/best_config_tests.py:54-330`): read a grid-search TSV, pick
the config with the highest mean R^2, re-run it with test_type 'overall'
(at 15 and 30 train years) and 'ahead_pred' (15), appending result rows
immediately per run (HPC-safe)."""

import argparse
import logging
import os
from typing import Dict, List

from weathermodel_tpu_torch.cli.grid_search import TSV_COLUMNS, append_row

logger = logging.getLogger(__name__)


def read_rows(tsv_path: str) -> List[Dict]:
    rows = []
    with open(tsv_path) as f:
        header = f.readline().rstrip("\n").split("\t")
        for line in f:
            rows.append(dict(zip(header, line.rstrip("\n").split("\t"))))
    return rows


def pick_best_config(tsv_path: str) -> Dict:
    """argmax of mean R^2 over complete cells (reference :54-98)."""
    best, best_r2 = None, float("-inf")
    for row in read_rows(tsv_path):
        if "±" not in row.get("r2", ""):
            continue
        r2 = float(row["r2"].split("±")[0].strip())
        if r2 > best_r2:
            best, best_r2 = row, r2
    if best is None:
        raise ValueError(f"no complete cells in {tsv_path}")
    logger.info("Best config: r2=%.4f %s", best_r2, best)
    return best


def run_best_config_tests(tsv_path: str, base_args, out_path: str) -> None:
    from weathermodel_tpu_torch.cli.yield_main import run as yield_run

    best = pick_best_config(tsv_path)
    configs = [
        ("overall", 15), ("overall", 30), ("ahead_pred", 15),
    ]
    for test_type, n_train_years in configs:
        args = argparse.Namespace(**vars(base_args))
        args.beta = float(best["beta"])
        args.batch_size = int(best["batch_size"])
        args.init_lr = float(best["init_lr"])
        args.n_train_years = n_train_years
        args.test_type = test_type
        try:
            res = yield_run(args)
            row = {c: best.get(c, "") for c in TSV_COLUMNS}
            row.update({
                "test_type": test_type, "n_train_years": n_train_years,
                "rmse": (f'{res["avg_rmse_bu_acre"]:.4f} ± '
                         f'{res["std_rmse_bu_acre"]:.4f}'),
                "r2": (f'{res["avg_r_squared"]:.4f} ± '
                       f'{res["std_r_squared"]:.4f}'),
                "status": "OK",
            })
        except Exception as e:
            row = {c: best.get(c, "") for c in TSV_COLUMNS}
            row.update({"test_type": test_type,
                        "n_train_years": n_train_years,
                        "rmse": "FAILED", "r2": "FAILED",
                        "status": f"FAILED: {type(e).__name__}"})
        append_row(out_path, row)  # appended immediately (HPC-safe)


def grid_search_tsv_path(results_dir: str, model: str, crop_type: str,
                         country: str, test_type: str,
                         pretrained: bool) -> str:
    """Derive the sweep's TSV path from its identifying flags — the
    reference's get_grid_search_file_path convention
    (best_config_tests.py:263-267, 280-283) mapped onto our grid-search
    file naming (cli/grid_search.py GridSearch.__init__)."""
    tag = f"{model}_{crop_type}_{country}_{test_type}"
    if pretrained:
        tag += "_pretrained"
    return os.path.join(results_dir, f"grid_search_{tag}.tsv")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    from weathermodel_tpu_torch.cli.yield_main import build_parser as yield_parser

    p = yield_parser()
    p.add_argument("--grid-tsv", default=None,
                   help="explicit grid-search TSV; when omitted the path is "
                        "derived from --grid-search-results-dir + the "
                        "model/crop/country/test-type flags (reference "
                        "best_config_tests.py convention)")
    p.add_argument("--grid-search-results-dir", default="data/grid_search",
                   help="where the grid-search sweep wrote its TSVs "
                        "(reference best_config_tests.py --grid-search-"
                        "results-dir)")
    p.add_argument("--load-pretrained", action="store_true",
                   help="the sweep being consumed was run with "
                        "--load-pretrained (its TSV carries the "
                        "_pretrained tag)")
    p.add_argument("--out-path", default="data/best_config_tests/results.tsv")
    args = p.parse_args(argv)
    tsv = args.grid_tsv or grid_search_tsv_path(
        args.grid_search_results_dir, args.model, args.crop_type,
        args.country, args.test_type,
        bool(args.load_pretrained or args.pretrained_model_path))
    os.makedirs(os.path.dirname(args.out_path), exist_ok=True)
    run_best_config_tests(tsv, args, args.out_path)


if __name__ == "__main__":
    main()
