"""The yield stack's four entry points on the CPU (`--device cpu`, mini, a
small synthetic frame): `wm-yield-torch` (one pinned fold with the LR range
test, and k folds), `wm-cropnet-torch` (its defaults, `--attention-impl auto`
included, and per-crop isolation), `wm-grid-search-torch` (resume, a failed
cell) and `wm-best-config-torch`; an unknown model raises the JAX CLI's
text, the JAX-only `--prng` exits naming its ROADMAP item, CropNet's
`--model gnnrnn` fails every crop as JAX's does, and the entry points want
a card unless asked for the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from weathermodel_tpu_torch.cli import (
    best_config,
    cropnet_main,
    grid_search,
    yield_main,
)
from weathermodel_tpu_torch.data.cropnet_data import synthetic_cropnet_df
from weathermodel_tpu_torch.data.yield_data import synthetic_yield_df
from weathermodel_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_fwd,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.utils import constants

TINY = ["--model-size", "mini", "--n-past-years", "1", "--n-train-years",
        "4", "--n-epochs", "2", "--n-warmup-epochs", "0", "--batch-size",
        "8", "--country", "synthetic"]
RESULT_KEYS = {"fold_results", "avg_best_val_loss", "std_best_val_loss",
               "n_folds", "rmse_bu_acre", "avg_rmse_bu_acre",
               "std_rmse_bu_acre", "r_squared", "avg_r_squared",
               "std_r_squared", "test_years", "details", "trainers"}


@pytest.fixture(scope="module")
def crop_df():
    return synthetic_yield_df(seed=1, n_locs=3)


def _yield_args(crop_df, *extra):
    args = yield_main.build_parser().parse_args(
        TINY + ["--device", "cpu", *extra])
    args.crop_df = crop_df
    return args


def test_defaults_are_the_jax_clis():
    from weathermodel_tpu.cli import cropnet_main as jax_cropnet
    from weathermodel_tpu.cli import yield_main as jax_yield

    for port, jax in ((yield_main, jax_yield), (cropnet_main, jax_cropnet)):
        got = vars(port.build_parser().parse_args([]))
        want = vars(jax.build_parser().parse_args([]))
        for k in ("attention_impl", "device", "compilation_cache_dir"):
            got.pop(k, None)
            want.pop(k, None)
        assert got == want
    assert yield_main.YIELD_MODELS == jax_yield.YIELD_MODELS
    assert yield_main.MODEL_ALIASES == jax_yield.MODEL_ALIASES


def test_one_pinned_fold_with_the_lr_range_test(crop_df, tmp_path,
                                                monkeypatch):
    """WeatherFormer-mini ELBO (the default model and objective) through the
    flash attention's plain versions (`auto` at mini), no kernel launch."""
    monkeypatch.setattr(constants, "DRY_RUN", True)  # 5 finder steps
    before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    result = yield_main.run(_yield_args(
        crop_df, "--test-year", "2016", "--use-optimal-lr", "--workdir",
        str(tmp_path)))
    assert (flash_attention_fwd.launches,
            flash_attention_bwd.launches) == before
    assert set(result) == RESULT_KEYS
    assert result["n_folds"] == 1 and result["test_years"] == [2016]
    assert np.isfinite(result["avg_rmse_bu_acre"])
    (trainer,) = result["trainers"]
    assert trainer.optimal_lr is not None and trainer.optimal_lr >= 1e-4
    assert trainer.model.weather_model.transformer_encoder.layers[
        0].self_attn.attention_impl == "flash"
    fold = tmp_path / "fold_0_year_2016"
    with open(fold / "yield_output.json") as f:
        record = json.load(f)
    assert set(record["losses"]["train"]) == {"total_loss", "yield",
                                              "reconstruction", "kl_term"}
    assert len(record["losses"]["val"]["total_loss"]) == 2
    assert (fold / "best.pth").exists()


def test_k_folds_and_a_pretrained_encoder(crop_df, tmp_path):
    """WeatherBERT-mini over two folds of the overall table, each from the
    same pretrained encoder (a .pth the port wrote), which neither fold
    changes."""
    from weathermodel_tpu_torch.cli.pretrain import make_model
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    encoder = make_model("weatherbert", model_config_for_size("mini"),
                         "torch")
    encoder.reset_parameters(torch.Generator().manual_seed(3))
    torch.save(encoder.state_dict(), tmp_path / "enc.pth")
    result = yield_main.run(_yield_args(
        crop_df, "--model", "weatherbert", "--test-type", "overall",
        "--cross-validation-k", "2", "--pretrained-model-path",
        str(tmp_path / "enc.pth"), "--attention-impl", "torch"))
    assert result["test_years"] == [2014, 2015]
    first, second = result["trainers"]
    ptrs = [{p.data_ptr() for p in t.model.parameters()}
            for t in (first, second)]
    assert not ptrs[0] & ptrs[1]
    saved = torch.load(tmp_path / "enc.pth")
    for k, v in encoder.state_dict().items():
        assert torch.equal(saved[k], v)


@pytest.mark.parametrize("argv", [
    ["--model", "nope"], ["--model", "gnnrnn", "--prng", "threefry2x32"],
    ["--prng", "threefry2x32"]])
def test_unported_models_and_flags_exit(crop_df, argv):
    """An unknown model raises the JAX CLI's text (the CropNet loop reports
    the crop failed, as JAX's does for any error); the JAX-only `--prng`
    exits naming its item, on the GNN path too."""
    from weathermodel_tpu.cli import yield_main as jax_yield

    if "--prng" in argv:
        with pytest.raises(SystemExit, match="item 14"):
            yield_main.run(_yield_args(crop_df, *argv))
        with pytest.raises(SystemExit, match="item 14"):
            cropnet_main.run(cropnet_main.build_parser().parse_args(
                ["--device", "cpu", "--crop-type", "Corn", *argv]))
        return
    with pytest.raises(ValueError) as want:
        jax_yield.main(argv)
    with pytest.raises(ValueError) as got:
        yield_main.run(_yield_args(crop_df, *argv))
    assert str(got.value) == str(want.value)
    args = cropnet_main.build_parser().parse_args(
        ["--device", "cpu", "--crop-type", "Corn", *argv])
    args.cropnet_df = synthetic_cropnet_df(seed=0, n_counties=2)
    assert cropnet_main.run(args) == {"Corn": None}


def test_cropnet_gnnrnn_fails_every_crop_as_jax():
    """`wm-cropnet --model gnnrnn`: no CropNet path; the model table lacks
    the model, so every crop fails inside the per-crop try, is reported
    FAILED, and the CLI returns normally (exit code 0)."""
    from weathermodel_tpu.cli import cropnet_main as jax_cropnet

    df = synthetic_cropnet_df(seed=0, n_counties=2)
    results = []
    for module, extra in ((cropnet_main, ["--device", "cpu"]),
                          (jax_cropnet, [])):
        args = module.build_parser().parse_args(
            ["--model", "gnnrnn", "--n-epochs", "1", *extra])
        args.cropnet_df = df
        results.append(module.run(args))
    assert results[0] == results[1] == {
        crop: None for crop in ("Cotton", "Corn", "Soybeans", "WinterWheat")}


def test_unknown_model_raises_and_aliases_resolve(crop_df):
    with pytest.raises(ValueError, match="Unknown model type"):
        yield_main.run(_yield_args(crop_df, "--model", "nope"))
    assert yield_main.check_model("weatherautoencodersinusoid") == \
        "weatherautoencodersine"


def test_entry_points_need_a_card_unless_asked_for_the_cpu(crop_df):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a CUDA device")
    args = yield_main.build_parser().parse_args(TINY)
    args.crop_df = crop_df
    with pytest.raises(SystemExit, match="--device cpu"):
        yield_main.run(args)
    with pytest.raises(SystemExit, match="--device cpu"):
        cropnet_main.run(cropnet_main.build_parser().parse_args(
            ["--crop-type", "Corn"]))


def test_cropnet_defaults_train_a_crop_and_isolate_failures():
    """The CropNet defaults (mini, 4 train years, 3 past years, `auto`)
    train Corn; a crop whose yield column is missing is reported None and
    the loop goes on."""
    df = synthetic_cropnet_df(seed=0, n_counties=4)
    args = cropnet_main.build_parser().parse_args(
        ["--device", "cpu", "--n-epochs", "1", "--batch-size", "8"])
    args.cropnet_df = df.drop(columns=["cotton_yield"])
    args.crop_type = None
    results = cropnet_main.run(args)
    assert list(results) == ["Cotton", "Corn", "Soybeans", "WinterWheat"]
    assert results["Cotton"] is None
    for crop in ("Corn", "Soybeans", "WinterWheat"):
        rmse, std = results[crop]
        assert np.isfinite(rmse) and std == 0.0


def test_grid_search_resumes_and_best_config_retests(crop_df, tmp_path):
    args = grid_search.build_parser().parse_args(
        TINY + ["--device", "cpu", "--model", "linear", "--n-epochs", "1",
                "--test-type", "overall", "--cross-validation-k", "1",
                "--out-dir", str(tmp_path)])
    args.crop_df = crop_df
    cells = dict(betas=(0.0,), batch_sizes=(8,), lrs=(1e-3, 5e-4),
                 n_train_years_list=(4,))
    tsv = grid_search.GridSearch(args, str(tmp_path), **cells).run()
    assert os.path.basename(tsv) == \
        "grid_search_linear_soybean_synthetic_overall.tsv"
    rows = open(tsv).read().strip().split("\n")
    assert len(rows) == 3 and all("±" in r for r in rows[1:])
    grid_search.GridSearch(args, str(tmp_path), **cells).run()
    assert open(tsv).read().strip().split("\n") == rows
    with open(tmp_path / "grid_search_linear_soybean_synthetic_overall.json"
              ) as f:
        details = json.load(f)
    assert len(details) == 2
    assert all("runtime_seconds" in v for v in details.values())

    # a failed cell (no corn yields in the frame) is recorded, and the
    # sweep goes on
    args.crop_type = "corn"
    failed = grid_search.GridSearch(args, str(tmp_path), betas=(0.0,),
                                    batch_sizes=(8,), lrs=(1e-3,),
                                    n_train_years_list=(4,)).run()
    assert "FAILED: KeyError" in open(failed).read()

    # the best cell re-tested at overall 15 and 30 and ahead_pred 15
    args.crop_type = "soybean"
    out = tmp_path / "best" / "results.tsv"
    os.makedirs(out.parent)
    best_config.run_best_config_tests(tsv, args, str(out))
    rows = open(out).read().strip().split("\n")[1:]
    assert [(r.split("\t")[3], r.split("\t")[7]) for r in rows] == [
        ("overall", "15"), ("overall", "30"), ("ahead_pred", "15")]
    assert all(r.endswith("\tOK") for r in rows)


def test_grid_search_and_best_config_command_lines(tmp_path, monkeypatch):
    """`wm-grid-search-torch` and `wm-best-config-torch` from their command
    lines: the sweep's TSV is where best-config derives it from the flags."""
    monkeypatch.chdir(tmp_path)
    common = ["--device", "cpu", "--model", "linear", "--country",
              "synthetic", "--test-type", "overall", "--cross-validation-k",
              "1", "--n-epochs", "1", "--n-warmup-epochs", "0",
              "--n-past-years", "1"]
    tsv = grid_search.main(common + [
        "--out-dir", "sweep", "--betas", "0", "--grid-batch-sizes", "16",
        "--grid-lrs", "1e-3", "--grid-n-train-years", "4"])
    assert tsv == os.path.join(
        "sweep", "grid_search_linear_soybean_synthetic_overall.tsv")
    best_config.main(common + ["--grid-search-results-dir", "sweep",
                               "--out-path", "best/results.tsv"])
    rows = open("best/results.tsv").read().strip().split("\n")
    assert len(rows) == 4 and all(r.endswith("\tOK") for r in rows[1:])
