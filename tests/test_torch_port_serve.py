"""The serving slice end to end: the JAX `wm-serve` and the port's
`wm-serve-torch` on the same reference-format .pth and windows .npz."""

import numpy as np
import pytest
import torch

from weathermodel_tpu.cli import serve as jax_serve
from weathermodel_tpu_torch.cli import serve as port_serve
from weathermodel_tpu_torch.cli.pretrain import make_model
from weathermodel_tpu_torch.serve import load_weather_predictor
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.utils.config import model_config_for_size


T, N = 24, 45


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A mini WeatherBERT's weights as a reference .pth, and N=45 seeded
    windows: with --batch-size 32 that is a 32-row chunk plus 13 rows
    padded to the 32 bucket."""
    tmp = tmp_path_factory.mktemp("serve")
    model = make_model("weatherbert",
                       model_config_for_size("mini", max_len=T), "torch")
    model.reset_parameters(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), tmp / "mini.pth")
    rng = np.random.default_rng(0)
    np.savez(tmp / "windows.npz",
             weather=rng.normal(size=(N, T, 31)).astype(np.float32),
             coords=rng.uniform(-90, 90, (N, 2)).astype(np.float32),
             year=(1990.0 + np.arange(T) / 52.0
                   + rng.integers(0, 12, (N, 1))).astype(np.float32),
             interval=np.full((N, 1), 7.0, np.float32),
             mask=rng.random((N, T, 31)) < 0.15)
    return tmp


def _argv(files, out):
    return ["--checkpoint", str(files / "mini.pth"), "--model", "weatherbert",
            "--model-size", "mini", "--input", str(files / "windows.npz"),
            "--output", str(out), "--batch-size", "32",
            "--compute-dtype", "float32"]


def test_port_serve_matches_jax_serve(files, tmp_path):
    jax_res = jax_serve.run(jax_serve.build_parser().parse_args(
        _argv(files, tmp_path / "jax.npz")))
    port_res = port_serve.run(port_serve.build_parser().parse_args(
        _argv(files, tmp_path / "port.npz") + ["--device", "cpu"]))
    assert port_res["n"] == jax_res["n"] == N
    assert port_res["keys"] == jax_res["keys"]
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].shape == b[key].shape
            # fp32, "pallas_qkv" (interpret mode) vs the port's plain
            # version of the fused kernel: the JAX package's bar for it
            np.testing.assert_allclose(b[key], a[key], atol=5e-5, rtol=1e-4)


def test_port_serve_matches_jax_serve_for_weatherformer(files, tmp_path):
    """A WeatherFormer's variational head: both entry points write mu and
    var, and they agree at the fused kernel's bar."""
    model = make_model("weatherformer",
                       model_config_for_size("mini", max_len=T), "torch")
    model.reset_parameters(torch.Generator().manual_seed(1))
    torch.save(model.state_dict(), tmp_path / "wf.pth")
    argv = _argv(files, None)
    argv[argv.index("--checkpoint") + 1] = str(tmp_path / "wf.pth")
    argv[argv.index("--model") + 1] = "weatherformer"
    out = argv.index("--output") + 1
    argv[out] = str(tmp_path / "jax.npz")
    jax_res = jax_serve.run(jax_serve.build_parser().parse_args(argv))
    argv[out] = str(tmp_path / "port.npz")
    port_res = port_serve.run(port_serve.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert port_res["keys"] == jax_res["keys"] == ["mu", "var"]
    with np.load(tmp_path / "jax.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        for key in ("mu", "var"):
            assert b[key].shape == a[key].shape == (N, T, 31)
            np.testing.assert_allclose(b[key], a[key], atol=5e-5, rtol=1e-4,
                                       err_msg=key)


@pytest.mark.parametrize("flag", [["--daemon"], ["--bundle", "x.wmx"],
                                  ["--quantize", "int8"],
                                  ["--tensor-parallel", "2"]])
def test_unported_flags_exit_naming_the_roadmap(files, tmp_path, flag):
    args = port_serve.build_parser().parse_args(
        _argv(files, tmp_path / "o.npz") + ["--device", "cpu"] + flag)
    with pytest.raises(SystemExit, match="ROADMAP"):
        port_serve.run(args)


def test_predictor_buckets_and_checkpoint_checks(files):
    predictor = load_weather_predictor(
        str(files / "mini.pth"), "mini", max_len=T, buckets=(8, 32),
        compute_dtype="float32", device="cpu")
    assert predictor._bucket(13) == 32 and predictor._bucket(33) == 32
    with np.load(files / "windows.npz") as z:
        w, c, y, i, m = (z[k] for k in ("weather", "coords", "year",
                                        "interval", "mask"))
    whole = predictor(w, c, y, i, m)
    # rows are independent of their batch-mates and of the zero padding
    np.testing.assert_allclose(predictor(w[:5], c[:5], y[:5], i[:5], m[:5]),
                               whole[:5], atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="lacks"):
        load_weather_predictor(str(files / "mini.pth"), "small", max_len=T,
                               device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_weather_predictor(str(files / "mini"), "mini", max_len=T,
                               device="cpu")
    with pytest.raises(ValueError, match="lacks MoE"):
        load_weather_predictor(str(files / "mini.pth"), "mini", max_len=T,
                               num_experts=4, device="cpu")
