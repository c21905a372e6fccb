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


# the daemon and its bundle source are ported (test_torch_port_daemon.py,
# test_torch_port_export.py); tensor-parallel serving is not
@pytest.mark.parametrize("flag", [["--tensor-parallel", "2"]])
def test_unported_flags_exit_naming_the_roadmap(files, tmp_path, flag):
    args = port_serve.build_parser().parse_args(
        _argv(files, tmp_path / "o.npz") + ["--device", "cpu"] + flag)
    with pytest.raises(SystemExit, match="ROADMAP"):
        port_serve.run(args)


def _calibration_file(files, t=T):
    path = files / f"calib_{t}.npz"
    rng = np.random.default_rng(1)
    np.savez(path, weather=rng.normal(size=(10, t, 31)).astype(np.float32))
    return path


# whole-model int8 against JAX (tests/test_torch_port_quant.py's module
# docstring): the float part upstream of each quantizer differs from JAX by
# ~1e-6, which flips a code at a rounding boundary now and then, and a
# flipped code moves what it feeds by one step of its scale; through two
# layers: (RMS, max) of |port - JAX| over the RMS of JAX's output
INT8_MODEL_TOL = (1e-3, 2e-2)


@pytest.mark.parametrize("quantize", ["int8", "int8_static"])
def test_port_serve_int8_matches_jax_serve(files, tmp_path, quantize):
    """`--quantize int8` and `--quantize int8_static --calibrate-input`
    through both entry points on the same .pth, windows and calibration
    windows: the outputs within INT8_MODEL_TOL, and quantized (away from
    the float serve)."""
    argv = _argv(files, None) + ["--quantize", quantize]
    if quantize == "int8_static":
        argv += ["--calibrate-input", str(_calibration_file(files))]
    out = argv.index("--output") + 1
    outs = {}
    for name, cli, extra in (("jax", jax_serve, []),
                             ("port", port_serve, ["--device", "cpu"])):
        argv[out] = str(tmp_path / f"{name}.npz")
        cli.run(cli.build_parser().parse_args(argv + extra))
        with np.load(tmp_path / f"{name}.npz") as z:
            outs[name] = z["output"]
    port_serve.run(port_serve.build_parser().parse_args(
        _argv(files, tmp_path / "float.npz") + ["--device", "cpu"]))
    with np.load(tmp_path / "float.npz") as z:
        float_out = z["output"]
    want, got = outs["jax"], outs["port"]
    rms = np.sqrt(np.mean(np.square(want)))
    diff = got - want
    assert np.sqrt(np.mean(np.square(diff))) <= INT8_MODEL_TOL[0] * rms
    assert np.abs(diff).max() <= INT8_MODEL_TOL[1] * rms
    drift = np.abs(got - float_out).mean() / np.abs(float_out).mean()
    assert 1e-3 < drift < 0.05  # JAX's drift budget (tests/test_quant.py)


def test_int8_static_needs_matching_calibration_windows(files, tmp_path):
    """As `wm-serve`: int8_static without --calibrate-input exits, and so
    does a calibration file whose T differs from the served T."""
    argv = _argv(files, tmp_path / "o.npz") + ["--device", "cpu",
                                                "--quantize", "int8_static"]
    with pytest.raises(SystemExit, match="--calibrate-input"):
        port_serve.run(port_serve.build_parser().parse_args(argv))
    with pytest.raises(SystemExit, match="T=12"):
        port_serve.run(port_serve.build_parser().parse_args(
            argv + ["--calibrate-input",
                    str(_calibration_file(files, 12))]))


def test_daemon_serves_int8_static_and_reload_keeps_its_scales(files):
    """The daemon's predictor (`--daemon --quantize int8_static
    --calibrate-input`) answers /predict as the offline predictor does, and
    POST /reload of a checkpoint keeps its calibrated scales."""
    import http.client
    import io
    import json
    import threading

    from weathermodel_tpu_torch.serve import reload_predictor_params
    from weathermodel_tpu_torch.serving_daemon import make_server

    args = port_serve.build_parser().parse_args(
        _argv(files, None) + ["--daemon", "--device", "cpu", "--quantize",
                              "int8_static", "--calibrate-input",
                              str(_calibration_file(files))])
    pred = port_serve._make_predictor(args, T, "cpu")
    srv, batcher = make_server(
        pred, port=0, max_batch=32, max_wait_ms=1.0,
        reload_fn=lambda p: reload_predictor_params(pred, p),
        checkpoint=args.checkpoint)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()

    def post(path, body):
        conn = http.client.HTTPConnection("127.0.0.1",
                                          srv.server_address[1], timeout=30)
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    try:
        with np.load(files / "windows.npz") as z:
            arrays = {k: z[k][:5] for k in z.files}
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        offline = pred(arrays["weather"], arrays["coords"], arrays["year"],
                       arrays["interval"], arrays["mask"])
        for _ in range(2):  # before and after a reload
            status, data = post("/predict", buf.getvalue())
            assert status == 200
            with np.load(io.BytesIO(data)) as z:
                np.testing.assert_array_equal(z["output"], offline)
            assert post("/reload", json.dumps(
                {"checkpoint": args.checkpoint}).encode())[0] == 200
    finally:
        srv.shutdown()
        batcher.close()
        srv.server_close()
        th.join(timeout=5)


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
