"""The export bundle (`weathermodel_tpu_torch/export_artifact.py`,
`wm-export-torch`) and the daemon that serves it (`wm-serve-torch --daemon
--bundle`) on the CPU: a bundle against the live port forward and against
the JAX package's own bundle of the same parameters, the bucket padding and
chunking, a MoE bundle with kernel B4's op inside, int8_static, the CLI
exits (JAX's texts), the loader's refusals, and the daemon's bundle reload
(JAX tests/test_serving_daemon.py:568-673)."""

import http.client
import io
import json
import threading

import jax
import numpy as np
import pytest
import torch

from weathermodel_tpu import export_artifact as jax_export
from weathermodel_tpu.cli import export as jax_export_cli
from weathermodel_tpu.cli import serve as jax_serve
from weathermodel_tpu.models import WeatherBERT as JaxWeatherBERT
from weathermodel_tpu.models.transfer import convert_torch_state_dict
from weathermodel_tpu.ops import pallas_gmm
from weathermodel_tpu.utils.config import ModelConfig as JaxModelConfig
from weathermodel_tpu_torch import export_artifact
from weathermodel_tpu_torch.cli import export as export_cli
from weathermodel_tpu_torch.cli import serve
from weathermodel_tpu_torch.cli.pretrain import make_model
from weathermodel_tpu_torch.export_artifact import (
    BundleServingPredictor,
    ExportedPredictor,
    custom_ops,
    export_forward,
    load_bundle,
    write_bundle,
)
from weathermodel_tpu_torch.models.transfer import state_dict_from_jax_params
from weathermodel_tpu_torch.serve import load_weather_predictor
from weathermodel_tpu_torch.serving_daemon import make_server, warmup
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from weathermodel_tpu_torch.utils.config import ModelConfig
from weathermodel_tpu_torch.utils.config import model_config_for_size
from test_torch_port_jax_params import jax_params_from_state

T, F = 10, 31
# JAX tests/test_export.py's model: one layer, 4 heads of 12
CFG = dict(num_heads=4, num_layers=1, hidden_dim_factor=12, max_len=T,
           dropout_rate=0.0)
MOE = dict(num_experts=4, moe_top_k=2, moe_dispatch="ragged")


def _arrays(n, seed=0, t=T):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, t, F)).astype(np.float32),
            rng.uniform(-90, 90, size=(n, 2)).astype(np.float32),
            np.full((n, t), 1990.0, np.float32),
            np.full((n, 1), 7.0, np.float32),
            rng.random((n, t, F)) < 0.15)


def _model(seed=0, **extra):
    """The port's WeatherBERT at CFG from `seed`, in eval mode."""
    model = make_model("weatherbert", ModelConfig(**CFG, **extra), "torch")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()


def _live(model, args):
    with torch.inference_mode():
        return model(*map(torch.from_numpy, args)).numpy()


def _bundle(tmp_path, name, model, buckets=(4,), t=T):
    path = str(tmp_path / name)
    manifest = write_bundle(path, model, None, buckets, t,
                            platforms=("cpu",))
    return path, manifest


def test_dense_bundle_matches_the_live_forward_and_the_jax_bundle(tmp_path):
    model = _model()
    path, manifest = _bundle(tmp_path, "m.wmx", model)
    assert manifest["buckets"] == [4] and manifest["seq_len"] == T
    assert manifest["format"] == export_artifact.MAGIC
    assert manifest["ops"] == [] and manifest["weather_dim"] == F
    args = _arrays(4, seed=1)
    got = ExportedPredictor(path)(*args)
    np.testing.assert_allclose(got, _live(model, args), atol=2e-5, rtol=0)
    # one program alone: export_forward's bytes, state baked in
    other = _model(seed=3)
    program = torch.export.load(io.BytesIO(export_forward(
        _model(seed=4), other.state_dict(), 4, T, "cpu"))).module()
    with torch.inference_mode():
        alone = program(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(alone, _live(other, args), atol=2e-5, rtol=0)
    # the JAX package's bundle of the same parameters
    jmodel = JaxWeatherBERT(JaxModelConfig(**CFG), attention_impl="xla")
    params = convert_torch_state_dict(model.state_dict(), 1)
    jpath = str(tmp_path / "jax.wmx")
    jax_export.write_bundle(jpath, jmodel, params, buckets=(4,), seq_len=T,
                            platforms=("cpu",))
    want = jax_export.ExportedPredictor(jpath)(*args)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    # and the port's loader refuses JAX's bundle, naming it
    with pytest.raises(ValueError, match="is a JAX bundle"):
        load_bundle(jpath)


def test_exported_predictor_pads_to_the_bucket_and_chunks(tmp_path):
    model = _model()
    path, _ = _bundle(tmp_path, "m.wmx", model, buckets=(2, 4))
    pred = ExportedPredictor(path)
    assert pred.buckets == (2, 4) and pred.device.type == "cpu"
    args = _arrays(3, seed=2)    # pads to bucket 4, sliced back to 3
    np.testing.assert_allclose(pred(*args), _live(model, args), atol=2e-5,
                               rtol=0)
    # 11 rows: chunks of 4, 4 and 3 (padded to 4)
    args = _arrays(11, seed=3)
    got = pred(*args)
    assert got.shape == (11, T, F)
    np.testing.assert_allclose(got, _live(model, args), atol=2e-5, rtol=0)


def test_moe_bundle_holds_the_gmm_op_and_matches(tmp_path, monkeypatch):
    """The ragged experts' grouped matmul is one `wm::gmm` node a matmul
    (ops/gmm.py): bitwise the live forward here (1e-6 asked), and JAX's
    ragged MoE at 2e-5 (its grouped matmul through `lax.ragged_dot`)."""
    monkeypatch.setattr(pallas_gmm, "_INTERPRET", False)
    jmodel = JaxWeatherBERT(JaxModelConfig(**CFG, **MOE),
                            attention_impl="xla")
    model = _model(**MOE)
    params = jax_params_from_state(
        lambda: jmodel.init(jax.random.PRNGKey(0), *_arrays(2)),
        state_dict_from_jax_params, model.state_dict())
    path, manifest = _bundle(tmp_path, "moe.wmx", model)
    assert manifest["ops"] == ["wm::gmm"]
    program = torch.export.load(io.BytesIO(np.load(path)[
        "bucket_4_cpu"].tobytes()))
    assert custom_ops(program) == ["wm::gmm"]
    assert sum(n.target == torch.ops.wm.gmm.default
               for n in program.graph.nodes) == 2
    args = _arrays(4, seed=5)
    got = ExportedPredictor(path)(*args)
    np.testing.assert_allclose(got, _live(model, args), atol=1e-6, rtol=0)
    want = jax.jit(jmodel.apply)(params, *args)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=0)


def _mini_checkpoint(tmp_path, experts=0, seed=0):
    model = make_model("weatherbert", model_config_for_size(
        "mini", max_len=T, num_experts=experts), "torch")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    path = tmp_path / f"mini{experts}_{seed}.pth"
    torch.save(model.state_dict(), path)
    return path


def _export_argv(ckpt, out, *extra):
    return ["--checkpoint", str(ckpt), "--model-size", "mini", "--output",
            str(out), "--seq-len", str(T), "--buckets", "4",
            "--platforms", "cpu", "--compute-dtype", "float32", *extra]


def test_int8_static_bundle_matches_the_live_quantized_predictor(tmp_path):
    ckpt = _mini_checkpoint(tmp_path)
    calib = _arrays(6, seed=7)
    np.savez(tmp_path / "calib.npz", weather=calib[0], coords=calib[1],
             year=calib[2], interval=calib[3], mask=calib[4])
    manifest = export_cli.main(_export_argv(
        ckpt, tmp_path / "q.wmx", "--quantize", "int8_static",
        "--calibrate-input", str(tmp_path / "calib.npz")))
    assert manifest["quantize"] == "int8_static" and manifest["mb"] > 0
    live = load_weather_predictor(
        str(ckpt), "mini", attention_impl="torch", max_len=T, buckets=(4,),
        compute_dtype="float32", device="cpu", quantize="int8_static",
        calibration_batches=[calib])
    fp = load_weather_predictor(
        str(ckpt), "mini", attention_impl="torch", max_len=T, buckets=(4,),
        compute_dtype="float32", device="cpu")
    args = _arrays(4, seed=8)
    got = ExportedPredictor(str(tmp_path / "q.wmx"))(*args)
    want = live(*args[:4], weather_feature_mask=args[4])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert not np.allclose(got, fp(*args[:4], weather_feature_mask=args[4]))


def _exit_text(run, args) -> str:
    with pytest.raises(SystemExit) as e:
        run(args)
    return str(e.value)


def test_export_cli_exits_as_the_jax_cli(tmp_path):
    ckpt = _mini_checkpoint(tmp_path)
    np.savez(tmp_path / "c8.npz", weather=_arrays(2, t=8)[0])
    for extra in (["--quantize", "int8_static"],
                  ["--quantize", "int8_static", "--calibrate-input",
                   str(tmp_path / "c8.npz")]):
        argv = _export_argv(ckpt, tmp_path / "x.wmx", *extra)
        want = _exit_text(jax_export_cli.run,
                          jax_export_cli.build_parser().parse_args(argv))
        assert _exit_text(export_cli.run,
                          export_cli.build_parser().parse_args(argv)) == want
    argv = _export_argv(ckpt, tmp_path / "x.wmx")
    argv[argv.index("cpu")] = "tpu"
    assert "'tpu'" in _exit_text(export_cli.run,
                                 export_cli.build_parser().parse_args(argv))
    # an orbax directory stays refused (ROADMAP.md queue A item 16)
    argv = _export_argv(tmp_path, tmp_path / "x.wmx")
    with pytest.raises(NotImplementedError, match="item 16"):
        export_cli.run(export_cli.build_parser().parse_args(argv))


@pytest.mark.parametrize("argv", [
    ["--checkpoint", "m.pth", "--bundle", "m.wmx", "--daemon"],
    ["--daemon"],
    ["--bundle", "m.wmx", "--input", "w.npz", "--output", "o.npz"]],
    ids=["both", "neither", "offline-bundle"])
def test_serve_bundle_flags_exit_as_the_jax_cli(argv):
    want = _exit_text(jax_serve.run, jax_serve.build_parser().parse_args(
        argv))
    assert _exit_text(serve.run, serve.build_parser().parse_args(
        argv + ["--device", "cpu"])) == want


def _edited(path, out, **manifest_items):
    """A copy of the bundle at `path` with manifest entries replaced."""
    with np.load(path) as z:
        arrays = dict(z)
    manifest = json.loads(arrays["manifest"].tobytes().decode())
    manifest.update(manifest_items)
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(),
                                       np.uint8)
    arrays.update({f"bucket_{b}_cuda": arrays[f"bucket_{b}_cpu"]
                   for b in manifest["buckets"]})
    with open(out, "wb") as fh:   # np.savez names a path .npz
        np.savez(fh, **arrays)
    return str(out)


def test_cuda_programs_need_a_card_and_ops_a_registration(tmp_path,
                                                          monkeypatch):
    model = _model()
    path, _ = _bundle(tmp_path, "m.wmx", model)
    with pytest.raises(ValueError, match=r"\['cpu'\], not 'cuda'"):
        load_bundle(path, "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            write_bundle(str(tmp_path / "c.wmx"), model, None, (4,), T,
                         platforms=("cuda",))
        both = _edited(path, tmp_path / "both.wmx",
                       platforms=["cuda", "cpu"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_bundle(both, "cuda")
        assert load_bundle(both)[0]["platform"] == "cpu"
        with pytest.raises(SystemExit, match="--platforms cpu"):
            export_cli.run(export_cli.build_parser().parse_args(
                _export_argv(_mini_checkpoint(tmp_path), tmp_path / "x.wmx")
                + ["--platforms", "cuda,cpu"]))
    # a manifest naming an op that no module registers, or whose module
    # does not register it, is refused before any program loads
    absent = _edited(path, tmp_path / "absent.wmx", ops=["wm::absent"])
    with pytest.raises(ValueError, match="no module"):
        load_bundle(absent)
    monkeypatch.setitem(export_artifact.OP_MODULES, "wm::absent", "json")
    with pytest.raises(RuntimeError, match="did not register"):
        load_bundle(absent)


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _predict(port, args):
    buf = io.BytesIO()
    np.savez(buf, weather=args[0], coords=args[1], year=args[2],
             interval=args[3], mask=args[4])
    status, data = _post(port, "/predict", buf.getvalue())
    assert status == 200, data
    with np.load(io.BytesIO(data)) as z:
        return z["output"]


def test_bundle_daemon_roundtrip_and_reload(tmp_path):
    """A bundle served by the daemon answers /predict as the live model,
    and /reload {"bundle": ...} swaps in a new bundle (geometry checked,
    buckets warmed before the swap); /stats names the bundle."""
    m0, m1 = _model(0), _model(7)
    p0, _ = _bundle(tmp_path, "a.wmx", m0)
    p1, _ = _bundle(tmp_path, "b.wmx", m1)
    pred = BundleServingPredictor(p0)
    assert pred.buckets == (4,) and pred.seq_len == T
    assert pred.weather_dim == F and pred.platform == "cpu"
    warmup(pred, T, F)  # the daemon's startup path works on bundles
    srv, batcher = make_server(pred, port=0, max_wait_ms=1.0,
                               reload_fn=pred.reload_bundle, checkpoint=p0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    port = srv.server_address[1]
    try:
        args = _arrays(3, 50)
        before = _predict(port, args)
        np.testing.assert_allclose(before, _live(m0, args), atol=1e-5)
        status, out = _post(port, "/reload", json.dumps(
            {"bundle": p1}).encode())
        assert status == 200 and json.loads(out)["ok"]
        after = _predict(port, args)
        assert not np.allclose(after, before)
        np.testing.assert_allclose(after, _live(m1, args), atol=1e-5)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
        assert stats["checkpoint"] == p1 and stats["bundle"] is True
        assert stats["n_reloads"] == 1
        status, out = _post(port, "/reload", b'{"path": "x"}')
        assert status == 400 and b"bundle mode" in out
    finally:
        srv.shutdown()
        batcher.close()
        srv.server_close()
        th.join(timeout=5)


def test_bundle_reload_rejects_geometry_mismatch(tmp_path):
    p0, _ = _bundle(tmp_path, "a.wmx", _model(0))
    pred = BundleServingPredictor(p0)
    pb, _ = _bundle(tmp_path, "buckets.wmx", _model(1), buckets=(2, 4))
    with pytest.raises(ValueError, match=r"buckets \(2, 4\) != served "
                                         r"buckets \(4,\)"):
        pred.reload_bundle(pb)
    m8 = make_model("weatherbert", ModelConfig(**{**CFG, "max_len": 8}),
                    "torch")
    ps, _ = _bundle(tmp_path, "seq.wmx", m8, t=8)
    with pytest.raises(ValueError, match="has seq_len=8 but the daemon "
                                         f"serves seq_len={T}"):
        pred.reload_bundle(ps)
    # the served predictor is untouched after rejected reloads
    assert pred.path == p0
    assert pred(*_arrays(2, 60)[:4]).shape == (2, T, F)


def test_serve_cli_daemon_serves_a_bundle(tmp_path, monkeypatch):
    """`wm-serve-torch --daemon --bundle` hands serve_forever the bundle's
    predictor, its geometry and, with --allow-reload, its reload."""
    from weathermodel_tpu_torch import serving_daemon

    p0, _ = _bundle(tmp_path, "a.wmx", _model(), buckets=(2, 4))
    seen = {}
    monkeypatch.setattr(serving_daemon, "serve_forever",
                        lambda pred, *a, **kw: seen.update(pred=pred, **kw))
    serve.run(serve.build_parser().parse_args([
        "--daemon", "--bundle", p0, "--allow-reload", "--device", "cpu"]))
    assert isinstance(seen["pred"], BundleServingPredictor)
    assert (seen["seq_len"], seen["max_batch"]) == (T, 4)
    assert seen["reload_fn"] == seen["pred"].reload_bundle
    assert seen["checkpoint"] == p0


def test_moe_layer_takes_the_op_only_with_gradients_off(monkeypatch):
    """With gradients off the ragged experts call `wm::gmm` (what an
    exported program records); with them on, `GroupedMatmul` as before:
    the two forwards agree bit for bit, and the backward is the one of the
    grouped matmul's custom VJP, bitwise the plain version's autograd."""
    from weathermodel_tpu_torch.models import moe
    from weathermodel_tpu_torch.ops import gmm as gmm_ops

    calls = {"op": 0, "function": 0}
    op, function = moe.gmm_op, gmm_ops.GroupedMatmul.apply

    def counted(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(moe, "gmm_op", counted("op", op))
    monkeypatch.setattr(moe.GroupedMatmul, "apply",
                        counted("function", function))
    layer = moe.MoEFFN(32, 128, 4, top_k=2)
    layer.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 32, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = layer(x)
    assert calls == {"op": 2, "function": 0}
    xt = x.clone().requires_grad_()
    got, _ = layer(xt)
    assert calls == {"op": 2, "function": 2}
    assert torch.equal(got, want)
    got.square().sum().backward()
    plain = moe.MoEFFN(32, 128, 4, top_k=2, gmm_impl="plain")
    plain.load_state_dict(layer.state_dict())
    xp = x.clone().requires_grad_()
    plain(xp)[0].square().sum().backward()
    assert torch.equal(xt.grad, xp.grad)
    for name in ("expert_w1", "expert_w2"):
        assert torch.equal(getattr(layer, name).grad,
                           getattr(plain, name).grad), name


def test_weatherformer_bundle_serves_its_outputs(tmp_path):
    """A WeatherFormer's program returns its tuple (mu, var, ...), which the
    predictor pads, chunks and slices output by output."""
    model = make_model("weatherformer", ModelConfig(**CFG), "torch")
    model.reset_parameters(torch.Generator().manual_seed(2))
    path, _ = _bundle(tmp_path, "wf.wmx", model.eval(), buckets=(2, 4))
    args = _arrays(5, seed=9)
    got = ExportedPredictor(path)(*args)
    with torch.inference_mode():
        want = model(*map(torch.from_numpy, args))
    assert isinstance(got, tuple) and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape[0] == 5
        np.testing.assert_allclose(g, w.numpy(), atol=2e-5, rtol=0)
