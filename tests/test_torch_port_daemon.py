"""The port's online serving daemon (weathermodel_tpu_torch/serving_daemon.py)
with a mini port predictor: the cases of tests/test_serving_daemon.py
(micro-batching, the HTTP protocol, hot reload, drain, load shedding), the
JAX daemon and the port's answering the same request on the same weights,
and `wm-serve-torch --daemon` as a process with a SIGTERM drain."""

import http.client
import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from weathermodel_tpu.models import WeatherBERT as JaxWeatherBERT
from weathermodel_tpu.serve import WeatherPredictor as JaxPredictor
from weathermodel_tpu.serving_daemon import make_server as jax_make_server
from weathermodel_tpu.utils.config import ModelConfig as JaxModelConfig
from weathermodel_tpu_torch.cli import serve as port_serve
from weathermodel_tpu_torch.models.transfer import state_dict_from_jax_params
from weathermodel_tpu_torch.models.weatherbert import WeatherBERT
from weathermodel_tpu_torch.models.weatherformer import WeatherFormer
from weathermodel_tpu_torch.serve import (
    WeatherPredictor,
    load_weather_predictor,
    reload_predictor_params,
)
from weathermodel_tpu_torch.serving_daemon import (
    MicroBatcher,
    QueueFull,
    RequestTimeout,
    make_server,
    warmup,
)
from weathermodel_tpu_torch.testing import _one_torch_thread  # noqa: F401
from test_torch_port_jax_params import jax_params_from_state
from weathermodel_tpu_torch.utils.config import (
    ModelConfig,
    model_config_for_size,
)

T, F = 12, 31
CFG = ModelConfig(num_heads=4, num_layers=1, hidden_dim_factor=12, max_len=T,
                  dropout_rate=0.0)
REPO = Path(__file__).resolve().parents[1]


def _arrays(n, seed=0, t=T):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, t, F)).astype(np.float32),
            rng.uniform(-90, 90, size=(n, 2)).astype(np.float32),
            np.full((n, t), 1990.0, np.float32),
            np.full((n, 1), 7.0, np.float32),
            np.zeros((n, t, F), bool))


def _model(seed=0, cfg=CFG, cls=WeatherBERT):
    model = cls(cfg, attention_impl="fused_qkv")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def _predictor(seed=0, buckets=(4, 16)):
    return WeatherPredictor(_model(seed), buckets, device="cpu")


@pytest.fixture(scope="module")
def predictor():
    return _predictor()


def _start(srv):
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return th


def _stop(srv, batcher, th):
    srv.shutdown()
    batcher.close()
    srv.server_close()
    th.join(timeout=5)


@pytest.fixture()
def server(predictor):
    srv, batcher = make_server(predictor, host="127.0.0.1", port=0,
                               max_batch=16, max_wait_ms=2.0)
    th = _start(srv)
    yield srv
    _stop(srv, batcher, th)


def _post(port, path, body, timeout=30):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, body=body,
                 headers={"Content-Type": "application/octet-stream"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _post_npz(port, path="/predict", **arrays):
    return _post(port, path, _npz(**arrays))


def _get_json(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    out = json.loads(conn.getresponse().read())
    conn.close()
    return out


def _kw(args):
    return dict(zip(("weather", "coords", "year", "interval", "mask"), args))


def test_microbatcher_coalesces_concurrent_requests(predictor):
    """While the worker is blocked on request #1, three more requests
    arrive; one predictor call serves them, each output equal to a direct
    call's."""
    gate = threading.Event()
    first_started = threading.Event()
    calls = []

    def gated_predictor(w, c, y, i, weather_feature_mask=None):
        calls.append(w.shape[0])
        if len(calls) == 1:
            first_started.set()
            gate.wait(timeout=10)
        return predictor(w, c, y, i,
                         weather_feature_mask=weather_feature_mask)

    mb = MicroBatcher(gated_predictor, max_batch=64, max_wait_ms=100.0)
    try:
        results = {}

        def client(name, n, seed):
            results[name] = mb.submit(*_arrays(n, seed))

        t0 = threading.Thread(target=client, args=("a", 2, 1))
        t0.start()
        assert first_started.wait(timeout=10)
        rest = [threading.Thread(target=client, args=(k, n, s))
                for k, n, s in (("b", 3, 2), ("c", 1, 3), ("d", 2, 4))]
        for th in rest:
            th.start()
        time.sleep(0.15)  # let b/c/d enqueue while the worker is gated
        gate.set()
        for th in [t0] + rest:
            th.join(timeout=30)

        assert calls == [2, 3 + 1 + 2]  # [a], then [b+c+d] coalesced
        for name, n, seed in (("a", 2, 1), ("b", 3, 2), ("c", 1, 3),
                              ("d", 2, 4)):
            w, c, y, i, m = _arrays(n, seed)
            direct = predictor(w, c, y, i, weather_feature_mask=m)
            np.testing.assert_allclose(results[name], direct, atol=1e-5)
        stats = mb.stats()
        assert stats["n_requests"] == 4 and stats["n_batches"] == 2
        assert stats["rows_per_batch"] == 4.0
        assert stats["latency_ms"]["p50"] is not None
    finally:
        mb.close()


def test_microbatcher_groups_by_shape():
    shapes = []

    def shape_logging_predictor(w, c, y, i, weather_feature_mask=None):
        shapes.append(w.shape)
        return np.zeros(w.shape, np.float32)

    mb = MicroBatcher(shape_logging_predictor, max_batch=64,
                      max_wait_ms=150.0)
    try:
        outs = {}
        ths = [threading.Thread(
                   target=lambda k=k, t=t, s=s: outs.update(
                       {k: mb.submit(*_arrays(2, s, t=t))}))
               for k, t, s in (("t12a", 12, 5), ("t8", 8, 6),
                               ("t12b", 12, 7))]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=30)
        assert sorted(s[1] for s in shapes) == [8, 12]  # two groups
        assert outs["t8"].shape == (2, 8, F)
    finally:
        mb.close()


def test_microbatcher_surfaces_errors_and_survives():
    def flaky(w, *a, **kw):
        if w.shape[0] == 3:
            raise ValueError("boom")
        return np.zeros(w.shape, np.float32)

    mb = MicroBatcher(flaky, max_batch=64, max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError, match="boom"):
            mb.submit(*_arrays(3, 8))
        assert mb.submit(*_arrays(2, 9)).shape == (2, T, F)
    finally:
        mb.close()


def test_http_predict_roundtrip(predictor, server):
    port = server.server_address[1]
    w, c, y, i, m = _arrays(5, 10)
    status, data = _post_npz(port, weather=w, coords=c, year=y, interval=i,
                             mask=m)
    assert status == 200
    with np.load(io.BytesIO(data)) as z:
        out = z["output"]
    np.testing.assert_allclose(out, predictor(w, c, y, i, m), atol=1e-5)
    status, data = _post_npz(port, weather=w)  # defaults synthesized
    assert status == 200
    with np.load(io.BytesIO(data)) as z:
        assert z["output"].shape == (5, T, F)
    assert _get_json(port, "/healthz") == {"ok": True}
    stats = _get_json(port, "/stats")
    assert stats["n_requests"] >= 2 and stats["n_rows"] >= 10


def test_http_rejects_bad_requests(server):
    port = server.server_address[1]
    status, data = _post_npz(port, weather=np.zeros((2, 2), np.float32))
    assert status == 400 and b"N,T,F" in data
    status, _ = _post_npz(port, wrong_key=np.zeros(3, np.float32))
    assert status == 400
    w = _arrays(2, 1)[0]
    status, data = _post_npz(port, weather=w, year=np.zeros((2, 3)))
    assert status == 400 and b"year must have shape" in data
    assert _post(port, "/nope", b"x")[0] == 404


def test_variational_head_returns_mu_var():
    pred = WeatherPredictor(_model(1, cls=WeatherFormer), (4,), device="cpu")
    srv, batcher = make_server(pred, port=0, max_wait_ms=1.0)
    th = _start(srv)
    try:
        status, data = _post_npz(srv.server_address[1],
                                 weather=_arrays(3, 11)[0])
        assert status == 200
        with np.load(io.BytesIO(data)) as z:
            assert z["mu"].shape == (3, T, F)
            assert np.all(z["var"] > 0)
    finally:
        _stop(srv, batcher, th)


def test_warmup_runs_every_bucket():
    seen = []

    class Recording(WeatherPredictor):
        def __call__(self, weather, *args, **kw):
            seen.append(weather.shape)
            return super().__call__(weather, *args, **kw)

    pred = Recording(_model(), (4, 16), device="cpu")
    warmup(pred, T, F)
    assert seen == [(4, T, F), (16, T, F)]


def test_http_rejects_oversized_body(predictor):
    srv, batcher = make_server(predictor, port=0, max_wait_ms=1.0,
                               max_body_mb=0.001)  # 1 KB
    th = _start(srv)
    try:
        status, data = _post_npz(srv.server_address[1],
                                 weather=_arrays(4, 20)[0])
        assert status == 400 and b"exceeds" in data
    finally:
        _stop(srv, batcher, th)


def test_batcher_rejects_submit_after_close(predictor):
    mb = MicroBatcher(predictor, max_wait_ms=1.0)
    mb.close()
    with pytest.raises(RuntimeError, match="shut down"):
        mb.submit(*_arrays(1, 21))


# ---- hot reload -------------------------------------------------------------

def test_swap_state_changes_outputs_and_leaves_the_old_module():
    pred = _predictor(0, buckets=(4,))
    args = _arrays(3, 30)
    before = pred(*args)
    old = pred.model
    old_weight = old.in_proj.weight.clone()
    new = _model(7).state_dict()
    assert pred.swap_state(new) == sum(v.numel() for v in new.values())
    after = pred(*args)
    assert not np.allclose(before, after)  # genuinely new weights
    np.testing.assert_allclose(after, _predictor(7, (4,))(*args), atol=1e-6)
    # a batch that read the old module finishes on it, unchanged
    assert pred.model is not old
    assert torch.equal(old.in_proj.weight, old_weight)
    np.testing.assert_allclose(WeatherPredictor(old, (4,), "cpu")(*args),
                               before, atol=1e-6)


def test_swap_state_under_concurrent_calls_never_mixes_weights():
    """A predictor called in a loop while another thread swaps two weight
    sets back and forth: every answer is one set's, never a mix."""
    pred = _predictor(0, buckets=(4,))
    args = _arrays(2, 32)
    states = [_model(0).state_dict(), _model(7).state_dict()]
    answers = [pred(*args), _predictor(7, (4,))(*args)]
    stop = threading.Event()
    seen = []

    def caller():
        while not stop.is_set():
            seen.append(pred(*args))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller) for _ in range(2)]
        for th in threads:
            th.start()
        for i in range(20):
            pred.swap_state(states[(i + 1) % 2])
        stop.set()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
    finally:
        stop.set()
        sys.setswitchinterval(interval)
    assert seen
    for out in seen:
        assert any(np.array_equal(out, a) for a in answers)


def test_swap_state_rejects_mismatches():
    pred = _predictor(0, buckets=(4,))
    args = _arrays(2, 31)
    before = pred(*args)
    deeper = _model(1, ModelConfig(num_heads=4, num_layers=2,
                                   hidden_dim_factor=12, max_len=T))
    with pytest.raises(ValueError, match="tree does not match"):
        pred.swap_state(deeper.state_dict())
    wide = _model(1, ModelConfig(num_heads=4, num_layers=1,
                                 hidden_dim_factor=16, max_len=T))
    with pytest.raises(ValueError, match="leaf mismatch"):
        pred.swap_state(wide.state_dict())
    half = {k: v.to(torch.bfloat16) for k, v in _model(1).state_dict().items()}
    with pytest.raises(ValueError, match="leaf mismatch"):
        pred.swap_state(half)
    np.testing.assert_array_equal(pred(*args), before)  # untouched


def test_http_reload_roundtrip(tmp_path):
    ckpt = str(tmp_path / "new_weights.pth")
    torch.save(_model(7).state_dict(), ckpt)
    pred = _predictor(0, buckets=(4,))
    srv, batcher = make_server(
        pred, port=0, max_wait_ms=1.0,
        reload_fn=lambda p: reload_predictor_params(pred, p),
        checkpoint="initial")
    th = _start(srv)
    port = srv.server_address[1]
    try:
        args = _arrays(3, 31)
        _, before = _post_npz(port, **_kw(args))
        status, data = _post(port, "/reload",
                             json.dumps({"checkpoint": ckpt}).encode())
        out = json.loads(data)
        assert status == 200 and out["ok"] and out["checkpoint"] == ckpt
        # a bad body, a missing file and an orbax directory: 400, still up
        assert _post(port, "/reload", b"not json")[0] == 400
        assert _post(port, "/reload", json.dumps(
            {"checkpoint": "/nonexistent.pth"}).encode())[0] == 400
        status, data = _post(port, "/reload", json.dumps(
            {"checkpoint": str(tmp_path)}).encode())
        assert status == 400 and b"item 16" in data
        stats = _get_json(port, "/stats")
        assert stats["n_reloads"] == 1 and stats["checkpoint"] == ckpt
        _, after = _post_npz(port, **_kw(args))
        with np.load(io.BytesIO(before)) as zb, \
                np.load(io.BytesIO(after)) as za:
            assert not np.allclose(zb["output"], za["output"])
            np.testing.assert_allclose(za["output"],
                                       _predictor(7, (4,))(*args), atol=1e-6)
    finally:
        _stop(srv, batcher, th)


def test_reload_rejects_moe_mismatch(tmp_path):
    moe = _model(1, ModelConfig(num_heads=4, num_layers=1,
                                hidden_dim_factor=12, max_len=T,
                                num_experts=2))
    torch.save(moe.state_dict(), tmp_path / "moe.pth")
    with pytest.raises(ValueError, match="contains MoE"):
        reload_predictor_params(_predictor(), str(tmp_path / "moe.pth"))


def test_http_reload_disabled_by_default(server):
    status, data = _post(server.server_address[1], "/reload",
                         json.dumps({"checkpoint": "x"}).encode())
    assert status == 403 and b"allow-reload" in data


def test_shutdown_drains_inflight_requests(predictor):
    """server_close joins the handler of a request accepted before the
    shutdown (what SIGTERM triggers): its response is complete."""
    release = threading.Event()

    def slow_predictor(w, c, y, i, weather_feature_mask=None):
        release.wait(timeout=10)
        return predictor(w, c, y, i,
                         weather_feature_mask=weather_feature_mask)

    srv, batcher = make_server(slow_predictor, host="127.0.0.1", port=0,
                               max_batch=16, max_wait_ms=1.0)
    port = srv.server_address[1]
    th = _start(srv)
    done = threading.Event()
    result = {}

    def client():
        result["status"], result["data"] = _post_npz(
            port, **_kw(_arrays(2, seed=3)))
        done.set()

    threading.Thread(target=client, daemon=True).start()
    time.sleep(0.3)  # accepted, blocked in the predictor
    assert not done.is_set()
    threading.Thread(target=srv.shutdown, daemon=True).start()
    release.set()
    srv.server_close()
    assert done.wait(timeout=1), "response not completed by server_close"
    assert result["status"] == 200
    with np.load(io.BytesIO(result["data"])) as z:
        assert z["output"].shape == (2, T, F)
    batcher.close()
    th.join(timeout=5)


# ---- load shedding ----------------------------------------------------------

def test_queue_full_sheds_with_retry_after():
    gate = threading.Event()
    started = threading.Event()

    def gated(w, c, y, i, weather_feature_mask=None):
        started.set()
        gate.wait(timeout=10)
        return np.zeros(w.shape, np.float32)

    mb = MicroBatcher(gated, max_batch=4, max_wait_ms=1.0, max_queue_rows=4)
    try:
        oks, sheds = [], []

        def client(n, seed):
            try:
                oks.append(mb.submit(*_arrays(n, seed)))
            except QueueFull as e:
                sheds.append(e)

        t0 = threading.Thread(target=client, args=(2, 1))
        t0.start()
        assert started.wait(timeout=10)
        ths = [threading.Thread(target=client, args=(2, s)) for s in (2, 3, 4)]
        for th in ths:
            th.start()
        deadline = time.monotonic() + 10
        while not sheds and time.monotonic() < deadline:
            time.sleep(0.01)
        gate.set()
        for th in [t0] + ths:
            th.join(timeout=10)
        assert len(sheds) >= 1 and all(e.retry_after_s > 0 for e in sheds)
        assert len(oks) + len(sheds) == 4
        assert mb.stats()["n_shed"] == len(sheds)
    finally:
        gate.set()
        mb.close()


def test_http_flood_returns_429_with_retry_after(predictor):
    release = threading.Event()

    def slow(w, c, y, i, weather_feature_mask=None):
        release.wait(timeout=10)
        return predictor(w, c, y, i,
                         weather_feature_mask=weather_feature_mask)

    srv, batcher = make_server(slow, port=0, max_batch=4, max_wait_ms=1.0,
                               max_queue_rows=6)
    th = _start(srv)
    port = srv.server_address[1]
    statuses, headers = [], []

    def client(seed):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/predict", body=_npz(**_kw(_arrays(2, seed))))
        resp = conn.getresponse()
        resp.read()
        statuses.append(resp.status)
        headers.append(resp.getheader("Retry-After"))
        conn.close()

    try:
        ths = [threading.Thread(target=client, args=(s,)) for s in range(12)]
        for t_ in ths:
            t_.start()
        time.sleep(0.5)  # the flood lands while the predictor is gated
        release.set()
        for t_ in ths:
            t_.join(timeout=30)
        n429 = statuses.count(429)
        assert statuses.count(200) >= 1 and n429 >= 1, statuses
        assert all(h is not None and int(h) >= 1
                   for s, h in zip(statuses, headers) if s == 429)
        assert set(statuses) <= {200, 429}
        assert _get_json(port, "/stats")["n_shed"] == n429
    finally:
        release.set()
        _stop(srv, batcher, th)


def test_request_timeout_returns_503_and_abandons_rows():
    gate = threading.Event()
    started = threading.Event()
    seen_rows = []

    def gated(w, c, y, i, weather_feature_mask=None):
        seen_rows.append(w.shape[0])
        started.set()
        gate.wait(timeout=10)
        return np.zeros(w.shape, np.float32)

    mb = MicroBatcher(gated, max_batch=64, max_wait_ms=1.0,
                      request_timeout_s=0.3)
    try:
        errs = []

        def waiter():
            try:
                mb.submit(*_arrays(2, 40))
            except RequestTimeout as e:
                errs.append(e)

        t0 = threading.Thread(target=waiter)
        t0.start()
        assert started.wait(timeout=10)
        t1 = threading.Thread(target=waiter)  # queued behind the gate
        t1.start()
        t1.join(timeout=10)
        gate.set()
        t0.join(timeout=10)
        assert len(errs) == 2 and mb.stats()["n_timeouts"] == 2
        time.sleep(0.2)  # let the worker drain
        assert seen_rows == [2]  # the abandoned request was never computed
    finally:
        gate.set()
        mb.close()


# ---- the JAX daemon and the port's on the same weights ---------------------

def test_port_daemon_answers_as_the_jax_daemon():
    jax_cfg = JaxModelConfig(num_heads=4, num_layers=1, hidden_dim_factor=12,
                             max_len=T, dropout_rate=0.0)
    jax_model = JaxWeatherBERT(jax_cfg)
    # the port's seeded init in the flax tree (test_torch_port_jax_params.py)
    model = WeatherBERT(CFG, attention_impl="torch")
    model.reset_parameters(torch.Generator().manual_seed(0))
    params = jax_params_from_state(
        lambda: jax_model.init(jax.random.PRNGKey(0),
                               *map(np.asarray, _arrays(2))),
        state_dict_from_jax_params, model.state_dict())
    body = _npz(**_kw(_arrays(5, 50)))
    answers = []
    for pred, make in ((JaxPredictor(jax_model, params, buckets=(8,)),
                        jax_make_server),
                       (WeatherPredictor(model, (8,), device="cpu"),
                        make_server)):
        srv, batcher = make(pred, port=0, max_wait_ms=1.0)
        th = _start(srv)
        try:
            status, data = _post(srv.server_address[1], "/predict", body)
            assert status == 200
            with np.load(io.BytesIO(data)) as z:
                answers.append(z["output"])
        finally:
            _stop(srv, batcher, th)
    assert answers[1].shape == answers[0].shape == (5, T, F)
    np.testing.assert_allclose(answers[1], answers[0], atol=5e-5, rtol=1e-4)


# ---- wm-serve-torch --daemon ------------------------------------------------

def test_daemon_flag_needs_a_card_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = port_serve.build_parser().parse_args([
        "--daemon", "--checkpoint", str(tmp_path / "x.pth")])
    with pytest.raises(SystemExit, match="--device cpu"):
        port_serve.run(args)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_daemon_process_serves_and_drains_on_sigterm(tmp_path):
    """`python -m weathermodel_tpu_torch.cli.serve --daemon --device cpu`:
    /healthz, an answer equal to the offline predictor's, a reload, and exit
    0 on SIGTERM."""
    mini = model_config_for_size("mini", max_len=T)
    for seed, name in ((0, "a.pth"), (7, "b.pth")):
        torch.save(_model(seed, mini).state_dict(), tmp_path / name)
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "weathermodel_tpu_torch.cli.serve",
         "--daemon", "--checkpoint", str(tmp_path / "a.pth"), "--model",
         "weatherbert", "--model-size", "mini", "--batch-size", "8",
         "--seq-len", str(T), "--compute-dtype", "float32",
         "--allow-reload", "--port", str(port), "--device", "cpu"],
        cwd=tmp_path, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                assert _get_json(port, "/healthz") == {"ok": True}
                break
            except (ConnectionError, OSError):
                assert proc.poll() is None, proc.stderr.read()
                assert time.monotonic() < deadline, "daemon did not start"
                time.sleep(0.2)
        args = _arrays(5, 60)
        for ckpt in ("a.pth", "b.pth"):
            if ckpt == "b.pth":
                status, _ = _post(port, "/reload", json.dumps(
                    {"checkpoint": str(tmp_path / ckpt)}).encode())
                assert status == 200
            status, data = _post_npz(port, **_kw(args))
            assert status == 200
            offline = load_weather_predictor(
                str(tmp_path / ckpt), "mini", max_len=T, buckets=(8,),
                compute_dtype="float32", device="cpu")(*args)
            with np.load(io.BytesIO(data)) as z:
                np.testing.assert_allclose(z["output"], offline, atol=1e-5,
                                           rtol=1e-5)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
