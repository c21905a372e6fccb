"""Online serving daemon: HTTP front end + request micro-batching (port of
weathermodel_tpu/serving_daemon.py, numpy and the standard library only).

  * **Micro-batching**: concurrent requests are coalesced (within
    `max_wait_ms`, up to `max_batch` rows, grouped by [T, F] shape) into
    one device batch before they reach the `WeatherPredictor`
    (weathermodel_tpu_torch/serve.py), so the card sees large,
    bucket-padded batches however small each request is.
  * **Bounded shapes**: batching reuses the predictor's padding buckets,
    so the kernels see a fixed set of batch sizes whatever the mix of
    request sizes.
  * **Observability**: /stats reports request/batch counts, coalescing
    factor, shed/timeout counters, queue depth, and rolling latency
    percentiles.
  * **Load shedding**: the pending queue is bounded (`max_queue_rows`,
    default 8 x max_batch): a request flood gets 429 + Retry-After
    instead of unbounded memory growth; `request_timeout_s` optionally
    bounds any accepted request's end-to-end wait (503 on expiry, the
    abandoned rows are dropped without device compute).

Protocol (stdlib-only, works with `requests` or `curl --data-binary`):

  POST /predict   body = .npz bytes: weather [N,T,F] required; coords
                  [N,2], year [N,T], interval [N,1], mask [N,T,F]
                  optional (pretraining defaults synthesized when absent,
                  the schema of `wm-serve-torch --input`).
                  response = .npz bytes: `output` [N,T,F] (deterministic
                  encoders) or `mu`/`var` (variational heads).
  POST /reload    body = JSON {"checkpoint": "<.pth>"}: hot-swap the
                  served weights with no dropped traffic (serve.py
                  `reload_predictor_params`; a batch in flight finishes on
                  the weights it started with). Same-architecture
                  checkpoints only (key/shape/MoE mismatches: 400). When
                  the daemon serves an exported bundle, {"bundle":
                  "<.wmx>"} is the same request: the new bundle must have
                  the served geometry (export_artifact.py
                  `BundleServingPredictor.reload_bundle`). Gated behind
                  `wm-serve-torch --allow-reload` (403 otherwise).
  GET  /healthz   {"ok": true}
  GET  /stats     JSON counters + latency percentiles (ms) + the served
                  checkpoint or bundle path (`checkpoint`), whether it is a
                  bundle (`bundle`) and the reload count

Start with `wm-serve-torch --daemon --port 8476 --checkpoint ... --model ...`,
or `--bundle model.wmx` to serve a `wm-export-torch` bundle.
"""

import collections
import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class QueueFull(RuntimeError):
    """Load shed: the pending-row queue is at capacity. `retry_after_s`
    estimates when capacity frees up (429 Retry-After)."""

    def __init__(self, queued_rows: int, retry_after_s: float):
        super().__init__(
            f"queue full ({queued_rows} rows pending); retry in "
            f"~{retry_after_s:.1f}s")
        self.retry_after_s = retry_after_s


class RequestTimeout(RuntimeError):
    """The request waited longer than the configured per-request budget;
    the client gets a 503 and its compute slot is abandoned."""


class _Pending:
    __slots__ = ("arrays", "n", "event", "result", "error", "t_enqueue",
                 "abandoned")

    def __init__(self, arrays):
        self.arrays = arrays            # (weather, coords, year, itv, mask)
        self.n = arrays[0].shape[0]
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None
        self.t_enqueue = time.perf_counter()
        self.abandoned = False          # timed-out waiter: skip its rows


class MicroBatcher:
    """Coalesces concurrent predict requests into device-sized batches.

    Requests enqueue; a single worker drains the queue, groups items by
    [T, F] shape, concatenates up to `max_batch` rows per group, runs the
    predictor ONCE per group, and splits the outputs back per request.
    `max_wait_ms` bounds the extra latency a lone request pays waiting
    for company.

    Backpressure (a daemon must bound its memory under a request flood):
    at most `max_queue_rows` rows may be pending; `submit` beyond that
    raises QueueFull, which the HTTP layer maps to 429 + Retry-After.
    `request_timeout_s` bounds how long any accepted request waits end to
    end; an expired waiter raises RequestTimeout (503) and its rows are
    dropped from the queue (not computed) if the worker hasn't picked them
    up yet."""

    def __init__(self, predictor, max_batch: int = 512,
                 max_wait_ms: float = 5.0,
                 max_queue_rows: Optional[int] = None,
                 request_timeout_s: Optional[float] = None):
        self.predictor = predictor
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.max_queue_rows = (max_queue_rows if max_queue_rows is not None
                               else 8 * max_batch)
        self.request_timeout = request_timeout_s
        self._queue: collections.deque = collections.deque()
        self._queued_rows = 0
        self._cv = threading.Condition()
        self._stop = False
        self.n_requests = 0
        self.n_rows = 0
        self.n_batches = 0
        self.n_shed = 0
        self.n_timeouts = 0
        self._latencies: collections.deque = collections.deque(maxlen=1024)
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="wm-microbatcher")
        self._worker.start()

    def _retry_after(self, queued_rows: int) -> float:
        """Rough time for the backlog to drain: batches to go x recent p50
        batch latency (1 s/batch before any data exists)."""
        lats = sorted(self._latencies)
        per_batch = lats[len(lats) // 2] if lats else 1.0
        batches = max(1, -(-queued_rows // self.max_batch))
        return max(0.5, batches * per_batch)

    # ---- client side -------------------------------------------------
    def submit(self, weather, coords, year, interval, mask):
        item = _Pending((weather, coords, year, interval, mask))
        with self._cv:
            if self._stop:
                raise RuntimeError("batcher is shut down")
            if self._queued_rows + item.n > self.max_queue_rows:
                self.n_shed += 1
                raise QueueFull(self._queued_rows,
                                self._retry_after(self._queued_rows))
            self._queue.append(item)
            self._queued_rows += item.n
            self._cv.notify()
        if not item.event.wait(timeout=self.request_timeout):
            with self._cv:
                item.abandoned = True   # worker will skip it if still queued
                self.n_timeouts += 1
            raise RequestTimeout(
                f"request not served within {self.request_timeout:.1f}s "
                f"(overloaded); retry later")
        if item.error is not None:
            raise item.error
        return item.result

    # ---- worker side -------------------------------------------------
    def _collect(self) -> List[_Pending]:
        """Block for the first item, then linger up to max_wait for more
        (or until max_batch rows are queued)."""
        with self._cv:
            while not self._queue and not self._stop:
                self._cv.wait(timeout=0.2)
            if self._stop and not self._queue:
                return []
            deadline = time.perf_counter() + self.max_wait
            total = sum(it.n for it in self._queue)
            while total < self.max_batch and not self._stop:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
                total = sum(it.n for it in self._queue)
            items, self._queue = list(self._queue), collections.deque()
            self._queued_rows = 0
            # timed-out waiters left the building: don't spend device
            # time computing rows nobody will read
            return [it for it in items if not it.abandoned]

    def _loop(self):
        while True:
            items = self._collect()
            if not items:
                with self._cv:
                    if self._stop:
                        return
                continue
            # group by [T, F]: one predictor call per shape
            groups: Dict[Tuple[int, int], List[_Pending]] = {}
            for it in items:
                groups.setdefault(it.arrays[0].shape[1:], []).append(it)
            for group in groups.values():
                self._run_group(group)

    def _run_group(self, group: List[_Pending]):
        try:
            cat = [np.concatenate([it.arrays[i] for it in group])
                   for i in range(5)]
            out = self.predictor(cat[0], cat[1], cat[2], cat[3],
                                 weather_feature_mask=cat[4])
            now = time.perf_counter()
            self.n_batches += 1
            start = 0
            for it in group:
                sl = slice(start, start + it.n)
                if isinstance(out, tuple):
                    it.result = tuple(np.asarray(o)[sl] for o in out)
                else:
                    it.result = np.asarray(out)[sl]
                start += it.n
                self.n_requests += 1
                self.n_rows += it.n
                self._latencies.append(now - it.t_enqueue)
                it.event.set()
        except Exception as e:  # surface per-request, keep the worker alive
            logger.exception("micro-batch failed")
            for it in group:
                it.error = e
                it.event.set()

    def stats(self) -> dict:
        lats = sorted(self._latencies)

        def pct(p):
            return (round(1e3 * lats[min(len(lats) - 1,
                                         int(p * len(lats)))], 3)
                    if lats else None)

        return {
            "n_requests": self.n_requests,
            "n_rows": self.n_rows,
            "n_batches": self.n_batches,
            "n_shed": self.n_shed,
            "n_timeouts": self.n_timeouts,
            "queued_rows": self._queued_rows,
            "max_queue_rows": self.max_queue_rows,
            "rows_per_batch": (round(self.n_rows / self.n_batches, 2)
                               if self.n_batches else None),
            "latency_ms": {"p50": pct(0.50), "p95": pct(0.95),
                           "p99": pct(0.99)},
        }

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._worker.join(timeout=5)


def _parse_request_npz(body: bytes):
    """Decode the request .npz into the predictor's five arrays, applying
    the same defaults as the offline CLI (cli/serve.py)."""
    with np.load(io.BytesIO(body)) as z:
        if "weather" not in z:
            raise ValueError("request .npz must contain 'weather' [N,T,F]")
        weather = np.asarray(z["weather"], np.float32)
        if weather.ndim != 3:
            raise ValueError(f"weather must be [N,T,F], got {weather.shape}")
        n, t, f = weather.shape
        coords = (np.asarray(z["coords"], np.float32) if "coords" in z
                  else np.zeros((n, 2), np.float32))
        year = (np.asarray(z["year"], np.float32) if "year" in z
                else np.full((n, t), 1990.0, np.float32))
        interval = (np.asarray(z["interval"], np.float32) if "interval" in z
                    else np.full((n, 1), 7.0, np.float32))
        mask = (np.asarray(z["mask"], bool) if "mask" in z
                else np.zeros((n, t, f), bool))
    for name, arr, shape in (("coords", coords, (n, 2)),
                             ("year", year, (n, t)),
                             ("interval", interval, (n, 1)),
                             ("mask", mask, (n, t, f))):
        if arr.shape != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {arr.shape}")
    return weather, coords, year, interval, mask


def _encode_response_npz(out) -> bytes:
    buf = io.BytesIO()
    if isinstance(out, tuple):  # variational heads: (mu, var, ...)
        np.savez(buf, mu=np.asarray(out[0]), var=np.asarray(out[1]))
    else:
        np.savez(buf, output=np.asarray(out))
    return buf.getvalue()


def make_server(predictor, host: str = "127.0.0.1", port: int = 8476,
                max_batch: int = 512, max_wait_ms: float = 5.0,
                max_body_mb: float = 512.0, reload_fn=None,
                checkpoint: Optional[str] = None,
                max_queue_rows: Optional[int] = None,
                request_timeout_s: Optional[float] = None):
    """Build (ThreadingHTTPServer, MicroBatcher); caller runs
    serve_forever() (or serve_forever in a thread for tests).

    `reload_fn(checkpoint_path) -> n_params` enables POST /reload
    (hot weight swap); None keeps the route disabled (403).
    `checkpoint` labels the initially served weights (or bundle) in
    /stats, whose `bundle` says whether the predictor serves an exported
    bundle (export_artifact.BundleServingPredictor).
    `max_queue_rows` (default 8 x max_batch) bounds the pending queue:
    beyond it /predict answers 429 + Retry-After. `request_timeout_s`
    bounds any accepted request's end-to-end wait (503 on expiry)."""
    batcher = MicroBatcher(predictor, max_batch=max_batch,
                           max_wait_ms=max_wait_ms,
                           max_queue_rows=max_queue_rows,
                           request_timeout_s=request_timeout_s)
    reload_state = {"checkpoint": checkpoint,
                    "bundle": hasattr(predictor, "reload_bundle"),
                    "n_reloads": 0}
    reload_lock = threading.Lock()

    def _do_reload(body: bytes) -> dict:
        try:
            req = json.loads(body.decode())
            # "bundle" is an accepted alias when serving an exported
            # bundle (wm-serve-torch --daemon --bundle): the reload target
            # is a .wmx path, not a checkpoint
            path = req.get("checkpoint") or req["bundle"]
        except (ValueError, KeyError, TypeError, AttributeError,
                UnicodeDecodeError):
            raise ValueError(
                'body must be JSON {"checkpoint": "<path>"} '
                '(or {"bundle": "<path>"} in bundle mode)') from None
        with reload_lock:   # serialize concurrent reloads; last one wins
            n = reload_fn(path)
            reload_state["checkpoint"] = path
            reload_state["n_reloads"] += 1
        logger.info("reloaded %d params from %s", n, path)
        return {"ok": True, "checkpoint": path, "n_params": n}

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: dict):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {"ok": True})
            elif self.path == "/stats":
                self._send_json(200, {**batcher.stats(), **reload_state})
            else:
                self._send_json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path == "/reload":
                if reload_fn is None:
                    self._send_json(403, {
                        "error": "reload disabled; start wm-serve-torch "
                                 "with --allow-reload"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    result = _do_reload(self.rfile.read(length))
                except Exception as e:
                    self._send_json(400, {"error": str(e)})
                    return
                self._send_json(200, result)
                return
            if self.path != "/predict":
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length <= 0:
                    raise ValueError("empty body (send .npz bytes)")
                if length > max_body_mb * 1e6:
                    raise ValueError(
                        f"body {length} bytes exceeds {max_body_mb} MB")
                arrays = _parse_request_npz(self.rfile.read(length))
            except Exception as e:
                self._send_json(400, {"error": str(e)})
                return
            try:
                out = batcher.submit(*arrays)
            except QueueFull as e:
                self.send_response(429)
                body = json.dumps({"error": str(e)}).encode()
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Retry-After",
                                 str(max(1, round(e.retry_after_s))))
                self.end_headers()
                self.wfile.write(body)
                return
            except RequestTimeout as e:
                self._send_json(503, {"error": str(e)})
                return
            except Exception as e:
                self._send_json(500, {"error": str(e)})
                return
            self._send(200, _encode_response_npz(out),
                       "application/octet-stream")

        def log_message(self, fmt, *args):  # route through logging, quiet
            logger.debug("%s - %s", self.address_string(), fmt % args)

    class _DrainingServer(ThreadingHTTPServer):
        # join in-flight handler threads on server_close(): a shutdown
        # must answer every accepted request before the process exits
        # (stock ThreadingHTTPServer marks handlers daemonic and drops
        # them). Handlers can't hang: every submitted _Pending gets its
        # event set by the worker, success or error.
        daemon_threads = False
        block_on_close = True

    server = _DrainingServer((host, port), Handler)
    server.batcher = batcher  # for tests / shutdown
    return server, batcher


def warmup(predictor, seq_len: int, weather_dim: int):
    """Run every padding bucket once before accepting traffic, so that no
    request pays the kernels' build and load, the CUDA context's lazy
    module loads or the first cuBLAS calls' set-up."""
    for b in predictor.buckets:
        t0 = time.perf_counter()
        predictor(
            np.zeros((b, seq_len, weather_dim), np.float32),
            np.zeros((b, 2), np.float32),
            np.full((b, seq_len), 1990.0, np.float32),
            np.full((b, 1), 7.0, np.float32),
            weather_feature_mask=np.zeros((b, seq_len, weather_dim), bool),
        )
        logger.info("warmed bucket %d (%.1f s)", b,
                    time.perf_counter() - t0)


def serve_forever(predictor, host: str, port: int, max_batch: int,
                  max_wait_ms: float, do_warmup: bool = True,
                  seq_len: int = 365, weather_dim: Optional[int] = None,
                  reload_fn=None, checkpoint: Optional[str] = None,
                  max_queue_rows: Optional[int] = None,
                  request_timeout_s: Optional[float] = None):
    if weather_dim is None:
        # checkpoint predictors carry a model config; bundle predictors
        # (export_artifact.BundleServingPredictor) expose it directly
        weather_dim = getattr(predictor, "weather_dim", None)
    if weather_dim is None:
        cfg = getattr(getattr(predictor, "model", None), "cfg", None)
        weather_dim = cfg.weather_dim if cfg is not None else 31
    if do_warmup:
        warmup(predictor, seq_len, weather_dim)
    server, batcher = make_server(predictor, host, port, max_batch,
                                  max_wait_ms, reload_fn=reload_fn,
                                  checkpoint=checkpoint,
                                  max_queue_rows=max_queue_rows,
                                  request_timeout_s=request_timeout_s)
    logger.info("serving on http://%s:%d (micro-batch <= %d rows, "
                "wait <= %.1f ms) — POST /predict, GET /healthz /stats",
                host, server.server_address[1], max_batch, max_wait_ms)
    # SIGTERM-graceful: the signal stops the accept loop, in-flight
    # requests drain (server_close joins handler threads), then the
    # batcher exits.
    old_handlers = {}
    if threading.current_thread() is threading.main_thread():
        import signal

        def _graceful(sig, frame):
            logger.info("signal %d: draining in-flight requests", sig)
            threading.Thread(target=server.shutdown, daemon=True).start()

        for s in (signal.SIGTERM, signal.SIGINT):
            old_handlers[s] = signal.signal(s, _graceful)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        server.server_close()   # joins in-flight handlers (block_on_close)
        batcher.close()         # worker drains anything still queued
        if old_handlers:
            import signal

            for s, h in old_handlers.items():
                signal.signal(s, h)
        logger.info("shutdown complete: all accepted requests answered")
