"""Ahead-of-time model export via `torch.export` (port of
weathermodel_tpu/export_artifact.py).

Freezes the deterministic serving forward, weights baked in, into a bundle
that serves without the checkpoint and without the port's model code:

    from weathermodel_tpu_torch.export_artifact import ExportedPredictor
    pred = ExportedPredictor("model.wmx")
    out = pred(weather, coords, year, interval, mask)

A bundle is an `.npz`: a JSON manifest (JAX's keys `format`, `seq_len`,
`buckets`, `platforms`, `weather_dim`, the export's meta, and `ops`, the
custom ops its programs hold) and one `torch.export.save` program per
padding bucket and platform (`bucket_{b}_{platform}`). JAX lowers one
StableHLO artifact for several platforms; the port traces one program per
platform, because the int8 matmul is `torch._int_mm` on the card and an
exact int32 product on the CPU (ops/quant.py). A program for "cuda" is
traced and runs on the card: exporting or loading one without a card
raises.

Shapes are fixed at export time ([bucket, seq_len], the calling convention
JAX's positional (weather, coords, year, interval, mask)), and the caller
builds the model with the plain attention (`torch`, JAX's `xla`): the
attention kernels' ctypes launches are opaque to `torch.export`. A MoE
model's ragged experts keep kernel B4: with gradients off they call the op
`torch.ops.wm.gmm` (ops/gmm.py), which the program records as a node, and
on the card that node launches B4. Loading a program that holds a custom op
imports the one module that registers it (`OP_MODULES`) and nothing else of
the package; a dense bundle's programs need no module of the port at all
(`torch.export.load` on the blobs is enough). Loading raises on a JAX
bundle, on an op no module registers, and on a platform the bundle lacks;
it never falls back to another path.
"""

import copy
import importlib
import io
import json
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

MAGIC = "weathermodel_tpu_torch.export/v1"
JAX_MAGIC = "weathermodel_tpu.export/v1"
PLATFORMS = ("cuda", "cpu")
# custom op a program may hold -> the module that registers it
OP_MODULES = {"wm::gmm": "weathermodel_tpu_torch.ops.gmm"}


def _device(platform: str) -> torch.device:
    if platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got "
                         f"{platform!r}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda program is traced and runs on the card, "
                           "and no CUDA device is available")
    return torch.device(platform)


def _example_inputs(batch_size: int, seq_len: int, weather_dim: int,
                    device) -> tuple:
    """Seeded inputs of the export geometry, in the calling convention."""
    g = torch.Generator().manual_seed(0)
    b, t, f = batch_size, seq_len, weather_dim
    return tuple(a.to(device) for a in (
        torch.randn(b, t, f, generator=g), torch.zeros(b, 2),
        torch.full((b, t), 1990.0), torch.full((b, 1), 7.0),
        torch.rand(b, t, f, generator=g) < 0.15))


def custom_ops(program) -> list:
    """The custom ops (`namespace::name`, outside aten/prims) that an
    ExportedProgram's graph calls."""
    names = set()
    for node in program.graph.nodes:
        schema = getattr(node.target, "_schema", None)
        if node.op == "call_function" and schema is not None:
            if schema.name.split("::")[0] not in ("aten", "prims"):
                names.add(schema.name)
    return sorted(names)


def _export(model, batch_size: int, seq_len: int, platform: str):
    """(ExportedProgram, seconds) of `model`'s eval forward on `platform`
    at [batch_size, seq_len]."""
    device = _device(platform)
    model = model.to(device).eval()
    args = _example_inputs(batch_size, seq_len, model.cfg.weather_dim,
                           device)
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(model, args)
    return program, time.perf_counter() - t0


def export_forward(model, state: Optional[dict], batch_size: int,
                   seq_len: int, platform: str = "cuda") -> bytes:
    """`torch.export.save` bytes of `model`'s eval forward for fixed
    [batch_size, seq_len] on `platform` ("cuda" or "cpu"), with `state`
    (a state dict of `model`, or None for the weights it holds) baked in.
    The caller's module is left where it was."""
    model = copy.deepcopy(model)
    if state is not None:
        model.load_state_dict(state)
    program, _ = _export(model, batch_size, seq_len, platform)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def write_bundle(path: str, model, state: Optional[dict],
                 buckets: Sequence[int], seq_len: int,
                 platforms: Sequence[str] = ("cuda", "cpu"),
                 meta: Optional[dict] = None) -> dict:
    """Write an .npz bundle: one program per bucket and platform plus the
    JSON manifest. Returns the manifest; its `export_seconds` holds each
    program's trace time."""
    model = copy.deepcopy(model)
    if state is not None:
        model.load_state_dict(state)
    arrays, ops, seconds = {}, set(), {}
    for platform in platforms:
        for b in buckets:
            program, s = _export(model, int(b), seq_len, platform)
            unknown = set(custom_ops(program)) - set(OP_MODULES)
            if unknown:
                raise ValueError(f"the program calls {sorted(unknown)}, "
                                 "which no module of the port registers")
            ops.update(custom_ops(program))
            buf = io.BytesIO()
            torch.export.save(program, buf)
            name = f"bucket_{int(b)}_{platform}"
            arrays[name] = np.frombuffer(buf.getvalue(), dtype=np.uint8)
            seconds[name] = round(s, 3)
    manifest = {
        "format": MAGIC,
        "seq_len": int(seq_len),
        "buckets": [int(b) for b in buckets],
        "platforms": list(platforms),
        "weather_dim": int(model.cfg.weather_dim),
        "ops": sorted(ops),
        **(meta or {}),
    }
    buf = io.BytesIO()
    np.savez(buf, manifest=np.frombuffer(json.dumps(manifest).encode(),
                                         dtype=np.uint8), **arrays)
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())
    return {**manifest, "export_seconds": seconds}


def _require_op(name: str) -> None:
    """Import the module that registers the custom op `name` and check that
    the op exists; raise otherwise."""
    module = OP_MODULES.get(name)
    if module is None:
        raise ValueError(f"the bundle needs the op {name}, which no module "
                         "of weathermodel_tpu_torch registers")
    importlib.import_module(module)
    namespace, op = name.split("::")
    try:
        getattr(getattr(torch.ops, namespace), op)
    except AttributeError:
        raise RuntimeError(f"the bundle needs the op {name}, and importing "
                           f"{module} did not register it") from None


def _platform(manifest: dict, path: str, platform: Optional[str]) -> str:
    have = manifest["platforms"]
    if platform is None:
        platform = ("cuda" if "cuda" in have and torch.cuda.is_available()
                    else "cpu" if "cpu" in have else have[0])
    if platform not in have:
        raise ValueError(f"bundle {path} holds programs for {have}, not "
                         f"{platform!r}")
    _device(platform)
    return platform


def load_bundle(path: str, platform: Optional[str] = None
                ) -> Tuple[dict, dict]:
    """Load a bundle -> (manifest, {bucket_size: callable}), the programs of
    `platform` (default: "cuda" when the bundle has it and a card is
    present, else "cpu"), which the manifest's `platform` then names. Each
    callable is the program's module; no model code of the port is
    imported, only the modules of the custom ops the manifest names."""
    with np.load(path) as z:
        manifest = json.loads(bytes(z["manifest"].tobytes()).decode())
        fmt = manifest.get("format")
        if fmt == JAX_MAGIC:
            raise ValueError(
                f"{path} is a JAX bundle ({JAX_MAGIC}: StableHLO, served "
                f"by wm-serve --bundle); this loader takes {MAGIC} bundles "
                "(wm-export-torch)")
        if fmt != MAGIC:
            raise ValueError(f"{path} is not a weathermodel export bundle")
        manifest["platform"] = _platform(manifest, path, platform)
        for name in manifest.get("ops", []):
            _require_op(name)
        fns = {}
        for b in manifest["buckets"]:
            blob = z[f"bucket_{b}_{manifest['platform']}"].tobytes()
            fns[int(b)] = torch.export.load(io.BytesIO(blob)).module()
    return manifest, fns


class ExportedPredictor:
    """Bucketed batch inference from a bundle alone (serve.WeatherPredictor's
    padding semantics, without the model code): numpy in, numpy out."""

    def __init__(self, path: str, platform: Optional[str] = None):
        t0 = time.perf_counter()
        self.manifest, self._fns = load_bundle(path, platform)
        self.load_seconds = time.perf_counter() - t0
        self.device = torch.device(self.manifest["platform"])
        self.buckets = tuple(sorted(self._fns))
        self.seq_len = self.manifest["seq_len"]

    def __call__(self, weather, coords, year, interval, mask):
        n = weather.shape[0]
        big = self.buckets[-1]
        if n > big:  # chunk large requests by the largest bucket, like
            # the live serve.WeatherPredictor (the daemon's MicroBatcher
            # can coalesce a drained queue past max_batch rows)
            outs = [self(weather[i:i + big], coords[i:i + big],
                         year[i:i + big], interval[i:i + big],
                         mask[i:i + big]) for i in range(0, n, big)]
            if isinstance(outs[0], tuple):
                return tuple(np.concatenate(parts) for parts in zip(*outs))
            return np.concatenate(outs)
        b = [bb for bb in self.buckets if bb >= n][0]
        pad = b - n

        def place(a, dtype):
            a = np.pad(np.asarray(a, dtype), [(0, pad)] + [(0, 0)] * (
                np.ndim(a) - 1))
            return torch.from_numpy(a).to(self.device)

        with torch.inference_mode():
            out = self._fns[b](
                place(weather, np.float32), place(coords, np.float32),
                place(year, np.float32), place(interval, np.float32),
                place(mask, bool))
        if isinstance(out, (tuple, list)):
            return tuple(o.cpu().numpy()[:n] for o in out)
        return out.cpu().numpy()[:n]


class BundleServingPredictor:
    """ExportedPredictor adapted to the online daemon's predictor contract
    (serving_daemon.MicroBatcher / warmup): `buckets`, `seq_len`,
    `weather_dim` and the keyword `weather_feature_mask` calling convention,
    plus hot bundle reload for POST /reload. `wm-export-torch` freezes a
    checkpoint into a bundle, and `wm-serve-torch --daemon --bundle` serves
    it: the serving host needs the bundle and torch, not the checkpoint or
    the model code."""

    def __init__(self, path: str, platform: Optional[str] = None):
        self._pred = ExportedPredictor(path, platform)
        self.path = path

    @property
    def buckets(self):
        return self._pred.buckets

    @property
    def seq_len(self) -> int:
        return self._pred.seq_len

    @property
    def weather_dim(self) -> int:
        return int(self._pred.manifest["weather_dim"])

    @property
    def platform(self) -> str:
        return self._pred.manifest["platform"]

    def __call__(self, weather, coords, year, interval,
                 weather_feature_mask=None):
        if weather_feature_mask is None:
            weather_feature_mask = np.zeros(np.shape(weather), bool)
        return self._pred(weather, coords, year, interval,
                          weather_feature_mask)

    def reload_bundle(self, path: str) -> int:
        """Swap in a new bundle with no dropped traffic: the incoming
        bundle is checked against the served geometry (seq_len, weather_dim
        and the bucket set must match: the daemon's warmed programs and
        request contract are keyed on them), loaded for the served
        platform, and every bucket is run once before the atomic swap, so
        no request waits on a cold program. Returns the bucket count (the
        programs bake the weights in; there is no parameter tree to
        count)."""
        new = ExportedPredictor(path, self.platform)
        for key in ("seq_len", "weather_dim"):
            if new.manifest[key] != self._pred.manifest[key]:
                raise ValueError(
                    f"bundle {path} has {key}={new.manifest[key]} but the "
                    f"daemon serves {key}={self._pred.manifest[key]}")
        if new.buckets != self._pred.buckets:
            raise ValueError(
                f"bundle {path} buckets {new.buckets} != served buckets "
                f"{self._pred.buckets}")
        t, f = new.seq_len, int(new.manifest["weather_dim"])
        for b in new.buckets:   # warm before swap: no cold first request
            new(np.zeros((b, t, f), np.float32), np.zeros((b, 2), np.float32),
                np.full((b, t), 1990.0, np.float32),
                np.full((b, 1), 7.0, np.float32), np.zeros((b, t, f), bool))
        self._pred = new        # atomic: in-flight calls hold the old ref
        self.path = path
        return len(new.buckets)
