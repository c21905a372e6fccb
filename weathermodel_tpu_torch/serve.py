"""Batched inference (port of weathermodel_tpu/serve.py).

Loads a reference-format `.pth` checkpoint and returns an eval-mode
predictor on one device. Requests are padded with zero rows up to a small
set of bucket batch sizes, as the JAX package does to bound its compiled
programs; here it bounds the shapes the kernels see. Requests larger than
the largest bucket are chunked by it.

    predictor = load_weather_predictor("wb_large.pth", "large",
                                       device="cuda")
    out = predictor(weather, coords, year, interval, mask)

`quantize="int8"` serves the FFN matmuls W8A8 with dynamic activation
scales, `"int8_static"` with per-channel activation scales that
`calibrate_quant_scales` takes offline from `calibration_batches` (and the
attention out-projection too under `ops.quant.set_attn_out_quant`); a MoE
model serves int8_static through the sort layout (ops/quant.py,
models/moe.py).

`reload_predictor_params` hot-swaps a predictor's weights from a new `.pth`
(the online daemon's POST /reload): the new weights are loaded into a
second copy of the module on the device and the predictor's one reference
to its module is swapped, so a batch in flight finishes on the weights it
started with. The copy keeps the served calibration (the scale buffers are
not in a checkpoint), as the JAX package keeps its `quant` collection.
"""

import copy
import dataclasses
import logging
from typing import Sequence

import numpy as np
import torch

from weathermodel_tpu_torch.utils.config import model_config_for_size

logger = logging.getLogger(__name__)

DEFAULT_BUCKETS = (8, 32, 128, 512)


class WeatherPredictor:
    """Deterministic batched forward of `model` on `device` with batch
    bucketing. Inputs and outputs are numpy arrays; a model with several
    outputs (the WeatherFormer family: mu, var, ...) gives a tuple of
    them. Each call reads `self.model` once, so `swap_state` may replace it
    from another thread."""

    def __init__(self, model: torch.nn.Module,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.buckets = tuple(sorted(buckets))

    def swap_state(self, state_dict) -> int:
        """Replace the served parameters with `state_dict` (the model's
        keys, shapes and dtypes; a mismatch raises before anything is
        touched). The new weights go into a copy of the module on the
        device, and the device is synchronized before the predictor's
        reference moves to it: a batch in flight finishes on the module it
        read, never on a mix. Returns the number of parameters."""
        model = self.model
        current = model.state_dict()
        if set(state_dict) != set(current):
            raise ValueError(
                "checkpoint parameter tree does not match the serving "
                "model (wrong --model/--model-size/--moe-experts?)")
        bad = [f"{k}: {tuple(current[k].shape)}/{current[k].dtype} != "
               f"{tuple(v.shape)}/{v.dtype}"
               for k, v in state_dict.items()
               if v.shape != current[k].shape or v.dtype != current[k].dtype]
        if bad:
            raise ValueError("checkpoint leaf mismatch vs serving model: "
                             + "; ".join(bad[:5]))
        staged = copy.deepcopy(model)
        staged.load_state_dict(state_dict)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # resident before the swap
        self.model = staged
        return sum(v.numel() for v in state_dict.values())

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]  # callers > largest bucket are chunked

    def __call__(self, weather, coords, year, interval,
                 weather_feature_mask=None):
        weather = np.asarray(weather, np.float32)
        n = weather.shape[0]
        if weather_feature_mask is None:
            weather_feature_mask = np.zeros(weather.shape, bool)
        big = self.buckets[-1]
        if n > big:  # chunk large requests by the largest bucket
            outs = [self(weather[i:i + big], coords[i:i + big],
                         year[i:i + big], interval[i:i + big],
                         weather_feature_mask[i:i + big])
                    for i in range(0, n, big)]
            if isinstance(outs[0], tuple):
                return tuple(np.concatenate(parts) for parts in zip(*outs))
            return np.concatenate(outs)
        pad = self._bucket(n) - n

        def place(x, dtype):
            x = np.asarray(x, dtype)
            x = np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
            return torch.from_numpy(x).to(self.device)

        model = self.model  # read once: swap_state may replace it
        with torch.inference_mode():
            out = model(
                place(weather, np.float32), place(coords, np.float32),
                place(year, np.float32), place(interval, np.float32),
                place(weather_feature_mask, bool))
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy()[:n] for o in out)
        return out.cpu().numpy()[:n]


def calibrate_quant_scales(model_name, cfg, state_dict, batches,
                           attention_impl: str = "torch",
                           dropless_moe_stats: bool = True,
                           device="cuda") -> dict:
    """Offline calibration for `ffn_impl="int8_static"` (JAX
    serve.py:138-191): run the float model with `state_dict` on `device`
    over `batches` (an iterable of (weather, coords, year, interval, mask)
    numpy tuples) and record, per encoder layer, the per-channel absmax of
    each quantized matmul's input: the FFN input and its post-ReLU hidden
    (per expert for MoE layers), and the attention out-projection's input
    under `ops.quant.set_attn_out_quant`. Across batches the statistics
    combine by an elementwise max. Returns {scale-buffer name: fp32 CPU
    tensor} for `models/transfer.py::load_quant_scales`.

    MoE models calibrate through the dropless ragged dispatch (unless
    `dropless_moe_stats` is False), whatever layout serves: the sort
    layout's over-capacity tokens would be missing from the statistics."""
    from weathermodel_tpu_torch.cli.pretrain import make_model

    if dropless_moe_stats and cfg.num_experts > 0 \
            and cfg.moe_dispatch != "ragged":
        cfg = dataclasses.replace(cfg, moe_dispatch="ragged")
    model = make_model(model_name, cfg, attention_impl, ffn_impl="calibrate")
    model.load_state_dict(_model_keys(model, state_dict))
    model = model.to(device).eval()
    n = 0
    with torch.inference_mode():
        for batch in batches:
            weather, coords, year, interval, mask = (
                torch.from_numpy(np.asarray(a, dtype)).to(device)
                for a, dtype in zip(batch, (np.float32,) * 4 + (bool,)))
            model(weather, coords, year, interval, mask)
            n += weather.shape[0]
    if n == 0:
        raise ValueError("calibration requires at least one batch")
    logger.info("calibrated int8 activation scales over %d windows", n)
    return {name: buf.cpu() for name, buf in model.named_buffers()
            if name.endswith("_amax") and buf.numel() > 0}


def load_weather_predictor(
    checkpoint_path: str,
    model_size: str = "small",
    model_name: str = "weatherbert",
    attention_impl: str = "fused_qkv",
    max_len: int = 365,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    num_experts: int = 0,
    moe_top_k: int = 2,
    quantize: str = "none",
    compute_dtype: str = "bfloat16",
    mesh=None,
    device="cuda",
    calibration_batches=None,
) -> WeatherPredictor:
    """Build the model, load a reference `.pth` state dict into it and wrap
    it in a WeatherPredictor on `device`. Parameters stay fp32; the forward
    computes in `compute_dtype`. `num_experts` and `moe_top_k` must match
    the checkpoint's training config: MoE layers run the dropless ragged
    dispatch (exact under bucket padding: rows are independent), and a
    checkpoint whose MoE-ness differs from `num_experts` raises.

    `quantize` "int8" serves the FFN matmuls W8A8 with dynamic scales;
    "int8_static" calibrates static scales on `calibration_batches` first
    (`calibrate_quant_scales`) and serves MoE layers through the sort
    layout, whose per-row capacity keeps rows independent of the padding
    too."""
    from weathermodel_tpu_torch.cli.pretrain import (
        load_pretrained_params,
        make_model,
    )
    from weathermodel_tpu_torch.models.transfer import (
        has_moe_layers,
        load_quant_scales,
    )

    if mesh is not None:
        raise NotImplementedError(
            "sharded serving over a device mesh is not ported yet; see "
            "ROADMAP.md queue A item 14")
    if quantize not in ("none", "int8", "int8_static"):
        raise ValueError(f"quantize must be 'none', 'int8' or "
                         f"'int8_static', got {quantize!r}")
    if quantize == "int8_static" and calibration_batches is None:
        raise ValueError(
            "quantize='int8_static' needs calibration_batches: an iterable "
            "of (weather, coords, year, interval, mask) tuples of "
            "representative inputs (see serve.calibrate_quant_scales)")
    # int8_static's expert einsum is wired to the capacity (sort) layout
    moe_overrides = ({"moe_dispatch": "sort"}
                     if quantize == "int8_static" and num_experts > 0
                     else {})
    cfg = model_config_for_size(model_size, max_len=max_len,
                                num_experts=num_experts, moe_top_k=moe_top_k,
                                compute_dtype=compute_dtype, **moe_overrides)
    ffn_impl = quantize if quantize != "none" else "torch"
    model = make_model(model_name, cfg, attention_impl, ffn_impl=ffn_impl)
    state_dict = load_pretrained_params(checkpoint_path)
    if has_moe_layers(state_dict) != (num_experts > 0):
        raise ValueError(
            f"checkpoint {checkpoint_path} "
            f"{'contains' if has_moe_layers(state_dict) else 'lacks'} MoE "
            f"expert params but the predictor was requested with "
            f"num_experts={num_experts}; pass --moe-experts matching the "
            "training config")
    missing = [k for k in model.state_dict() if k not in state_dict]
    if missing:
        raise ValueError(
            f"checkpoint {checkpoint_path} lacks {len(missing)} parameters "
            f"of {model_name}-{model_size} (first: {missing[:3]}); wrong "
            "--model/--model-size?")
    model.load_state_dict(_model_keys(model, state_dict))
    if quantize == "int8_static":
        load_quant_scales(model, calibrate_quant_scales(
            model_name, cfg, state_dict, calibration_batches,
            attention_impl=attention_impl, device=device))
    return WeatherPredictor(model, buckets, device=device)


def _model_keys(model, state_dict) -> dict:
    """The entries of `state_dict` that `model` has: keys the model does
    not have (e.g. a reference PE buffer) are ignored, as the JAX package's
    converter ignores them."""
    return {k: state_dict[k] for k in model.state_dict() if k in state_dict}


def reload_predictor_params(predictor: WeatherPredictor,
                            checkpoint_path: str) -> int:
    """Hot-reload `predictor` from a new reference `.pth` of the same
    architecture (`swap_state` checks keys, shapes and dtypes; MoE-ness is
    checked here with `load_weather_predictor`'s message), without
    dropping traffic: the daemon's POST /reload. An int8_static predictor
    keeps its calibrated scales (checkpoints carry none; JAX
    serve.py:286-292). Returns the parameter count."""
    from weathermodel_tpu_torch.cli.pretrain import load_pretrained_params
    from weathermodel_tpu_torch.models.transfer import has_moe_layers

    cfg = getattr(predictor.model, "cfg", None)
    if cfg is None:
        raise ValueError("predictor.model has no cfg; cannot reload")
    state_dict = load_pretrained_params(checkpoint_path)
    if has_moe_layers(state_dict) != (cfg.num_experts > 0):
        raise ValueError(
            f"checkpoint {checkpoint_path} "
            f"{'contains' if has_moe_layers(state_dict) else 'lacks'} MoE "
            f"expert params but the serving model was built with "
            f"num_experts={cfg.num_experts}")
    n = predictor.swap_state(_model_keys(predictor.model, state_dict))
    logger.info("hot-reloaded %d params from %s", n, checkpoint_path)
    return n
