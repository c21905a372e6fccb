"""Batched inference (port of weathermodel_tpu/serve.py:23-135,194-261).

Loads a reference-format `.pth` checkpoint and returns an eval-mode
predictor on one device. Requests are padded with zero rows up to a small
set of bucket batch sizes, as the JAX package does to bound its compiled
programs; here it bounds the shapes the kernels see. Requests larger than
the largest bucket are chunked by it.

    predictor = load_weather_predictor("wb_large.pth", "large",
                                       device="cuda")
    out = predictor(weather, coords, year, interval, mask)
"""

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
    them."""

    def __init__(self, model: torch.nn.Module,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.buckets = tuple(sorted(buckets))

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

        with torch.inference_mode():
            out = self.model(
                place(weather, np.float32), place(coords, np.float32),
                place(year, np.float32), place(interval, np.float32),
                place(weather_feature_mask, bool))
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy()[:n] for o in out)
        return out.cpu().numpy()[:n]


def load_weather_predictor(
    checkpoint_path: str,
    model_size: str = "small",
    model_name: str = "weatherbert",
    attention_impl: str = "fused_qkv",
    max_len: int = 365,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    num_experts: int = 0,
    quantize: str = "none",
    compute_dtype: str = "bfloat16",
    mesh=None,
    device="cuda",
) -> WeatherPredictor:
    """Build the model, load a reference `.pth` state dict into it and wrap
    it in a WeatherPredictor on `device`. Parameters stay fp32; the forward
    computes in `compute_dtype`."""
    from weathermodel_tpu_torch.cli.pretrain import (
        load_pretrained_params,
        make_model,
    )

    if mesh is not None:
        raise NotImplementedError(
            "sharded serving over a device mesh is not ported yet; see "
            "ROADMAP.md queue A item 14")
    if quantize != "none":
        raise NotImplementedError(
            f"quantize={quantize!r} (int8 serving, ops/quant.py) is not "
            "ported yet; see ROADMAP.md queue A item 13")
    if num_experts > 0:
        raise NotImplementedError(
            "MoE serving is not ported yet; see ROADMAP.md queue A item 12")
    cfg = model_config_for_size(model_size, max_len=max_len,
                                compute_dtype=compute_dtype)
    model = make_model(model_name, cfg, attention_impl)
    state_dict = load_pretrained_params(checkpoint_path)
    if any(".moe." in k for k in state_dict):
        raise ValueError(
            f"checkpoint {checkpoint_path} contains MoE expert params but "
            "the predictor was requested with num_experts=0")
    missing = [k for k in model.state_dict() if k not in state_dict]
    if missing:
        raise ValueError(
            f"checkpoint {checkpoint_path} lacks {len(missing)} parameters "
            f"of {model_name}-{model_size} (first: {missing[:3]}); wrong "
            "--model/--model-size?")
    # keys the model does not have (e.g. a reference PE buffer) are ignored,
    # as the JAX package's converter ignores them
    model.load_state_dict({k: state_dict[k] for k in model.state_dict()})
    return WeatherPredictor(model, buckets, device=device)
