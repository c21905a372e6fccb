"""Reference checkpoints in and out of the port (port of
weathermodel_tpu/models/transfer.py:107-171).

The port's models' `state_dict()`s use the reference's keys and torch's
[out, in] weight layout, so a reference `.pth` loads with no conversion.
`state_dict_from_jax_params` maps a flax param tree of WeatherBERT or of the
WeatherFormer family to that state dict: it is the exact inverse of the JAX
package's `convert_torch_state_dict`.
"""

import numpy as np
import torch

_LAYER_KEYS = {"self_attn", "linear1", "linear2", "norm1", "norm2"}
# the WeatherFormer priors' top-level parameters, kept untransposed
# (weathermodel_tpu/models/transfer.py:27-30)
PRIOR_PARAM_NAMES = ("frequency", "phase", "amplitude", "log_var_prior",
                     "log_var_k", "mixture_logits")


def load_reference_checkpoint(path: str) -> dict:
    """State dict of a reference checkpoint: a whole-module pickle, a
    checkpoint dict holding `model_state_dict`, or a bare state dict (the
    reference saves all three, base_trainer.py:127-146). DDP `module.`
    prefixes are stripped. Whole-module pickles need full unpickling, so
    load only checkpoints from a trusted source."""
    obj = torch.load(path, weights_only=False, map_location="cpu")
    if hasattr(obj, "state_dict"):
        state_dict = obj.state_dict()
    elif isinstance(obj, dict) and "model_state_dict" in obj:
        state_dict = obj["model_state_dict"]
    else:
        state_dict = obj
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def state_dict_from_jax_params(params) -> dict:
    """flax WeatherBERT or WeatherFormer param tree (numpy or jax arrays,
    with or without the top-level 'params') -> the port's state dict of CPU
    tensors."""
    p = params["params"] if "params" in params else params
    unknown = set(p) - {"core", "out_proj", *PRIOR_PARAM_NAMES}
    if unknown:
        raise ValueError(f"not a WeatherBERT/WeatherFormer param tree: "
                         f"unexpected top-level entries {sorted(unknown)}")
    sd = {}

    def dense(prefix, node):
        sd[prefix + "weight"] = _tensor(np.asarray(node["kernel"]).T)
        sd[prefix + "bias"] = _tensor(node["bias"])

    def norm(prefix, node):
        sd[prefix + "weight"] = _tensor(node["scale"])
        sd[prefix + "bias"] = _tensor(node["bias"])

    core = p["core"]
    dense("in_proj.", core["in_proj"])
    encoder = core["encoder"]
    for i in range(len(encoder)):
        layer = encoder[f"layer_{i}"]
        if set(layer) != _LAYER_KEYS:
            raise ValueError(f"layer_{i} is not a dense post-LN layer: "
                             f"{sorted(layer)}")
        pre = f"transformer_encoder.layers.{i}."
        dense(pre + "self_attn.in_proj_", layer["self_attn"]["qkv_proj"])
        dense(pre + "self_attn.out_proj.", layer["self_attn"]["out_proj"])
        dense(pre + "linear1.", layer["linear1"])
        dense(pre + "linear2.", layer["linear2"])
        norm(pre + "norm1.", layer["norm1"])
        norm(pre + "norm2.", layer["norm2"])
    if "out_proj" in p:
        dense("out_proj.", p["out_proj"])
    for name in PRIOR_PARAM_NAMES:
        if name in p:
            sd[name] = _tensor(p[name])
    return sd
