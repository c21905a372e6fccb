"""Reference checkpoints in and out of the port, and pretrained-parameter
transfer between model variants (port of
weathermodel_tpu/models/transfer.py:53-171).

The port's models' `state_dict()`s use the reference's keys and torch's
[out, in] weight layout, so a reference `.pth` loads with no conversion.
`state_dict_from_jax_params` maps a flax param tree of WeatherBERT, of the
WeatherFormer family or of the MLP baseline (`fc1`, `fc2`) to that state
dict: for dense layers it is the exact inverse of the JAX package's
`convert_torch_state_dict`. MoE layers
(`layer_i/moe`, models/moe.py) map to `....moe.router.{weight,bias}` (the
kernel transposed) and `....moe.expert_{w1,b1,w2,b2}` in the JAX layout,
which is what the grouped matmul takes. `yield_state_dict_from_jax_params`
does the same for a flax yield-model tree (models/yield_models.py): the
`weather_model` subtree as above under `weather_model.`, the head's
`yield_head/{attn_fc1,attn_fc2,mlp_fc1,mlp_fc2}` as
`weather_attention.{0,2}` and `yield_mlp.{0,2}`, and the variational heads'
dense layers and priors under their own names.
`cnn_state_dict_from_jax_params` maps a flax CNN-family tree
(models/cnn.py: the conv kernels to torch's [out, in, k], the LSTM cell to
`nn.LSTM`'s stacked gates); `gnn_state_dict_from_jax_params` a GNN-RNN tree
(models/gnn.py) the same way, and `chronos_state_dict_from_jax_params` a
Chronos tree (models/chronos.py, whose modules carry the flax names: each
Dense kernel transposed).

`quant_scales_from_jax` maps the JAX package's `quant` collection (the
calibrated int8_static activation scales, as `calibrate_quant_scales`
returns them) to the port's scale-buffer names, which
`serve.calibrate_quant_scales` returns too, and `load_quant_scales` puts
such scales into a model's buffers (outside its state dict).

`load_pretrained` applies the JAX package's transfer rules to these state
dicts: the encoder trunk (`in_proj.*`, `transformer_encoder.*`) always
transfers; `out_proj.*` only when every shape matches (a WeatherFormer from a
WeatherBERT keeps its own [2F, H] head); each prior transfers when both sides
hold it.
"""

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)

_LAYER_KEYS = {"self_attn", "linear1", "linear2", "norm1", "norm2"}
_MOE_LAYER_KEYS = {"self_attn", "moe", "norm1", "norm2"}
_EXPERT_PARAMS = ("expert_w1", "expert_b1", "expert_w2", "expert_b2")
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


def has_moe_layers(state_dict) -> bool:
    """True if a state dict holds MoE expert layers (`.moe.` keys)."""
    return any(".moe." in k for k in state_dict)


def _is_trunk(key: str) -> bool:
    return key.startswith(("in_proj.", "transformer_encoder."))


def load_pretrained(model_name: str, target_state: dict,
                    pretrained_state: dict,
                    load_out_proj: bool = True) -> dict:
    """`target_state` with its transferable entries replaced by the
    pretrained ones (weathermodel_tpu/models/transfer.py:53-100): the
    encoder trunk always; `out_proj.*` when `load_out_proj` and every shape
    matches; each prior of PRIOR_PARAM_NAMES that both hold, raising on a
    shape (k) mismatch. An input-projection or MoE-ness mismatch raises.
    `model_name` is the trainer's key, kept for the JAX signature."""
    del model_name  # the rules do not depend on it, as in the JAX package
    for name, state in (("target", target_state),
                        ("pretrained", pretrained_state)):
        if "in_proj.weight" not in state:
            raise ValueError(f"both state dicts must contain an encoder "
                             f"trunk; the {name} state lacks "
                             "'in_proj.weight'")
    # shapes as the JAX kernel's [in, out], so the message reads the same
    tgt_in = tuple(target_state["in_proj.weight"].shape[::-1])
    src_in = tuple(pretrained_state["in_proj.weight"].shape[::-1])
    if tgt_in != src_in:
        raise ValueError(
            f"expected input dimension {tgt_in} but received {src_in}")
    if has_moe_layers(pretrained_state) != has_moe_layers(target_state):
        raise ValueError(
            "FFN architecture mismatch: one checkpoint uses MoE layers "
            "(--moe-experts) and the other a dense FFN; build the target "
            "with the same num_experts as the pretrained encoder")
    trunk = {k for k in target_state if _is_trunk(k)}
    src_trunk = {k for k in pretrained_state if _is_trunk(k)}
    if trunk != src_trunk:
        missing = sorted(trunk - src_trunk)
        extra = sorted(src_trunk - trunk)
        raise ValueError(
            f"pretrained state lacks {len(missing)} and adds {len(extra)} "
            f"encoder trunk parameters of the model (first: "
            f"{(missing + extra)[:3]}); another --model-size?")
    out = {k: (pretrained_state[k] if k in trunk else v)
           for k, v in target_state.items()}

    heads = [k for k in target_state if k.startswith("out_proj.")]
    src_heads = [k for k in pretrained_state if k.startswith("out_proj.")]
    if heads and src_heads:
        if load_out_proj and sorted(heads) == sorted(src_heads) and all(
                target_state[k].shape == pretrained_state[k].shape
                for k in heads):
            logger.info("Loading out_proj from pretrained model")
            out.update({k: pretrained_state[k] for k in heads})
        else:
            logger.info("Not loading out_proj from pretrained model")

    for name in PRIOR_PARAM_NAMES:
        if name in pretrained_state and name in target_state:
            tgt_shape = tuple(target_state[name].shape)
            src_shape = tuple(pretrained_state[name].shape)
            if tgt_shape != src_shape:
                raise ValueError(f"{name} shape mismatch: {tgt_shape} != "
                                 f"{src_shape} (k mismatch?)")
            out[name] = pretrained_state[name]
    return out


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _dense_into(sd: dict):
    """dense(prefix, node): a flax Dense's kernel [in, out] and bias into
    `sd` as torch's `{prefix}weight` [out, in] and `{prefix}bias`."""

    def dense(prefix, node):
        sd[prefix + "weight"] = _tensor(np.asarray(node["kernel"]).T)
        sd[prefix + "bias"] = _tensor(node["bias"])

    return dense


def state_dict_from_jax_params(params) -> dict:
    """flax WeatherBERT, WeatherFormer or WeatherMLP param tree (numpy or
    jax arrays, with or without the top-level 'params') -> the port's state
    dict of CPU tensors."""
    p = params["params"] if "params" in params else params
    if set(p) == {"fc1", "fc2"}:
        sd = {}
        dense = _dense_into(sd)
        dense("fc1.", p["fc1"])
        dense("fc2.", p["fc2"])
        return sd
    unknown = set(p) - {"core", "out_proj", *PRIOR_PARAM_NAMES}
    if unknown:
        raise ValueError(f"not a WeatherBERT/WeatherFormer/MLP param tree: "
                         f"unexpected top-level entries {sorted(unknown)}")
    sd = {}
    dense = _dense_into(sd)

    def norm(prefix, node):
        sd[prefix + "weight"] = _tensor(node["scale"])
        sd[prefix + "bias"] = _tensor(node["bias"])

    core = p["core"]
    dense("in_proj.", core["in_proj"])
    encoder = core["encoder"]
    for i in range(len(encoder)):
        layer = encoder[f"layer_{i}"]
        if set(layer) not in (_LAYER_KEYS, _MOE_LAYER_KEYS):
            raise ValueError(f"layer_{i} is not a post-LN layer (dense or "
                             f"MoE): {sorted(layer)}")
        pre = f"transformer_encoder.layers.{i}."
        dense(pre + "self_attn.in_proj_", layer["self_attn"]["qkv_proj"])
        dense(pre + "self_attn.out_proj.", layer["self_attn"]["out_proj"])
        if "moe" in layer:
            dense(pre + "moe.router.", layer["moe"]["router"])
            for name in _EXPERT_PARAMS:
                sd[pre + "moe." + name] = _tensor(layer["moe"][name])
        else:
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


# the calibrated activation scales of int8_static: leaf name -> the module
# that holds it within an encoder layer ("" the layer itself)
QUANT_SCALE_OWNERS = {"ffn_in_amax": "", "ffn_hidden_amax": "",
                      "attn_out_amax": "self_attn.",
                      "expert_in_amax": "moe.", "expert_hidden_amax": "moe."}


def quant_scales_from_jax(quant) -> dict:
    """The JAX `quant` collection of a WeatherBERT/WeatherFormer (nested
    dicts of numpy or jax arrays, with or without the top-level 'quant':
    `core/encoder/layer_i/{ffn_in_amax, ffn_hidden_amax, self_attn/
    attn_out_amax, moe/expert_in_amax, moe/expert_hidden_amax}`) -> the
    port's {buffer name: fp32 CPU tensor}, e.g.
    `transformer_encoder.layers.0.self_attn.attn_out_amax`."""
    q = quant["quant"] if "quant" in quant else quant
    out = {}
    encoder = q["core"]["encoder"]
    for layer_name, layer in encoder.items():
        pre = f"transformer_encoder.layers.{layer_name[len('layer_'):]}."

        def walk(node, owner):
            for name, leaf in node.items():
                if isinstance(leaf, dict):
                    walk(leaf, owner + name + ".")
                elif QUANT_SCALE_OWNERS.get(name) != owner:
                    raise ValueError(f"unknown quant leaf {owner}{name} in "
                                     f"{layer_name}")
                else:
                    out[pre + owner + name] = torch.tensor(
                        np.asarray(leaf, np.float32))

        walk(layer, "")
    return out


def load_quant_scales(model: torch.nn.Module, scales: dict) -> None:
    """Put calibrated scales ({buffer name: tensor}, as
    `serve.calibrate_quant_scales` or `quant_scales_from_jax` return them)
    into `model`'s scale buffers, on each buffer's device. Every name must
    be a scale buffer of the model (built with ffn_impl "int8_static" or
    "calibrate")."""
    for key, value in scales.items():
        owner, _, name = key.rpartition(".")
        try:
            module = model.get_submodule(owner)
        except AttributeError:
            module = None
        buf = getattr(module, name, None) if module is not None else None
        if name not in QUANT_SCALE_OWNERS or not isinstance(buf,
                                                            torch.Tensor):
            raise ValueError(f"{key} is not a calibrated-scale buffer of "
                             f"{type(model).__name__} (built with ffn_impl "
                             "'int8_static'?)")
        setattr(module, name, value.to(device=buf.device,
                                       dtype=torch.float32))


# flax yield-head Dense name -> the port's module prefix
_YIELD_HEAD = {"attn_fc1": "weather_attention.0.",
               "attn_fc2": "weather_attention.2.",
               "mlp_fc1": "yield_mlp.0.", "mlp_fc2": "yield_mlp.2."}
_YIELD_DENSE = ("log_var_fc1", "log_var_fc2", "theta_p", "linear")
_YIELD_PRIORS = ("A_p", "log_var_p", "mu_k", "log_var_k")


def yield_state_dict_from_jax_params(params) -> dict:
    """flax yield-model param tree (weathermodel_tpu/models/yield_models.py,
    with or without the top-level 'params') -> the port's yield-model state
    dict of CPU tensors."""
    p = params["params"] if "params" in params else params
    unknown = set(p) - {"weather_model", "yield_head", *_YIELD_DENSE,
                        *_YIELD_PRIORS}
    if unknown:
        raise ValueError(f"not a yield-model param tree: unexpected "
                         f"top-level entries {sorted(unknown)}")
    sd = {}
    if "weather_model" in p:
        sd.update({"weather_model." + k: v for k, v in
                   state_dict_from_jax_params(p["weather_model"]).items()})
    dense = _dense_into(sd)
    if "yield_head" in p:
        for name, prefix in _YIELD_HEAD.items():
            dense(prefix, p["yield_head"][name])
    for name in _YIELD_DENSE:
        if name in p:
            dense(name + ".", p[name])
    for name in _YIELD_PRIORS:
        if name in p:
            sd[name] = _tensor(p[name])
    return sd


_LSTM_GATES = ("i", "f", "g", "o")   # flax's names, nn.LSTM's row order
_LSTM_CELL = "OptimizedLSTMCell_0"


def cnn_state_dict_from_jax_params(params) -> dict:
    """flax CNN-family param tree (weathermodel_tpu/models/cnn.py:
    WeatherCNNPretrain, CNNRNNYieldModel; with or without the top-level
    'params') -> the port's state dict (models/cnn.py) of CPU tensors. A conv
    kernel [k, in, out] becomes torch's [out, in, k]; a Dense kernel [in,
    out] becomes [out, in]; the LSTM cell's `ii/if/ig/io` (no bias) and
    `hi/hf/hg/ho` (with bias; flax names the cell `OptimizedLSTMCell_0`, as
    the model builds it outside its `nn.RNN`) become `weight_ih_l0` and
    `weight_hh_l0`,
    gates stacked in i, f, g, o order, the hidden bias `bias_hh_l0` and
    `bias_ih_l0` zeros (flax adds one bias a gate; nn.LSTM adds both)."""
    p = params["params"] if "params" in params else params
    unknown = set(p) - {"cnn", "decoder", "soil_cnn", _LSTM_CELL,
                        "output_layer"}
    if unknown or "cnn" not in p:
        raise ValueError(f"not a CNN-family param tree: top-level entries "
                         f"{sorted(p)}")
    sd = {}

    def layers(prefix, tree):
        for name, node in tree.items():
            sd.update(_conv_or_dense(f"{prefix}{name}.", node))

    for name in ("cnn", "soil_cnn"):
        if name in p:
            layers(name + ".", p[name])
    layers("", {k: p[k] for k in ("decoder", "output_layer") if k in p})
    if _LSTM_CELL in p:
        sd.update(_lstm_state_dict(p[_LSTM_CELL]))
    return sd


def _lstm_state_dict(cell, prefix: str = "lstm.") -> dict:
    """A flax LSTM cell's `ii/if/ig/io` (no bias) and `hi/hf/hg/ho` (with
    bias) -> a one-layer nn.LSTM's weight_ih_l0 and weight_hh_l0, gates
    stacked in i, f, g, o order, the hidden bias as `bias_hh_l0` and zeros
    as `bias_ih_l0`."""
    sd = {
        prefix + "weight_ih_l0": _tensor(np.concatenate(
            [np.asarray(cell["i" + g]["kernel"]).T for g in _LSTM_GATES])),
        prefix + "weight_hh_l0": _tensor(np.concatenate(
            [np.asarray(cell["h" + g]["kernel"]).T for g in _LSTM_GATES])),
        prefix + "bias_hh_l0": _tensor(np.concatenate(
            [np.asarray(cell["h" + g]["bias"]) for g in _LSTM_GATES]))}
    sd[prefix + "bias_ih_l0"] = torch.zeros_like(sd[prefix + "bias_hh_l0"])
    return sd


def _conv_or_dense(prefix: str, node) -> dict:
    """A flax Conv ([k, in, out] -> torch's [out, in, k]) or Dense ([in,
    out] -> [out, in]) with its bias, under `prefix`."""
    kernel = np.asarray(node["kernel"])
    return {prefix + "weight": _tensor(kernel.transpose(2, 1, 0)
                                       if kernel.ndim == 3 else kernel.T),
            prefix + "bias": _tensor(node["bias"])}


def gnn_state_dict_from_jax_params(params) -> dict:
    """flax GNNRNNYieldModel param tree (weathermodel_tpu/models/gnn.py;
    with or without the top-level 'params') -> the port's state dict
    (models/gnn.py) of CPU tensors. flax names the LSTM cell
    `OptimizedLSTMCell_0` here too: the model builds it in its own scope and
    hands it to `nn.RNN(name="lstm")`, which holds no parameters."""
    p = params["params"] if "params" in params else params
    sage = sorted((k for k in p if k.startswith("sage_")),
                  key=lambda k: int(k[5:]))
    unknown = set(p) - {"encoder", _LSTM_CELL, "reg_fc1", "reg_fc2", *sage}
    if unknown or "encoder" not in p or _LSTM_CELL not in p:
        raise ValueError(f"not a GNN-RNN param tree: top-level entries "
                         f"{sorted(p)}")
    sd = {}
    for name, node in p["encoder"].items():
        sd.update(_conv_or_dense(f"encoder.{name}.", node))
    for i, name in enumerate(sage):
        for fc in ("fc_self", "fc_neigh"):
            sd.update(_conv_or_dense(f"sage.{i}.{fc}.", p[name][fc]))
    for name in ("reg_fc1", "reg_fc2"):
        sd.update(_conv_or_dense(name + ".", p[name]))
    sd.update(_lstm_state_dict(p[_LSTM_CELL]))
    return sd


def chronos_port_key(path) -> str:
    """A flax path of the chronos encoder or the Chronos yield model (a
    tuple of names) -> the port's state-dict key: the port's modules carry
    the flax names, a Dense's `kernel` and an Embed's `embedding` are torch's
    `weight`."""
    *head, leaf = path
    leaf = {"kernel": "weight", "embedding": "weight"}.get(leaf, leaf)
    return ".".join((*head, leaf))


def chronos_state_dict_from_jax_params(params) -> dict:
    """flax ChronosYieldModel param tree (weathermodel_tpu/models/chronos.py;
    or a ChronosBoltEncoder's; with or without the top-level 'params') ->
    the port's state dict (models/chronos.py, models/chronos_bolt.py) of CPU
    tensors: every Dense kernel transposed, the rest as it is."""
    p = params["params"] if "params" in params else params
    sd = {}

    def walk(path, node):
        if hasattr(node, "items"):
            for name, child in node.items():
                walk((*path, name), child)
        else:
            sd[chronos_port_key(path)] = _tensor(
                np.asarray(node).T if path[-1] == "kernel" else node)

    walk((), p)
    return sd
