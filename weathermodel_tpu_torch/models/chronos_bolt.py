"""The chronos-bolt encoder and the mapping of a chronos-bolt checkpoint onto
it (port of weathermodel_tpu/models/chronos_bolt.py).

The reference yield baseline (`src/crop_yield/models/chronos_yield_model.py:
47-93`) embeds each weather variable with the frozen pretrained
`amazon/chronos-bolt-tiny` through `model.encode(context)`, which runs:

    instance norm -> left NaN-padding to whole patches (patch 16, stride 16)
    -> [values ; observed mask] per patch -> the ResidualBlock patch
    embedding -> [+ REG token] -> the T5 encoder stack -> per-patch
    embeddings

T5's parts, as the JAX package writes them: pre-RMSNorm blocks (the
variance in fp32, the product cast back before the weight), the UNSCALED
q k^T plus a bucketed relative position bias (block 0's table, shared by
every block) and the attention mask added as the fp32 minimum, softmax in
fp32, ReLU feed-forward, no bias on any encoder Linear, a final RMSNorm.
The attention is plain tensor ops (no kernel of the port: JAX runs it as
XLA einsums and a softmax). chronos-bolt-tiny (t5-efficient-tiny): d_model
256, d_ff 1024, 4 layers, 4 heads, d_kv 64.

The submodules carry the flax names (`input_patch_embedding.{hidden_layer,
output_layer,residual_layer}`, `encoder.block_{i}.{attn_norm,attn.{q,k,v,o},
ffn_norm,wi,wo}`, `encoder.rel_bias`, `encoder.final_norm`, `reg_token`), so
a JAX tree converts by transposing its Dense kernels
(`models/transfer.py::chronos_state_dict_from_jax_params`), and
`load_torch_state_dict` maps a chronos-bolt checkpoint's names through the
JAX package's key map with its error texts. The decoder and the quantile
heads of a checkpoint are ignored: the reference never runs them for yield.

Dropout (rate `dropout_rate`, 0.1) draws its seeds from a CPU
torch.Generator in training; the inits follow flax's (lecun-normal Dense
kernels, zero biases, the position table normal with std 1/sqrt(heads), the
REG token standard normal, norms at one).
"""

import dataclasses
import functools
import logging

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from weathermodel_tpu_torch.models.cnn import lecun_normal_
from weathermodel_tpu_torch.models.transfer import chronos_port_key
from weathermodel_tpu_torch.ops.dropout import draw_seed, rand_dropout

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ChronosBoltConfig:
    d_model: int = 256
    d_ff: int = 1024
    num_layers: int = 4
    num_heads: int = 4
    d_kv: int = 64
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-6
    patch_size: int = 16
    patch_stride: int = 16
    context_length: int = 2048
    use_reg_token: bool = True
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128


CHRONOS_BOLT_TINY = ChronosBoltConfig()


def num_patches(seq_len: int, cfg: ChronosBoltConfig = CHRONOS_BOLT_TINY
                ) -> int:
    """Patch count for a series (reference chronos_yield_model.py:76-85
    `calculate_num_patches`)."""
    padded = seq_len
    if seq_len % cfg.patch_size != 0:
        padded += cfg.patch_size - (seq_len % cfg.patch_size)
    return (padded - cfg.patch_size) // cfg.patch_stride + 1


def _rms_norm(x, weight, eps):
    # T5LayerNorm: no mean subtraction, the variance in fp32
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * weight


def relative_position_bucket(relative_position, num_buckets=32,
                             max_distance=128):
    """T5's bidirectional bucketing of key_pos - query_pos (an int tensor):
    half the buckets for each sign, half of those exact, the rest
    log-spaced up to max_distance; fp32 arithmetic and the int cast as the
    JAX package's."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / max_exact + 1e-20)
        / float(np.float32(np.log(max_distance / max_exact)))
        * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


@functools.lru_cache(maxsize=16)
def position_buckets(t: int, num_buckets: int, max_distance: int
                     ) -> torch.Tensor:
    """The [T, T] bucket ids of key_pos - query_pos, computed once a length
    on the CPU (so a card's log cannot round an exact power of two to the
    other side)."""
    pos = torch.arange(t)
    return relative_position_bucket(pos[None, :] - pos[:, None], num_buckets,
                                     max_distance).long()


class _Dropout:
    """dropout(x) at `rate` with seeds from the CPU `generator`; identity at
    rate 0."""

    def __init__(self, rate: float, generator):
        if rate > 0.0 and generator is None:
            raise ValueError("training with dropout needs a generator (a "
                             "CPU torch.Generator for the dropout seeds)")
        self.rate, self.generator = rate, generator

    def __call__(self, x):
        if self.rate <= 0.0:
            return x
        return rand_dropout(x, self.rate, draw_seed(self.generator))


def _dense_init(layers, generator) -> None:
    """flax nn.Dense's init: lecun-normal kernels, zero biases."""
    with torch.no_grad():
        for layer in layers:
            lecun_normal_(layer.weight, generator)
            if layer.bias is not None:
                layer.bias.zero_()


class T5SelfAttention(nn.Module):
    """HF T5Attention (encoder self-attention): q/k/v/o without biases,
    the unscaled q k^T scores plus `position_bias`, dropout on the
    softmax's weights."""

    def __init__(self, cfg: ChronosBoltConfig):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)

    def forward(self, x, position_bias, drop):
        c = self.cfg
        b, t, _ = x.shape

        def heads(y):  # [B, T, inner] -> [B, H, T, d_kv]
            return y.reshape(b, t, c.num_heads, c.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        scores = torch.matmul(q, k.transpose(-1, -2)) + position_bias
        w = drop(torch.softmax(scores.float(), dim=-1).to(x.dtype))
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, t, -1)
        return self.o(out)


class T5Block(nn.Module):
    """Pre-norm self-attention and ReLU feed-forward, each a residual."""

    def __init__(self, cfg: ChronosBoltConfig):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = nn.Parameter(torch.ones(cfg.d_model))
        self.attn = T5SelfAttention(cfg)
        self.ffn_norm = nn.Parameter(torch.ones(cfg.d_model))
        self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x, position_bias, drop):
        eps = self.cfg.layer_norm_eps
        x = x + drop(self.attn(_rms_norm(x, self.attn_norm, eps),
                               position_bias, drop))
        h = drop(torch.relu(self.wi(_rms_norm(x, self.ffn_norm, eps))))
        return x + drop(self.wo(h))


class T5EncoderStack(nn.Module):
    def __init__(self, cfg: ChronosBoltConfig):
        super().__init__()
        self.cfg = cfg
        self.rel_bias = nn.Embedding(cfg.relative_attention_num_buckets,
                                     cfg.num_heads)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", T5Block(cfg))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model))

    def forward(self, inputs_embeds, attention_mask, drop):
        c = self.cfg
        t = inputs_embeds.shape[1]
        buckets = position_buckets(t, c.relative_attention_num_buckets,
                                   c.relative_attention_max_distance)
        # [T, T, H] -> [1, H, T, T]
        position_bias = self.rel_bias(buckets.to(inputs_embeds.device)
                                      ).permute(2, 0, 1)[None]
        if attention_mask is not None:
            neg = torch.finfo(torch.float32).min
            position_bias = position_bias + torch.where(
                attention_mask[:, None, None, :], 0.0, neg)
        x = drop(inputs_embeds)
        for i in range(c.num_layers):
            x = getattr(self, f"block_{i}")(x, position_bias, drop)
        return drop(_rms_norm(x, self.final_norm, c.layer_norm_eps))


class ResidualBlock(nn.Module):
    """chronos-bolt's patch embedding: out(relu(hidden(x))) + res(x)."""

    def __init__(self, in_dim: int, h_dim: int, out_dim: int):
        super().__init__()
        self.hidden_layer = nn.Linear(in_dim, h_dim)
        self.output_layer = nn.Linear(h_dim, out_dim)
        self.residual_layer = nn.Linear(in_dim, out_dim)

    def forward(self, x, drop):
        out = drop(self.output_layer(torch.relu(self.hidden_layer(x))))
        return out + self.residual_layer(x)


class ChronosBoltEncoder(nn.Module):
    """`ChronosBoltModelForForecasting.encode()`: series [B, T] (NaN =
    missing) -> per-patch embeddings [B, num_patches (+1 REG), d_model] in
    fp32. In `train()` mode the dropout draws its seeds from the CPU
    `generator`; `dropout_rate` overrides the config's rate."""

    def __init__(self, cfg: ChronosBoltConfig = CHRONOS_BOLT_TINY):
        super().__init__()
        self.cfg = cfg
        self.input_patch_embedding = ResidualBlock(2 * cfg.patch_size,
                                                   cfg.d_ff, cfg.d_model)
        if cfg.use_reg_token:
            self.reg_token = nn.Parameter(torch.zeros(cfg.d_model))
        self.encoder = T5EncoderStack(cfg)

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        dense = [m for m in self.modules() if isinstance(m, nn.Linear)]
        _dense_init(dense, generator)
        with torch.no_grad():
            nn.init.normal_(self.encoder.rel_bias.weight, 0.0,
                            self.cfg.num_heads ** -0.5, generator=generator)
            if self.cfg.use_reg_token:
                nn.init.normal_(self.reg_token, 0.0, 1.0,
                                generator=generator)
            for name, p in self.named_parameters():
                if name.endswith("_norm"):
                    p.fill_(1.0)

    def forward(self, series, generator=None, dropout_rate=None):
        c = self.cfg
        rate = 0.0
        if self.training:
            rate = c.dropout_rate if dropout_rate is None else dropout_rate
        drop = _Dropout(rate, generator)
        b, t = series.shape
        if t > c.context_length:
            series = series[:, -c.context_length:]
            t = c.context_length
        series = series.float()
        observed = ~torch.isnan(series)
        x = torch.where(observed, series, 0.0)
        # instance norm over the observed values (eps 1e-5; an all-missing
        # series gets loc 0 and scale 1)
        n_obs = observed.sum(dim=1, keepdim=True)
        cnt = n_obs.clamp(min=1)
        loc = x.sum(dim=1, keepdim=True) / cnt
        var = torch.where(observed, x - loc, 0.0).square().sum(
            dim=1, keepdim=True) / cnt
        scale = torch.sqrt(var)
        scale = torch.where(scale == 0.0, loc.abs() + 1e-5, scale)
        scale = torch.where(n_obs == 0, 1.0, scale)
        x = (x - loc) / scale

        # left-pad to whole patches with missing values, then patch
        pad = (-t) % c.patch_size
        x = F.pad(x, (pad, 0))
        m = F.pad(observed.float(), (pad, 0))
        p = x.shape[1] // c.patch_size
        patched_x = x.reshape(b, p, c.patch_size)
        patched_m = m.reshape(b, p, c.patch_size)
        patched_x = torch.where(patched_m > 0.0, patched_x, 0.0)
        emb = self.input_patch_embedding(
            torch.cat([patched_x, patched_m], dim=-1), drop)
        attn_mask = patched_m.sum(dim=-1) > 0.0
        if c.use_reg_token:
            emb = torch.cat([emb, self.reg_token.expand(b, 1, c.d_model)],
                            dim=1)
            attn_mask = torch.cat([attn_mask, attn_mask.new_ones(b, 1)],
                                  dim=1)
        return self.encoder(emb, attn_mask, drop)


# ---------------------------------------------------------------------------
# a chronos-bolt checkpoint's names -> the encoder's (the JAX package's map)
# ---------------------------------------------------------------------------

def _flax_key_map(cfg: ChronosBoltConfig):
    """Checkpoint key -> (the flax path, whether the value is row 1 of the
    shared embedding), in the JAX package's order. A checkpoint's Linear
    weights are torch's [out, in], the port's layout: nothing transposes."""
    m = {}
    for lin in ("hidden_layer", "output_layer", "residual_layer"):
        m[f"input_patch_embedding.{lin}.weight"] = (
            ("input_patch_embedding", lin, "kernel"), False)
        m[f"input_patch_embedding.{lin}.bias"] = (
            ("input_patch_embedding", lin, "bias"), False)
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        for name in ("q", "k", "v", "o"):
            m[f"{pre}.0.SelfAttention.{name}.weight"] = (
                ("encoder", f"block_{i}", "attn", name, "kernel"), False)
        m[f"{pre}.0.layer_norm.weight"] = (
            ("encoder", f"block_{i}", "attn_norm"), False)
        m[f"{pre}.1.DenseReluDense.wi.weight"] = (
            ("encoder", f"block_{i}", "wi", "kernel"), False)
        m[f"{pre}.1.DenseReluDense.wo.weight"] = (
            ("encoder", f"block_{i}", "wo", "kernel"), False)
        m[f"{pre}.1.layer_norm.weight"] = (
            ("encoder", f"block_{i}", "ffn_norm"), False)
    m["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] \
        = (("encoder", "rel_bias", "embedding"), False)
    m["encoder.final_layer_norm.weight"] = (("encoder", "final_norm"), False)
    if cfg.use_reg_token:
        # the shared embedding's vocabulary is [pad (unused), REG]
        m["shared.weight"] = (("reg_token",), True)
    return m


def _flax_path(key: str) -> tuple:
    """The port's encoder key -> its flax path (for error texts)."""
    parts = key.split(".")
    if parts[-1] == "weight":
        parts[-1] = "embedding" if parts[-2] == "rel_bias" else "kernel"
    return tuple(parts)


def _flax_shape(path, shape) -> tuple:
    """A leaf's shape as flax holds it (a Dense kernel is [in, out])."""
    shape = tuple(int(d) for d in shape)
    return shape[::-1] if path[-1] == "kernel" else shape


def convert_torch_state_dict(sd, cfg: ChronosBoltConfig = CHRONOS_BOLT_TINY
                             ) -> dict:
    """A chronos-bolt checkpoint's state dict -> {flax path: fp32 CPU
    tensor in the port's layout} for ChronosBoltEncoder. Raises on missing
    encoder keys (an honest failure beats a silent random init); the
    decoder and head keys are ignored."""
    key_map = _flax_key_map(cfg)
    missing = [k for k in key_map if k not in sd]
    if missing:
        raise KeyError(
            f"chronos-bolt checkpoint is missing {len(missing)} encoder "
            f"keys, e.g. {missing[:3]}")
    out = {}
    for key, (path, reg_row) in key_map.items():
        value = torch.as_tensor(np.asarray(sd[key].detach().cpu())
                                if hasattr(sd[key], "detach") else
                                np.asarray(sd[key]))
        out[path] = (value[1] if reg_row else value).to(torch.float32)
    return out


def load_torch_state_dict(model: nn.Module, sd, *,
                          subtree: str = "chronos_encoder",
                          cfg: ChronosBoltConfig = CHRONOS_BOLT_TINY):
    """Replace the encoder `model.<subtree>` with a chronos-bolt
    checkpoint's weights, every leaf's shape checked against the encoder's,
    with the JAX package's texts; returns `model`."""
    converted = convert_torch_state_dict(sd, cfg)
    encoder = model.get_submodule(subtree)
    state = encoder.state_dict()
    new = {}
    for path, leaf in converted.items():
        key = chronos_port_key(path)
        if key not in state:
            raise KeyError(f"no param at {subtree}/{'/'.join(path)}")
        if state[key].shape != leaf.shape:
            raise ValueError(
                f"shape mismatch at {'/'.join(path)}: "
                f"{_flax_shape(path, state[key].shape)} vs checkpoint "
                f"{_flax_shape(path, leaf.shape)}")
        new[key] = leaf
    unmapped = [_flax_path(k) for k in state if k not in new]
    if unmapped:
        raise KeyError(
            f"{len(unmapped)} encoder params not covered by the checkpoint "
            f"mapping, e.g. {unmapped[:3]}")
    encoder.load_state_dict(new)
    return model
