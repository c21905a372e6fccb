"""Transformer building blocks (port of weathermodel_tpu/models/blocks.py).

Semantics of PyTorch's stock `nn.TransformerEncoderLayer` with its defaults,
as the reference uses it: post-LayerNorm, ReLU FFN, LayerNorm eps 1e-5. The
modules are named so that their state-dict keys are the reference's
(`self_attn.in_proj_weight`, `linear1.weight`, `norm1.weight`, ...), and the
weights keep torch's [out, in] layout.

The forward computes in the dtype of its input: parameters stay fp32 and
are cast at each use, as the JAX package does. With `dropout_rate` > 0 (the
model's training mode) the layer drops at the JAX layer's four sites
(blocks.py:271-396): the attention weights (inside the attention kernel),
the attention output before the residual, the FFN hidden after the ReLU (the
experts' hidden in a MoE layer, models/moe.py) and the FFN output. Each site
takes its own seed from the CPU generator the caller passes (ops/dropout.py).
With dropout 0 and no gradient the eval path is the one the serving path
runs.

`ffn_impl` picks the dense FFN (blocks.py:313-396 of the JAX package; a MoE
layer ignores it, as there):
  "torch"         plain ops (the JAX "xla")
  "fused_ffn_ln"  kernel B6f returns LN(x + FFN(x)) directly, B6b is its
                  backward (the JAX "pallas", ops/fused_ffn_ln.py)
  "fused_ffn"     kernel B7 computes the FFN with both dropouts, then the
                  layer's own residual + LN tail; plain-op backward (the JAX
                  "pallas2", ops/fused_ffn.py)
Each draws two seeds when dropout is on, hidden site then output site, as
"torch" does, so later layers' seeds do not depend on the impl. The
parameters are the same for every impl.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from weathermodel_tpu_torch.models.moe import MoEFFN
from weathermodel_tpu_torch.ops.attention import ATTENTION_IMPLS, torch_attention
from weathermodel_tpu_torch.ops.dropout import draw_seed, dropout
from weathermodel_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention_fwd,
)
from weathermodel_tpu_torch.ops.fused_ffn import FusedFFN, fused_ffn
from weathermodel_tpu_torch.ops.fused_ffn_ln import FusedFFNLN
from weathermodel_tpu_torch.ops.fused_qkv_attention import (
    FusedQKVAttention,
    fused_qkv_attention,
)

LN_EPS = 1e-5
FFN_IMPLS = ("torch", "fused_ffn_ln", "fused_ffn")


def sinusoidal_positional_encoding(max_len: int, hidden_dim: int) -> torch.Tensor:
    """'Attention is All You Need' PE table [max_len, hidden_dim], fp32,
    computed in numpy exactly as the JAX package computes it."""
    if hidden_dim % 2 != 0:
        raise ValueError(f"hidden_dim must be even, got {hidden_dim}")
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, hidden_dim, 2, dtype=np.float32)
                      * (-np.log(10000.0) / hidden_dim))
    pe = np.zeros((max_len, hidden_dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe)


def torch_linear_init_(weight, bias, generator=None) -> None:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for both the weight and the bias:
    nn.Linear's default and the JAX package's init (blocks.py:25-38)."""
    bound = 1.0 / weight.shape[1] ** 0.5
    nn.init.uniform_(weight, -bound, bound, generator=generator)
    nn.init.uniform_(bias, -bound, bound, generator=generator)


def linear(x, layer: nn.Linear):
    """`layer` applied in x's dtype (fp32 parameters cast at use)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def needs_grad(x, *params) -> bool:
    """Whether autograd will ask for a gradient through x or params."""
    return torch.is_grad_enabled() and any(a.requires_grad
                                           for a in (x, *params))


class SelfAttention(nn.Module):
    """Multi-head self-attention with torch MHA's parameter layout: a packed
    QKV projection `in_proj_weight` [3H, H] / `in_proj_bias` [3H] and an
    `out_proj` Linear. attention_impl "fused_qkv" runs the projection and
    the attention as one kernel (its eval form, or its training form and
    backward kernel when dropout is on or a gradient is needed); "flash"
    runs the projection as a plain matmul in the compute dtype and the
    attention on its three column slices as kernel B3f (with B3b as its
    backward when dropout is on or a gradient is needed; blocks.py:170-185
    of the JAX package); "torch" runs both as plain ops."""

    def __init__(self, hidden_dim: int, num_heads: int,
                 attention_impl: str = "torch"):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"Unknown attention impl: {attention_impl}")
        if hidden_dim % num_heads != 0:
            raise ValueError(f"hidden dim {hidden_dim} not divisible by "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.attention_impl = attention_impl
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden_dim,
                                                       hidden_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * hidden_dim))
        torch_linear_init_(self.in_proj_weight, self.in_proj_bias)
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, x, dropout_rate: float = 0.0, generator=None):
        w = self.in_proj_weight.to(x.dtype)
        b = self.in_proj_bias.to(x.dtype)
        seed = draw_seed(generator) if dropout_rate > 0.0 else 0
        train = dropout_rate > 0.0 or needs_grad(x, w, b)
        if self.attention_impl == "fused_qkv" and train:
            out = FusedQKVAttention.apply(x, w.contiguous(), b,
                                          self.num_heads, dropout_rate, seed)
        elif self.attention_impl == "fused_qkv":
            out = fused_qkv_attention(x, w.contiguous(), b, self.num_heads)
        else:
            q, k, v = F.linear(x, w, b).chunk(3, dim=-1)
            if self.attention_impl == "torch":
                out = torch_attention(q, k, v, self.num_heads, dropout_rate,
                                      seed)
            elif train:
                out = FlashAttention.apply(q, k, v, self.num_heads,
                                           dropout_rate, seed)
            else:
                out = flash_attention_fwd(q, k, v, self.num_heads, 0.0, 0)
        return linear(out, self.out_proj)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer with the dense ReLU FFN or, with `moe` (the
    keyword arguments of models/moe.py's MoEFFN), the routed expert FFN.

    norm1 takes its statistics in fp32 (as flax nn.LayerNorm does). The dense
    branch's norm2 takes them in the compute dtype (as the JAX layer's
    hand-written tail, blocks.py:391-396, does); the MoE branch's norm2 is a
    flax nn.LayerNorm again (blocks.py:287-305), with fp32 statistics. So bf16
    rounds where the JAX package rounds. The forward returns (x, the MoE aux
    loss or None)."""

    def __init__(self, hidden_dim: int, num_heads: int, ffn_dim: int,
                 attention_impl: str = "torch", ffn_impl: str = "torch",
                 moe: dict = None):
        super().__init__()
        if ffn_impl in ("int8", "int8_static", "calibrate"):
            raise NotImplementedError(
                f"ffn_impl={ffn_impl!r} (int8 serving) is not ported yet; see "
                "ROADMAP.md queue A item 13")
        if ffn_impl not in FFN_IMPLS:
            raise ValueError(f"Unknown ffn impl {ffn_impl!r}; choose one of "
                             f"{FFN_IMPLS}")
        self.ffn_impl = ffn_impl
        self.self_attn = SelfAttention(hidden_dim, num_heads, attention_impl)
        if moe:
            self.moe = MoEFFN(hidden_dim, ffn_dim, **moe)
        else:
            self.moe = None
            self.linear1 = nn.Linear(hidden_dim, ffn_dim)
            self.linear2 = nn.Linear(ffn_dim, hidden_dim)
        self.norm1 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=LN_EPS)

    def forward(self, x, dropout_rate: float = 0.0, generator=None):
        def drop(a):
            if dropout_rate <= 0.0:
                return a
            return dropout(a, dropout_rate, draw_seed(generator))

        def layer_norm(y, norm):  # fp32 statistics, as flax nn.LayerNorm
            return F.layer_norm(y.float(), y.shape[-1:], norm.weight,
                                norm.bias, LN_EPS).to(y.dtype)

        dtype = x.dtype
        x = layer_norm(x + drop(self.self_attn(x, dropout_rate, generator)),
                       self.norm1)
        if self.moe is not None:
            ff, aux = self.moe(x, dropout_rate, generator)
            return layer_norm(x + drop(ff), self.norm2), aux
        if self.ffn_impl == "torch":
            ff = drop(F.relu(linear(x, self.linear1)))
            ff = drop(linear(ff, self.linear2))
        else:
            seeds = ((draw_seed(generator), draw_seed(generator))
                     if dropout_rate > 0.0 else (0, 0))
            w1 = self.linear1.weight.to(dtype).t().contiguous()
            w2 = self.linear2.weight.to(dtype).t().contiguous()
            b1, b2 = self.linear1.bias, self.linear2.bias
            if self.ffn_impl == "fused_ffn_ln":
                return FusedFFNLN.apply(x, w1, b1, w2, b2, self.norm2.weight,
                                        self.norm2.bias, dropout_rate,
                                        seeds), None
            rows = x.reshape(-1, x.shape[-1])
            # with no gradient and no dropout B7 skips the write of h
            if dropout_rate > 0.0 or needs_grad(x, w1, b1, w2, b2):
                ff = FusedFFN.apply(rows, w1, b1, w2, b2, dropout_rate, seeds)
            else:
                ff = fused_ffn(rows, w1, b1, w2, b2)[0]
            ff = ff.reshape(x.shape)
        y = x + ff
        mu = y.mean(dim=-1, keepdim=True)
        var = (y - mu).square().mean(dim=-1, keepdim=True)
        xhat = (y - mu) * torch.rsqrt(var + LN_EPS)
        return (xhat * self.norm2.weight.to(dtype)
                + self.norm2.bias.to(dtype)), None


class TransformerEncoder(nn.Module):
    """Stack of post-LN layers with no final norm (reference
    weatherbert.py:52-54). Returns (x, the mean of the layers' MoE aux
    losses, or None for dense layers), as the JAX step averages the sown
    losses (train/steps.py:71-79)."""

    def __init__(self, hidden_dim: int, num_heads: int, ffn_dim: int,
                 num_layers: int, attention_impl: str = "torch",
                 ffn_impl: str = "torch", moe: dict = None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(hidden_dim, num_heads, ffn_dim,
                                    attention_impl, ffn_impl, moe)
            for _ in range(num_layers))

    def forward(self, x, dropout_rate: float = 0.0, generator=None):
        auxes = []
        for layer in self.layers:
            x, aux = layer(x, dropout_rate, generator)
            if aux is not None:
                auxes.append(aux)
        return x, (torch.stack(auxes).mean() if auxes else None)
