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
the attention output before the residual, the FFN hidden after the ReLU and
the FFN output. Each site takes its own seed from the CPU generator the
caller passes (ops/dropout.py). With dropout 0 and no gradient the eval
path is the one the serving path runs.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from weathermodel_tpu_torch.ops.attention import ATTENTION_IMPLS, torch_attention
from weathermodel_tpu_torch.ops.dropout import draw_seed, dropout
from weathermodel_tpu_torch.ops.flash_attention import (
    FlashAttention,
    flash_attention_fwd,
)
from weathermodel_tpu_torch.ops.fused_qkv_attention import (
    FusedQKVAttention,
    fused_qkv_attention,
)

LN_EPS = 1e-5


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
        train = dropout_rate > 0.0 or (torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad or b.requires_grad))
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
    """Post-LN encoder layer with the dense ReLU FFN.

    norm1 takes its statistics in fp32 (as flax nn.LayerNorm does) and
    norm2 in the compute dtype (as the JAX layer's hand-written tail,
    blocks.py:391-396, does), so that bf16 rounds where the JAX package
    rounds."""

    def __init__(self, hidden_dim: int, num_heads: int, ffn_dim: int,
                 attention_impl: str = "torch", ffn_impl: str = "torch",
                 num_experts: int = 0):
        super().__init__()
        if num_experts > 0:
            raise NotImplementedError(
                "the MoE FFN (models/moe.py, TPU kernel B4) is not ported "
                "yet; see ROADMAP.md queue A item 12")
        if ffn_impl != "torch":
            raise NotImplementedError(
                f"ffn_impl={ffn_impl!r} (int8 serving or the Pallas FFN "
                "kernels B6/B7) is not ported yet; see ROADMAP.md queue A "
                "item 13 and queue B")
        self.self_attn = SelfAttention(hidden_dim, num_heads, attention_impl)
        self.linear1 = nn.Linear(hidden_dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, hidden_dim)
        self.norm1 = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=LN_EPS)

    def forward(self, x, dropout_rate: float = 0.0, generator=None):
        def drop(a):
            if dropout_rate <= 0.0:
                return a
            return dropout(a, dropout_rate, draw_seed(generator))

        dtype = x.dtype
        y = x + drop(self.self_attn(x, dropout_rate, generator))
        x = F.layer_norm(y.float(), y.shape[-1:], self.norm1.weight,
                         self.norm1.bias, LN_EPS).to(dtype)
        ff = drop(F.relu(linear(x, self.linear1)))
        ff = drop(linear(ff, self.linear2))
        y = x + ff
        mu = y.mean(dim=-1, keepdim=True)
        var = (y - mu).square().mean(dim=-1, keepdim=True)
        xhat = (y - mu) * torch.rsqrt(var + LN_EPS)
        return xhat * self.norm2.weight.to(dtype) + self.norm2.bias.to(dtype)


class TransformerEncoder(nn.Module):
    """Stack of post-LN layers with no final norm (reference
    weatherbert.py:52-54)."""

    def __init__(self, hidden_dim: int, num_heads: int, ffn_dim: int,
                 num_layers: int, attention_impl: str = "torch",
                 ffn_impl: str = "torch", num_experts: int = 0):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(hidden_dim, num_heads, ffn_dim,
                                    attention_impl, ffn_impl, num_experts)
            for _ in range(num_layers))

    def forward(self, x, dropout_rate: float = 0.0, generator=None):
        for layer in self.layers:
            x = layer(x, dropout_rate, generator)
        return x
