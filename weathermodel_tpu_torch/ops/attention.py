"""Multi-head attention: the plain PyTorch path and the impl resolver
(port of weathermodel_tpu/ops/attention.py).

Impl names in the port: "fused_qkv" is the hand-written CUDA kernel of
`ops/fused_qkv_attention.py` (the JAX package's "pallas_qkv"); "torch" is
`torch_attention` below (the JAX package's "xla").
"""

import torch

ATTENTION_IMPLS = ("fused_qkv", "torch")


def torch_attention(q, k, v, num_heads: int):
    """q/k/v [B, T, H] -> [B, T, H]: scores and softmax in fp32, the
    weights rounded to q's dtype, the weighted sum accumulated in fp32
    (as `_xla_attention` with preferred_element_type=float32). No padding
    mask, no dropout: the ported path is eval only."""
    b, t, h = q.shape
    if h % num_heads != 0:
        raise ValueError(f"hidden dim {h} not divisible by num_heads "
                         f"{num_heads}")
    hd = h // num_heads
    dtype = q.dtype
    q, k, v = (a.float().reshape(b, t, num_heads, hd) for a in (q, k, v))
    scores = torch.einsum("bqnd,bknd->bnqk", q, k) / hd ** 0.5
    weights = torch.softmax(scores, dim=-1).to(dtype).float()
    out = torch.einsum("bnqk,bknd->bqnd", weights, v)
    return out.reshape(b, t, h).to(dtype)


def resolve_attention_impl(impl: str, model_size=None,
                           mode: str = "train") -> str:
    """Resolve impl="auto" by the JAX package's rule: the fused QKV kernel
    for inference at every size and for medium/large training. Mini/small
    training used the unfused kernel B3, which is not ported yet."""
    if impl != "auto":
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"Unknown attention impl: {impl}")
        return impl
    if mode == "eval" or model_size in ("medium", "large"):
        return "fused_qkv"
    raise NotImplementedError(
        "attention for mini/small training (TPU kernel B3, flash_attention) "
        "is not ported yet; see ROADMAP.md queue B")
