"""Multi-head attention: the plain PyTorch path, the impl resolver and the
attention-weight dropout rule (port of weathermodel_tpu/ops/attention.py).

Impl names in the port: "fused_qkv" is the hand-written CUDA kernel of
`ops/fused_qkv_attention.py` (the JAX package's "pallas_qkv");
"fused_qkv_op" its inference-only kernel B5 with the out-projection inside
(the JAX package's "pallas_qkv_op"); "flash" is
the attention kernel on separate q, k, v of `ops/flash_attention.py` (the
JAX package's "pallas"); "torch" is `torch_attention` below (the JAX
package's "xla").

Dropout on the attention weights keeps weight (i, j) of head `head` of
batch row `row` iff bits < (1 - p) * 2^32, the TPU kernels' rule
(weathermodel_tpu/ops/pallas_attention.py:143-148). The card has no TPU
PRNG, so the bits are a hash of (seed, row * heads + head, i, j):
`attention_keep_mask` computes them with int64 tensor ops, exactly as
`csrc/attention_common.cuh` does in the kernels, so a kernel and its plain
version draw the same mask and the backward regenerates the forward's.
"""

import torch

ATTENTION_IMPLS = ("fused_qkv", "fused_qkv_op", "flash", "torch")

M32 = 0xFFFFFFFF
# keep-mask elements per chunk of batch rows: bounds the int64 temporaries
# (2^24 elements = 128 MiB each)
MASK_CHUNK = 1 << 24


def dropout_params(rate: float):
    """(on, threshold, keep_prob, inv_keep) of the keep rule at rate p:
    threshold = (uint32)((1 - p) * 2^32); keep_prob = 1 - p and
    inv_keep = 1 / (1 - p) as Python floats, which the kernels and the
    plain versions use in fp32."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate == 0.0:
        return 0, 0, 1.0, 1.0
    return 1, int((1.0 - rate) * 4294967296.0), 1.0 - rate, 1.0 / (1.0 - rate)


def _mul32(x, c: int):
    """x * c mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32,
    exact in int64: x's 16-bit halves keep every partial product < 2^49."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & M32


def mix32(x):
    """Chris Wellons' lowbias32 hash on int64 tensors holding uint32 values
    (`mix32` in csrc/attention_common.cuh)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def attention_keep_mask(seed: int, batch: int, num_heads: int, t: int,
                        rate: float, device) -> torch.Tensor:
    """Bool keep-mask [batch, num_heads, t, t] of the attention weights for
    `seed` (an integer in [0, 2^32))."""
    _, threshold, _, _ = dropout_params(rate)
    if not 0 <= seed <= M32:
        raise ValueError(f"dropout seed must be in [0, 2^32), got {seed}")
    i = torch.arange(t, device=device).view(1, 1, t, 1)
    j = torch.arange(t, device=device)
    rows = max(1, MASK_CHUNK // (num_heads * t * t))
    out = []
    for r0 in range(0, batch, rows):
        n = min(rows, batch - r0)
        row_head = torch.arange(r0 * num_heads, (r0 + n) * num_heads,
                                device=device).view(n, num_heads, 1, 1)
        head_key = mix32(seed ^ mix32((row_head + 0x9E3779B9) & M32))
        row_key = mix32(head_key ^ i)
        out.append(mix32(row_key ^ j) < threshold)
    return torch.cat(out)


def torch_attention(q, k, v, num_heads: int, dropout_rate: float = 0.0,
                    seed: int = 0):
    """q/k/v [B, T, H] -> [B, T, H]: scores and softmax in fp32, the
    weights rounded to q's dtype, dropped with `attention_keep_mask` and
    scaled by 1/(1-p) in that dtype (as `_xla_attention`), the weighted sum
    accumulated in fp32. No padding mask."""
    b, t, h = q.shape
    if h % num_heads != 0:
        raise ValueError(f"hidden dim {h} not divisible by num_heads "
                         f"{num_heads}")
    hd = h // num_heads
    dtype = q.dtype
    q, k, v = (a.float().reshape(b, t, num_heads, hd) for a in (q, k, v))
    scores = torch.einsum("bqnd,bknd->bnqk", q, k) / hd ** 0.5
    weights = torch.softmax(scores, dim=-1).to(dtype)
    if dropout_rate > 0.0:
        keep = attention_keep_mask(seed, b, num_heads, t, dropout_rate,
                                   weights.device)
        weights = torch.where(keep, weights / (1.0 - dropout_rate),
                              torch.zeros((), dtype=dtype,
                                          device=weights.device))
    out = torch.einsum("bnqk,bknd->bqnd", weights.float(), v)
    return out.reshape(b, t, h).to(dtype)


def resolve_attention_impl(impl: str, model_size=None,
                           mode: str = "train") -> str:
    """Resolve impl="auto" by the JAX package's rule
    (weathermodel_tpu/ops/attention.py:44-56): the fused QKV kernel for
    inference at every size and for medium/large training, the attention
    kernel on separate q, k, v for mini/small training."""
    if impl != "auto":
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"Unknown attention impl: {impl}")
        return impl
    if mode == "eval" or model_size in ("medium", "large"):
        return "fused_qkv"
    return "flash"
