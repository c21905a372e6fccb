"""Multi-head self-attention on separate q, k, v, training form, and its
backward (port of `flash_attention`, weathermodel_tpu/ops/pallas_attention.py:
429-506,765-798), the attention of mini and small training.

* `flash_attention_fwd` - kernel B3f (`csrc/flash_attention.cu`,
  `_fwd_kernel`): o from q, k, v [B, T, H], with dropout on the attention
  weights. Rounding as the TPU kernel (pallas_attention.py:158-178): qs =
  q * scale in q's dtype (the scale rounded to it too); scores qs . k^T and
  the softmax in fp32; weights keep ? e * (recip / (1 - p)) : 0, rounded to
  q's dtype; p . v accumulated in fp32.
* `flash_attention_bwd` - kernel B3b (`csrc/flash_attention_bwd.cu`,
  `_bwd_kernel`): dq, dk, dv from q, k, v and dO, recomputing the softmax
  and the dropout mask (`_bwd_head_math`'s rounding points).
* `FlashAttention` - the autograd Function joining the two (the custom VJP
  `_attention_bth`); it saves q, k and v.

Each wrapper launches its hand-written Hopper kernel on CUDA tensors
(counting the launch in its `launches` attribute) or raises, and runs its
plain PyTorch version (`*_reference`) on CPU tensors; the plain version is
also what the kernel is checked against on the card. The kernels take q, k
and v as three pointers with one row stride, so the column slices of a
packed [B, T, 3H] projection (`chunk(3, dim=-1)`) go in without a copy.

The plain versions below are shared with the fused QKV attention
(ops/fused_qkv_attention.py), whose training form and backward run the same
attention after and before their projection. The dropout keep bits are
`ops.attention.attention_keep_mask`'s hash of (seed, batch row, head, i,
j), the same in the kernels and the plain versions, and the same for B1 and
B3 at one seed.
"""

import torch

from weathermodel_tpu_torch.kernels import build
from weathermodel_tpu_torch.ops.attention import (
    attention_keep_mask,
    dropout_params,
)

def _heads(a, num_heads):
    """[B, T, nh * hd] -> fp32 [B, nh, T, hd]."""
    b, t, h = a.shape
    return a.float().reshape(b, t, num_heads, h // num_heads).transpose(1, 2)


def _merge(a):
    """[B, nh, T, hd] -> [B, T, nh * hd]."""
    b, nh, t, hd = a.shape
    return a.transpose(1, 2).reshape(b, t, nh * hd)


def _softmax_parts(q, k, v, num_heads):
    """The fp32 pieces both plain versions start from: qs = q * scale in
    q's dtype (scale rounded to it too, as the JAX package's weak-typed
    `q * scale`), then e = exp(s - max) and 1/sum(e) over s = qs . k^T. The
    max is a constant shift (detached)."""
    scale = 1.0 / (q.shape[-1] // num_heads) ** 0.5
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    qs, k, v = (_heads(a, num_heads) for a in (qs, k, v))
    s = qs @ k.transpose(-1, -2)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
    return qs, k, v, e, 1.0 / e.sum(dim=-1, keepdim=True), scale


def _check_shapes(q, k, v, num_heads, do=None):
    shapes = {tuple(a.shape) for a in (q, k, v, do) if a is not None}
    if q.dim() != 3 or len(shapes) != 1:
        raise ValueError(f"q, k, v (and do) must be [B, T, H] of one shape, "
                         f"got {sorted(shapes)}")
    if q.shape[-1] % num_heads != 0:
        raise ValueError(f"hidden {q.shape[-1]} not divisible by heads "
                         f"{num_heads}")


def _row_stride(name, q, k, v) -> int:
    """The one row stride the kernels take for q, k and v: each must have a
    unit column stride and rows that many elements apart (three contiguous
    [B, T, H] tensors, or the column slices of one packed projection)."""
    b, t, h = q.shape
    strides = {a.stride() for a in (q, k, v)}
    if len(strides) == 1:
        sb, st, sh = strides.pop()
        if sh == 1 and st >= h and (sb == t * st or b == 1):
            return st
    raise ValueError(f"{name} needs q, k, v with a unit column stride and one "
                     f"row stride, got strides "
                     f"{[a.stride() for a in (q, k, v)]}")


def flash_attention_fwd_reference(q, k, v, num_heads: int,
                                  dropout_rate: float, seed: int):
    """Plain PyTorch version of kernel B3f: o [B, T, H] in q.dtype.
    Differentiable."""
    _check_shapes(q, k, v, num_heads)
    on, _, keep_prob, _ = dropout_params(dropout_rate)
    _, _, v, e, recip, _ = _softmax_parts(q, k, v, num_heads)
    if on:
        bsz, t, _ = q.shape
        keep = attention_keep_mask(seed, bsz, num_heads, t, dropout_rate,
                                   q.device)
        # a true fp32 division by fp32(1 - p), as the kernel's
        scl = recip / torch.full_like(recip, keep_prob)
        w = torch.where(keep, e * scl, torch.zeros((), device=q.device))
    else:
        w = e * recip
    o = w.to(q.dtype).float() @ v
    return _merge(o).to(q.dtype)


def flash_attention_fwd(q, k, v, num_heads: int, dropout_rate: float,
                        seed: int):
    """Kernel B3f: q, k, v [B, T, H] -> o [B, T, H], with dropout at
    `dropout_rate` on the attention weights drawn from `seed` (an integer in
    [0, 2^32)).

    CUDA tensors launch the kernel (counted in `flash_attention_fwd.launches`)
    or raise; CPU tensors take the plain version."""
    _check_shapes(q, k, v, num_heads)
    if not build.on_cuda("flash_attention_fwd", q.shape[-1] // num_heads, q,
                         k, v):
        return flash_attention_fwd_reference(q, k, v, num_heads, dropout_rate,
                                             seed)
    stride = _row_stride("flash_attention_fwd", q, k, v)
    on, threshold, keep_prob, _ = dropout_params(dropout_rate)
    bsz, t, h = q.shape
    lib = build.load_library().lib
    out = q.new_empty(bsz, t, h)
    with torch.cuda.device(q.device):
        err = lib.wm_flash_attention(
            build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), stride, out.data_ptr(), bsz, t, h, num_heads, on,
            seed, threshold, keep_prob, build.cuda_stream(q.device))
    build.check(err)
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


def flash_attention_bwd_reference(q, k, v, do, num_heads: int,
                                  dropout_rate: float, seed: int):
    """Plain PyTorch version of kernel B3b: (dq, dk, dv), each [B, T, H] in
    q.dtype, from q, k, v and do [B, T, H]."""
    _check_shapes(q, k, v, num_heads, do)
    dtype = q.dtype
    on, _, _, inv_keep = dropout_params(dropout_rate)
    qs, k, v, e, recip, scale = _softmax_parts(q, k, v, num_heads)
    g = _heads(do, num_heads)
    w = e * recip
    dwd = g @ v.transpose(-1, -2)
    if on:
        bsz, t, _ = do.shape
        keep = attention_keep_mask(seed, bsz, num_heads, t, dropout_rate,
                                   q.device)
        zero = torch.zeros((), device=q.device)
        wd = torch.where(keep, w * inv_keep, zero)
        dw = torch.where(keep, dwd * inv_keep, zero)
    else:
        wd, dw = w, dwd
    dv = wd.to(dtype).float().transpose(-1, -2) @ g
    rowsum = (dw * w).sum(dim=-1, keepdim=True)
    ds = (w * (dw - rowsum)).to(dtype).float()
    dq = (ds @ k) * scale
    dk = ds.transpose(-1, -2) @ qs
    return tuple(_merge(a).to(dtype) for a in (dq, dk, dv))


def flash_attention_bwd(q, k, v, do, num_heads: int, dropout_rate: float,
                        seed: int):
    """Kernel B3b: q, k, v, do [B, T, H] -> (dq, dk, dv) [B, T, H], with the
    forward's dropout rate and seed. do must be contiguous.

    CUDA tensors launch the kernel (its two passes, counted once in
    `flash_attention_bwd.launches`) or raise; CPU tensors take the plain
    version."""
    _check_shapes(q, k, v, num_heads, do)
    if not build.on_cuda("flash_attention_bwd", q.shape[-1] // num_heads, q,
                         k, v, do):
        return flash_attention_bwd_reference(q, k, v, do, num_heads,
                                             dropout_rate, seed)
    stride = _row_stride("flash_attention_bwd", q, k, v)
    if not do.is_contiguous():
        raise ValueError("flash_attention_bwd needs a contiguous do")
    on, threshold, _, inv_keep = dropout_params(dropout_rate)
    bsz, t, h = q.shape
    lib = build.load_library().lib
    dq, dk, dv = (torch.empty_like(do) for _ in range(3))
    stats = torch.empty(bsz, num_heads, 3, t, dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        err = lib.wm_flash_attention_bwd(
            build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), stride, do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), bsz, t, h,
            num_heads, on, seed, threshold, inv_keep,
            build.cuda_stream(q.device))
    build.check(err)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) with dropout on the attention weights:
    forward `flash_attention_fwd`, backward `flash_attention_bwd`, which
    regenerates the forward's mask from the seed. Saves q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, dropout_rate, seed):
        o = flash_attention_fwd(q, k, v, num_heads, dropout_rate, seed)
        ctx.save_for_backward(q, k, v)
        ctx.attention = (num_heads, dropout_rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, do.contiguous(),
                                         *ctx.attention)
        return dq, dk, dv, None, None, None
