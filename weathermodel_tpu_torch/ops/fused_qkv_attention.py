"""Fused QKV projection + multi-head self-attention, eval and training forms.

Port of `flash_attention_fused` (weathermodel_tpu/ops/pallas_attention.py).
Each kernel has a wrapper that launches the hand-written Hopper kernel on a
CUDA tensor (counting the launch in its `launches` attribute) and runs the
plain PyTorch version beside it on a CPU tensor; the plain version is also
what the kernel is checked against on the card.

* `fused_qkv_attention` - eval form (`csrc/fused_qkv_attention.cu`,
  `_fused_fwd_kernel` with emit_qkv=False and dropout 0). Numerics: qkv =
  x . w^T + b accumulated in fp32 and rounded to x's dtype; scores
  q . k^T / sqrt(hd) in fp32; a max-subtracted fp32 softmax whose weights
  are rounded to x's dtype; p . v accumulated in fp32; the output in x's
  dtype.
* `fused_qkv_attention_train` - training form of the same kernel
  (emit_qkv=True, dropout on the attention weights): returns (o, qkv), qkv
  being the backward's residual. Rounding as the TPU kernel
  (pallas_attention.py:158-178): qs = q * scale in x's dtype; scores
  qs . k^T in fp32; weights keep ? e * (recip / (1 - p)) : 0, rounded.
* `fused_qkv_attention_bwd` - kernel B2 (`csrc/fused_qkv_attention_bwd.cu`,
  `_bwd_kernel_qkv`): the packed dqkv from qkv and dO, recomputing the
  softmax and the dropout mask (`_bwd_head_math`'s rounding points).
* `FusedQKVAttention` - the autograd Function joining the two (the custom
  VJP `_attention_fused_bth`); dx, dW and db are plain matmuls and a sum
  outside the kernels, as in the JAX package (pallas_attention.py:682-692).

The dropout keep bits are `ops.attention.attention_keep_mask`'s hash of
(seed, batch row, head, i, j), the same in the kernels and the plain
versions.
"""

import torch

from weathermodel_tpu_torch.kernels import build
from weathermodel_tpu_torch.ops.attention import (
    attention_keep_mask,
    dropout_params,
    torch_attention,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernels are instantiated for: mini/small/medium/large
KERNEL_HEAD_DIMS = (12, 20, 28, 36)


def _check_shapes(x, w_qkv, b_qkv, num_heads):
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, H], got {tuple(x.shape)}")
    h = x.shape[-1]
    if h % num_heads != 0:
        raise ValueError(f"hidden {h} not divisible by heads {num_heads}")
    if tuple(w_qkv.shape) != (3 * h, h) or tuple(b_qkv.shape) != (3 * h,):
        raise ValueError(
            f"w_qkv must be [{3 * h}, {h}] and b_qkv [{3 * h}], got "
            f"{tuple(w_qkv.shape)} and {tuple(b_qkv.shape)}")


def _on_cuda(name, head_dim, *tensors) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA
    tensors the kernel takes; raises on anything else."""
    devices = {a.device for a in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    dtypes = {a.dtype for a in tensors}
    if len(dtypes) != 1 or tensors[0].dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: inputs must share one dtype of "
                         f"float32/bfloat16, got {[a.dtype for a in tensors]}")
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} not in the kernel's "
                         f"instantiations {KERNEL_HEAD_DIMS}")
    return True


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _heads(a, num_heads):
    """[B, T, nh * hd] -> fp32 [B, nh, T, hd]."""
    b, t, h = a.shape
    return a.float().reshape(b, t, num_heads, h // num_heads).transpose(1, 2)


def _merge(a):
    """[B, nh, T, hd] -> [B, T, nh * hd]."""
    b, nh, t, hd = a.shape
    return a.transpose(1, 2).reshape(b, t, nh * hd)


def _softmax_parts(qkv, num_heads):
    """The fp32 pieces both training-form plain versions start from:
    qs = q * scale in qkv's dtype (scale rounded to it too, as the JAX
    package's weak-typed `q * scale`), then e = exp(s - max) and 1/sum(e)
    over s = qs . k^T. The max is a constant shift (detached)."""
    h = qkv.shape[-1] // 3
    hd = h // num_heads
    q, k, v = qkv.split(h, dim=-1)
    scale = 1.0 / hd ** 0.5
    qs = q * torch.tensor(scale, dtype=qkv.dtype, device=qkv.device)
    qs, k, v = (_heads(a, num_heads) for a in (qs, k, v))
    s = qs @ k.transpose(-1, -2)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
    return qs, k, v, e, 1.0 / e.sum(dim=-1, keepdim=True), scale


def fused_qkv_attention_reference(x, w_qkv, b_qkv, num_heads: int):
    """Plain PyTorch version of the eval kernel. x [B, T, H]; w_qkv [3H, H]
    (torch [out, in] layout); b_qkv [3H]; returns [B, T, H] in x.dtype."""
    _check_shapes(x, w_qkv, b_qkv, num_heads)
    qkv = (x.float() @ w_qkv.float().T + b_qkv.float()).to(x.dtype)
    return torch_attention(*qkv.chunk(3, dim=-1), num_heads)


def fused_qkv_attention(x, w_qkv, b_qkv, num_heads: int):
    """x [B, T, H]; w_qkv [3H, H]; b_qkv [3H] -> [B, T, H].

    CUDA tensors launch the kernel (and count the launch in
    `fused_qkv_attention.launches`) or raise; CPU tensors take the plain
    version."""
    _check_shapes(x, w_qkv, b_qkv, num_heads)
    if not _on_cuda("fused_qkv_attention", x.shape[-1] // num_heads, x,
                    w_qkv, b_qkv):
        return fused_qkv_attention_reference(x, w_qkv, b_qkv, num_heads)
    bsz, t, h = x.shape
    lib = build.load_library().lib
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.wm_fused_qkv_attention(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w_qkv.data_ptr(),
            b_qkv.data_ptr(), out.data_ptr(), bsz, t, h, num_heads,
            _stream(x.device))
    build.check(err)
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0


def fused_qkv_attention_train_reference(x, w_qkv, b_qkv, num_heads: int,
                                        dropout_rate: float, seed: int):
    """Plain PyTorch version of the training-form kernel: (o [B, T, H],
    qkv [B, T, 3H]), both in x.dtype. Differentiable."""
    _check_shapes(x, w_qkv, b_qkv, num_heads)
    on, _, keep_prob, _ = dropout_params(dropout_rate)
    qkv = (x.float() @ w_qkv.float().T + b_qkv.float()).to(x.dtype)
    _, _, v, e, recip, _ = _softmax_parts(qkv, num_heads)
    if on:
        bsz, t, _ = x.shape
        keep = attention_keep_mask(seed, bsz, num_heads, t, dropout_rate,
                                   x.device)
        # a true fp32 division by fp32(1 - p), as the kernel's
        scl = recip / torch.full_like(recip, keep_prob)
        w = torch.where(keep, e * scl, torch.zeros((), device=x.device))
    else:
        w = e * recip
    o = w.to(x.dtype).float() @ v
    return _merge(o).to(x.dtype), qkv


def fused_qkv_attention_train(x, w_qkv, b_qkv, num_heads: int,
                              dropout_rate: float, seed: int):
    """Training form: x [B, T, H]; w_qkv [3H, H]; b_qkv [3H] -> (o
    [B, T, H], qkv [B, T, 3H]), with dropout at `dropout_rate` on the
    attention weights drawn from `seed` (an integer in [0, 2^32)).

    CUDA tensors launch the kernel (counted in
    `fused_qkv_attention_train.launches`) or raise; CPU tensors take the
    plain version."""
    _check_shapes(x, w_qkv, b_qkv, num_heads)
    if not _on_cuda("fused_qkv_attention_train", x.shape[-1] // num_heads,
                    x, w_qkv, b_qkv):
        return fused_qkv_attention_train_reference(
            x, w_qkv, b_qkv, num_heads, dropout_rate, seed)
    on, threshold, keep_prob, _ = dropout_params(dropout_rate)
    bsz, t, h = x.shape
    lib = build.load_library().lib
    out = torch.empty_like(x)
    qkv = x.new_empty(bsz, t, 3 * h)
    with torch.cuda.device(x.device):
        err = lib.wm_fused_qkv_attention_train(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w_qkv.data_ptr(),
            b_qkv.data_ptr(), out.data_ptr(), qkv.data_ptr(), bsz, t, h,
            num_heads, on, seed, threshold, keep_prob, _stream(x.device))
    build.check(err)
    fused_qkv_attention_train.launches += 1
    return out, qkv


fused_qkv_attention_train.launches = 0


def _check_bwd_shapes(qkv, do, num_heads):
    if qkv.dim() != 3 or do.dim() != 3 or \
            tuple(qkv.shape) != (*do.shape[:2], 3 * do.shape[2]):
        raise ValueError(f"qkv must be [B, T, 3H] and do [B, T, H], got "
                         f"{tuple(qkv.shape)} and {tuple(do.shape)}")
    if do.shape[-1] % num_heads != 0:
        raise ValueError(f"hidden {do.shape[-1]} not divisible by heads "
                         f"{num_heads}")


def fused_qkv_attention_bwd_reference(qkv, do, num_heads: int,
                                      dropout_rate: float, seed: int):
    """Plain PyTorch version of kernel B2: dqkv [B, T, 3H] in qkv.dtype
    from the forward's qkv residual and do [B, T, H]."""
    _check_bwd_shapes(qkv, do, num_heads)
    dtype = qkv.dtype
    on, _, _, inv_keep = dropout_params(dropout_rate)
    qs, k, v, e, recip, scale = _softmax_parts(qkv, num_heads)
    g = _heads(do, num_heads)
    w = e * recip
    dwd = g @ v.transpose(-1, -2)
    if on:
        bsz, t, _ = do.shape
        keep = attention_keep_mask(seed, bsz, num_heads, t, dropout_rate,
                                   qkv.device)
        zero = torch.zeros((), device=qkv.device)
        wd = torch.where(keep, w * inv_keep, zero)
        dw = torch.where(keep, dwd * inv_keep, zero)
    else:
        wd, dw = w, dwd
    dv = wd.to(dtype).float().transpose(-1, -2) @ g
    rowsum = (dw * w).sum(dim=-1, keepdim=True)
    ds = (w * (dw - rowsum)).to(dtype).float()
    dq = (ds @ k) * scale
    dk = ds.transpose(-1, -2) @ qs
    return torch.cat([_merge(a) for a in (dq, dk, dv)], dim=-1).to(dtype)


def fused_qkv_attention_bwd(qkv, do, num_heads: int, dropout_rate: float,
                            seed: int):
    """Kernel B2: qkv [B, T, 3H] (the training forward's residual), do
    [B, T, H] -> dqkv [B, T, 3H], with the forward's dropout rate and seed.

    CUDA tensors launch the kernel (its two passes, counted once in
    `fused_qkv_attention_bwd.launches`) or raise; CPU tensors take the
    plain version."""
    _check_bwd_shapes(qkv, do, num_heads)
    if not _on_cuda("fused_qkv_attention_bwd", do.shape[-1] // num_heads,
                    qkv, do):
        return fused_qkv_attention_bwd_reference(qkv, do, num_heads,
                                                 dropout_rate, seed)
    on, threshold, _, inv_keep = dropout_params(dropout_rate)
    bsz, t, h = do.shape
    lib = build.load_library().lib
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(bsz, num_heads, 3, t, dtype=torch.float32,
                        device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.wm_fused_qkv_attention_bwd(
            _DTYPE_CODES[qkv.dtype], qkv.data_ptr(), do.data_ptr(),
            dqkv.data_ptr(), stats.data_ptr(), bsz, t, h, num_heads, on,
            seed, threshold, inv_keep, _stream(qkv.device))
    build.check(err)
    fused_qkv_attention_bwd.launches += 1
    return dqkv


fused_qkv_attention_bwd.launches = 0


class FusedQKVAttention(torch.autograd.Function):
    """o = attention(split(x . w_qkv^T + b_qkv)) with dropout on the
    attention weights: forward `fused_qkv_attention_train`, backward
    `fused_qkv_attention_bwd` plus dx = dqkv . w_qkv, dW = dqkv^T . x and
    db = sum over (batch, time) of dqkv. Saves x, w_qkv and qkv."""

    @staticmethod
    def forward(ctx, x, w_qkv, b_qkv, num_heads, dropout_rate, seed):
        o, qkv = fused_qkv_attention_train(x, w_qkv, b_qkv, num_heads,
                                           dropout_rate, seed)
        ctx.save_for_backward(x, w_qkv, qkv)
        ctx.attention = (num_heads, dropout_rate, seed)
        return o

    @staticmethod
    def backward(ctx, do):
        x, w_qkv, qkv = ctx.saved_tensors
        dqkv = fused_qkv_attention_bwd(qkv, do.contiguous(), *ctx.attention)
        h = x.shape[-1]
        dx = dqkv @ w_qkv
        dw = dqkv.reshape(-1, 3 * h).T @ x.reshape(-1, h)
        db = dqkv.float().sum(dim=(0, 1)).to(w_qkv.dtype)
        return dx, dw, db, None, None, None
