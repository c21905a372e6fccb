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
* `fused_qkv_attention_outproj` - kernel B5
  (`csrc/fused_qkv_attention_outproj.cu`, `_fused_fwd_outproj_kernel` of
  `flash_attention_fused_outproj`): the eval form (or, with dropout, the
  training form's attention) and then y = o . wo^T + bo inside the kernel,
  o rounded to x's dtype, y summed in fp32 with the bias and rounded once.
  Inference only: it has no backward and refuses a tensor that needs a
  gradient.

The training form's and B2's plain versions are B3's
(ops/flash_attention.py) on the three column slices of the packed qkv:
the same attention after the projection. The dropout keep bits are
`ops.attention.attention_keep_mask`'s hash of (seed, batch row, head, i,
j), the same in the kernels and the plain versions.
"""

import torch

from weathermodel_tpu_torch.kernels import build
from weathermodel_tpu_torch.ops.attention import dropout_params, torch_attention
from weathermodel_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_reference,
    flash_attention_fwd_reference,
)


def _on_cuda(name, head_dim, *tensors) -> bool:
    """`build.on_cuda`, and the layout these kernels take: contiguous
    inputs."""
    if not build.on_cuda(name, head_dim, *tensors):
        return False
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    return True


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
            build.DTYPE_CODES[x.dtype], x.data_ptr(), w_qkv.data_ptr(),
            b_qkv.data_ptr(), out.data_ptr(), bsz, t, h, num_heads,
            build.cuda_stream(x.device))
    build.check(err)
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0


def fused_qkv_attention_train_reference(x, w_qkv, b_qkv, num_heads: int,
                                        dropout_rate: float, seed: int):
    """Plain PyTorch version of the training-form kernel: (o [B, T, H],
    qkv [B, T, 3H]), both in x.dtype. Differentiable."""
    _check_shapes(x, w_qkv, b_qkv, num_heads)
    qkv = (x.float() @ w_qkv.float().T + b_qkv.float()).to(x.dtype)
    o = flash_attention_fwd_reference(*qkv.chunk(3, dim=-1), num_heads,
                                      dropout_rate, seed)
    return o, qkv


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
            build.DTYPE_CODES[x.dtype], x.data_ptr(), w_qkv.data_ptr(),
            b_qkv.data_ptr(), out.data_ptr(), qkv.data_ptr(), bsz, t, h,
            num_heads, on, seed, threshold, keep_prob,
            build.cuda_stream(x.device))
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
    grads = flash_attention_bwd_reference(*qkv.chunk(3, dim=-1), do,
                                          num_heads, dropout_rate, seed)
    return torch.cat(grads, dim=-1)


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
            build.DTYPE_CODES[qkv.dtype], qkv.data_ptr(), do.data_ptr(),
            dqkv.data_ptr(), stats.data_ptr(), bsz, t, h, num_heads, on,
            seed, threshold, inv_keep, build.cuda_stream(qkv.device))
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


def _check_outproj_shapes(x, w_qkv, b_qkv, wo, bo, num_heads):
    _check_shapes(x, w_qkv, b_qkv, num_heads)
    h = x.shape[-1]
    if tuple(wo.shape) != (h, h) or tuple(bo.shape) != (h,):
        raise ValueError(f"wo must be [{h}, {h}] and bo [{h}], got "
                         f"{tuple(wo.shape)} and {tuple(bo.shape)}")


def fused_qkv_attention_outproj_reference(x, w_qkv, b_qkv, wo, bo,
                                          num_heads: int,
                                          dropout_rate: float = 0.0,
                                          seed: int = 0):
    """Plain PyTorch version of kernel B5: the eval form's plain version
    (with dropout, the training form's), then y = o . wo^T + bo in fp32,
    rounded once to x.dtype. wo [H, H] in torch's [out, in] layout."""
    _check_outproj_shapes(x, w_qkv, b_qkv, wo, bo, num_heads)
    if dropout_rate > 0.0:
        o = fused_qkv_attention_train_reference(x, w_qkv, b_qkv, num_heads,
                                                dropout_rate, seed)[0]
    else:
        o = fused_qkv_attention_reference(x, w_qkv, b_qkv, num_heads)
    return (o.float() @ wo.float().T + bo.float()).to(x.dtype)


def fused_qkv_attention_outproj(x, w_qkv, b_qkv, wo, bo, num_heads: int,
                                dropout_rate: float = 0.0, seed: int = 0):
    """Kernel B5: x [B, T, H]; w_qkv [3H, H]; b_qkv [3H]; wo [H, H]; bo [H]
    -> y = attention(x . w_qkv^T + b_qkv) . wo^T + bo [B, T, H], with
    dropout at `dropout_rate` on the attention weights drawn from `seed`.

    Inference only: raises ValueError if a gradient is needed through any
    input. CUDA tensors launch the kernel (counted in
    `fused_qkv_attention_outproj.launches`) or raise; CPU tensors take the
    plain version."""
    _check_outproj_shapes(x, w_qkv, b_qkv, wo, bo, num_heads)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x, w_qkv, b_qkv, wo, bo)):
        raise ValueError("fused_qkv_attention_outproj (kernel B5) is "
                         "inference-only: it has no backward; train with "
                         "fused_qkv_attention's FusedQKVAttention")
    if not _on_cuda("fused_qkv_attention_outproj",
                   x.shape[-1] // num_heads, x, w_qkv, b_qkv, wo, bo):
        return fused_qkv_attention_outproj_reference(
            x, w_qkv, b_qkv, wo, bo, num_heads, dropout_rate, seed)
    on, threshold, keep_prob, _ = dropout_params(dropout_rate)
    bsz, t, h = x.shape
    lib = build.load_library().lib
    o = torch.empty_like(x)  # phase 1's output, phase 2's input
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.wm_fused_qkv_attention_outproj(
            build.DTYPE_CODES[x.dtype], x.data_ptr(), w_qkv.data_ptr(),
            b_qkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), o.data_ptr(),
            y.data_ptr(), bsz, t, h, num_heads, on, seed, threshold,
            keep_prob, build.cuda_stream(x.device))
    build.check(err)
    fused_qkv_attention_outproj.launches += 1
    return y


fused_qkv_attention_outproj.launches = 0
