"""Fused FFN forward with a plain backward (port of `fused_ffn`,
weathermodel_tpu/ops/pallas_ffn2.py), the JAX layer's ffn_impl="pallas2"
(the port's "fused_ffn").

    h = dropout1(relu(x @ W1 + b1))   rounded once to x's dtype
    f = dropout2(h @ W2 + b2)         rounded once to x's dtype

on rows x [M, H]; the residual and LayerNorm stay with the layer.

* `fused_ffn` - kernel B7 (`csrc/fused_ffn.cu`, `_kernel`): f [M, H], and
  the hidden h [M, F] when `want_h` (the backward's residual); without it
  the kernel skips that write, as `_run_fwd(want_h=False)` does. Both
  products accumulate in fp32; a kept value is multiplied by 1/(1 - p).
  bf16 runs the wgmma/TMA body (`csrc/ffn_hopper.cuh`, the layout rule of
  `check_wgmma_layout`), float32 the row kernel.
* `fused_ffn_bwd` - the backward, plain ops as in the JAX package
  (pallas_ffn2.py:148-178): the masks come back from the zeros of f and h
  (f == 0 where dropped, h != 0 exactly where kept and relu' > 0), so
  nothing is regenerated; the matmuls are torch.matmul in x's dtype.
* `FusedFFN` - the autograd Function joining them (the custom VJP of
  `fused_ffn`); it saves x, the weights, h and f.

Weights keep the JAX layout (W1 [H, F], W2 [F, H]); b1 and b2 are used in
fp32. Dropout draws the FFN keep bits of ops/dropout.py from two seeds (the
hidden site's and the output site's), the same in the kernel and its plain
version. The wrapper launches the hand-written Hopper kernel on CUDA tensors
(counting the launch in `fused_ffn.launches`) or raises, and runs its plain
PyTorch version on CPU tensors; the plain version is also what the kernel is
checked against on the card. M is not padded.
"""

import torch

from weathermodel_tpu_torch.kernels import build
from weathermodel_tpu_torch.ops.attention import dropout_params
from weathermodel_tpu_torch.ops.dropout import ffn_keep_mask
from weathermodel_tpu_torch.ops.fused_ffn_ln import (
    check_ffn_shapes,
    check_wgmma_layout,
    ffn_on_cuda,
    fp32_vectors,
)


def _check_rows(x):
    if x.dim() != 2:
        raise ValueError(f"x must be [M, H], got {tuple(x.shape)}")


def fused_ffn_reference(x, w1, b1, w2, b2, dropout_rate: float = 0.0,
                        seeds=(0, 0), want_h: bool = False):
    """Plain PyTorch version of kernel B7: (f, h or None) in x.dtype."""
    _check_rows(x)
    h, f = check_ffn_shapes(x, w1, b1, w2, b2)
    on, _, _, inv = dropout_params(dropout_rate)
    m = x.shape[0]
    zero = torch.zeros((), device=x.device)
    hid = (x.float() @ w1.float() + b1.float()).clamp_min(0.0)
    if on:
        keep1 = ffn_keep_mask(seeds[0], m, f, dropout_rate, x.device)
        hid = torch.where(keep1, hid * inv, zero)
    hid = hid.to(x.dtype)
    out = hid.float() @ w2.float() + b2.float()
    if on:
        keep2 = ffn_keep_mask(seeds[1], m, h, dropout_rate, x.device)
        out = torch.where(keep2, out * inv, zero)
    return out.to(x.dtype), (hid if want_h else None)


def fused_ffn(x, w1, b1, w2, b2, dropout_rate: float = 0.0, seeds=(0, 0),
              want_h: bool = False):
    """Kernel B7: x [M, H], W1 [H, F], b1 [F], W2 [F, H], b2 [H] -> (f [M, H],
    h [M, F] if `want_h` else None) in x.dtype, dropping at `dropout_rate`
    with seeds[0] at the hidden site and seeds[1] at the output site.

    CUDA tensors launch the kernel (counted in `fused_ffn.launches`) or
    raise; CPU tensors take the plain version."""
    _check_rows(x)
    h, f = check_ffn_shapes(x, w1, b1, w2, b2)
    if not ffn_on_cuda("fused_ffn", x, w1, w2, b1, b2):
        return fused_ffn_reference(x, w1, b1, w2, b2, dropout_rate, seeds,
                                   want_h)
    check_wgmma_layout("fused_ffn", x, w1, w2)
    on, threshold, _, inv = dropout_params(dropout_rate)
    b1, b2 = fp32_vectors(b1, b2)
    m = x.shape[0]
    out = torch.empty_like(x)
    hid = x.new_empty(m, f) if want_h else None
    lib = build.load_library().lib
    with torch.cuda.device(x.device):
        err = lib.wm_fused_ffn(
            build.DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            None if hid is None else hid.data_ptr(), m, h, f, on, seeds[0],
            seeds[1], threshold, inv, build.cuda_stream(x.device))
    build.check(err)
    fused_ffn.launches += 1
    return out, hid


fused_ffn.launches = 0


def fused_ffn_bwd(x, w1, w2, hid, out, dout, dropout_rate: float):
    """The backward of `fused_ffn` from its residuals (x, the weights, h, f)
    and the cotangent dout [M, H]: (dx, dW1, db1, dW2, db2), dx and the
    weight gradients in their inputs' dtypes, db1 and db2 fp32. Plain ops on
    any device, as the JAX package's `_ffn_bwd`; 1/(1 - p) is taken in
    dout's dtype, as there."""
    dtype = dout.dtype
    if dropout_rate > 0.0:
        inv = torch.tensor(1.0 / (1.0 - dropout_rate), dtype=dtype,
                           device=dout.device)
        dy2 = torch.where(out != 0, dout * inv, torch.zeros((), dtype=dtype,
                                                           device=dout.device))
    else:
        inv = torch.ones((), dtype=dtype, device=dout.device)
        dy2 = dout
    db2 = dy2.float().sum(dim=0)
    dw2 = (hid.T @ dy2).to(w2.dtype)
    dh = dy2 @ w2.T
    dz = torch.where(hid != 0, dh * inv, torch.zeros((), dtype=dtype,
                                                      device=dout.device))
    db1 = dz.float().sum(dim=0)
    dw1 = (x.T @ dz).to(w1.dtype)
    dx = (dz @ w1.T).to(x.dtype)
    return dx, dw1, db1, dw2, db2


class FusedFFN(torch.autograd.Function):
    """f = fused_ffn(x, ...): forward kernel B7 with its hidden output,
    backward `fused_ffn_bwd` (plain ops). Saves x, W1, W2, h and f."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, dropout_rate, seeds):
        out, hid = fused_ffn(x, w1, b1, w2, b2, dropout_rate, seeds,
                             want_h=True)
        ctx.save_for_backward(x, w1, w2, hid, out)
        ctx.dropout_rate = dropout_rate
        ctx.bias_dtypes = (b1.dtype, b2.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, w1, w2, hid, out = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_ffn_bwd(x, w1, w2, hid, out, dout,
                                               ctx.dropout_rate)
        return (dx, dw1, db1.to(ctx.bias_dtypes[0]), dw2,
                db2.to(ctx.bias_dtypes[1]), None, None)
