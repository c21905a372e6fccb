"""Fused FFN + residual + post-LayerNorm, forward and backward (port of
`fused_ffn_ln`, weathermodel_tpu/ops/pallas_ffn.py), the JAX layer's
ffn_impl="pallas" (the port's "fused_ffn_ln").

    h   = dropout1(relu(x @ W1 + b1))      rounded once to x's dtype
    f   = dropout2(h @ W2 + b2)            fp32
    out = LN(x + f) * ln_scale + ln_bias   fp32 statistics, eps 1e-5

* `fused_ffn_ln` - kernel B6f (`csrc/fused_ffn_ln.cu`, `_ffn_fwd_kernel`):
  out [..., H] in x's dtype. Rounding as the TPU kernel (pallas_ffn.py:
  63-91): both products accumulate in fp32; a kept value is divided by
  (1 - p).
* `fused_ffn_ln_bwd` - kernel B6b (`csrc/fused_ffn_ln_bwd.cu`,
  `_ffn_bwd_kernel`): (dx, dW1, db1, dW2, db2, dln_scale, dln_bias) from
  the inputs and the cotangent, recomputing the hidden and both masks
  (multiplying by 1/(1 - p), as the TPU backward does); dx and the weight
  gradients in x's dtype, the rest fp32. db1 and db2 sum dz and df after
  their rounding to x's dtype, where the kernel takes them from its
  tensor-core products (the TPU sums them before; the same in fp32).
* `FusedFFNLN` - the autograd Function joining the two (the custom VJP of
  `_ffn_ln`); it saves the inputs and recomputes the rest.

Weights keep the JAX layout: W1 [H, F], W2 [F, H]; b1, b2 and the LN
parameters are used in fp32 whatever x's dtype, as the JAX layer passes its
fp32 parameters. Dropout draws the FFN keep bits of ops/dropout.py
(`ffn_keep_mask`) from two seeds, the hidden site's and the output site's,
identically in the kernels and the plain versions. Each wrapper launches its
hand-written Hopper kernel on CUDA tensors (counting the launch in its
`launches` attribute) or raises, and runs its plain PyTorch version
(`*_reference`) on CPU tensors; the plain version is also what the kernel is
checked against on the card. Nothing is padded: the kernels bound-check the
rows and both widths (H at most 640).
"""

import math

import torch

from weathermodel_tpu_torch.kernels import build
from weathermodel_tpu_torch.ops.attention import dropout_params
from weathermodel_tpu_torch.ops.dropout import ffn_keep_mask

LN_EPS = 1e-5
# the widest H the kernels' row blocks hold (csrc/ffn_common.cuh kMaxH)
MAX_HIDDEN = 640
# target blocks per SM of the weight-gradient products, and the fewest rows
# a slice of their rows gets
_WGRAD_BLOCKS_PER_SM, _WGRAD_MIN_ROWS = 4, 1024


def check_ffn_shapes(x, w1, b1, w2, b2):
    """x [..., H], W1 [H, F], b1 [F], W2 [F, H], b2 [H]; returns (H, F)."""
    h = x.shape[-1]
    if w1.dim() != 2 or w1.shape[0] != h:
        raise ValueError(f"w1 must be [{h}, F], got {tuple(w1.shape)}")
    f = w1.shape[1]
    if tuple(w2.shape) != (f, h) or tuple(b1.shape) != (f,) or \
            tuple(b2.shape) != (h,):
        raise ValueError(f"w2 [{f}, {h}], b1 [{f}], b2 [{h}] expected, got "
                         f"{tuple(w2.shape)}, {tuple(b1.shape)}, "
                         f"{tuple(b2.shape)}")
    return h, f


def _check_ln(h, ln_scale, ln_bias):
    if tuple(ln_scale.shape) != (h,) or tuple(ln_bias.shape) != (h,):
        raise ValueError(f"LayerNorm parameters must be [{h}], got "
                         f"{tuple(ln_scale.shape)}, {tuple(ln_bias.shape)}")


def ffn_on_cuda(name, x, w1, w2, *vectors) -> bool:
    """`build.on_cuda` for x and the weights, and the layout the FFN kernels
    take: contiguous x and weights, H <= MAX_HIDDEN, the vectors on x's
    device (the wrappers hand them over as contiguous fp32)."""
    if not build.on_cuda(name, None, x, w1, w2):
        return False
    if not all(a.is_contiguous() for a in (x, w1, w2)):
        raise ValueError(f"{name} needs contiguous x, w1 and w2")
    if x.shape[-1] > MAX_HIDDEN:
        raise ValueError(f"{name}: hidden {x.shape[-1]} exceeds the kernels' "
                         f"{MAX_HIDDEN}")
    if any(v.device != x.device for v in vectors):
        raise ValueError(f"{name}: biases and LN parameters must be on "
                         f"{x.device}")
    return True


def _fp32(*vectors):
    return [v.float().contiguous() for v in vectors]


def _ln_stats(y):
    """(mu, rstd) of fp32 rows y, as the TPU kernel's `_ln_fwd`."""
    mu = y.mean(dim=-1, keepdim=True)
    var = (y - mu).square().mean(dim=-1, keepdim=True)
    return mu, torch.rsqrt(var + LN_EPS)


def fused_ffn_ln_reference(x, w1, b1, w2, b2, ln_scale, ln_bias,
                           dropout_rate: float = 0.0, seeds=(0, 0)):
    """Plain PyTorch version of kernel B6f: out [..., H] in x.dtype."""
    h, f = check_ffn_shapes(x, w1, b1, w2, b2)
    _check_ln(h, ln_scale, ln_bias)
    on, _, keep_prob, _ = dropout_params(dropout_rate)
    x2 = x.reshape(-1, h)
    m = x2.shape[0]
    hid = (x2.float() @ w1.float() + b1.float()).clamp_min(0.0)
    if on:
        # a true fp32 division by fp32(1 - p), as the kernel's
        kp = torch.full((), keep_prob, device=x.device)
        keep1 = ffn_keep_mask(seeds[0], m, f, dropout_rate, x.device)
        hid = torch.where(keep1, hid / kp, torch.zeros((), device=x.device))
    out = hid.to(x.dtype).float() @ w2.float() + b2.float()
    if on:
        keep2 = ffn_keep_mask(seeds[1], m, h, dropout_rate, x.device)
        out = torch.where(keep2, out / kp, torch.zeros((), device=x.device))
    y = x2.float() + out
    mu, rstd = _ln_stats(y)
    out = (y - mu) * rstd * ln_scale.float() + ln_bias.float()
    return out.to(x.dtype).reshape(x.shape)


def fused_ffn_ln(x, w1, b1, w2, b2, ln_scale, ln_bias,
                 dropout_rate: float = 0.0, seeds=(0, 0)):
    """Kernel B6f: x [..., H], W1 [H, F], b1 [F], W2 [F, H], b2, ln_scale,
    ln_bias [H] -> LN(x + FFN(x)) [..., H] in x.dtype, dropping at
    `dropout_rate` with seeds[0] at the hidden site and seeds[1] at the
    output site (integers in [0, 2^32)).

    CUDA tensors launch the kernel (counted in `fused_ffn_ln.launches`) or
    raise; CPU tensors take the plain version."""
    h, f = check_ffn_shapes(x, w1, b1, w2, b2)
    _check_ln(h, ln_scale, ln_bias)
    if not ffn_on_cuda("fused_ffn_ln", x, w1, w2, b1, b2, ln_scale, ln_bias):
        return fused_ffn_ln_reference(x, w1, b1, w2, b2, ln_scale, ln_bias,
                                      dropout_rate, seeds)
    on, threshold, keep_prob, _ = dropout_params(dropout_rate)
    b1, b2, ln_scale, ln_bias = _fp32(b1, b2, ln_scale, ln_bias)
    m = x.numel() // h
    out = torch.empty_like(x)
    lib = build.load_library().lib
    with torch.cuda.device(x.device):
        err = lib.wm_fused_ffn_ln(
            build.DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), out.data_ptr(), m, h, f, on, seeds[0],
            seeds[1], threshold, keep_prob, build.cuda_stream(x.device))
    build.check(err)
    fused_ffn_ln.launches += 1
    return out


fused_ffn_ln.launches = 0


def fused_ffn_ln_bwd_reference(x, w1, b1, w2, b2, ln_scale, ln_bias, do,
                               dropout_rate: float = 0.0, seeds=(0, 0)):
    """Plain PyTorch version of kernel B6b: (dx, dW1, db1, dW2, db2,
    dln_scale, dln_bias), dx and the weight gradients in x.dtype, the rest
    fp32, in the order of the TPU kernel (pallas_ffn.py:114-175)."""
    h, f = check_ffn_shapes(x, w1, b1, w2, b2)
    _check_ln(h, ln_scale, ln_bias)
    on, _, _, inv = dropout_params(dropout_rate)
    dtype = x.dtype
    x2 = x.reshape(-1, h)
    g = do.reshape(-1, h).float()
    m = x2.shape[0]
    zero = torch.zeros((), device=x.device)
    w1f, w2f = w1.float(), w2.float()
    h_pre = x2.float() @ w1f + b1.float()
    hid = h_pre.clamp_min(0.0)
    if on:
        keep1 = ffn_keep_mask(seeds[0], m, f, dropout_rate, x.device)
        keep2 = ffn_keep_mask(seeds[1], m, h, dropout_rate, x.device)
        hid = torch.where(keep1, hid * inv, zero)
    hd = hid.to(dtype).float()
    out = hd @ w2f + b2.float()
    if on:
        out = torch.where(keep2, out * inv, zero)
    y = x2.float() + out
    mu, rstd = _ln_stats(y)
    xhat = (y - mu) * rstd
    dls = (g * xhat).sum(dim=0)
    dlb = g.sum(dim=0)
    dxhat = g * ln_scale.float()
    dy = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    df = torch.where(keep2, dy * inv, zero) if on else dy
    df = df.to(dtype).float()
    dh = df @ w2f.T
    if on:
        dh = torch.where(keep1, dh * inv, zero)
    dz = torch.where(h_pre > 0, dh, zero).to(dtype).float()
    dx = (dz @ w1f.T + dy).to(dtype).reshape(x.shape)
    return (dx, (x2.float().T @ dz).to(dtype), dz.sum(dim=0),
            (hd.T @ df).to(dtype), df.sum(dim=0), dls, dlb)


def _wgrad_splits(m, k, n, device):
    """Row slices of a weight-gradient product [k + 1, n] over m rows: enough
    blocks to fill the card on `device`, at least _WGRAD_MIN_ROWS rows
    each."""
    blocks = (torch.cuda.get_device_properties(device).multi_processor_count
              * _WGRAD_BLOCKS_PER_SM)
    tiles = math.ceil(n / 128) * math.ceil((k + 1) / 128)
    return max(1, min(math.ceil(blocks / tiles),
                      math.ceil(m / _WGRAD_MIN_ROWS)))


def fused_ffn_ln_bwd(x, w1, b1, w2, b2, ln_scale, ln_bias, do,
                     dropout_rate: float = 0.0, seeds=(0, 0)):
    """Kernel B6b: the gradients of `fused_ffn_ln` for the cotangent do
    [..., H], with the forward's dropout rate and seeds: (dx, dW1, db1, dW2,
    db2, dln_scale, dln_bias), dx and the weight gradients in x.dtype, the
    rest fp32.

    CUDA tensors launch the kernel (its passes, counted once in
    `fused_ffn_ln_bwd.launches`) or raise; CPU tensors take the plain
    version."""
    h, f = check_ffn_shapes(x, w1, b1, w2, b2)
    _check_ln(h, ln_scale, ln_bias)
    if tuple(do.shape) != tuple(x.shape):
        raise ValueError(f"do must be {tuple(x.shape)}, got {tuple(do.shape)}")
    if not ffn_on_cuda("fused_ffn_ln_bwd", x, w1, w2, b1, b2, ln_scale,
                       ln_bias, do):
        return fused_ffn_ln_bwd_reference(x, w1, b1, w2, b2, ln_scale,
                                          ln_bias, do, dropout_rate, seeds)
    if do.dtype != x.dtype or not do.is_contiguous():
        raise ValueError("fused_ffn_ln_bwd needs a contiguous do of x's dtype")
    on, threshold, _, inv = dropout_params(dropout_rate)
    b1, b2, ln_scale = _fp32(b1, b2, ln_scale)
    m = x.numel() // h
    fp32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    db1, db2 = torch.empty(f, **fp32), torch.empty(h, **fp32)
    dls, dlb = torch.empty(h, **fp32), torch.empty(h, **fp32)
    hd, dz = x.new_empty(m, f), x.new_empty(m, f)
    df, dy = x.new_empty(m, h), torch.empty(m, h, **fp32)
    ln_part = torch.empty(math.ceil(m / 32), 2, h, **fp32)
    splits1 = _wgrad_splits(m, h, f, x.device)
    splits2 = _wgrad_splits(m, f, h, x.device)
    w_part = torch.empty(max(splits1 * (h + 1) * f, splits2 * (f + 1) * h),
                         **fp32)
    lib = build.load_library().lib
    with torch.cuda.device(x.device):
        err = lib.wm_fused_ffn_ln_bwd(
            build.DTYPE_CODES[x.dtype], x.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), ln_scale.data_ptr(),
            do.data_ptr(), dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), dls.data_ptr(), dlb.data_ptr(),
            hd.data_ptr(), df.data_ptr(), dy.data_ptr(), dz.data_ptr(),
            ln_part.data_ptr(), w_part.data_ptr(), m, h, f, on, seeds[0],
            seeds[1], threshold, inv, splits1, splits2,
            build.cuda_stream(x.device))
    build.check(err)
    fused_ffn_ln_bwd.launches += 1
    return dx, dw1, db1, dw2, db2, dls, dlb


fused_ffn_ln_bwd.launches = 0


class FusedFFNLN(torch.autograd.Function):
    """out = fused_ffn_ln(x, ...): forward kernel B6f, backward kernel B6b,
    which recomputes the hidden and regenerates both masks from the seeds.
    Saves the inputs only. Gradients come back in each input's dtype."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, ln_scale, ln_bias, dropout_rate,
                seeds):
        ctx.save_for_backward(x, w1, b1, w2, b2, ln_scale, ln_bias)
        ctx.dropout = (dropout_rate, seeds)
        return fused_ffn_ln(x, w1, b1, w2, b2, ln_scale, ln_bias,
                            dropout_rate, seeds)

    @staticmethod
    def backward(ctx, do):
        inputs = ctx.saved_tensors
        grads = fused_ffn_ln_bwd(*inputs, do.contiguous(), *ctx.dropout)
        return (*(g.to(a.dtype) for g, a in zip(grads, inputs)), None, None)
