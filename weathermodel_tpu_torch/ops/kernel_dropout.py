"""Dropout of any shape as one kernel, with the mask regenerated in the
backward (port of weathermodel_tpu/ops/pallas_dropout.py: its `dropout` and
`random_keep_mask`). As in the JAX package it is a standalone op: no
dropout impl and no layer calls it.

* `random_keep_mask` - kernel B8m (`csrc/keep_mask.cu`, JAX `_mask_kernel`):
  a bool keep-mask of any shape.
* `lane_dropout` - kernel B8 (JAX `_kernel`): x dropped by B8m's mask for
  the same seed, the kept values multiplied by 1/(1 - rate) rounded to x's
  dtype (the product rounded once, as JAX's weak-typed scalar does).
* `kernel_dropout` - the op: `KernelDropout`, whose backward launches B8 on
  dy with the same seed and saves no mask (JAX `_dropout2d`'s VJP).
Rate <= 0 is the identity, and an all-keep mask for `random_keep_mask`.

Both kernels work on JAX's lane view of the flattened tensor, [ceil(n /
512), 512], and write nothing past n (no padding). The TPU kernels draw from
the hardware PRNG seeded per block; the card has none, so the bits of
element (r, j) of the view are the FFN sites' hash of (seed, r, j) and an
element is kept iff bits < floor((1 - rate) * 2^32), B8's rule
(pallas_attention.py:143-148). So B8m's plain version is `ffn_keep_mask(seed,
ceil(n / 512), 512, rate)` flattened and cut to n, and `kernel_dropout(x) ==
where(random_keep_mask(x.shape), x * scale, 0)` bitwise.

The wrappers launch the hand-written Hopper kernels on CUDA (counting each
launch in `.launches`) or raise, and run their plain PyTorch versions on the
CPU; the plain versions are also what the kernels are checked against on the
card.
"""

import math

import torch

from weathermodel_tpu_torch.kernels import build
from weathermodel_tpu_torch.ops.attention import dropout_params
from weathermodel_tpu_torch.ops.dropout import (
    apply_keep,
    check_seed,
    ffn_keep_mask,
    rounded_scale,
)

LANES = 512  # the lane view's row width (pallas_dropout.py:86)


def random_keep_mask_reference(shape, rate: float, seed: int,
                               device) -> torch.Tensor:
    """Plain PyTorch version of kernel B8m: bool [shape]."""
    n = math.prod(shape)
    keep = ffn_keep_mask(seed, -(-n // LANES), LANES, rate, device)
    return keep.reshape(-1)[:n].reshape(shape)


def random_keep_mask(shape, rate: float, seed: int,
                     device="cuda") -> torch.Tensor:
    """Kernel B8m: bool keep-mask of `shape`, keep iff bits < floor((1 -
    rate) 2^32). A CUDA device launches the kernel (counted in
    `random_keep_mask.launches`), the CPU runs the plain version."""
    device = torch.device(device)
    shape = tuple(int(s) for s in shape)
    if rate <= 0.0:
        return torch.ones(shape, dtype=torch.bool, device=device)
    if not build.device_on_cuda(device):
        return random_keep_mask_reference(shape, rate, seed, device)
    _, threshold, _, _ = dropout_params(rate)
    check_seed(seed)
    out = torch.empty(shape, dtype=torch.bool, device=device)
    lib = build.load_library().lib
    with torch.cuda.device(device):
        err = lib.wm_random_keep_mask(out.data_ptr(), out.numel(), seed,
                                      threshold, build.cuda_stream(device))
    build.check(err)
    random_keep_mask.launches += 1
    return out


random_keep_mask.launches = 0


def lane_dropout_reference(x, rate: float, seed: int):
    """Plain PyTorch version of kernel B8."""
    return apply_keep(x, random_keep_mask_reference(x.shape, rate, seed,
                                                    x.device), rate)


def lane_dropout(x, rate: float, seed: int):
    """Kernel B8: x (fp32 or bf16, any shape) dropped by
    `random_keep_mask(x.shape, rate, seed)`. CUDA tensors launch the kernel
    (counted in `lane_dropout.launches`) or raise; CPU tensors take the
    plain version; the identity at rate <= 0."""
    if rate <= 0.0:
        return x
    if not build.on_cuda("lane_dropout", None, x):
        return lane_dropout_reference(x, rate, seed)
    _, threshold, _, _ = dropout_params(rate)
    check_seed(seed)
    x = x.contiguous()
    out = torch.empty_like(x)
    scale = rounded_scale(rate, x.dtype)  # exact in the kernel's fp32
    lib = build.load_library().lib
    with torch.cuda.device(x.device):
        err = lib.wm_lane_dropout(build.DTYPE_CODES[x.dtype], x.data_ptr(),
                                  out.data_ptr(), x.numel(), seed, threshold,
                                  scale, build.cuda_stream(x.device))
    build.check(err)
    lane_dropout.launches += 1
    return out


lane_dropout.launches = 0


class KernelDropout(torch.autograd.Function):
    """y = lane_dropout(x); dx = lane_dropout(dy) with the same seed: the
    mask is regenerated, never saved."""

    @staticmethod
    def forward(ctx, x, rate, seed):
        ctx.rate, ctx.seed = rate, seed
        return lane_dropout(x, rate, seed)

    @staticmethod
    def backward(ctx, dy):
        return lane_dropout(dy, ctx.rate, ctx.seed), None, None


def kernel_dropout(x, rate: float, seed: int):
    """Dropout of x (any shape) by kernel B8, forward and backward; the
    identity at rate <= 0 (JAX `pallas_dropout.dropout`)."""
    if rate <= 0.0:
        return x
    return KernelDropout.apply(x, rate, seed)
