"""The maskgen dropout impls: keep-mask kernels B9p (packed) and B9b (bool)
and the dropout ops built on them (port of weathermodel_tpu/ops/
pallas_maskgen.py, the JAX dropout impls "maskgen" and "maskgen_bool").

* `packed_keep_mask` - kernel B9p (`csrc/keep_mask.cu`, JAX `_kernel`):
  int32 [m / 32, c], bit i of word [g, j] = keep(row 32g + i, col j),
  packed along the rows (bit 31 makes a word negative, as in JAX).
  `unpack_keep` turns it back into bool [m, c].
* `bool_keep_mask` - kernel B9b (JAX `_bool_kernel`): bool [m, c].
* `packed_dropout` / `bool_dropout` - dropout of x [..., C] through
  `PackedDropout` (saves only the m * c / 32 int32 words) or `BoolDropout`
  (saves the bool mask); each backward applies the saved mask to dy. JAX's
  shape rule: `packed_dropout` needs prod(leading) % 32 == 0 and C % 128 ==
  0, `bool_dropout` C % 128 == 0; other shapes take the "auto" impl
  (`ops/dropout.py::rand_dropout`), as JAX's fall back to `bits8`.

The TPU kernels draw from the hardware PRNG, seeded per block. The card has
none, so the bits are the FFN sites' hash of (seed, row, col)
(`ops/dropout.py::hash_keep_mask`), independent of the launch's blocks, and
an element is kept iff bits >= floor(rate * 2^32), the maskgen rule
(pallas_maskgen.py:42-44,116-117). So `unpack_keep(packed_keep_mask(...))`
equals `bool_keep_mask(...)` exactly. A kept value is multiplied by
1/(1 - rate) rounded to x's dtype (`ops/dropout.py::apply_keep`).

The mask wrappers launch the hand-written Hopper kernels on a CUDA device
(counting each launch in `.launches`) or raise, and run their plain
PyTorch versions on the CPU; the plain versions are also what the kernels
are checked against on the card.
"""

import math

import torch

from weathermodel_tpu_torch.kernels import build
from weathermodel_tpu_torch.ops.dropout import (
    apply_keep,
    check_seed,
    hash_keep_mask,
    rand_dropout,
)

GROUP = 32  # mask rows packed per int32 word (along the rows)
C_ALIGN = 128  # the TPU kernels' lane rule on the last dim


def maskgen_threshold(rate: float) -> int:
    """keep iff bits >= this (uint32): floor(rate * 2^32)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return int(rate * 4294967296.0)


def _check_mask_shape(m: int, c: int, packed: bool):
    if m < 0 or c <= 0 or c % C_ALIGN or (packed and m % GROUP):
        rule = "m % 32 == 0 and c % 128 == 0" if packed else "c % 128 == 0"
        raise ValueError(f"keep mask [{m}, {c}] needs {rule}")


def bool_keep_mask_reference(m: int, c: int, rate: float, seed: int,
                             device) -> torch.Tensor:
    """Plain PyTorch version of kernel B9b: bool [m, c]."""
    _check_mask_shape(m, c, packed=False)
    return hash_keep_mask(seed, m, c, maskgen_threshold(rate), True, device)


def packed_keep_mask_reference(m: int, c: int, rate: float, seed: int,
                               device) -> torch.Tensor:
    """Plain PyTorch version of kernel B9p: int32 [m / 32, c]."""
    _check_mask_shape(m, c, packed=True)
    keep = bool_keep_mask_reference(m, c, rate, seed, device)
    keep = keep.view(m // GROUP, GROUP, c)
    words = torch.zeros(m // GROUP, c, dtype=torch.int32, device=device)
    for i in range(GROUP):  # 1 << 31 wraps to the int32 sign bit
        words |= keep[:, i].to(torch.int32) << i
    return words


def _launch(name, fn, out, *args):
    lib = build.load_library().lib
    with torch.cuda.device(out.device):
        err = getattr(lib, name)(out.data_ptr(), *args,
                                 build.cuda_stream(out.device))
    build.check(err)
    fn.launches += 1
    return out


def bool_keep_mask(m: int, c: int, rate: float, seed: int,
                   device="cuda") -> torch.Tensor:
    """Kernel B9b: bool [m, c] keep-mask, keep iff bits >= floor(rate 2^32);
    c a multiple of 128. A CUDA device launches the kernel (counted in
    `bool_keep_mask.launches`), the CPU runs the plain version."""
    device = torch.device(device)
    if not build.device_on_cuda(device):
        return bool_keep_mask_reference(m, c, rate, seed, device)
    _check_mask_shape(m, c, packed=False)
    check_seed(seed)
    out = torch.empty(m, c, dtype=torch.bool, device=device)
    return _launch("wm_bool_keep_mask", bool_keep_mask, out, m, c, seed,
                   maskgen_threshold(rate))


bool_keep_mask.launches = 0


def packed_keep_mask(m: int, c: int, rate: float, seed: int,
                     device="cuda") -> torch.Tensor:
    """Kernel B9p: int32 [m / 32, c], bit i of word [g, j] = keep(32g + i,
    j); m a multiple of 32, c of 128. A CUDA device launches the kernel
    (counted in `packed_keep_mask.launches`), the CPU runs the plain
    version."""
    device = torch.device(device)
    if not build.device_on_cuda(device):
        return packed_keep_mask_reference(m, c, rate, seed, device)
    _check_mask_shape(m, c, packed=True)
    check_seed(seed)
    out = torch.empty(m // GROUP, c, dtype=torch.int32, device=device)
    return _launch("wm_packed_keep_mask", packed_keep_mask, out, m, c, seed,
                   maskgen_threshold(rate))


packed_keep_mask.launches = 0


def unpack_keep(packed: torch.Tensor, m: int) -> torch.Tensor:
    """int32 [m / 32, c] -> bool [m, c]: bit s of a word by an arithmetic
    shift and & 1 (the shift's sign fill never reaches bit 0)."""
    rows, c = packed.shape
    shifts = torch.arange(GROUP, dtype=torch.int32,
                          device=packed.device).view(1, GROUP, 1)
    bits = (packed[:, None, :] >> shifts) & 1
    return bits.to(torch.bool).reshape(m, c)


class PackedDropout(torch.autograd.Function):
    """Dropout of x2d [m, c] by B9p's mask; saves only the packed words."""

    @staticmethod
    def forward(ctx, x2d, rate, seed):
        m, c = x2d.shape
        packed = packed_keep_mask(m, c, rate, seed, x2d.device)
        ctx.save_for_backward(packed)
        ctx.rate = rate
        return apply_keep(x2d, unpack_keep(packed, m), rate)

    @staticmethod
    def backward(ctx, dy):
        (packed,) = ctx.saved_tensors
        return apply_keep(dy, unpack_keep(packed, dy.shape[0]),
                          ctx.rate), None, None


class BoolDropout(torch.autograd.Function):
    """Dropout of x2d [m, c] by B9b's mask; saves the bool mask."""

    @staticmethod
    def forward(ctx, x2d, rate, seed):
        keep = bool_keep_mask(*x2d.shape, rate, seed, x2d.device)
        ctx.save_for_backward(keep)
        ctx.rate = rate
        return apply_keep(x2d, keep, rate)

    @staticmethod
    def backward(ctx, dy):
        (keep,) = ctx.saved_tensors
        return apply_keep(dy, keep, ctx.rate), None, None


def _rows_cols(x):
    return math.prod(x.shape[:-1]), x.shape[-1]


def packed_dropout(x, rate: float, seed: int):
    """Dropout of x [..., C] by B9p's mask when prod(leading) % 32 == 0 and
    C % 128 == 0, else the "auto" impl (JAX `packed_dropout`'s rule)."""
    if rate <= 0.0:
        return x
    m, c = _rows_cols(x)
    if m % GROUP or c % C_ALIGN:
        return rand_dropout(x, rate, seed)
    return PackedDropout.apply(x.reshape(m, c), rate, seed).reshape(x.shape)


def bool_dropout(x, rate: float, seed: int):
    """Dropout of x [..., C] by B9b's mask when C % 128 == 0, else the
    "auto" impl (JAX `bool_dropout`'s rule)."""
    if rate <= 0.0:
        return x
    m, c = _rows_cols(x)
    if c % C_ALIGN:
        return rand_dropout(x, rate, seed)
    return BoolDropout.apply(x.reshape(m, c), rate, seed).reshape(x.shape)
