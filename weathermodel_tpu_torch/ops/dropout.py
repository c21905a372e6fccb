"""Dropout for the plain sites of the encoder layer (port of
weathermodel_tpu/ops/dropout.py: its impl switch and the impls the port has).

Randomness comes from the caller: a CPU `torch.Generator` hands out integer
seeds (`draw_seed`, host only, so no device sync), and each dropout site
draws exactly one seed, whatever the impl, so later seeds do not depend on
it. The attention-weight site runs inside the attention kernels and takes
its seed directly (ops/fused_qkv_attention.py, ops/flash_attention.py).

`dropout` dispatches on the impl `set_impl` chose, as the JAX `dropout`
does (its `_IMPLS`):
  "auto"          `rand_dropout`: a `torch.rand` mask drawn on x's device
                  from the site's seed (the JAX `auto` -> `bits8`)
  "maskgen"       `ops/maskgen.py::packed_dropout`: the packed keep-mask
                  kernel B9p (JAX `pallas_maskgen.packed_dropout`)
  "maskgen_bool"  `ops/maskgen.py::bool_dropout`: the bool keep-mask kernel
                  B9b (JAX `pallas_maskgen.bool_dropout`)
The JAX package's ablation arms stay JAX-only (ROADMAP.md queue A item 15).
Every impl keeps a value as `apply_keep` does: multiplied by 1/(1 - p)
rounded to x's dtype, the product rounded once, as JAX `_apply8` and the
maskgen impls do.

The FFN sites of the fused FFN kernels (ops/fused_ffn.py, ops/fused_ffn_ln.py)
draw no mask from a generator: element (row, col) of a site is kept iff
mix32(mix32(seed ^ mix32(row + 0x9E3779B9)) ^ col) < (1 - p) * 2^32, the
attention hash (ops/attention.py) on a (row, col) pair, with one seed per
site. `hash_keep_mask` computes those bits with int64 tensor ops, exactly as
`csrc/ffn_common.cuh` and `csrc/keep_mask.cu` do in the kernels, so a kernel
and its plain version draw the same mask and a backward kernel regenerates
the forward's.
"""

import torch

from weathermodel_tpu_torch.ops.attention import (
    M32,
    MASK_CHUNK,
    dropout_params,
    mix32,
)

SEED_BOUND = 2 ** 31 - 1
DROPOUT_IMPLS = ("auto", "maskgen", "maskgen_bool")
# the JAX package's ablation arms (weathermodel_tpu/ops/dropout.py:45-57)
JAX_ONLY_IMPLS = ("bits16", "bits16_ad", "mul16", "bits8", "bits4",
                  "bits8_sign", "nn", "skip")

_IMPL = "auto"


def set_impl(value: str) -> None:
    """Select the impl of every plain dropout site (process-wide, as the
    JAX package's `set_impl`)."""
    global _IMPL
    if value in JAX_ONLY_IMPLS:
        raise NotImplementedError(
            f"dropout impl {value!r} is a JAX-only ablation arm and is not "
            "ported; see ROADMAP.md queue A item 15")
    if value not in DROPOUT_IMPLS:
        raise ValueError(f"Unknown dropout impl {value!r}; choose one of "
                         f"{DROPOUT_IMPLS}")
    _IMPL = value


def get_impl() -> str:
    return _IMPL


def draw_seed(generator: torch.Generator) -> int:
    """An integer seed in [0, 2^31 - 1) from a CPU generator."""
    return int(torch.randint(0, SEED_BOUND, (), generator=generator))


def check_seed(seed: int) -> None:
    if not 0 <= seed <= M32:
        raise ValueError(f"dropout seed must be in [0, 2^32), got {seed}")


def rounded_scale(rate: float, dtype) -> float:
    """1/(1 - rate) rounded to `dtype`, as a Python float (exact in fp32)."""
    return torch.tensor(1.0 / (1.0 - rate), dtype=dtype).item()


def apply_keep(x, keep, rate: float):
    """x where `keep`, times 1/(1 - rate) rounded to x's dtype (the product
    rounded once), else 0: JAX `_apply8`'s rounding. The scale is a host
    scalar, so nothing waits on the device."""
    return torch.where(keep, x * rounded_scale(rate, x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def rand_dropout(x, rate: float, seed: int):
    """The "auto" impl (rate > 0): each element zeroed with probability
    `rate` by a `torch.rand` mask drawn on x's device from `seed`."""
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return apply_keep(x, keep, rate)


def dropout(x, rate: float, seed: int):
    """Zero each element with probability `rate` and scale the others by
    1/(1 - rate), by the impl `set_impl` chose; identity at rate 0."""
    if rate <= 0.0:
        return x
    if _IMPL == "auto":
        return rand_dropout(x, rate, seed)
    from weathermodel_tpu_torch.ops import maskgen

    if _IMPL == "maskgen":
        return maskgen.packed_dropout(x, rate, seed)
    return maskgen.bool_dropout(x, rate, seed)


def hash_keep_mask(seed: int, rows: int, cols: int, threshold: int,
                   keep_at_least: bool, device) -> torch.Tensor:
    """Bool [rows, cols]: with bits = mix32(mix32(seed ^ mix32(row +
    0x9E3779B9)) ^ col), keep iff bits >= threshold (`keep_at_least`, the
    maskgen rule) or bits < threshold (the attention and FFN kernels'
    rule). Computed in chunks of rows to bound the int64 temporaries."""
    check_seed(seed)
    col = torch.arange(cols, device=device)
    step = max(1, MASK_CHUNK // max(cols, 1))  # rows per chunk
    out = []
    for r0 in range(0, rows, step):
        row = torch.arange(r0, min(rows, r0 + step), device=device)[:, None]
        bits = mix32(mix32(seed ^ mix32((row + 0x9E3779B9) & M32)) ^ col)
        out.append(bits >= threshold if keep_at_least else bits < threshold)
    return torch.cat(out) if out else torch.ones(0, cols, dtype=torch.bool,
                                                  device=device)


def ffn_keep_mask(seed: int, rows: int, cols: int, rate: float,
                  device) -> torch.Tensor:
    """Bool keep-mask [rows, cols] of an FFN dropout site for `seed` (an
    integer in [0, 2^32)); row is the flattened row of the layer's input."""
    on, threshold, _, _ = dropout_params(rate)
    check_seed(seed)
    if not on:
        return torch.ones(rows, cols, dtype=torch.bool, device=device)
    return hash_keep_mask(seed, rows, cols, threshold, False, device)
