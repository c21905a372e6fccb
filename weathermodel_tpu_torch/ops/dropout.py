"""Dropout for the plain sites of the encoder layer (port of the one impl of
weathermodel_tpu/ops/dropout.py the port needs).

Randomness comes from the caller: a CPU `torch.Generator` hands out integer
seeds (`draw_seed`, host only, so no device sync), and each dropout site
draws its mask on the tensor's device from a generator seeded with its own
seed. The attention-weight site runs inside the attention kernels and
takes its seed directly (ops/fused_qkv_attention.py, ops/flash_attention.py).

The FFN sites of the fused FFN kernels (ops/fused_ffn.py, ops/fused_ffn_ln.py)
draw no mask from a generator: element (row, col) of a site is kept iff
mix32(mix32(seed ^ mix32(row + 0x9E3779B9)) ^ col) < (1 - p) * 2^32, the
attention hash (ops/attention.py) on a (row, col) pair, with one seed per
site. `ffn_keep_mask` computes those bits with int64 tensor ops, exactly as
`csrc/ffn_common.cuh` does in the kernels, so a kernel and its plain version
draw the same mask and the backward kernel regenerates the forward's.
"""

import torch

from weathermodel_tpu_torch.ops.attention import (
    M32,
    MASK_CHUNK,
    dropout_params,
    mix32,
)

SEED_BOUND = 2 ** 31 - 1


def draw_seed(generator: torch.Generator) -> int:
    """An integer seed in [0, 2^31 - 1) from a CPU generator."""
    return int(torch.randint(0, SEED_BOUND, (), generator=generator))


def dropout(x, rate: float, seed: int):
    """Zero each element with probability `rate` and scale the others by
    1/(1 - rate), in x's dtype; the mask is drawn on x's device from
    `seed`."""
    if rate <= 0.0:
        return x
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def ffn_keep_mask(seed: int, rows: int, cols: int, rate: float,
                  device) -> torch.Tensor:
    """Bool keep-mask [rows, cols] of an FFN dropout site for `seed` (an
    integer in [0, 2^32)); row is the flattened row of the layer's input."""
    on, threshold, _, _ = dropout_params(rate)
    if not 0 <= seed <= M32:
        raise ValueError(f"dropout seed must be in [0, 2^32), got {seed}")
    if not on:
        return torch.ones(rows, cols, dtype=torch.bool, device=device)
    col = torch.arange(cols, device=device)
    step = max(1, MASK_CHUNK // max(cols, 1))  # rows per chunk
    out = []
    for r0 in range(0, rows, step):
        row = torch.arange(r0, min(rows, r0 + step), device=device)[:, None]
        key = mix32(seed ^ mix32((row + 0x9E3779B9) & M32))
        out.append(mix32(key ^ col) < threshold)
    return torch.cat(out) if out else torch.ones(0, cols, dtype=torch.bool,
                                                  device=device)
