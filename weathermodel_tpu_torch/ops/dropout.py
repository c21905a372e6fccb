"""Dropout for the plain sites of the encoder layer (port of the one impl of
weathermodel_tpu/ops/dropout.py the port needs).

Randomness comes from the caller: a CPU `torch.Generator` hands out integer
seeds (`draw_seed`, host only, so no device sync), and each dropout site
draws its mask on the tensor's device from a generator seeded with its own
seed. The attention-weight site runs inside the fused attention kernel and
takes its seed directly (ops/fused_qkv_attention.py).
"""

import torch

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
