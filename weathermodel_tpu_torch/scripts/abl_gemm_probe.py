"""Go/no-go probe for a hand-written GEMM at the WeatherBERT-large FFN shape,
on the card (port of scripts/abl_gemm_probe.py): how close does a blocked
GEMM written by hand (kernel P3, `ops.blocked_mm.blocked_mm`) come to the
library's matmul at [70144, 576] x [576, 2304] bf16? The fused FFN kernels
(B6f, B6b, B7) and the grouped matmuls (B4, B4t) run the same tiles, so the
gap measured here is the room a fused GEMM + ReLU + dropout kernel has to
win back before its fusion savings show.

torch.matmul is timed as the yardstick only; the port never calls it. Each
arm passes the TPU's (bm, bn) block, which decides only the covered region
((m // bm) bm rows, (n // bn) bn columns); TF/s counts that region's FLOPs.
An arm that fails raises, and the run exits non-zero.

    python -m weathermodel_tpu_torch.scripts.abl_gemm_probe [--device cpu]
"""

import argparse

import numpy as np
import torch

from weathermodel_tpu_torch.cli.pretrain import resolve_device
from weathermodel_tpu_torch.ops.blocked_mm import blocked_mm, covered
from weathermodel_tpu_torch.scripts import device_line, time_ms

# the FFN shape's 70080 rows padded to 548 x 128, as the JAX script runs it
M, K, N = 70144, 576, 2304
ARMS = ((512, 1152), (512, 2304), (1024, 1152), (256, 2304), (1024, 2304))
STEPS = 30


def inputs(m: int, device):
    """x [m, K] (normals x 0.1) and w [K, N] (normals x 0.05), bf16, from
    numpy default_rng(0)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(m, K)) * 0.1)
    w = torch.from_numpy(rng.normal(size=(K, N)) * 0.05)
    return (x.to(device=device, dtype=torch.bfloat16),
            w.to(device=device, dtype=torch.bfloat16))


def main(device="cuda", m: int = M, steps: int = STEPS) -> dict:
    """Time torch.matmul and each (bm, bn) arm of the blocked GEMM; returns
    the numbers and the printed lines."""
    device = resolve_device(device)
    lines = []

    def say(tag, ms, flops):
        line = f"{tag:42s} {ms:7.3f} ms  {flops / ms / 1e9:6.1f} TF/s"
        print(line, flush=True)
        lines.append(line)

    lines.append(device_line(device))
    print(lines[0], flush=True)
    x, w = inputs(m, device)
    matmul_ms = time_ms(lambda: torch.matmul(x, w), steps, device)
    say("torch.matmul", matmul_ms, 2 * m * K * N)
    arms = []
    for bm, bn in ARMS:
        rows, cols = covered(m, N, bm, bn)
        ms = time_ms(lambda: blocked_mm(x, w, bm, bn), steps, device)
        say(f"blocked mm bm={bm} bn={bn}", ms, 2 * rows * K * cols)
        arms.append(dict(bm=bm, bn=bn, rows=rows, cols=cols, ms=ms))
    return dict(device=str(device), m=m, steps=steps, matmul_ms=matmul_ms,
                arms=arms, lines=lines)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
