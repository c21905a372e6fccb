"""Head-packed layouts for attention's matrix products, on the card (port of
scripts/abl_headpack.py).

Hypothesis under test: hd=36 wastes most of every matrix-unit tile; packing
3 heads (3 x 36 = 108 columns) per pass with block-diagonal operands should
cut attention's matmul time up to ~2.8x.

Counter-analysis: the matrix unit's time goes as M x ceil(N / tile) x
ceil(K / tile) per matmul; block-diagonal packing trades K-padding for
extra N tiles (scores) or N-padding for extra K tiles (AV) exactly 1:1, so
the pass count is conserved and packing should be neutral at best (the
block-diagonal construction itself costs passes and memory). On Hopper the
products run on wgmma (csrc/headpack_hopper.cuh): its depth is a multiple of
16 and its width N a multiple of 8, so a head of 36 pads to 48 deep and 40
wide (P1 multiplies a fifth more than its useful products), a group of 108
to 112 both ways; but the group multiplies three times the rows, so the
packed form does 2.4x P1's tensor-core work for 15 of its 16 heads.

This script settles it with the matmul patterns in isolation (no softmax,
identical IO, no dropout):

  V0 (P1, `ops.headpack.headpack_v0`): per head j
        S_j = q_j k_j^T  [384, 36] x [36, 384];  O_j = S_j v_j  [384, 384] x
        [384, 36]
  V1 (P2, `ops.headpack.headpack_v1`): per group of 3 heads, block-diagonal
        Kbd, Vbd [3 x 384, 108];  S3 = q3 Kbd^T [384, 1152];  O3 = S3 Vbd
        [384, 108]

G = 3 does not divide NH = 16, so V1 computes heads 0-14 and never writes
head 15 (on the TPU too): the cross-check's relative error is taken over
the 15 heads both compute.

    python -m weathermodel_tpu_torch.scripts.abl_headpack [--device cpu]
"""

import argparse

import numpy as np
import torch

from weathermodel_tpu_torch.cli.pretrain import resolve_device
from weathermodel_tpu_torch.ops.headpack import headpack_v0, headpack_v1
from weathermodel_tpu_torch.scripts import device_line, time_ms

B, T, H, NH, HD = 224, 384, 576, 16, 36
G = 3  # heads per packed group
STEPS = 30
LIVE = NH // G * G * HD  # the columns both versions compute: heads 0-14


def inputs(batch: int, device):
    """q, k, v [batch, T, H] bf16: numpy default_rng(0) normals, in that
    order."""
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.normal(size=(batch, T, H))).to(
        device=device, dtype=torch.bfloat16) for _ in range(3))


def main(device="cuda", batch: int = B, steps: int = STEPS) -> dict:
    """Cross-check V0 against V1, then time each; returns the numbers and
    the printed lines."""
    device = resolve_device(device)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)

    say(device_line(device))
    q, k, v = inputs(batch, device)
    o0 = headpack_v0(q, k, v)[..., :LIVE].float()
    o1 = headpack_v1(q, k, v)[..., :LIVE].float()
    err = ((o0 - o1).abs().max() / (o0.abs().max() + 1e-9)).item()
    say(f"v0 vs v1 rel err (heads 0-{NH // G * G - 1}): {err:.2e}")
    del o0, o1
    v0_ms = time_ms(lambda: headpack_v0(q, k, v), steps, device)
    say(f"V0 per-head matmuls (B={batch}): {v0_ms:.3f} ms")
    v1_ms = time_ms(lambda: headpack_v1(q, k, v), steps, device)
    say(f"V1 packed block-diag g={G} (B={batch}): {v1_ms:.3f} ms")
    return dict(device=str(device), batch=batch, steps=steps, rel_err=err,
                v0_ms=v0_ms, v1_ms=v1_ms, lines=lines)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


if __name__ == "__main__":
    main(**vars(parse_args()))
