"""The blocked matmul probe: kernel P3 (port of `pallas_mm`,
scripts/abl_gemm_probe.py:46).

`blocked_mm(x, w, bm, bn)` computes y = x w, an fp32 sum rounded to x.dtype,
on the covered region: the first (m // bm) * bm rows and (n // bn) * bn
columns, the part of y that the TPU kernel's grid (m // bm, n // bn) of
(bm, bn) blocks reaches. The rest of y is never written: the kernel
allocates y with `torch.empty` and leaves it, as the TPU kernel does, and the
plain version fills it with NaN, as JAX's Pallas interpreter leaves it.
(bm, bn) are the TPU's VMEM block and decide only the covered region; the
kernel (`csrc/blocked_mm.cu`) has its own 128 x 128 tile and stops at the
region's edge itself.

The wrapper launches the hand-written Hopper kernel on CUDA tensors
(counting the launch in `blocked_mm.launches`) or raises, and runs the plain
PyTorch version (`blocked_mm_reference`) on CPU tensors; the plain version is
also what the kernel is checked against on the card.
"""

import torch

from weathermodel_tpu_torch.kernels import build


def covered(m: int, n: int, bm: int, bn: int):
    """(rows, columns) of y that the TPU grid (m // bm, n // bn) writes."""
    if bm <= 0 or bn <= 0:
        raise ValueError(f"block ({bm}, {bn}) must be positive")
    return m // bm * bm, n // bn * bn


def _check(x, w):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x [m, k] and w [k, n] must share k, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def blocked_mm_reference(x, w, bm: int, bn: int):
    """Plain PyTorch version of kernel P3: the fp32 product on the covered
    region, rounded to x.dtype; NaN elsewhere."""
    _check(x, w)
    mc, nc = covered(x.shape[0], w.shape[1], bm, bn)
    y = x.new_full((x.shape[0], w.shape[1]), float("nan"))
    y[:mc, :nc] = (x[:mc].float() @ w[:, :nc].float()).to(x.dtype)
    return y


def blocked_mm(x, w, bm: int, bn: int):
    """Kernel P3: x [m, k], w [k, n] -> y [m, n] in x.dtype, x w on the
    covered region (m // bm * bm rows, n // bn * bn columns), the rest
    unwritten.

    CUDA tensors launch the kernel (counted in `blocked_mm.launches`) or
    raise; CPU tensors take the plain version."""
    _check(x, w)
    if not build.on_cuda("blocked_mm", None, x, w):
        return blocked_mm_reference(x, w, bm, bn)
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("blocked_mm needs contiguous x and w")
    (m, k), n = x.shape, w.shape[1]
    mc, nc = covered(m, n, bm, bn)
    y = x.new_empty(m, n)
    if mc == 0 or nc == 0:
        return y  # the TPU grid is empty: nothing to launch
    lib = build.load_library().lib
    with torch.cuda.device(x.device):
        err = lib.wm_blocked_mm(build.DTYPE_CODES[x.dtype], x.data_ptr(),
                                w.data_ptr(), y.data_ptr(), mc, k, n, nc,
                                build.cuda_stream(x.device))
    build.check(err)
    blocked_mm.launches += 1
    return y


blocked_mm.launches = 0
