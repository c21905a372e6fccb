"""The head-layout probes of attention's matrix products: kernels P1 and P2
(port of `run_v0` and `run_v1`, scripts/abl_headpack.py:115,125).

q, k and v are [B, T, H] with the heads side by side in H (head j owns
columns j * HD .. (j + 1) * HD - 1), the JAX script's layout. Neither probe
has a softmax or a scale: they time the two products attention runs per
head.

* `headpack_v0` - kernel P1 (`csrc/headpack.cu`, JAX `_v0_kernel`): for
  every head j, S_j = q_j k_j^T (fp32 sum, rounded to the input dtype) and
  O_j = S_j v_j (fp32 sum, rounded), written to head j's columns.
* `headpack_v1` - kernel P2 (JAX `_v1_kernel`): the same products with
  GROUP = 3 heads packed per pass: q3 [T, G HD] against block-diagonal Kbd and
  Vbd [G T, G HD] (head i's k or v in rows i T.., columns i HD.., zeros
  elsewhere), S3 = q3 Kbd^T [T, G T] rounded, O3 = S3 Vbd. Only whole groups
  are computed: with 16 heads in groups of 3, head 15's columns are never
  written, by the TPU kernel too.

The kernels allocate their output with `torch.empty` and leave what they do
not compute unwritten, as the TPU kernels do; the plain versions fill it
with NaN, as JAX's Pallas interpreter leaves it. Each wrapper launches its
hand-written Hopper kernel on CUDA tensors (counting the launch in its
`launches` attribute) or raises, and runs its plain PyTorch version
(`*_reference`) on CPU tensors; the plain version is also what the kernel is
checked against on the card. The kernels take bfloat16, contiguous
[B, T, H] with HD = 36, the probes' widths.
"""

import torch

from weathermodel_tpu_torch.kernels import build

NUM_HEADS = 16
GROUP = 3
KERNEL_HEAD_DIM = 36  # the head dim csrc/headpack.cu is built for


def _check(q, k, v, num_heads):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one [B, T, H] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[2] % num_heads:
        raise ValueError(f"H = {q.shape[2]} is not a multiple of "
                         f"{num_heads} heads")
    return q.shape[2] // num_heads


def _heads(a, num_heads):
    """[B, T, H] -> fp32 [B, NH, T, HD]."""
    b, t, h = a.shape
    return a.float().reshape(b, t, num_heads, h // num_heads).transpose(1, 2)


def headpack_v0_reference(q, k, v, num_heads: int = NUM_HEADS):
    """Plain PyTorch version of kernel P1: every head's S_j = q_j k_j^T and
    O_j = S_j v_j, each an fp32 sum rounded to q.dtype."""
    _check(q, k, v, num_heads)
    s = (_heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2))
    o = s.to(q.dtype).float() @ _heads(v, num_heads)
    return o.to(q.dtype).transpose(1, 2).reshape(q.shape)


def block_diagonal(a, num_heads: int = NUM_HEADS):
    """[B, T, H] -> fp32 [B, NH // G, G T, G HD]: per group of GROUP heads,
    head i's [T, HD] block in rows i T.., columns i HD.., zeros elsewhere
    (the TPU kernel's Kbd and Vbd scratch)."""
    b, t, h = a.shape
    hd, n_groups = h // num_heads, num_heads // GROUP
    heads = _heads(a, num_heads)[:, :n_groups * GROUP].view(
        b, n_groups, GROUP, t, hd)
    out = a.new_zeros(b, n_groups, GROUP, t, GROUP, hd, dtype=torch.float32)
    for i in range(GROUP):
        out[:, :, i, :, i] = heads[:, :, i]
    return out.view(b, n_groups, GROUP * t, GROUP * hd)


def headpack_v1_reference(q, k, v, num_heads: int = NUM_HEADS):
    """Plain PyTorch version of kernel P2: the packed products computed
    literally, zero blocks included (exact zeros change no fp32 sum), S3
    rounded to q.dtype, O3 rounded; the columns of heads past the last whole
    group are NaN."""
    hd = _check(q, k, v, num_heads)
    b, t, h = q.shape
    n_groups = num_heads // GROUP
    width = n_groups * GROUP * hd
    q3 = q[..., :width].float().reshape(b, t, n_groups, GROUP * hd)
    s3 = q3.transpose(1, 2) @ block_diagonal(k, num_heads).transpose(-1, -2)
    o3 = s3.to(q.dtype).float() @ block_diagonal(v, num_heads)
    out = torch.full_like(q, float("nan"))
    out[..., :width] = o3.to(q.dtype).transpose(1, 2).reshape(b, t, width)
    return out


def _on_cuda(name, q, k, v, hd) -> bool:
    """`build.on_cuda`, and what csrc/headpack.cu takes: bfloat16,
    contiguous, 8-byte aligned, head dim 36."""
    if not build.on_cuda(name, None, q, k, v):
        return False
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel is built for bfloat16, got "
                         f"{q.dtype}")
    if hd != KERNEL_HEAD_DIM:
        raise ValueError(f"{name}: the kernel is built for head dim "
                         f"{KERNEL_HEAD_DIM}, got {hd}")
    if not all(a.is_contiguous() and a.data_ptr() % 8 == 0
               for a in (q, k, v)):
        raise ValueError(f"{name} needs contiguous, 8-byte aligned q, k, v")
    return True


def _launch(entry, fn, q, k, v):
    b, t, h = q.shape
    out = torch.empty_like(q)
    lib = build.load_library().lib
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), b, t, h,
                                  build.cuda_stream(q.device))
    build.check(err)
    fn.launches += 1
    return out


def headpack_v0(q, k, v, num_heads: int = NUM_HEADS):
    """Kernel P1: q, k, v [B, T, H] -> o [B, T, H], every head's
    (q_j k_j^T) v_j with S_j rounded to q.dtype.

    CUDA tensors launch the kernel (counted in `headpack_v0.launches`) or
    raise; CPU tensors take the plain version."""
    hd = _check(q, k, v, num_heads)
    if not _on_cuda("headpack_v0", q, k, v, hd):
        return headpack_v0_reference(q, k, v, num_heads)
    return _launch("wm_headpack_v0", headpack_v0, q, k, v)


headpack_v0.launches = 0


def headpack_v1(q, k, v, num_heads: int = NUM_HEADS):
    """Kernel P2: P1's products with GROUP heads packed into
    block-diagonal operands, for the heads of whole groups; the other
    heads' columns of o are left unwritten (NaN in the plain version).

    CUDA tensors launch the kernel (counted in `headpack_v1.launches`) or
    raise; CPU tensors take the plain version."""
    hd = _check(q, k, v, num_heads)
    if not _on_cuda("headpack_v1", q, k, v, hd):
        return headpack_v1_reference(q, k, v, num_heads)
    return _launch("wm_headpack_v1", headpack_v1, q, k, v)


headpack_v1.launches = 0
