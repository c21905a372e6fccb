"""Grouped matmul, the dropless MoE expert GEMM, and its weight gradient
(port of `gmm` and its custom VJP, weathermodel_tpu/ops/pallas_gmm.py:307-341).

* `gmm` - kernel B4 (`csrc/gmm.cu`, `_gmm_kernel`): lhs [S, K] with rows
  sorted by group, rhs [E, K, N] and group_sizes [E] -> [S, N], row s
  multiplied by its own group's weights; with `trans_rhs` rhs is [E, N, K]
  and row s multiplies rhs[g]^T (the backward's d_lhs reads the forward's
  weights without a copy). Rows past the sum of the sizes come out as zeros.
* `tgmm` - kernel B4t (`csrc/tgmm.cu`, `_tgmm_kernel`): lhs [S, K] and dy
  [S, N] -> [E, K, N], the per-group lhs^T . dy; a group with no rows gets
  zeros (pallas_gmm.py:300-304).
* `GroupedMatmul` - the autograd Function joining them (the custom VJP at
  pallas_gmm.py:307-341): d_lhs = gmm(dy, rhs^T), d_rhs = tgmm(lhs, dy) in
  rhs's dtype.

Both kernels accumulate in fp32 and round once to the inputs' dtype. Each
wrapper launches its hand-written Hopper kernel on CUDA tensors (counting
the launch in its `launches` attribute) or raises, and runs its plain
PyTorch version (`*_reference`, one fp32 matmul per group) on CPU tensors;
the plain version is also what the kernel is checked against on the card.
The group sizes stay on the device: the wrappers hand the kernels their
exclusive cumsum, computed there, and size the grid from S, E, K and N
alone, so nothing waits on the host. The plain versions read the sizes on
the host.

`gmm_sharded` and `group_offset`, the expert-parallel shard-local form
(pallas_gmm.py:344-409), are not ported: they need more than one card
(ROADMAP.md queue A item 14).
"""

import torch

from weathermodel_tpu_torch.kernels import build


def group_offsets(group_sizes):
    """[E] group sizes -> int32 [E + 1] offsets (0, then their cumsum), on
    the sizes' device."""
    ends = torch.cumsum(group_sizes, 0).to(torch.int32)
    return torch.cat([ends.new_zeros(1), ends])


def _check_groups(lhs, group_sizes, e):
    if lhs.dim() != 2:
        raise ValueError(f"lhs must be [S, K], got {tuple(lhs.shape)}")
    if group_sizes.dim() != 1 or group_sizes.shape[0] != e or \
            group_sizes.dtype.is_floating_point:
        raise ValueError(f"group_sizes must be integer [{e}], got "
                         f"{group_sizes.dtype} {tuple(group_sizes.shape)}")


def _check_gmm(lhs, rhs, group_sizes, trans_rhs):
    if rhs.dim() != 3:
        raise ValueError(f"rhs must be [E, K, N], got {tuple(rhs.shape)}")
    _check_groups(lhs, group_sizes, rhs.shape[0])
    k = rhs.shape[2] if trans_rhs else rhs.shape[1]
    if lhs.shape[1] != k:
        raise ValueError(f"lhs {tuple(lhs.shape)} and rhs {tuple(rhs.shape)} "
                         f"(trans_rhs={trans_rhs}) do not share K")


def _on_cuda(name, group_sizes, *tensors) -> bool:
    """`build.on_cuda`, and the layout these kernels take: contiguous
    operands and the group sizes on their device."""
    if not build.on_cuda(name, None, *tensors):
        return False
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError(f"{name} needs contiguous inputs")
    if group_sizes.device != tensors[0].device:
        raise ValueError(f"{name}: group_sizes on {group_sizes.device}, "
                         f"operands on {tensors[0].device}")
    return True


def _slices(group_sizes):
    """(group, first row, end row) of each group, read on the host."""
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        yield g, start, start + size
        start += size


def gmm_reference(lhs, rhs, group_sizes, trans_rhs: bool = False):
    """Plain PyTorch version of kernel B4: one fp32 matmul per group slice,
    rounded to lhs.dtype. Differentiable."""
    _check_gmm(lhs, rhs, group_sizes, trans_rhs)
    parts, end = [], 0
    for g, a, end in _slices(group_sizes):
        w = rhs[g].float()
        parts.append(lhs[a:end].float() @ (w.T if trans_rhs else w))
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    parts.append(lhs.new_zeros(lhs.shape[0] - end, n, dtype=torch.float32))
    return torch.cat(parts).to(lhs.dtype)


def gmm(lhs, rhs, group_sizes, trans_rhs: bool = False):
    """Kernel B4: lhs [S, K] (rows sorted by group), rhs [E, K, N] (or
    [E, N, K] with `trans_rhs`), group_sizes [E] integer -> [S, N] in
    lhs.dtype.

    CUDA tensors launch the kernel (counted in `gmm.launches`) or raise; CPU
    tensors take the plain version."""
    _check_gmm(lhs, rhs, group_sizes, trans_rhs)
    if not _on_cuda("gmm", group_sizes, lhs, rhs):
        return gmm_reference(lhs, rhs, group_sizes, trans_rhs)
    s, k = lhs.shape
    e = rhs.shape[0]
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    offsets = group_offsets(group_sizes)
    out = lhs.new_empty(s, n)
    lib = build.load_library().lib
    with torch.cuda.device(lhs.device):
        err = lib.wm_gmm(build.DTYPE_CODES[lhs.dtype], lhs.data_ptr(),
                         rhs.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                         s, k, n, e, int(trans_rhs),
                         build.cuda_stream(lhs.device))
    build.check(err)
    gmm.launches += 1
    return out


gmm.launches = 0


def _check_tgmm(lhs, dy, group_sizes):
    _check_groups(lhs, group_sizes, group_sizes.shape[0])
    if dy.dim() != 2 or dy.shape[0] != lhs.shape[0]:
        raise ValueError(f"dy must be [{lhs.shape[0]}, N], got "
                         f"{tuple(dy.shape)}")


def tgmm_reference(lhs, dy, group_sizes):
    """Plain PyTorch version of kernel B4t: the fp32 lhs_g^T . dy_g of each
    group slice, rounded to lhs.dtype ([E, K, N])."""
    _check_tgmm(lhs, dy, group_sizes)
    return torch.stack([lhs[a:b].float().T @ dy[a:b].float()
                        for _, a, b in _slices(group_sizes)]).to(lhs.dtype)


def tgmm(lhs, dy, group_sizes):
    """Kernel B4t: lhs [S, K], dy [S, N] (rows sorted by group),
    group_sizes [E] integer -> [E, K, N] in lhs.dtype; empty groups are
    zeros.

    CUDA tensors launch the kernel (counted in `tgmm.launches`) or raise;
    CPU tensors take the plain version."""
    _check_tgmm(lhs, dy, group_sizes)
    if not _on_cuda("tgmm", group_sizes, lhs, dy):
        return tgmm_reference(lhs, dy, group_sizes)
    s, k = lhs.shape
    n = dy.shape[1]
    e = group_sizes.shape[0]
    offsets = group_offsets(group_sizes)
    out = lhs.new_empty(e, k, n)
    lib = build.load_library().lib
    with torch.cuda.device(lhs.device):
        err = lib.wm_tgmm(build.DTYPE_CODES[lhs.dtype], lhs.data_ptr(),
                          dy.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                          s, k, n, e, build.cuda_stream(lhs.device))
    build.check(err)
    tgmm.launches += 1
    return out


tgmm.launches = 0


class GroupedMatmul(torch.autograd.Function):
    """y = gmm(lhs, rhs, group_sizes): forward kernel B4; backward d_lhs =
    B4 on dy against rhs^T and d_rhs = B4t (lhs, dy), cast to rhs's dtype.
    Saves lhs, rhs and the group sizes."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm(lhs, rhs, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        d_lhs = d_rhs = None
        if ctx.needs_input_grad[0]:
            d_lhs = gmm(dy, rhs, group_sizes, trans_rhs=True)
        if ctx.needs_input_grad[1]:
            d_rhs = tgmm(lhs, dy, group_sizes).to(rhs.dtype)
        return d_lhs, d_rhs, None
