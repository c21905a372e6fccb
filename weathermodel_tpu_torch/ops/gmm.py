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
* `torch.ops.wm.gmm` (`gmm_op`) - B4's forward as a `torch.library` op, the
  form the MoE layer calls with gradients off (serving, validation): the
  CUDA implementation is `gmm` (the launch, counted in `gmm.launches`), the
  CPU one `gmm_reference`, and the fake one an empty [S, N] in lhs.dtype
  (S is static; only the group sizes are data). `torch.export` records
  the op as one node and traces neither the ctypes launch nor the plain
  version's host reads of the sizes, so an exported MoE program
  (export_artifact.py) launches B4 on the card. A program that holds the
  op needs this module imported before it loads.

Both kernels accumulate in fp32 and round once to the inputs' dtype. Each
wrapper launches its hand-written Hopper kernel on CUDA tensors (counting
the launch in its `launches` attribute) or raises, and runs its plain
PyTorch version (`*_reference`, one fp32 matmul per group) on CPU tensors;
the plain version is also what the kernel is checked against on the card.
The group sizes stay on the device: the wrappers hand the kernels their
exclusive cumsum, computed there, and size the grid from S, E, K and N
alone, so nothing waits on the host. The plain versions read the sizes on
the host.

The expert-parallel forms (pallas_gmm.py:344-409), for a rank that holds
the e_loc experts [off, off + e_loc) of E, are the same kernels over a
window of the groups:
* `gmm_sharded` - kernel B4s: rhs_local [e_loc, K, N] (or [e_loc, N, K]
  with `trans_rhs`), group_sizes [E] of all the rows and the host int
  `group_offset` = off -> [S, N]; a row of a group in the window multiplies
  rhs_local[g - off], every other row (below the window, past it, past the
  sum of the sizes) comes out as zeros, so the sum of the ranks' outputs is
  `gmm`'s.
* `tgmm_sharded` - kernel B4ts: [e_loc, K, N], the window's groups only; an
  empty local group gets zeros.
* `GroupedMatmul.apply(lhs, rhs_local, group_sizes, off)` - their custom VJP
  (pallas_gmm.py:389-409): d_lhs = gmm_sharded(dy, rhs^T), zero on the rows
  of other ranks' groups, and d_rhs = tgmm_sharded(lhs, dy).
The full forms are the window at off = 0 with e_loc = E: one implementation
(`_gmm`, `_tgmm`, and the plain versions' `group_offset`) serves both, and
only the launch counter differs (`gmm`/`tgmm` count B4/B4t, `gmm_sharded`/
`tgmm_sharded` B4s/B4ts). The kernels are handed the window [off, off +
e_loc] of the E + 1 device offsets, a slice of the device tensor: they read
the window's extent from the device and size their grids from S, e_loc, K
and N alone, so the host int off is all the host knows.
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


def _window(group_sizes, group_offset, e_local: int) -> int:
    """The window's first group: `group_offset`, or 0 for the full form
    (None), whose e_local is all E groups."""
    e = group_sizes.shape[0]
    if group_offset is None:
        return 0
    if not (isinstance(group_offset, int) and e_local > 0
            and 0 <= group_offset <= e - e_local):
        raise ValueError(f"the window [{group_offset}, {group_offset} + "
                         f"{e_local}) is not inside the {e} groups")
    return group_offset


def _check_gmm(lhs, rhs, group_sizes, trans_rhs, group_offset) -> int:
    if rhs.dim() != 3:
        raise ValueError(f"rhs must be [E, K, N], got {tuple(rhs.shape)}")
    _check_groups(lhs, group_sizes, rhs.shape[0] if group_offset is None
                  else group_sizes.shape[0])
    k = rhs.shape[2] if trans_rhs else rhs.shape[1]
    if lhs.shape[1] != k:
        raise ValueError(f"lhs {tuple(lhs.shape)} and rhs {tuple(rhs.shape)} "
                         f"(trans_rhs={trans_rhs}) do not share K")
    return _window(group_sizes, group_offset, rhs.shape[0])


def _check_tgmm(lhs, dy, group_sizes, group_offset, e_local) -> int:
    _check_groups(lhs, group_sizes, group_sizes.shape[0])
    if dy.dim() != 2 or dy.shape[0] != lhs.shape[0]:
        raise ValueError(f"dy must be [{lhs.shape[0]}, N], got "
                         f"{tuple(dy.shape)}")
    return _window(group_sizes, group_offset, e_local)


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


def _slices(group_sizes, off: int, e_local: int):
    """(local group, first row, end row) of each group of the window [off,
    off + e_local), read on the host."""
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        if off <= g < off + e_local:
            yield g - off, start, start + size
        start += size


def gmm_reference(lhs, rhs, group_sizes, trans_rhs: bool = False,
                  group_offset=None):
    """Plain PyTorch version of kernels B4 and B4s (`_gmm_offset_ref`,
    pallas_gmm.py:351-362): one fp32 matmul per group of the window [off,
    off + rhs.shape[0]) (every group without `group_offset`), zeros on every
    other row, rounded to lhs.dtype. Differentiable."""
    off = _check_gmm(lhs, rhs, group_sizes, trans_rhs, group_offset)
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    slices = list(_slices(group_sizes, off, rhs.shape[0]))
    parts = [lhs.new_zeros(slices[0][1], n, dtype=torch.float32)]
    for g, a, b in slices:
        w = rhs[g].float()
        parts.append(lhs[a:b].float() @ (w.T if trans_rhs else w))
    parts.append(lhs.new_zeros(lhs.shape[0] - slices[-1][2], n,
                               dtype=torch.float32))
    return torch.cat(parts).to(lhs.dtype)


def _gmm(counter, lhs, rhs, group_sizes, group_offset, trans_rhs):
    """B4 over the window of `group_offset` (None: every group), counted
    in `counter.launches`."""
    off = _check_gmm(lhs, rhs, group_sizes, trans_rhs, group_offset)
    if not _on_cuda(counter.__name__, group_sizes, lhs, rhs):
        return gmm_reference(lhs, rhs, group_sizes, trans_rhs, group_offset)
    s, k = lhs.shape
    e_loc = rhs.shape[0]
    n = rhs.shape[1] if trans_rhs else rhs.shape[2]
    offsets = group_offsets(group_sizes)[off:off + e_loc + 1]
    out = lhs.new_empty(s, n)
    lib = build.load_library().lib
    with torch.cuda.device(lhs.device):
        err = lib.wm_gmm(build.DTYPE_CODES[lhs.dtype], lhs.data_ptr(),
                         rhs.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                         s, k, n, e_loc, int(trans_rhs),
                         build.cuda_stream(lhs.device))
    build.check(err)
    counter.launches += 1
    return out


def gmm(lhs, rhs, group_sizes, trans_rhs: bool = False):
    """Kernel B4: lhs [S, K] (rows sorted by group), rhs [E, K, N] (or
    [E, N, K] with `trans_rhs`), group_sizes [E] integer -> [S, N] in
    lhs.dtype.

    CUDA tensors launch the kernel (counted in `gmm.launches`) or raise; CPU
    tensors take the plain version."""
    return _gmm(gmm, lhs, rhs, group_sizes, None, trans_rhs)


def gmm_sharded(lhs, rhs, group_sizes, group_offset: int,
                trans_rhs: bool = False):
    """Kernel B4s: lhs [S, K] (rows sorted by group), rhs [e_loc, K, N] (or
    [e_loc, N, K] with `trans_rhs`), the E group sizes of all the rows and
    the host int `group_offset` -> [S, N] in lhs.dtype: the rows of groups
    [off, off + e_loc) times rhs[g - off], every other row zeros.

    CUDA tensors launch the kernel (counted in `gmm_sharded.launches`) or
    raise; CPU tensors take the plain version."""
    return _gmm(gmm_sharded, lhs, rhs, group_sizes, group_offset, trans_rhs)


gmm.launches = gmm_sharded.launches = 0


@torch.library.custom_op("wm::gmm", mutates_args=(), device_types="cpu")
def gmm_op(lhs: torch.Tensor, rhs: torch.Tensor,
           group_sizes: torch.Tensor) -> torch.Tensor:
    """Kernel B4's forward as an op: the plain version on the CPU, `gmm`
    (the launch) on the card."""
    return gmm_reference(lhs, rhs, group_sizes)


@gmm_op.register_kernel("cuda")
def _gmm_op_cuda(lhs, rhs, group_sizes):
    return gmm(lhs, rhs, group_sizes)


@gmm_op.register_fake
def _gmm_op_fake(lhs, rhs, group_sizes):
    return lhs.new_empty(lhs.shape[0], rhs.shape[2])


def tgmm_reference(lhs, dy, group_sizes, group_offset=None, e_local=None):
    """Plain PyTorch version of kernels B4t and B4ts (`_tgmm_offset_ref`,
    pallas_gmm.py:365-371): the fp32 lhs_g^T . dy_g of each group of the
    window [off, off + e_local) (every group without `group_offset`),
    rounded to lhs.dtype ([e_local, K, N]; zeros for an empty group)."""
    e_local = group_sizes.shape[0] if group_offset is None else e_local
    off = _check_tgmm(lhs, dy, group_sizes, group_offset, e_local)
    return torch.stack([lhs[a:b].float().T @ dy[a:b].float()
                        for _, a, b in _slices(group_sizes, off, e_local)
                        ]).to(lhs.dtype)


def _tgmm(counter, lhs, dy, group_sizes, group_offset, e_local):
    """B4t over the window [group_offset, group_offset + e_local) (None:
    every group), counted in `counter.launches`."""
    e_local = group_sizes.shape[0] if group_offset is None else e_local
    off = _check_tgmm(lhs, dy, group_sizes, group_offset, e_local)
    if not _on_cuda(counter.__name__, group_sizes, lhs, dy):
        return tgmm_reference(lhs, dy, group_sizes, group_offset, e_local)
    s, k = lhs.shape
    n = dy.shape[1]
    offsets = group_offsets(group_sizes)[off:off + e_local + 1]
    out = lhs.new_empty(e_local, k, n)
    lib = build.load_library().lib
    with torch.cuda.device(lhs.device):
        err = lib.wm_tgmm(build.DTYPE_CODES[lhs.dtype], lhs.data_ptr(),
                          dy.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                          s, k, n, e_local, build.cuda_stream(lhs.device))
    build.check(err)
    counter.launches += 1
    return out


def tgmm(lhs, dy, group_sizes):
    """Kernel B4t: lhs [S, K], dy [S, N] (rows sorted by group),
    group_sizes [E] integer -> [E, K, N] in lhs.dtype; empty groups are
    zeros.

    CUDA tensors launch the kernel (counted in `tgmm.launches`) or raise;
    CPU tensors take the plain version."""
    return _tgmm(tgmm, lhs, dy, group_sizes, None, None)


def tgmm_sharded(lhs, dy, group_sizes, group_offset: int, e_local: int):
    """Kernel B4ts: lhs [S, K], dy [S, N] (rows sorted by group), the E
    group sizes and the window [off, off + e_local) -> [e_local, K, N] in
    lhs.dtype, the per-group lhs^T . dy of the window's groups; an empty
    group is zeros.

    CUDA tensors launch the kernel (counted in `tgmm_sharded.launches`) or
    raise; CPU tensors take the plain version."""
    return _tgmm(tgmm_sharded, lhs, dy, group_sizes, group_offset, e_local)


tgmm.launches = tgmm_sharded.launches = 0


class GroupedMatmul(torch.autograd.Function):
    """y = gmm(lhs, rhs, group_sizes), or with `group_offset` y =
    gmm_sharded(lhs, rhs_local, group_sizes, group_offset): forward kernel
    B4 (B4s); backward d_lhs = B4 (B4s) on dy against rhs^T and d_rhs = B4t
    (B4ts) (lhs, dy), cast to rhs's dtype (pallas_gmm.py:307-341, 389-409).
    A window's d_lhs is zero on the rows of other ranks' groups: the caller
    sums d_lhs over the ranks. Saves lhs, rhs and the group sizes."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, group_offset=None):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.group_offset = group_offset
        if group_offset is None:
            return gmm(lhs, rhs, group_sizes)
        return gmm_sharded(lhs, rhs, group_sizes, group_offset)

    @staticmethod
    def backward(ctx, dy):
        lhs, rhs, group_sizes = ctx.saved_tensors
        off = ctx.group_offset
        dy = dy.contiguous()
        d_lhs = d_rhs = None
        if ctx.needs_input_grad[0]:
            d_lhs = (gmm(dy, rhs, group_sizes, trans_rhs=True) if off is None
                     else gmm_sharded(dy, rhs, group_sizes, off,
                                      trans_rhs=True))
        if ctx.needs_input_grad[1]:
            d_rhs = (tgmm(lhs, dy, group_sizes) if off is None
                     else tgmm_sharded(lhs, dy, group_sizes, off,
                                       rhs.shape[0])).to(rhs.dtype)
        return d_lhs, d_rhs, None, None
