// Weight gradient of the grouped matmul for Hopper (sm_90a): kernel B4t.
//
// Replaces the TPU kernel `_tgmm_kernel` in weathermodel_tpu/ops/pallas_gmm.py (reached
// through `_tgmm_pallas`, the d_rhs of `gmm`'s custom VJP). For lhs [S, K] and dy [S, N]
// whose rows are sorted by group, and the E+1 group offsets (the exclusive cumsum of the
// group sizes, on the device):
//   out[g] = sum over offsets[g] <= s < offsets[g + 1] of lhs[s]^T . dy[s]    [E, K, N]
// with fp32 accumulation and one rounding to the element type; a group with no rows
// gets zeros, as the TPU path's final `where(group_sizes > 0, out, 0)` gives them.
//
// Two bodies, chosen by an explicit dispatch on the shape in `launch`:
//   * bf16 with K and N multiples of 8, 16-byte aligned operands and at least one row (the
//     MoE layer's every call): the wgmma/TMA body of gmm_hopper.cuh
//     (expert_wgrad_wgmma_kernel), a block per (192 columns of N, 128 rows of K, group).
//   * every other call (fp32, and bf16 of other shapes or alignments): the tiles below
//     (gmm_common.cuh), one thread block per (group, 128-row tile of K, 128-column tile of
//     N), so the grid is sized from E, K and N alone. A block walks its group's rows in
//     slabs of 32: lhs's slab is staged as [s][k] and read by the tensor cores as the
//     column-major lhs^T, dy's as [s][n]; rows of other groups are staged as zeros (both
//     operands, so that nothing of a neighbouring group reaches the sum).
// The window form B4ts (`tgmm_sharded`, replacing `_tgmm_pallas(..., group_offset=,
// e_local=)` of the expert-parallel shard's backward, pallas_gmm.py:262): offsets are the
// e_loc + 1 entries [off, off + e_loc] of the global ones and out is [e_loc, K, N]. A block
// reads its group's rows from offsets[g] and offsets[g + 1] alone, so nothing changes:
// the grid (sized from e_loc, K and N) covers the local groups only, rows of other groups
// are never read, and an empty local group's blocks run no slab and store zeros.
// In both the block owns its output tile alone, so there are no atomics and the result
// does not depend on scheduling: the sum over a group's rows runs in one fixed order. The
// TPU kernel's virtual-tile table and flush-on-last-visit writes, needed because its grid
// runs in order over all rows, have no counterpart.
//
// What bounds it on the card: the same 186 GFLOP per call as B4 at the MoE layer's
// shapes, tensor-core bound (0.19 ms in bf16). The block's work is its group's row
// count, so blocks of large groups run longer than others: with uneven routing the last
// wave is ragged.

#include <type_traits>

#include "gmm_common.cuh"
#include "gmm_hopper.cuh"

namespace {

using namespace gmm_tiles;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
tgmm_kernel(const T* __restrict__ lhs, const T* __restrict__ dy,
            const int* __restrict__ offsets, T* __restrict__ out, int k, int n, bool vec_lhs,
            bool vec_dy) {
  constexpr int kLd = kLdTile<T>;  // both slabs [kDepth][kTile]
  __shared__ __align__(32) T a_s[kDepth * kLd];
  __shared__ __align__(32) T b_s[kDepth * kLd];
  __shared__ __align__(32) float scratch[kWarps * 256];

  const int g = blockIdx.z;
  const int k0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const long long lo = offsets[g], hi = offsets[g + 1];

  Acc<T> acc;
  acc.zero();
  for (long long s0 = lo; s0 < hi; s0 += kDepth) {
    stage<T, kDepth, kTile>(a_s, kLd, lhs, k, s0, lo, hi, k0, k, vec_lhs);
    stage<T, kDepth, kTile>(b_s, kLd, dy, n, s0, lo, hi, n0, n, vec_dy);
    __syncthreads();
    // A = lhs^T [k][s], stored [s][k]: column-major; B = dy [s][n]: row-major
    mma_slab<T, false, true>(acc, a_s, kLd, b_s, kLd);
    __syncthreads();
  }
  store_tile<T>(acc, out + ((long long)g * k + k0) * n + n0, n,
                k - k0 < kTile ? k - k0 : kTile, n - n0 < kTile ? n - n0 : kTile, scratch);
}

template <typename T>
cudaError_t launch(const void* lhs, const void* dy, const int* offsets, void* out, int s,
                   int k, int n, int e, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (gmm_hopper::takes(s, k, n, lhs, dy, out))
      return gmm_hopper::launch_tgmm(lhs, dy, offsets, out, s, k, n, e, stream);
  }
  const dim3 grid((n + kTile - 1) / kTile, (k + kTile - 1) / kTile, e);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidConfiguration;
  tgmm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(lhs), static_cast<const T*>(dy), offsets, static_cast<T*>(out), k,
      n, vec_ok<T>(lhs, k), vec_ok<T>(dy, n));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lhs [s, k] and dy [s, n] with rows sorted by group;
// offsets [e + 1] int32, nondecreasing, the exclusive cumsum of the group sizes (at most
// s), or a window of e + 1 consecutive entries of it (B4ts), whose first may be above 0;
// out [e, k, n]. All contiguous on the current device. Returns a cudaError_t (0 on
// success).
int wm_tgmm(int dtype, const void* lhs, const void* dy, const void* offsets, void* out, int s,
            int k, int n, int e, void* stream) {
  if (s < 0 || k <= 0 || n <= 0 || e <= 0) return cudaErrorInvalidValue;
  auto* offs = static_cast<const int*>(offsets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(lhs, dy, offs, out, s, k, n, e, st);
  if (dtype == 1) return launch<__nv_bfloat16>(lhs, dy, offs, out, s, k, n, e, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
