// Grouped matmul for Hopper (sm_90a): kernel B4, the dropless MoE expert GEMM.
//
// Replaces the TPU kernel `_gmm_kernel` in weathermodel_tpu/ops/pallas_gmm.py (reached
// through `_gmm_pallas`, public entry `gmm` and its custom VJP's d_lhs). For lhs [S, K]
// whose rows are sorted by group, rhs [E, K, N] and the E+1 group offsets (the exclusive
// cumsum of the group sizes, on the device):
//   out[s] = lhs[s] . rhs[g(s)]     offsets[g] <= s < offsets[g + 1]
// with fp32 accumulation and one rounding to the element type. With trans_rhs, rhs is
// [E, N, K] and out[s] = lhs[s] . rhs[g(s)]^T: the backward's d_lhs = gmm(dy, rhs^T)
// reads the forward's weights in place, with no [E, N, K] copy.
//
// Two bodies, chosen by an explicit dispatch on the shape in `launch`:
//   * bf16 with K and N multiples of 8, 16-byte aligned operands and at least one row (the
//     MoE layer's every call): the wgmma/TMA body of gmm_hopper.cuh
//     (expert_gemm_wgmma_kernel), 128 x 192 tiles fed by a 4-stage TMA ring, on a
//     persistent grid of one block an SM.
//   * every other call (fp32, and bf16 of other shapes or alignments): the tiles below
//     (gmm_common.cuh), one thread block per 128-row x 128-column tile of out. The grid is
//     sized from S and N alone. A block reads the offsets, walks the groups that intersect
//     its rows (usually one; at a group boundary two or a few) and, for each, runs the K
//     loop against that group's weights with the rows of other groups staged as zeros. A
//     row thus takes products from its own group only, and all groups of the tile sum into
//     one set of fp32 accumulators that is written once. Rows past the last offset come
//     out as zeros. bf16 runs WMMA (mma.sync) from one shared-memory stage per 32-deep
//     slab; fp32 runs on the FMA pipes.
// The window form B4s (`gmm_sharded`, replacing `_gmm_pallas(..., group_offset=)` of the
// expert-parallel shard, pallas_gmm.py:192): the offsets are the e_loc + 1 entries
// [off, off + e_loc] of the E + 1 global ones, so offsets[0] may be above 0, and rhs holds
// the e_loc local groups. Neither body assumes that group 0 starts at row 0 or that the
// last offset is S: a tile meets only the groups whose rows intersect it, rows of no
// group (below offsets[0], at or past offsets[e]) are staged as zeros in a tile that
// straddles the window's edge, and a tile of no group runs no K loop and is stored as
// zeros. So the K loops run over the window's rows only, about e_loc / E of B4's work, and
// the grid is sized from S and N as for B4.
// The TPU kernel's virtual-tile table, scalar prefetch and flush-on-last-visit writes
// exist because a Pallas grid runs in order; here blocks run in parallel and need none of
// it.
//
// What bounds it on the card: at the MoE layer's shapes (S = 70080, K x N = 576 x 2304
// or 2304 x 576) a call is 186 GFLOP against 425 MB of operands in bf16, so the tensor
// cores' rate bounds it (0.19 ms at 989 TFLOP/s; 2.8 ms at fp32's 67 TFLOP/s).

#include <type_traits>

#include "gmm_common.cuh"
#include "gmm_hopper.cuh"

namespace {

using namespace gmm_tiles;

template <typename T, bool kTrans>
__global__ void __launch_bounds__(kThreads, 2)
gmm_kernel(const T* __restrict__ lhs, const T* __restrict__ rhs,
           const int* __restrict__ offsets, T* __restrict__ out, int s, int k, int n, int e,
           bool vec_lhs, bool vec_rhs) {
  // A slab [kTile][kDepth]; B slab [kTile][kDepth] (kTrans) or [kDepth][kTile]
  constexpr int kLdA = kLdDepth<T>;
  constexpr int kLdB = kTrans ? kLdDepth<T> : kLdTile<T>;
  constexpr int kBSize = kTrans ? kTile * kLdDepth<T> : kDepth * kLdTile<T>;
  __shared__ __align__(32) T a_s[kTile * kLdA];
  __shared__ __align__(32) T b_s[kBSize];
  __shared__ __align__(32) float scratch[kWarps * 256];

  const long long r0 = (long long)blockIdx.y * kTile;
  const long long r1 = r0 + kTile < s ? r0 + kTile : s;
  const int n0 = blockIdx.x * kTile;

  Acc<T> acc;
  acc.zero();
  for (int g = 0; g < e; ++g) {
    const long long lo = max(r0, (long long)offsets[g]);
    const long long hi = min(r1, (long long)offsets[g + 1]);
    if (lo >= hi) continue;  // uniform across the block
    const T* w = rhs + (long long)g * k * n;
    for (int k0 = 0; k0 < k; k0 += kDepth) {
      stage<T, kTile, kDepth>(a_s, kLdA, lhs, k, r0, lo, hi, k0, k, vec_lhs);
      if constexpr (kTrans)  // rhs[g] is [N, K]: rows n0.., columns k0..
        stage<T, kTile, kDepth>(b_s, kLdB, w, k, n0, 0, n, k0, k, vec_rhs);
      else  // rhs[g] is [K, N]: rows k0.., columns n0..
        stage<T, kDepth, kTile>(b_s, kLdB, w, n, k0, 0, k, n0, n, vec_rhs);
      __syncthreads();
      mma_slab<T, true, !kTrans>(acc, a_s, kLdA, b_s, kLdB);
      __syncthreads();
    }
  }
  store_tile<T>(acc, out + r0 * n + n0, n, (int)(r1 - r0), n - n0 < kTile ? n - n0 : kTile,
                scratch);
}

template <typename T>
cudaError_t launch(const void* lhs, const void* rhs, const int* offsets, void* out, int s,
                   int k, int n, int e, bool trans, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (gmm_hopper::takes(s, k, n, lhs, rhs, out))
      return gmm_hopper::launch_gmm(lhs, rhs, offsets, out, s, k, n, e, trans, stream);
  }
  const dim3 grid((n + kTile - 1) / kTile, (s + kTile - 1) / kTile);
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  const bool vec_lhs = vec_ok<T>(lhs, k);
  const bool vec_rhs = vec_ok<T>(rhs, trans ? k : n);
  auto* l = static_cast<const T*>(lhs);
  auto* r = static_cast<const T*>(rhs);
  auto* o = static_cast<T*>(out);
  if (trans)
    gmm_kernel<T, true><<<grid, kThreads, 0, stream>>>(l, r, offsets, o, s, k, n, e, vec_lhs,
                                                      vec_rhs);
  else
    gmm_kernel<T, false><<<grid, kThreads, 0, stream>>>(l, r, offsets, o, s, k, n, e, vec_lhs,
                                                       vec_rhs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. lhs [s, k] with rows sorted by group; rhs [e, k, n]
// (trans_rhs = 0) or [e, n, k] (trans_rhs = 1); offsets [e + 1] int32, nondecreasing, at
// most s: the exclusive cumsum of the group sizes (B4), or a window of e + 1 consecutive
// entries of it (B4s), whose first may be above 0; out [s, n], zeros on the rows outside
// [offsets[0], offsets[e]). All contiguous on the current device. Returns a cudaError_t
// (0 on success).
int wm_gmm(int dtype, const void* lhs, const void* rhs, const void* offsets, void* out, int s,
           int k, int n, int e, int trans_rhs, void* stream) {
  if (s < 0 || k <= 0 || n <= 0 || e <= 0) return cudaErrorInvalidValue;
  if (s == 0) return cudaSuccess;
  auto* offs = static_cast<const int*>(offsets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(lhs, rhs, offs, out, s, k, n, e, trans_rhs != 0, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(lhs, rhs, offs, out, s, k, n, e, trans_rhs != 0, st);
  return cudaErrorInvalidValue;
}

// The bf16 body's (B4 and B4t, gmm_hopper.cuh) dynamic shared memory per block, in bytes.
int wm_gmm_wgmma_smem() { return gmm_hopper::kSmemBytes; }

}  // extern "C"
