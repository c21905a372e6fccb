// Blocked matmul probe for Hopper (sm_90a): kernel P3.
//
// Replaces the TPU kernel `_mm_kernel` via `pallas_mm` in scripts/abl_gemm_probe.py, the
// go/no-go probe of a hand-written GEMM at the WeatherBERT-large FFN shape. For x [m, k],
// w [k, n] and the TPU's VMEM block (bm, bn), it computes
//   y[i, j] = sum_c x[i, c] w[c, j]   (fp32 sum, rounded once to the element type)
// on the covered region i < mc = (m / bm) bm, j < nc = (n / bn) bn, the rows and columns
// the TPU's grid (m / bm, n / bn) reaches; the rest of y is never written. (bm, bn) decide
// only mc and nc: this kernel has its own tile.
//
// Two bodies, chosen by an explicit dispatch on the shape in `launch`, as gmm.cu's:
//   * bf16 with k and n multiples of 8 and 16-byte aligned operands (the probe's every
//     arm): B4's wgmma/TMA body (gmm_hopper.cuh, expert_gemm_wgmma_kernel) with one group,
//     offsets [0, mc] on the device (allocated by ops/blocked_mm.py): x's first mc rows, w as
//     the one expert's [1, k, n] weights, y as an [mc, nc] map whose rows stay n elements
//     apart, so the tiles stop at the covered region and nothing else of y is written. 128 x
//     192 tiles through a 4-stage TMA ring on a persistent grid, m64n192k16.
//   * every other call (fp32, and bf16 of other shapes or alignments): gmm_common.cuh's tiles
//     for a single group: one thread block per 128 x 128 tile of the covered region, the
//     reduction in slabs of 32 staged into shared memory (rows at or past mc and columns at
//     or past nc read as zeros, and the tile's stores stop at mc and nc), bf16 products
//     through WMMA (mma.sync 16 x 16 x 16, fp32 accumulators), fp32 on the FMA pipes, at two
//     blocks per SM, with no overlap of the next slab's loads with the current slab's
//     products.
// Measuring the bf16 body alone at the dense FFN shape is the probe's point: it is the
// yardstick of the hand-written GEMMs in B4, B4t, B5, B6b and B7.
//
// What bounds it on the card: at m = 70144, k = 576, n = 2304 in bf16 a call is 186.2 GFLOP
// against 406.7 MB (x and w read once, y written once), so the tensor cores' rate bounds
// it: 0.188 ms at 989 TFLOP/s (a bm = 1024 arm covers 69632 rows: 0.187 ms).

#include <type_traits>

#include "gmm_common.cuh"
#include "gmm_hopper.cuh"

namespace {

using namespace gmm_tiles;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
blocked_mm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int mc,
                  int k, int n, int nc, bool vec_x, bool vec_w) {
  __shared__ __align__(32) T a_s[kTile * kLdDepth<T>];
  __shared__ __align__(32) T b_s[kDepth * kLdTile<T>];
  __shared__ __align__(32) float scratch[kWarps * 256];

  const long long r0 = (long long)blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  Acc<T> acc;
  acc.zero();
  for (int k0 = 0; k0 < k; k0 += kDepth) {
    // x: rows r0.., columns k0.. (rows at or past mc as zeros); w: rows k0.., columns n0..
    stage<T, kTile, kDepth>(a_s, kLdDepth<T>, x, k, r0, 0, mc, k0, k, vec_x);
    stage<T, kDepth, kTile>(b_s, kLdTile<T>, w, n, k0, 0, k, n0, nc, vec_w);
    __syncthreads();
    mma_slab<T, true, true>(acc, a_s, kLdDepth<T>, b_s, kLdTile<T>);
    __syncthreads();
  }
  store_tile<T>(acc, y + r0 * n + n0, n, mc - r0 < kTile ? (int)(mc - r0) : kTile,
                nc - n0 < kTile ? nc - n0 : kTile, scratch);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* offsets, void* y, int mc, int k,
                   int n, int nc, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (gmm_hopper::takes(mc, k, n, x, w, y)) {
      if (offsets == nullptr) return cudaErrorInvalidValue;
      return gmm_hopper::launch_gmm(x, w, offsets, y, mc, k, nc, 1, false, stream, n);
    }
  }
  const dim3 grid((nc + kTile - 1) / kTile, (mc + kTile - 1) / kTile);
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  blocked_mm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), mc, k, n, nc,
      vec_ok<T>(x, k), vec_ok<T>(w, n));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x [m, k], w [k, n], y [m, n], contiguous on the current
// device; offsets: int32 {0, mc} on the device, which bf16 calls on the wgmma body read
// (null for fp32); writes y's rows < mc and columns < nc (0 < mc <= m, 0 < nc <= n) and
// nothing else. Returns a cudaError_t (0 on success).
int wm_blocked_mm(int dtype, const void* x, const void* w, const void* offsets, void* y,
                  int mc, int k, int n, int nc, void* stream) {
  if (mc <= 0 || k <= 0 || nc <= 0 || nc > n) return cudaErrorInvalidValue;
  auto* offs = static_cast<const int*>(offsets);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, offs, y, mc, k, n, nc, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, offs, y, mc, k, n, nc, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
