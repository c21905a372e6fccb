// Backward of the fused FFN + residual + LayerNorm for Hopper (sm_90a): kernel B6b.
//
// Replaces the TPU kernel `_ffn_bwd_kernel` in weathermodel_tpu/ops/pallas_ffn.py (reached
// through `_ffn_bwd_rule`, the custom VJP of `fused_ffn_ln`). From x [M, H], the weights, the
// LN parameters, the cotangent do [M, H] and the forward's dropout seeds it computes, as the
// TPU kernel does (recomputing the hidden and both masks, fp32 accumulation):
//   dx [M, H] in x's dtype, dW1 [H, F] and dW2 [F, H] in the weights' dtype (x's), and
//   db1, db2, dln_scale, dln_bias in fp32.
//
// The TPU kernel walks the batch items in order and accumulates the parameter gradients in
// constant-index output blocks. Blocks on the card run in parallel, so the work is split
// into passes on one stream (one launch of the wrapper):
//   1. the row work, one block per row block: recompute h and f, write the hidden hd
//      [M, F], run the LayerNorm backward on whole rows (dy, df = dropout2(dy) rounded, and
//      per-block column sums of do * xhat and do), then dz = mask1 . (df . W2^T), rounded
//      (mask1 = kept and relu' > 0, scaled by 1/(1-p) where dropout is on), and
//      dx = dz . W1^T + dy, rounded.
//      bfloat16: ffn_hopper_bwd.cuh's wgmma/TMA body does all of it in one kernel (dy stays
//      in its accumulators: the dx product starts from it), 64-row blocks.
//      float32: ffn_common.cuh's row kernel in its backward mode (32-row blocks, dy to
//      device memory), then products 3. dz and 4. dx on gmm_common.cuh's tiles (FMA), which
//      read W1 and W2 in place, transposed by the staging; dz's mask is hd != 0;
//   2. sum the per-block column sums in order: dln_scale, dln_bias;
//   5. dW2 = hd^T . df and db2 = sum over rows of df, 6. dW1 = x^T . dz and db1 = sum of dz:
//      one block per (output tile, slice of the rows), fp32 partials, then a pass that sums
//      the slices in order and rounds. The bias gradient is the product's extra row against
//      a column of ones beside the activations, so it comes out of the same tensor-core
//      sums.
//      bfloat16: the grouped matmul's wgmma/TMA body (gmm_hopper.cuh, B4t's product with
//      kPartials: 128 x 192 tiles fed by a 4-stage TMA ring, the slices as its groups, the
//      ones written into the landed stage); every bf16 call meets its layout rule (the
//      wrapper's check_wgmma_layout, and hd, df, dz fresh allocations).
//      float32: gmm_common.cuh's 128 x 128 FMA tiles, the ones staged beside the slab.
// Nothing uses atomics: every sum runs in a fixed order, so the result does not depend on
// scheduling. db1 and db2 sum dz and df after their rounding to x's dtype (the TPU sums
// them before it); in fp32 the two are the same.
//
// What bounds it on the card: 12 M H F operations (1674 GFLOP at the bench microbatch,
// M = 105,120, H = 576, F = 2304: 1.69 ms at the bf16 peak) against 485 MB of x, do and dx
// in bf16: operations. The passes also move hd, dz (484 MB each in bf16) and df through
// device memory (and in fp32 dy), about 0.6 ms at the memory rate at those shapes. Passes 5
// and 6 are a third of the operations (558 GFLOP, 0.564 ms at the peak); their partial sums
// add splits x (K + 1) x N x 4 bytes each way (the wrapper's _wgrad_splits weighs them
// against the waves of blocks).

#include "ffn_common.cuh"
#include "ffn_hopper_bwd.cuh"
#include "gmm_hopper.cuh"

namespace {

using namespace gmm_tiles;
using wm::from_float;
using wm::to_float;

// dz = (hd != 0 ? v * scale : 0), rounded
template <typename T>
struct DzEpilogue {
  const T* hd;
  T* dz;
  int n;
  float scale;
  __device__ void operator()(long long row, int col, float v) const {
    const long long i = row * n + col;
    dz[i] = from_float<T>(to_float(hd[i]) != 0.f ? v * scale : 0.f);
  }
};

// dx = v + dy, rounded
template <typename T>
struct DxEpilogue {
  const float* dy;
  T* dx;
  int n;
  __device__ void operator()(long long row, int col, float v) const {
    const long long i = row * n + col;
    dx[i] = from_float<T>(v + dy[i]);
  }
};

// out[m, n] = epi(a[m, :] . b[n, :]): A [M, K] row-major, B stored [N, K] (a weight matrix
// read transposed in place). One block per 128 x 128 output tile.
template <typename T, class Epi>
__global__ void __launch_bounds__(kThreads, 2)
gemm_nt_kernel(const T* __restrict__ a, const T* __restrict__ b, int m, int k, int n,
               bool vec_a, bool vec_b, Epi epi) {
  __shared__ __align__(32) T a_s[kTile * kLdDepth<T>];
  __shared__ __align__(32) T b_s[kTile * kLdDepth<T>];
  __shared__ __align__(32) float scratch[kWarps * 256];
  const long long r0 = (long long)blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  Acc<T> acc;
  acc.zero();
  for (int k0 = 0; k0 < k; k0 += kDepth) {
    stage<T, kTile, kDepth>(a_s, kLdDepth<T>, a, k, r0, 0, m, k0, k, vec_a);
    stage<T, kTile, kDepth>(b_s, kLdDepth<T>, b, k, n0, 0, n, k0, k, vec_b);
    __syncthreads();
    mma_slab<T, true, false>(acc, a_s, kLdDepth<T>, b_s, kLdDepth<T>);
    __syncthreads();
  }
  const int rows = m - r0 < kTile ? (int)(m - r0) : kTile;
  const int cols = n - n0 < kTile ? n - n0 : kTile;
  tile_epilogue<T>(acc, rows, cols, scratch,
                   [&](int i, int j, float v) { epi(r0 + i, n0 + j, v); });
}

template <typename T, class Epi>
cudaError_t gemm_nt(const T* a, const T* b, int m, int k, int n, Epi epi, cudaStream_t st) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  if (grid.y > 65535u) return cudaErrorInvalidConfiguration;
  gemm_nt_kernel<T, Epi><<<grid, kThreads, 0, st>>>(a, b, m, k, n, vec_ok<T>(a, k),
                                                    vec_ok<T>(b, k), epi);
  return cudaGetLastError();
}

// part[split, 0:k+1, :] = [a | 1]^T . b over the split's rows: a [M, K], b [M, N]; row k of
// the product is the column sum of b (a's extra column of ones). One block per (128 x 128
// tile of the [K + 1, N] product, slice of rows).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wgrad_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ part, int m,
             int k, int n, int rows_per_split, bool vec_a, bool vec_b) {
  constexpr int kLd = kLdTile<T>;  // both slabs [kDepth][kTile]
  __shared__ __align__(32) T a_s[kDepth * kLd];
  __shared__ __align__(32) T b_s[kDepth * kLd];
  __shared__ __align__(32) float scratch[kWarps * 256];
  const int n0 = blockIdx.x * kTile;
  const int k0 = blockIdx.y * kTile;
  const long long lo = (long long)blockIdx.z * rows_per_split;
  const long long hi = lo + rows_per_split < m ? lo + rows_per_split : m;
  const int ones = k - k0;  // the ones column's place in this tile, if 0 <= ones < kTile
  const bool has_ones = ones < kTile;  // uniform across the block
  Acc<T> acc;
  acc.zero();
  for (long long s0 = lo; s0 < hi; s0 += kDepth) {
    stage<T, kDepth, kTile>(a_s, kLd, a, k, s0, lo, hi, k0, k, vec_a);
    stage<T, kDepth, kTile>(b_s, kLd, b, n, s0, lo, hi, n0, n, vec_b);
    __syncthreads();
    if (has_ones) {
      if (threadIdx.x < kDepth && s0 + threadIdx.x < hi)
        a_s[threadIdx.x * kLd + ones] = from_float<T>(1.f);
      __syncthreads();
    }
    // A = [a | 1]^T [k][s], stored [s][k]: column-major; B = b [s][n]: row-major
    mma_slab<T, false, true>(acc, a_s, kLd, b_s, kLd);
    __syncthreads();
  }
  float* out = part + ((long long)blockIdx.z * (k + 1) + k0) * n + n0;
  const int rows = k + 1 - k0 < kTile ? k + 1 - k0 : kTile;
  const int cols = n - n0 < kTile ? n - n0 : kTile;
  tile_epilogue<T>(acc, rows, cols, scratch,
                   [&](int i, int j, float v) { out[(long long)i * n + j] = v; });
}

// Sum the splits' partials [splits, k + 1, n] in order: rows < k round into dw [k, n], row k
// is db [n] (fp32).
template <typename T>
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, T* __restrict__ dw,
                                    float* __restrict__ db, int k, int n, int splits) {
  const long long total = (long long)(k + 1) * n;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[sp * total + i];
  if (i < (long long)k * n)
    dw[i] = from_float<T>(s);
  else
    db[i - (long long)k * n] = s;
}

// dln_scale, dln_bias: the row work's per-block column sums [blocks, 2, h], summed in order.
__global__ void ln_reduce_kernel(const float* __restrict__ part, float* __restrict__ dls,
                                 float* __restrict__ dlb, int h, int blocks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * h) return;
  const int plane = i / h, col = i % h;
  float s = 0.f;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) s += part[((long long)b * 2 + plane) * h + col];
  (plane == 0 ? dls : dlb)[col] = s;
}

template <typename T>
cudaError_t wgrad_reduce(const float* part, T* dw, float* db, int k, int n, int splits,
                         cudaStream_t st) {
  const long long total = (long long)(k + 1) * n;
  wgrad_reduce_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, dw, db, k, n,
                                                                          splits);
  return cudaGetLastError();
}

// the fp32 partials on gmm_common.cuh's tiles, then the ordered sum
cudaError_t wgrad(const float* a, const float* b, float* part, float* dw, float* db, int m,
                  int k, int n, int splits, cudaStream_t st) {
  const int rows_per_split = ((m + splits - 1) / splits + kDepth - 1) / kDepth * kDepth;
  const dim3 grid((n + kTile - 1) / kTile, (k + 1 + kTile - 1) / kTile, splits);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidConfiguration;
  wgrad_kernel<float><<<grid, kThreads, 0, st>>>(a, b, part, m, k, n, rows_per_split,
                                                 vec_ok<float>(a, k), vec_ok<float>(b, n));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return wgrad_reduce<float>(part, dw, db, k, n, splits, st);
}

// the bf16 partials on gmm_hopper.cuh's body (slices of 64-row multiples), then the ordered
// sum, rounded once
cudaError_t wgrad(const __nv_bfloat16* a, const __nv_bfloat16* b, float* part,
                  __nv_bfloat16* dw, float* db, int m, int k, int n, int splits,
                  cudaStream_t st) {
  if (!gmm_hopper::takes(m, k, n, a, b, part)) return cudaErrorInvalidValue;
  const int slice = ((m + splits - 1) / splits + 63) / 64 * 64;
  const cudaError_t err =
      gmm_hopper::launch_wgrad_partials(a, b, part, m, k, n, splits, slice, st);
  if (err != cudaSuccess) return err;
  return wgrad_reduce<__nv_bfloat16>(part, dw, db, k, n, splits, st);
}

struct BwdArgs {
  const void *x, *w1, *b1, *w2, *b2, *ls, *dout;
  void *dx, *dw1, *db1, *dw2, *db2, *dls, *dlb;
  void *hd, *df, *dy, *dz, *ln_part, *w_part;
  int m, h, f, on;
  unsigned seed1, seed2, threshold;
  float inv_keep;
  int splits1, splits2;
};

// Passes 5 and 6: the weight and bias gradients from hd, df and dz.
template <typename T>
cudaError_t weight_grads(const BwdArgs& p, cudaStream_t st) {
  float* part = static_cast<float*>(p.w_part);
  cudaError_t err = wgrad(static_cast<const T*>(p.hd), static_cast<const T*>(p.df), part,
                          static_cast<T*>(p.dw2), static_cast<float*>(p.db2), p.m, p.f, p.h,
                          p.splits2, st);
  if (err != cudaSuccess) return err;
  return wgrad(static_cast<const T*>(p.x), static_cast<const T*>(p.dz), part,
               static_cast<T*>(p.dw1), static_cast<float*>(p.db1), p.m, p.h, p.f, p.splits1,
               st);
}

cudaError_t ln_reduce(const BwdArgs& p, int blocks, cudaStream_t st) {
  ln_reduce_kernel<<<(2 * p.h + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(p.ln_part), static_cast<float*>(p.dls),
      static_cast<float*>(p.dlb), p.h, blocks);
  return cudaGetLastError();
}

// bfloat16: the row work on ffn_hopper_bwd.cuh's body, then pass 2, and passes 5 and 6 on
// gmm_hopper.cuh's body
cudaError_t backward_bf16(const BwdArgs& p, cudaStream_t st) {
  cudaError_t err = ffn_hopper::launch_bwd(
      p.x, p.w1, static_cast<const float*>(p.b1), p.w2, static_cast<const float*>(p.b2),
      static_cast<const float*>(p.ls), p.dout, p.hd, p.dz, p.df, p.dx,
      static_cast<float*>(p.ln_part), p.m, p.h, p.f, p.on, p.seed1, p.seed2, p.threshold,
      p.inv_keep, st);
  if (err != cudaSuccess) return err;
  err = ln_reduce(p, (p.m + ffn_hopper::kRows - 1) / ffn_hopper::kRows, st);
  if (err != cudaSuccess) return err;
  return weight_grads<__nv_bfloat16>(p, st);
}

// float32: the row kernel's pass 1, then passes 2 to 6
cudaError_t backward_fp32(const BwdArgs& p, cudaStream_t st) {
  using T = float;
  ffn::RowsArgs a = {};
  a.x = p.x;
  a.w1 = p.w1;
  a.b1 = static_cast<const float*>(p.b1);
  a.w2 = p.w2;
  a.b2 = static_cast<const float*>(p.b2);
  a.ls = static_cast<const float*>(p.ls);
  a.dout = p.dout;
  a.hidden = p.hd;
  a.df = p.df;
  a.dy = static_cast<float*>(p.dy);
  a.ln_part = static_cast<float*>(p.ln_part);
  a.m = p.m;
  a.h = p.h;
  a.f = p.f;
  a.on = p.on;
  a.seed1 = p.seed1;
  a.seed2 = p.seed2;
  a.threshold = p.threshold;
  a.scale = p.inv_keep;
  cudaError_t err = ffn::launch_rows_fp32<ffn::kModeBwd>(a, st);
  if (err != cudaSuccess) return err;
  err = ln_reduce(p, (p.m + ffn::kRows - 1) / ffn::kRows, st);
  if (err != cudaSuccess) return err;

  const T* w1 = static_cast<const T*>(p.w1);
  const T* w2 = static_cast<const T*>(p.w2);
  const T* hd = static_cast<const T*>(p.hd);
  const T* df = static_cast<const T*>(p.df);
  T* dz = static_cast<T*>(p.dz);
  // 3. dz = mask1 (df . W2^T): W2 [F, H] is the [N, K] operand
  err = gemm_nt<T>(df, w2, p.m, p.h, p.f,
                   DzEpilogue<T>{hd, dz, p.f, p.on ? p.inv_keep : 1.f}, st);
  if (err != cudaSuccess) return err;
  // 4. dx = dz . W1^T + dy: W1 [H, F] is the [N, K] operand
  err = gemm_nt<T>(dz, w1, p.m, p.f, p.h,
                   DxEpilogue<T>{static_cast<const float*>(p.dy), static_cast<T*>(p.dx), p.h},
                   st);
  if (err != cudaSuccess) return err;
  return weight_grads<T>(p, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w1, w2, dout, dx, dw1, dw2 and the scratch hd, df,
// dz); b1, b2, ln_scale and the gradients db1, db2, dln_scale, dln_bias float32. x, dout, dx
// [m, h]; w1, dw1 [h, f]; w2, dw2 [f, h]. Scratch: hd, dz [m, f]; df [m, h]; dy [m, h]
// fp32 (float32 only: bfloat16 keeps dy on chip, and takes null); ln_part [ceil(m / 32), 2,
// h] fp32; w_part [max(splits1 (h + 1) f, splits2 (f + 1) h)] fp32, splits1/splits2 the row
// slices of the dW1/dW2 products (in bfloat16 each slice a multiple of 64 rows: splits
// beyond ceil(m / 64) add empty slices). Contiguous, on the current device; in bfloat16 16-byte
// aligned with h and f multiples of 8 and wm_ffn_bwd_wgmma_smem(h, f) > 0. Dropout as
// wm_fused_ffn_ln's, kept values times inv_keep. Returns a cudaError_t (0 on success).
int wm_fused_ffn_ln_bwd(int dtype, const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, const void* ln_scale, const void* dout,
                        void* dx, void* dw1, void* db1, void* dw2, void* db2, void* dln_scale,
                        void* dln_bias, void* hd, void* df, void* dy, void* dz, void* ln_part,
                        void* w_part, int m, int h, int f, int dropout_on, unsigned seed1,
                        unsigned seed2, unsigned threshold, float inv_keep, int splits1,
                        int splits2, void* stream) {
  if (m <= 0 || h <= 0 || f <= 0 || h > ffn::kMaxH || splits1 <= 0 || splits2 <= 0)
    return cudaErrorInvalidValue;
  const BwdArgs p = {x,  w1, b1, w2, b2, ln_scale, dout, dx, dw1, db1, dw2, db2, dln_scale,
                     dln_bias, hd, df, dy, dz, ln_part, w_part, m, h, f, dropout_on, seed1,
                     seed2, threshold, inv_keep, splits1, splits2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return backward_fp32(p, st);
  if (dtype == 1) return backward_bf16(p, st);
  return cudaErrorInvalidValue;
}

// The dynamic shared memory a block of the bfloat16 row body takes at (h, f), or 0 where it
// does not take them.
int wm_ffn_bwd_wgmma_smem(int h, int f) { return ffn_hopper::bwd_smem_bytes(h, f); }

}  // extern "C"
