// The head-layout probes for Hopper (sm_90a): kernels P1 and P2, attention's two matrix
// products without softmax, per head (P1) and with three heads packed into block-diagonal
// operands (P2).
//
// Replaces the TPU kernels of the head-packing ablation, scripts/abl_headpack.py:
//   P1  `_v0_kernel` via `run_v0`: for each head j of q, k, v [B, T, H] (heads side by
//       side in H, HD = 36 columns each)
//         S_j = q_j . k_j^T   (fp32 sum, rounded to bf16),   O_j = S_j . v_j   (fp32 sum,
//         rounded to bf16), written to o's columns of head j
//   P2  `_v1_kernel` via `run_v1`: for each group g of G = 3 heads (g < NH / G; with NH = 16
//       head 15 is never written, on the TPU too), q3 = the group's 108 columns, Kbd and Vbd
//       [G T, 108] block-diagonal (rows jT .. jT + T - 1 hold k_{3g+j}, v_{3g+j} in columns
//       36j .. 36j + 35, zeros elsewhere);
//         S3 = q3 . Kbd^T  [T, G T] (fp32 sum, rounded),   O3 = S3 . Vbd  [T, 108] (rounded)
//       computed literally, zero blocks included: the ablation asks what the packed layout
//       costs, and a kernel that skipped the zeros would be P1.
// bfloat16 only, as the probes run.
//
// Design, one body for both (kGroup = 1 is P1, kGroup = 3 is P2): a block of 8 warps owns
// 128 query rows of one batch row and one head (P1) or group (P2); each warp owns 16 rows.
// The block stages its q tile once, [128, W] with W the live width (36 or 108) padded with
// zeros to a whole number of 16-deep bf16 fragments (48 or 112), and keeps each warp's q
// fragments in registers. It then streams the key rows in chunks of 64 that lie inside one
// head's block: chunk [64, W] of K (and of V) is staged with the head's 36 columns in place
// and zeros in the rest of W, which is the literal Kbd (Vbd) chunk for P2 and k_j (v_j) with
// its depth padding for P1. Each warp computes its [16, 64] slice of S on the tensor cores
// (WMMA, mma.sync 16 x 16 x 16 bf16 -> fp32), rounds it to bf16 through shared memory and
// multiplies it into its fp32 O accumulator [16, W]. With no softmax, O is a plain sum over
// the chunks: only the fp32 summation order differs from the TPU kernel's. The live columns
// are rounded once and written; padding and other groups' columns are never touched.
// Holding all of Kbd (1152 x 108 bf16, 249 KB) does not fit a block's 227 KB of shared
// memory; a 64-row chunk of K and V is 15 KB (P2) or 7 KB (P1).
//
// What bounds them on the card (3.35 TB/s, 989 TFLOP/s dense bf16), B = 224, T = 384,
// H = 576: P1 reads q, k, v and writes o, 396.4 MB, against 76.1 GFLOP: bound by bytes at
// 0.118 ms. P2's useful work is the 15 heads it writes, 371.6 MB and 71.4 GFLOP: bound by
// bytes at 0.111 ms; the packed products it multiplies come to 214.0 GFLOP, 0.216 ms at the
// tensor-core peak, so on this card the packed layout is bound by its operations, not by
// its bytes. This first version pays for single-stage staging (no overlap of the next
// chunk's loads with the current products), S's round trip through shared memory, the
// depth padding (36 -> 48: P1 multiplies 4/3 of its useful products) and 8-byte loads (a
// head's 72-byte column block is 8-byte aligned, not 16). Later work: keep S in registers
// (mma.sync's accumulator layout is its A layout), cp.async double buffering, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace headpack {

namespace w = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 36;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = 16;                  // query rows a warp owns
constexpr int kTileRows = kWarps * kWarpRows;  // query rows a block owns
constexpr int kChunk = 64;                     // key rows staged a step
constexpr int kLdS = kChunk + 8;               // row stride of a warp's bf16 S slice

template <int kGroup>
struct Layout {
  static constexpr int kLive = kGroup * kHeadDim;         // 36 or 108 columns
  static constexpr int kWidth = (kLive + 15) / 16 * 16;   // 48 or 112: whole fragments
  static constexpr int kFrags = kWidth / 16;
  static constexpr int kLd = kWidth + 8;                  // staged row stride (elements)
  static constexpr int kQ = kTileRows * kLd;              // elements of the q tile
  static constexpr int kKV = kChunk * kLd;                // elements of a K or V chunk
  static constexpr int kS = kWarps * kWarpRows * kLdS;    // elements of the S slices
  // every region starts 32-byte aligned, as WMMA's fragment loads need
  static constexpr size_t kBytes =
      (size_t)(kQ + 2 * kKV + kS) * sizeof(bf16) + kWarps * 256 * sizeof(float);
};

// Stage rows row0 .. row0 + rows - 1 of one batch row (src, [t, h]) into dst ([rows][kLd]):
// dst[r][c] = src[row0 + r][col0 + c] for live_lo <= c < live_hi and row0 + r < t, else 0,
// for c < kWidth. 8-byte loads: a head's columns start at a multiple of 36 elements.
template <int kWidth, int kLd>
__device__ __forceinline__ void stage(bf16* dst, int rows, const bf16* __restrict__ src,
                                      int h, int row0, int t, int col0, int live_lo,
                                      int live_hi) {
  constexpr int kUnits = kWidth / 4;
  for (int u = threadIdx.x; u < rows * kUnits; u += kThreads) {
    const int r = u / kUnits, c = (u % kUnits) * 4;
    uint2 val = make_uint2(0u, 0u);
    if (row0 + r < t && c >= live_lo && c < live_hi)
      val = *reinterpret_cast<const uint2*>(src + (long long)(row0 + r) * h + col0 + c);
    *reinterpret_cast<uint2*>(dst + r * kLd + c) = val;
  }
}

template <int kGroup>
__global__ void __launch_bounds__(kThreads)
headpack_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int t, int h) {
  using L = Layout<kGroup>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + L::kQ;
  bf16* vs = ks + L::kKV;
  bf16* ss = vs + L::kKV;
  float* scratch = reinterpret_cast<float*>(ss + L::kS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kTileRows;
  const int col0 = blockIdx.y * L::kLive;  // the head's (P1) or the group's (P2) columns
  const long long base = (long long)blockIdx.z * t * h;
  bf16* sw = ss + warp * kWarpRows * kLdS;
  float* sc = scratch + warp * 256;

  stage<L::kWidth, L::kLd>(qs, kTileRows, q + base, h, q0, t, col0, 0, L::kLive);
  __syncthreads();
  w::fragment<w::matrix_a, 16, 16, 16, bf16, w::row_major> qf[L::kFrags];
#pragma unroll
  for (int f = 0; f < L::kFrags; ++f)
    w::load_matrix_sync(qf[f], qs + warp * kWarpRows * L::kLd + f * 16, L::kLd);
  w::fragment<w::accumulator, 16, 16, 16, float> acc[L::kFrags];
#pragma unroll
  for (int f = 0; f < L::kFrags; ++f) w::fill_fragment(acc[f], 0.f);

  for (int j = 0; j < kGroup; ++j) {  // the head block of Kbd / Vbd
    for (int t0 = 0; t0 < t; t0 += kChunk) {
      __syncthreads();  // the previous chunk's products are done
      stage<L::kWidth, L::kLd>(ks, kChunk, k + base, h, t0, t, col0, j * kHeadDim,
                               (j + 1) * kHeadDim);
      stage<L::kWidth, L::kLd>(vs, kChunk, v + base, h, t0, t, col0, j * kHeadDim,
                               (j + 1) * kHeadDim);
      __syncthreads();
      // S slice [16, 64] = q rows . chunk^T over the whole width, rounded to bf16
#pragma unroll
      for (int n = 0; n < kChunk / 16; ++n) {
        w::fragment<w::accumulator, 16, 16, 16, float> s;
        w::fill_fragment(s, 0.f);
#pragma unroll
        for (int f = 0; f < L::kFrags; ++f) {
          w::fragment<w::matrix_b, 16, 16, 16, bf16, w::col_major> kf;
          w::load_matrix_sync(kf, ks + n * 16 * L::kLd + f * 16, L::kLd);
          w::mma_sync(s, qf[f], kf, s);
        }
        w::store_matrix_sync(sc, s, 16, w::mem_row_major);
        __syncwarp();
        for (int i = lane; i < 256; i += 32)
          sw[(i / 16) * kLdS + n * 16 + i % 16] = __float2bfloat16(sc[i]);
        __syncwarp();
      }
      // O [16, W] += S slice [16, 64] . V chunk [64, W]
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 16) {
        w::fragment<w::matrix_a, 16, 16, 16, bf16, w::row_major> sf;
        w::load_matrix_sync(sf, sw + kk, kLdS);
#pragma unroll
        for (int f = 0; f < L::kFrags; ++f) {
          w::fragment<w::matrix_b, 16, 16, 16, bf16, w::row_major> vf;
          w::load_matrix_sync(vf, vs + kk * L::kLd + f * 16, L::kLd);
          w::mma_sync(acc[f], sf, vf, acc[f]);
        }
      }
    }
  }
  // the live columns of the warp's rows, rounded once
#pragma unroll
  for (int f = 0; f < L::kFrags; ++f) {
    w::store_matrix_sync(sc, acc[f], 16, w::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 256; i += 32) {
      const int r = q0 + warp * kWarpRows + i / 16, c = f * 16 + i % 16;
      if (r < t && c < L::kLive)
        o[base + (long long)r * h + col0 + c] = __float2bfloat16(sc[i]);
    }
    __syncwarp();
  }
}

template <int kGroup>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int t,
                   int h, cudaStream_t stream) {
  using L = Layout<kGroup>;
  const int units = h / L::kLive;  // heads (P1) or whole groups (P2)
  if (batch <= 0 || t <= 0 || h % kHeadDim || units == 0 || batch > 65535)
    return cudaErrorInvalidValue;
  auto kernel = headpack_kernel<kGroup>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + kTileRows - 1) / kTileRows, units, batch);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), t, h);
  return cudaGetLastError();
}

}  // namespace headpack

extern "C" {

// q, k, v, o: bfloat16 [batch, t, h], contiguous, 8-byte aligned, h = heads x 36. P1 writes
// every head's columns of o; P2 (groups of 3) those of heads 0 .. 3 floor(heads / 3) - 1
// and leaves the rest of o as it was. Return a cudaError_t (0 on success).
int wm_headpack_v0(const void* q, const void* k, const void* v, void* o, int batch, int t,
                   int h, void* stream) {
  return headpack::launch<1>(q, k, v, o, batch, t, h, static_cast<cudaStream_t>(stream));
}

int wm_headpack_v1(const void* q, const void* k, const void* v, void* o, int batch, int t,
                   int h, void* stream) {
  return headpack::launch<3>(q, k, v, o, batch, t, h, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
