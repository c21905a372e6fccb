// Tile machinery shared by the grouped matmul (B4, gmm.cu) and its weight gradient
// (B4t, tgmm.cu).
//
// Both kernels compute one 128 x 128 output tile per thread block of 256 threads and
// reduce over a dimension in slabs of 32: each slab of both operands is staged from
// device memory into shared memory (rows outside the active group and columns past the
// matrix edge read as zeros), then multiplied into fp32 accumulators:
//   bfloat16  tensor cores through WMMA (mma.sync, 16 x 16 x 16 bf16 -> fp32). The 8
//             warps sit on a 4 x 2 grid, each owning a 32 x 64 sub-tile (2 x 4
//             fragments); the accumulators go out through a per-warp 16 x 16 fp32
//             scratch in shared memory.
//   float32   fp32 FMA (no tensor core keeps full fp32). Each thread owns an 8 x 8
//             register block at rows ty + 16i, columns tx + 16j.
// Every product is accumulated in fp32 and rounded once to the element type at the end.
//
// Shared-memory rows are padded: bf16 by 8 elements (16 bytes; WMMA needs a leading
// dimension that is a multiple of 8 and 32-byte aligned fragment pointers), fp32 by one
// word so that the FMA loop's column reads of a transposed operand hit distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace gmm_tiles {

using wm::from_float;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;  // output tile edge
constexpr int kDepth = 32;  // reduction slab

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

template <typename T>
constexpr int kPad = kIsBf16<T> ? 8 : 1;

// row strides (elements) of a staged slab that is kTile or kDepth wide
template <typename T>
constexpr int kLdTile = kTile + kPad<T>;
template <typename T>
constexpr int kLdDepth = kDepth + kPad<T>;

// Copy rows [row0, row0 + kRows) x columns [col0, col0 + kCols) of the row-major matrix
// `src` (`ld` elements per row) into shared memory `dst` (`ldd` elements per row). Rows
// outside [row_lo, row_hi) and columns at or past col_end are written as zeros, so they
// add nothing to the products. `vec` says that src and ld allow 16-byte loads.
template <typename T, int kRows, int kCols>
__device__ __forceinline__ void stage(T* dst, int ldd, const T* __restrict__ src, long long ld,
                                      long long row0, long long row_lo, long long row_hi,
                                      int col0, int col_end, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunksPerRow = kCols / kVec;
  static_assert(kCols % kVec == 0, "tile width must be whole 16-byte chunks");
  for (int c = threadIdx.x; c < kRows * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int cc = (c % kChunksPerRow) * kVec;
    const long long row = row0 + r;
    const int col = col0 + cc;
    const bool row_in = row >= row_lo && row < row_hi;
    T* d = dst + r * ldd + cc;
    if (row_in && vec && col + kVec <= col_end) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + row * ld + col);
      if constexpr (kIsBf16<T>) {
        *reinterpret_cast<uint4*>(d) = v;  // bf16 rows are 16-byte aligned (see kPad)
      } else {
        d[0] = __uint_as_float(v.x);
        d[1] = __uint_as_float(v.y);
        d[2] = __uint_as_float(v.z);
        d[3] = __uint_as_float(v.w);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        d[i] = (row_in && col + i < col_end) ? src[row * ld + col + i] : from_float<T>(0.f);
    }
  }
}

// fp32 accumulators of one thread block's 128 x 128 tile, in the layout of its compute
// path (module comment).
template <typename T>
struct Acc;

template <>
struct Acc<__nv_bfloat16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[2][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(f[i][j], 0.f);
  }
};

template <>
struct Acc<float> {
  float v[8][8];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) v[i][j] = 0.f;
  }
};

// acc += A . B over one staged slab of depth kDepth. A is kTile x kDepth, B kDepth x kTile.
// A is read at a + m * a_m + kk * a_k and B at b + kk * b_k + n * b_n (element strides in
// shared memory); one of each pair is 1, which is what the layout flags below say.
//   kARowMajor: a_k == 1 (A stored [m][k]), else a_m == 1 (A stored [k][m])
//   kBRowMajor: b_n == 1 (B stored [k][n]), else b_k == 1 (B stored [n][k])
// `ld_a` / `ld_b` is the stride that is not 1.
template <typename T, bool kARowMajor, bool kBRowMajor>
__device__ __forceinline__ void mma_slab(Acc<T>& acc, const T* a, int ld_a, const T* b,
                                         int ld_b) {
  if constexpr (kIsBf16<T>) {
    namespace w = nvcuda::wmma;
    using ALayout = typename std::conditional<kARowMajor, w::row_major, w::col_major>::type;
    using BLayout = typename std::conditional<kBRowMajor, w::row_major, w::col_major>::type;
    const int warp = threadIdx.x / 32;
    const int wm = warp / 2, wn = warp % 2;  // 4 x 2 warps of 32 x 64
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 16) {
      w::fragment<w::matrix_a, 16, 16, 16, __nv_bfloat16, ALayout> fa[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm * 32 + i * 16;
        w::load_matrix_sync(fa[i], kARowMajor ? a + m * ld_a + kk : a + kk * ld_a + m, ld_a);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 64 + j * 16;
        w::fragment<w::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb;
        w::load_matrix_sync(fb, kBRowMajor ? b + kk * ld_b + n : b + n * ld_b + kk, ld_b);
#pragma unroll
        for (int i = 0; i < 2; ++i) w::mma_sync(acc.f[i][j], fa[i], fb, acc.f[i][j]);
      }
    }
  } else {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
    for (int kk = 0; kk < kDepth; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = ty + 16 * i;
        av[i] = kARowMajor ? a[m * ld_a + kk] : a[kk * ld_a + m];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        bv[j] = kBRowMajor ? b[kk * ld_b + n] : b[n * ld_b + kk];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc.v[i][j] = fmaf(av[i], bv[j], acc.v[i][j]);
    }
  }
}

// Write the tile: element (m, n) of the accumulators goes to out[m * ld + n], rounded
// once to T, for m < rows and n < cols (the tile's part inside the output).
// `scratch` is kWarps x 256 floats of shared memory, 32-byte aligned (bf16 path only).
template <typename T>
__device__ __forceinline__ void store_tile(Acc<T>& acc, T* __restrict__ out, long long ld,
                                           int rows, int cols, float* scratch) {
  if constexpr (kIsBf16<T>) {
    namespace w = nvcuda::wmma;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 2, wn = warp % 2;
    float* sc = scratch + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w::store_matrix_sync(sc, acc.f[i][j], 16, w::mem_row_major);
        __syncwarp();
        const int m0 = wm * 32 + i * 16, n0 = wn * 64 + j * 16;
        for (int idx = lane; idx < 256; idx += 32) {
          const int m = m0 + idx / 16, n = n0 + idx % 16;
          if (m < rows && n < cols) out[m * ld + n] = from_float<T>(sc[idx]);
        }
        __syncwarp();
      }
  } else {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = ty + 16 * i;
      if (m >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (n < cols) out[m * ld + n] = from_float<T>(acc.v[i][j]);
      }
    }
  }
}

// 16-byte loads need the base pointer 16-byte aligned and the row length a whole number
// of 16-byte chunks.
template <typename T>
inline bool vec_ok(const void* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (ld * (long long)sizeof(T)) % 16 == 0;
}

}  // namespace gmm_tiles
