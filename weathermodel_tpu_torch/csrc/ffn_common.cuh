// The row-block FFN kernel shared by the fused FFN (B7, fused_ffn.cu), the fused FFN +
// residual + LayerNorm (B6f, fused_ffn_ln.cu) and the recompute pass of its backward (B6b,
// fused_ffn_ln_bwd.cu).
//
// One thread block of 256 threads owns kRows = 32 rows of x [M, H] and every one of their H
// output columns, so the LayerNorm epilogue (and its backward) sees whole rows, as the TPU
// kernel's per-item blocks do. The block walks the hidden dimension F in chunks of 128:
//   h_c  = dropout1(relu(x . W1[:, chunk] + b1[chunk]))   rounded once to x's dtype,
//          kept in shared memory (written to device memory only where a caller needs it)
//   acc += h_c . W2[chunk, :]                              fp32 accumulators of [32, H]
// then adds b2, applies dropout2 and finishes the rows by mode:
//   kModeFfn  (B7)   f = acc + b2 (dropped), rounded; optionally h
//   kModeLn   (B6f)  out = LN(x + f) with fp32 statistics, rounded
//   kModeBwd  (B6b)  recomputes the forward (multiplying by 1/(1-p) where the forward divided,
//                    as the TPU backward does), writes the hidden hd, runs the LayerNorm
//                    backward: dy = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) in fp32,
//                    df = dropout2(dy) rounded, and per-block column sums of do * xhat and do
//                    (the LN parameters' gradients, summed over blocks in a second pass)
// The [M, F] hidden never goes through device memory in the forward unless asked for.
//
// Products: bfloat16 on the tensor cores through WMMA (16 x 16 x 16, fp32 accumulation);
// the first product's [32, 128] chunk is 2 x 8 fragments, one column of fragments per warp;
// the second's [32, H] accumulators are 2 x 5 fragments per warp (warp w owns the fragment
// columns w, w + 8, ..., so H <= 640). float32 on the FMA pipes: thread (warp w, lane l)
// owns rows w + 8i and columns l + 32j. The weights stream through shared memory in slabs
// of 32 (W1 as [32][128], W2 as [32][H]); x's rows are staged once. Everything sits in
// dynamic shared memory (RowsSmem; 109 KB in bf16 and 176 KB in fp32 at H = 576), which
// needs cudaFuncSetAttribute above 48 KB.
//
// Dropout keep bits of an FFN site: element (row, col) is kept iff
//   mix32(dropout_head_key(seed, row) ^ col) < threshold,   threshold = (uint32)((1-p) 2^32)
// (attention_common.cuh's hash on a (row, col) pair), with row the flattened row of x and
// one seed per site; weathermodel_tpu_torch/ops/dropout.py computes the same bits with
// int64 tensor ops (`ffn_keep_mask`).

#pragma once

#include "attention_common.cuh"
#include "gmm_common.cuh"

namespace ffn {

using gmm_tiles::kDepth;
using wm::from_float;
using wm::to_float;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;       // rows of x per block
constexpr int kChunk = 128;     // hidden columns per pass
constexpr int kColFrags = 5;    // bf16: fragment columns of the [32, H] accumulator per warp
constexpr int kMaxH = kWarps * kColFrags * 16;  // 640
constexpr int kFp32Cols = kMaxH / 32;           // fp32: columns per thread, l + 32j
constexpr float kLnEps = 1e-5f;

enum { kModeFfn = 0, kModeLn = 1, kModeBwd = 2 };

// keep bit of element (row, col) of an FFN dropout site, `key` = dropout_head_key(seed, row)
__device__ __forceinline__ bool keep_bit(uint32_t key, int col, uint32_t threshold) {
  return wm::dropout_keep(key, (uint32_t)col, threshold);
}

struct RowsArgs {
  const void* x;      // [m, h]
  const void* w1;     // [h, f]
  const float* b1;    // [f]
  const void* w2;     // [f, h]
  const float* b2;    // [h]
  const float* ls;    // [h] LayerNorm scale (kModeLn, kModeBwd)
  const float* lb;    // [h] LayerNorm bias (kModeLn)
  const void* dout;   // [m, h] cotangent of the LN output (kModeBwd)
  void* out;          // [m, h]: f (kModeFfn) or the LN output (kModeLn)
  void* hidden;       // [m, f]: h (kModeFfn, may be null) or hd (kModeBwd)
  void* df;           // [m, h] (kModeBwd)
  float* dy;          // [m, h] fp32 (kModeBwd)
  float* ln_part;     // [blocks, 2, h] fp32 column sums of do * xhat and do (kModeBwd)
  int m, h, f;
  int on;             // dropout on
  uint32_t seed1, seed2, threshold;
  float scale;        // kept values: v / scale in kModeLn (scale = 1 - p), else v * scale
  bool vec_x, vec_w1, vec_w2;
};

// Byte offsets of the block's shared-memory regions. ys (fp32 [32][ldy], the finished rows)
// reuses the slabs' space once the products are done.
struct RowsSmem {
  int hp, ldx, ld1, ldy;
  int xs, w1s, hs, w2s, sc, ys, total;
};

__host__ __device__ inline int round128(int bytes) { return (bytes + 127) / 128 * 128; }

template <typename T>
__host__ __device__ inline RowsSmem rows_smem(int h) {
  RowsSmem s;
  s.hp = (h + 31) / 32 * 32;
  s.ldx = s.hp + gmm_tiles::kPad<T>;
  s.ld1 = kChunk + gmm_tiles::kPad<T>;
  s.ldy = s.hp + 4;
  const int e = sizeof(T);
  const int xs = round128(kRows * s.ldx * e), w1s = round128(kDepth * s.ld1 * e);
  const int hs = round128(kRows * s.ld1 * e), w2s = round128(kDepth * s.ldx * e);
  const int sc = gmm_tiles::kIsBf16<T> ? kRows * kChunk * 4 : 0;
  const int ys = round128(kRows * s.ldy * 4);
  s.xs = 0;
  s.w1s = xs;
  s.hs = s.w1s + w1s;
  s.w2s = s.hs + hs;
  s.sc = s.w2s + w2s;
  s.ys = xs;
  const int slabs = w1s + hs + w2s + sc;
  s.total = xs + (slabs > ys ? slabs : ys);
  return s;
}

// Copy rows [row0, row0 + rows) x columns [col0, col0 + ncols) of the row-major matrix src
// (ld elements per row) into dst (ldd elements per row); rows at or past row_end and columns
// at or past col_end are written as zeros. col0 and ncols are whole 16-byte chunks; `vec`
// says that src and ld allow 16-byte loads.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ldd, const T* __restrict__ src,
                                           long long ld, long long row0, int rows,
                                           long long row_end, int col0, int ncols,
                                           int col_end, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = ncols / kVec;
  for (int c = threadIdx.x; c < rows * per_row; c += kThreads) {
    const int r = c / per_row;
    const int cc = (c % per_row) * kVec;
    const long long row = row0 + r;
    const int col = col0 + cc;
    const bool row_in = row < row_end;
    T* d = dst + r * ldd + cc;
    if (row_in && vec && col + kVec <= col_end) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + row * ld + col);
      if constexpr (gmm_tiles::kIsBf16<T>) {
        *reinterpret_cast<uint4*>(d) = v;  // bf16 row strides are whole 16-byte chunks
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

namespace {

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 1) ffn_rows_kernel(RowsArgs a) {
  namespace w = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsSmem L = rows_smem<T>(a.h);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* w1s = reinterpret_cast<T*>(smem + L.w1s);
  T* hs = reinterpret_cast<T*>(smem + L.hs);
  T* w2s = reinterpret_cast<T*>(smem + L.w2s);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* ys = reinterpret_cast<float*>(smem + L.ys);

  const T* x = static_cast<const T*>(a.x);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);
  T* hidden = static_cast<T*>(a.hidden);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r0 = (long long)blockIdx.x * kRows;
  const int h = a.h, f = a.f, hp = L.hp;

  auto drop = [&](float v, bool keep) {
    if (!keep) return 0.f;
    return kMode == kModeLn ? v / a.scale : v * a.scale;
  };
  // one element of the hidden chunk starting at column c0: bias, ReLU, dropout1, rounding;
  // into shared memory, and to device memory where asked
  auto hidden_elem = [&](int c0, int r, int cc, float acc) {
    const long long row = r0 + r;
    const int col = c0 + cc;
    float v = 0.f;
    if (col < f) {
      v = fmaxf(acc + a.b1[col], 0.f);
      if (a.on) v = drop(v, keep_bit(wm::dropout_head_key(a.seed1, (uint32_t)row), col,
                                     a.threshold));
    }
    const T hv = from_float<T>(v);
    hs[r * L.ld1 + cc] = hv;
    if (hidden != nullptr && row < a.m && col < f) hidden[row * f + col] = hv;
  };

  stage_rows<T>(xs, L.ldx, x, h, r0, kRows, a.m, 0, hp, h, a.vec_x);

  // second product's accumulators (one of the two layouts is used)
  w::fragment<w::accumulator, 16, 16, 16, float> acc2[2][kColFrags];
  float acc2f[4][kFp32Cols];
  if constexpr (gmm_tiles::kIsBf16<T>) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int s = 0; s < kColFrags; ++s) w::fill_fragment(acc2[i][s], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kFp32Cols; ++j) acc2f[i][j] = 0.f;
  }

  for (int c0 = 0; c0 < f; c0 += kChunk) {
    // ---- first product: the [32, 128] hidden chunk
    if constexpr (gmm_tiles::kIsBf16<T>) {
      w::fragment<w::accumulator, 16, 16, 16, float> acc1[2];
      w::fill_fragment(acc1[0], 0.f);
      w::fill_fragment(acc1[1], 0.f);
      for (int k0 = 0; k0 < hp; k0 += kDepth) {
        stage_rows<T>(w1s, L.ld1, w1, f, k0, kDepth, h, c0, kChunk, f, a.vec_w1);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kDepth; kk += 16) {
          w::fragment<w::matrix_b, 16, 16, 16, __nv_bfloat16, w::row_major> fb;
          w::load_matrix_sync(fb, w1s + kk * L.ld1 + 16 * warp, L.ld1);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            w::fragment<w::matrix_a, 16, 16, 16, __nv_bfloat16, w::row_major> fa;
            w::load_matrix_sync(fa, xs + 16 * i * L.ldx + k0 + kk, L.ldx);
            w::mma_sync(acc1[i], fa, fb, acc1[i]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
        w::store_matrix_sync(sc + 16 * i * kChunk + 16 * warp, acc1[i], kChunk,
                             w::mem_row_major);
      __syncthreads();
      for (int idx = threadIdx.x; idx < kRows * kChunk; idx += kThreads)
        hidden_elem(c0, idx / kChunk, idx % kChunk, sc[idx]);
    } else {
      float acc1[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc1[i][j] = 0.f;
      for (int k0 = 0; k0 < hp; k0 += kDepth) {
        stage_rows<T>(w1s, L.ld1, w1, f, k0, kDepth, h, c0, kChunk, f, a.vec_w1);
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kDepth; ++kk) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = to_float(xs[(warp + 8 * i) * L.ldx + k0 + kk]);
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = to_float(w1s[kk * L.ld1 + lane + 32 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc1[i][j] = fmaf(av[i], bv[j], acc1[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) hidden_elem(c0, warp + 8 * i, lane + 32 * j, acc1[i][j]);
    }

    // ---- second product: acc += h_c . W2[c0 : c0 + 128, :]
    for (int kk0 = 0; kk0 < kChunk; kk0 += kDepth) {
      stage_rows<T>(w2s, L.ldx, w2, h, c0 + kk0, kDepth, f, 0, hp, h, a.vec_w2);
      __syncthreads();
      if constexpr (gmm_tiles::kIsBf16<T>) {
#pragma unroll
        for (int kk = 0; kk < kDepth; kk += 16) {
          w::fragment<w::matrix_a, 16, 16, 16, __nv_bfloat16, w::row_major> fa[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            w::load_matrix_sync(fa[i], hs + 16 * i * L.ld1 + kk0 + kk, L.ld1);
#pragma unroll
          for (int s = 0; s < kColFrags; ++s) {
            const int j = warp + kWarps * s;
            if (16 * j >= hp) continue;  // uniform across the warp
            w::fragment<w::matrix_b, 16, 16, 16, __nv_bfloat16, w::row_major> fb;
            w::load_matrix_sync(fb, w2s + kk * L.ldx + 16 * j, L.ldx);
#pragma unroll
            for (int i = 0; i < 2; ++i) w::mma_sync(acc2[i][s], fa[i], fb, acc2[i][s]);
          }
        }
      } else {
#pragma unroll 2
        for (int kk = 0; kk < kDepth; ++kk) {
          float av[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = to_float(hs[(warp + 8 * i) * L.ld1 + kk0 + kk]);
#pragma unroll
          for (int j = 0; j < kFp32Cols; ++j) {
            if (32 * j >= hp) continue;  // uniform across the warp
            const float bv = to_float(w2s[kk * L.ldx + lane + 32 * j]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc2f[i][j] = fmaf(av[i], bv, acc2f[i][j]);
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- the finished products as fp32 rows in ys (over the slabs, which are done)
  if constexpr (gmm_tiles::kIsBf16<T>) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int s = 0; s < kColFrags; ++s) {
        const int j = warp + kWarps * s;
        if (16 * j < hp)
          w::store_matrix_sync(ys + 16 * i * L.ldy + 16 * j, acc2[i][s], L.ldy,
                               w::mem_row_major);
      }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kFp32Cols; ++j)
        if (32 * j < hp) ys[(warp + 8 * i) * L.ldy + lane + 32 * j] = acc2f[i][j];
  }
  __syncthreads();

  // ---- row epilogues: a warp per row
  T* out = static_cast<T*>(a.out);
  const T* dout = static_cast<const T*>(a.dout);
  for (int rr = 0; rr < kRows / kWarps; ++rr) {
    const int r = warp * (kRows / kWarps) + rr;
    const long long row = r0 + r;
    float* yr = ys + r * L.ldy;
    if (row >= a.m) {  // uniform across the warp
      if constexpr (kMode == kModeBwd)
        for (int c = lane; c < h; c += 32) yr[c] = 0.f;
      continue;
    }
    const uint32_t key2 = wm::dropout_head_key(a.seed2, (uint32_t)row);
    float sum = 0.f;
    for (int c = lane; c < h; c += 32) {
      float v = yr[c] + a.b2[c];
      if (a.on) v = drop(v, keep_bit(key2, c, a.threshold));
      if constexpr (kMode == kModeFfn) {
        out[row * h + c] = from_float<T>(v);
      } else {
        v += to_float(xs[r * L.ldx + c]);
        yr[c] = v;
        sum += v;
      }
    }
    if constexpr (kMode != kModeFfn) {
      const float mu = wm::warp_sum(sum) / h;
      float sq = 0.f;
      for (int c = lane; c < h; c += 32) {
        const float d = yr[c] - mu;
        sq += d * d;
      }
      const float rstd = rsqrtf(wm::warp_sum(sq) / h + kLnEps);
      if constexpr (kMode == kModeLn) {
        for (int c = lane; c < h; c += 32)
          out[row * h + c] = from_float<T>((yr[c] - mu) * rstd * a.ls[c] + a.lb[c]);
      } else {
        const T* dor = dout + row * h;
        float s1 = 0.f, s2 = 0.f;
        for (int c = lane; c < h; c += 32) {
          const float xhat = (yr[c] - mu) * rstd;
          const float dxhat = to_float(dor[c]) * a.ls[c];
          s1 += dxhat;
          s2 += dxhat * xhat;
        }
        const float m1 = wm::warp_sum(s1) / h, m2 = wm::warp_sum(s2) / h;
        T* df = static_cast<T*>(a.df);
        for (int c = lane; c < h; c += 32) {
          const float xhat = (yr[c] - mu) * rstd;
          const float g = to_float(dor[c]);
          const float dy = rstd * (g * a.ls[c] - m1 - xhat * m2);
          a.dy[row * h + c] = dy;
          const float d = a.on ? drop(dy, keep_bit(key2, c, a.threshold)) : dy;
          df[row * h + c] = from_float<T>(d);
          yr[c] = g * xhat;
        }
      }
    }
  }

  if constexpr (kMode == kModeBwd) {  // the block's column sums of do * xhat and do
    __syncthreads();
    const int rows = a.m - r0 < kRows ? (int)(a.m - r0) : kRows;
    for (int c = threadIdx.x; c < h; c += kThreads) {
      float s = 0.f, g = 0.f;
      for (int r = 0; r < kRows; ++r) s += ys[r * L.ldy + c];
      for (int r = 0; r < rows; ++r) g += to_float(dout[(r0 + r) * h + c]);
      a.ln_part[(2LL * blockIdx.x) * h + c] = s;
      a.ln_part[(2LL * blockIdx.x + 1) * h + c] = g;
    }
  }
}

// Launch the row kernel of one mode over all rows of a.
template <typename T, int kMode>
cudaError_t launch_rows(const RowsArgs& a, cudaStream_t stream) {
  const RowsSmem L = rows_smem<T>(a.h);
  cudaError_t err = cudaFuncSetAttribute(ffn_rows_kernel<T, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((a.m + kRows - 1) / kRows);
  ffn_rows_kernel<T, kMode><<<blocks, kThreads, L.total, stream>>>(a);
  return cudaGetLastError();
}

// Fill the shared part of RowsArgs and dispatch on the dtype (0 = float32, 1 = bfloat16).
template <int kMode>
cudaError_t launch_rows_dtype(int dtype, RowsArgs a, cudaStream_t stream) {
  if (a.m < 0 || a.h <= 0 || a.f <= 0 || a.h > kMaxH) return cudaErrorInvalidValue;
  if (a.m == 0) return cudaSuccess;
  if (dtype == 0) {
    a.vec_x = gmm_tiles::vec_ok<float>(a.x, a.h);
    a.vec_w1 = gmm_tiles::vec_ok<float>(a.w1, a.f);
    a.vec_w2 = gmm_tiles::vec_ok<float>(a.w2, a.h);
    return launch_rows<float, kMode>(a, stream);
  }
  if (dtype == 1) {
    a.vec_x = gmm_tiles::vec_ok<__nv_bfloat16>(a.x, a.h);
    a.vec_w1 = gmm_tiles::vec_ok<__nv_bfloat16>(a.w1, a.f);
    a.vec_w2 = gmm_tiles::vec_ok<__nv_bfloat16>(a.w2, a.h);
    return launch_rows<__nv_bfloat16, kMode>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

}  // namespace ffn
