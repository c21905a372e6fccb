// The float32 bodies of the attention on separate q, k, v for Hopper (sm_90a): B3f's forward
// (flash_attention.cu's `launch`) and the backward of B3b and B2 (attention_bwd.cuh's
// `launch_bwd`), written for the SIMT pipes: fp32 operands, fp32 FMA, fp32 sums and expf; no
// TF32, no tensor cores, no library call.
//
// Replaces, in float32, the TPU kernels `_fwd_kernel` (weathermodel_tpu/ops/pallas_attention.py
// :199), `_bwd_kernel` (:288) and `_bwd_kernel_qkv` (:391). The math is the one
// flash_attention.cu and attention_bwd.cuh state, with rnd the identity in float32:
//   forward   qs = q scale;  s = qs . k^T;  o = sum_j keep e_j v_j * (recip / (1 - rate))
//   backward  w = exp(s - m) recip;  wd = keep ? w inv_keep : 0;  dw = keep ? dwd inv_keep : 0
//             rowsum = sum_j dw w;  ds = w (dw - rowsum);  dq = (ds . k) scale;
//             dk = ds^T . qs;  dv = wd^T . dO
// with the keep bits of attention_common.cuh (mix32 unchanged, the same bits as B1's at one
// seed), regenerated from the seed and the global (batch row, head), never stored.
//
// What bounds it: at B = 256, T = 365, 10 heads of 20 the forward's two T x T x hd products
// are 27.3 GFLOP (0.407 ms at 67 TFLOP/s) and the backward's five 68.2 GFLOP (1.018 ms);
// their bytes take a tenth of that. Off the tensor cores two more limits stand in front of
// the FFMA pipe: shared memory returns 32 words a clock to an SM against its 128 FMA lanes,
// so a word loaded must feed four FMAs; and every other instruction (per score an expf, the
// dropout hash, the softmax's few operations, the loads) takes a scheduler slot from an FFMA.
// The scalar bodies (attention_fwd.cuh, attention_bwd.cuh's passes) loaded a word per FMA,
// with lanes idle over the head dim and one 512-thread block an SM.
//
// Design: a thread owns R rows of one (batch row, head), R = 2 where its registers hold them
// (`FwdTile`, `DqTile`, `DkdvTile`): query rows in the forward and in pass A, key rows in
// pass B. A block of up to six warps takes up to 192 R rows, a head ceil(T / (192 R))
// blocks, the rows shared evenly. The block keeps the head's other operands whole in shared
// memory as fp32 [T_pad][hd] (T_pad = T rounded up to 8, zero past T), and all its threads
// walk them in one order, so that each float4 read is a broadcast (no bank conflict, no
// padding) and feeds 4 R FMAs in each lane. The thread's own rows, its sums and a tile of
// scores stay in registers: R rows x 8 / R keys a step in the forward (8 independent FMA
// chains), R x 4 / R in pass A for s and for dwd, then R rows x hd for the products over
// the head dim (in whole float4s). At hd 20 a loaded word so feeds two FMAs in every kernel
// (pass B: one query row's qs and dO, each entering two products): half of what would let
// the FFMA pipe alone set the pace. More rows a thread ran slower on the card: pass B with
// two keys at hd 20 took 235 registers, one block an SM, and 13% more time.
//   * Forward: sweep 1 takes the row max; sweep 2 recomputes s, forms e = expf(s - m) (the
//     scalar body's bits: the same fmaf order and the exact max), sums e, and adds keep e v;
//     the end scales by recip / (1 - rate). One product more than an online softmax, which
//     ran 12% faster on the card but moved WeatherFormer-small's fp32 step off the plain
//     path's past its bar (a first-layer gradient 1.6e-4 off, against 1e-4).
//   * Backward pass A (`attention_bwd_ffma_dq_kernel`): sweep 1 computes s and dwd = dO . v
//     and keeps the max, sum e and sum e dw online (scalars rescaled when the max rises);
//     sweep 2 recomputes both, forms ds and adds ds k into dq, reading the step's k rows
//     again (volatile reads above hd 20, where ptxas would hold them and spill). Writes dq
//     and the row statistics (max, recip, rowsum) to the [B, nh, 3, T] buffer.
//   * Backward pass B (`attention_bwd_ffma_dkdv_kernel`): qs and dO rows and the statistics
//     with each row's dropout key in shared memory. For each query row the thread reads qs
//     and dO once into registers, computes s and dwd against its key in pass A's fmaf order
//     (so both passes see the same bits), then adds wd dO into dv and ds qs into dk.
//   Nine T x T x hd products against the bound's five, in exchange for no atomics and a fixed
//   order for every sum: two calls give the same bits. Each row's dropout key is hoisted with
//   mix32's first shift-xor folded in (`hoisted_key`), so a keep bit costs the hash's last
//   two multiplies and shifts. Outputs go through shared memory ([rows][hd + 1]) so that the
//   stores are coalesced.
// Shared memory: 8 hd T_pad bytes (forward, pass A) and (8 hd + 16) T_pad (pass B): 58,880
// and 64,768 B at T = 365, hd 20. The backward takes T up to 760 at hd 36, 968 at hd 28, 1320
// at hd 20 and every T at hd 12 (`bwd_takes`), the forward up to 800, 1032, 1448 and every T
// (`fwd_takes`). Past that float32 runs the scalar bodies, an explicit dispatch on the shape.
// Any row stride and any 4-byte aligned base: the loads are scalar and coalesced. Registers
// and spills: ptxas -v, printed by chip_smoke.py's kernel_flash phase.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

// Everything here has internal linkage: the forward's and the two backward files each
// compile their own copy.
namespace attn_ffma {
namespace {

constexpr int kScores = 8;  // the register tile of scores a step: rows x keys
constexpr int kPad = 8;     // resident rows are padded to a multiple of this
constexpr int kBlockWarps = 6;  // a block's most warps

// How each kernel tiles a head, by head dim: the rows a thread owns are as many as its
// registers hold beside the rest without spilling (ptxas -v), and pass B above hd 20 needs
// one block an SM's registers.
template <int R, int B>
struct Tiling {
  static constexpr int kRows = R;    // rows a thread owns
  static constexpr int kBlocks = B;  // blocks an SM holds: the launch bounds' registers
};
template <int HD>
using FwdTile = Tiling<(HD <= 28 ? 2 : 1), 2>;
template <int HD>
using DqTile = Tiling<(HD <= 20 ? 2 : 1), 2>;
template <int HD>
using DkdvTile = Tiling<(HD <= 12 ? 2 : 1), (HD > 20 ? 1 : 2)>;

// T rounded up to whole steps: the rows a block keeps of each resident operand.
__host__ __device__ constexpr int padded(int t) { return (t + kPad - 1) / kPad * kPad; }

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// The launch at t of a kernel tiled by Tile: warps a block, blocks a (batch row, head).
struct Shape {
  int warps;
  int blocks;
};

template <typename Tile>
__host__ __device__ constexpr Shape shape_at(int t) {
  const int rows = Tile::kRows;
  const int row_warps = (t + 32 * rows - 1) / (32 * rows);
  const int blocks = (row_warps + kBlockWarps - 1) / kBlockWarps;
  return {(row_warps + blocks - 1) / blocks, blocks};
}

// Dynamic shared memory, in bytes: a forward or pass-A block keeps K and V (or stages its
// outputs), a pass-B block qs, dO and the row statistics (or stages dk and dv).
template <typename Tile>
__host__ __device__ constexpr size_t rows_smem(int t, int hd, int extra, int outs) {
  return sizeof(float) * imax((2 * hd + extra) * padded(t),
                              outs * 32 * Tile::kRows * shape_at<Tile>(t).warps * (hd + 1));
}

template <int HD>
constexpr size_t fwd_smem(int t) {
  return rows_smem<FwdTile<HD>>(t, HD, 0, 1);
}

template <int HD>
constexpr size_t dq_smem(int t) {
  return rows_smem<DqTile<HD>>(t, HD, 0, 1);
}

template <int HD>
constexpr size_t dkdv_smem(int t) {
  return rows_smem<DkdvTile<HD>>(t, HD, 4, 2);
}

template <int HD>
constexpr bool fwd_takes(int t) {
  return t >= 1 && t <= wm::kMaxContext && fwd_smem<HD>(t) <= wm::kSmemMax;
}

template <int HD>
constexpr bool bwd_takes(int t) {
  return t >= 1 && t <= wm::kMaxContext && dq_smem<HD>(t) <= wm::kSmemMax &&
         dkdv_smem<HD>(t) <= wm::kSmemMax;
}

struct FwdParams {
  const float* q;
  const float* k;
  const float* v;
  int stride;  // row stride of q, k and v, in elements
  float* o;    // [B, T, H]
  int t;
  int h;
  int heads;
  float scale;
  wm::Dropout drop;
};

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  int in_stride;      // row stride of q, k and v, in elements
  const float* dout;  // [B, T, H]
  float* dq;
  float* dk;
  float* dv;
  int out_stride;  // row stride of dq, dk and dv, in elements
  float* stats;    // [B, nh, 3, T]: max, recip, rowsum
  int t;
  int h;
  int heads;
  float scale;
  wm::Dropout drop;
};

// A query row's statistics in pass B's shared memory, one broadcast float4 read.
struct __align__(16) RowStat {
  float m;
  float recip;
  float rowsum;
  uint32_t key;  // hoisted_key of the row
};

// The row's dropout key with mix32's first shift-xor applied: mix32(key ^ j) starts from
// (key ^ j) ^ ((key ^ j) >> 16) = (key ^ (key >> 16)) ^ j for every j < 2^16 (T is at most
// wm::kMaxContext).
__device__ __forceinline__ uint32_t hoisted_key(uint32_t head_key, uint32_t i) {
  const uint32_t key = wm::dropout_row_key(head_key, i);
  return key ^ (key >> 16);
}

// wm::dropout_keep(row key, j, threshold) from the row's hoisted key.
__device__ __forceinline__ bool keep(uint32_t hkey, uint32_t j, uint32_t threshold) {
  uint32_t x = hkey ^ j;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x < threshold;
}

// A float4 of shared memory read with ld.volatile.shared: never merged with, nor served
// from, an earlier read of the same words.
__device__ __forceinline__ float4 lds4_volatile(const float* p) {
  float4 x;
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"((unsigned)__cvta_generic_to_shared(p)));
  return x;
}

// dst[r][d] = src[r * stride + d] * mul for r < t and 0 up to padded(t): coalesced loads.
template <int HD>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int stride, float* dst,
                                          int t, float mul) {
  const int n = padded(t) * HD;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int r = idx / HD;
    dst[idx] = r < t ? src[(size_t)r * stride + (idx - r * HD)] * mul : 0.f;
  }
}

// The thread's R rows (row0 + threadIdx.x + r blockDim.x; past t, row t - 1's, never
// stored) of a [t] x stride array, times mul, into registers.
template <int HD, int R>
__device__ __forceinline__ void load_own(const float* __restrict__ src, int stride, int row0,
                                         int t, float mul, float (&dst)[R][HD]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + threadIdx.x + r * blockDim.x;
    const float* row = src + (size_t)(i < t ? i : t - 1) * stride;
#pragma unroll
    for (int d = 0; d < HD; ++d) dst[r][d] = row[d] * mul;
  }
}

// s[r][c] = a[r] . rows[c] for the thread's R rows and C rows of HD floats in shared memory:
// float4 broadcast reads, each feeding 4 R FMAs, every product summed from 0 in the order
// d = 0 .. HD - 1 (pass A and pass B take s and dwd in this one order, with the operands'
// roles swapped, which fmaf does not see).
template <int HD, int R, int C>
__device__ __forceinline__ void dots(const float (&a)[R][HD], const float* rows,
                                     float (&s)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) s[r][c] = 0.f;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(rows + c * HD + d);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r][c] = fmaf(a[r][d], x.x, s[r][c]);
        s[r][c] = fmaf(a[r][d + 1], x.y, s[r][c]);
        s[r][c] = fmaf(a[r][d + 2], x.z, s[r][c]);
        s[r][c] = fmaf(a[r][d + 3], x.w, s[r][c]);
      }
    }
  }
}

// acc[r] += w[r] row for the thread's R rows, one row of HD floats in shared memory.
// kVolatile reads the row again even where the step read it for its scores: ptxas would
// otherwise hold the step's rows (C x HD registers) and spill them above hd 20.
template <int HD, int R, bool kVolatile = false>
__device__ __forceinline__ void axpy(const float (&w)[R], const float* row,
                                     float (&acc)[R][HD]) {
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 x =
        kVolatile ? lds4_volatile(row + d) : *reinterpret_cast<const float4*>(row + d);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r][d] = fmaf(w[r], x.x, acc[r][d]);
      acc[r][d + 1] = fmaf(w[r], x.y, acc[r][d + 1]);
      acc[r][d + 2] = fmaf(w[r], x.z, acc[r][d + 2]);
      acc[r][d + 3] = fmaf(w[r], x.w, acc[r][d + 3]);
    }
  }
}

// The thread's rows times mul[r] to rows `stride` apart (those below t), staged through
// `stage` ([R blockDim][HD + 1] floats) so that the stores are coalesced. Call after a
// barrier that ends every read of that region.
template <int HD, int R>
__device__ __forceinline__ void store_own(const float (&rows)[R][HD], const float (&mul)[R],
                                          float* stage, float* __restrict__ dst, int stride,
                                          int row0, int t) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < HD; ++d)
      stage[(threadIdx.x + r * blockDim.x) * (HD + 1) + d] = rows[r][d] * mul[r];
  __syncthreads();
  const int n = R * blockDim.x * HD;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int r = idx / HD, d = idx - r * HD;
    if (row0 + r < t) dst[(size_t)(row0 + r) * stride + d] = stage[r * (HD + 1) + d];
  }
}

template <int HD, bool kDrop>
__global__ void __launch_bounds__(32 * kBlockWarps, FwdTile<HD>::kBlocks)
attention_fwd_ffma_kernel(FwdParams p) {
  constexpr int R = FwdTile<HD>::kRows, C = kScores / R;
  extern __shared__ float4 smem4[];
  const int t = p.t, tp = padded(t);
  float* ks = reinterpret_cast<float*>(smem4);  // [tp][HD]
  float* vs = ks + tp * HD;                     // [tp][HD]
  const int bh = blockIdx.x, b = bh / p.heads, head = bh - b * p.heads;
  const size_t off = (size_t)b * t * p.stride + head * HD;
  const int row0 = blockIdx.y * R * blockDim.x;

  load_rows<HD>(p.k + off, p.stride, ks, t, 1.f);
  load_rows<HD>(p.v + off, p.stride, vs, t, 1.f);
  float q[R][HD];
  load_own<HD, R>(p.q + off, p.stride, row0, t, p.scale, q);
  uint32_t hkey[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    hkey[r] = kDrop ? hoisted_key(wm::dropout_head_key(p.drop.seed, bh),
                                  row0 + threadIdx.x + r * blockDim.x)
                    : 0u;
  __syncthreads();

  float m[R], l[R], o[R][HD];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[r][d] = 0.f;
  }
  for (int j0 = 0; j0 < tp; j0 += C) {  // sweep 1: the row max
    float s[R][C];
    dots<HD, R, C>(q, ks + j0 * HD, s);
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (j0 + c < t)
#pragma unroll
        for (int r = 0; r < R; ++r) m[r] = fmaxf(m[r], s[r][c]);
  }
  for (int j0 = 0; j0 < tp; j0 += C) {  // sweep 2: e, its sum and keep e v
    float s[R][C];
    dots<HD, R, C>(q, ks + j0 * HD, s);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float e = j0 + c < t ? expf(s[r][c] - m[r]) : 0.f;
        l[r] += e;
        w[r] = !kDrop || keep(hkey[r], j0 + c, p.drop.threshold) ? e : 0.f;
      }
      axpy<HD, R>(w, vs + (j0 + c) * HD, o);
    }
  }
  float mul[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float recip = 1.f / l[r];
    mul[r] = kDrop ? recip / p.drop.keep_prob : recip;
  }
  __syncthreads();  // every thread is done with k and v
  store_own<HD, R>(o, mul, ks, p.o + (size_t)b * t * p.h + head * HD, p.h, row0, t);
}

template <int HD, bool kDrop>
__global__ void __launch_bounds__(32 * kBlockWarps, DqTile<HD>::kBlocks)
attention_bwd_ffma_dq_kernel(BwdParams p) {
  constexpr int R = DqTile<HD>::kRows, C = kScores / 2 / R;
  extern __shared__ float4 smem4[];
  const int t = p.t, tp = padded(t);
  float* ks = reinterpret_cast<float*>(smem4);  // [tp][HD]
  float* vs = ks + tp * HD;                     // [tp][HD]
  const int bh = blockIdx.x, b = bh / p.heads, head = bh - b * p.heads;
  const size_t in_off = (size_t)b * t * p.in_stride + head * HD;
  const int row0 = blockIdx.y * R * blockDim.x;

  load_rows<HD>(p.k + in_off, p.in_stride, ks, t, 1.f);
  load_rows<HD>(p.v + in_off, p.in_stride, vs, t, 1.f);
  float qs[R][HD], g[R][HD];
  load_own<HD, R>(p.q + in_off, p.in_stride, row0, t, p.scale, qs);
  load_own<HD, R>(p.dout + (size_t)b * t * p.h + head * HD, p.h, row0, t, 1.f, g);
  uint32_t hkey[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    hkey[r] = kDrop ? hoisted_key(wm::dropout_head_key(p.drop.seed, bh),
                                  row0 + threadIdx.x + r * blockDim.x)
                    : 0u;
  __syncthreads();

  // sweep 1: the max, sum e and sum e dw, rescaled when the max rises
  float m[R], l[R], edw[R];
#pragma unroll
  for (int r = 0; r < R; ++r) m[r] = -INFINITY, l[r] = 0.f, edw[r] = 0.f;
  for (int j0 = 0; j0 < tp; j0 += C) {
    float s[R][C], dwd[R][C];
    dots<HD, R, C>(qs, ks + j0 * HD, s);
    dots<HD, R, C>(g, vs + j0 * HD, dwd);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = m[r];
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (j0 + c < t) mx = fmaxf(mx, s[r][c]);
      if (mx > m[r]) {
        const float alpha = expf(m[r] - mx);
        l[r] *= alpha;
        edw[r] *= alpha;
        m[r] = mx;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float e = j0 + c < t ? expf(s[r][c] - m[r]) : 0.f;
        float dw = dwd[r][c];
        if (kDrop) dw = keep(hkey[r], j0 + c, p.drop.threshold) ? dw * p.drop.inv_keep : 0.f;
        l[r] += e;
        edw[r] = fmaf(e, dw, edw[r]);
      }
    }
  }
  float recip[R], rowsum[R];
#pragma unroll
  for (int r = 0; r < R; ++r) recip[r] = 1.f / l[r], rowsum[r] = edw[r] * recip[r];

  // sweep 2: ds and dq
  float dq[R][HD];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < HD; ++d) dq[r][d] = 0.f;
  for (int j0 = 0; j0 < tp; j0 += C) {
    float s[R][C], dwd[R][C];
    dots<HD, R, C>(qs, ks + j0 * HD, s);
    dots<HD, R, C>(g, vs + j0 * HD, dwd);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float ds[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float w = j0 + c < t ? expf(s[r][c] - m[r]) * recip[r] : 0.f;
        float dw = dwd[r][c];
        if (kDrop) dw = keep(hkey[r], j0 + c, p.drop.threshold) ? dw * p.drop.inv_keep : 0.f;
        ds[r] = w * (dw - rowsum[r]);
      }
      axpy<HD, R, (HD > 20)>(ds, ks + (j0 + c) * HD, dq);
    }
  }
  float* st = p.stats + (size_t)bh * 3 * t;
  float scale[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + threadIdx.x + r * blockDim.x;
    if (i < t) {
      st[i] = m[r];
      st[t + i] = recip[r];
      st[2 * t + i] = rowsum[r];
    }
    scale[r] = p.scale;
  }
  __syncthreads();  // every thread is done with k and v
  store_own<HD, R>(dq, scale, ks, p.dq + (size_t)b * t * p.out_stride + head * HD,
                   p.out_stride, row0, t);
}

// Pass B holds six rows of HD in registers: its key's k, v and two sums, and the query row
// of the step, whose qs and dO each feed two products. Above hd 20 that takes one block an
// SM's worth of registers.
template <int HD, bool kDrop>
__global__ void __launch_bounds__(32 * kBlockWarps, DkdvTile<HD>::kBlocks)
attention_bwd_ffma_dkdv_kernel(BwdParams p) {
  constexpr int R = DkdvTile<HD>::kRows;
  extern __shared__ float4 smem4[];
  const int t = p.t, tp = padded(t);
  float* qs = reinterpret_cast<float*>(smem4);             // [tp][HD], q * scale
  float* gs = qs + tp * HD;                                // [tp][HD], dO
  RowStat* st = reinterpret_cast<RowStat*>(gs + tp * HD);  // [tp]
  const int bh = blockIdx.x, b = bh / p.heads, head = bh - b * p.heads;
  const size_t in_off = (size_t)b * t * p.in_stride + head * HD;
  const int row0 = blockIdx.y * R * blockDim.x;

  load_rows<HD>(p.q + in_off, p.in_stride, qs, t, p.scale);
  load_rows<HD>(p.dout + (size_t)b * t * p.h + head * HD, p.h, gs, t, 1.f);
  const float* stats = p.stats + (size_t)bh * 3 * t;
  const uint32_t head_key = kDrop ? wm::dropout_head_key(p.drop.seed, bh) : 0u;
  for (int r = threadIdx.x; r < t; r += blockDim.x)
    st[r] = RowStat{stats[r], stats[t + r], stats[2 * t + r],
                    kDrop ? hoisted_key(head_key, r) : 0u};
  float kr[R][HD], vr[R][HD];
  load_own<HD, R>(p.k + in_off, p.in_stride, row0, t, 1.f, kr);
  load_own<HD, R>(p.v + in_off, p.in_stride, row0, t, 1.f, vr);
  __syncthreads();

  float dk[R][HD], dv[R][HD];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int d = 0; d < HD; ++d) dk[r][d] = dv[r][d] = 0.f;
  for (int i = 0; i < t; ++i) {
    float qi[HD], gi[HD];
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(qs + i * HD + d);
      const float4 y = *reinterpret_cast<const float4*>(gs + i * HD + d);
      qi[d] = x.x, qi[d + 1] = x.y, qi[d + 2] = x.z, qi[d + 3] = x.w;
      gi[d] = y.x, gi[d + 1] = y.y, gi[d + 2] = y.z, gi[d + 3] = y.w;
    }
    const RowStat x = st[i];
    float wd[R], ds[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f, dwd = 0.f;  // pass A's fmaf order
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        s = fmaf(kr[r][d], qi[d], s);
        dwd = fmaf(vr[r][d], gi[d], dwd);
      }
      const float w = expf(s - x.m) * x.recip;
      wd[r] = w;
      if (kDrop) {
        const bool kept = keep(x.key, row0 + threadIdx.x + r * blockDim.x, p.drop.threshold);
        wd[r] = kept ? w * p.drop.inv_keep : 0.f;
        dwd = kept ? dwd * p.drop.inv_keep : 0.f;
      }
      ds[r] = w * (dwd - x.rowsum);
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dv[r][d] = fmaf(wd[r], gi[d], dv[r][d]);
        dk[r][d] = fmaf(ds[r], qi[d], dk[r][d]);
      }
  }
  __syncthreads();  // every thread is done with qs and dO
  const size_t out_off = (size_t)b * t * p.out_stride + head * HD;
  float one[R];
#pragma unroll
  for (int r = 0; r < R; ++r) one[r] = 1.f;
  store_own<HD, R>(dk, one, qs, p.dk + out_off, p.out_stride, row0, t);
  store_own<HD, R>(dv, one, qs + R * blockDim.x * (HD + 1), p.dv + out_off, p.out_stride,
                   row0, t);
}

// ---- host side

// Dynamic shared memory up to `smem` bytes and the carveout that lets blocks share an SM.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int HD, bool kDrop>
cudaError_t launch_fwd_body(const FwdParams& p, int batch, cudaStream_t stream) {
  auto kernel = attention_fwd_ffma_kernel<HD, kDrop>;
  const size_t smem = fwd_smem<HD>(p.t);
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const Shape s = shape_at<FwdTile<HD>>(p.t);
  kernel<<<dim3((unsigned)batch * p.heads, s.blocks), 32 * s.warps, smem, stream>>>(p);
  return cudaGetLastError();
}

// B3f in float32 at a t that fwd_takes: q, k, v rows `stride` apart, o [batch, t, h].
template <int HD>
cudaError_t launch_fwd(const FwdParams& p, int batch, cudaStream_t stream) {
  if (!fwd_takes<HD>(p.t)) return cudaErrorInvalidValue;
  return p.drop.on ? launch_fwd_body<HD, true>(p, batch, stream)
                   : launch_fwd_body<HD, false>(p, batch, stream);
}

template <int HD, bool kDrop>
cudaError_t launch_bwd_body(const BwdParams& p, int batch, cudaStream_t stream) {
  auto dq = attention_bwd_ffma_dq_kernel<HD, kDrop>;
  auto dkdv = attention_bwd_ffma_dkdv_kernel<HD, kDrop>;
  const size_t smem_a = dq_smem<HD>(p.t), smem_b = dkdv_smem<HD>(p.t);
  cudaError_t err = set_smem(dq, smem_a);
  if (err == cudaSuccess) err = set_smem(dkdv, smem_b);
  if (err != cudaSuccess) return err;
  const Shape a = shape_at<DqTile<HD>>(p.t), b = shape_at<DkdvTile<HD>>(p.t);
  dq<<<dim3((unsigned)batch * p.heads, a.blocks), 32 * a.warps, smem_a, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((unsigned)batch * p.heads, b.blocks), 32 * b.warps, smem_b, stream>>>(p);
  return cudaGetLastError();
}

// The float32 backward at a t that bwd_takes: pass A, then pass B on its statistics.
template <int HD>
cudaError_t launch_bwd(const BwdParams& p, int batch, cudaStream_t stream) {
  if (!bwd_takes<HD>(p.t)) return cudaErrorInvalidValue;
  return p.drop.on ? launch_bwd_body<HD, true>(p, batch, stream)
                   : launch_bwd_body<HD, false>(p, batch, stream);
}

// The dynamic shared memory of a forward block at (hd, t), and the larger of the backward's
// two passes', in bytes; 0 where the body does not take t (float32 runs the scalar body).
inline int fwd_smem_bytes(int hd, int t) {
  switch (hd) {
    case 12: return fwd_takes<12>(t) ? (int)fwd_smem<12>(t) : 0;
    case 20: return fwd_takes<20>(t) ? (int)fwd_smem<20>(t) : 0;
    case 28: return fwd_takes<28>(t) ? (int)fwd_smem<28>(t) : 0;
    case 36: return fwd_takes<36>(t) ? (int)fwd_smem<36>(t) : 0;
    default: return 0;
  }
}

template <int HD>
int bwd_smem_at(int t) {
  return bwd_takes<HD>(t) ? imax((int)dq_smem<HD>(t), (int)dkdv_smem<HD>(t)) : 0;
}

inline int bwd_smem_bytes(int hd, int t) {
  switch (hd) {
    case 12: return bwd_smem_at<12>(t);
    case 20: return bwd_smem_at<20>(t);
    case 28: return bwd_smem_at<28>(t);
    case 36: return bwd_smem_at<36>(t);
    default: return 0;
  }
}

}  // namespace
}  // namespace attn_ffma
