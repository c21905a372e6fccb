// The attention backward shared by kernels B2 (csrc/fused_qkv_attention_bwd.cu, packed
// qkv in and dqkv out) and B3b (csrc/flash_attention_bwd.cu, separate q, k, v in and
// dq, dk, dv out). Both are one body: each operand is a base pointer plus a row stride,
// so the packed layout is q = qkv, k = qkv + h, v = qkv + 2h with row stride 3h, and the
// separate one is three tensors with row stride h (or the column slices of a packed
// projection, row stride 3h). dO is [B, T, H], contiguous.
//
// For one (batch row, head), with q, k, v, dO [T, hd] the head's slices, at the TPU
// kernels' rounding points (`_bwd_head_math`, pallas_attention.py:330-388; rnd = round to
// the element type):
//   qs  = rnd(q * rnd(scale))
//   s   = qs . k^T;  e = exp(s - max);  recip = 1 / sum(e);  w = e * recip     (fp32)
//   wd  = rnd(keep ? w * inv_keep : 0)       (dropout off: rnd(w))
//   dv  = wd^T . dO
//   dwd = dO . v^T;  dw = keep ? dwd * inv_keep : 0   (dropout off: dwd)
//   rowsum = sum_j dw * w;  ds = rnd(w * (dw - rowsum))
//   dq  = (ds . k) * scale;  dk = ds^T . qs
// all accumulated in fp32 and written in the element type. The dropout keep bits are
// regenerated from the forward's seed and the global (batch row, head) (attention_common.cuh),
// not stored.
//
// Design: the flash-attention-2 split into two launches, because one head's q, k, v and
// dO do not fit a block's shared memory next to the score rows (as fp32 with stride
// hd + 1 at T = 365, hd = 36: 4 x 365 x 37 x 4 B = 216 KB of the 227 KB).
//   pass A (`bwd_dq_kernel`), one block per (batch row, head), 512 threads: K and V in
//     shared memory as fp32; each warp takes query rows, with that row's qs and dO in
//     registers. Lanes over keys compute s and dwd into two per-warp rows, then the
//     softmax, dw, the row sum and ds in place; lanes over the head dim then sum ds . K.
//     Writes dq and the row statistics (max, recip, rowsum) as fp32 [B, nh, 3, T].
//   pass B (`bwd_dkdv_kernel`), one block per (batch row, head): qs and dO in shared
//     memory, with the statistics and the per-row dropout keys; each warp takes key
//     columns, with that column's k and v in registers. Lanes over query rows recompute
//     s (bit-identical to pass A: the same fmaf chain), w from the statistics, the keep
//     bit, wd and ds into two per-warp rows; lanes over the head dim then sum wd^T . dO
//     and ds^T . qs. Writes dk and dv.
// Shared memory at T = 365, hd = 36: pass A 2 x 365 x 37 + 2 x 16 x 365 floats = 155 KB,
// pass B 2 x 365 x 37 + 4 x 365 + 2 x 16 x 365 words = 161 KB (hd = 20: 107 and 113 KB);
// the same in both element types, since everything in shared memory is fp32.
//
// What bounds it on the card: scalar fp32 FMA and shared-memory loads, as the forward
// (no tensor cores yet): 5 products of B x nh x T^2 x hd MACs plus the wasted lanes of
// the head-dim loops (hd = 36 over 2 x 32 lanes, hd = 20 over 32). The two passes each
// recompute the scores. Later work: the four T x T x hd products on tensor cores, one
// pass with dk/dv accumulated across query tiles.

#pragma once

#include <math.h>

#include "attention_common.cuh"

namespace {

// Operand pointers of one backward launch (see the header comment for the layouts).
template <typename T>
struct BwdArgs {
  const T* q;
  const T* k;
  const T* v;
  int in_stride;  // row stride of q, k and v, in elements
  const T* dout;  // [B, T, H]
  T* dq;
  T* dk;
  T* dv;
  int out_stride;  // row stride of dq, dk and dv, in elements
  float* stats;    // [B, nh, 3, T] fp32 scratch
};

// shared-memory row stride HD + 1 words (odd for the even head dims)
template <int HD>
size_t smem_dq_bytes(int t) {
  return (2ull * t * (HD + 1) + 2ull * wm::kWarps * t) * sizeof(float);
}

template <int HD>
size_t smem_dkdv_bytes(int t) {
  return (2ull * t * (HD + 1) + 4ull * t + 2ull * wm::kWarps * t) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(wm::kThreads, 1)
bwd_dq_kernel(BwdArgs<T> a, int t, int h, int num_heads, float scale, wm::Dropout drop) {
  using namespace wm;
  constexpr int S = HD + 1;
  extern __shared__ float smem[];
  float* ks = smem;                          // [t][S]
  float* vs = ks + (size_t)t * S;            // [t][S]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* srow = vs + (size_t)t * S + (size_t)warp * 2 * t;  // s -> e -> w -> ds
  float* dwrow = srow + t;                                  // dwd -> dw

  const int head = blockIdx.x % num_heads;
  const int row_b = blockIdx.x / num_heads;
  const size_t in_off = (size_t)row_b * t * a.in_stride + head * HD;
  const T* q_b = a.q + in_off;
  const T* do_b = a.dout + (size_t)row_b * t * h + head * HD;
  T* dq_b = a.dq + (size_t)row_b * t * a.out_stride + head * HD;
  float* st = a.stats + (size_t)blockIdx.x * 3 * t;  // [3][t]: max, recip, rowsum
  const float scale_t = round_to<T>(scale);
  const uint32_t head_key = dropout_head_key(drop.seed, blockIdx.x);

  load_head<T, HD, false>(a.k + in_off, ks, t, a.in_stride, 0.f);
  load_head<T, HD, false>(a.v + in_off, vs, t, a.in_stride, 0.f);
  __syncthreads();

  for (int i = warp; i < t; i += kWarps) {
    float q[HD], g[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      q[d] = round_to<T>(to_float(q_b[(size_t)i * a.in_stride + d]) * scale_t);
      g[d] = to_float(do_b[(size_t)i * h + d]);
    }

    float m = -INFINITY;
    for (int j = lane; j < t; j += 32) {
      const float* kr = ks + j * S;
      const float* vr = vs + j * S;
      float s = 0.f, dwd = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        s = fmaf(q[d], kr[d], s);
        dwd = fmaf(g[d], vr[d], dwd);
      }
      srow[j] = s;
      dwrow[j] = dwd;
      m = fmaxf(m, s);
    }
    m = warp_max(m);

    float sum = 0.f;
    for (int j = lane; j < t; j += 32) {
      float e = expf(srow[j] - m);
      srow[j] = e;
      sum += e;
    }
    const float recip = 1.f / warp_sum(sum);

    const uint32_t row_key = dropout_row_key(head_key, i);
    float part = 0.f;
    for (int j = lane; j < t; j += 32) {
      float w = srow[j] * recip;
      float dw = dwrow[j];
      if (drop.on) dw = dropout_keep(row_key, j, drop.threshold) ? dw * drop.inv_keep : 0.f;
      srow[j] = w;
      dwrow[j] = dw;
      part += dw * w;
    }
    const float rowsum = warp_sum(part);
    for (int j = lane; j < t; j += 32) srow[j] = round_to<T>(srow[j] * (dwrow[j] - rowsum));
    __syncwarp();

    float acc0 = 0.f, acc1 = 0.f;
    const int d0 = lane, d1 = lane + 32;
    for (int j = 0; j < t; ++j) {
      const float ds = srow[j];
      const float* kr = ks + j * S;
      if (d0 < HD) acc0 = fmaf(ds, kr[d0], acc0);
      if (d1 < HD) acc1 = fmaf(ds, kr[d1], acc1);
    }
    if (d0 < HD) dq_b[(size_t)i * a.out_stride + d0] = from_float<T>(acc0 * scale);
    if (d1 < HD) dq_b[(size_t)i * a.out_stride + d1] = from_float<T>(acc1 * scale);
    if (lane == 0) {
      st[i] = m;
      st[t + i] = recip;
      st[2 * t + i] = rowsum;
    }
    __syncwarp();  // the rows are rewritten by the next query row
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(wm::kThreads, 1)
bwd_dkdv_kernel(BwdArgs<T> a, int t, int h, int num_heads, float scale, wm::Dropout drop) {
  using namespace wm;
  constexpr int S = HD + 1;
  extern __shared__ float smem[];
  float* qs = smem;                          // [t][S], q * scale rounded
  float* gs = qs + (size_t)t * S;            // [t][S], dO
  float* mx = gs + (size_t)t * S;            // [t] row max
  float* rc = mx + t;                        // [t] row recip
  float* rsum = rc + t;                      // [t] rowsum(dw * w)
  uint32_t* rkey = reinterpret_cast<uint32_t*>(rsum + t);  // [t] dropout row keys
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* wdrow = reinterpret_cast<float*>(rkey + t) + (size_t)warp * 2 * t;
  float* dsrow = wdrow + t;

  const int head = blockIdx.x % num_heads;
  const int row_b = blockIdx.x / num_heads;
  const size_t in_off = (size_t)row_b * t * a.in_stride + head * HD;
  const T* k_b = a.k + in_off;
  const T* v_b = a.v + in_off;
  const size_t out_off = (size_t)row_b * t * a.out_stride + head * HD;
  T* dk_b = a.dk + out_off;
  T* dv_b = a.dv + out_off;
  const float* st = a.stats + (size_t)blockIdx.x * 3 * t;
  const float scale_t = round_to<T>(scale);
  const uint32_t head_key = dropout_head_key(drop.seed, blockIdx.x);

  load_head<T, HD, true>(a.q + in_off, qs, t, a.in_stride, scale_t);
  load_head<T, HD, false>(a.dout + (size_t)row_b * t * h + head * HD, gs, t, h, 0.f);
  for (int i = threadIdx.x; i < t; i += kThreads) {
    mx[i] = st[i];
    rc[i] = st[t + i];
    rsum[i] = st[2 * t + i];
    rkey[i] = dropout_row_key(head_key, i);
  }
  __syncthreads();

  for (int j = warp; j < t; j += kWarps) {
    float k[HD], v[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      k[d] = to_float(k_b[(size_t)j * a.in_stride + d]);
      v[d] = to_float(v_b[(size_t)j * a.in_stride + d]);
    }

    for (int i = lane; i < t; i += 32) {
      const float* qr = qs + i * S;
      const float* gr = gs + i * S;
      float s = 0.f, dwd = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        s = fmaf(qr[d], k[d], s);
        dwd = fmaf(gr[d], v[d], dwd);
      }
      const float w = expf(s - mx[i]) * rc[i];
      float wd, dw;
      if (drop.on) {
        const bool keep = dropout_keep(rkey[i], j, drop.threshold);
        wd = keep ? round_to<T>(w * drop.inv_keep) : 0.f;
        dw = keep ? dwd * drop.inv_keep : 0.f;
      } else {
        wd = round_to<T>(w);
        dw = dwd;
      }
      wdrow[i] = wd;
      dsrow[i] = round_to<T>(w * (dw - rsum[i]));
    }
    __syncwarp();

    float dv0 = 0.f, dv1 = 0.f, dk0 = 0.f, dk1 = 0.f;
    const int d0 = lane, d1 = lane + 32;
    for (int i = 0; i < t; ++i) {
      const float wd = wdrow[i], ds = dsrow[i];
      const float* qr = qs + i * S;
      const float* gr = gs + i * S;
      if (d0 < HD) {
        dv0 = fmaf(wd, gr[d0], dv0);
        dk0 = fmaf(ds, qr[d0], dk0);
      }
      if (d1 < HD) {
        dv1 = fmaf(wd, gr[d1], dv1);
        dk1 = fmaf(ds, qr[d1], dk1);
      }
    }
    if (d0 < HD) {
      dk_b[(size_t)j * a.out_stride + d0] = from_float<T>(dk0);
      dv_b[(size_t)j * a.out_stride + d0] = from_float<T>(dv0);
    }
    if (d1 < HD) {
      dk_b[(size_t)j * a.out_stride + d1] = from_float<T>(dk1);
      dv_b[(size_t)j * a.out_stride + d1] = from_float<T>(dv1);
    }
    __syncwarp();  // the rows are rewritten by the next key column
  }
}

template <typename T, int HD>
cudaError_t launch_bwd(BwdArgs<T> a, int batch, int t, int h, int num_heads,
                       wm::Dropout drop, cudaStream_t stream) {
  auto dq = bwd_dq_kernel<T, HD>;
  auto dkdv = bwd_dkdv_kernel<T, HD>;
  const size_t smem_a = smem_dq_bytes<HD>(t), smem_b = smem_dkdv_bytes<HD>(t);
  cudaError_t err =
      cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)HD));  // as the forward
  const unsigned grid = (unsigned)batch * num_heads;
  dq<<<grid, wm::kThreads, smem_a, stream>>>(a, t, h, num_heads, scale, drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv<<<grid, wm::kThreads, smem_b, stream>>>(a, t, h, num_heads, scale, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention_bwd(BwdArgs<T> a, int batch, int t, int h, int num_heads,
                          wm::Dropout drop, cudaStream_t s) {
  switch (h / num_heads) {
    case 12: return launch_bwd<T, 12>(a, batch, t, h, num_heads, drop, s);
    case 20: return launch_bwd<T, 20>(a, batch, t, h, num_heads, drop, s);
    case 28: return launch_bwd<T, 28>(a, batch, t, h, num_heads, drop, s);
    case 36: return launch_bwd<T, 36>(a, batch, t, h, num_heads, drop, s);
    default: return cudaErrorInvalidValue;
  }
}

// Validate the sizes and run the backward in element type `dtype` (0 = float32,
// 1 = bfloat16) on operands given as untyped pointers.
inline int attention_bwd_entry(int dtype, const void* q, const void* k, const void* v,
                               int in_stride, const void* dout, void* dq, void* dk, void* dv,
                               int out_stride, void* stats, int batch, int t, int h,
                               int num_heads, wm::Dropout drop, void* stream) {
  if (batch <= 0 || t <= 0 || num_heads <= 0 || h % num_heads != 0 || in_stride < h ||
      out_stride < h)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* st = static_cast<float*>(stats);
  if (dtype == 0) {
    using T = float;
    BwdArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), in_stride, static_cast<const T*>(dout),
                 static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), out_stride, st};
    return attention_bwd<T>(a, batch, t, h, num_heads, drop, s);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    BwdArgs<T> a{static_cast<const T*>(q), static_cast<const T*>(k),
                 static_cast<const T*>(v), in_stride, static_cast<const T*>(dout),
                 static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), out_stride, st};
    return attention_bwd<T>(a, batch, t, h, num_heads, drop, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
