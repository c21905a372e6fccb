// Backward of the fused QKV attention for Hopper (sm_90a): packed dqkv from the packed
// qkv residual and dO.
//
// Replaces the TPU kernel `_bwd_kernel_qkv` in weathermodel_tpu/ops/pallas_attention.py
// (the backward rule `_attention_fused_bwd` of `flash_attention_fused`; its math is
// `_bwd_head_math`). For one (batch row, head), with q, k, v [T, hd] the head's slices
// of qkv [B, T, 3H] and dO [T, hd] the slice of do [B, T, H], at the TPU kernel's
// rounding points (rnd = round to the element type):
//   qs  = rnd(q * rnd(scale))
//   s   = qs . k^T;  e = exp(s - max);  recip = 1 / sum(e);  w = e * recip     (fp32)
//   wd  = rnd(keep ? w * inv_keep : 0)       (dropout off: rnd(w))
//   dv  = wd^T . dO
//   dwd = dO . v^T;  dw = keep ? dwd * inv_keep : 0   (dropout off: dwd)
//   rowsum = sum_j dw * w;  ds = rnd(w * (dw - rowsum))
//   dq  = (ds . k) * scale;  dk = ds^T . qs
// all accumulated in fp32 and written to dqkv [B, T, 3H] in the element type. The
// dropout keep bits are regenerated from the forward's seed (attention_common.cuh), not
// stored.
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
// pass B 2 x 365 x 37 + 4 x 365 + 2 x 16 x 365 words = 161 KB; the same in both element
// types, since everything in shared memory is fp32.
//
// What bounds it on the card: scalar fp32 FMA and shared-memory loads, as the forward
// (no tensor cores yet): 5 products of B x nh x T^2 x hd MACs plus the wasted lanes of
// the head-dim loops (hd = 36 over 2 x 32 lanes). The two passes each recompute the
// scores. Later work: the four T x T x hd products on tensor cores, one pass with
// dk/dv accumulated across query tiles.

#include <math.h>

#include "attention_common.cuh"

namespace {

using wm::Dropout;
using wm::from_float;
using wm::kThreads;
using wm::kWarps;
using wm::round_to;
using wm::to_float;
using wm::warp_max;
using wm::warp_sum;

// shared-memory row stride HD + 1 words (odd for the even head dims)
template <int HD>
size_t smem_dq_bytes(int t) {
  return (2ull * t * (HD + 1) + 2ull * kWarps * t) * sizeof(float);
}

template <int HD>
size_t smem_dkdv_bytes(int t) {
  return (2ull * t * (HD + 1) + 4ull * t + 2ull * kWarps * t) * sizeof(float);
}

// Copy one head's [t, HD] slice (columns offset..offset+HD of rows of `stride`
// elements) into shared memory as fp32 [t][HD + 1]; kScaled stores rnd(v * scale_t).
template <typename T, int HD, bool kScaled>
__device__ void load_head(const T* __restrict__ src, float* dst, int t, int stride,
                          int offset, float scale_t) {
  for (int idx = threadIdx.x; idx < t * HD; idx += kThreads) {
    int r = idx / HD, d = idx % HD;
    float v = to_float(src[(size_t)r * stride + offset + d]);
    if constexpr (kScaled) v = round_to<T>(v * scale_t);
    dst[r * (HD + 1) + d] = v;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dqkv,
              float* __restrict__ stats, int t, int h, int num_heads, float scale,
              Dropout drop) {
  constexpr int S = HD + 1;
  extern __shared__ float smem[];
  float* ks = smem;                          // [t][S]
  float* vs = ks + (size_t)t * S;            // [t][S]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* srow = vs + (size_t)t * S + (size_t)warp * 2 * t;  // s -> e -> w -> ds
  float* dwrow = srow + t;                                  // dwd -> dw

  const int head = blockIdx.x % num_heads;
  const int row_b = blockIdx.x / num_heads;
  const T* qkv_b = qkv + (size_t)row_b * t * 3 * h;
  const T* do_b = dout + (size_t)row_b * t * h;
  T* dq_b = dqkv + (size_t)row_b * t * 3 * h + head * HD;
  float* st = stats + (size_t)blockIdx.x * 3 * t;  // [3][t]: max, recip, rowsum
  const float scale_t = round_to<T>(scale);
  const uint32_t head_key = wm::dropout_head_key(drop.seed, blockIdx.x);

  load_head<T, HD, false>(qkv_b, ks, t, 3 * h, h + head * HD, 0.f);
  load_head<T, HD, false>(qkv_b, vs, t, 3 * h, 2 * h + head * HD, 0.f);
  __syncthreads();

  for (int i = warp; i < t; i += kWarps) {
    float q[HD], g[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      q[d] = round_to<T>(to_float(qkv_b[(size_t)i * 3 * h + head * HD + d]) * scale_t);
      g[d] = to_float(do_b[(size_t)i * h + head * HD + d]);
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

    const uint32_t row_key = wm::dropout_row_key(head_key, i);
    float part = 0.f;
    for (int j = lane; j < t; j += 32) {
      float w = srow[j] * recip;
      float dw = dwrow[j];
      if (drop.on) dw = wm::dropout_keep(row_key, j, drop.threshold) ? dw * drop.inv_keep : 0.f;
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
    if (d0 < HD) dq_b[(size_t)i * 3 * h + d0] = from_float<T>(acc0 * scale);
    if (d1 < HD) dq_b[(size_t)i * 3 * h + d1] = from_float<T>(acc1 * scale);
    if (lane == 0) {
      st[i] = m;
      st[t + i] = recip;
      st[2 * t + i] = rowsum;
    }
    __syncwarp();  // the rows are rewritten by the next query row
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dqkv,
                const float* __restrict__ stats, int t, int h, int num_heads, float scale,
                Dropout drop) {
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
  const T* qkv_b = qkv + (size_t)row_b * t * 3 * h;
  const T* do_b = dout + (size_t)row_b * t * h;
  T* dk_b = dqkv + (size_t)row_b * t * 3 * h + h + head * HD;
  T* dv_b = dk_b + h;
  const float* st = stats + (size_t)blockIdx.x * 3 * t;
  const float scale_t = round_to<T>(scale);
  const uint32_t head_key = wm::dropout_head_key(drop.seed, blockIdx.x);

  load_head<T, HD, true>(qkv_b, qs, t, 3 * h, head * HD, scale_t);
  load_head<T, HD, false>(do_b, gs, t, h, head * HD, 0.f);
  for (int i = threadIdx.x; i < t; i += kThreads) {
    mx[i] = st[i];
    rc[i] = st[t + i];
    rsum[i] = st[2 * t + i];
    rkey[i] = wm::dropout_row_key(head_key, i);
  }
  __syncthreads();

  for (int j = warp; j < t; j += kWarps) {
    float k[HD], v[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      k[d] = to_float(qkv_b[(size_t)j * 3 * h + h + head * HD + d]);
      v[d] = to_float(qkv_b[(size_t)j * 3 * h + 2 * h + head * HD + d]);
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
        const bool keep = wm::dropout_keep(rkey[i], j, drop.threshold);
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
      dk_b[(size_t)j * 3 * h + d0] = from_float<T>(dk0);
      dv_b[(size_t)j * 3 * h + d0] = from_float<T>(dv0);
    }
    if (d1 < HD) {
      dk_b[(size_t)j * 3 * h + d1] = from_float<T>(dk1);
      dv_b[(size_t)j * 3 * h + d1] = from_float<T>(dv1);
    }
    __syncwarp();  // the rows are rewritten by the next key column
  }
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* qkv, const void* dout, void* dqkv, void* stats, int batch,
                       int t, int h, int num_heads, Dropout drop, cudaStream_t stream) {
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
  dq<<<grid, kThreads, smem_a, stream>>>(static_cast<const T*>(qkv),
                                         static_cast<const T*>(dout), static_cast<T*>(dqkv),
                                         static_cast<float*>(stats), t, h, num_heads, scale,
                                         drop);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv<<<grid, kThreads, smem_b, stream>>>(static_cast<const T*>(qkv),
                                           static_cast<const T*>(dout), static_cast<T*>(dqkv),
                                           static_cast<const float*>(stats), t, h, num_heads,
                                           scale, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* qkv, const void* dout, void* dqkv, void* stats,
                              int batch, int t, int h, int num_heads, Dropout drop,
                              cudaStream_t s) {
  switch (h / num_heads) {
    case 12: return launch_bwd<T, 12>(qkv, dout, dqkv, stats, batch, t, h, num_heads, drop, s);
    case 20: return launch_bwd<T, 20>(qkv, dout, dqkv, stats, batch, t, h, num_heads, drop, s);
    case 28: return launch_bwd<T, 28>(qkv, dout, dqkv, stats, batch, t, h, num_heads, drop, s);
    case 36: return launch_bwd<T, 36>(qkv, dout, dqkv, stats, batch, t, h, num_heads, drop, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qkv [batch, t, 3h] (the training forward's residual),
// dout [batch, t, h], dqkv [batch, t, 3h] (written), stats [batch, num_heads, 3, t] fp32
// scratch; all contiguous on the current device. Dropout as in attention_common.cuh, with
// the forward's seed. Returns a cudaError_t (0 on success).
int wm_fused_qkv_attention_bwd(int dtype, const void* qkv, const void* dout, void* dqkv,
                               void* stats, int batch, int t, int h, int num_heads,
                               int dropout_on, unsigned int seed, unsigned int threshold,
                               float inv_keep, void* stream) {
  if (batch <= 0 || t <= 0 || num_heads <= 0 || h % num_heads != 0)
    return cudaErrorInvalidValue;
  Dropout drop{dropout_on, seed, threshold, 0.f, inv_keep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(qkv, dout, dqkv, stats, batch, t, h, num_heads, drop, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(qkv, dout, dqkv, stats, batch, t, h, num_heads,
                                            drop, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
