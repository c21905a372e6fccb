// Multi-head self-attention on separate q, k, v for Hopper (sm_90a), training form: kernel
// B3f.
//
// Replaces the TPU kernel `_fwd_kernel` in weathermodel_tpu/ops/pallas_attention.py
// (reached through `_attention_bth`, public entry `flash_attention`; its body is
// `_fwd_body`), the attention that mini and small training run. For q, k, v [B, T, H]
// with heads sliced from the hidden dim, per (batch row, head), at the TPU kernel's
// rounding points (pallas_attention.py:158-178; rnd = round to the element type):
//   qs = rnd(q * rnd(scale))
//   s  = qs . k^T;  e = exp(s - max);  recip = 1 / sum(e)                        (fp32)
//   p  = rnd(keep ? e * (recip / (1 - rate)) : 0)      (dropout off: rnd(e * recip))
//   o  = p . v                 fp32 accumulation, written in the element type
// The dropout keep bits are those of B1's training form for the same seed and global
// (batch row, head) (attention_common.cuh); B3b regenerates them.
//
// Design: B1's attention phase (`wm::attend_rows`, attention_fwd.cuh) without the
// projection. One block per (batch row, head), 512 threads, loads that head's q (scaled
// and rounded), k and v into shared memory as fp32 [T][hd + 1], then each warp takes
// query rows. q, k and v are a base pointer each with one row stride, so the wrapper
// passes either three [B, T, H] tensors (stride H) or the column slices of a packed
// [B, T, 3H] projection (stride 3H) without copying them. Shared memory at T = 365:
// 3 x 365 x 21 + 16 x 365 floats = 115 KB at hd = 20, 185 KB at hd = 36.
//
// What bounds it on the card: scalar fp32 FMA and shared-memory loads (no tensor cores
// yet), one 512-thread block per SM. Per weight: hd FMAs for the score, an exp, a hash
// when dropout is on, and in p . V one FMA per head-dim lane with 32 - hd lanes idle at
// hd = 20. Its bound by bytes is far below that (q, k, v read once, o written once).
// Later work: both products on tensor cores, several heads per block.

#include <math.h>

#include "attention_common.cuh"
#include "attention_fwd.cuh"

namespace {

template <int HD>
size_t smem_bytes(int t) {
  return (3ull * t * (HD + 1) + (size_t)wm::kWarps * t) * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(wm::kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, int stride, T* __restrict__ out, int t, int h,
                       int num_heads, float scale, wm::Dropout drop) {
  constexpr int S = HD + 1;
  extern __shared__ float smem[];
  float* qs = smem;                  // [t][S], q * scale rounded
  float* ks = qs + (size_t)t * S;    // [t][S]
  float* vs = ks + (size_t)t * S;    // [t][S]
  float* scores = vs + (size_t)t * S;  // kWarps score rows of t

  const int head = blockIdx.x % num_heads;
  const int row_b = blockIdx.x / num_heads;
  const size_t off = (size_t)row_b * t * stride + head * HD;
  wm::load_head<T, HD, true>(q + off, qs, t, stride, wm::round_to<T>(scale));
  wm::load_head<T, HD, false>(k + off, ks, t, stride, 0.f);
  wm::load_head<T, HD, false>(v + off, vs, t, stride, 0.f);
  __syncthreads();
  wm::attend_rows<T, HD, true>(qs, ks, vs, scores, out + (size_t)row_b * t * h + head * HD,
                               t, h, scale, drop, blockIdx.x);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, int stride, void* o,
                   int batch, int t, int h, int num_heads, wm::Dropout drop,
                   cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>(t);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // 1/sqrt(hd) rounded once from double, as the JAX package's Python float is
  const float scale = (float)(1.0 / sqrt((double)HD));
  kernel<<<(unsigned)batch * num_heads, wm::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), stride,
      static_cast<T*>(o), t, h, num_heads, scale, drop);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, int stride,
                              void* o, int batch, int t, int h, int num_heads,
                              wm::Dropout drop, cudaStream_t s) {
  switch (h / num_heads) {
    case 12: return launch<T, 12>(q, k, v, stride, o, batch, t, h, num_heads, drop, s);
    case 20: return launch<T, 20>(q, k, v, stride, o, batch, t, h, num_heads, drop, s);
    case 28: return launch<T, 28>(q, k, v, stride, o, batch, t, h, num_heads, drop, s);
    case 36: return launch<T, 36>(q, k, v, stride, o, batch, t, h, num_heads, drop, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v: [batch, t, h] each with rows `stride`
// elements apart (stride >= h, unit column stride), o [batch, t, h] contiguous, all on the
// current device. Dropout on the attention weights when dropout_on != 0 (threshold,
// keep_prob and seed as in attention_common.cuh). Returns a cudaError_t (0 on success).
int wm_flash_attention(int dtype, const void* q, const void* k, const void* v, int stride,
                       void* o, int batch, int t, int h, int num_heads, int dropout_on,
                       unsigned int seed, unsigned int threshold, float keep_prob,
                       void* stream) {
  if (batch <= 0 || t <= 0 || num_heads <= 0 || h % num_heads != 0 || stride < h)
    return cudaErrorInvalidValue;
  wm::Dropout drop{dropout_on, seed, threshold, keep_prob, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(q, k, v, stride, o, batch, t, h, num_heads, drop, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(q, k, v, stride, o, batch, t, h, num_heads, drop,
                                            s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
