// Helpers shared by the attention kernels: the fused QKV attention (B1, B2) and the
// attention on separate q, k, v (B3f, B3b), forward and backward.
//
// Element types: float and __nv_bfloat16. Values are carried in fp32 and rounded to
// the element type where the TPU kernels store them in x.dtype (round_to).
//
// Dropout on the attention weights: the keep bit of weight (i, j) of head `head` of
// batch row `row` is a pure function of (seed, row * num_heads + head, i, j), so the
// backward regenerates the forward's mask, and the mask depends neither on the block
// shape nor on the launch order. weathermodel_tpu_torch/ops/attention.py computes the
// same bits with int64 tensor ops (`attention_keep_mask`): keep those in step.
//   mix32(x)       Chris Wellons' "lowbias32" integer hash
//   head key       mix32(seed ^ mix32(row * num_heads + head + 0x9e3779b9))
//   row key        mix32(head key ^ i)
//   bits           mix32(row key ^ j)
//   keep           bits < threshold, threshold = (uint32)((1 - p) * 2^32)
// (the TPU kernels' rule, pallas_attention.py:143-148, on other random bits).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wm {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Round an fp32 value to the element type and back.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t dropout_head_key(uint32_t seed, uint32_t row_head) {
  return mix32(seed ^ mix32(row_head + 0x9e3779b9u));
}

__device__ __forceinline__ uint32_t dropout_row_key(uint32_t head_key, uint32_t i) {
  return mix32(head_key ^ i);
}

__device__ __forceinline__ bool dropout_keep(uint32_t row_key, uint32_t j, uint32_t threshold) {
  return mix32(row_key ^ j) < threshold;
}

// Dropout parameters as the wrapper computes them from the rate p (in double, then
// rounded to fp32 as the JAX package's weak-typed Python floats are).
struct Dropout {
  int on;              // 0: no dropout (p == 0)
  uint32_t seed;
  uint32_t threshold;  // (uint32)((1 - p) * 2^32)
  float keep_prob;     // 1 - p        (forward: scl = recip / keep_prob)
  float inv_keep;      // 1 / (1 - p)  (backward: w * inv_keep)
};

// Copy one head's [t, HD] slice (rows `stride` elements apart, starting at src) into
// shared memory as fp32 [t][HD + 1]; kScaled stores rnd(v * scale_t).
template <typename T, int HD, bool kScaled>
__device__ __forceinline__ void load_head(const T* __restrict__ src, float* dst, int t,
                                          int stride, float scale_t) {
  for (int idx = threadIdx.x; idx < t * HD; idx += kThreads) {
    int r = idx / HD, d = idx % HD;
    float v = to_float(src[(size_t)r * stride + d]);
    if constexpr (kScaled) v = round_to<T>(v * scale_t);
    dst[r * (HD + 1) + d] = v;
  }
}

}  // namespace wm
