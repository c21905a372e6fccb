// The attention phase shared by the scalar forward kernels: B1 (csrc/fused_qkv_attention.cu,
// float32) after its in-kernel projection, and B3f (csrc/flash_attention.cu) after loading
// q, k and v. One block holds one (batch row, head)'s q (already scaled and rounded), k and
// v as fp32 [t][HD + 1], in shared memory or, past the T that fits, in a device workspace;
// each warp takes query rows: scores against all of K (lanes over keys, the query row in
// registers), a row max and sum by warp shuffles, the weights (with the dropout keep bits)
// back into the warp's score row, then p . V with lanes over the head dim.
//
// One arithmetic for every form, the TPU kernels' rounding (pallas_attention.py:158-178):
//   s = qs . k^T,  qs = rnd(q rnd(scale))
//   p = rnd(keep ? e * (recip / (1 - rate)) : 0)     dropout on (the training form)
//   p = rnd(e * recip)                               dropout off (and the eval form)
//   o = p . v accumulated in fp32, written in the element type.

#pragma once

#include <math.h>

#include "attention_common.cuh"

namespace wm {

// scores: kWarps * t floats of shared memory; ob: the output of this (row, head), rows h
// elements apart; row_head = batch row * num_heads + head (the dropout key).
template <typename T, int HD>
__device__ __forceinline__ void attend_rows(const float* qs, const float* ks, const float* vs,
                                            float* scores, T* __restrict__ ob, int t, int h,
                                            Dropout drop, uint32_t row_head) {
  constexpr int S = HD + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sc = scores + (size_t)warp * t;  // this warp's score row
  const uint32_t head_key = drop.on ? dropout_head_key(drop.seed, row_head) : 0u;

  for (int i = warp; i < t; i += kWarps) {
    float q[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) q[d] = qs[i * S + d];

    float m = -INFINITY;
    for (int k = lane; k < t; k += 32) {
      const float* kr = ks + k * S;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) s = fmaf(q[d], kr[d], s);
      sc[k] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);

    float sum = 0.f;
    for (int k = lane; k < t; k += 32) {
      float e = expf(sc[k] - m);
      sc[k] = e;
      sum += e;
    }
    const float recip = 1.f / warp_sum(sum);
    // the weights, dropped and rounded, back into the score row
    if (drop.on) {
      const float scl = recip / drop.keep_prob;
      const uint32_t row_key = dropout_row_key(head_key, i);
      for (int k = lane; k < t; k += 32)
        sc[k] = dropout_keep(row_key, k, drop.threshold) ? round_to<T>(sc[k] * scl) : 0.f;
    } else {
      for (int k = lane; k < t; k += 32) sc[k] = round_to<T>(sc[k] * recip);
    }
    __syncwarp();

    float acc0 = 0.f, acc1 = 0.f;
    const int d0 = lane, d1 = lane + 32;
    for (int k = 0; k < t; ++k) {
      const float p = sc[k];
      const float* vr = vs + k * S;
      if (d0 < HD) acc0 = fmaf(p, vr[d0], acc0);
      if (d1 < HD) acc1 = fmaf(p, vr[d1], acc1);
    }
    if (d0 < HD) ob[(size_t)i * h + d0] = from_float<T>(acc0);
    if (d1 < HD) ob[(size_t)i * h + d1] = from_float<T>(acc1);
    __syncwarp();  // sc is rewritten by the next row
  }
}

}  // namespace wm
