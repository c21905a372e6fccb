// Fused FFN + residual + LayerNorm forward for Hopper (sm_90a): kernel B6f.
//
// Replaces the TPU kernel `_ffn_fwd_kernel` in weathermodel_tpu/ops/pallas_ffn.py (reached
// through `_ffn_ln` and `fused_ffn_ln`, the JAX layer's ffn_impl="pallas"). For x [M, H]
// (the flattened [B, T, H]), W1 [H, F], W2 [F, H] and fp32 b1, b2, LN scale and bias:
//   h   = dropout1(relu(x . W1 + b1))          rounded once to x's dtype
//   f   = dropout2(h . W2 + b2)                fp32
//   out = LN(x + f) . scale + bias             fp32 statistics, eps 1e-5, rounded once
// with fp32 accumulation; a kept value is divided by (1 - p), as the TPU forward does.
//
// Design: ffn_common.cuh's row-block kernel. LayerNorm needs every column of a row, so a
// block owns 32 whole rows (the TPU kernel owns whole batch items); its [32, H] fp32
// accumulators are finished in shared memory, where a warp per row takes the statistics.
// The hidden never leaves the block. The TPU pads T to 128 and B to its block; here the
// block bound-checks M, H and F, so nothing is padded. What bounds it on the card: 4 M H F
// operations (558 GFLOP at the bench microbatch, 0.56 ms at the bf16 peak) against 242 MB
// of x and out in bf16: operations. Later work as for B7 (fused_ffn.cu).

#include "ffn_common.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w1, w2, out); b1, b2, ln_scale, ln_bias float32.
// x [m, h], w1 [h, f], w2 [f, h], out [m, h]. Contiguous, on the current device. dropout_on:
// keep iff the FFN hash of (seed, row, col) < threshold (seed1 hidden, seed2 output), kept
// values divided by keep_prob. Returns a cudaError_t (0 on success).
int wm_fused_ffn_ln(int dtype, const void* x, const void* w1, const void* b1, const void* w2,
                    const void* b2, const void* ln_scale, const void* ln_bias, void* out, int m,
                    int h, int f, int dropout_on, unsigned seed1, unsigned seed2,
                    unsigned threshold, float keep_prob, void* stream) {
  ffn::RowsArgs a = {};
  a.x = x;
  a.w1 = w1;
  a.b1 = static_cast<const float*>(b1);
  a.w2 = w2;
  a.b2 = static_cast<const float*>(b2);
  a.ls = static_cast<const float*>(ln_scale);
  a.lb = static_cast<const float*>(ln_bias);
  a.out = out;
  a.m = m;
  a.h = h;
  a.f = f;
  a.on = dropout_on;
  a.seed1 = seed1;
  a.seed2 = seed2;
  a.threshold = threshold;
  a.scale = keep_prob;
  return ffn::launch_rows_dtype<ffn::kModeLn>(dtype, a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
