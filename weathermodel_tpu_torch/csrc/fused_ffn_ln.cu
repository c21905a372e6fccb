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
// Design. LayerNorm needs every column of a row, so a block owns whole rows (the TPU kernel
// owns whole batch items). bfloat16 runs ffn_hopper.cuh's body: 64 rows a block, two
// consumer warpgroups each with its own TMA ring of W1 and W2 slabs feeding wgmma, x
// resident in shared memory as the first product's A and the residual, the [64, H] fp32
// accumulators in the two warpgroups' registers, which exchange row sums through shared
// memory for the statistics. float32 stays on ffn_common.cuh's row kernel. The hidden never
// leaves the block. Nothing is padded: TMA zero-fills reads past M, H and F and clips
// writes. What bounds it on the card: 4 M H F operations (558 GFLOP at the bench
// microbatch, 0.564 ms at the bf16 peak) against 242 MB of x and out in bf16: operations;
// the weights' L2 reads fall from 17.4 GB a call (32-row blocks) to 8.7 GB (64-row
// blocks). ptxas (-Xptxas -v, chip_smoke.py's build phase, sm_90a, CUDA 12.8), kModeLn by
// kAtoms: 1: 105 registers, 4: 158, 6: 192, no spills; 9: 255 registers and 140 bytes of
// spill stores and loads; 10: 255
// and 540 / 532; shared memory as fused_ffn.cu's (165,960 bytes a block at H = 576).

#include "ffn_common.cuh"
#include "ffn_hopper.cuh"

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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return ffn_hopper::launch<ffn::kModeLn>(a, st);
  if (dtype == 0) return ffn::launch_rows_fp32<ffn::kModeLn>(a, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
