// Fused FFN forward for Hopper (sm_90a): kernel B7.
//
// Replaces the TPU kernel `_kernel` in weathermodel_tpu/ops/pallas_ffn2.py (reached through
// `_run_fwd` and `fused_ffn`, the JAX layer's ffn_impl="pallas2"). For rows x [M, H],
// W1 [H, F], W2 [F, H] and fp32 biases:
//   h = dropout1(relu(x . W1 + b1))     rounded once to x's dtype
//   f = dropout2(h . W2 + b2)           rounded once to x's dtype
// with fp32 accumulation; a kept value is scaled by 1/(1-p) (a multiply, as the TPU kernel).
// h is written only when the caller needs it (the backward's residual): without it the
// [M, F] hidden never leaves the block's shared memory. The backward is plain ops in the
// port, as in the JAX package: it reads the masks back from the zeros of f and h.
//
// Design: ffn_common.cuh's row-block kernel (32 rows x all H columns per block, the hidden
// in 128-column chunks). The TPU pads M to its 256-row block; here the block bound-checks M,
// H and F. What bounds it on the card: 4 M H F operations (558 GFLOP at the bench
// microbatch, M = 105,120, H = 576, F = 2304: 0.56 ms at the bf16 tensor-core peak) against
// 242 MB of x and f (and 484 MB of h) in bf16, so operations. This first version feeds the
// tensor cores through WMMA from one shared-memory stage and re-reads both weight matrices
// from L2 for every 32 rows; later work: a wgmma/TMA pipeline and taller row blocks.

#include "ffn_common.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w1, w2, f, h); b1, b2 float32. x [m, h], w1 [h, f],
// w2 [f, h], f_out [m, h], h_out [m, f] or null. Contiguous, on the current device.
// dropout_on: keep iff the FFN hash of (seed, row, col) < threshold (seed1 for the hidden,
// seed2 for the output), kept values times inv_keep. Returns a cudaError_t (0 on success).
int wm_fused_ffn(int dtype, const void* x, const void* w1, const void* b1, const void* w2,
                 const void* b2, void* f_out, void* h_out, int m, int h, int f,
                 int dropout_on, unsigned seed1, unsigned seed2, unsigned threshold,
                 float inv_keep, void* stream) {
  ffn::RowsArgs a = {};
  a.x = x;
  a.w1 = w1;
  a.b1 = static_cast<const float*>(b1);
  a.w2 = w2;
  a.b2 = static_cast<const float*>(b2);
  a.out = f_out;
  a.hidden = h_out;
  a.m = m;
  a.h = h;
  a.f = f;
  a.on = dropout_on;
  a.seed1 = seed1;
  a.seed2 = seed2;
  a.threshold = threshold;
  a.scale = inv_keep;
  return ffn::launch_rows_dtype<ffn::kModeFfn>(dtype, a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
