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
// Design. bfloat16 runs ffn_hopper.cuh's body: 64-row blocks of two consumer warpgroups,
// wgmma fed by a TMA ring of W1 and W2 slabs per warpgroup, x resident in shared memory, h
// written by TMA store from its swizzled tile. What bounds it on the card: 4 M H F
// operations (558 GFLOP at the bench microbatch, M = 105,120, H = 576, F = 2304: 0.564 ms
// at the bf16 tensor-core peak) against 242 MB of x and f (and 484 MB of h) in bf16, so
// operations; the weights' L2 reads fall from 17.4 GB a call (32-row blocks) to 8.7 GB
// (64-row blocks). float32 stays on ffn_common.cuh's row kernel (32 rows x all H columns a
// block, FMA pipes). The TPU pads M to its 256-row block; here TMA clips the ragged edges.
// ptxas (-Xptxas -v, chip_smoke.py's build phase, sm_90a, CUDA 12.8), kModeFfn by kAtoms:
// 1: 104 registers, 4: 150, 6: 186, 9: 232, 10: 254, no spills; dynamic shared memory at
// H = 48, 200, 336, 576, 640: 92,232, 116,808, 133,192, 165,960, 182,344 bytes a block.

#include "ffn_common.cuh"
#include "ffn_hopper.cuh"

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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return ffn_hopper::launch<ffn::kModeFfn>(a, st);
  if (dtype == 0) return ffn::launch_rows_fp32<ffn::kModeFfn>(a, st);
  return cudaErrorInvalidValue;
}

// The dynamic shared memory, in bytes, of the bfloat16 body's block at width h (-1 past
// 640), for reports.
int wm_ffn_wgmma_smem(int h) {
  return h > 0 && h <= ffn_hopper::kMaxH ? ffn_hopper::smem_bytes(h) : -1;
}

}  // extern "C"
