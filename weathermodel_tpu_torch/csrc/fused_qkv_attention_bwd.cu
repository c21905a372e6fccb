// Backward of the fused QKV attention for Hopper (sm_90a): packed dqkv from the packed
// qkv residual and dO.
//
// Replaces the TPU kernel `_bwd_kernel_qkv` in weathermodel_tpu/ops/pallas_attention.py
// (the backward rule `_attention_fused_bwd` of `flash_attention_fused`; its math is
// `_bwd_head_math`). For one (batch row, head), q, k, v [T, hd] are the head's slices of
// qkv [B, T, 3H] and dO [T, hd] the slice of do [B, T, H]; dq, dk and dv go to the same
// slices of dqkv [B, T, 3H].
//
// The math, the two-pass design, its shared memory and what bounds it are those of the
// attention backward this kernel shares with B3b (attention_bwd.cuh): here each operand
// is the packed buffer at column offset 0, H or 2H with a row stride of 3H.

#include "attention_bwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qkv [batch, t, 3h] (the training forward's residual),
// dout [batch, t, h], dqkv [batch, t, 3h] (written), stats [batch, num_heads, 3, t] fp32
// scratch; all contiguous on the current device. Dropout as in attention_common.cuh, with
// the forward's seed. Returns a cudaError_t (0 on success).
int wm_fused_qkv_attention_bwd(int dtype, const void* qkv, const void* dout, void* dqkv,
                               void* stats, int batch, int t, int h, int num_heads,
                               int dropout_on, unsigned int seed, unsigned int threshold,
                               float inv_keep, void* stream) {
  const size_t col = (size_t)h * (dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16));
  const char* in = static_cast<const char*>(qkv);
  char* out = static_cast<char*>(dqkv);
  wm::Dropout drop{dropout_on, seed, threshold, 0.f, inv_keep};
  return attention_bwd_entry(dtype, in, in + col, in + 2 * col, 3 * h, dout, out, out + col,
                             out + 2 * col, 3 * h, stats, batch, t, h, num_heads, drop,
                             stream);
}

}  // extern "C"
