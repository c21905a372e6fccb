// Backward of the attention on separate q, k, v for Hopper (sm_90a): kernel B3b.
//
// Replaces the TPU kernel `_bwd_kernel` in weathermodel_tpu/ops/pallas_attention.py (the
// backward rule `_attention_bwd` of `flash_attention`'s custom VJP; its math is
// `_bwd_head_math`). For one (batch row, head), q, k, v and dO [T, hd] are the head's
// slices of q, k, v and do [B, T, H]; dq, dk and dv go to the same slices of three
// [B, T, H] outputs. The softmax and the dropout mask of the forward (B3f,
// flash_attention.cu) are recomputed from q, k and the seed, not stored.
//
// The math, the two-pass design, its shared memory (107 and 113 KB at T = 365, hd = 20)
// and what bounds it are those of the attention backward this kernel shares with B2
// (attention_bwd.cuh): here q, k and v have one row stride (H for three tensors, 3H for
// the column slices of a packed projection) and dq, dk, dv a row stride of H.

#include "attention_bwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v [batch, t, h] with rows `stride` elements
// apart (unit column stride); dout, dq, dk, dv [batch, t, h] contiguous (dq, dk, dv
// written); stats [batch, num_heads, 3, t] fp32 scratch; all on the current device.
// Dropout as in attention_common.cuh, with the forward's seed. Returns a cudaError_t
// (0 on success).
int wm_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                           int stride, const void* dout, void* dq, void* dk, void* dv,
                           void* stats, int batch, int t, int h, int num_heads,
                           int dropout_on, unsigned int seed, unsigned int threshold,
                           float inv_keep, void* stream) {
  wm::Dropout drop{dropout_on, seed, threshold, 0.f, inv_keep};
  return attention_bwd_entry(dtype, q, k, v, stride, dout, dq, dk, dv, h, stats, batch, t,
                             h, num_heads, drop, stream);
}

}  // extern "C"
