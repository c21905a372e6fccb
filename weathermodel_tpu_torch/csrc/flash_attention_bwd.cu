// Backward of the attention on separate q, k, v for Hopper (sm_90a): kernel B3b.
//
// Replaces the TPU kernel `_bwd_kernel` in weathermodel_tpu/ops/pallas_attention.py (the
// backward rule `_attention_bwd` of `flash_attention`'s custom VJP; its math is
// `_bwd_head_math`). For one (batch row, head), q, k, v and dO [T, hd] are the head's
// slices of q, k, v and do [B, T, H]; dq, dk and dv go to the same slices of three
// [B, T, H] outputs. The softmax and the dropout mask of the forward (B3f,
// flash_attention.cu) are recomputed from q, k and the seed, not stored.
//
// The math, the two bodies and what bounds them are those of the attention backward this
// kernel shares with B2 (attention_bwd.cuh): bf16 runs the wgmma body of
// attention_bwd_hopper.cuh (105,472 B of shared memory a block at T = 365, hd = 20), float32
// the FFMA body of attention_ffma.cuh (two passes of 58,880 and 64,768 B a block there), and
// both past the T those bodies keep resident the two scalar passes (107 and 113 KB at
// T = 365, hd = 20). Here q, k and v have one row stride (H for three tensors, 3H for the
// column slices of a packed projection) and dq, dk, dv a row stride of H.

#include "attention_bwd.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v [batch, t, h] with rows `stride` elements
// apart (unit column stride); dout, dq, dk, dv [batch, t, h] contiguous (dq, dk, dv
// written); stats [batch, num_heads, 3, t] fp32 scratch; ws wm_attention_bwd_workspace(
// head_dim, t) bytes for each of the batch x num_heads blocks (null where that is 0); all on
// the current device. Dropout as in attention_common.cuh, with the forward's seed. T up to
// wm::kMaxContext. Returns a cudaError_t (0 on success).
int wm_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                           int stride, const void* dout, void* dq, void* dk, void* dv,
                           void* stats, void* ws, int batch, int t, int h, int num_heads,
                           int dropout_on, unsigned int seed, unsigned int threshold,
                           float inv_keep, void* stream) {
  wm::Dropout drop{dropout_on, seed, threshold, 0.f, inv_keep};
  return attention_bwd_entry(dtype, q, k, v, stride, dout, dq, dk, dv, h, stats, ws, batch,
                             t, h, num_heads, drop, stream);
}

// The device workspace B2 and B3b need for each (batch row, head) block at (head_dim, t),
// in bytes: 0 where their rows fit in shared memory, -1 where they do not take it.
long long wm_attention_bwd_workspace(int head_dim, int t) {
  return attention_bwd_workspace(head_dim, t);
}

// The dynamic shared memory a block of the bf16 wgmma body of B2 and B3b takes at
// (head_dim, t), in bytes; 0 where bf16 runs the scalar passes instead.
int wm_attention_bwd_wgmma_smem(int head_dim, int t) {
  return attn_bwd_hopper::smem_bytes(head_dim, t);
}

// The dynamic shared memory a block of the fp32 FFMA body of B2 and B3b takes at (head_dim,
// t), in bytes (the larger of its two passes'); 0 where fp32 runs the scalar passes instead.
int wm_attention_bwd_ffma_smem(int head_dim, int t) {
  return attn_ffma::bwd_smem_bytes(head_dim, t);
}

}  // extern "C"
