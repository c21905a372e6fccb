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
// Three bodies, chosen by an explicit dispatch on dtype and shape in `launch`:
//   * bf16 at a T whose q, k and v stay in a block's shared memory (up to 768 at hd 36, 1152
//     at hd 28 and 20, every T at hd 12): the wgmma body of flash_attention_hopper.cuh, the
//     backward body's query sweep on its operand layout (its note has the design).
//   * fp32 at a T whose k and v stay in a block's shared memory (up to 800 at hd 36, 1032 at
//     hd 28, 1448 at hd 20, every T at hd 12): the FFMA body of attention_ffma.cuh, a thread
//     a query row over broadcast float4 reads (its note has the design).
//   * fp32 and bf16 past those T: the scalar body below, B1's attention phase
//     (`wm::attend_rows`, attention_fwd.cuh) without the projection. One block per (batch
//     row, head), 512 threads, loads that head's q (scaled and rounded), k and v into shared
//     memory as fp32 [T][hd + 1], then each warp takes query rows. Shared memory at T = 365:
//     3 x 365 x 21 + 16 x 365 floats = 115 KB at hd = 20, 185 KB at hd = 36. Past the T
//     whose rows fit (457 at hd 36, 735 at hd 20), the block's q, k and v rows go to a device
//     workspace of the same layout (`kGlobal`, 3 t (hd + 1) floats a block) and only the
//     score rows stay in shared memory: the same code reads them through the caches, in the
//     same fmaf order. What bounds it: scalar fp32 FMA and shared-memory loads, one
//     512-thread block per SM; per weight hd FMAs for the score, an exp, a hash when dropout
//     is on, and in p . V one FMA per head-dim lane with 32 - hd lanes idle at hd = 20.
// Both take q, k and v as a base pointer each with one row stride, so the wrapper passes
// either three [B, T, H] tensors (stride H) or the column slices of a packed [B, T, 3H]
// projection (stride 3H) without copying them. T up to wm::kMaxContext (1536).

#include <math.h>

#include <type_traits>

#include "attention_common.cuh"
#include "attention_ffma.cuh"
#include "attention_fwd.cuh"
#include "flash_attention_hopper.cuh"

namespace {

// The block's dynamic shared memory: q, k, v rows and the score rows, or (kGlobal) the
// score rows alone.
template <int HD>
size_t smem_bytes(int t, bool global) {
  return ((global ? 0ull : 3ull * t * (HD + 1)) + (size_t)wm::kWarps * t) * sizeof(float);
}

// A scalar block's device workspace in bytes: 0 where its rows fit in shared memory, where
// bf16 runs the wgmma body and where fp32 runs the FFMA body.
template <typename T, int HD>
size_t workspace_bytes(int t) {
  if (std::is_same<T, __nv_bfloat16>::value && flash_fwd_hopper::takes<HD>(t)) return 0;
  if (std::is_same<T, float>::value && attn_ffma::fwd_takes<HD>(t)) return 0;
  return smem_bytes<HD>(t, false) <= wm::kSmemMax ? 0 : 3ull * t * (HD + 1) * sizeof(float);
}

template <typename T, int HD, bool kGlobal>
__global__ void __launch_bounds__(wm::kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, int stride, T* __restrict__ out, int t, int h,
                       int num_heads, float scale, wm::Dropout drop, float* ws) {
  constexpr int S = HD + 1;
  extern __shared__ float smem[];
  // [t][S] each: q * scale rounded, k, v; then kWarps score rows of t
  float* qs = kGlobal ? ws + (size_t)blockIdx.x * 3 * t * S : smem;
  float* ks = qs + (size_t)t * S;
  float* vs = ks + (size_t)t * S;
  float* scores = kGlobal ? smem : vs + (size_t)t * S;

  const int head = blockIdx.x % num_heads;
  const int row_b = blockIdx.x / num_heads;
  const size_t off = (size_t)row_b * t * stride + head * HD;
  wm::load_head<T, HD, true>(q + off, qs, t, stride, wm::round_to<T>(scale));
  wm::load_head<T, HD, false>(k + off, ks, t, stride, 0.f);
  wm::load_head<T, HD, false>(v + off, vs, t, stride, 0.f);
  __syncthreads();
  wm::attend_rows<T, HD>(qs, ks, vs, scores, out + (size_t)row_b * t * h + head * HD, t, h,
                         drop, blockIdx.x);
}

template <typename T, int HD, bool kGlobal>
cudaError_t launch_body(const void* q, const void* k, const void* v, int stride, void* o,
                        int batch, int t, int h, int num_heads, wm::Dropout drop, void* ws,
                        cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, HD, kGlobal>;
  const size_t smem = smem_bytes<HD>(t, kGlobal);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // 1/sqrt(hd) rounded once from double, as the JAX package's Python float is
  const float scale = (float)(1.0 / sqrt((double)HD));
  kernel<<<(unsigned)batch * num_heads, wm::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), stride,
      static_cast<T*>(o), t, h, num_heads, scale, drop, static_cast<float*>(ws));
  return cudaGetLastError();
}

// bf16 B3f on the wgmma body.
template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, int stride, void* o,
                         int batch, int t, int h, int num_heads, wm::Dropout drop,
                         cudaStream_t stream) {
  using B = __nv_bfloat16;
  const flash_fwd_hopper::Params p{static_cast<const B*>(q),
                                   static_cast<const B*>(k),
                                   static_cast<const B*>(v),
                                   stride,
                                   static_cast<B*>(o),
                                   t,
                                   h,
                                   num_heads,
                                   0,
                                   (float)(1.0 / sqrt((double)HD)),  // as the scalar body's
                                   drop};
  return flash_fwd_hopper::launch<HD>(p, batch, stream);
}

// bfloat16 at a T whose operands stay in shared memory runs the wgmma body, float32 at a T
// whose k and v do the FFMA body; otherwise the scalar body, its rows in shared memory where
// they fit, else in the workspace.
template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, int stride, void* o,
                   int batch, int t, int h, int num_heads, wm::Dropout drop, void* ws,
                   cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (flash_fwd_hopper::takes<HD>(t))
      return launch_wgmma<HD>(q, k, v, stride, o, batch, t, h, num_heads, drop, stream);
  } else {
    if (attn_ffma::fwd_takes<HD>(t)) {
      const attn_ffma::FwdParams p{static_cast<const float*>(q),
                                   static_cast<const float*>(k),
                                   static_cast<const float*>(v),
                                   stride,
                                   static_cast<float*>(o),
                                   t,
                                   h,
                                   num_heads,
                                   (float)(1.0 / sqrt((double)HD)),  // as the scalar body's
                                   drop};
      return attn_ffma::launch_fwd<HD>(p, batch, stream);
    }
  }
  if (workspace_bytes<T, HD>(t) == 0)
    return launch_body<T, HD, false>(q, k, v, stride, o, batch, t, h, num_heads, drop, ws,
                                     stream);
  if (ws == nullptr) return cudaErrorInvalidValue;
  return launch_body<T, HD, true>(q, k, v, stride, o, batch, t, h, num_heads, drop, ws,
                                  stream);
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, int stride,
                              void* o, int batch, int t, int h, int num_heads,
                              wm::Dropout drop, void* ws, cudaStream_t s) {
  switch (h / num_heads) {
    case 12: return launch<T, 12>(q, k, v, stride, o, batch, t, h, num_heads, drop, ws, s);
    case 20: return launch<T, 20>(q, k, v, stride, o, batch, t, h, num_heads, drop, ws, s);
    case 28: return launch<T, 28>(q, k, v, stride, o, batch, t, h, num_heads, drop, ws, s);
    case 36: return launch<T, 36>(q, k, v, stride, o, batch, t, h, num_heads, drop, ws, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q, k, v: [batch, t, h] each with rows `stride`
// elements apart (stride >= h, unit column stride), o [batch, t, h] contiguous, all on the
// current device; ws: wm_flash_attention_workspace(dtype, head_dim, t) bytes for each of
// the batch x num_heads blocks (null where that is 0). Where bf16 runs the wgmma body it
// needs h a multiple of 8, stride a multiple of 4 and 8-byte aligned bases (an error
// otherwise). Dropout on the attention weights when dropout_on != 0 (threshold, keep_prob
// and seed as in attention_common.cuh). T up to wm::kMaxContext. Returns a cudaError_t (0
// on success).
int wm_flash_attention(int dtype, const void* q, const void* k, const void* v, int stride,
                       void* o, void* ws, int batch, int t, int h, int num_heads,
                       int dropout_on, unsigned int seed, unsigned int threshold,
                       float keep_prob, void* stream) {
  if (batch <= 0 || t <= 0 || t > wm::kMaxContext || num_heads <= 0 || h % num_heads != 0 ||
      stride < h)
    return cudaErrorInvalidValue;
  wm::Dropout drop{dropout_on, seed, threshold, keep_prob, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float>(q, k, v, stride, o, batch, t, h, num_heads, drop, ws, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(q, k, v, stride, o, batch, t, h, num_heads, drop,
                                            ws, s);
  return cudaErrorInvalidValue;
}

// The device workspace kernel B3f needs for each (batch row, head) block at (dtype,
// head_dim, t), in bytes (its rows are fp32 in both dtypes); 0 where the rows fit in shared
// memory or bf16 runs the wgmma body or fp32 the FFMA body, -1 where the kernel does not take
// (head_dim, t).
long long wm_flash_attention_workspace(int dtype, int head_dim, int t) {
  if (t <= 0 || t > wm::kMaxContext || (dtype != 0 && dtype != 1)) return -1;
  switch (head_dim * 2 + dtype) {
    case 24: return (long long)workspace_bytes<float, 12>(t);
    case 25: return (long long)workspace_bytes<__nv_bfloat16, 12>(t);
    case 40: return (long long)workspace_bytes<float, 20>(t);
    case 41: return (long long)workspace_bytes<__nv_bfloat16, 20>(t);
    case 56: return (long long)workspace_bytes<float, 28>(t);
    case 57: return (long long)workspace_bytes<__nv_bfloat16, 28>(t);
    case 72: return (long long)workspace_bytes<float, 36>(t);
    case 73: return (long long)workspace_bytes<__nv_bfloat16, 36>(t);
    default: return -1;
  }
}

// The dynamic shared memory a block of bf16 B3f's wgmma body takes at (head_dim, t), in
// bytes; 0 where bf16 runs the scalar body instead.
int wm_flash_attention_wgmma_smem(int head_dim, int t) {
  return flash_fwd_hopper::smem_bytes(head_dim, t);
}

// The dynamic shared memory a block of fp32 B3f's FFMA body takes at (head_dim, t), in bytes;
// 0 where fp32 runs the scalar body instead.
int wm_flash_attention_ffma_smem(int head_dim, int t) {
  return attn_ffma::fwd_smem_bytes(head_dim, t);
}

}  // extern "C"
