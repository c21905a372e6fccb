// Fused QKV projection + multi-head self-attention + out-projection for Hopper (sm_90a):
// kernel B5, the inference-only form of the attention sublayer.
//
// Replaces the TPU kernel `_fused_fwd_outproj_kernel` in
// weathermodel_tpu/ops/pallas_attention.py (reached through `_fused_outproj_call`, public
// entry `flash_attention_fused_outproj`). For x [B, T, H], w [3H, H], b [3H], wo [H, H]
// (torch [out, in] layout, as `self_attn.out_proj.weight`) and bo [H]:
//   o = attention(x . w^T + b)   kernel B1's forward (fused_qkv_attention.cu): the eval
//                                form with dropout off, the training form's rounding and
//                                keep-mask with dropout on; o rounded to the element
//                                type, as the TPU kernel's VMEM scratch of x.dtype holds it
//   y = o . wo^T + bo            fp32 accumulation, the bias added in fp32, rounded once
//                                to the element type (pallas_attention.py:273-278)
// Not differentiable: there is no backward, and the wrapper refuses a tensor that needs a
// gradient.
//
// Design: two phases, launched one after the other on the caller's stream.
//   Phase 1 is B1's kernel without its qkv output (`wm::fused_qkv_attention_o`): one
//   block per (batch row, head) projects that head's q, k and v into shared memory and
//   runs the attention body shared with B3f (`wm::attend_rows`, attention_fwd.cuh). It
//   writes o in the element type into a workspace [B, T, H] that the wrapper allocates.
//   Phase 2 is the out-projection, one 128 x 128 tile of y per block of 256 threads on the
//   tile code of the grouped matmul (gmm_common.cuh, one group): o's rows and wo's rows
//   (y's columns) are staged in 32-deep slabs, multiplied on the tensor cores through
//   WMMA in bf16 and on the FMA pipes in fp32, and the epilogue adds bo and rounds once.
// Every element of y needs o from all heads of its row, and phase 1's grid gives each
// block one head, so the out-projection cannot be an epilogue of phase 1's blocks. The
// round trip of o through device memory (2 x 108 MB in bf16 at B = 256, T = 365,
// H = 576) costs about 0.06 ms at the memory rate, next to ~19 ms of phase 1.
//
// Later work: keep o on chip. One way is a thread-block cluster of num_heads blocks per
// batch row: each block keeps its head's o_j in shared memory and computes its column
// slice of y from every head's o_j through distributed shared memory.
//
// T is bounds-checked (phase 1 takes T up to what its shared memory holds, 453 at
// hd = 36; no padding to 384 as on the TPU); head dims 12/20/28/36 as B1.

#include "attention_common.cuh"
#include "gmm_common.cuh"

namespace wm {
// fused_qkv_attention.cu
int fused_qkv_attention_o(int dtype, const void* x, const void* w, const void* b, void* o,
                          int batch, int t, int h, int num_heads, Dropout drop,
                          void* stream);
}  // namespace wm

namespace {

using namespace gmm_tiles;

// y [m, h] = o [m, h] . wo^T + bo, wo [h, h] in [out, in] layout; one block per 128 x 128
// tile of y.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
outproj_kernel(const T* __restrict__ o, const T* __restrict__ wo, const T* __restrict__ bo,
               T* __restrict__ y, long long m, int h, bool vec) {
  constexpr int kLd = kLdDepth<T>;
  __shared__ __align__(32) T a_s[kTile * kLd];  // o rows r0.., columns k0.. : [m][k]
  __shared__ __align__(32) T b_s[kTile * kLd];  // wo rows n0.., columns k0.. : [n][k]
  __shared__ __align__(32) float scratch[kWarps * 256];

  const long long r0 = (long long)blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int rows = m - r0 < kTile ? (int)(m - r0) : kTile;
  const int cols = h - n0 < kTile ? h - n0 : kTile;

  Acc<T> acc;
  acc.zero();
  for (int k0 = 0; k0 < h; k0 += kDepth) {
    stage<T, kTile, kDepth>(a_s, kLd, o, h, r0, 0, m, k0, h, vec);
    stage<T, kTile, kDepth>(b_s, kLd, wo, h, n0, 0, h, k0, h, vec);
    __syncthreads();
    mma_slab<T, true, false>(acc, a_s, kLd, b_s, kLd);
    __syncthreads();
  }
  T* yt = y + r0 * h + n0;
  const T* bt = bo + n0;
  tile_epilogue<T>(acc, rows, cols, scratch, [&](int mm, int nn, float v) {
    yt[(long long)mm * h + nn] = from_float<T>(v + wm::to_float(bt[nn]));
  });
}

template <typename T>
cudaError_t launch_outproj(const void* o, const void* wo, const void* bo, void* y,
                           long long m, int h, cudaStream_t stream) {
  const dim3 grid((h + kTile - 1) / kTile, (unsigned)((m + kTile - 1) / kTile));
  if ((m + kTile - 1) / kTile > 65535) return cudaErrorInvalidConfiguration;
  const bool vec = vec_ok<T>(o, h) && vec_ok<T>(wo, h);
  outproj_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(wo), static_cast<const T*>(bo),
      static_cast<T*>(y), m, h, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x [batch, t, h], w [3h, h], b [3h], wo [h, h], bo [h],
// the workspace o [batch, t, h] and y [batch, t, h], all contiguous on the current device.
// Dropout on the attention weights when dropout_on != 0 (threshold, keep_prob and seed as
// in attention_common.cuh). Returns a cudaError_t (0 on success).
int wm_fused_qkv_attention_outproj(int dtype, const void* x, const void* w, const void* b,
                                   const void* wo, const void* bo, void* o, void* y,
                                   int batch, int t, int h, int num_heads, int dropout_on,
                                   unsigned int seed, unsigned int threshold,
                                   float keep_prob, void* stream) {
  if (batch <= 0 || t <= 0 || h <= 0) return cudaErrorInvalidValue;
  wm::Dropout drop{dropout_on, seed, threshold, keep_prob, 0.f};
  int err = wm::fused_qkv_attention_o(dtype, x, w, b, o, batch, t, h, num_heads, drop, stream);
  if (err != cudaSuccess) return err;
  const long long m = (long long)batch * t;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_outproj<float>(o, wo, bo, y, m, h, s);
  if (dtype == 1) return launch_outproj<__nv_bfloat16>(o, wo, bo, y, m, h, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
