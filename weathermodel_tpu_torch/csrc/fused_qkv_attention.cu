// Fused QKV projection + multi-head self-attention for Hopper (sm_90a): the eval form
// and the training form of one kernel.
//
// Replaces the TPU kernel `_fused_fwd_kernel` in weathermodel_tpu/ops/pallas_attention.py
// (reached through `_fused_call`, public entry `flash_attention_fused`):
//   eval form      emit_qkv=False, dropout 0 (`wm_fused_qkv_attention`)
//   training form  emit_qkv=True, dropout on the attention weights
//                  (`wm_fused_qkv_attention_train`, the forward rule of the custom VJP)
//
// What it computes, for x [B, T, H], w [3H, H] (torch [out, in] layout), b [3H]:
//   qkv = x . w^T + b          fp32 accumulation, rounded to the element type
//   both forms, the TPU kernel's rounding order (`_fwd_body`, pallas_attention.py:151-197):
//     qs = q * scale           scale = 1/sqrt(hd) from double, rounded to the element
//                              type; the product rounded
//     s  = qs . k^T            fp32
//     e = exp(s - max), recip = 1 / sum(e)
//     p  = keep ? e * (recip / (1 - rate)) : 0, rounded   (training form, dropout on)
//     p  = e * recip, rounded                              (eval form; dropout off)
//   o = p . v                  fp32 accumulation, rounded to the element type
// The training form also writes the packed qkv [B, T, 3H] in the element type: the
// backward's residual (weathermodel_tpu_torch/csrc/fused_qkv_attention_bwd.cu). The eval
// form keeps qkv on chip, as on the TPU.
//
// The kernel B5 (fused_qkv_attention_outproj.cu) runs this kernel as its first phase
// through `wm::fused_qkv_attention_o`: the eval form, or with dropout the training form's
// rounding and mask without the qkv output (kEmitQkv = false).
//
// Two bodies. bfloat16 runs attention_hopper.cuh's (wgmma fed by TMA: the projection and
// both attention products on the tensor cores; its note has the design). float32 runs the
// scalar body below: TF32 would change its numerics.
//
// The float32 body: one thread block per (batch row, head), 512 threads.
//   Phase 1 projects that head's q, k and v slices ([T, hd] each) from x[b] into shared
//   memory. x and the head's 3*hd weight rows are staged through shared memory in
//   K-chunks of 32; each thread keeps a 4-row by CPT-column register tile.
//   Phase 2 gives each warp query rows: scores against all of K (lanes over keys, the
//   query row in registers), a row max and sum by warp shuffles, the weights (with the
//   dropout keep bits, attention_common.cuh) back into the warp's score row, then p . V
//   with lanes over the head dim. It is `wm::attend_rows` (attention_fwd.cuh), which
//   kernel B3f (flash_attention.cu) shares.
// q, k and v are kept in shared memory as fp32 (values already rounded to the element
// type) with a row stride of hd + 1 words, odd for the even head dims, so that lanes
// walking keys hit distinct banks. At T = 365, hd = 36 that is 162 KB of the 227 KB a
// block may use; the phase-1 staging tiles and the phase-2 score rows share what is left.
//
// What bounds the float32 body on the card: scalar FMA. It uses no tensor cores, so it is
// bound by fp32 FMA issue and by shared-memory load bandwidth (phase 1 does 11 shared
// loads per 28 FMAs, phase 2 one per FMA), at one 512-thread block per SM. Each block
// re-reads x[b] from L2 once per head. The training form adds the qkv write (3x the bytes
// of o) and one hash per attention weight.
//
// Head dims 12/20/28/36 are = 4 mod 8 and the per-head slice offset is not 16-byte
// aligned, so every global access of the float32 body is a scalar load. T is
// bounds-checked (no padding to 384 as on the TPU, hence no pad-column softmax correction
// and no bias row mask), up to wm::kMaxContext (1536) in both bodies: the float32 body keeps
// q, k and v in shared memory while they fit beside the score rows (453 at hd 36), and past
// that in a device workspace of the same layout (`kGlobal`, 3 t (hd + 1) floats a block),
// with only the phase-1 staging and the score rows in shared memory; the bfloat16 body
// streams K^T and V^T past the T they fit at (`attn_hopper::resident`: 512 at hd 36).

#include <math.h>

#include <type_traits>

#include "attention_common.cuh"
#include "attention_fwd.cuh"
#include "attention_hopper.cuh"

namespace {

using wm::Dropout;
using wm::from_float;
using wm::kThreads;
using wm::kWarps;
using wm::round_to;
using wm::to_float;

constexpr int kRowTile = 128;  // phase-1 rows per tile: 32 row groups x 4 rows
constexpr int kRowsPerThread = 4;
constexpr int kColGroups = 16;
constexpr int kChunk = 32;  // phase-1 K-chunk

template <int HD>
struct Layout {
  static constexpr int kCols = 3 * HD;                               // q, k, v columns
  static constexpr int kColsPerThread = (kCols + kColGroups - 1) / kColGroups;
  static constexpr int kStride = HD + 1;                             // smem row stride
  static constexpr int kStage = (kRowTile + kCols) * (kChunk + 1);   // phase-1 floats
};

// The block's dynamic shared memory: q, k, v rows, then the phase-1 staging or the score
// rows; with kGlobal (q, k, v in the workspace) the latter alone.
template <int HD>
size_t smem_bytes(int t, bool global) {
  using L = Layout<HD>;
  size_t qkv = global ? 0 : 3ull * t * L::kStride;
  size_t scratch = (size_t)kWarps * t;
  size_t shared = scratch > (size_t)L::kStage ? scratch : (size_t)L::kStage;
  return (qkv + shared) * sizeof(float);
}

// A float32 block's device workspace in bytes: 0 where its rows fit in shared memory.
template <int HD>
size_t scalar_workspace_bytes(int t) {
  return smem_bytes<HD>(t, false) <= wm::kSmemMax ? 0 : 3ull * t * Layout<HD>::kStride * 4;
}

// kTrain selects the training form (dropout; module comment), kEmitQkv (training form
// only) writes the packed qkv, kGlobal keeps q, k and v in the workspace `work`.
template <typename T, int HD, bool kTrain, bool kEmitQkv, bool kGlobal>
__global__ void __launch_bounds__(kThreads, 1)
fused_qkv_attention_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ bias, T* __restrict__ out,
                           T* __restrict__ qkv_out, int t, int h, int num_heads, float scale,
                           Dropout drop, float* work) {
  using L = Layout<HD>;
  extern __shared__ float smem[];
  float* qs = kGlobal ? work + (size_t)blockIdx.x * 3 * t * L::kStride : smem;  // [t][HD + 1]
  float* ks = qs + (size_t)t * L::kStride;
  float* vs = ks + (size_t)t * L::kStride;
  float* shared = kGlobal ? smem : vs + (size_t)t * L::kStride;  // staging, then scores

  const int head = blockIdx.x % num_heads;
  const int row_b = blockIdx.x / num_heads;
  const int tid = threadIdx.x;
  const T* xb = x + (size_t)row_b * t * h;
  // q is scaled by the scale rounded to the element type, as the TPU kernel's
  // `q * scale` is in x.dtype
  const float scale_t = round_to<T>(scale);

  // ---- phase 1: this head's q, k, v = x[b] . W_head^T + b_head -------------------
  float* xs = shared;                               // [kRowTile][kChunk + 1]
  float* ws = shared + kRowTile * (kChunk + 1);     // [kCols][kChunk + 1]
  const int tx = tid % kColGroups;                  // column group
  const int ty = tid / kColGroups;                  // row group, 0..31

  for (int r0 = 0; r0 < t; r0 += kRowTile) {
    float acc[kRowsPerThread][L::kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < L::kColsPerThread; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < h; k0 += kChunk) {
      for (int idx = tid; idx < kRowTile * kChunk; idx += kThreads) {
        int r = idx / kChunk, kk = idx % kChunk;
        int gr = r0 + r, gk = k0 + kk;
        xs[r * (kChunk + 1) + kk] =
            (gr < t && gk < h) ? to_float(xb[(size_t)gr * h + gk]) : 0.f;
      }
      for (int idx = tid; idx < L::kCols * kChunk; idx += kThreads) {
        int c = idx / kChunk, kk = idx % kChunk;
        int gk = k0 + kk;
        int wrow = (c / HD) * h + head * HD + (c % HD);
        ws[c * (kChunk + 1) + kk] = gk < h ? to_float(w[(size_t)wrow * h + gk]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kChunk; ++kk) {
        float xv[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          xv[i] = xs[(ty + 32 * i) * (kChunk + 1) + kk];
#pragma unroll
        for (int j = 0; j < L::kColsPerThread; ++j) {
          int c = tx + kColGroups * j;
          float wv = c < L::kCols ? ws[c * (kChunk + 1) + kk] : 0.f;
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) acc[i][j] = fmaf(xv[i], wv, acc[i][j]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < L::kColsPerThread; ++j) {
      int c = tx + kColGroups * j;
      if (c >= L::kCols) continue;
      int part = c / HD, dd = c % HD;
      float bv = to_float(bias[part * h + head * HD + dd]);
      float* dst = part == 0 ? qs : (part == 1 ? ks : vs);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        int r = r0 + ty + 32 * i;
        if (r >= t) continue;
        float v = round_to<T>(acc[i][j] + bv);
        if constexpr (kEmitQkv)
          qkv_out[((size_t)row_b * t + r) * 3 * h + part * h + head * HD + dd] =
              from_float<T>(v);
        if (part == 0) v = round_to<T>(v * scale_t);
        dst[r * L::kStride + dd] = v;
      }
    }
  }
  __syncthreads();

  // ---- phase 2: per query row, softmax(qs . K^T) . V (attention_fwd.cuh) ----
  wm::attend_rows<T, HD>(qs, ks, vs, shared, out + (size_t)row_b * t * h + head * HD, t, h,
                         kTrain ? drop : Dropout{}, blockIdx.x);
}

template <typename T, int HD, bool kTrain, bool kEmitQkv, bool kGlobal>
cudaError_t launch_scalar(const void* x, const void* w, const void* b, void* o, void* qkv,
                          void* ws, int batch, int t, int h, int num_heads, float scale,
                          Dropout drop, cudaStream_t stream) {
  auto kernel = fused_qkv_attention_kernel<T, HD, kTrain, kEmitQkv, kGlobal>;
  size_t smem = smem_bytes<HD>(t, kGlobal);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)batch * num_heads, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(o), static_cast<T*>(qkv), t, h, num_heads, scale, drop,
      static_cast<float*>(ws));
  return cudaGetLastError();
}

// bfloat16 on attention_hopper.cuh's body, float32 on the scalar body above
template <typename T, int HD, bool kTrain, bool kEmitQkv>
cudaError_t launch(const void* x, const void* w, const void* b, void* o, void* qkv, void* ws,
                   int batch, int t, int h, int num_heads, Dropout drop,
                   cudaStream_t stream) {
  // 1/sqrt(hd) rounded once from double, as the JAX package's Python float is
  const float scale = (float)(1.0 / sqrt((double)HD));
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return attn_hopper::launch<HD, kTrain, kEmitQkv>(x, w, b, o, qkv, ws, batch, t, h,
                                                     num_heads, scale, drop, stream);
  } else {
    if (scalar_workspace_bytes<HD>(t) == 0)
      return launch_scalar<T, HD, kTrain, kEmitQkv, false>(x, w, b, o, qkv, ws, batch, t, h,
                                                           num_heads, scale, drop, stream);
    if (ws == nullptr) return cudaErrorInvalidValue;
    return launch_scalar<T, HD, kTrain, kEmitQkv, true>(x, w, b, o, qkv, ws, batch, t, h,
                                                        num_heads, scale, drop, stream);
  }
}

template <typename T, bool kTrain, bool kEmitQkv>
cudaError_t dispatch_head_dim(const void* x, const void* w, const void* b, void* o,
                              void* qkv, void* ws, int batch, int t, int h, int num_heads,
                              Dropout drop, cudaStream_t stream) {
  switch (h / num_heads) {
    case 12:
      return launch<T, 12, kTrain, kEmitQkv>(x, w, b, o, qkv, ws, batch, t, h, num_heads,
                                            drop, stream);
    case 20:
      return launch<T, 20, kTrain, kEmitQkv>(x, w, b, o, qkv, ws, batch, t, h, num_heads,
                                            drop, stream);
    case 28:
      return launch<T, 28, kTrain, kEmitQkv>(x, w, b, o, qkv, ws, batch, t, h, num_heads,
                                            drop, stream);
    case 36:
      return launch<T, 36, kTrain, kEmitQkv>(x, w, b, o, qkv, ws, batch, t, h, num_heads,
                                            drop, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kTrain, bool kEmitQkv>
int dispatch(int dtype, const void* x, const void* w, const void* b, void* o, void* qkv,
             void* ws, int batch, int t, int h, int num_heads, Dropout drop, void* stream) {
  if (batch <= 0 || t <= 0 || t > wm::kMaxContext || num_heads <= 0 || h % num_heads != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float, kTrain, kEmitQkv>(x, w, b, o, qkv, ws, batch, t, h,
                                                      num_heads, drop, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16, kTrain, kEmitQkv>(x, w, b, o, qkv, ws, batch, t,
                                                              h, num_heads, drop, s);
  return cudaErrorInvalidValue;
}

template <int HD>
long long workspace_at(int dtype, int t) {
  return dtype == 1 ? attn_hopper::workspace_bytes<HD>(t)
                    : (long long)scalar_workspace_bytes<HD>(t);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x [batch, t, h], w [3h, h], b [3h], o [batch, t, h],
// all contiguous on the current device; ws wm_fused_qkv_attention_workspace(dtype,
// head_dim, t) bytes for each of the batch x num_heads blocks (null where that is 0). T up
// to wm::kMaxContext. Returns a cudaError_t (0 on success).
int wm_fused_qkv_attention(int dtype, const void* x, const void* w, const void* b, void* o,
                           void* ws, int batch, int t, int h, int num_heads, void* stream) {
  return dispatch<false, false>(dtype, x, w, b, o, nullptr, ws, batch, t, h, num_heads,
                                Dropout{}, stream);
}

// The training form: as above, plus qkv [batch, t, 3h] written out, and dropout on the
// attention weights when dropout_on != 0 (threshold, keep_prob and seed as in
// attention_common.cuh).
int wm_fused_qkv_attention_train(int dtype, const void* x, const void* w, const void* b,
                                 void* o, void* qkv, void* ws, int batch, int t, int h,
                                 int num_heads, int dropout_on, unsigned int seed,
                                 unsigned int threshold, float keep_prob, void* stream) {
  Dropout drop{dropout_on, seed, threshold, keep_prob, 0.f};
  return dispatch<true, true>(dtype, x, w, b, o, qkv, ws, batch, t, h, num_heads, drop,
                              stream);
}

// The device workspace the forward kernels (both forms, and B5's first phase) need for
// each (batch row, head) block at (dtype, head_dim, t), in bytes: 0 where the block keeps
// its rows on chip, -1 where the kernels do not take (head_dim, t).
long long wm_fused_qkv_attention_workspace(int dtype, int head_dim, int t) {
  if (t <= 0 || t > wm::kMaxContext || (dtype != 0 && dtype != 1)) return -1;
  switch (head_dim) {
    case 12: return workspace_at<12>(dtype, t);
    case 20: return workspace_at<20>(dtype, t);
    case 28: return workspace_at<28>(dtype, t);
    case 36: return workspace_at<36>(dtype, t);
    default: return -1;
  }
}

}  // extern "C"

namespace wm {

// B5's first phase: o [batch, t, h] as above with no qkv output, the eval form when
// drop.on == 0, else the training form's rounding and dropout mask; ws as above.
int fused_qkv_attention_o(int dtype, const void* x, const void* w, const void* b, void* o,
                          void* ws, int batch, int t, int h, int num_heads, Dropout drop,
                          void* stream) {
  if (drop.on)
    return dispatch<true, false>(dtype, x, w, b, o, nullptr, ws, batch, t, h, num_heads, drop,
                                 stream);
  return dispatch<false, false>(dtype, x, w, b, o, nullptr, ws, batch, t, h, num_heads, drop,
                                stream);
}

}  // namespace wm

extern "C" {

// The bfloat16 body's dynamic shared memory a block at (head_dim, t), in bytes, or 0 where
// it does not take t (past wm::kMaxContext).
int wm_qkv_attention_wgmma_smem(int head_dim, int t) {
  return attn_hopper::smem_bytes(head_dim, t);
}

const char* wm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
