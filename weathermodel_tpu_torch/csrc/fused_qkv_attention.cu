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
//   eval form:
//     s = q . k^T / sqrt(hd)   per head, fp32
//     p = softmax(s)           max-subtracted, fp32, then rounded to the element type
//   training form (the TPU kernel's rounding order, pallas_attention.py:158-178):
//     qs = q * scale           scale rounded to the element type, product rounded
//     s  = qs . k^T            fp32
//     e = exp(s - max), recip = 1 / sum(e)
//     p  = keep ? e * (recip / (1 - rate)) : 0, rounded   (dropout on)
//     p  = e * recip, rounded                              (dropout off)
//     and the packed qkv [B, T, 3H] is written out in the element type: the backward's
//     residual (weathermodel_tpu_torch/csrc/fused_qkv_attention_bwd.cu).
//   o = p . v                  fp32 accumulation, rounded to the element type
// The eval form keeps qkv on chip, as on the TPU.
//
// The kernel B5 (fused_qkv_attention_outproj.cu) runs this kernel as its first phase
// through `wm::fused_qkv_attention_o`: the eval form, or with dropout the training form's
// rounding and mask without the qkv output (kEmitQkv = false).
//
// Design: one thread block per (batch row, head), 512 threads.
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
// What bounds it on the card: this is scalar-FMA first. It uses no tensor cores, so it is
// bound by fp32 FMA issue and by shared-memory load bandwidth (phase 1 does 11 shared
// loads per 28 FMAs, phase 2 one per FMA), at one 512-thread block per SM. Each block
// re-reads x[b] from L2 once per head. The training form adds the qkv write (3x the bytes
// of o) and one hash per attention weight. Later work: the projection as a wgmma GEMM fed
// by TMA, and the two attention products on tensor cores.
//
// Head dims 12/20/28/36 are = 4 mod 8 and the per-head slice offset is not 16-byte
// aligned, so every global access is a scalar load; T is bounds-checked here (no padding
// to 384 as on the TPU, hence no pad-column softmax correction and no bias row mask).

#include <math.h>

#include "attention_common.cuh"
#include "attention_fwd.cuh"

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

template <int HD>
size_t smem_bytes(int t) {
  using L = Layout<HD>;
  size_t qkv = 3ull * t * L::kStride;
  size_t scratch = (size_t)kWarps * t;
  size_t shared = scratch > (size_t)L::kStage ? scratch : (size_t)L::kStage;
  return (qkv + shared) * sizeof(float);
}

// kTrain selects the training form (module comment); kEmitQkv (training form only)
// writes the packed qkv. The eval instantiations compile exactly the eval form's code.
template <typename T, int HD, bool kTrain, bool kEmitQkv>
__global__ void __launch_bounds__(kThreads, 1)
fused_qkv_attention_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ bias, T* __restrict__ out,
                           T* __restrict__ qkv_out, int t, int h, int num_heads, float scale,
                           Dropout drop) {
  using L = Layout<HD>;
  extern __shared__ float smem[];
  float* qs = smem;                       // [t][HD + 1]
  float* ks = qs + (size_t)t * L::kStride;
  float* vs = ks + (size_t)t * L::kStride;
  float* shared = vs + (size_t)t * L::kStride;  // phase-1 staging, then phase-2 scores

  const int head = blockIdx.x % num_heads;
  const int row_b = blockIdx.x / num_heads;
  const int tid = threadIdx.x;
  const T* xb = x + (size_t)row_b * t * h;
  // training form: q is scaled by the scale rounded to the element type, as the TPU
  // kernel's `q * scale` is in x.dtype
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
        if constexpr (kTrain) {
          if (part == 0) v = round_to<T>(v * scale_t);
        }
        dst[r * L::kStride + dd] = v;
      }
    }
  }
  __syncthreads();

  // ---- phase 2: per query row, softmax(q . K^T * scale) . V (attention_fwd.cuh) ----
  wm::attend_rows<T, HD, kTrain>(qs, ks, vs, shared, out + (size_t)row_b * t * h + head * HD,
                                 t, h, scale, drop, blockIdx.x);
}

template <typename T, int HD, bool kTrain, bool kEmitQkv>
cudaError_t launch(const void* x, const void* w, const void* b, void* o, void* qkv,
                   int batch, int t, int h, int num_heads, Dropout drop,
                   cudaStream_t stream) {
  auto kernel = fused_qkv_attention_kernel<T, HD, kTrain, kEmitQkv>;
  size_t smem = smem_bytes<HD>(t);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // the training form takes 1/sqrt(hd) rounded once from double, as the JAX
  // package's Python float is (the eval form keeps its fp32 quotient)
  float scale = kTrain ? (float)(1.0 / sqrt((double)HD)) : 1.0f / sqrtf((float)HD);
  kernel<<<(unsigned)batch * num_heads, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(o), static_cast<T*>(qkv), t, h, num_heads, scale, drop);
  return cudaGetLastError();
}

template <typename T, bool kTrain, bool kEmitQkv>
cudaError_t dispatch_head_dim(const void* x, const void* w, const void* b, void* o,
                              void* qkv, int batch, int t, int h, int num_heads,
                              Dropout drop, cudaStream_t stream) {
  switch (h / num_heads) {
    case 12:
      return launch<T, 12, kTrain, kEmitQkv>(x, w, b, o, qkv, batch, t, h, num_heads, drop,
                                            stream);
    case 20:
      return launch<T, 20, kTrain, kEmitQkv>(x, w, b, o, qkv, batch, t, h, num_heads, drop,
                                            stream);
    case 28:
      return launch<T, 28, kTrain, kEmitQkv>(x, w, b, o, qkv, batch, t, h, num_heads, drop,
                                            stream);
    case 36:
      return launch<T, 36, kTrain, kEmitQkv>(x, w, b, o, qkv, batch, t, h, num_heads, drop,
                                            stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kTrain, bool kEmitQkv>
int dispatch(int dtype, const void* x, const void* w, const void* b, void* o, void* qkv,
             int batch, int t, int h, int num_heads, Dropout drop, void* stream) {
  if (batch <= 0 || t <= 0 || num_heads <= 0 || h % num_heads != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_head_dim<float, kTrain, kEmitQkv>(x, w, b, o, qkv, batch, t, h, num_heads,
                                                      drop, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16, kTrain, kEmitQkv>(x, w, b, o, qkv, batch, t, h,
                                                              num_heads, drop, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x [batch, t, h], w [3h, h], b [3h], o [batch, t, h],
// all contiguous on the current device. Returns a cudaError_t (0 on success).
int wm_fused_qkv_attention(int dtype, const void* x, const void* w, const void* b, void* o,
                           int batch, int t, int h, int num_heads, void* stream) {
  return dispatch<false, false>(dtype, x, w, b, o, nullptr, batch, t, h, num_heads,
                                Dropout{}, stream);
}

// The training form: as above, plus qkv [batch, t, 3h] written out, and dropout on the
// attention weights when dropout_on != 0 (threshold, keep_prob and seed as in
// attention_common.cuh).
int wm_fused_qkv_attention_train(int dtype, const void* x, const void* w, const void* b,
                                 void* o, void* qkv, int batch, int t, int h,
                                 int num_heads, int dropout_on, unsigned int seed,
                                 unsigned int threshold, float keep_prob, void* stream) {
  Dropout drop{dropout_on, seed, threshold, keep_prob, 0.f};
  return dispatch<true, true>(dtype, x, w, b, o, qkv, batch, t, h, num_heads, drop, stream);
}

}  // extern "C"

namespace wm {

// B5's first phase: o [batch, t, h] as above with no qkv output, the eval form when
// drop.on == 0, else the training form's rounding and dropout mask.
int fused_qkv_attention_o(int dtype, const void* x, const void* w, const void* b, void* o,
                          int batch, int t, int h, int num_heads, Dropout drop,
                          void* stream) {
  if (drop.on)
    return dispatch<true, false>(dtype, x, w, b, o, nullptr, batch, t, h, num_heads, drop,
                                 stream);
  return dispatch<false, false>(dtype, x, w, b, o, nullptr, batch, t, h, num_heads, drop,
                                stream);
}

}  // namespace wm

extern "C" {

const char* wm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
