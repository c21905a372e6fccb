// Fused QKV projection + multi-head self-attention, eval form, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_fwd_kernel` in
// weathermodel_tpu/ops/pallas_attention.py (reached through `_fused_call` with
// emit_qkv=False and dropout 0, the public entry `flash_attention_fused`).
//
// What it computes, for x [B, T, H], w [3H, H] (torch [out, in] layout), b [3H]:
//   qkv = x . w^T + b          fp32 accumulation, rounded to the element type
//   s   = q . k^T / sqrt(hd)   per head, fp32
//   p   = softmax(s)           max-subtracted, fp32, then rounded to the element type
//   o   = p . v                fp32 accumulation, rounded to the element type
// The projection runs inside the kernel, as on the TPU: qkv never goes to device memory.
//
// Design: one thread block per (batch row, head), 512 threads.
//   Phase 1 projects that head's q, k and v slices ([T, hd] each) from x[b] into shared
//   memory. x and the head's 3*hd weight rows are staged through shared memory in
//   K-chunks of 32; each thread keeps a 4-row by CPT-column register tile.
//   Phase 2 gives each warp query rows: scores against all of K (lanes over keys, the
//   query row in registers), a row max and sum by warp shuffles, then p . V with lanes
//   over the head dim.
// q, k and v are kept in shared memory as fp32 (values already rounded to the element
// type) with a row stride of hd + 1 words, odd for the even head dims, so that lanes
// walking keys hit distinct banks. At T = 365, hd = 36 that is 162 KB of the 227 KB a
// block may use; the phase-1 staging tiles and the phase-2 score rows share what is left.
//
// What bounds it on the card: this is scalar-FMA first. It uses no tensor cores, so it is
// bound by fp32 FMA issue and by shared-memory load bandwidth (phase 1 does 11 shared
// loads per 28 FMAs, phase 2 one per FMA), at one 512-thread block per SM. Each block
// re-reads x[b] from L2 once per head. Later work: the projection as a wgmma GEMM fed by
// TMA, and the two attention products on tensor cores.
//
// Head dims 12/20/28/36 are = 4 mod 8 and the per-head slice offset is not 16-byte
// aligned, so every global access is a scalar load; T is bounds-checked here (no padding
// to 384 as on the TPU, hence no pad-column softmax correction and no bias row mask).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 128;  // phase-1 rows per tile: 32 row groups x 4 rows
constexpr int kRowsPerThread = 4;
constexpr int kColGroups = 16;
constexpr int kChunk = 32;  // phase-1 K-chunk

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Round an fp32 value to the element type and back.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
fused_qkv_attention_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ bias, T* __restrict__ out,
                           int t, int h, int num_heads, float scale) {
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
        if (r < t) dst[r * L::kStride + dd] = round_to<T>(acc[i][j] + bv);
      }
    }
  }
  __syncthreads();

  // ---- phase 2: per query row, softmax(q . K^T * scale) . V ----------------------
  const int warp = tid / 32, lane = tid % 32;
  float* sc = shared + (size_t)warp * t;  // this warp's score row
  T* ob = out + (size_t)row_b * t * h + head * HD;

  for (int i = warp; i < t; i += kWarps) {
    float q[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) q[d] = qs[i * L::kStride + d];

    float m = -INFINITY;
    for (int k = lane; k < t; k += 32) {
      const float* kr = ks + k * L::kStride;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) s = fmaf(q[d], kr[d], s);
      s *= scale;
      sc[k] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);

    float sum = 0.f;
    for (int k = lane; k < t; k += 32) {
      float e = expf(sc[k] - m);
      sc[k] = e;
      sum += e;
    }
    const float recip = 1.f / warp_sum(sum);
    __syncwarp();

    float acc0 = 0.f, acc1 = 0.f;
    const int d0 = lane, d1 = lane + 32;
    for (int k = 0; k < t; ++k) {
      float p = round_to<T>(sc[k] * recip);
      const float* vr = vs + k * L::kStride;
      if (d0 < HD) acc0 = fmaf(p, vr[d0], acc0);
      if (d1 < HD) acc1 = fmaf(p, vr[d1], acc1);
    }
    if (d0 < HD) ob[(size_t)i * h + d0] = from_float<T>(acc0);
    if (d1 < HD) ob[(size_t)i * h + d1] = from_float<T>(acc1);
    __syncwarp();  // sc is rewritten by the next row
  }
}

template <typename T, int HD>
cudaError_t launch(const void* x, const void* w, const void* b, void* o, int batch, int t,
                   int h, int num_heads, cudaStream_t stream) {
  auto kernel = fused_qkv_attention_kernel<T, HD>;
  size_t smem = smem_bytes<HD>(t);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  float scale = 1.0f / sqrtf((float)HD);
  kernel<<<(unsigned)batch * num_heads, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(o), t, h, num_heads, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* x, const void* w, const void* b, void* o,
                              int batch, int t, int h, int num_heads, cudaStream_t stream) {
  switch (h / num_heads) {
    case 12: return launch<T, 12>(x, w, b, o, batch, t, h, num_heads, stream);
    case 20: return launch<T, 20>(x, w, b, o, batch, t, h, num_heads, stream);
    case 28: return launch<T, 28>(x, w, b, o, batch, t, h, num_heads, stream);
    case 36: return launch<T, 36>(x, w, b, o, batch, t, h, num_heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x [batch, t, h], w [3h, h], b [3h], o [batch, t, h],
// all contiguous on the current device. Returns a cudaError_t (0 on success).
int wm_fused_qkv_attention(int dtype, const void* x, const void* w, const void* b, void* o,
                           int batch, int t, int h, int num_heads, void* stream) {
  if (batch <= 0 || t <= 0 || num_heads <= 0 || h % num_heads != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_head_dim<float>(x, w, b, o, batch, t, h, num_heads, s);
  if (dtype == 1)
    return dispatch_head_dim<__nv_bfloat16>(x, w, b, o, batch, t, h, num_heads, s);
  return cudaErrorInvalidValue;
}

const char* wm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
