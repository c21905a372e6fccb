// The keep-mask kernel family: dropout keep-masks and dropout without a stored mask.
//
// Replaces four TPU kernels (weathermodel_tpu/ops/):
//   B9b  pallas_maskgen.py `_bool_kernel` (via `bool_keep_mask`): bool [m, c]
//   B9p  pallas_maskgen.py `_kernel` (via `packed_keep_mask`): int32 [m / 32, c], bit i of
//        word [g, j] = keep(row 32g + i, col j), packed along the rows
//   B8m  pallas_dropout.py `_mask_kernel` (via `random_keep_mask`): bool mask of any shape
//   B8   pallas_dropout.py `_kernel` (via `_run`, public `dropout`): x dropped, any shape
// B8 and B8m work on JAX's lane view [ceil(n / 512), 512] of the flattened tensor and write
// nothing past n.
//
// The TPU kernels draw from the hardware PRNG, seeded per block. The card has none, so the
// bits of element (row, col) are attention_common.cuh's hash on a (row, col) pair, the FFN
// sites' bits (ffn_common.cuh), independent of the launch's blocks:
//   bits = mix32(dropout_head_key(seed, row) ^ col)
//   B9b, B9p:  keep iff bits >= threshold, threshold = floor(p 2^32)       (maskgen rule)
//   B8, B8m:   keep iff bits <  threshold, threshold = floor((1 - p) 2^32)  (B8's rule)
// weathermodel_tpu_torch/ops/dropout.py::hash_keep_mask computes the same bits with int64
// tensor ops. B8 multiplies a kept value by 1/(1 - p) rounded to x's dtype (the caller
// passes it, exact in fp32) and rounds the product once, as the TPU kernel's weak-typed
// scalar does.
//
// What bounds them on the card: the bytes written (B9b and B8m 1 byte an element, B9p 1/8,
// B8 x in and y out) against ~10 integer operations an element for the hash and the
// compare (12 with B9p's packing or B8's multiply and select); at the bench microbatch's
// FFN hidden, 105,120 x 2304 elements, the two are about equal for the bool masks (0.072 ms
// at 3.35 TB/s; 2.4 G operations at one 32-bit instruction per lane and clock), and B9p is
// bound by its operations. Design: each block computes its rows' keys once into shared
// memory; a thread then hashes 16 bytes' worth of consecutive elements of one row and
// writes them with one 16-byte store (B9b, B8m, B8), or 32 rows of one column into one
// int32 word (B9p, stores coalesced along the columns). No shared state between blocks.

#include "attention_common.cuh"

namespace keep_mask {

using wm::from_float;
using wm::to_float;

constexpr int kThreads = 256;
constexpr int kRows = 16;        // rows of the [rows, cols] view per block (bool masks, B8)
constexpr int kVecBytes = 16;    // bytes a thread writes with one store
constexpr int kLanes = 512;      // the lane view's row width (B8, B8m)
constexpr int kPackThreads = 128;
constexpr int kGroup = 32;       // rows packed per int32 word (B9p)

__device__ __forceinline__ bool keep(uint32_t key, uint32_t col, uint32_t threshold,
                                     bool at_least) {
  uint32_t bits = wm::mix32(key ^ col);
  return at_least ? bits >= threshold : bits < threshold;
}

// Keys of the block's rows row0 .. row0 + kRows - 1.
__device__ __forceinline__ void row_keys(uint32_t* keys, long long row0, uint32_t seed) {
  if (threadIdx.x < kRows)
    keys[threadIdx.x] = wm::dropout_head_key(seed, (uint32_t)(row0 + threadIdx.x));
  __syncthreads();
}

// Bool mask of the [rows, cols] view (cols % 16 == 0); flat elements >= n are not written.
template <bool kAtLeast>
__global__ void __launch_bounds__(kThreads)
    bool_mask_kernel(uint8_t* __restrict__ out, long long rows, int cols, long long n,
                     uint32_t seed, uint32_t threshold) {
  __shared__ uint32_t keys[kRows];
  const long long row0 = (long long)blockIdx.x * kRows;
  row_keys(keys, row0, seed);
  const int groups = cols / kVecBytes;
  const int items = (int)min((long long)kRows, rows - row0) * groups;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int r = it / groups;
    const int col0 = (it - r * groups) * kVecBytes;
    const long long base = (row0 + r) * cols + col0;
    if (base >= n) continue;
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        word |= (uint32_t)keep(keys[r], (uint32_t)(col0 + 4 * q + b), threshold, kAtLeast)
                << (8 * b);
      w[q] = word;
    }
    if (base + kVecBytes <= n) {
      *reinterpret_cast<uint4*>(out + base) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int e = 0; base + e < n; ++e) out[base + e] = (w[e / 4] >> (8 * (e % 4))) & 1u;
    }
  }
}

// B9p: one thread per (word row g, column); the 32 row keys of g in shared memory.
__global__ void __launch_bounds__(kPackThreads)
    packed_mask_kernel(int32_t* __restrict__ out, int m, int c, uint32_t seed,
                       uint32_t threshold) {
  __shared__ uint32_t keys[kGroup];
  const int tiles = (c + kPackThreads - 1) / kPackThreads;
  const int g = blockIdx.x / tiles;
  const int col = (blockIdx.x - g * tiles) * kPackThreads + threadIdx.x;
  if (threadIdx.x < kGroup)
    keys[threadIdx.x] = wm::dropout_head_key(seed, (uint32_t)(g * kGroup + threadIdx.x));
  __syncthreads();
  if (g * kGroup >= m || col >= c) return;
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < kGroup; ++i)
    word |= (uint32_t)keep(keys[i], (uint32_t)col, threshold, true) << i;
  out[(size_t)g * c + col] = (int32_t)word;
}

// B8 on the lane view: a thread loads 16 bytes of x (4 fp32 or 8 bf16 elements of one row).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lane_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                        uint32_t seed, uint32_t threshold, float scale, bool aligned) {
  constexpr int kElems = kVecBytes / sizeof(T);
  constexpr int kGroups = kLanes / kElems;
  __shared__ uint32_t keys[kRows];
  const long long row0 = (long long)blockIdx.x * kRows;
  row_keys(keys, row0, seed);
  const long long rows = (n + kLanes - 1) / kLanes;
  const int items = (int)min((long long)kRows, rows - row0) * kGroups;
  const T zero = from_float<T>(0.0f);
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int r = it / kGroups;
    const int col0 = (it % kGroups) * kElems;
    const long long base = (row0 + r) * kLanes + col0;
    if (base >= n) continue;
    const bool whole = aligned && base + kElems <= n;
    alignas(16) T v[kElems];
    if (whole) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(x + base);
    } else {
      for (int e = 0; e < kElems; ++e) v[e] = base + e < n ? x[base + e] : zero;
    }
#pragma unroll
    for (int e = 0; e < kElems; ++e)
      v[e] = keep(keys[r], (uint32_t)(col0 + e), threshold, false)
                 ? from_float<T>(to_float(v[e]) * scale)
                 : zero;
    if (whole) {
      *reinterpret_cast<uint4*>(y + base) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int e = 0; e < kElems && base + e < n; ++e) y[base + e] = v[e];
    }
  }
}

inline unsigned blocks_for(long long rows, int per_block) {
  return (unsigned)((rows + per_block - 1) / per_block);
}

}  // namespace keep_mask

extern "C" {

// B9b: out bool [m, c], contiguous, c a multiple of 128. keep iff bits >= threshold.
// Returns a cudaError_t (0 on success).
int wm_bool_keep_mask(void* out, int m, int c, unsigned seed, unsigned threshold,
                      void* stream) {
  using namespace keep_mask;
  if (m < 0 || c <= 0 || c % 128) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  bool_mask_kernel<true><<<blocks_for(m, kRows), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), m, c, (long long)m * c, seed, threshold);
  return cudaGetLastError();
}

// B9p: out int32 [m / 32, c], contiguous, m a multiple of 32, c of 128. keep iff
// bits >= threshold; bit i of word [g, j] is keep(32g + i, j).
int wm_packed_keep_mask(void* out, int m, int c, unsigned seed, unsigned threshold,
                        void* stream) {
  using namespace keep_mask;
  if (m < 0 || c <= 0 || m % kGroup || c % 128) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const long long blocks = (long long)(m / kGroup) * blocks_for(c, kPackThreads);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  packed_mask_kernel<<<(unsigned)blocks, kPackThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<int32_t*>(out), m, c,
                                                            seed, threshold);
  return cudaGetLastError();
}

// B8m: out bool [n] (any shape, contiguous), the lane view [ceil(n / 512), 512]. keep iff
// bits < threshold.
int wm_random_keep_mask(void* out, long long n, unsigned seed, unsigned threshold,
                        void* stream) {
  using namespace keep_mask;
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const long long rows = (n + kLanes - 1) / kLanes;
  bool_mask_kernel<false><<<blocks_for(rows, kRows), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), rows, kLanes, n, seed, threshold);
  return cudaGetLastError();
}

// B8: dtype 0 = float32, 1 = bfloat16; x and y [n] contiguous. y = keep ? x * scale : 0 on
// the lane view, keep iff bits < threshold; scale is 1/(1 - p) rounded to the dtype.
int wm_lane_dropout(int dtype, const void* x, void* y, long long n, unsigned seed,
                    unsigned threshold, float scale, void* stream) {
  using namespace keep_mask;
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const unsigned blocks = blocks_for((n + kLanes - 1) / kLanes, kRows);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) %
                        kVecBytes) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    lane_dropout_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, seed, threshold, scale,
        aligned);
  } else if (dtype == 1) {
    lane_dropout_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n, seed,
        threshold, scale, aligned);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
