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
// B8 x in and y out) against the hash's integer instructions, which Hopper issues at one
// warp instruction a clock per scheduler onto two pipes of 64 lanes an SM each: the ALU
// pipe (LOP3, SHF, ISETP, SEL, PRMT, IADD3) and the FMA pipe (IMAD in all its forms). At
// the bench microbatch's FFN hidden, 105,120 x 2304 elements, the bool masks' 242 MB of
// stores take 0.072 ms at 3.35 TB/s.
//
// B8: each block computes its rows' keys once into shared memory; a thread then hashes 16
// bytes' worth of consecutive elements of one row with one 16-byte store.
//
// B9b and B8m (`bool_mask_kernel`) are built for the two pipes. Per element, mix32 costs
// three shift-xors and two multiplies; the body takes the first shift-xor out of the
// element loop, since (key ^ col) ^ ((key ^ col) >> 16) = K1 ^ col ^ (col >> 16) with
// K1 = key ^ (key >> 16) per row, and for the columns c0 + e of a 16-column run starting at
// a multiple of 16 that is (K1 ^ c0 ^ (c0 >> 16)) ^ e, one LOP3 with an immediate. A thread
// owns one 16-column run, walks rows and reads each row's K1 from shared memory; no
// division anywhere on the device. The compare is the carry of bits + (2^32 - threshold),
// and the carries are packed into bytes by Horner steps that take the carry in (IADD3 on
// the ALU pipe, IMAD.X on the FMA pipe: one each an element, where a compare and a select
// were two on the ALU pipe); B8m's rule, bits < threshold, is the complement, one xor a
// word. What is left on the ALU pipe is ~6 instructions an element: the xor with e, the
// two shifts and their xors, the carry (on the FMA pipe, the two multiplies and the
// Horner step). Right shifts as the high word of a multiply by 2^17 or 2^16 (IMAD.HI)
// measured slower on the card than SHF, so the shifts stay on the ALU pipe.
//
// B9p (`packed_mask_kernel`) is built the same way, with the compare cut by one shift: write
// mix32's state before its last shift-xor as u, so bits = u ^ (u >> 16); then
//   bits >= threshold  <=>  u ^ (threshold >> 16) >= threshold,
// since both sides' top 16 bits are u's: where they differ from threshold's, they decide
// both compares alike, and where they equal threshold's top half, the low halves are both
// lo(u) ^ (threshold >> 16). A thread owns four consecutive columns c0 .. c0 + 3 (c0 a
// multiple of 4, one 16-byte store of four words) of one word row and walks its 32 rows from
// 31 down, reading four rows' K1 with one broadcast 16-byte shared load. The four columns'
// hash inputs after the hoist are h + j, j = 0 .. 3, with h = (K1 ^ c0 ^ (c0 >> 16)) & ~3
// (one LOP3 a row), so mix32's first multiply is h * M1 (one IMAD a row) plus j * M1 (one
// IMAD each, the factor 1 an argument): column c0 + e gets j = e ^ b, b = (K1 ^ cterm) & 3.
// Its carry (v + 2^32 - threshold, v = u ^ (threshold >> 16)) goes by Horner steps
// acc = acc * 2 + carry (an `add.cc` and a `madc.lo`: IADD3 and IMAD.X, the factor 2 an
// argument) into word j, so word j holds row i's bit for column c0 + (j ^ b_i). Two
// rounds of masked swaps per word row undo that: where bit 0 of b_i is set, words 0/1 and
// 2/3 swap bit i, then where bit 1 is set, 0/2 and 1/3; the masks are ballots of the rows'
// K1 bits, xored with the column term's. Per element that leaves ~4.4 instructions on the
// ALU pipe (the row's LOP3 over four, the shift and its xor, the xor with the threshold's
// top half, the carry) and 3 on the FMA pipe (the two multiplies, the Horner step). The
// grid is the bool body's: chunks of word rows along x, column tiles along y, a block
// computing its chunk's K1 once.
// A warp's lanes as the word's 32 rows (a ballot of the compares gives the word) measured
// slower: the compare is an ISETP on the ALU pipe and a lane keeps its column's word with
// a select. Right shifts as IMAD.HI measured slower here too, for one column of four or
// for all.
// No shared state between blocks.

#include "attention_common.cuh"

namespace keep_mask {

using wm::from_float;
using wm::to_float;

constexpr int kThreads = 256;
constexpr int kRows = 16;        // rows of the lane view per block (B8)
constexpr int kTileRows = 128;   // rows of a bool-mask chunk (B9b, B8m)
constexpr int kBlocksPerSm = 16; // the bool masks' grid, over all its waves
constexpr int kVecBytes = 16;    // bytes a thread writes with one store
constexpr int kLanes = 512;      // the lane view's row width (B8, B8m)
constexpr int kPackThreads = 128; // B9p's block: (64, 2) or (32, 4) threads
constexpr int kPackCols = 4;     // columns a B9p thread owns: one 16-byte store of 4 words
constexpr int kGroup = 32;       // rows packed per int32 word (B9p)

// B8's rule: keep iff bits < threshold.
__device__ __forceinline__ bool keep(uint32_t key, uint32_t col, uint32_t threshold) {
  return wm::mix32(key ^ col) < threshold;
}

// Keys of the block's rows row0 .. row0 + kRows - 1.
__device__ __forceinline__ void row_keys(uint32_t* keys, long long row0, uint32_t seed) {
  if (threadIdx.x < kRows)
    keys[threadIdx.x] = wm::dropout_head_key(seed, (uint32_t)(row0 + threadIdx.x));
  __syncthreads();
}

// The bool body's compare: keep iff bits + addend carries out of 32 bits, addend = (hi,
// lo) = 2^32 - threshold; k256 = 256 comes in as an argument so that ptxas keeps the
// packing's Horner step an IMAD.X rather than a shift on the ALU pipe.
struct Carry {
  uint32_t lo, hi, k256;
};

// mix32 after its first shift-xor: y = x ^ (x >> 16).
__device__ __forceinline__ uint32_t mix32_rest(uint32_t y) {
  uint32_t u = y * 0x7feb352du;
  u ^= u >> 15;
  u *= 0x846ca68bu;
  return u ^ (u >> 16);
}

// Byte i of the word is the carry of b[i] + addend (1 iff b[i] >= threshold), by Horner
// from the top byte: acc = acc * 256 + carry, one IADD3 (the carry, ALU pipe) and one
// IMAD.X (FMA pipe) a byte. hi + carry <= 1: hi is 1 only at threshold 0, where the low
// word adds 0 and never carries.
__device__ __forceinline__ uint32_t carry_bytes(const uint32_t b[4], const Carry& c) {
  uint32_t acc;
  asm("{\n\t.reg .u32 t;\n\t"
      "add.cc.u32 t, %1, %5;\n\t"
      "addc.u32 %0, %6, 0;\n\t"
      "add.cc.u32 t, %2, %5;\n\t"
      "madc.lo.u32 %0, %0, %7, %6;\n\t"
      "add.cc.u32 t, %3, %5;\n\t"
      "madc.lo.u32 %0, %0, %7, %6;\n\t"
      "add.cc.u32 t, %4, %5;\n\t"
      "madc.lo.u32 %0, %0, %7, %6;\n\t}"
      : "=r"(acc)
      : "r"(b[3]), "r"(b[2]), "r"(b[1]), "r"(b[0]), "r"(c.lo), "r"(c.hi), "r"(c.k256));
  return acc;
}

// The 16 mask bytes of a run whose hash input after the hoisted shift-xor is y at the run's
// first column: keep iff bits >= threshold, or (kAtLeast false) its complement, bits <
// threshold, by one xor a word.
template <bool kAtLeast>
__device__ __forceinline__ uint4 run_bytes(uint32_t y, const Carry& c) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = mix32_rest(y ^ (4 * q + i));
    w[q] = carry_bytes(b, c) ^ (kAtLeast ? 0u : 0x01010101u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// B9b and B8m: the bool mask of the [rows, cols] view (cols % 128 == 0, or the lane view's
// 512), rows [0, full) whole and row full cut at n (flat elements >= n are not written). The
// block is (tw, kThreads / tw) threads: tw runs of 16 columns across, rows down. The grid
// walks chunks of kTileRows rows along x and column tiles of tw runs along y; a block
// computes its chunk's K1 once for all its column tiles.
template <bool kAtLeast>
__global__ void __launch_bounds__(kThreads)
    bool_mask_kernel(uint8_t* __restrict__ out, long long rows, long long full, int cols,
                     long long n, uint32_t seed, Carry carry) {
  __shared__ uint32_t k1[kTileRows];
  const int tw = blockDim.x, ry = blockDim.y;
  const int ctiles = cols / (kVecBytes * tw);
  const long long chunks = (rows + kTileRows - 1) / kTileRows;
  const int t = threadIdx.y * tw + threadIdx.x;
  for (long long chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const long long row0 = chunk * kTileRows;
    __syncthreads();  // the previous chunk's keys are read
    for (int i = t; i < kTileRows; i += kThreads) {
      const uint32_t key = wm::dropout_head_key(seed, (uint32_t)(row0 + i));
      k1[i] = key ^ (key >> 16);
    }
    __syncthreads();
    const int whole = (int)max(0LL, min((long long)kTileRows, full - row0));
    const int nrows = (int)min((long long)kTileRows, rows - row0);
    for (int ct = blockIdx.y; ct < ctiles; ct += gridDim.y) {
      const uint32_t col0 = (uint32_t)(ct * tw + threadIdx.x) * kVecBytes;
      const uint32_t cterm = col0 ^ (col0 >> 16);
      uint8_t* p = out + (row0 + threadIdx.y) * cols + col0;
      int r = threadIdx.y;
      for (; r < whole; r += ry, p += (long long)ry * cols)
        *reinterpret_cast<uint4*>(p) = run_bytes<kAtLeast>(k1[r] ^ cterm, carry);
      if (r < nrows) {  // row `full`, which n cuts
        const uint4 v = run_bytes<kAtLeast>(k1[r] ^ cterm, carry);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        const long long base = (row0 + r) * cols + col0;
        for (int e = 0; e < kVecBytes && base + e < n; ++e)
          p[e] = (uint8_t)(w[e / 4] >> (8 * (e % 4)));
      }
    }
  }
}

// B9p's compare and packing: keep iff v + (hi, lo) carries out of 32 bits, (hi, lo) =
// 2^32 - threshold, v = u ^ kx, kx = threshold >> 16; two = 2 and one = 1 come in as
// arguments so that ptxas keeps the Horner step and the columns' adds IMADs on the FMA pipe.
struct PackCarry {
  uint32_t lo, hi, kx, two, one;
};

// Row 31's carry starts the word: acc = hi + carry (hi + carry <= 1, as in carry_bytes).
__device__ __forceinline__ uint32_t carry_first(uint32_t v, const PackCarry& p) {
  uint32_t acc;
  asm("{\n\t.reg .u32 t;\n\t"
      "add.cc.u32 t, %1, %2;\n\t"
      "addc.u32 %0, %3, 0;\n\t}"
      : "=r"(acc)
      : "r"(v), "r"(p.lo), "r"(p.hi));
  return acc;
}

// The next row's: acc * 2 + hi + carry.
__device__ __forceinline__ uint32_t carry_next(uint32_t acc, uint32_t v, const PackCarry& p) {
  uint32_t out;
  asm("{\n\t.reg .u32 t;\n\t"
      "add.cc.u32 t, %1, %2;\n\t"
      "madc.lo.u32 %0, %3, %4, %5;\n\t}"
      : "=r"(out)
      : "r"(v), "r"(p.lo), "r"(acc), "r"(p.two), "r"(p.hi));
  return out;
}

// Swap the bits of a and b where mask is set.
__device__ __forceinline__ void swap_bits(uint32_t& a, uint32_t& b, uint32_t mask) {
  const uint32_t t = (a ^ b) & mask;
  a ^= t;
  b ^= t;
}

// The four words of one word row for columns c0 .. c0 + 3: k1 holds its 32 rows' K1,
// cterm = c0 ^ (c0 >> 16), m0 and m1 set bit i where bit 0 (1) of row i's K1 ^ cterm is.
__device__ __forceinline__ uint4 packed_words(const uint32_t* k1, uint32_t cterm, uint32_t m0,
                                              uint32_t m1, const PackCarry& p) {
  uint32_t acc[kPackCols];
#pragma unroll
  for (int q = kGroup / 4 - 1; q >= 0; --q) {
    const uint4 k4 = reinterpret_cast<const uint4*>(k1)[q];  // rows 4q .. 4q + 3
    const uint32_t k[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
    for (int i = 3; i >= 0; --i) {
      const uint32_t h = ((k[i] ^ cterm) & ~3u) * 0x7feb352du;
#pragma unroll
      for (int j = 0; j < kPackCols; ++j) {
        uint32_t u = h;
        if (j)
          asm("mad.lo.u32 %0, %1, %2, %3;"
              : "=r"(u)
              : "r"(h), "r"(p.one), "r"((uint32_t)j * 0x7feb352du));
        u ^= u >> 15;
        u *= 0x846ca68bu;
        acc[j] = q == kGroup / 4 - 1 && i == 3 ? carry_first(u ^ p.kx, p)
                                               : carry_next(acc[j], u ^ p.kx, p);
      }
    }
  }
  swap_bits(acc[0], acc[1], m0);
  swap_bits(acc[2], acc[3], m0);
  swap_bits(acc[0], acc[2], m1);
  swap_bits(acc[1], acc[3], m1);
  return make_uint4(acc[0], acc[1], acc[2], acc[3]);
}

// B9p: int32 [words, cols], cols % 128 == 0. The block is (tw, kPackThreads / tw) threads: tw
// runs of 4 columns across, one word row each down. The grid walks chunks of word rows (one
// a thread row) along x and column tiles of tw runs along y; a block computes its chunk's K1
// and their low bits' ballots once for all its column tiles.
__global__ void __launch_bounds__(kPackThreads)
    packed_mask_kernel(int32_t* __restrict__ out, long long words, int cols, uint32_t seed,
                       PackCarry carry) {
  __shared__ __align__(16) uint32_t k1[kPackThreads];
  __shared__ uint32_t low[2][kPackThreads / kGroup];
  const int tw = blockDim.x, ry = blockDim.y;
  const int ctiles = cols / (kPackCols * tw);
  const long long chunks = (words + ry - 1) / ry;
  const int t = threadIdx.y * tw + threadIdx.x;
  for (long long chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const long long g0 = chunk * ry;
    __syncthreads();  // the previous chunk's keys are read
    if (t < kGroup * ry) {  // whole warps, one a word row
      const uint32_t key = wm::dropout_head_key(seed, (uint32_t)(g0 * kGroup + t));
      const uint32_t k = key ^ (key >> 16);
      k1[t] = k;
      const uint32_t b0 = __ballot_sync(~0u, k & 1u), b1 = __ballot_sync(~0u, k & 2u);
      if (t % kGroup == 0) {
        low[0][t / kGroup] = b0;
        low[1][t / kGroup] = b1;
      }
    }
    __syncthreads();
    const long long g = g0 + threadIdx.y;
    if (g >= words) continue;
    const uint32_t* rows = k1 + kGroup * threadIdx.y;
    const uint32_t b0 = low[0][threadIdx.y], b1 = low[1][threadIdx.y];
    for (int ct = blockIdx.y; ct < ctiles; ct += gridDim.y) {
      const uint32_t col0 = (uint32_t)(ct * tw + threadIdx.x) * kPackCols;
      const uint32_t cterm = col0 ^ (col0 >> 16);
      const uint4 w = packed_words(rows, cterm, b0 ^ (0u - (cterm & 1u)),
                                   b1 ^ (0u - ((cterm >> 1) & 1u)), carry);
      // inline PTX keeps the store one 16-byte STG (nvcc split a uint4 store here)
      asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(out + g * cols + col0),
                   "r"(w.x), "r"(w.y), "r"(w.z), "r"(w.w)
                   : "memory");
    }
  }
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
      v[e] = keep(keys[r], (uint32_t)(col0 + e), threshold)
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

// The bool masks' and B9p's grid: the column tiles along y, kBlocksPerSm blocks an SM in all
// along x, each walking its chunks.
inline cudaError_t mask_grid(long long chunks, long long ctiles, dim3* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long gy = ctiles < 65535 ? ctiles : 65535;
  const long long per_y = (long long)sms * kBlocksPerSm / gy;
  const long long gx = chunks < per_y ? chunks : per_y > 0 ? per_y : 1;
  *grid = dim3((unsigned)gx, (unsigned)gy);
  return cudaSuccess;
}

// B9b and B8m on the [rows, cols] view (cols a multiple of 128), n elements: a block's runs
// across are the most of 32, 16 and 8 that divide a row's 16-column runs.
template <bool kAtLeast>
int launch_bool_mask(void* out, long long rows, int cols, long long n, uint32_t seed,
                     uint32_t threshold, void* stream) {
  const int runs = cols / kVecBytes;
  const int tw = runs % 32 == 0 ? 32 : runs % 16 == 0 ? 16 : 8;
  dim3 grid;
  const cudaError_t err = mask_grid((rows + kTileRows - 1) / kTileRows, runs / tw, &grid);
  if (err != cudaSuccess) return err;
  const uint64_t addend = (1ull << 32) - threshold;
  const Carry carry = {(uint32_t)addend, (uint32_t)(addend >> 32), 256u};
  bool_mask_kernel<kAtLeast><<<grid, dim3(tw, kThreads / tw), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), rows, n / cols, cols, n, seed, carry);
  return cudaGetLastError();
}

// B9p on int32 [words, cols] (cols a multiple of 128): a block's runs of 4 columns across are
// 64 where they divide a row's runs, else 32 (which always do); the rest of its 128 threads
// go down, one word row each.
int launch_packed_mask(void* out, long long words, int cols, uint32_t seed,
                       uint32_t threshold, void* stream) {
  const int runs = cols / kPackCols;
  const int tw = runs % 64 == 0 ? 64 : 32, ry = kPackThreads / tw;
  dim3 grid;
  const cudaError_t err = mask_grid((words + ry - 1) / ry, runs / tw, &grid);
  if (err != cudaSuccess) return err;
  const uint64_t addend = (1ull << 32) - threshold;
  const PackCarry carry = {(uint32_t)addend, (uint32_t)(addend >> 32), threshold >> 16, 2u,
                           1u};
  packed_mask_kernel<<<grid, dim3(tw, ry), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), words, cols, seed, carry);
  return cudaGetLastError();
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
  return launch_bool_mask<true>(out, m, c, (long long)m * c, seed, threshold, stream);
}

// B9p: out int32 [m / 32, c], contiguous, m a multiple of 32, c of 128. keep iff
// bits >= threshold; bit i of word [g, j] is keep(32g + i, j).
int wm_packed_keep_mask(void* out, int m, int c, unsigned seed, unsigned threshold,
                        void* stream) {
  using namespace keep_mask;
  if (m < 0 || c <= 0 || m % kGroup || c % 128) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  return launch_packed_mask(out, m / kGroup, c, seed, threshold, stream);
}

// B8m: out bool [n] (any shape, contiguous), the lane view [ceil(n / 512), 512]. keep iff
// bits < threshold.
int wm_random_keep_mask(void* out, long long n, unsigned seed, unsigned threshold,
                        void* stream) {
  using namespace keep_mask;
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  return launch_bool_mask<false>(out, (n + kLanes - 1) / kLanes, kLanes, n, seed, threshold,
                                 stream);
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
