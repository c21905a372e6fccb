// The bfloat16 body of the attention forward on separate q, k, v for Hopper (sm_90a): kernel
// B3f (flash_attention.cu), launched by that file's `launch`.
//
// Replaces the TPU kernel `_fwd_kernel` (weathermodel_tpu/ops/pallas_attention.py:199, on
// `_fwd_body` :151-197). Per (batch row, head), q, k, v [T, hd] the head's slices, rnd = round
// to bf16:
//   qs = rnd(q rnd(scale));  s = qs . k^T;  e = exp(s - m),  recip = 1 / sum e      (fp32)
//   p = rnd(keep ? e (recip / (1 - rate)) : 0)        (dropout off: rnd(e recip))
//   o = rnd(p . v)                                    (fp32 sums)
// with the keep bits of attention_common.cuh: those B1's training form draws for the same
// seed and global (batch row, head), and that B3b regenerates.
//
// What bounds it: at B = 256, T = 365, H = 200, 10 heads of 20 the two T x T x hd products
// are 27.3 GFLOP (0.028 ms at the 989 TFLOP/s bf16 peak) against 149.5 MB of q, k, v and o
// (0.045 ms at 3.35 TB/s): bytes. In practice the softmax's element work sets the pace: two
// exponents a score (the TPU rounds p after the row's whole sum, so S is computed twice), the
// dropout hash once, the scaling, rounding and packing, on the 128 lanes and the 16
// exponent units an SM has a clock.
//
// Design: the query sweep of the backward body (attention_bwd_hopper.cuh) without dP, dO
// and the key sweep, on that body's loader and operand layout. One block per (batch row,
// head); its kWgs warpgroups take 64-row query tiles round robin.
//   * Operands: `load_operands` reads the head's q (scaled and rounded on the way in), k and
//     v once with 8-byte loads (no TMA box fits a head's 24- to 72-byte columns) into [kd x
//     64-position] slabs with the 128-byte swizzle; the spare depth column holds 1 in qs and
//     -inf in k at the keys past T, so s = -inf there and no score needs a mask.
//   * Loop 1: S = Qs . K^T slab by slab on m64n64k16 (A = Qs M-major, B = K N-major, both
//     through the transpose bits), a running max and sum of e per row, combined by the four
//     threads of a row into m and recip, which stay in registers.
//   * Loop 2: S again, p in the accumulator layout (each keep bit hashed here, once, never
//     stored), packed into bf16 A fragments in registers (the accumulator's layout is the A
//     operand's) and o += P . V on m64n{np}k16 (np = hd rounded up to 8), V the K-major B
//     operand (positions as K), as the backward's dq = dS . K reads K.
//   * o leaves the accumulators rounded once, through 4-byte stores into the head's columns
//     of the contiguous [B, T, H] output; rows past T are never stored.
// q, k and v share one row stride: three [B, T, H] tensors (H) or the column slices of the
// packed [B, T, 3H] projection (3H), which is how the model calls it.
// Shared memory: 3 kd T_pad x 2 B + 1 KB of alignment slack (T_pad = T rounded up to 64):
// 74,752 B at T = 365, hd 20 and 111,616 B at hd 36, so two blocks share an SM. Occupancy:
// kWgs = 2 warpgroups a block (256 threads, at most 128 registers, two blocks an SM, so that
// one block's operand loads overlap another's products). On an H100 80GB HBM3 at 700 W this
// took 0.674 ms against 0.812 for three warpgroups and one block an SM, as the backward
// runs, at the cell's shape with dropout 0.1 (PERF.md §6). Registers and spills: ptxas
// -v, printed by chip_smoke.py's kernel_flash (90-96 registers, no spills).
// Takes T up to 768 at hd 36, 1152 at hd 28 and 20, every T up to wm::kMaxContext at hd 12
// (`takes`, where the three slabs fit); past that flash_attention.cu's `launch` runs the
// scalar kernel, an explicit dispatch on the shape (ROADMAP R5). Needs H a multiple of 8 and
// the operands' rows 8-byte aligned; ops/flash_attention.py checks both and raises before any
// launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_bwd_hopper.cuh"
#include "attention_common.cuh"
#include "hopper_common.cuh"

// Everything here has internal linkage, as in the backward body it builds on.
namespace flash_fwd_hopper {
namespace {

using namespace hopper;
using attn_bwd_hopper::Dims;
using attn_bwd_hopper::ex2;
using attn_bwd_hopper::issue_product;
using attn_bwd_hopper::kLog2e;
using attn_bwd_hopper::kTile;
using attn_bwd_hopper::load_operands;
using attn_bwd_hopper::pack_fragments;
using attn_bwd_hopper::product_rs;
using attn_bwd_hopper::store_tile;

// warpgroups a block: two blocks an SM (see the note)
constexpr int kWgs = 2;
constexpr int kThreads = 128 * kWgs;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int stride;          // row stride of q, k and v, in elements
  __nv_bfloat16* out;  // [B, T, H]
  int t, h, heads, tiles;
  float scale;
  wm::Dropout drop;
};

// The dynamic shared memory a block takes for `tiles` 64-row tiles: qs, k and v, and slack
// to align them to 1024 bytes (the swizzle's period).
template <int HD>
__host__ __device__ constexpr int smem_bytes_for(int tiles) {
  return 3 * tiles * Dims<HD>::kSlab + 1024;
}

// s = Qs . K^T for one slab of keys; waits for it (and every earlier wgmma group).
template <int HD>
__device__ __forceinline__ void scores(float* s, uint32_t qslab, uint32_t kslab) {
  fence_regs<32>(s);
  wgmma_fence();
  issue_product<HD>(s, qslab, kslab);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<32>(s);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
    attention_fwd_wgmma_kernel(const __grid_constant__ Params p) {
  using D = Dims<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tiles = p.tiles, T = p.t;
  const uint32_t ops = tiles * D::kSlab;  // one operand's bytes
  const uint32_t qs_s = base, k_s = base + ops, v_s = base + 2 * ops;
  const int head = blockIdx.x % p.heads, row_b = blockIdx.x / p.heads;
  load_operands<HD, 3, kThreads>(base, ops, p.q, p.k, p.v, p.stride, nullptr, 0,
                                (size_t)row_b * T, head, tiles, T, p.scale);
  fence_async_smem();
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, q4 = lane & 3;
  const int rl = 16 * warp + (lane >> 2);  // this thread's rows of a tile: rl and rl + 8
  const bool drop_on = p.drop.on;
  const uint32_t threshold = p.drop.threshold;
  const uint32_t head_key = wm::dropout_head_key(p.drop.seed, blockIdx.x);
  __nv_bfloat16* const out = p.out + (size_t)row_b * T * p.h + head * HD;
  float s[32];

  for (int tile = wg; tile < tiles; tile += kWgs) {
    const int r0 = tile * kTile;
    const uint32_t qslab = qs_s + tile * D::kSlab;

    // loop 1: per row the max m and the sum of e = exp(s - m), rescaled online
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kb = 0; kb < tiles; ++kb) {
      scores<HD>(s, qslab, k_s + kb * D::kSlab);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 2 * hh; i < 32; i += 4) mx = fmaxf(fmaxf(mx, s[i]), s[i + 1]);
        const float mn = fmaxf(m[hh], mx);
        // while all of this thread's keys lie past T (mn = -inf), e stays 0
        const float nml = mn == -INFINITY ? 0.f : -mn * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) sum += ex2(fmaf(s[4 * j + 2 * hh + e], kLog2e, nml));
        l[hh] = l[hh] * ex2(fmaf(m[hh], kLog2e, nml)) + sum;  // 0 while m is -inf
        m[hh] = mn;
      }
    }
    // the four threads of a row combine; scl multiplies e into p
    float nml[2], scl[2];
    uint32_t row_key[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mq = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
      mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
      nml[hh] = -mq * kLog2e;  // key 0 is in every row, so mq is finite
      float lq = l[hh] * ex2(fmaf(m[hh], kLog2e, nml[hh]));
      lq += __shfl_xor_sync(0xffffffffu, lq, 1);
      lq += __shfl_xor_sync(0xffffffffu, lq, 2);
      const float recip = 1.f / lq;
      scl[hh] = drop_on ? recip / p.drop.keep_prob : recip;
      row_key[hh] = wm::dropout_row_key(head_key, r0 + rl + 8 * hh);
    }

    // loop 2: p per slab, packed into A fragments, o += P . V
    float o[D::kNp / 2];
#pragma unroll
    for (int i = 0; i < D::kNp / 2; ++i) o[i] = 0.f;
    for (int kb = 0; kb < tiles; ++kb) {
      scores<HD>(s, qslab, k_s + kb * D::kSlab);  // its wait also retires the last P . V
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e, key = kb * kTile + 8 * j + 2 * q4 + e;
            float pv = ex2(fmaf(s[i], kLog2e, nml[hh])) * scl[hh];
            if (drop_on && !wm::dropout_keep(row_key[hh], key, threshold)) pv = 0.f;
            s[i] = pv;
          }
      uint32_t pa[4][4];
      pack_fragments(pa, s);
      fence_regs<D::kNp / 2>(o);
      wgmma_fence();
      product_rs<HD>(o, pa, v_s + kb * D::kSlab);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs<D::kNp / 2>(o);
    store_tile<HD>(out, o, r0, rl, q4, T, p.h, 1.f);
  }
}

// ---- host side

// The most tiles whose three operands stay in a block's shared memory.
template <int HD>
constexpr int max_tiles() {
  return (kSmemMax - 1024) / (3 * Dims<HD>::kSlab);
}

// Whether the body takes t at head dim HD.
template <int HD>
constexpr bool takes(int t) {
  return t >= 1 && t <= wm::kMaxContext && (t + kTile - 1) / kTile <= max_tiles<HD>();
}

// The dynamic shared memory of a block at (HD, t), or 0 where the body does not take t.
template <int HD>
constexpr int smem_bytes_at(int t) {
  return takes<HD>(t) ? smem_bytes_for<HD>((t + kTile - 1) / kTile) : 0;
}

// Launch the body: q, k, v rows `stride` elements apart, out [batch, t, h]; h a multiple of
// 8, the stride a multiple of 4 and every base 8-byte aligned.
template <int HD>
cudaError_t launch(Params p, int batch, cudaStream_t stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
                          reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.out);
  if (!takes<HD>(p.t) || p.h % 8 || p.stride % 4 || bases % 8) return cudaErrorInvalidValue;
  p.tiles = (p.t + kTile - 1) / kTile;
  const int smem = smem_bytes_for<HD>(p.tiles);
  auto kernel = attention_fwd_wgmma_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)  // as much shared memory as the SM has, so that blocks share it
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)batch * p.heads, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The dynamic shared memory of a block at (hd, t), or 0 where the body does not take t.
inline int smem_bytes(int hd, int t) {
  switch (hd) {
    case 12: return smem_bytes_at<12>(t);
    case 20: return smem_bytes_at<20>(t);
    case 28: return smem_bytes_at<28>(t);
    case 36: return smem_bytes_at<36>(t);
    default: return 0;
  }
}

}  // namespace
}  // namespace flash_fwd_hopper
