// The bfloat16 body of the fused QKV projection + attention forward for Hopper (sm_90a):
// kernel B1 in its eval form (wm_fused_qkv_attention) and its training form
// (wm_fused_qkv_attention_train), and the first phase of kernel B5
// (wm::fused_qkv_attention_o), all in fused_qkv_attention.cu.
//
// Replaces the TPU kernels `_fused_fwd_kernel` (B1) and the attention of
// `_fused_fwd_outproj_kernel` (B5) in weathermodel_tpu/ops/pallas_attention.py. Per (batch
// row b, head), with x [B, T, H], w [3H, H], b [3H] in bf16 and hd = H / heads:
//   q, k, v = rnd(x[b] . W_head^T + b_head)        fp32 sums, the bias in fp32, one rounding
//   s = qs . k^T, qs = rnd(q rnd(scale))   scale = 1/sqrt(hd) from double, both forms
//                                          (train: the qkv residual written when kEmitQkv)
//   e = exp(s - m), m and the sum of e over all T keys of the row
//   p = rnd(e (1 / sum))                  eval, and train without dropout
//   p = keep ? rnd(e ((1 / sum) / (1 - rate))) : 0   train with dropout
//   o = rnd(p . v)                        fp32 sums
// with the keep bits of attention_common.cuh (B2 regenerates them) and the TPU kernel's
// rounding points (pallas_attention.py:151-197,209-231). The fp32 forms stay on the scalar
// body of fused_qkv_attention.cu and attention_fwd.cuh.
//
// What bounds it: at B = 256, T = 365, H = 576, 16 heads of 36, 186 GFLOP of projection and
// 79 of attention, 0.268 ms at the 989 TFLOP/s bf16 peak, against 216 MB of x and o:
// operations. Each block re-reads x[b] (420 KB) and its head's weight rows (135 KB) from L2,
// 2.3 GB a call over 4096 blocks; the softmax's exp, scaling, rounding and (train) hash run
// on the FMA and SFU pipes, about 20 instructions per score over two passes.
//
// Design: one block per (batch row, head), three consumer warpgroups and one producer warp.
//   * Phase 1, the projection, on wgmma m64nNk16 with N = 3 np (np = hd rounded up to 8):
//     the producer warp streams, per 64-column slab of H, one TMA box of x[b] (192 rows:
//     one 64-row tile per consumer, rows past T zero-filled by a 3-D map [B, T, H]) and one
//     box of the head's weight rows (a 3-D map [3, H, H]: the q, k and v parts, np rows
//     each, in one instruction; rows past H are zeros) into a ring of 2-4 stages with full
//     and empty mbarriers. Tiles go round-robin to the consumers, in passes of three (the
//     weight rows stream once a pass). Each consumer's epilogue adds the bias, rounds,
//     writes the training form's qkv with 4-byte stores (a head's columns start 8-byte
//     aligned at hd = 36, so no TMA store box fits them), and keeps q, k and v on chip:
//       q as wgmma A fragments (rows 16 w + lane / 4 (+ 8)), kd = hd rounded up to 16
//         deep, zero past hd, in a thread-ordered array (each thread stores and reloads
//         its own words);
//       k as K^T [kd rows x 64 keys] slabs, v as V^T [np rows x 64 keys] slabs, 128-byte
//         swizzled: the B operands of q . k^T (N-major, the transpose bit) and of p . v
//         (K-major), the depth and the width padded with zeros in shared memory only.
//   * Phase 2, per 64-row query tile: m and the sum over all keys come first, as the TPU
//     kernel rounds p after both, so S is computed twice. Pass A: S = Q . K^T slab by
//     slab (m64n64k16, A from registers), a running max and rescaled sum per thread,
//     combined across the four threads of a row. Pass B: S again, p from the accumulator
//     layout (the keep bit per element), packed to bf16 A fragments in registers (the
//     accumulator's layout is the A operand's) and o += P . V^T on m64n{np}k16.
//   Keys past T get s = -inf, so p = 0 there; rows past T are never stored.
// Shared memory at T = 365, hd = 36: K^T 36 KB, V^T 30 KB, Q 36 KB and three 39 KB
// stages. Why the weight rows stream: kept resident (135 KB) beside K^T, V^T and Q
// (102 KB) they do not fit in the 227 KB a block has, so they come in once a pass of
// three tiles (twice at T = 365) with x[b]'s rows, each read once. A cluster of a batch
// row's heads sharing x by TMA multicast is not built: the FFN body measured multicast
// slower (PERF.md).
// Long T (kStream). K^T and V^T stay resident while they fit beside Q and a two-stage
// ring (`resident`: up to 512 at hd 36, 768 at 28, 896 at 20, 1728 at 12). Past that, phase
// 1's epilogue writes each tile's K^T and V^T slabs, as the byte image of their swizzled
// shared-memory layout, into a device workspace (kSlabPair bytes a tile and block: the
// eval form has no qkv output to read them back from, and TMA cannot transpose the
// training form's), fences them for the async proxy, and the producer warp, after a
// barrier with the consumers, streams them back through the same ring by TMA bulk copies:
// per round of three query tiles, pass A's K^T slabs, then pass B's K^T + V^T slabs, each
// stage read by the three consumers and released by each. Q stays as register fragments
// (kept in shared memory between the phases), so T is bounded by Q's fragments beside two
// stages: 1536 at hd 36 (wm::kMaxContext, the limit of every attention kernel). Needs H a
// multiple of 8 (TMA's 16-byte strides) and x and w 16-byte aligned;
// ops/fused_qkv_attention.py checks all three and T, and raises before any launch.
// Registers, spills and dynamic shared memory of each instantiation: ptxas -v, printed by
// chip_smoke.py's kernel phase.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper_common.cuh"

namespace attn_hopper {

using namespace hopper;

constexpr int kWgs = 3;                    // consumer warpgroups
constexpr int kThreads = 128 * kWgs + 32;  // and one producer warp
constexpr int kTile = 64;                  // query rows of a tile, keys of a K^T / V^T slab
constexpr int kXRows = kTile * kWgs;       // x rows a stage holds: a tile per consumer
constexpr int kXBytes = kXRows * 128;      // [kXRows x 64] bf16, 128-byte swizzle
constexpr int kMaxStages = 4;
constexpr int kBars = 2 * 8 * kMaxStages;  // full and empty mbarriers
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Dims {
  static constexpr int kNp = (HD + 7) / 8 * 8;     // a part's weight rows; V^T rows; P.V's N
  static constexpr int kKd = (HD + 15) / 16 * 16;  // q . k^T's depth; K^T rows
  static constexpr int kKsteps = kKd / 16;
  static constexpr int kNproj = 3 * kNp;           // the projection's N
  static constexpr int kStageBytes = kXBytes + kNproj * 128;
  static constexpr int kKtSlab = kKd * 128;
  static constexpr int kVtSlab = kNp * 128;
  static constexpr int kSlabPair = kKtSlab + kVtSlab;  // a tile's K^T and V^T (kStream)
  static constexpr int kQTile = kKsteps * 4 * 128 * 4;  // a tile's Q fragments
  static constexpr int kPerTile = kKtSlab + kVtSlab + kQTile;
  static_assert(kSlabPair <= kStageBytes, "a stage holds a tile's K^T and V^T");
};

// Byte offsets into the block's dynamic shared memory (after aligning it to 1024): the
// ring, then K^T, V^T (1024-byte multiples; none when they stream), the Q fragments and
// the mbarriers.
struct Smem {
  int ring, kt, vt, q, bars, stages, total;
};

template <int HD>
__host__ __device__ inline Smem smem_layout(int tiles, bool stream) {
  using D = Dims<HD>;
  Smem s;
  const int per_tile = stream ? D::kQTile : D::kPerTile;
  const int fit = (kSmemMax - 1024 - kBars - tiles * per_tile) / D::kStageBytes;
  s.stages = fit < kMaxStages ? fit : kMaxStages;
  s.ring = 0;
  s.kt = s.stages * D::kStageBytes;
  s.vt = s.kt + (stream ? 0 : tiles * D::kKtSlab);
  s.q = s.vt + (stream ? 0 : tiles * D::kVtSlab);
  s.bars = s.q + tiles * D::kQTile;
  s.total = s.bars + kBars + 1024;  // + slack for the alignment
  return s;
}

// Whether `tiles` query tiles keep K^T and V^T resident: the ring needs two stages.
template <int HD>
inline bool resident(int tiles) {
  return smem_layout<HD>(tiles, false).stages >= 2;
}

struct Params {
  CUtensorMap tm_x;  // x as (H, T, B): boxes of [kXRows x 64] in one batch row
  CUtensorMap tm_w;  // w as (H, H, 3 parts): boxes of [3 x np x 64], a head's q, k, v rows
  const __nv_bfloat16* bias;
  __nv_bfloat16* out;
  __nv_bfloat16* qkv;
  unsigned char* ws;  // kStream: kSlabPair bytes a tile and block
  int t, h, heads, tiles, passes, nks, stages;
  float scale;
  wm::Dropout drop;
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(lo, hi);
}

__device__ __forceinline__ void store_u16(unsigned char* dst, float v) {
  *reinterpret_cast<uint16_t*>(dst) = bf16_bits(v);
}

namespace {

// s[64 x 64] = Q . K^T for one slab of 64 keys: A from registers, B N-major from the slab
template <int HD>
__device__ __forceinline__ void scores(float* s, uint32_t (*qa)[4], uint32_t kt_slab) {
  fence_regs<32>(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Dims<HD>::kKsteps; ++kk)
    WgmmaRs<64, 1>::mma(s, qa[kk], make_desc(kt_slab + kk * 2048, 1024, 1024, 1), kk != 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<32>(s);
}

template <int HD, bool kTrain, bool kEmitQkv, bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
    qkv_attention_wgmma_kernel(const __grid_constant__ Params p) {
  using D = Dims<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem L = smem_layout<HD>(p.tiles, kStream);
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + L.ring, kt = base + L.kt, vt = base + L.vt, qf = base + L.q;
  const uint32_t full = base + L.bars, empty = full + 8 * kMaxStages;
  const int S = p.stages;
  const int head = blockIdx.x % p.heads, row_b = blockIdx.x / p.heads;
  // kStream: this block's K^T and V^T slabs in the workspace, tile after tile
  unsigned char* const ws = kStream ? p.ws + (size_t)blockIdx.x * p.tiles * D::kSlabPair
                                    : nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWgs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // ---- the producer warp: per pass and slab of H, x's tiles and the head's weight rows;
  // with kStream, then phase 2's K^T and V^T slabs from the workspace
  if (threadIdx.x >= 128 * kWgs) {
    const bool lead = threadIdx.x == 128 * kWgs;
    if (lead) {
      const int n_loads = p.passes * p.nks;
      for (int n = 0; n < n_loads; ++n) {
        const int st = n % S, pass = n / p.nks, ks = n % p.nks;
        if (n >= S) mbar_wait(empty + 8 * st, (n / S - 1) & 1);
        const uint32_t dst = ring + st * D::kStageBytes, bar = full + 8 * st;
        mbar_expect_tx(bar, D::kStageBytes);
        tma_load3d(dst, &p.tm_x, bar, 64 * ks, pass * kXRows, row_b);
        tma_load3d(dst + kXBytes, &p.tm_w, bar, 64 * ks, head * HD, 0);
      }
    }
    if constexpr (kStream) {
      __syncwarp();
      named_sync(1, kThreads);  // every tile's K^T and V^T is in the workspace
      if (lead) {
        // per round of kWgs query tiles: pass A's K^T slabs, then pass B's K^T + V^T
        const int n0 = p.passes * p.nks, n_loads = p.passes * 2 * p.tiles;
        for (int i = 0; i < n_loads; ++i) {
          const int n = n0 + i, st = n % S, kb = i % p.tiles;
          const uint32_t bytes = (i / p.tiles) % 2 ? D::kSlabPair : D::kKtSlab;
          if (n >= S) mbar_wait(empty + 8 * st, (n / S - 1) & 1);
          mbar_expect_tx(full + 8 * st, bytes);
          bulk_load(ring + st * D::kStageBytes, ws + (size_t)kb * D::kSlabPair, bytes,
                    full + 8 * st);
        }
      }
    }
    return;  // the consumers synchronize among themselves from here on
  }

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, q4 = lane & 3;
  const int rl = 16 * warp + (lane >> 2);  // this thread's rows of a tile: rl and rl + 8
  const int T = p.t, H = p.h;
  const float scale_t = wm::round_to<__nv_bfloat16>(p.scale);  // q's scale, rounded once

  // ---- phase 1: q, k, v of tile pass * kWgs + wg, for every pass
  for (int pass = 0; pass < p.passes; ++pass) {
    const int tile = pass * kWgs + wg;
    const bool active = tile < p.tiles;
    float acc[D::kNproj / 2];
#pragma unroll
    for (int v = 0; v < D::kNproj / 2; ++v) acc[v] = 0.f;
    // wgmma groups one deep: after committing slab ks, wait for slab ks - 1's group and
    // release its stage. Every consumer waits for and releases every stage, with a tile
    // or without, so that each empty barrier counts one arrival per consumer and use.
    for (int ks = 0; ks < p.nks; ++ks) {
      const int n = pass * p.nks + ks, st = n % S;
      mbar_wait(full + 8 * st, (n / S) & 1);
      __syncwarp();
      if (active) {
        const uint32_t xs = ring + st * D::kStageBytes + wg * kTile * 128;
        const uint32_t ws_ = ring + st * D::kStageBytes + kXBytes;
        fence_regs<D::kNproj / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<D::kNproj, 0>::mma(acc, make_desc(xs + kk * 32, 16, 1024, 1),
                                   make_desc(ws_ + kk * 32, 16, 1024, 1), (ks | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (ks > 0 && t == 0) mbar_arrive(empty + 8 * ((n - 1) % S));
      } else if (t == 0) {
        mbar_arrive(empty + 8 * st);
      }
      __syncwarp();
    }
    if (!active) continue;
    wgmma_wait<0>();
    fence_regs<D::kNproj / 2>(acc);
    if (t == 0) mbar_arrive(empty + 8 * ((pass * p.nks + p.nks - 1) % S));

    // epilogue: bias, rounding; the qkv residual; q fragments on chip, K^T and V^T on chip
    // or (kStream) in the workspace
    const int r0 = tile * kTile;
    const uint32_t kts = kt + tile * D::kKtSlab, vts = vt + tile * D::kVtSlab;
    unsigned char* const gkt = kStream ? ws + (size_t)tile * D::kSlabPair : nullptr;
    unsigned char* const gvt = kStream ? gkt + D::kKtSlab : nullptr;
    uint32_t qpk[D::kNp / 8][2];  // q's packed pairs by column group and row half
#pragma unroll
    for (int j = 0; j < D::kNproj / 8; ++j) {
      const int part = 8 * j / D::kNp;
      const int d = 8 * j - part * D::kNp + 2 * q4;  // the head's column (even)
      const bool in = d < HD;
      float b0 = 0.f, b1 = 0.f;
      if (in) {
        const __nv_bfloat16* bp = p.bias + part * H + head * HD + d;
        b0 = __bfloat162float(bp[0]);
        b1 = __bfloat162float(bp[1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = rl + 8 * hh, row = r0 + r;
        float v0 = wm::round_to<__nv_bfloat16>(acc[4 * j + 2 * hh] + b0);
        float v1 = wm::round_to<__nv_bfloat16>(acc[4 * j + 2 * hh + 1] + b1);
        if (!in) v0 = v1 = 0.f;
        if constexpr (kEmitQkv) {
          if (in && row < T)
            store_pair(p.qkv + ((size_t)row_b * T + row) * 3 * H + part * H + head * HD + d,
                       v0, v1);
        }
        if (part == 0) {
          v0 = wm::round_to<__nv_bfloat16>(v0 * scale_t);
          v1 = wm::round_to<__nv_bfloat16>(v1 * scale_t);
          qpk[j < D::kNp / 8 ? j : 0][hh] = pack_bf16(v0, v1);
        } else if constexpr (kStream) {
          unsigned char* slab = part == 1 ? gkt : gvt;
          store_u16(slab + sw128(d, r), v0);
          store_u16(slab + sw128(d + 1, r), v1);
        } else if (part == 1) {
          st_shared_u16(kts + sw128(d, r), bf16_bits(v0));
          st_shared_u16(kts + sw128(d + 1, r), bf16_bits(v1));
        } else {
          st_shared_u16(vts + sw128(d, r), bf16_bits(v0));
          st_shared_u16(vts + sw128(d + 1, r), bf16_bits(v1));
        }
      }
    }
    // A fragment g of k-step kk: column group 2 kk + g / 2, row half g % 2
#pragma unroll
    for (int kk = 0; kk < D::kKsteps; ++kk)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int j = 2 * kk + g / 2;
        st_shared(qf + tile * D::kQTile + ((kk * 4 + g) * 128 + t) * 4,
                  j < D::kNp / 8 ? qpk[j < D::kNp / 8 ? j : 0][g % 2] : 0u);
      }
    // K^T rows np..kd-1 (the depth's padding) are zeros: whole rows, so in any order
    constexpr int kPadWords = (D::kKd - D::kNp) * 128 / 8;
    for (int i = t; i < kPadWords; i += 128) {
      if constexpr (kStream) {
        *reinterpret_cast<uint2*>(gkt + D::kNp * 128 + 8 * i) = make_uint2(0u, 0u);
      } else {
        asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(kts + D::kNp * 128 + 8 * i),
                     "r"(0u), "r"(0u)
                     : "memory");
      }
    }
  }
  if constexpr (kStream) {
    fence_proxy_async();      // the workspace's slabs, before TMA reads them back
    named_sync(1, kThreads);  // with the producer warp
  } else {
    fence_async_smem();
    named_sync(1, 128 * kWgs);  // every tile's q, K^T and V^T are in shared memory
  }

  // ---- phase 2: softmax(s) . v per query tile. The K^T and V^T slab kb: resident, or
  // (kStream) the ring's next stage, which every consumer takes and releases in every
  // round of kWgs tiles, with a tile or without
  uint32_t head_key = 0;
  if constexpr (kTrain) head_key = wm::dropout_head_key(p.drop.seed, blockIdx.x);
  const bool drop_on = kTrain && p.drop.on;
  int n = p.passes * p.nks;  // kStream: the ring's next slab
  auto acquire = [&](int kb) -> uint32_t {
    if constexpr (kStream) {
      const int st = n % S;
      mbar_wait(full + 8 * st, (n / S) & 1);
      __syncwarp();
      return ring + st * D::kStageBytes;
    } else {
      return kt + kb * D::kKtSlab;
    }
  };
  auto release = [&]() {  // after the wgmma groups that read the slab completed
    if constexpr (kStream) {
      if (t == 0) mbar_arrive(empty + 8 * (n % S));
      __syncwarp();
      ++n;
    }
  };
  const int tile_end = kStream ? p.passes * kWgs : p.tiles;
  for (int tile = wg; tile < tile_end; tile += kWgs) {
    const bool active = !kStream || tile < p.tiles;
    uint32_t qa[D::kKsteps][4];
#pragma unroll
    for (int kk = 0; kk < D::kKsteps; ++kk)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        qa[kk][g] = active ? ld_shared(qf + tile * D::kQTile + ((kk * 4 + g) * 128 + t) * 4)
                           : 0u;
    const int r0 = tile * kTile;
    float s[32];

    // pass A: the row max m and the sum of exp(s - m) over all keys
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kb = 0; kb < p.tiles; ++kb) {
      const uint32_t kslab = acquire(kb);
      if (active) {
        scores<HD>(s, qa, kslab);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hh + e, key = kb * kTile + 8 * j + 2 * q4 + e;
              const float x = key < T ? s[i] : -INFINITY;
              s[i] = x;
              mx = fmaxf(mx, x);
            }
          const float mn = fmaxf(m[hh], mx);
          if (mn != -INFINITY) {
            const float ml = mn * kLog2e;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) sum += ex2(fmaf(s[4 * j + 2 * hh + e], kLog2e, -ml));
            l[hh] = l[hh] * ex2(fmaf(m[hh], kLog2e, -ml)) + sum;
            m[hh] = mn;
          }
        }
      }
      release();
    }
    // the four threads of a row combine; scl multiplies e into p
    float ml[2], scl[2];
    uint32_t row_key[2] = {0u, 0u};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mq = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
      mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
      ml[hh] = mq * kLog2e;  // key 0 is in every row, so mq is finite
      float lq = l[hh] * ex2(fmaf(m[hh], kLog2e, -ml[hh]));
      lq += __shfl_xor_sync(0xffffffffu, lq, 1);
      lq += __shfl_xor_sync(0xffffffffu, lq, 2);
      const float recip = 1.f / lq;
      scl[hh] = drop_on ? recip / p.drop.keep_prob : recip;
      if constexpr (kTrain) row_key[hh] = wm::dropout_row_key(head_key, r0 + rl + 8 * hh);
    }

    // pass B: p per slab, packed into A fragments, o += P . V^T
    float o[D::kNp / 2];
#pragma unroll
    for (int v = 0; v < D::kNp / 2; ++v) o[v] = 0.f;
    for (int kb = 0; kb < p.tiles; ++kb) {
      const uint32_t kslab = acquire(kb);
      if (active) {
        scores<HD>(s, qa, kslab);  // its wait also retires the last P . V
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * hh + e, key = kb * kTile + 8 * j + 2 * q4 + e;
              float pv = key < T ? ex2(fmaf(s[i], kLog2e, -ml[hh])) * scl[hh] : 0.f;
              if (drop_on && !wm::dropout_keep(row_key[hh], key, p.drop.threshold)) pv = 0.f;
              s[i] = pv;
            }
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            pa[kk][g] = pack_bf16(s[8 * kk + 2 * g], s[8 * kk + 2 * g + 1]);
        fence_regs<D::kNp / 2>(o);
        wgmma_fence();
        const uint32_t vts = kStream ? kslab + D::kKtSlab : vt + kb * D::kVtSlab;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaRs<D::kNp, 0>::mma(o, pa[kk], make_desc(vts + kk * 32, 16, 1024, 1), 1);
        wgmma_commit();
        if constexpr (kStream) wgmma_wait<0>();  // before the stage is released
      }
      release();
    }
    if (!active) continue;
    wgmma_wait<0>();
    fence_regs<D::kNp / 2>(o);

    // o rounded once, this head's columns of its rows below T
#pragma unroll
    for (int j = 0; j < D::kNp / 8; ++j) {
      const int d = 8 * j + 2 * q4;
      if (d >= HD) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + rl + 8 * hh;
        if (row < T)
          store_pair(p.out + ((size_t)row_b * T + row) * H + head * HD + d, o[4 * j + 2 * hh],
                     o[4 * j + 2 * hh + 1]);
      }
    }
  }
}

}  // namespace

// ---- host side

template <int HD, bool kTrain, bool kEmitQkv, bool kStream>
cudaError_t launch_body(Params& p, int batch, cudaStream_t stream) {
  const Smem L = smem_layout<HD>(p.tiles, kStream);
  if (L.stages < 2) return cudaErrorInvalidValue;
  p.stages = L.stages;
  auto kernel = qkv_attention_wgmma_kernel<HD, kTrain, kEmitQkv, kStream>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)batch * p.heads, kThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

// Launch the body: x [batch, t, h], w [3h, h], b [3h], o [batch, t, h], qkv [batch, t, 3h]
// (kEmitQkv) in bf16, x and w 16-byte aligned, h a multiple of 8, t up to wm::kMaxContext;
// ws workspace_bytes<HD>(t) for each of the batch x heads blocks (null where that is 0).
template <int HD, bool kTrain, bool kEmitQkv>
cudaError_t launch(const void* x, const void* w, const void* b, void* o, void* qkv, void* ws,
                   int batch, int t, int h, int heads, float scale, wm::Dropout drop,
                   cudaStream_t stream) {
  if (h % 8 || t > wm::kMaxContext || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return cudaErrorInvalidValue;
  using D = Dims<HD>;
  Params p = {};
  const cuuint64_t xdims[3] = {(cuuint64_t)h, (cuuint64_t)t, (cuuint64_t)batch};
  const cuuint64_t xstr[2] = {(cuuint64_t)h * 2, (cuuint64_t)t * h * 2};
  const cuuint32_t xbox[3] = {64, kXRows, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)h, (cuuint64_t)h, 3};
  const cuuint64_t wstr[2] = {(cuuint64_t)h * 2, (cuuint64_t)h * h * 2};
  const cuuint32_t wbox[3] = {64, (cuuint32_t)D::kNp, 3};
  if (!make_map_nd(&p.tm_x, x, 3, xdims, xstr, xbox, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_nd(&p.tm_w, w, 3, wdims, wstr, wbox, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  p.bias = static_cast<const __nv_bfloat16*>(b);
  p.out = static_cast<__nv_bfloat16*>(o);
  p.qkv = static_cast<__nv_bfloat16*>(qkv);
  p.ws = static_cast<unsigned char*>(ws);
  p.t = t;
  p.h = h;
  p.heads = heads;
  p.tiles = (t + kTile - 1) / kTile;
  p.passes = (p.tiles + kWgs - 1) / kWgs;
  p.nks = (h + 63) / 64;
  p.scale = scale;
  p.drop = drop;
  if (resident<HD>(p.tiles)) return launch_body<HD, kTrain, kEmitQkv, false>(p, batch, stream);
  if (ws == nullptr || reinterpret_cast<uintptr_t>(ws) % 16) return cudaErrorInvalidValue;
  return launch_body<HD, kTrain, kEmitQkv, true>(p, batch, stream);
}

// The device workspace a block takes at (HD, t), in bytes: 0 where K^T and V^T stay
// resident.
template <int HD>
inline long long workspace_bytes(int t) {
  const int tiles = (t + kTile - 1) / kTile;
  return resident<HD>(tiles) ? 0 : (long long)tiles * Dims<HD>::kSlabPair;
}

template <int HD>
inline int smem_bytes_at(int t) {
  const int tiles = (t + kTile - 1) / kTile;
  const Smem L = smem_layout<HD>(tiles, !resident<HD>(tiles));
  return L.stages >= 2 ? L.total : 0;
}

// The dynamic shared memory of a block at (hd, t), or 0 where the body does not take t.
inline int smem_bytes(int hd, int t) {
  if (t <= 0 || t > wm::kMaxContext) return 0;
  switch (hd) {
    case 12: return smem_bytes_at<12>(t);
    case 20: return smem_bytes_at<20>(t);
    case 28: return smem_bytes_at<28>(t);
    case 36: return smem_bytes_at<36>(t);
    default: return 0;
  }
}

}  // namespace attn_hopper
