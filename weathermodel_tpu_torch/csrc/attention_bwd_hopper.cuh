// The bfloat16 body of the attention backward for Hopper (sm_90a): kernels B2
// (fused_qkv_attention_bwd.cu, packed qkv in and dqkv out) and B3b (flash_attention_bwd.cu,
// separate q, k, v in and dq, dk, dv out), launched by attention_bwd.cuh's `launch_bwd`.
//
// Replaces the TPU kernels `_bwd_kernel_qkv` (pallas_attention.py:391) and `_bwd_kernel`
// (:288) in weathermodel_tpu/ops/pallas_attention.py, both on `_bwd_head_math` (:330-388).
// Per (batch row, head), q, k, v, dO [T, hd] the head's slices, rnd = round to bf16:
//   qs = rnd(q rnd(scale));  s = qs . k^T;  w = exp(s - m) recip            (fp32)
//   wd = rnd(keep ? w inv_keep : 0);  dw = keep ? dwd inv_keep : 0,  dwd = dO . v^T
//   rowsum = sum_j dw w;  ds = rnd(w (dw - rowsum))
//   dq = rnd((ds . k) scale),  dk = rnd(ds^T . qs),  dv = rnd(wd^T . dO)
// with every sum in fp32 and the keep bits of attention_common.cuh, regenerated from the
// forward's seed, the global (batch row, head) and the query row, never stored.
//
// What bounds it: at B = 288, T = 365, H = 576, 16 heads of 36 the five T x T x hd products
// are 221 GFLOP (0.22 ms at the 989 TFLOP/s bf16 peak) against 847 MB in and out (0.25 ms
// at 3.35 TB/s): bytes, by a little. In practice the softmax's element work sets the pace:
// some 40-60 FMA, SFU and integer instructions a score over the three sweeps below (three
// exponents, the dropout hash once, w, dw, ds, the roundings and packs), on the 128 lanes
// an SM issues a clock.
//
// Design: one block per (batch row, head), three warpgroups (384 threads), no producer.
//   * Operands resident in shared memory (`load_operands`, which B3f's forward body,
//     flash_attention_hopper.cuh, shares for q, k and v). The block reads its head's q, k,
//     v and dO once with 8-byte loads (a head's columns start 8-byte aligned at every head
//     dim: 72, 56, 40 or 24 bytes a head, so no TMA box fits them), scales and rounds q on
//     the way in,
//     and stores each as [kd rows x 64 positions] slabs with the 128-byte swizzle (kd = hd
//     rounded up to 16), depth past hd and rows past T zero, except the last depth column
//     (kd - hd >= 4 at every head dim): 1 in qs and -inf in k at the keys past T, so that
//     the products give s = -inf there exactly and no score needs a mask. One layout serves every
//     product an operand enters: as B with positions as N it is N-major (the transpose
//     bit; K^T in S = Qs . K^T), with positions as K it is K-major (K in dq = dS . K), and
//     as A with positions as M it is M-major (A's transpose bit; K in S^T = K . Qs^T).
//   * Query sweep: a warpgroup per 64-row query tile, round robin. Loop 1 computes S and
//     dP = dO . V^T slab by slab (m64n64k16, A = Qs and dO transposed from shared memory)
//     and keeps per row the running max, the sum of e and the sum of keep dwd e, rescaled
//     online; the four threads of a row combine them into m, recip and rowsum, which go to
//     shared memory with the row's dropout key. With dropout, loop 1 also hashes each keep
//     bit once and the row's four threads gather them into a 64-bit word per key slab in
//     shared memory (`kBits`, T_pad^2 / 8 bytes, where they fit beside the operands: T up
//     to 448 at hd 36; past that each sweep hashes again). Loop 2 computes S and dP again,
//     forms w, the keep bit, dw and ds in the accumulator layout, packs ds into bf16 A
//     fragments in
//     registers (the accumulator's layout is the A operand's) and runs dq += dS . K on
//     m64n{np}k16 (np = hd rounded up to 8). The TPU rounds ds after rowsum is complete,
//     so S is computed twice, as the forward computes it twice.
//   * Key sweep, after a barrier of the block: a warpgroup per 64-key tile. Over the query
//     slabs it computes S^T = K . Qs^T and dP^T = V . dO^T, forms wd^T and dS^T from the
//     query rows' statistics and keep bits (or keys) in shared memory, and runs dv += P^T .
//     dO and dk += dS^T . Qs with A from registers and B K-major.
//   Nine T x T x kd products against the five of the minimum; in exchange no atomics and
//   a fixed summation order (the port's rule: sums across blocks use no atomics), so two
//   calls give the same bits. Keys past T get s = -inf; query rows past T have dO = 0, qs
//   = 0 and finite statistics, so they add nothing, and are never stored. Outputs leave the
//   accumulators through 4-byte stores into each head's columns.
// Shared memory: 4 kd T_pad x 2 B of operands + 16 B of statistics a query row (T_pad = T
// rounded up to 64), and with dropout the keep bits: 154,624 B (+ 18,432) at T = 365, hd
// 36 and 105,472 B (+ 18,432) at hd 20. The body takes T
// up to 576 at hd 36, 832 at hd 28 and 20, and every T up to wm::kMaxContext at hd 12
// (`max_tiles`); past that attention_bwd.cuh's `launch_bwd` runs the scalar passes, an
// explicit dispatch on the shape (ROADMAP R5: stream the slabs through a ring, as
// attention_hopper.cuh's kStream does). Needs H a multiple of 8 and every operand's rows
// 8-byte aligned; ops/fused_qkv_attention.py and ops/flash_attention.py check both and
// raise before any launch. Registers and spills of each instantiation: ptxas -v, printed
// by chip_smoke.py's kernel_train and kernel_flash phases.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper_common.cuh"

// Everything here has internal linkage: B2's and B3b's files each compile their own copy.
namespace attn_bwd_hopper {
namespace {

using namespace hopper;

constexpr int kWgs = 3;                // warpgroups
constexpr int kThreads = 128 * kWgs;
constexpr int kTile = 64;              // query rows or keys of a tile; positions of a slab
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Dims {
  static constexpr int kNp = (HD + 7) / 8 * 8;     // N of the dq, dk and dv products
  static constexpr int kKd = (HD + 15) / 16 * 16;  // depth of S and dP; a slab's rows
  static constexpr int kKsteps = kKd / 16;
  static constexpr int kSlab = kKd * 128;          // one operand's 64 positions
  static constexpr int kPerTile = 4 * kSlab + kTile * 16;  // four operands + statistics
};

// A query row's statistics, written by the query sweep and read by the key sweep.
struct __align__(16) Stat {
  float nml;     // -m log2(e)
  float recip;   // 1 / sum(e)
  float rowsum;  // sum_j dw w
  uint32_t key;  // the row's dropout key
};

// The dynamic shared memory a block takes for `tiles` 64-row tiles: operands, statistics,
// with `bits` the dropout keep bits (8 B a query row and key slab), and slack to align
// them to 1024 bytes (the swizzle's period).
template <int HD>
__host__ __device__ constexpr int smem_bytes_for(int tiles, bool bits) {
  return tiles * Dims<HD>::kPerTile + (bits ? tiles * tiles * kTile * 8 : 0) + 1024;
}

// The most tiles whose operands stay resident in a block's shared memory (without the
// dropout keep bits, which the body keeps only where they fit beside them).
template <int HD>
constexpr int max_tiles() {
  return (kSmemMax - 1024) / Dims<HD>::kPerTile;
}

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int in_stride;  // row stride of q, k and v, in elements
  const __nv_bfloat16* dout;  // [B, T, H]
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int out_stride;  // row stride of dq, dk and dv, in elements
  int t, h, heads, tiles;
  float scale;
  wm::Dropout drop;
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// s = A . B on m64n64k16 over the depth kd, A M-major and B N-major from shared memory
// slabs (A's and B's transpose bits). Issued, not committed.
template <int HD>
__device__ __forceinline__ void issue_product(float* s, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < Dims<HD>::kKsteps; ++kk)
    Wgmma<64, 1, 1>::mma(s, make_desc(a + kk * 2048, 1024, 1024, 1),
                         make_desc(b + kk * 2048, 1024, 1024, 1), kk != 0);
}

// s = A1 . B1 and dp = A2 . B2 as issue_product; waits for them.
template <int HD>
__device__ __forceinline__ void two_products(float* s, float* dp, uint32_t a1, uint32_t b1,
                                             uint32_t a2, uint32_t b2) {
  fence_regs<32>(s);
  fence_regs<32>(dp);
  wgmma_fence();
  issue_product<HD>(s, a1, b1);
  issue_product<HD>(dp, a2, b2);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<32>(s);
  fence_regs<32>(dp);
}

// acc[64 x np] += A . B over one slab of 64 positions: A the packed bf16 fragments of a
// 64 x 64 accumulator, B the slab K-major (positions as K, its rows as N). Committed, not
// waited for.
template <int HD>
__device__ __forceinline__ void product_rs(float* acc, uint32_t (*a)[4], uint32_t slab) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    WgmmaRs<Dims<HD>::kNp, 0>::mma(acc, a[kk], make_desc(slab + kk * 32, 16, 1024, 1), 1);
}

// A fragments of a 64 x 64 fp32 accumulator, rounded to bf16
__device__ __forceinline__ void pack_fragments(uint32_t (*a)[4], const float* x) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int g = 0; g < 4; ++g) a[kk][g] = pack_bf16(x[8 * kk + 2 * g], x[8 * kk + 2 * g + 1]);
}

// Store the rows below T of a [64 x np] accumulator, times `mul` and rounded, into this
// head's columns of `out` (rows `stride` elements apart from the batch row's first).
template <int HD>
__device__ __forceinline__ void store_tile(__nv_bfloat16* out, const float* acc, int r0,
                                           int rl, int q4, int T, int stride, float mul) {
#pragma unroll
  for (int j = 0; j < Dims<HD>::kNp / 8; ++j) {
    const int d = 8 * j + 2 * q4;
    if (d >= HD) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + rl + 8 * hh;
      if (row < T)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * stride + d) =
            pack_bf16(acc[4 * j + 2 * hh] * mul, acc[4 * j + 2 * hh + 1] * mul);
    }
  }
}

// A block's operands into shared memory as [kd x 64-position] slabs, 128-byte swizzled,
// `ops` bytes an operand from `base`: q (scaled by rnd(scale) and rounded), k, v and, with
// kOps = 4, dO, each the head's columns of rows `in_row0` on (q, k, v `stride` elements
// apart, dO `dstride`). Per pair of positions and quad of depth, two 8-byte loads and four
// 4-byte stores (the pair is adjacent in a swizzled row), by the block's kBlock threads.
// Depth past hd and rows past T are zero, except the last depth column (kd - hd >= 4 at
// every head dim): 1 in qs and -inf in k at the keys past T, so that s = -inf exactly there.
template <int HD, int kOps, int kBlock>
__device__ __forceinline__ void load_operands(uint32_t base, uint32_t ops,
                                              const __nv_bfloat16* q, const __nv_bfloat16* k,
                                              const __nv_bfloat16* v, int stride,
                                              const __nv_bfloat16* dout, int dstride,
                                              size_t in_row0, int head, int tiles, int T,
                                              float scale) {
  using D = Dims<HD>;
  const float scale_t = wm::round_to<__nv_bfloat16>(scale);
  constexpr int kQuads = D::kKd / 4;
  const int per_op = tiles * (kTile / 2) * kQuads;
  for (int idx = threadIdx.x; idx < kOps * per_op; idx += kBlock) {
    const int op = idx / per_op, rem = idx - op * per_op;
    const int pos = 2 * (rem / kQuads), d = 4 * (rem % kQuads);
    const __nv_bfloat16* src = op == 0 ? q : op == 1 ? k : op == 2 ? v : dout;
    const int row_stride = op == 3 ? dstride : stride;
    uint2 r[2] = {make_uint2(0u, 0u), make_uint2(0u, 0u)};
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (d < HD && pos + e < T)
        r[e] = *reinterpret_cast<const uint2*>(src + (in_row0 + pos + e) * row_stride +
                                               head * HD + d);
    uint32_t w[4] = {__byte_perm(r[0].x, r[1].x, 0x5410), __byte_perm(r[0].x, r[1].x, 0x7632),
                     __byte_perm(r[0].y, r[1].y, 0x5410), __byte_perm(r[0].y, r[1].y, 0x7632)};
    if (op == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack_bf16(w[i]);
        w[i] = pack_bf16(f.x * scale_t, f.y * scale_t);
      }
    }
    // the last depth column (always padding): qs 1 at every row, k 0 at a key below T
    // and -inf past it
    if (d == D::kKd - 4 && op < 2)
      w[3] = op == 0 ? 0x3F803F80u : (pos < T ? 0u : 0xFF80u) | (pos + 1 < T ? 0u : 0xFF800000u);
    const uint32_t slab = base + op * ops + (pos / kTile) * D::kSlab;
#pragma unroll
    for (int i = 0; i < 4; ++i) st_shared(slab + sw128(d + i, pos % kTile), w[i]);
  }
}

template <int HD, bool kBits>
__global__ void __launch_bounds__(kThreads, 1)
    attention_bwd_wgmma_kernel(const __grid_constant__ Params p) {
  using D = Dims<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int tiles = p.tiles, T = p.t;
  const uint32_t ops = tiles * D::kSlab;  // one operand's bytes
  // the operands, slab after slab: qs, k, v, dO; then the statistics
  const uint32_t qs_s = base, k_s = base + ops, v_s = base + 2 * ops, do_s = base + 3 * ops;
  Stat* const stats = reinterpret_cast<Stat*>(smem_raw + (base - raw) + 4 * ops);
  // kBits: the dropout keep bits of each query row and key slab, [row][slab], keys 0-31 in
  // .x and 32-63 in .y
  uint2* const bits = reinterpret_cast<uint2*>(stats + tiles * kTile);
  const int head = blockIdx.x % p.heads, row_b = blockIdx.x / p.heads;

  load_operands<HD, 4, kThreads>(base, ops, p.q, p.k, p.v, p.in_stride, p.dout, p.h,
                                 (size_t)row_b * T, head, tiles, T, p.scale);
  fence_async_smem();
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, q4 = lane & 3;
  const int rl = 16 * warp + (lane >> 2);  // this thread's rows of a tile: rl and rl + 8
  const bool drop_on = p.drop.on;
  const uint32_t threshold = p.drop.threshold;
  const float inv_keep = p.drop.inv_keep;
  const uint32_t head_key = wm::dropout_head_key(p.drop.seed, blockIdx.x);
  const size_t out_row0 = (size_t)row_b * T * p.out_stride + head * HD;
  float s[32], dp[32];

  // ---- query sweep: the statistics of each query row, then dq
  for (int tile = wg; tile < tiles; tile += kWgs) {
    const int r0 = tile * kTile;
    const uint32_t qslab = qs_s + tile * D::kSlab, dslab = do_s + tile * D::kSlab;
    uint32_t row_key[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) row_key[hh] = wm::dropout_row_key(head_key, r0 + rl + 8 * hh);

    // loop 1: per row the max m, the sum of e = exp(s - m) and the sum of keep dwd e;
    // kBits: the keep bits of the row's 64 keys of the slab, gathered from its four threads
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
    for (int kb = 0; kb < tiles; ++kb) {
      two_products<HD>(s, dp, qslab, k_s + kb * D::kSlab, dslab, v_s + kb * D::kSlab);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 2 * hh; i < 32; i += 4) mx = fmaxf(fmaxf(mx, s[i]), s[i + 1]);
        const float mn = fmaxf(m[hh], mx);
        // while all of this thread's keys lie past T (mn = -inf), e stays 0
        const float nml = mn == -INFINITY ? 0.f : -mn * kLog2e;
        float sum = 0.f, acc = 0.f;
        uint32_t word[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e, key = kb * kTile + 8 * j + 2 * q4 + e;
            const float x = ex2(fmaf(s[i], kLog2e, nml));
            sum += x;
            const bool keep = !drop_on || wm::dropout_keep(row_key[hh], key, threshold);
            if constexpr (kBits) word[j / 4] |= (uint32_t)keep << (8 * (j % 4) + e);
            acc += keep ? dp[i] * x : 0.f;
          }
        const float corr = ex2(fmaf(m[hh], kLog2e, nml));  // 0 while m is -inf
        l[hh] = l[hh] * corr + sum;
        a[hh] = a[hh] * corr + acc;
        m[hh] = mn;
        if constexpr (kBits) {
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            word[w] <<= 2 * q4;
            word[w] |= __shfl_xor_sync(0xffffffffu, word[w], 1);
            word[w] |= __shfl_xor_sync(0xffffffffu, word[w], 2);
          }
          if (q4 == hh) bits[(r0 + rl + 8 * hh) * tiles + kb] = make_uint2(word[0], word[1]);
        }
      }
    }
    // the four threads of a row combine
    float nml[2], recip[2], rowsum[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mq = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
      mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
      nml[hh] = -mq * kLog2e;  // key 0 is in every row, so mq is finite
      const float corr = ex2(fmaf(m[hh], kLog2e, nml[hh]));
      float lq = l[hh] * corr, aq = a[hh] * corr;
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        lq += __shfl_xor_sync(0xffffffffu, lq, o);
        aq += __shfl_xor_sync(0xffffffffu, aq, o);
      }
      recip[hh] = 1.f / lq;
      rowsum[hh] = aq * recip[hh] * (drop_on ? inv_keep : 1.f);
      if (q4 == 0) stats[r0 + rl + 8 * hh] = Stat{nml[hh], recip[hh], rowsum[hh], row_key[hh]};
    }
    __syncwarp();  // the rows' keep bits, written by one thread of each row

    // loop 2: ds per slab, packed into A fragments, dq += dS . K
    float dq[D::kNp / 2];
#pragma unroll
    for (int i = 0; i < D::kNp / 2; ++i) dq[i] = 0.f;
    for (int kb = 0; kb < tiles; ++kb) {
      // its wait also retires the last dq product, whose fragments are rewritten below
      two_products<HD>(s, dp, qslab, k_s + kb * D::kSlab, dslab, v_s + kb * D::kSlab);
      uint32_t word[2][2];  // kBits: the rows' keep bits from this thread's first key on
      if constexpr (kBits) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint2 b = bits[(r0 + rl + 8 * hh) * tiles + kb];
          word[hh][0] = b.x >> 2 * q4;
          word[hh][1] = b.y >> 2 * q4;
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e, key = kb * kTile + 8 * j + 2 * q4 + e;
            const float w = ex2(fmaf(s[i], kLog2e, nml[hh])) * recip[hh];
            float dw = dp[i];
            if (drop_on) {
              bool keep;
              if constexpr (kBits)
                keep = (word[hh][j / 4] >> (8 * (j % 4) + e)) & 1u;
              else
                keep = wm::dropout_keep(row_key[hh], key, threshold);
              dw = keep ? dw * inv_keep : 0.f;
            }
            s[i] = w * (dw - rowsum[hh]);
          }
      uint32_t pa[4][4];
      pack_fragments(pa, s);
      fence_regs<D::kNp / 2>(dq);
      wgmma_fence();
      product_rs<HD>(dq, pa, k_s + kb * D::kSlab);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs<D::kNp / 2>(dq);
    store_tile<HD>(p.dq + out_row0, dq, r0, rl, q4, T, p.out_stride, p.scale);
  }
  __syncthreads();  // every query row's statistics (and keep bits) are in shared memory

  // ---- key sweep: dk and dv per 64-key tile. A query row past T needs no mask: its qs
  // and dO are zero and its statistics finite, so it adds nothing to dk or dv.
  // kBits: bits rl and rl + 8 of a query row's word are bits 0 and 8 after a funnel shift
  // by min(rl, 32) and a shift by the rest
  const int fs1 = rl < 32 ? rl : 32, fs2 = rl - fs1;
  for (int tile = wg; tile < tiles; tile += kWgs) {
    const uint32_t kslab = k_s + tile * D::kSlab, vslab = v_s + tile * D::kSlab;
    const int k0 = tile * kTile;
    float dk[D::kNp / 2], dv[D::kNp / 2];
#pragma unroll
    for (int i = 0; i < D::kNp / 2; ++i) dk[i] = dv[i] = 0.f;
    for (int qb = 0; qb < tiles; ++qb) {
      const uint32_t qslab = qs_s + qb * D::kSlab, dslab = do_s + qb * D::kSlab;
      // S^T and dP^T: rows are keys, columns query rows; waits for the last dk and dv
      two_products<HD>(s, dp, kslab, qslab, vslab, dslab);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int query = qb * kTile + 8 * j + 2 * q4 + e;
          const Stat st = stats[query];
          uint32_t word = 0u;
          if constexpr (kBits) {
            const uint2 b = bits[query * tiles + tile];
            word = __funnelshift_rc(b.x, b.y, fs1) >> fs2;
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * j + 2 * hh + e, key = k0 + rl + 8 * hh;
            const float w = ex2(fmaf(s[i], kLog2e, st.nml)) * st.recip;
            float wd = w, dw = dp[i];
            if (drop_on) {
              bool keep;
              if constexpr (kBits)
                keep = (word >> 8 * hh) & 1u;
              else
                keep = wm::dropout_keep(st.key, key, threshold);
              wd = keep ? w * inv_keep : 0.f;
              dw = keep ? dw * inv_keep : 0.f;
            }
            s[i] = wd;
            dp[i] = w * (dw - st.rowsum);
          }
        }
      uint32_t pw[4][4], pd[4][4];
      pack_fragments(pw, s);
      pack_fragments(pd, dp);
      fence_regs<D::kNp / 2>(dv);
      fence_regs<D::kNp / 2>(dk);
      wgmma_fence();
      product_rs<HD>(dv, pw, dslab);
      product_rs<HD>(dk, pd, qslab);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs<D::kNp / 2>(dv);
    fence_regs<D::kNp / 2>(dk);
    store_tile<HD>(p.dk + out_row0, dk, k0, rl, q4, T, p.out_stride, 1.f);
    store_tile<HD>(p.dv + out_row0, dv, k0, rl, q4, T, p.out_stride, 1.f);
  }
}

// ---- host side

// Whether the body takes t at head dim HD (its operands resident in shared memory).
template <int HD>
constexpr bool takes(int t) {
  return t >= 1 && t <= wm::kMaxContext && (t + kTile - 1) / kTile <= max_tiles<HD>();
}

// The dynamic shared memory of a block at (HD, t), or 0 where the body does not take t.
template <int HD>
constexpr int smem_bytes_at(int t) {
  return takes<HD>(t) ? smem_bytes_for<HD>((t + kTile - 1) / kTile, false) : 0;
}

template <int HD, bool kBits>
cudaError_t launch_body(const Params& p, int batch, cudaStream_t stream) {
  const int smem = smem_bytes_for<HD>(p.tiles, kBits);
  auto kernel = attention_bwd_wgmma_kernel<HD, kBits>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)batch * p.heads, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Launch the body on operands laid out as attention_bwd.cuh's BwdArgs: q, k, v rows
// `in_stride` apart, dO [batch, t, h], dq, dk, dv rows `out_stride` apart; h a multiple of
// 8, both strides multiples of 4 and every base 8-byte aligned.
template <int HD>
cudaError_t launch(Params p, int batch, cudaStream_t stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
                          reinterpret_cast<uintptr_t>(p.v) |
                          reinterpret_cast<uintptr_t>(p.dout) |
                          reinterpret_cast<uintptr_t>(p.dq) | reinterpret_cast<uintptr_t>(p.dk) |
                          reinterpret_cast<uintptr_t>(p.dv);
  if (!takes<HD>(p.t) || p.h % 8 || p.in_stride % 4 || p.out_stride % 4 || bases % 8)
    return cudaErrorInvalidValue;
  p.tiles = (p.t + kTile - 1) / kTile;
  if (p.drop.on && smem_bytes_for<HD>(p.tiles, true) <= kSmemMax)
    return launch_body<HD, true>(p, batch, stream);
  return launch_body<HD, false>(p, batch, stream);
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
}  // namespace attn_bwd_hopper
