// The bfloat16 body of the grouped matmul for Hopper (sm_90a): kernels B4 (gmm.cu, the
// MoE expert GEMM and its d_lhs), B4t (tgmm.cu, its weight gradient), the dense probe P3
// (blocked_mm.cu, as one group), B5's out-projection (fused_qkv_attention_outproj.cu: B4's
// transposed-weight form as one group, with a bias) and B6b's weight and bias gradients
// (fused_ffn_ln_bwd.cu: B4t's product over slices of the rows, fp32 partial sums).
//
// Replaces, in bf16, the TPU kernels `_gmm_kernel` and `_tgmm_kernel` of
// weathermodel_tpu/ops/pallas_gmm.py. For lhs [S, K] with rows sorted by group and the E+1
// group offsets (the exclusive cumsum of the group sizes, on the device):
//   B4   out[s] = lhs[s] . rhs[g(s)]   rhs [E, K, N], or [E, N, K] read transposed (kTransB)
//   B4t  out[g] = sum over the rows s of group g of lhs[s]^T . dy[s]          [E, K, N]
// with fp32 accumulation and one rounding to bf16. B4 masks the rows of other groups out of
// lhs before the product (rows past the last offset come out as zeros); B4t masks them out
// of both operands (the TPU's rule: 0 * NaN = NaN), and an empty group gets zeros.
//
// What bounds it: at the MoE layer's shapes (S = 70080, K x N = 576 x 2304 or back) a call
// is 186 GFLOP against 425 MB of operands, 0.188 ms at the 989 TFLOP/s bf16 peak:
// operations. The WMMA tiles this body replaces (gmm_common.cuh: one shared-memory stage a
// 32-deep slab, staged by the threads themselves, mma.sync, no overlap of loads with
// products) reached ~100 TFLOP/s.
//
// Design. A block computes 128 x 192 output tiles: 384 threads, warpgroup 2 a producer
// (one thread issues every TMA load; setmaxnreg 40) and warpgroups 0 and 1 consumers of
// 64 rows each (setmaxnreg 232; 96 fp32 accumulators a thread, one wgmma m64n192k16 a
// 16-deep step). 192 columns divide both MoE widths (576 = 3 x 192, 2304 = 12 x 192); a
// 128-wide tile would leave half a tile at N = 576.
//   * The reduction runs in 64-deep slabs (one 128-byte swizzle atom of bf16) through a
//     ring of kStages = 4 stages of A [128 x 64] + B [64 x 192] (40 KB each), each with a
//     full mbarrier (the producer's expect_tx, completed by TMA) and an empty one (one
//     arrival from each consumer warp once its wgmma group that read the stage is done;
//     the consumers keep one group in flight). The output leaves through its own 48 KB
//     staging tile by TMA store, 128-byte swizzled, rounded once; the store runs on while
//     the block goes on.
//   * Operand layouts, all TMA boxes of 64 bf16 columns with the 128-byte swizzle, nothing
//     transposed or copied on the host:
//       B4   A = lhs rows, K-major.  B = rhs[g] [K][N]: three [64 x 64] boxes, N-major
//            (B's transpose bit); with kTransB, rhs[g] as [N][K]: one [192 x 64] box,
//            K-major. The weights' map is 3-D ([E, K, N] or [E, N, K], the group the
//            outer coordinate), so a K or N tail reads TMA's zeros, never the next
//            expert's weights.
//       B4t  A = lhs^T: the lhs slab [64 rows][128 k] as two [64 x 64] boxes, M-major
//            (A's transpose bit). B = the dy slab [64 rows][192 n], three boxes, N-major.
//   * B4: the output tiles are 192 columns of N x 128 rows of S, counted from S and N
//     alone (the offsets stay on the device), and the grid is persistent: one block an SM,
//     each taking every gridDim.x-th tile, N fastest, so that the blocks in flight share
//     their lhs rows in L2. The ring runs on across a block's tiles, so the producer
//     loads the next tile's first slabs while the consumers finish the last one's products
//     and epilogue: at K = 576 a tile has only 9 slabs, and one block a tile (6576 blocks
//     at fwd1) left the ring's fill and the epilogue unhidden (on an H100 fwd1 and dlhs2
//     took 0.44 ms that way, 0.33 persistent). For each group that meets a tile's rows
//     (usually one) a block runs the K loop against that group's weights. In a tile the
//     group does not cover, each consumer zeroes its own A rows of other groups in the
//     stage after it arrives (a whole row is 128 contiguous bytes under the swizzle), then
//     fence.proxy.async and a warpgroup barrier before the wgmma. All passes sum into one
//     set of accumulators, written once: at most E - 1 extra passes of 548 a column at
//     S = 70080, E = 8 (1.3%).
//   * B4t: the grid is (192-column tiles of N, 128-row tiles of K, E). A block walks its
//     group's rows in slabs from offsets[g] (a TMA box may start at any row), so only the
//     group's last slab runs past its end: there both consumers zero those rows in A's
//     and B's stage, split between them, and meet at a named barrier. The block owns its
//     tile: no atomics, one summation order, two calls give equal bits. A block's work is
//     its group's ~S / E rows (137 slabs at the MoE shapes), so a persistent grid would
//     hide little. At K = 576 the last 128-row tile of K is half empty; 480 (dw1) and 432
//     (dw2) blocks are 3.6 and 3.3 waves on 132 SMs. Splitting a group's rows over two
//     blocks (a second, fixed-order reduction pass) or a 192-row M tile were not taken:
//     neither lowers the number of full-length waves at these shapes.
//   * The window forms B4s and B4ts (gmm.cu, tgmm.cu: an expert-parallel rank's e_loc
//     groups, offsets [off, off + e_loc] of the global E + 1) run these kernels unchanged:
//     B4's tile walk meets only the groups in the offsets it is given, a tile that
//     straddles the window's first or last offset zeroes its rows of no group as above, a
//     tile of no group stores zeros without a K loop, and B4t's blocks read their group's
//     rows from the offsets alone.
//   * Both operand layouts of B4 run the same tile, slab order and instruction shape,
//     differing only in B's transpose bit, so gmm(dy, rhs, trans_rhs) equals gmm on a
//     transposed copy of rhs bit for bit.
//   * P3 (blocked_mm.cu, the dense probe) is B4 with one group, offsets [0, mc]: its covered
//     region's mc rows of x, and w and y as [1, k, n] and [mc, n] maps that stop at the
//     region's nc columns but keep their rows n elements apart (`ld`).
//   * B5's out-projection y = o . wo^T + bo (launch_linear) is B4's kTransB form with one
//     group, offsets [0, m], and kBias: the epilogue adds bo[col] to the fp32 sums before
//     the one rounding (the TPU kernel's order, pallas_attention.py:273-278).
//   * B6b's weight gradients (launch_wgrad_partials) are B4t's product with kPartials:
//     the "groups" are slices of `slice` rows (a multiple of 64) over all M rows, so that
//     the grid fills the card (one group of all rows gives 54-60 blocks at the bench's
//     shapes); each block writes its fp32 sums straight from its accumulators into
//     part [slices, K + 1, N] (96 KB a tile: no staging tile, no rounding), and
//     fused_ffn_ln_bwd.cu's reduce sums the slices in order and rounds once. Row K is the
//     bias gradient: the consumer whose A box holds lhs column K (TMA's zeros there, since
//     the grid covers K + 1 rows) writes 1.0 into it for every row of each landed slab,
//     behind fence.proxy.async and its warpgroup's barrier, so that the column sums of dy
//     come out of the same tensor-core sums. No atomics: every sum runs in a fixed order.
// Shared memory: 4 x 40 KB + 48 KB + barriers + 1 KB of alignment slack = 214,080 B, one
// block an SM. Registers and spills: ptxas -v, printed by chip_smoke.py's build phase.
// Takes K and N multiples of 8 (TMA's 16-byte strides), 16-byte aligned operands and at
// least one row; gmm.cu, tgmm.cu, blocked_mm.cu and fused_qkv_attention_outproj.cu dispatch
// on exactly that (`takes`) and send any other bf16 call, and every fp32 call, to
// gmm_common.cuh's tiles. fused_ffn_ln_bwd.cu's bf16 calls always meet it (its wrapper's
// layout rule) and it refuses any that does not.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

// Everything here has internal linkage: gmm.cu, tgmm.cu and blocked_mm.cu each compile their
// own copy.
namespace gmm_hopper {
namespace {

using namespace hopper;

constexpr int kM = 128;        // output rows of a block: two consumers of 64
constexpr int kN = 192;        // output columns of a block: one wgmma N
constexpr int kDepth = 64;     // a slab: one 128-byte swizzle atom of bf16
constexpr int kStages = 4;
constexpr int kThreads = 384;  // consumers 0 and 1, producer 2
constexpr int kBox = 64 * 64 * 2;             // a [64 x 64] bf16 box
constexpr int kABytes = kM * kDepth * 2;      // 16 KB
constexpr int kBBytes = kN * kDepth * 2;      // 24 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOutBytes = kM * kN * 2;        // 48 KB
constexpr int kOut = kStages * kStageBytes;  // after the ring
constexpr int kBars = kOut + kOutBytes;       // full[kStages], then empty[kStages]
constexpr int kSmemBytes = kBars + 16 * kStages + 1024;  // + slack to align to 1024
static_assert(kSmemBytes <= kSmemMax, "the ring and the output tile must fit");

struct Params {
  CUtensorMap tm_a;    // lhs [S, K]: B4 boxes [128 x 64], B4t [64 x 64]
  CUtensorMap tm_b;    // B4: rhs, 3-D; B4t: dy [S, N] in [64 x 64] boxes
  CUtensorMap tm_out;  // B4: out [S, N] in [64 x 64] boxes; B4t: out [E, K, N], 3-D
  const int* offsets;  // [E + 1]
  int s, k, n, e;
  const __nv_bfloat16* bias;  // B4 with kBias: [N]
  float* part;                // B4t with kPartials: [E, K + 1, N] fp32
  int slice;                  // B4t with kPartials: rows a group (a multiple of 64)
};

struct Roles {
  uint32_t ring, out, full, empty;
};

// Shared memory and the barriers' initialisation.
__device__ __forceinline__ Roles setup(unsigned char* smem_raw) {
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  Roles r{base, base + kOut, base + kBars, base + kBars + 8 * kStages};
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(r.full + 8 * st, 1);
      mbar_init(r.empty + 8 * st, 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// The producer's wait for slab n's stage to be free: the consumers have released the slab
// that held it kStages slabs ago.
__device__ __forceinline__ uint32_t claim(const Roles& r, int n) {
  const int st = n % kStages;
  if (n >= kStages) mbar_wait(r.empty + 8 * st, ((n / kStages) - 1) & 1);
  mbar_expect_tx(r.full + 8 * st, kStageBytes);
  return st;
}

// A consumer's wait for slab n.
__device__ __forceinline__ uint32_t wait_slab(const Roles& r, int n) {
  const int st = n % kStages;
  mbar_wait(r.full + 8 * st, (n / kStages) & 1);
  __syncwarp();
  return r.ring + st * kStageBytes;
}

// A consumer warp's release of slab `slab`'s stage (none for -1), once its wgmma group that
// read the stage has completed.
__device__ __forceinline__ void release(const Roles& r, int slab) {
  if (slab >= 0 && (threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * (slab % kStages));
  __syncwarp();
}

// Zero 16-byte chunk `c` of row `row` in the [64 x 64] box at `box`.
__device__ __forceinline__ void zero_chunk(uint32_t box, int row, int c) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(box + row * 128 + c * 16),
               "r"(0)
               : "memory");
}

// The epilogue, after every wgmma group of the tile has completed: this consumer's 64 x 192
// accumulators rounded once to bf16 into its three swizzled [64 x 64] boxes of the output
// tile, stored by `store(box address, a)` for the boxes a = 0, 1, 2 that start inside the
// output. The stores run on while the block goes on; the previous tile's have read the
// boxes before they are written again, and the block's last must have read them before it
// ends (`tma_store_wait_read` by thread 0).
template <class Store>
__device__ __forceinline__ void epilogue(float* acc, uint32_t out, int wg, int t, Store store) {
  fence_regs<96>(acc);
  if (t == 0) tma_store_wait_read();
  named_sync(1 + wg, 128);  // the previous tile's stores have read this consumer's boxes
  const uint32_t mine = out + wg * 3 * kBox;
  const int warp = t / 32, lane = t % 32;
  const int rl = 16 * warp + (lane >> 2), q = lane & 3;
#pragma unroll
  for (int j = 0; j < 24; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      st_shared(mine + (j / 8) * kBox + sw128(rl + 8 * i, 8 * (j % 8) + 2 * q),
                pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]));
  }
  fence_async_smem();
  named_sync(1 + wg, 128);  // this consumer's boxes are written
  if (t == 0)
    for (int a = 0; a < 3; ++a) store(mine + a * kBox, a);
}

// B4 with kBias: bias[col] (bf16) added to this consumer's fp32 sums, before the epilogue's
// one rounding, for the columns inside the output.
__device__ __forceinline__ void add_bias(float* acc, const __nv_bfloat16* bias, int n0, int n,
                                         int t) {
  fence_regs<96>(acc);
  const int q = t & 3;
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const int col = n0 + 8 * j + 2 * q;  // n is a multiple of 8: col + 1 < n too
    if (col < n) {
      const float2 b = unpack_bf16(__ldg(reinterpret_cast<const unsigned*>(bias + col)));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * j + 2 * i] += b.x;
        acc[4 * j + 2 * i + 1] += b.y;
      }
    }
  }
}

// ---- B4

// Output tile `tile` of B4's persistent grid: 192-column tiles of N fastest, then 128-row
// tiles of S, so that the blocks in flight share their lhs rows in L2.
struct Tile {
  int n0, r0, r1;
};

__device__ __forceinline__ Tile gemm_tile(const Params& p, int tiles_n, int tile) {
  const int r0 = (tile / tiles_n) * kM;
  return {(tile % tiles_n) * kN, r0, min(r0 + kM, p.s)};
}

template <bool kTransB, bool kBias>
__global__ void __launch_bounds__(kThreads, 1)
    expert_gemm_wgmma_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Roles r = setup(smem_raw);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int tiles_n = (p.n + kN - 1) / kN, tiles = tiles_n * ((p.s + kM - 1) / kM);

  if (wg == 2) {  // the producer: every slab of the block's tiles, in the consumers' order
    setmaxnreg_dec<40>();
    if (t == 0) {
      int n = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const Tile c = gemm_tile(p, tiles_n, tile);
        for (int g = 0; g < p.e; ++g) {
          const int lo = max(c.r0, __ldg(p.offsets + g));
          const int hi = min(c.r1, __ldg(p.offsets + g + 1));
          if (lo >= hi) continue;
          for (int k0 = 0; k0 < p.k; k0 += kDepth, ++n) {
            const uint32_t st = claim(r, n);
            const uint32_t dst = r.ring + st * kStageBytes, bar = r.full + 8 * st;
            tma_load(dst, &p.tm_a, bar, k0, c.r0);
            if constexpr (kTransB) {
              tma_load3d(dst + kABytes, &p.tm_b, bar, k0, c.n0, g);
            } else {
              for (int a = 0; a < 3; ++a)
                tma_load3d(dst + kABytes + a * kBox, &p.tm_b, bar, c.n0 + 64 * a, k0, g);
            }
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  float acc[96];
  int n = 0, held = -1;  // the next slab; the slab whose stage this warp still holds
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile c = gemm_tile(p, tiles_n, tile);
#pragma unroll
    for (int v = 0; v < 96; ++v) acc[v] = 0.f;
    for (int g = 0; g < p.e; ++g) {
      const int lo = max(c.r0, __ldg(p.offsets + g));
      const int hi = min(c.r1, __ldg(p.offsets + g + 1));
      if (lo >= hi) continue;  // uniform across the block
      const bool partial = lo > c.r0 || hi < c.r1;
      for (int k0 = 0; k0 < p.k; k0 += kDepth, ++n) {
        const uint32_t stage = wait_slab(r, n);
        const uint32_t a_s = stage + wg * (kABytes / 2), b_s = stage + kABytes;
        if (partial) {  // this consumer's rows of other groups, as zeros
          for (int i = t; i < 64 * 8; i += 128) {
            const int row = c.r0 + 64 * wg + i / 8;
            if (row < lo || row >= hi) zero_chunk(a_s, i / 8, i % 8);
          }
          fence_async_smem();
          named_sync(1 + wg, 128);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = make_desc(a_s + kk * 32, 16, 1024, 1);
          const uint64_t db = kTransB ? make_desc(b_s + kk * 32, 16, 1024, 1)
                                      : make_desc(b_s + kk * 2048, kBox, 1024, 1);
          Wgmma<kN, kTransB ? 0 : 1, 0>::mma(acc, da, db, 1);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the group of the previous slab has completed
        release(r, held);
        held = n;
      }
    }
    wgmma_wait<0>();
    release(r, held);
    held = -1;
    if constexpr (kBias) add_bias(acc, p.bias, c.n0, p.n, t);
    const int row = c.r0 + 64 * wg;
    epilogue(acc, r.out, wg, t, [&](uint32_t box, int a) {
      if (row < p.s && c.n0 + 64 * a < p.n) tma_store(&p.tm_out, box, c.n0 + 64 * a, row);
    });
  }
  if (t == 0) tma_store_wait_read();  // the block ends once its stores have read its tile
}

// ---- B4t

template <bool kPartials>
__global__ void __launch_bounds__(kThreads, 1)
    expert_wgrad_wgmma_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Roles r = setup(smem_raw);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int n0 = blockIdx.x * kN, k0 = blockIdx.y * kM, g = blockIdx.z;
  int lo, hi;
  if constexpr (kPartials) {  // slice g of the rows
    lo = min(g * p.slice, p.s);
    hi = min(lo + p.slice, p.s);
  } else {
    lo = __ldg(p.offsets + g);
    hi = __ldg(p.offsets + g + 1);
  }
  const int slabs = hi > lo ? (hi - lo + kDepth - 1) / kDepth : 0;

  if (wg == 2) {  // the producer
    setmaxnreg_dec<40>();
    if (t == 0) {
      for (int n = 0; n < slabs; ++n) {
        const uint32_t st = claim(r, n);
        const uint32_t dst = r.ring + st * kStageBytes, bar = r.full + 8 * st;
        const int s0 = lo + n * kDepth;
        for (int a = 0; a < 2; ++a) tma_load(dst + a * kBox, &p.tm_a, bar, k0 + 64 * a, s0);
        for (int a = 0; a < 3; ++a)
          tma_load(dst + kABytes + a * kBox, &p.tm_b, bar, n0 + 64 * a, s0);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  // kPartials: lhs column K's place in this consumer's A box, or -1 where the box does not
  // hold it
  int ones = -1;
  if constexpr (kPartials) {
    const int c = p.k - (k0 + 64 * wg);
    if (c >= 0 && c < 64) ones = c;
  }
  float acc[96];
#pragma unroll
  for (int v = 0; v < 96; ++v) acc[v] = 0.f;
  for (int n = 0; n < slabs; ++n) {
    const uint32_t stage = wait_slab(r, n);
    const int past = hi - (lo + n * kDepth);  // rows of the slab inside the group
    if (past < kDepth) {  // the group's last slab: its other rows, as zeros in A and B
      for (int i = threadIdx.x; i < 5 * 64 * 8; i += 256) {
        const int row = (i / 8) % 64;
        if (row >= past) zero_chunk(stage + (i / 512) * kBox, row, i % 8);
      }
      fence_async_smem();
      named_sync(3, 256);
    }
    const uint32_t a_s = stage + wg * kBox, b_s = stage + kABytes;
    if constexpr (kPartials) {
      if (ones >= 0) {  // A's row K, lhs column K in this consumer's box: ones
        if (t < kDepth) st_shared_u16(a_s + sw128(t, ones), 0x3F80);  // bf16 1.0
        fence_async_smem();
        named_sync(1 + wg, 128);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<kN, 1, 1>::mma(acc, make_desc(a_s + kk * 2048, kBox, 1024, 1),
                           make_desc(b_s + kk * 2048, kBox, 1024, 1), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the group of the previous slab has completed
    release(r, n - 1);
  }
  wgmma_wait<0>();
  const int krow = k0 + 64 * wg;
  if constexpr (kPartials) {  // the fp32 sums, rows up to K (the bias row), as they are
    fence_regs<96>(acc);
    const int rl = 16 * (t / 32) + ((t % 32) >> 2), q = t & 3;
    float* out = p.part + (long long)g * (p.k + 1) * p.n;
#pragma unroll
    for (int j = 0; j < 24; ++j) {
      const int col = n0 + 8 * j + 2 * q;  // n is a multiple of 8: col + 1 < n too
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = krow + rl + 8 * i;
        if (col < p.n && row <= p.k)
          *reinterpret_cast<float2*>(out + (long long)row * p.n + col) =
              make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
  } else {
    epilogue(acc, r.out, wg, t, [&](uint32_t box, int a) {
      if (krow < p.k && n0 + 64 * a < p.n) tma_store3d(&p.tm_out, box, n0 + 64 * a, krow, g);
    });
    if (t == 0) tma_store_wait_read();  // the block ends once its stores have read its tile
  }
}

// ---- host side

// The shape and layout rule of this body: K and N multiples of 8, every operand 16-byte
// aligned, at least one row.
inline bool takes(int s, int k, int n, const void* a, const void* b, const void* out) {
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return s > 0 && k % 8 == 0 && n % 8 == 0 && aligned(a) && aligned(b) && aligned(out);
}

// A bf16 [outer, rows, cols] tensor, its rows `ld` elements apart (cols where ld is 0), as a
// 3-D map in boxes [box_rows x 64] of one outer index, 128-byte swizzled.
inline bool make_map_3d(CUtensorMap* tm, const void* ptr, int outer, int rows, int cols,
                        int box_rows, int ld = 0) {
  const cuuint64_t row = (cuuint64_t)(ld ? ld : cols) * 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {row, rows * row};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return make_map_nd(tm, ptr, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <class Kernel>
cudaError_t run(Kernel kernel, const Params& p, dim3 grid, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

// B4's parameters and persistent grid: lhs [s, k], rhs [e, k, n] (or [e, n, k] with trans),
// out [s, n], rows of rhs and out ld elements apart where ld > 0.
inline cudaError_t gemm_setup(Params* p, dim3* grid, const void* lhs, const void* rhs,
                              const int* offsets, void* out, int s, int k, int n, int e,
                              bool trans, int ld) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((n + kN - 1) / kN) * ((s + kM - 1) / kM);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  *grid = dim3((unsigned)(tiles < sms ? tiles : sms));  // one block an SM, persistent
  *p = Params{};
  const bool ok =
      make_map(&p->tm_a, lhs, s, k, kM, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
      (trans ? make_map_3d(&p->tm_b, rhs, e, n, k, kN)
             : make_map_3d(&p->tm_b, rhs, e, k, n, 64, ld)) &&
      make_map(&p->tm_out, out, s, n, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B, ld);
  if (!ok) return cudaErrorInvalidValue;
  p->offsets = offsets;
  p->s = s;
  p->k = k;
  p->n = n;
  p->e = e;
  return cudaSuccess;
}

// B4 on this body: lhs [s, k], rhs [e, k, n] (or [e, n, k] with trans), out [s, n]. With
// ld > n (P3, blocked_mm.cu: one group, no trans) the rows of rhs and out are ld elements
// apart, and the body computes and writes their first n columns only.
inline cudaError_t launch_gmm(const void* lhs, const void* rhs, const int* offsets, void* out,
                              int s, int k, int n, int e, bool trans, cudaStream_t stream,
                              int ld = 0) {
  Params p;
  dim3 grid;
  const cudaError_t err = gemm_setup(&p, &grid, lhs, rhs, offsets, out, s, k, n, e, trans, ld);
  if (err != cudaSuccess) return err;
  return trans ? run(expert_gemm_wgmma_kernel<true, false>, p, grid, stream)
               : run(expert_gemm_wgmma_kernel<false, false>, p, grid, stream);
}

// B5's out-projection on this body: y [s, n] = x [s, k] . w^T + bias, w [n, k] (torch's
// [out, in]), bias [n] 4-byte aligned; offsets the one group's {0, s} on the device.
inline cudaError_t launch_linear(const void* x, const void* w, const void* bias,
                                 const int* offsets, void* y, int s, int k, int n,
                                 cudaStream_t stream) {
  Params p;
  dim3 grid;
  const cudaError_t err = gemm_setup(&p, &grid, x, w, offsets, y, s, k, n, 1, true, 0);
  if (err != cudaSuccess) return err;
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  return run(expert_gemm_wgmma_kernel<true, true>, p, grid, stream);
}

// B4t on this body: lhs [s, k], dy [s, n], out [e, k, n].
inline cudaError_t launch_tgmm(const void* lhs, const void* dy, const int* offsets, void* out,
                               int s, int k, int n, int e, cudaStream_t stream) {
  const dim3 grid((n + kN - 1) / kN, (k + kM - 1) / kM, e);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidConfiguration;
  Params p = {};
  const bool ok = make_map(&p.tm_a, lhs, s, k, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
                  make_map(&p.tm_b, dy, s, n, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
                  make_map_3d(&p.tm_out, out, e, k, n, 64);
  if (!ok) return cudaErrorInvalidValue;
  p.offsets = offsets;
  p.s = s;
  p.k = k;
  p.n = n;
  p.e = e;
  return run(expert_wgrad_wgmma_kernel<false>, p, grid, stream);
}

// B6b's weight and bias gradients on this body: for lhs [s, k] and dy [s, n], part[g] =
// [lhs | 1]^T . dy over rows [g slice, (g + 1) slice) of s, fp32, [splits, k + 1, n]; row k
// is the column sums of dy. slice a multiple of 64 with splits x slice >= s.
inline cudaError_t launch_wgrad_partials(const void* lhs, const void* dy, float* part, int s,
                                         int k, int n, int splits, int slice,
                                         cudaStream_t stream) {
  if (slice <= 0 || slice % kDepth || (long long)splits * slice < s)
    return cudaErrorInvalidValue;
  const dim3 grid((n + kN - 1) / kN, (k + 1 + kM - 1) / kM, splits);
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidConfiguration;
  Params p = {};
  const bool ok = make_map(&p.tm_a, lhs, s, k, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
                  make_map(&p.tm_b, dy, s, n, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return cudaErrorInvalidValue;
  p.s = s;
  p.k = k;
  p.n = n;
  p.e = splits;
  p.part = part;
  p.slice = slice;
  return run(expert_wgrad_wgmma_kernel<true>, p, grid, stream);
}

}  // namespace
}  // namespace gmm_hopper
