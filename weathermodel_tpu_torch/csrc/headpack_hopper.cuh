// The head-layout probes for Hopper (sm_90a): kernels P1 and P2 (headpack.cu) on one wgmma
// body, `headpack_wgmma_kernel<G, kTma>`: G = 1 is P1, G = 3 is P2.
//
// Replaces the TPU kernels of the head-packing ablation, scripts/abl_headpack.py:
//   P1  `_v0_kernel` via `run_v0` (:115): for each head j of q, k, v [B, T, H] (heads side by
//       side in H, HD = 36 columns each)
//         S_j = q_j . k_j^T   (fp32 sum, rounded to bf16),   O_j = S_j . v_j   (fp32 sum,
//         rounded to bf16), written to o's columns of head j
//   P2  `_v1_kernel` via `run_v1` (:125): for each group g of G = 3 heads (g < NH / G; with
//       NH = 16 head 15 is never written, on the TPU too), q3 = the group's 108 columns, Kbd
//       and Vbd [G T, 108] block-diagonal (rows jT .. jT + T - 1 hold k_{3g+j}, v_{3g+j} in
//       columns 36j .. 36j + 35, zeros elsewhere);
//         S3 = q3 . Kbd^T  [T, G T] (fp32 sum, rounded),   O3 = S3 . Vbd  [T, 108] (rounded)
//       computed literally, zero blocks included: the ablation asks what the packed layout
//       costs, and a kernel that skipped the zeros would be P1.
// bfloat16 only, as the probes run. Only the fp32 summation order differs from the TPU's.
//
// What bounds them on the card (3.35 TB/s, 989 TFLOP/s dense bf16), B = 224, T = 384,
// H = 576: P1 reads q, k, v and writes o, 396.4 MB, against 76.1 GFLOP: bound by bytes at
// 0.118 ms (its products padded as it runs them, depth 48 and O 40 wide, 93 GFLOP, take
// 0.094 ms). P2's useful work is the 15 heads it writes, 371.6 MB and 71.4 GFLOP: bound by
// bytes at 0.111 ms; but its literal products are 214.0 GFLOP, 0.216 ms at the peak, and
// 222.0 GFLOP as the tensor cores run them (depth and width 108 padded to 112), 0.2245 ms.
//
// Design: one body for both, persistent (one block an SM, each taking every gridDim-th work
// item). A work item is kTiles 64-row query tiles of one batch row and one unit (a head for
// P1, a group for P2); no softmax, so O is a plain sum over its G x T / 64 stages (head j's
// k and v rows of a 64-key slab).
//   * Warpgroups: consumers (P1 three with two tiles each, P2 two with one), each holding its
//     tiles' Q as bf16 A fragments in registers, and a producer warpgroup (setmaxnreg 64;
//     the consumers 144 or 216).
//   * Operands in shared memory in their natural layout, rows of 64 keys or queries, in atoms
//     of [64 x kCols] with the swizzle of that width: P1 one 128-byte atom (its 48 columns
//     used), P2 seven 32-byte ones, so that a head's 36 columns lie in 3 of them.
//   * P2's Kbd and Vbd are staged literally: each stage slot holds one head j's k or v rows at
//     their columns of the group, zeros elsewhere; the ring's 6 slots are dedicated to the 3
//     heads in turn, so the zeros outside a head's atoms are written once, when the block
//     starts. Every S3 product runs the full 112 deep and every O3 product the full 112
//     wide, on uniform descriptors.
//   * Loads by TMA, a box an atom, into two slots of query tiles and the ring. A unit's
//     columns start 8 bytes into a 16-byte unit for odd units, so those are read from 4
//     columns earlier (`shift_of`) and their boxes start aligned. The atoms hold neighbouring
//     columns too: the producer zeros them in the slot after the load lands (at most 12
//     columns a row), then fence.proxy.async. One producer thread issues every box, as far
//     ahead as the slots allow; warps 1-3 finish the loads in turn (wait, zero, fence,
//     arrive), each with its own ring of `landed` barriers. Where TMA cannot map the
//     operands (H not a multiple of 8, or a base not 16-byte aligned) the producer copies
//     with cp.async of 8 bytes instead, zeros where the slots must read them.
//   * Per stage and tile: S [64 x 64] = Qtile . K^T (RS wgmma m64n64k16 over kd = 48 or
//     112), waited for, rounded and packed into bf16 A fragments in registers
//     (attn_bwd_hopper's pack_fragments), then O += S . V (m64n{40, 112}k16, committed; the
//     next S's wait retires it). O leaves its accumulators rounded once, by 4-byte stores of
//     the unit's columns; rows past T (tiles past T compute on zeros) are never stored, and
//     P2 never writes the columns of heads past the last whole group.
//   The body takes every shape the WMMA kernel it replaces took: any T, any batch up to
//   65535, H a multiple of 36 (the operands' rows and a head's columns 8-byte aligned).
// Shared memory: two slots of kTiles query tiles and 6 stages of k and v slots: 197,856 bytes
// for P1, 230,624 for P2; 512 and 384 threads. Registers and spills of the four
// instantiations: ptxas -v, printed by chip_smoke.py's probes phase.
// On an H100 80GB HBM3 at 700 W the WMMA kernel this replaces took 1.0661 ms (P1) and
// 2.0242 ms (P2) at the probe's shape; PERF.md §6 has this body's times.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_bwd_hopper.cuh"
#include "hopper_common.cuh"

// Everything here has internal linkage, as in the attention bodies it builds on.
namespace headpack_hopper {
namespace {

using namespace hopper;
using attn_bwd_hopper::pack_fragments;
using bf16 = __nv_bfloat16;

constexpr int kHeadDim = 36;
constexpr int kTile = 64;               // query rows of a tile
// the producer's threads that finish a load: one of warps 1-3 behind the TMA issuer (they
// take the loads in turn, each with its own ring of kLandedRing `landed` barriers)
constexpr int kFinisherWarps = 3, kLandedRing = 4;

template <int G>
struct Layout {
  static_assert(G == 1 || G == 3, "P1 takes heads one by one, P2 in groups of 3");
  static constexpr int kWidth = G * kHeadDim;          // live columns: 36 or 108
  static constexpr int kSteps = (kWidth + 15) / 16;    // S's k-steps: 3 or 7
  static constexpr int kNp = (kWidth + 7) / 8 * 8;     // O's columns: 40 or 112
  // operands in atoms of [64 rows x kCols columns] with the swizzle of their row's width: P1
  // one 128-byte atom (48 of its columns used), P2 7 32-byte ones, so that a head's 36
  // columns lie in 3 of them and its slot needs at most 12 columns of zeroing a row
  static constexpr int kCols = G == 1 ? 64 : 16;
  static constexpr int kAtoms = (16 * kSteps + kCols - 1) / kCols;  // 1 or 7
  static constexpr int kAtom = kTile * kCols * 2;
  static constexpr int kSlot = kAtoms * kAtom;                  // a query tile, a k or v slot
  static constexpr uint64_t kSwizzle = G == 1 ? 1 : 3;  // descriptor code: 128 or 32 bytes
  static constexpr int kSbo = 8 * kCols * 2;            // 8 rows of an atom
  // the ring of k and v slots: P2's are dedicated to its heads in turn
  static constexpr int kStages = 6;
  static_assert(kStages % G == 0 && kFinisherWarps * kLandedRing > kStages + 2,
                "a landed barrier's last phase has completed before the issuer arms it again");

  // consumer warpgroups and their query tiles: P1 3 x 2 (20 accumulators a tile), P2 2 x 1
  // (56), each with its tiles' A fragments in registers; and a producer warpgroup
  static constexpr int kConsumers = G == 1 ? 3 : 2;
  static constexpr int kTilesPerWg = G == 1 ? 2 : 1;
  static constexpr int kTiles = kConsumers * kTilesPerWg;  // query tiles a work item
  static constexpr int kThreads = 128 * (kConsumers + 1);
  // registers a thread: the producer keeps kProducerRegs and gives the rest to the consumers
  // (65536 / kThreads each at the entry: 128 or 168)
  static constexpr int kProducerRegs = 64;
  static constexpr int kConsumerRegs = G == 1 ? 144 : 216;
  static constexpr int kRing = 2 * kTiles * kSlot;     // after two slots of query tiles
  static constexpr int kBars = kRing + kStages * 2 * kSlot;
  static constexpr int kNumBars = 4 + 2 * kStages + kFinisherWarps * kLandedRing;
  static constexpr int kSmemBytes = kBars + 8 * kNumBars + 1024;  // + slack to align to 1024
  static_assert(kSmemBytes <= kSmemMax, "the query tiles and the ring must fit");
};

// A unit's columns start 16-byte aligned in a row for even units only (72 or 216 bytes a
// unit), so an odd unit is read from `shift` = 4 columns before its first: every box then
// starts 16-byte aligned, and the unit's column c is column shift + c of its tiles and slots.
__device__ __forceinline__ int shift_of(int unit) { return 4 * (unit & 1); }

struct Params {
  CUtensorMap tm_q, tm_k, tm_v;  // kTma: [batch, t, h] as (h, t, batch), [64 x kCols] boxes
  const bf16* q;                 // !kTma: the operands themselves
  const bf16* k;
  const bf16* v;
  bf16* o;
  int t, h, units, groups, items;  // groups: work items a unit (query tiles / kTiles)
};

// A work item: query group qg of unit `unit` of batch row b.
struct Item {
  int b, unit, qg;
};

__device__ __forceinline__ Item item_of(const Params& p, int w) {
  const int rest = w / p.groups;
  return Item{rest / p.units, rest % p.units, w - rest * p.groups};
}

// The shared-memory map: two slots of query tiles, the ring of k and v slots, and the
// barriers: q_full, q_empty (a query slot each), full, empty (a stage each), landed (a
// finisher warp's ring).
struct Smem {
  uint32_t q, ring;
  uint32_t q_full, q_empty, full, empty, landed;
};

template <int G>
__device__ __forceinline__ Smem smem_map(uint32_t base) {
  using L = Layout<G>;
  const uint32_t bars = base + L::kBars;
  return Smem{base, base + L::kRing, bars, bars + 16, bars + 32, bars + 32 + 8 * L::kStages,
              bars + 32 + 16 * L::kStages};
}

// byte offset of bf16 element (r, c) in the layout's atoms
template <int G>
__device__ __forceinline__ uint32_t boxed(int r, int c) {
  using L = Layout<G>;
  return c / L::kCols * L::kAtom + (G == 1 ? sw128(r, c % L::kCols) : sw32(r, c % L::kCols));
}

// The barrier that load x lands on: the ring of its finisher warp.
__device__ __forceinline__ uint32_t landed_bar(const Smem& sm, int x) {
  return sm.landed + 8 * ((x % kFinisherWarps) * kLandedRing + x / kFinisherWarps % kLandedRing);
}

// cp.async of the rows row0 .. row0 + 63 of `src` ([rows, h], zeros at rows t and past) into
// the first 16 kSteps columns of the atoms at dst: column c takes src column col0 + c for
// lo <= c < hi, zeros elsewhere. Issued by the producer warpgroup's 128 threads, not waited
// for.
template <int G>
__device__ __forceinline__ void load_columns(uint32_t dst, const bf16* src, int h, int row0,
                                             int t, int col0, int lo, int hi, int pt) {
  constexpr int kQuads = 4 * Layout<G>::kSteps;
#pragma unroll 2
  for (int e = pt; e < kTile * kQuads; e += 128) {
    const int r = e / kQuads, c = 4 * (e - r * kQuads), row = row0 + r;
    const bool in = row < t && c >= lo && c < hi;
    cp_async8(dst + boxed<G>(r, c), in ? src + (size_t)row * h + col0 + c : src, in);
  }
}

// Zero the columns lo .. hi - 1 (multiples of 4) of row r of the atoms at `dst`.
template <int G>
__device__ __forceinline__ void zero_columns(uint32_t dst, int r, int lo, int hi) {
  for (int c = lo; c < hi; c += 4)
    asm volatile("st.shared.v2.u32 [%0], {%1, %1};" ::"r"(dst + boxed<G>(r, c)), "r"(0)
                 : "memory");
}

// ---- the producer warpgroup: the loads of its block's work items, in order, each item's
// kTiles query tiles and then its G x T / 64 stages of k and v (key slab by key slab, head
// by head within a slab). With TMA one thread issues every load (a box an atom), as far
// ahead as the slots allow, and warps 1-3 finish the loads in turn: wait for it to land,
// zero the columns that must read zeros (the atoms hold neighbouring heads' columns too),
// fence.proxy.async, and one arrival a thread on the barrier the consumers wait for.
// Without TMA every thread copies each load with cp.async (zeros where the atoms must read
// them), waits for its copies and finishes it.

template <int G, bool kTma>
__device__ __forceinline__ void issue(const Params& p, const Smem& sm, int x, int per, int pt) {
  using L = Layout<G>;
  const int m = x / per, r = x - m * per;
  const Item it = item_of(p, blockIdx.x + m * gridDim.x);
  const int shift = shift_of(it.unit), col = L::kWidth * it.unit - shift;
  if (r == 0) {  // the item's kTiles query tiles into slot m & 1 (past t: zeros)
    const int slot = m & 1;
    const uint32_t dst = sm.q + slot * L::kTiles * L::kSlot;
    if (m >= 2) mbar_wait(sm.q_empty + 8 * slot, ((m >> 1) - 1) & 1);
    if constexpr (kTma) mbar_expect_tx(landed_bar(sm, x), L::kTiles * L::kSlot);
    for (int i = 0; i < L::kTiles; ++i) {
      const int row = (it.qg * L::kTiles + i) * kTile;
      if constexpr (kTma) {
        for (int a = 0; a < L::kAtoms; ++a)
          tma_load3d(dst + i * L::kSlot + a * L::kAtom, &p.tm_q, landed_bar(sm, x),
                     col + L::kCols * a, row, it.b);
      } else {
        load_columns<G>(dst + i * L::kSlot, p.q + (size_t)it.b * p.t * p.h, p.h, row, p.t, col,
                        shift, shift + L::kWidth, pt);
      }
    }
  } else {  // stage n: head j's k and v rows of key slab kb, at its columns of slot n
    const int n = m * (per - 1) + r - 1, st = n % L::kStages;
    const int kb = (r - 1) / G, j = r - 1 - kb * G;
    const int head = shift + kHeadDim * j;  // the head's first column in the unit's boxes
    const uint32_t slot = sm.ring + st * 2 * L::kSlot;
    if (n >= L::kStages) mbar_wait(sm.empty + 8 * st, ((n / L::kStages) - 1) & 1);
    if constexpr (kTma) {  // the atoms that hold the head's columns
      const int a0 = head / L::kCols, a1 = (head + kHeadDim - 1) / L::kCols;
      const uint32_t bar = landed_bar(sm, x);
      mbar_expect_tx(bar, 2 * (a1 - a0 + 1) * L::kAtom);
      for (int a = a0; a <= a1; ++a) {
        tma_load3d(slot + a * L::kAtom, &p.tm_k, bar, col + L::kCols * a, kb * kTile, it.b);
        tma_load3d(slot + L::kSlot + a * L::kAtom, &p.tm_v, bar, col + L::kCols * a, kb * kTile,
                   it.b);
      }
    } else {
      const size_t base = (size_t)it.b * p.t * p.h;
      load_columns<G>(slot, p.k + base, p.h, kb * kTile, p.t, col, head, head + kHeadDim, pt);
      load_columns<G>(slot + L::kSlot, p.v + base, p.h, kb * kTile, p.t, col, head,
                      head + kHeadDim, pt);
    }
  }
  if constexpr (!kTma) cp_async_commit();
}

// Load x has landed (TMA), or this thread's copies of it have (cp.async): the zeroing, the
// fence and this thread's arrival. ft: this thread among the `count` finishing threads.
template <int G, bool kTma>
__device__ __forceinline__ void finish(const Params& p, const Smem& sm, int x, int per, int ft,
                                       int count) {
  using L = Layout<G>;
  const int m = x / per, r = x - m * per;
  const Item it = item_of(p, blockIdx.x + m * gridDim.x);
  const int shift = shift_of(it.unit);
  if constexpr (kTma) mbar_wait(landed_bar(sm, x), (x / kFinisherWarps / kLandedRing) & 1);
  if (r == 0) {
    const int slot = m & 1;
    if constexpr (kTma) {  // the neighbouring units' columns in the tiles' atoms
      for (int i = 0; i < L::kTiles; ++i)
        for (int row = ft; row < kTile; row += count) {
          const uint32_t tile = sm.q + (slot * L::kTiles + i) * L::kSlot;
          zero_columns<G>(tile, row, 0, shift);
          zero_columns<G>(tile, row, shift + L::kWidth, 16 * L::kSteps);
        }
    }
    fence_async_smem();
    mbar_arrive(sm.q_full + 8 * slot);
  } else {
    const int n = m * (per - 1) + r - 1, st = n % L::kStages;
    if constexpr (kTma) {  // the other columns of the atoms that hold head j's, below kd
      const int head = shift + kHeadDim * ((r - 1) % G);
      const int lo = head / L::kCols * L::kCols;
      const int hi = min(((head + kHeadDim - 1) / L::kCols + 1) * L::kCols, 16 * L::kSteps);
      const uint32_t slot = sm.ring + st * 2 * L::kSlot;
      for (int row = ft; row < kTile; row += count)
        for (int w = 0; w < 2; ++w) {
          zero_columns<G>(slot + w * L::kSlot, row, lo, head);
          zero_columns<G>(slot + w * L::kSlot, row, head + kHeadDim, hi);
        }
    }
    fence_async_smem();
    mbar_arrive(sm.full + 8 * st);
  }
}

// ---- the consumers

// A fragments of the query tile at qtile: k-step kk's (rows rl and rl + 8, columns 16 kk +
// 2 q4 and + 8), the layout pack_fragments gives an accumulator.
template <int G>
__device__ __forceinline__ void load_fragments(uint32_t (*qa)[4], uint32_t qtile, int rl, int q4) {
#pragma unroll
  for (int kk = 0; kk < Layout<G>::kSteps; ++kk)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      qa[kk][g] =
          ld_shared(qtile + boxed<G>(rl + 8 * (g & 1), 16 * kk + 2 * q4 + 8 * (g >> 1)));
}

// s = Qtile . K^T over the unit's kSteps k-steps: Qtile's A fragments from registers, the
// stage's k slot K-major (a k-step 16 columns of the swizzled atoms); outside head j's
// columns the slot holds zeros. Committed, not waited for.
template <int G>
__device__ __forceinline__ void scores(float* s, const uint32_t (*qa)[4], uint32_t kslot) {
  using L = Layout<G>;
  fence_regs<32>(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::kSteps; ++kk)
    WgmmaRs<64, 0>::mma(s, qa[kk],
                        make_desc(kslot + boxed<G>(0, 16 * kk), 16, L::kSbo, L::kSwizzle),
                        kk != 0);
  wgmma_commit();
}

// o += P . V over the stage's 64 keys: P the packed bf16 fragments, the v slot N-major (a
// k-step 16 rows; its atoms kAtom apart), all kNp columns. Committed, not waited for.
template <int G>
__device__ __forceinline__ void products(float* o, uint32_t (*pa)[4], uint32_t vslot) {
  using L = Layout<G>;
  fence_regs<L::kNp / 2>(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    WgmmaRs<L::kNp, 1>::mma(o, pa[kk],
                            make_desc(vslot + 16 * kk * L::kCols * 2, L::kAtom, L::kSbo,
                                      L::kSwizzle),
                            1);
  wgmma_commit();
}

// Store the rows below T of a [64 x kNp] accumulator, rounded, at its columns lo .. hi - 1
// (even) into `out` (rows `stride` elements apart from the batch row's first): 4-byte stores
// of bf16 pairs.
template <int kNp>
__device__ __forceinline__ void store_columns(bf16* out, const float* acc, int r0, int rl, int q4,
                                              int T, int stride, int lo, int hi) {
#pragma unroll
  for (int j = 0; j < kNp / 8; ++j) {
    const int d = 8 * j + 2 * q4;
    if (d < lo || d >= hi) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + rl + 8 * hh;
      if (row < T)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * stride + d) =
            pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

// A consumer warp's release of stage n's slot.
template <int G>
__device__ __forceinline__ void release(uint32_t empty, int n) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * (n % Layout<G>::kStages));
  __syncwarp();
}

// A consumer warpgroup's work items: its kTilesPerWg query tiles of each (tiles past T compute
// on zeros and are never stored). For each stage and tile: S, waited for (the wait also
// retires the last O += S . V, so one product overlaps the next S), packed, O += S . V.
// A stage is released once the first wait of the next one has retired every wgmma that read
// it.
template <int G>
__device__ __forceinline__ void consume(const Params& p, const Smem& sm, int my_items, int wg) {
  using L = Layout<G>;
  constexpr int kT = L::kTilesPerWg;
  const int stages = G * ((p.t + kTile - 1) / kTile);  // an item's
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, q4 = lane & 3;
  const int rl = 16 * warp + (lane >> 2);  // this thread's rows of a tile: rl and rl + 8
  float o[kT][L::kNp / 2];
  uint32_t qa[kT][L::kSteps][4];
  float s[32];
  int n = 0;  // stages consumed
  for (int m = 0; m < my_items; ++m) {
    const Item it = item_of(p, blockIdx.x + m * gridDim.x);
    mbar_wait(sm.q_full + 8 * (m & 1), (m >> 1) & 1);
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      load_fragments<G>(qa[i], sm.q + ((m & 1) * L::kTiles + wg * kT + i) * L::kSlot, rl, q4);
#pragma unroll
      for (int e = 0; e < L::kNp / 2; ++e) o[i][e] = 0.f;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.q_empty + 8 * (m & 1));  // its query tiles are read
    __syncwarp();
    for (int x = 0; x < stages; ++x, ++n) {
      const int st = n % L::kStages;
      mbar_wait(sm.full + 8 * st, (n / L::kStages) & 1);
      __syncwarp();
      const uint32_t kslot = sm.ring + st * 2 * L::kSlot;
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        scores<G>(s, qa[i], kslot);
        wgmma_wait<0>();
        fence_regs<32>(s);
        if (i == 0 && n > 0) release<G>(sm.empty, n - 1);
        uint32_t pa[4][4];
        pack_fragments(pa, s);
        products<G>(o[i], pa, kslot + L::kSlot);
      }
    }
    wgmma_wait<0>();
    const int shift = shift_of(it.unit);
    bf16* const out = p.o + (size_t)it.b * p.t * p.h + L::kWidth * it.unit - shift;
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      fence_regs<L::kNp / 2>(o[i]);
      store_columns<L::kNp>(out, o[i], (it.qg * L::kTiles + wg * kT + i) * kTile, rl, q4, p.t,
                            p.h, shift, shift + L::kWidth);
    }
  }
}

template <int G, bool kTma>
__global__ void __launch_bounds__(Layout<G>::kThreads, 1)
    headpack_wgmma_kernel(const __grid_constant__ Params p) {
  using L = Layout<G>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem sm = smem_map<G>((smem_u32(smem_raw) + 1023u) & ~1023u);
  // the ring starts as zeros: outside a head's window a slot is never written again
  for (int i = threadIdx.x; i < L::kStages * 2 * L::kSlot / 16; i += L::kThreads)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(sm.ring + 16 * i), "r"(0)
                 : "memory");
  fence_async_smem();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(sm.q_full + 8 * i, kTma ? 32 : 128);  // a finishing thread each
      mbar_init(sm.q_empty + 8 * i, 4 * L::kConsumers);  // a consumer warp each
    }
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(sm.full + 8 * st, kTma ? 32 : 128);
      mbar_init(sm.empty + 8 * st, 4 * L::kConsumers);
    }
    for (int i = 0; i < kFinisherWarps * kLandedRing; ++i)
      mbar_init(sm.landed + 8 * i, 1);  // the TMA issuer's expect_tx
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int my_items = (p.items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  if (wg == L::kConsumers) {
    setmaxnreg_dec<L::kProducerRegs>();
    const int per = 1 + G * ((p.t + kTile - 1) / kTile), total = my_items * per;  // loads
    const int pt = threadIdx.x - 128 * L::kConsumers;
    if constexpr (kTma) {
      if (pt == 0)
        for (int x = 0; x < total; ++x) issue<G, kTma>(p, sm, x, per, pt);
      else if (pt >= 32)
        for (int x = pt / 32 - 1; x < total; x += kFinisherWarps)
          finish<G, kTma>(p, sm, x, per, pt % 32, 32);
    } else {
      for (int x = 0; x < total; ++x) {
        issue<G, kTma>(p, sm, x, per, pt);
        cp_async_wait<0>();
        finish<G, kTma>(p, sm, x, per, pt, 128);
      }
    }
    return;
  }
  setmaxnreg_inc<L::kConsumerRegs>();
  consume<G>(p, sm, my_items, wg);
}

// ---- host side

// q, k, v, o: bfloat16 [batch, t, h], 8-byte aligned, h a multiple of 36: the body for G,
// persistent (one block an SM). Its loads go by TMA where h is a multiple of 8 and q, k, v are
// 16-byte aligned (a TMA map's rows are 16-byte multiples), by cp.async otherwise.
template <int G>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int t,
                   int h, cudaStream_t stream) {
  using L = Layout<G>;
  const uintptr_t ins = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v);
  if (batch <= 0 || t <= 0 || h % kHeadDim || h < L::kWidth ||
      (ins | reinterpret_cast<uintptr_t>(o)) % 8)
    return cudaErrorInvalidValue;
  const int tiles = (t + kTile - 1) / kTile, groups = (tiles + L::kTiles - 1) / L::kTiles;
  const long long items = (long long)groups * (h / L::kWidth) * batch;
  if (items > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.t = t;
  p.h = h;
  p.units = h / L::kWidth;
  p.groups = groups;
  p.items = (int)items;
  const bool tma = h % 8 == 0 && ins % 16 == 0;
  if (tma) {  // rows past t and columns past h read zeros
    const cuuint64_t dims[3] = {(cuuint64_t)h, (cuuint64_t)t, (cuuint64_t)batch};
    const cuuint64_t strides[2] = {(cuuint64_t)h * 2, (cuuint64_t)t * h * 2};
    const cuuint32_t box[3] = {L::kCols, kTile, 1};
    const CUtensorMapSwizzle swizzle =
        G == 1 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
    if (!make_map_nd(&p.tm_q, q, 3, dims, strides, box, swizzle) ||
        !make_map_nd(&p.tm_k, k, 3, dims, strides, box, swizzle) ||
        !make_map_nd(&p.tm_v, v, 3, dims, strides, box, swizzle))
      return cudaErrorInvalidValue;
  }
  auto kernel = tma ? headpack_wgmma_kernel<G, true> : headpack_wgmma_kernel<G, false>;
  // setmaxnreg moves registers between the warpgroups of a block: the block's entry
  // allocation must cover what they hold after it, or the consumers would wait forever
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * L::kThreads < 128 * (L::kProducerRegs + L::kConsumers * L::kConsumerRegs))
    return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int grid = items < sms ? (int)items : sms;
  kernel<<<grid, L::kThreads, L::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace headpack_hopper
