// The bfloat16 body of the fused FFN for Hopper (sm_90a): kernels B7 (fused_ffn.cu, kModeFfn)
// and B6f (fused_ffn_ln.cu, kModeLn). B6b's row work (fused_ffn_ln_bwd.cu) runs a backward
// body on the same layout, rings and helpers: ffn_hopper_bwd.cuh.
//
// Replaces the TPU kernels `_kernel` in weathermodel_tpu/ops/pallas_ffn2.py (B7, via
// `fused_ffn`) and `_ffn_fwd_kernel` in weathermodel_tpu/ops/pallas_ffn.py (B6f, via
// `_ffn_ln`). For x [M, H], W1 [H, F], W2 [F, H] in bf16 and fp32 b1, b2, LN scale and bias:
//   h = dropout1(relu(x . W1 + b1))   rounded once to bf16
//   f = dropout2(h . W2 + b2)         fp32
//   B7:  f rounded, and h written when asked for; a kept value times 1/(1 - p)
//   B6f: out = LN(x + f), fp32 two-pass statistics, eps 1e-5, rounded; a kept value / (1 - p)
// with the keep bits of ffn_common.cuh's `keep_bit`. The fp32 instantiations (and fp32 B6b's
// recompute pass) stay on ffn_common.cuh's row kernel.
//
// What bounds it: 4 M H F operations, 558 GFLOP at the bench microbatch (M = 105,120,
// H = 576, F = 2304), 0.564 ms at the 989 TFLOP/s bf16 peak, against 242 MB of x and the
// output (484 MB more for B7's h): operations. Every block streams both weight matrices
// (2 H F x 2 B = 5.31 MB) from L2: with the old body's 32-row blocks 3,285 x 5.31 MB =
// 17.4 GB of L2 reads a call, with 64-row blocks 1,643 x 5.31 MB = 8.7 GB (a cluster of 2
// or 4 blocks sharing each tile by TMA multicast would make that 4.4 or 2.2 GB).
//
// Design. A block owns kRows = 64 rows (one wgmma M tile) and every H column of them, so
// B6f's LayerNorm sees whole rows. 256 threads, two consumer warpgroups; warpgroup wg owns
// hidden columns [64 wg, +64) of each 128-column chunk of F and output columns
// [32 kAtoms wg, +32 kAtoms) (fp32 accumulators in registers: 144 a thread at H = 576).
//   * x's [64, H] tile comes in once by TMA and stays: the first product's A operand and
//     B6f's residual.
//   * Each consumer streams its own weights through its own ring of S stages (4 at
//     H = 576), one TMA box a slab: per chunk nks W1 half tiles [64 x 64] (its hidden
//     columns), then 8 W2 half slabs [16 x 32 kAtoms] (its output columns) as a 3-D box of
//     32-column blocks. Its thread 0 refills a stage as soon as its own wgmma group that
//     read the stage has completed, so neither consumer ever waits on the other for a
//     stage; each stage has a full mbarrier, no empty one.
//   * Per chunk, each consumer runs the first product h_c[64 x 64] = x . W1 with wgmma
//     m64n64k16 (A = x, K-major, 128-byte swizzle; B = the W1 tile, N-major through the
//     transpose bit: the JAX layout is kept, nothing is transposed on the host), applies
//     b1, ReLU, dropout1 and the bf16 rounding in registers from the accumulator layout,
//     writes its half into the swizzled [64 x 128] h tile, and after a named barrier
//     between the two consumers runs acc += h_c . W2 on its half of H (B N-major, 64-byte
//     swizzle; N = 160 + 128 at H = 576). B7's h leaves by TMA store of the h tile, a
//     [64 x 64] box per consumer and chunk.
//   * The epilogue adds b2 and dropout2 in registers; B6f adds x from its resident tile,
//     exchanges the row sums between the two consumers through shared memory for the
//     mean, then the centred sums of squares, and applies LN. The rounded rows overwrite
//     x's tile (each thread reads x only where it writes) and leave by TMA store.
// What the card showed at the bench shape (H100; PERF.md): a producer warpgroup (384
// threads, the roles one if/else that never rejoins, setmaxnreg 24 / 240) took effect (no
// C7508: the 6-atom consumers no longer spilled at a 168-register entry), but the 9- and
// 10-atom consumers still fell short: ptxas serialized their wgmmas (C7512) and spilled,
// and the body ran several times slower. At H = 576 the consumers need nearly all the 255
// registers a thread of a 256-thread block can have, so none are left for a producer. A
// loader thread inside consumer 0 that refilled a shared ring once both consumers had
// released a stage stalled consumer 0 on that handshake. A shared ring, clusters of 2 and 4
// blocks with multicast, a TMA box per 16 x 32 W2 block (a TMA instruction costs time of
// its own) and a 7-stage ring were each slower than this layout.
// Ragged edges are left to TMA: reads past M, H or F come in as zeros, writes are clipped;
// nothing is padded in device memory. Needs H and F multiples of 8 (TMA's 16-byte strides)
// and 16-byte aligned tensors; ops/fused_ffn_ln.py checks both and raises otherwise.
// Instantiations: kAtoms in {1, 4, 6, 9, 10} (H up to 64, 256, 384, 576, 640: mini, small,
// medium, large, and the widest the row kernel took); a width between two takes the
// larger, whose extra columns are zeros that are never stored.
// Registers, spills and dynamic shared memory of each instantiation: fused_ffn.cu and
// fused_ffn_ln.cu (ptxas -v, printed by chip_smoke.py's build phase).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ffn_common.cuh"
#include "hopper_common.cuh"

namespace ffn_hopper {

using namespace hopper;

constexpr int kRows = 64;         // rows of x per block: one wgmma M tile
constexpr int kChunk = 128;       // hidden columns per pass, 64 per consumer
constexpr int kSlab1 = 64;        // W1 rows (of H) in a slab
constexpr int kSlab2 = 16;        // W2 rows (of F) in a slab: one wgmma K step
constexpr int kSlabs2 = kChunk / kSlab2;
constexpr int kThreads = 256;     // two consumer warpgroups
constexpr int kBox = 64 * 64 * 2;             // a [64 x 64] bf16 box, 128-byte swizzle
constexpr int kAtomBox = kSlab2 * 32 * 2;     // a [16 x 32] W2 block, 64-byte swizzle
constexpr int kMaxH = 640;

struct Params {
  // 2-D maps [rows, cols] in boxes of one swizzle width, and 3-D views of x, out and W2
  // as (width, rows, blocks of width columns) that move a row block's whole blocks in one
  // box: each TMA instruction costs time of its own, so a slab is one instruction
  CUtensorMap tm_x, tm_w1, tm_w2, tm_out, tm_h, tm_x3, tm_w23, tm_out3;
  const float* b1;
  const float* b2;
  const float* ls;
  const float* lb;
  int m, h, f, nxb, nchunks, want_h, on;
  int nfx;   // x's and out's full 64-column blocks (one 3-D box)
  int nfw2;  // W2's full 32-column blocks
  uint32_t seed1, seed2, threshold;
  float scale;      // kept values: v / scale in kModeLn (scale = 1 - p), else v * scale
  float inv_scale;  // 1 / scale
};

// Each consumer's weight ring: per chunk nks W1 half tiles [64 x 64] (its hidden columns)
// then kSlabs2 W2 half slabs [16 x 32 kAtoms] (its output columns), in the order it reads
// them, in as many stages as the shared memory left by x and h holds.
template <int kAtoms>
struct Ring {
  static constexpr int kStageBytes = kBox > kAtoms * kAtomBox ? kBox : kAtoms * kAtomBox;
  static constexpr int kFit = (kSmemMax - (kAtoms + 2) * kBox - 3072) / (2 * kStageBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;  // 4 measured faster than 7
  static_assert(kStages >= 2, "the ring needs two stages");
};

// Byte offsets into the block's dynamic shared memory (after aligning it to 1024).
struct Smem {
  int xs, ring, hs, bars, red, total;
};

template <int kAtoms>
__host__ __device__ inline Smem smem_layout(int nxb) {
  constexpr int S = Ring<kAtoms>::kStages;
  Smem s;
  s.xs = 0;
  s.ring = nxb * kBox;
  s.hs = s.ring + 2 * S * Ring<kAtoms>::kStageBytes;
  s.bars = s.hs + 2 * kBox;
  s.red = s.bars + 8 * (1 + 2 * S);
  s.total = s.red + 2 * 2 * kRows * 4 + 1024;  // + slack for the alignment
  return s;
}

// A consumer's kAtoms output atoms as at most two wgmma N widths (in atoms).
template <int kAtoms>
struct Pieces {
  static constexpr int first = kAtoms <= 5 ? kAtoms : (kAtoms + 1) / 2;
  static constexpr int second = kAtoms - first;
};

// A kept value: v * scale (kModeFfn: scale = 1/(1-p)), or v / scale (kModeLn: scale = 1-p)
// as a correctly rounded quotient from the reciprocal `inv` = 1/scale and one FMA
// correction (no call into the division's slow path, whose saved registers spilled).
template <int kMode>
__device__ __forceinline__ float drop(float v, bool keep, float scale, float inv) {
  if (!keep) return 0.f;
  if constexpr (kMode == ffn::kModeLn) {
    const float q = v * inv;
    return fmaf(fmaf(-q, scale, v), inv, q);
  } else {
    return v * scale;
  }
}

namespace {

template <int kMode, int kAtoms>
__global__ void __launch_bounds__(kThreads, 1) ffn_wgmma_kernel(const __grid_constant__ Params p) {
  constexpr int S = Ring<kAtoms>::kStages, kStageBytes = Ring<kAtoms>::kStageBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem L = smem_layout<kAtoms>(p.nxb);
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* red = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) + L.red);

  // warpgroup wg owns hidden columns [64 wg, 64 wg + 64) of each chunk and output columns
  // [32 kAtoms wg, 32 kAtoms (wg + 1)), and its own ring of stages with their full barriers
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int row0 = blockIdx.x * kRows;
  const int nks = p.nxb;  // W1 slabs per chunk: 64 rows of H each
  const uint32_t xs = base + L.xs, hs = base + L.hs, x_full = base + L.bars;
  const uint32_t ring = base + L.ring + wg * S * kStageBytes, full = x_full + 8 + wg * 8 * S;

  if (threadIdx.x == 0) {
    mbar_init(x_full, 1);
    for (int s = 0; s < 2 * S; ++s) mbar_init(x_full + 8 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // ---- the loads: thread 0 of each consumer issues its own ring's. Slab n goes into stage
  // n % S as soon as this consumer's wgmma group that read slab n - S has completed, so
  // nobody waits on anybody else for a stage (a shared ring refilled after both consumers
  // released a stage stalled on that handshake; a producer warpgroup, even with setmaxnreg
  // in effect, cost the consumers registers: ptxas serialized the wgmmas and spilled)
  const int per_chunk = nks + kSlabs2, n_total = p.nchunks * per_chunk;
  auto load = [&](int n) {
    const int st = n % S, c = n / per_chunk, r = n % per_chunk;
    const uint32_t dst = ring + st * kStageBytes, bar = full + 8 * st;
    if (r < nks) {  // W1 rows [64 r, +64) x columns [128 c + 64 wg, +64), zeros past H, F
      mbar_expect_tx(bar, kBox);
      tma_load(dst, &p.tm_w1, bar, c * kChunk + 64 * wg, r * kSlab1);
    } else {  // W2 rows [128 c + 16 (r - nks), +16) x this consumer's blocks, zeros past F, H
      const int row = c * kChunk + (r - nks) * kSlab2, a0 = wg * kAtoms;
      mbar_expect_tx(bar, kAtoms * kAtomBox);
      if (a0 + kAtoms <= p.nfw2) {
        tma_load3d(dst, &p.tm_w23, bar, 0, row, a0);
      } else {
        for (int a = 0; a < kAtoms; ++a)
          tma_load(dst + a * kAtomBox, &p.tm_w2, bar, 32 * (a0 + a), row);
      }
    }
  };
  if (t == 0) {
    if (wg == 0) {
      mbar_expect_tx(x_full, p.nxb * kBox);
      if (p.nfx > 0) tma_load3d(xs, &p.tm_x3, x_full, 0, row0, 0);
      if (p.nfx < p.nxb) tma_load(xs + p.nfx * kBox, &p.tm_x, x_full, 64 * p.nfx, row0);
    }
    for (int n = 0; n < S && n < n_total; ++n) load(n);
  }

  const int warp = t / 32, lane = t % 32, q = lane & 3;
  const int rl = 16 * warp + (lane >> 2);  // this thread's rows: rl and rl + 8
  uint32_t key1[2], key2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key1[i] = wm::dropout_head_key(p.seed1, (uint32_t)(row0 + rl + 8 * i));
    key2[i] = wm::dropout_head_key(p.seed2, (uint32_t)(row0 + rl + 8 * i));
  }
  constexpr int kAcc2 = 16 * kAtoms;
  float acc2[kAcc2];
#pragma unroll
  for (int v = 0; v < kAcc2; ++v) acc2[v] = 0.f;
  float acc1[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) acc1[v] = 0.f;

  // wgmma groups stay in flight one deep: after committing the group of slab n, wait for
  // the group of slab n - 1 and refill its stage with slab n - 1 + S (two deep measured
  // the same)
  int n = 0;      // the next slab of the ring
  int prev = -1;  // the slab read by the last committed group
  auto refill = [&]() {
    if (prev >= 0 && t == 0 && prev + S < n_total) load(prev + S);
    __syncwarp();
  };
  auto committed = [&](int slab) {  // after wgmma_commit() of the group reading `slab`
    wgmma_wait<1>();
    refill();
    prev = slab;
  };
  auto drain = [&]() {  // every group complete, every stage they read refilled
    wgmma_wait<0>();
    refill();
    prev = -1;
  };

  mbar_wait(x_full, 0);
  __syncwarp();
  const bool rows_in = row0 < p.m;

  for (int c = 0; c < p.nchunks; ++c) {
    // ---- first product: acc1 = x . W1[:, c*128 + 64 wg + (0..63)]
    for (int s = 0; s < nks; ++s, ++n) {
      const int st = n % S;
      mbar_wait(full + 8 * st, (n / S) & 1);
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = make_desc(xs + s * kBox + kk * 32, 16, 1024, 1);
        const uint64_t db = make_desc(ring + st * kStageBytes + kk * 2048, 1024, 1024, 1);
        Wgmma<64>::mma(acc1, da, db, (s | kk) != 0);
      }
      wgmma_commit();
      committed(n);
    }
    drain();

    // ---- the hidden chunk: bias, ReLU, dropout1, bf16, into the h tile
    if (p.want_h && t == 0) tma_store_wait_read();  // the last chunk's h store has read it
    named_sync(1, 256);  // both consumers are done reading the h tile
    const uint32_t hbox = hs + wg * kBox;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = c * kChunk + 64 * wg + 8 * jj + 2 * q;
      float2 bb = make_float2(0.f, 0.f);
      if (col < p.f) bb = __ldg(reinterpret_cast<const float2*>(p.b1 + col));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v0 = fmaxf(acc1[4 * jj + 2 * i] + bb.x, 0.f);
        float v1 = fmaxf(acc1[4 * jj + 2 * i + 1] + bb.y, 0.f);
        if (p.on) {
          v0 = drop<kMode>(v0, ffn::keep_bit(key1[i], col, p.threshold), p.scale, p.inv_scale);
          v1 = drop<kMode>(v1, ffn::keep_bit(key1[i], col + 1, p.threshold), p.scale, p.inv_scale);
        }
        st_shared(hbox + sw128(rl + 8 * i, 8 * jj + 2 * q), pack_bf16(v0, v1));
      }
    }
    fence_async_smem();
    named_sync(2, 256);  // the whole h tile is written
    if (p.want_h && t == 0 && rows_in && c * kChunk + 64 * wg < p.f)
      tma_store(&p.tm_h, hbox, c * kChunk + 64 * wg, row0);

    // ---- second product: acc2 += h_c . W2[c*128 + (0..127), this consumer's columns]
    for (int j = 0; j < kSlabs2; ++j, ++n) {
      const int st = n % S;
      mbar_wait(full + 8 * st, (n / S) & 1);
      __syncwarp();
      wgmma_fence();
      const int k = j * kSlab2;  // row of the h tile's K
      const uint64_t da = make_desc(hs + (k / 64) * kBox + (k % 64) * 2, 16, 1024, 1);
      const uint32_t b0 = ring + st * kStageBytes;
      constexpr int P0 = Pieces<kAtoms>::first, P1 = Pieces<kAtoms>::second;
      const uint64_t db0 = make_desc(b0, kAtomBox, 512, 2);
      const uint64_t db1 = make_desc(b0 + P0 * kAtomBox, kAtomBox, 512, 2);
      Wgmma<32 * P0>::mma(acc2, da, db0, 1);
      if constexpr (P1 > 0) Wgmma<32 * P1>::mma(acc2 + 16 * P0, da, db1, 1);
      wgmma_commit();
      committed(n);
    }
  }
  drain();

  // ---- epilogue: b2, dropout2, (B6f: residual and LayerNorm), rounded into x's tile
  // (each thread reads x only where it writes), then out by TMA store
  const int c0 = wg * 32 * kAtoms;
#pragma unroll
  for (int jj = 0; jj < 4 * kAtoms; ++jj) {
    const int col = c0 + 8 * jj + 2 * q;
    const bool in = col < p.h;
    float2 bb = make_float2(0.f, 0.f);
    if (in) bb = __ldg(reinterpret_cast<const float2*>(p.b2 + col));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float v0 = acc2[4 * jj + 2 * i] + bb.x, v1 = acc2[4 * jj + 2 * i + 1] + bb.y;
      if (p.on) {
        v0 = drop<kMode>(v0, ffn::keep_bit(key2[i], col, p.threshold), p.scale, p.inv_scale);
        v1 = drop<kMode>(v1, ffn::keep_bit(key2[i], col + 1, p.threshold), p.scale, p.inv_scale);
      }
      if constexpr (kMode == ffn::kModeLn) {
        if (in) {
          const float2 xv =
              unpack_bf16(ld_shared(xs + (col >> 6) * kBox + sw128(rl + 8 * i, col & 63)));
          v0 += xv.x;
          v1 += xv.y;
        } else {
          v0 = v1 = 0.f;
        }
      }
      acc2[4 * jj + 2 * i] = v0;
      acc2[4 * jj + 2 * i + 1] = v1;
    }
  }
  if constexpr (kMode == ffn::kModeLn) {
    // two-pass statistics over the row, shared between the two consumers
    float mu[2], rstd[2];
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float s = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4 * kAtoms; ++jj) {
          const bool in = c0 + 8 * jj + 2 * q < p.h;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = acc2[4 * jj + 2 * i + e];  // 0 past h
            const float d = pass == 0 ? v : (in ? v - mu[i] : 0.f);
            s += pass == 0 ? d : d * d;
          }
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (q == 0) red[(pass * 2 + wg) * kRows + rl + 8 * i] = s;
      }
      named_sync(3 + pass, 256);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rl + 8 * i;
        const float tot = red[(pass * 2) * kRows + r] + red[(pass * 2 + 1) * kRows + r];
        if (pass == 0)
          mu[i] = tot / p.h;
        else
          rstd[i] = rsqrtf(tot / p.h + ffn::kLnEps);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 4 * kAtoms; ++jj) {
      const int col = c0 + 8 * jj + 2 * q;
      if (col >= p.h) continue;
      const float2 g = __ldg(reinterpret_cast<const float2*>(p.ls + col));
      const float2 bb = __ldg(reinterpret_cast<const float2*>(p.lb + col));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v0 = (acc2[4 * jj + 2 * i] - mu[i]) * rstd[i] * g.x + bb.x;
        const float v1 = (acc2[4 * jj + 2 * i + 1] - mu[i]) * rstd[i] * g.y + bb.y;
        st_shared(xs + (col >> 6) * kBox + sw128(rl + 8 * i, col & 63), pack_bf16(v0, v1));
      }
    }
  } else {
#pragma unroll
    for (int jj = 0; jj < 4 * kAtoms; ++jj) {
      const int col = c0 + 8 * jj + 2 * q;
      if (col >= p.h) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        st_shared(xs + (col >> 6) * kBox + sw128(rl + 8 * i, col & 63),
                  pack_bf16(acc2[4 * jj + 2 * i], acc2[4 * jj + 2 * i + 1]));
    }
  }
  fence_async_smem();
  named_sync(5, 256);  // the block's output rows are in x's tile
  if (t == 0 && rows_in) {
    if (wg == 0 && p.nfx > 0) tma_store3(&p.tm_out3, xs, row0);
    if (wg == 1 && p.nfx < p.nxb) tma_store(&p.tm_out, xs + p.nfx * kBox, 64 * p.nfx, row0);
    tma_store_wait_read();  // the block may end once the store has read its shared memory
  }
}

// ---- host side

// The instantiation that takes width h: 32-column atoms per consumer.
inline int atoms_for(int h) {
  return h <= 64 ? 1 : h <= 256 ? 4 : h <= 384 ? 6 : h <= 576 ? 9 : 10;
}

// The dynamic shared memory a block takes at width h (h <= kMaxH).
inline int smem_bytes(int h) {
  const int nxb = (h + 63) / 64;
  switch (atoms_for(h)) {
    case 1: return smem_layout<1>(nxb).total;
    case 4: return smem_layout<4>(nxb).total;
    case 6: return smem_layout<6>(nxb).total;
    case 9: return smem_layout<9>(nxb).total;
    default: return smem_layout<10>(nxb).total;
  }
}

template <int kMode, int kAtoms>
cudaError_t launch_atoms(Params& p, cudaStream_t stream) {
  const Smem L = smem_layout<kAtoms>(p.nxb);
  auto kernel = ffn_wgmma_kernel<kMode, kAtoms>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((p.m + kRows - 1) / kRows);
  kernel<<<blocks, kThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

// Launch the body over all rows: x [m, h], w1 [h, f], w2 [f, h], out [m, h], hidden [m, f]
// or null, all bf16 and 16-byte aligned, h and f multiples of 8, h <= 640.
template <int kMode>
cudaError_t launch(const ffn::RowsArgs& a, cudaStream_t stream) {
  if (a.m < 0 || a.h <= 0 || a.f <= 0 || a.h > kMaxH || a.h % 8 || a.f % 8)
    return cudaErrorInvalidValue;
  if (a.m == 0) return cudaSuccess;
  Params p = {};
  const bool ok =
      make_map(&p.tm_x, a.x, a.m, a.h, kRows, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&p.tm_w1, a.w1, a.h, a.f, kSlab1, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&p.tm_w2, a.w2, a.f, a.h, kSlab2, 32, CU_TENSOR_MAP_SWIZZLE_64B) &&
      make_map(&p.tm_out, a.out, a.m, a.h, kRows, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
      (a.hidden == nullptr ||
       make_map(&p.tm_h, a.hidden, a.m, a.f, kRows, 64, CU_TENSOR_MAP_SWIZZLE_128B));
  if (!ok) return cudaErrorInvalidValue;
  p.nfx = a.h / 64;
  p.nfw2 = a.h / 32;
  const int atoms = atoms_for(a.h);
  const bool ok3 =
      (p.nfx == 0 ||
       (make_map3(&p.tm_x3, a.x, a.m, a.h, 64, p.nfx, kRows, p.nfx, CU_TENSOR_MAP_SWIZZLE_128B) &&
        make_map3(&p.tm_out3, a.out, a.m, a.h, 64, p.nfx, kRows, p.nfx,
                  CU_TENSOR_MAP_SWIZZLE_128B))) &&
      (p.nfw2 < atoms || make_map3(&p.tm_w23, a.w2, a.f, a.h, 32, p.nfw2, kSlab2, atoms,
                                   CU_TENSOR_MAP_SWIZZLE_64B));
  if (!ok3) return cudaErrorInvalidValue;
  p.b1 = a.b1;
  p.b2 = a.b2;
  p.ls = a.ls;
  p.lb = a.lb;
  p.m = a.m;
  p.h = a.h;
  p.f = a.f;
  p.nxb = (a.h + 63) / 64;
  p.nchunks = (a.f + kChunk - 1) / kChunk;
  p.want_h = a.hidden != nullptr;
  p.on = a.on;
  p.seed1 = a.seed1;
  p.seed2 = a.seed2;
  p.threshold = a.threshold;
  p.scale = a.scale;
  p.inv_scale = 1.f / a.scale;
  switch (atoms) {
    case 1: return launch_atoms<kMode, 1>(p, stream);
    case 4: return launch_atoms<kMode, 4>(p, stream);
    case 6: return launch_atoms<kMode, 6>(p, stream);
    case 9: return launch_atoms<kMode, 9>(p, stream);
    default: return launch_atoms<kMode, 10>(p, stream);
  }
}

}  // namespace

}  // namespace ffn_hopper
