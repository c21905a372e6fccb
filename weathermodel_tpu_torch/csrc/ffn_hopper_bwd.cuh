// The bfloat16 body of B6b's row work for Hopper (sm_90a): fused_ffn_ln_bwd.cu's recompute,
// LayerNorm backward and the dz and dx products, on ffn_hopper.cuh's layout, rings and
// helpers (its note: 64-row blocks, two consumer warpgroups each with its own TMA ring,
// wgmma with the fp32 accumulators of [64, H] in registers).
//
// Replaces, with the weight-gradient passes of fused_ffn_ln_bwd.cu, the TPU kernel
// `_ffn_bwd_kernel` in weathermodel_tpu/ops/pallas_ffn.py (via `_ffn_bwd_rule`).
//
// What bounds it: 8 M H F operations (the recompute's two products and the dz and dx
// products; 1116 GFLOP at the bench microbatch M = 105,120, H = 576, F = 2304, 1.13 ms at the
// 989 TFLOP/s bf16 peak) against x and do in, hd and dz (484 MB each), df and dx out:
// operations. Each block streams both weight matrices twice from L2.
//
// Design. One block of kRows = 64 rows and two consumer warpgroups, each with its own TMA
// ring, as the forward. Per block, with the forward's column ownership (warpgroup wg: hidden
// columns [64 wg, +64) of each 128-column chunk, output columns [32 kAtoms wg, +32 kAtoms)):
//   loop 1, per chunk c: the forward's first product and hidden epilogue with the
//     backward's dropout (kept values times 1/(1-p), as the TPU backward):
//     hd_c = rnd(keep1 ? relu(x . W1_c + b1) / (1-p) : 0) into the h tile and out to hd by
//     TMA store (dW2 needs it), and mask1 = keep1 && x . W1_c + b1 > 0 as one 32-bit word a
//     thread and chunk in shared memory (the accumulator layout: bit 4 jj + 2 i + e of
//     column 8 jj + 2 q + e, row rl + 8 i); then acc += hd_c . W2_c.
//   epilogue: y = x + dropout2(acc + b2), the LayerNorm statistics over whole rows (the two
//     consumers exchange row sums), xhat, then the LayerNorm backward in place:
//     dy = rstd (do ls - mean(do ls) - xhat mean(do ls xhat)) stays in the fp32
//     accumulators; df = rnd(dropout2(dy)) overwrites x's tile (each thread reads x only
//     where it writes) and goes out by TMA store (dW2 and db2 need it); the block's column
//     sums of do xhat and do go to ln_part (each warp's 16 rows by shuffles, then the four
//     warps in order) for the ordered sum over blocks.
//   loop 2, per chunk c: g_c = df . W2_c^T on wgmma m64n64k16 (A = df's tile, K-major; B =
//     a [64 x 64] box of W2's rows, K-major: the transpose bit off, nothing transposed on
//     the host); dz_c = rnd(mask1 ? g_c / (1-p) : 0) into the h tile and out to dz by TMA
//     store (dW1 and db1 need it); acc += dz_c . W1_c^T, B = [32 kAtoms x 16] slabs of W1's
//     rows, K-major with the 32-byte swizzle, so acc, which started as dy, ends as dx.
//   dx = rnd(acc) over df's tile (after the df store has read it), out by TMA store.
// mask1 is kept as bits rather than recomputed (a third product, 2 M H F operations) or
// re-read from hd (hd != 0 differs from x . W1 + b1 > 0 where a positive pre-activation
// rounds to zero): 1 KB a chunk, 18 KB at F = 2304. dy never leaves the chip.
// Registers: loop 2 holds what the forward holds (acc 16 kAtoms floats a thread and the
// [64 x 64] chunk's 32); no producer warpgroup (ffn_hopper.cuh's note says why).

#pragma once

#include "ffn_hopper.cuh"

namespace ffn_hopper {

namespace {

constexpr int kBwdMaskMax = 20 * 1024;  // F up to 2560: 20 chunks of 256 words

template <int kAtoms>
struct BwdRing {
  static constexpr int kStageBytes = Ring<kAtoms>::kStageBytes;
  static constexpr int kCols = 2 * 4 * 2 * 32 * kAtoms * 4;  // [wg][warp][plane][column]
  static constexpr int kRed = 4 * 2 * kRows * 4;              // [plane][wg][row]
  static constexpr int kFit = (kSmemMax - (kAtoms + 2) * kBox - kBwdMaskMax - kCols - kRed -
                               2048) / (2 * kStageBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "the ring needs two stages");
};

struct BwdParams {
  // loop 1: the forward's maps of x, W1 and W2; loop 2: W2 in [64 x 64] boxes of its rows
  // (w2k) and W1 in [32 x 16] slabs of its rows (w1k, and a 3-D view of kAtoms of them);
  // the outputs hd, dz, df and dx (df and dx also as 3-D views of whole 64-column blocks)
  CUtensorMap tm_x, tm_x3, tm_w1, tm_w2, tm_w23, tm_w2k, tm_w1k, tm_w1k3, tm_h, tm_dz, tm_df,
      tm_df3, tm_dx, tm_dx3;
  const float* b1;
  const float* b2;
  const float* ls;
  const __nv_bfloat16* dout;
  float* ln_part;  // [blocks, 2, h]
  int m, h, f, nxb, nchunks, on;
  int nfx;   // x's (and df's, dx's) full 64-column blocks
  int nfw;   // W2's full 32-column blocks = W1's full 32-row blocks
  uint32_t seed1, seed2, threshold;
  float inv_keep;
};

struct BwdSmem {
  int xs, ring, hs, mask, bars, red, cols, total;
};

template <int kAtoms>
__host__ __device__ inline BwdSmem bwd_smem_layout(int nxb, int nchunks) {
  using R = BwdRing<kAtoms>;
  BwdSmem s;
  s.xs = 0;
  s.ring = nxb * kBox;
  s.hs = s.ring + 2 * R::kStages * R::kStageBytes;
  s.mask = s.hs + 2 * kBox;
  s.bars = s.mask + nchunks * kThreads * 4;
  s.red = s.bars + 8 * (1 + 2 * R::kStages);
  s.red = (s.red + 15) / 16 * 16;
  s.cols = s.red + R::kRed;
  s.total = s.cols + R::kCols + 1024;  // + slack for the alignment
  return s;
}

template <int kAtoms>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_bwd_wgmma_kernel(const __grid_constant__ BwdParams p) {
  constexpr int S = BwdRing<kAtoms>::kStages, kStageBytes = BwdRing<kAtoms>::kStageBytes;
  constexpr int kW = 32 * kAtoms;  // a consumer's output columns
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const BwdSmem L = bwd_smem_layout<kAtoms>(p.nxb, p.nchunks);
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - smem_u32(smem_raw));
  float* red = reinterpret_cast<float*>(sbase + L.red);
  float* cols = reinterpret_cast<float*>(sbase + L.cols);

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int row0 = blockIdx.x * kRows;
  const int nks = p.nxb;  // 64-column slabs of H
  const uint32_t xs = base + L.xs, hs = base + L.hs, masks = base + L.mask;
  const uint32_t x_full = base + L.bars;
  const uint32_t ring = base + L.ring + wg * S * kStageBytes, full = x_full + 8 + wg * 8 * S;

  if (threadIdx.x == 0) {
    mbar_init(x_full, 1);
    for (int s = 0; s < 2 * S; ++s) mbar_init(x_full + 8 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // each consumer's slabs in the order it reads them: loop 1 per chunk nks W1 half tiles and
  // kSlabs2 W2 half slabs (the forward's), then loop 2 per chunk nks W2 boxes [64 rows of
  // its hidden columns x 64 of H] and kSlabs2 W1 slabs [its 32 kAtoms rows of H x 16 of the
  // chunk]; zeros past H and F
  const int per_chunk = nks + kSlabs2, per_loop = p.nchunks * per_chunk;
  const int n_total = 2 * per_loop;
  auto load = [&](int n) {
    const int st = n % S, loop = n / per_loop, c = n % per_loop / per_chunk;
    const int r = n % per_chunk, a0 = wg * kAtoms;
    const uint32_t dst = ring + st * kStageBytes, bar = full + 8 * st;
    if (r < nks) {
      mbar_expect_tx(bar, kBox);
      if (loop == 0)
        tma_load(dst, &p.tm_w1, bar, c * kChunk + 64 * wg, r * kSlab1);
      else
        tma_load(dst, &p.tm_w2k, bar, r * 64, c * kChunk + 64 * wg);
      return;
    }
    const int k = c * kChunk + (r - nks) * kSlab2;  // the slab's first row of W2 / column of W1
    mbar_expect_tx(bar, kAtoms * kAtomBox);
    if (a0 + kAtoms <= p.nfw) {
      tma_load3d(dst, loop == 0 ? &p.tm_w23 : &p.tm_w1k3, bar, loop == 0 ? 0 : k,
                 loop == 0 ? k : 0, a0);
    } else {
      for (int a = 0; a < kAtoms; ++a) {
        if (loop == 0)
          tma_load(dst + a * kAtomBox, &p.tm_w2, bar, 32 * (a0 + a), k);
        else
          tma_load(dst + a * kAtomBox, &p.tm_w1k, bar, k, 32 * (a0 + a));
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

  // wgmma groups one deep, each stage refilled once the group that read it completed (the
  // forward's scheme)
  int n = 0, prev = -1;
  auto refill = [&]() {
    if (prev >= 0 && t == 0 && prev + S < n_total) load(prev + S);
    __syncwarp();
  };
  auto committed = [&](int slab) {
    wgmma_wait<1>();
    refill();
    prev = slab;
  };
  auto drain = [&]() {
    wgmma_wait<0>();
    refill();
    prev = -1;
  };
  // the ring's next slab, once it has arrived
  auto next_stage = [&]() {
    const int st = n % S;
    mbar_wait(full + 8 * st, (n / S) & 1);
    __syncwarp();
    return ring + st * kStageBytes;
  };
  // the h tile is free: both consumers are done reading it, and so is the last TMA store
  // that read it
  auto h_tile_free = [&]() {
    if (t == 0) tma_store_wait_read();
    named_sync(1, 256);
  };
  // acc += (the h tile) . (this consumer's kSlabs2 slabs of the ring), B N-major (loop 1's
  // W2, 64-byte swizzle) or K-major (loop 2's W1, 32-byte swizzle)
  auto second_product = [&](bool k_major) {
    constexpr int P0 = Pieces<kAtoms>::first, P1 = Pieces<kAtoms>::second;
    for (int j = 0; j < kSlabs2; ++j, ++n) {
      const uint32_t b0 = next_stage();
      wgmma_fence();
      const int k = j * kSlab2;
      const uint64_t da = make_desc(hs + (k / 64) * kBox + (k % 64) * 2, 16, 1024, 1);
      if (k_major) {
        Wgmma<32 * P0, 0>::mma(acc2, da, make_desc(b0, 16, 256, 3), 1);
        if constexpr (P1 > 0)
          Wgmma<32 * P1, 0>::mma(acc2 + 16 * P0, da, make_desc(b0 + P0 * kAtomBox, 16, 256, 3),
                                 1);
      } else {
        Wgmma<32 * P0>::mma(acc2, da, make_desc(b0, kAtomBox, 512, 2), 1);
        if constexpr (P1 > 0)
          Wgmma<32 * P1>::mma(acc2 + 16 * P0, da, make_desc(b0 + P0 * kAtomBox, kAtomBox, 512, 2),
                              1);
      }
      wgmma_commit();
      committed(n);
    }
  };

  mbar_wait(x_full, 0);
  __syncwarp();
  const uint32_t hbox = hs + wg * kBox;

  // ---- loop 1: the forward recomputed; hd and mask1 kept
  for (int c = 0; c < p.nchunks; ++c) {
    for (int s = 0; s < nks; ++s, ++n) {
      const uint32_t b = next_stage();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<64>::mma(acc1, make_desc(xs + s * kBox + kk * 32, 16, 1024, 1),
                       make_desc(b + kk * 2048, 1024, 1024, 1), (s | kk) != 0);
      wgmma_commit();
      committed(n);
    }
    drain();
    h_tile_free();
    uint32_t bits = 0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = c * kChunk + 64 * wg + 8 * jj + 2 * q;
      float2 bb = make_float2(0.f, 0.f);
      if (col < p.f) bb = __ldg(reinterpret_cast<const float2*>(p.b1 + col));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float z0 = acc1[4 * jj + 2 * i] + bb.x, z1 = acc1[4 * jj + 2 * i + 1] + bb.y;
        bool k0 = true, k1 = true;
        if (p.on) {
          k0 = ffn::keep_bit(key1[i], col, p.threshold);
          k1 = ffn::keep_bit(key1[i], col + 1, p.threshold);
        }
        float v0 = fmaxf(z0, 0.f), v1 = fmaxf(z1, 0.f);
        if (p.on) {
          v0 = k0 ? v0 * p.inv_keep : 0.f;
          v1 = k1 ? v1 * p.inv_keep : 0.f;
        }
        bits |= (uint32_t)(k0 && z0 > 0.f) << (4 * jj + 2 * i);
        bits |= (uint32_t)(k1 && z1 > 0.f) << (4 * jj + 2 * i + 1);
        st_shared(hbox + sw128(rl + 8 * i, 8 * jj + 2 * q), pack_bf16(v0, v1));
      }
    }
    st_shared(masks + (c * kThreads + threadIdx.x) * 4, bits);
    fence_async_smem();
    named_sync(2, 256);  // the whole h tile is written
    if (t == 0 && c * kChunk + 64 * wg < p.f) tma_store(&p.tm_h, hbox, c * kChunk + 64 * wg, row0);
    second_product(false);
  }
  drain();

  // ---- epilogue: y = x + dropout2(acc + b2), rows' statistics, xhat (0 past h)
  const int c0 = wg * kW;
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
        v0 = ffn::keep_bit(key2[i], col, p.threshold) ? v0 * p.inv_keep : 0.f;
        v1 = ffn::keep_bit(key2[i], col + 1, p.threshold) ? v1 * p.inv_keep : 0.f;
      }
      if (in) {
        const float2 xv =
            unpack_bf16(ld_shared(xs + (col >> 6) * kBox + sw128(rl + 8 * i, col & 63)));
        v0 += xv.x;
        v1 += xv.y;
      } else {
        v0 = v1 = 0.f;
      }
      acc2[4 * jj + 2 * i] = v0;
      acc2[4 * jj + 2 * i + 1] = v1;
    }
  }
  // row sums of this thread's columns, over the row's four threads, then both consumers'
  // (plane `pl` of red, barrier id)
  auto row_total = [&](float (&v)[2], int pl, int id) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], 1);
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], 2);
      if (q == 0) red[(pl * 2 + wg) * kRows + rl + 8 * i] = v[i];
    }
    named_sync(id, 256);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rl + 8 * i;
      v[i] = red[(pl * 2) * kRows + r] + red[(pl * 2 + 1) * kRows + r];
    }
  };
  float mu[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 4 * kAtoms; ++jj)
      mu[i] += acc2[4 * jj + 2 * i] + acc2[4 * jj + 2 * i + 1];  // 0 past h
  row_total(mu, 0, 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) mu[i] /= p.h;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < 4 * kAtoms; ++jj) {
      const bool in = c0 + 8 * jj + 2 * q < p.h;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = in ? acc2[4 * jj + 2 * i + e] - mu[i] : 0.f;
        rstd[i] += d * d;
      }
    }
  row_total(rstd, 1, 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) rstd[i] = rsqrtf(rstd[i] / p.h + ffn::kLnEps);
#pragma unroll
  for (int jj = 0; jj < 4 * kAtoms; ++jj) {
    const bool in = c0 + 8 * jj + 2 * q < p.h;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = acc2[4 * jj + 2 * i + e];
        v = in ? (v - mu[i]) * rstd[i] : 0.f;
      }
  }

  // the cotangent pair of (row rl + 8 i, columns col, col + 1): 0 past m and h
  auto dout_at = [&](int i, int col, bool in) {
    const int row = row0 + rl + 8 * i;
    if (!in || row >= p.m) return make_float2(0.f, 0.f);
    return unpack_bf16(
        __ldg(reinterpret_cast<const unsigned int*>(p.dout + (size_t)row * p.h + col)));
  };
  // ---- the LayerNorm backward: the rows' means of do ls and do ls xhat, and the block's
  // column sums of do xhat and do (each warp's 16 rows, into cols)
  float m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < 4 * kAtoms; ++jj) {
    const int col = c0 + 8 * jj + 2 * q;
    const bool in = col < p.h;
    float2 g = make_float2(0.f, 0.f);
    if (in) g = __ldg(reinterpret_cast<const float2*>(p.ls + col));
    float2 dv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dv[i] = dout_at(i, col, in);
      const float d0 = dv[i].x * g.x, d1 = dv[i].y * g.y;
      m1[i] += d0;
      m1[i] += d1;
      m2[i] += d0 * acc2[4 * jj + 2 * i];
      m2[i] += d1 * acc2[4 * jj + 2 * i + 1];
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float sx = (e ? dv[0].y : dv[0].x) * acc2[4 * jj + e] +
                 (e ? dv[1].y : dv[1].x) * acc2[4 * jj + 2 + e];
      float sg = (e ? dv[0].y : dv[0].x) + (e ? dv[1].y : dv[1].x);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        sx += __shfl_xor_sync(0xffffffffu, sx, off);
        sg += __shfl_xor_sync(0xffffffffu, sg, off);
      }
      if (lane < 4) {
        float* wcols = cols + (wg * 4 + warp) * 2 * kW;
        wcols[8 * jj + 2 * q + e] = sx;
        wcols[kW + 8 * jj + 2 * q + e] = sg;
      }
    }
  }
  row_total(m1, 2, 5);
  row_total(m2, 3, 6);  // its barrier also orders the column sums before their reads
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m1[i] /= p.h;
    m2[i] /= p.h;
  }
  for (int idx = t; idx < 2 * kW; idx += 128) {
    const int plane = idx / kW, cl = idx % kW, col = c0 + cl;
    if (col >= p.h) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) s += cols[((wg * 4 + w) * 2 + plane) * kW + cl];
    p.ln_part[((size_t)blockIdx.x * 2 + plane) * p.h + col] = s;
  }

  // dy into the accumulators, df = rnd(dropout2(dy)) over x's tile
#pragma unroll
  for (int jj = 0; jj < 4 * kAtoms; ++jj) {
    const int col = c0 + 8 * jj + 2 * q;
    const bool in = col < p.h;
    float2 g = make_float2(0.f, 0.f);
    if (in) g = __ldg(reinterpret_cast<const float2*>(p.ls + col));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 dv = dout_at(i, col, in);
      float& y0 = acc2[4 * jj + 2 * i];
      float& y1 = acc2[4 * jj + 2 * i + 1];
      y0 = in ? rstd[i] * (dv.x * g.x - m1[i] - y0 * m2[i]) : 0.f;
      y1 = in ? rstd[i] * (dv.y * g.y - m1[i] - y1 * m2[i]) : 0.f;
      float f0 = y0, f1 = y1;
      if (p.on) {
        f0 = ffn::keep_bit(key2[i], col, p.threshold) ? y0 * p.inv_keep : 0.f;
        f1 = ffn::keep_bit(key2[i], col + 1, p.threshold) ? y1 * p.inv_keep : 0.f;
      }
      if (in) st_shared(xs + (col >> 6) * kBox + sw128(rl + 8 * i, col & 63), pack_bf16(f0, f1));
    }
  }
  fence_async_smem();
  named_sync(7, 256);  // df's tile is whole
  if (t == 0) {
    if (wg == 0 && p.nfx > 0) tma_store3(&p.tm_df3, xs, row0);
    if (wg == 1 && p.nfx < p.nxb) tma_store(&p.tm_df, xs + p.nfx * kBox, 64 * p.nfx, row0);
  }

  // ---- loop 2: g_c = df . W2_c^T, dz_c = mask1 g_c, acc += dz_c . W1_c^T
  for (int c = 0; c < p.nchunks; ++c) {
    for (int s = 0; s < nks; ++s, ++n) {
      const uint32_t b = next_stage();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<64, 0>::mma(acc1, make_desc(xs + s * kBox + kk * 32, 16, 1024, 1),
                          make_desc(b + kk * 32, 16, 1024, 1), (s | kk) != 0);
      wgmma_commit();
      committed(n);
    }
    drain();
    h_tile_free();
    const uint32_t bits = ld_shared(masks + (c * kThreads + threadIdx.x) * 4);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v0 = acc1[4 * jj + 2 * i], v1 = acc1[4 * jj + 2 * i + 1];
        if (p.on) {
          v0 *= p.inv_keep;
          v1 *= p.inv_keep;
        }
        v0 = (bits >> (4 * jj + 2 * i)) & 1u ? v0 : 0.f;
        v1 = (bits >> (4 * jj + 2 * i + 1)) & 1u ? v1 : 0.f;
        st_shared(hbox + sw128(rl + 8 * i, 8 * jj + 2 * q), pack_bf16(v0, v1));
      }
    fence_async_smem();
    named_sync(2, 256);  // the whole dz tile is written
    if (t == 0 && c * kChunk + 64 * wg < p.f) tma_store(&p.tm_dz, hbox, c * kChunk + 64 * wg, row0);
    second_product(true);
  }
  drain();

  // ---- dx = rnd(acc) over df's tile, once both consumers and the df store are done with it
  h_tile_free();
#pragma unroll
  for (int jj = 0; jj < 4 * kAtoms; ++jj) {
    const int col = c0 + 8 * jj + 2 * q;
    if (col >= p.h) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      st_shared(xs + (col >> 6) * kBox + sw128(rl + 8 * i, col & 63),
                pack_bf16(acc2[4 * jj + 2 * i], acc2[4 * jj + 2 * i + 1]));
  }
  fence_async_smem();
  named_sync(8, 256);  // dx's tile is whole
  if (t == 0) {
    if (wg == 0 && p.nfx > 0) tma_store3(&p.tm_dx3, xs, row0);
    if (wg == 1 && p.nfx < p.nxb) tma_store(&p.tm_dx, xs + p.nfx * kBox, 64 * p.nfx, row0);
    tma_store_wait_read();  // the block may end once the stores have read its shared memory
  }
}

// The dynamic shared memory B6b's bf16 row body takes at (h, f), or 0 where it does not take
// them (h past kMaxH, F past 20 chunks).
inline int bwd_smem_bytes(int h, int f) {
  if (h <= 0 || f <= 0 || h > kMaxH) return 0;
  const int nxb = (h + 63) / 64, nchunks = (f + kChunk - 1) / kChunk;
  if (nchunks * kThreads * 4 > kBwdMaskMax) return 0;
  int total;
  switch (atoms_for(h)) {
    case 1: total = bwd_smem_layout<1>(nxb, nchunks).total; break;
    case 4: total = bwd_smem_layout<4>(nxb, nchunks).total; break;
    case 6: total = bwd_smem_layout<6>(nxb, nchunks).total; break;
    case 9: total = bwd_smem_layout<9>(nxb, nchunks).total; break;
    default: total = bwd_smem_layout<10>(nxb, nchunks).total;
  }
  return total <= kSmemMax ? total : 0;
}

template <int kAtoms>
cudaError_t launch_bwd_atoms(BwdParams& p, cudaStream_t stream) {
  const BwdSmem L = bwd_smem_layout<kAtoms>(p.nxb, p.nchunks);
  auto kernel = ffn_bwd_wgmma_kernel<kAtoms>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((p.m + kRows - 1) / kRows);
  kernel<<<blocks, kThreads, L.total, stream>>>(p);
  return cudaGetLastError();
}

// B6b's row work over all rows: x, dout [m, h], w1 [h, f], w2 [f, h] in bf16; hd, dz [m, f],
// df, dx [m, h] bf16 outputs; ln_part [ceil(m / 64), 2, h] fp32; b1, b2, ls fp32. All
// 16-byte aligned, h and f multiples of 8, bwd_smem_bytes(h, f) > 0.
inline cudaError_t launch_bwd(const void* x, const void* w1, const float* b1, const void* w2,
                              const float* b2, const float* ls, const void* dout, void* hd,
                              void* dz, void* df, void* dx, float* ln_part, int m, int h, int f,
                              int on, uint32_t seed1, uint32_t seed2, uint32_t threshold,
                              float inv_keep, cudaStream_t stream) {
  if (m <= 0 || h % 8 || f % 8 || bwd_smem_bytes(h, f) == 0) return cudaErrorInvalidValue;
  BwdParams p = {};
  const int atoms = atoms_for(h);
  p.nfx = h / 64;
  p.nfw = h / 32;
  bool ok =
      make_map(&p.tm_x, x, m, h, kRows, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&p.tm_w1, w1, h, f, kSlab1, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&p.tm_w2, w2, f, h, kSlab2, 32, CU_TENSOR_MAP_SWIZZLE_64B) &&
      make_map(&p.tm_w2k, w2, f, h, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&p.tm_w1k, w1, h, f, 32, kSlab2, CU_TENSOR_MAP_SWIZZLE_32B) &&
      make_map(&p.tm_h, hd, m, f, kRows, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&p.tm_dz, dz, m, f, kRows, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&p.tm_df, df, m, h, kRows, 64, CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&p.tm_dx, dx, m, h, kRows, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (ok && p.nfx > 0)
    ok = make_map3(&p.tm_x3, x, m, h, 64, p.nfx, kRows, p.nfx, CU_TENSOR_MAP_SWIZZLE_128B) &&
         make_map3(&p.tm_df3, df, m, h, 64, p.nfx, kRows, p.nfx, CU_TENSOR_MAP_SWIZZLE_128B) &&
         make_map3(&p.tm_dx3, dx, m, h, 64, p.nfx, kRows, p.nfx, CU_TENSOR_MAP_SWIZZLE_128B);
  if (ok && p.nfw >= atoms) {
    // W1's rows as (16 columns, 32 rows, blocks of 32 rows): kAtoms row blocks in one box
    const cuuint64_t dims[3] = {(cuuint64_t)f, 32, (cuuint64_t)p.nfw};
    const cuuint64_t strides[2] = {(cuuint64_t)f * 2, (cuuint64_t)f * 2 * 32};
    const cuuint32_t box[3] = {(cuuint32_t)kSlab2, 32, (cuuint32_t)atoms};
    ok = make_map3(&p.tm_w23, w2, f, h, 32, p.nfw, kSlab2, atoms, CU_TENSOR_MAP_SWIZZLE_64B) &&
         make_map_nd(&p.tm_w1k3, w1, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B);
  }
  if (!ok) return cudaErrorInvalidValue;
  p.b1 = b1;
  p.b2 = b2;
  p.ls = ls;
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.ln_part = ln_part;
  p.m = m;
  p.h = h;
  p.f = f;
  p.nxb = (h + 63) / 64;
  p.nchunks = (f + kChunk - 1) / kChunk;
  p.on = on;
  p.seed1 = seed1;
  p.seed2 = seed2;
  p.threshold = threshold;
  p.inv_keep = inv_keep;
  switch (atoms) {
    case 1: return launch_bwd_atoms<1>(p, stream);
    case 4: return launch_bwd_atoms<4>(p, stream);
    case 6: return launch_bwd_atoms<6>(p, stream);
    case 9: return launch_bwd_atoms<9>(p, stream);
    default: return launch_bwd_atoms<10>(p, stream);
  }
}

}  // namespace

}  // namespace ffn_hopper
