// Hopper (sm_90a) building blocks shared by the port's wgmma/TMA bodies: the bf16 FFN body
// (ffn_hopper.cuh: kernels B7, B6f and B6b's row work), the bf16 fused QKV attention body
// (attention_hopper.cuh: kernels B1 and B5's first phase), the bf16 attention backward
// (attention_bwd_hopper.cuh: kernels B2 and B3b), the bf16 grouped matmul
// (gmm_hopper.cuh: kernels B4 and B4t) and the head-layout probes (headpack_hopper.cuh:
// P1 and P2).
//   device: mbarriers, TMA loads (tensor and bulk) and stores, cp.async, the async-proxy
//           fences, named barriers, setmaxnreg, wgmma's fence / commit / wait,
//           shared-memory matrix descriptors, wgmma at the widths the bodies use (both
//           operands from shared memory, or A from registers), the 128- and 32-byte
//           swizzles' address functions and bf16 packing
//   host:   cuTensorMapEncodeTiled, found at run time, and the tensor maps built with it

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kSmemMax = 232448;  // a block's shared memory on the H100

// ---- PTX building blocks

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` to complete. A wait of more than 10 s can only be
// a broken pipeline: it traps, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  for (uint32_t spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && (spin & 1023) == 1023) {
      const uint64_t now = global_ns();
      if (start == 0) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  }
}

// TMA: a 2-D box at (c0 = inner, c1 = outer), or a 3-D box at (c0, c1, c2), into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* tm, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load3d(uint32_t dst, const CUtensorMap* tm, uint32_t bar,
                                           int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// TMA's bulk copy (no tensor map): `bytes` (a multiple of 16) from 16-byte aligned device
// memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* tm, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(tm)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the same into a 3-D map at (c0, c1, c2)
__device__ __forceinline__ void tma_store3d(const CUtensorMap* tm, uint32_t src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(tm)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// the box at (0, c1, 0) of a 3-D map
__device__ __forceinline__ void tma_store3(const CUtensorMap* tm, uint32_t src, int c1) {
  tma_store3d(tm, src, 0, c1, 0);
}

__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// cp.async (the generic proxy's asynchronous copy): 8 bytes from 8-byte aligned device
// memory into shared memory, or 8 zero bytes where `live` is false (src is not read then)
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst), "l"(src),
               "r"(live ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// make this thread's generic-proxy shared-memory writes visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// make this thread's generic-proxy writes, device memory included, visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// a warpgroup's register budget a thread, lowered for a producer and raised for consumers
// (every warp of the warpgroup executes it)
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pin n accumulator registers at this point of the program: after a wgmma wait, so that
// no read of them moves above it; before a wgmma, so that no write moves below.
template <int n>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride byte offsets
// (16-byte units), swizzle (1: 128-byte, 2: 64-byte). For a K-major operand the stride
// offset steps over 8-row groups; for an N-major one the leading offset steps over
// swizzle atoms along N and the stride offset over 8-row groups along K.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
}

#define WM_ACC4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WM_ACC8(d, i) WM_ACC4(d, i), WM_ACC4(d, i + 4)

// D[64 x N] (+)= A[64 x 16] . B[16 x N], bf16 in, fp32 accumulators, both operands from
// shared memory: A K-major with kTransA = 0 or M-major with kTransA = 1 (A's transpose bit,
// taken at N = 64), B N-major with kTransB = 1 (the transpose bit) or K-major with
// kTransB = 0; scale_d = 0 overwrites D.
template <int N, int kTransB = 1, int kTransA = 0>
struct Wgmma;

// The same with A from registers: four .b32 of bf16 pairs per thread, in the layout of an
// fp32 accumulator's 16 columns (rows 16 w + lane / 4 and + 8, columns 2 (lane % 4) and
// + 8), so an accumulator packs into an A operand without moving between threads.
template <int N, int kTransB>
struct WgmmaRs;

template <int kTransB>
struct Wgmma<32, kTransB> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : WM_ACC8(d, 0), WM_ACC8(d, 8)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct Wgmma<48, kTransB> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23 "
      "}, %24, %25, p, 1, 1, 0, %27;\n}\n"
      : WM_ACC8(d, 0), WM_ACC8(d, 8), WM_ACC8(d, 16)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB, int kTransA>
struct Wgmma<64, kTransB, kTransA> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, %36, %35;\n}\n"
      : WM_ACC8(d, 0), WM_ACC8(d, 8), WM_ACC8(d, 16), WM_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB), "n"(kTransA));
  }
};

template <int kTransB>
struct Wgmma<72, kTransB> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35 "
      "}, %36, %37, p, 1, 1, 0, %39;\n}\n"
      : WM_ACC8(d, 0), WM_ACC8(d, 8), WM_ACC8(d, 16), WM_ACC8(d, 24), WM_ACC4(d, 32)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct Wgmma<96, kTransB> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47 "
      "}, %48, %49, p, 1, 1, 0, %51;\n}\n"
      : WM_ACC8(d, 0), WM_ACC8(d, 8), WM_ACC8(d, 16), WM_ACC8(d, 24), WM_ACC8(d, 32),
        WM_ACC8(d, 40)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct Wgmma<120, kTransB> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59 "
      "}, %60, %61, p, 1, 1, 0, %63;\n}\n"
      : WM_ACC8(d, 0), WM_ACC8(d, 8), WM_ACC8(d, 16), WM_ACC8(d, 24), WM_ACC8(d, 32),
        WM_ACC8(d, 40), WM_ACC8(d, 48), WM_ACC4(d, 56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct Wgmma<128, kTransB> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : WM_ACC8(d, 0), WM_ACC8(d, 8), WM_ACC8(d, 16), WM_ACC8(d, 24), WM_ACC8(d, 32),
        WM_ACC8(d, 40), WM_ACC8(d, 48), WM_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct Wgmma<160, kTransB> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79 "
      "}, %80, %81, p, 1, 1, 0, %83;\n}\n"
      : WM_ACC8(d, 0), WM_ACC8(d, 8), WM_ACC8(d, 16), WM_ACC8(d, 24), WM_ACC8(d, 32),
        WM_ACC8(d, 40), WM_ACC8(d, 48), WM_ACC8(d, 56), WM_ACC8(d, 64), WM_ACC8(d, 72)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

// A M-major (kTransA = 1) or K-major, at the grouped matmul's tile width
template <int kTransB, int kTransA>
struct Wgmma<192, kTransB, kTransA> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95 "
      "}, %96, %97, p, 1, 1, %100, %99;\n}\n"
      : WM_ACC8(d, 0), WM_ACC8(d, 8), WM_ACC8(d, 16), WM_ACC8(d, 24), WM_ACC8(d, 32),
        WM_ACC8(d, 40), WM_ACC8(d, 48), WM_ACC8(d, 56), WM_ACC8(d, 64), WM_ACC8(d, 72),
        WM_ACC8(d, 80), WM_ACC8(d, 88)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB), "n"(kTransA));
  }
};

template <int kTransB>
struct WgmmaRs<16, kTransB> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db,
                                             int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : WM_ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct WgmmaRs<24, kTransB> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db,
                                             int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11 "
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, %18;\n}\n"
      : WM_ACC8(d, 0), WM_ACC4(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct WgmmaRs<32, kTransB> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db,
                                             int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : WM_ACC8(d, 0), WM_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct WgmmaRs<40, kTransB> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db,
                                             int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19 "
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, %26;\n}\n"
      : WM_ACC8(d, 0), WM_ACC8(d, 8), WM_ACC4(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct WgmmaRs<64, kTransB> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db,
                                             int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WM_ACC8(d, 0), WM_ACC8(d, 8), WM_ACC8(d, 16), WM_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct WgmmaRs<112, kTransB> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db,
                                             int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55 "
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, %62;\n}\n"
      : WM_ACC8(d, 0), WM_ACC8(d, 8), WM_ACC8(d, 16), WM_ACC8(d, 24), WM_ACC8(d, 32),
        WM_ACC8(d, 40), WM_ACC8(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(kTransB));
  }
};

#undef WM_ACC8
#undef WM_ACC4


// byte offset of bf16 element (r, c) in a [64 x 64] box with the 128-byte swizzle
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// byte offset of bf16 element (r, c) in a [rows x 16] box with the 32-byte swizzle
__device__ __forceinline__ uint32_t sw32(int r, int c) {
  return r * 32 + ((((c >> 3) ^ (r >> 2)) & 1) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&v);
  return __bfloat1622float2(b);
}

__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.b16 [%0], %1;" ::"r"(addr), "h"(v) : "memory");
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  const __nv_bfloat16 b = __float2bfloat16(v);
  return *reinterpret_cast<const uint16_t*>(&b);
}

// ---- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found at run time (the library links only the
// CUDA runtime)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                         cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A bf16 tensor of `rank` dimensions (dims innermost first, strides in bytes of the outer
// ones) read or written in boxes of `box`.
inline bool make_map_nd(CUtensorMap* tm, const void* ptr, int rank, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box,
                        CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return encode(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major bf16 matrix [rows, cols] read or written in boxes [box_rows, box_cols], its
// rows `ld` elements apart (cols where ld is 0).
inline bool make_map(CUtensorMap* tm, const void* ptr, int rows, int cols, int box_rows,
                     int box_cols, CUtensorMapSwizzle swizzle, int ld = 0) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld ? ld : cols) * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  return make_map_nd(tm, ptr, 2, dims, strides, box, swizzle);
}

// The same matrix as (width, rows, blocks): `blocks` blocks of `width` columns, boxes of
// [box_rows x width] x box_blocks, laid out block after block in shared memory.
inline bool make_map3(CUtensorMap* tm, const void* ptr, int rows, int cols, int width,
                      int blocks, int box_rows, int box_blocks, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)blocks};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)width * 2};
  const cuuint32_t box[3] = {(cuuint32_t)width, (cuuint32_t)box_rows, (cuuint32_t)box_blocks};
  return make_map_nd(tm, ptr, 3, dims, strides, box, swizzle);
}

}  // namespace hopper
