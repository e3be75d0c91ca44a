// Hopper (sm_90a) primitives shared by the tensor-core kernels: K1-K4's
// MFCC tile (mfcc_tc.cuh) and K7 (forward_probs.cu).
//
// - shared-memory addresses and wgmma's shared-memory descriptors;
// - mbarriers, with a wait that traps instead of hanging the card;
// - bulk asynchronous copies from device memory (cp.async.bulk), multicast
//   to every CTA of a cluster when the cluster has more than one;
// - the cluster's rank and barrier;
// - the wgmma fences, groups and the shapes the kernels issue (bf16
//   operands, f32 accumulators), A from shared memory (_ss) or from
//   registers (_rs);
// - packing floats into bf16 pairs, rounded to nearest even.
//
// Fragments: in a [64, N] accumulator of a warpgroup, thread (warp, g =
// lane / 4, q = lane % 4) holds rows 16 warp + g and + 8 at columns 8 j + 2 q
// and + 1: element 4 j + e is row + 8 (e / 2), column + e % 2.  An A operand
// from registers is each warp's m16n8k16 A fragment of its 16 rows: four
// registers of two bf16, (row g, k 2q), (row g + 8, k 2q), (row g, k 2q + 8),
// (row g + 8, k 2q + 8), each with k + 1 in the high half.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace streamz_hopper {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor of a [rows, 16] K-major bf16 block in the
// 32-byte swizzle (layout type 3): rows of 32 bytes, 8-row groups 256
// bytes apart (the stride byte offset), the leading byte offset unused.
// Row n's two 16-byte halves are swapped when n / 4 is odd.
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}

// The same for a block without swizzle (layout type 0): 8-row core
// matrices of 16-byte rows, contiguous, 128 bytes apart along M (the stride
// byte offset); the two 8-k halves `lbo` bytes apart (the leading byte
// offset).  Any 16-byte aligned start, so a start one row on reads rows 1..
__device__ __forceinline__ uint64_t make_desc_plain(const void* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(128 >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// Wait for the phase of `parity` to complete.  A wait of more than about
// ten seconds traps, so a fault in a ring ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, uint32_t parity) {
  long long start = 0;
  for (uint32_t i = 1;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if ((i & 1023) == 0) {
      if (start == 0) {
        start = clock64();
      } else if (clock64() - start > 20000000000LL) {
        __trap();
      }
    }
  }
}

// Arrive on the barrier at the same offset in CTA `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(unsigned long long* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_addr(bar)),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Copy `bytes` from device memory to the same offset `dst` in every CTA of
// a cluster of `Cluster` CTAs, completing on each one's barrier `bar`.
template <int Cluster>
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          unsigned long long* bar) {
  if constexpr (Cluster == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  } else {
    const uint16_t mask = (1u << Cluster) - 1;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1], %2, [%3], %4;\n"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
        : "memory");
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's shared-memory operands, bulk copies).
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across a
// wgmma issue or wait: the tensor cores write these registers asynchronously.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64, 128] (+)= A[64, 16] B[16, 128]: A and B from shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64, 128] (+)= A[64, 16] B[16, 128]: A from registers (each warp's A
// fragment of its 16 rows), B from shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64, 32] (+)= A[64, 16] B[16, 32]: A from registers, B from shared memory.
__device__ __forceinline__ void wgmma_m64n32k16_rs(float* d, const uint32_t* a,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// (a, b) in bf16, rounded to nearest even, two to a register (a in the low
// half).
__device__ __forceinline__ uint32_t pack_bf16_rn(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// bf16 hi and lo of (a, b), packed two to a register (a in the low half),
// both rounded to nearest even: the split of bf16_split.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  *lo = *reinterpret_cast<const uint32_t*>(&l);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace streamz_hopper
