// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (lowrank_lse.cu, logmmexp.cu): TF32 rounding, wgmma on K-major unswizzled
// operands in shared memory, mbarriers and TMA bulk copies.  Everything is
// inline, so a kernel compiles as if these were written in its own source.
//
// Shared-memory layout of a tf32 operand for wgmma, K-major without swizzle:
// "core matrices" of 8 rows x 4 k (128 contiguous bytes, a row every 16
// bytes), the k blocks of one 8-row group next to each other (leading byte
// offset 128) and the 8-row groups one after the other (stride byte offset
// 128 * kb, kb = the k blocks of 4 that a row group holds).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

__host__ __device__ __forceinline__ size_t cdiv(size_t a, size_t b) { return (a + b - 1) / b; }

__device__ __forceinline__ float finite_or_zero(float m) {
  return isfinite(m) ? m : 0.f;
}

// x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero; the
// low 13 bits of the result are 0.
__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// wgmma shared-memory descriptor of a K-major, unswizzled operand at p whose
// row groups hold kb k blocks of 4
__device__ __forceinline__ uint64_t wgmma_desc(const float* p, int kb) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((128 * kb) >> 4) << 32);
}

// d (+)= A . B^T for a 64 x 8 A and a 64 x 8 B (both K-major, tf32), the
// warpgroup's 64 x 64 f32 tile in d; scale_d 0 starts the sum afresh.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The same for a 64 x 128 tile (B 128 x 8).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Keeps the compiler from moving reads or writes of r across the
// asynchronous products that use it.
template <int N>
__device__ __forceinline__ void fence_operand(float (&r)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) asm volatile("" : "+f"(r[k])::"memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"((unsigned)__cvta_generic_to_shared(bar)), "r"(parity)
        : "memory");
}

// One of the barrier's expected arrivals.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar))
               : "memory");
}

// One thread: the barrier's next phase completes when bytes have arrived
// by the bulk copies that follow.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar)),
               "r"(bytes)
               : "memory");
}

// One thread: bytes (a multiple of 16) from src to dst (both 16-byte
// aligned) by TMA, counted on bar.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"((unsigned)__cvta_generic_to_shared(dst)),
      "l"(src), "r"(bytes), "r"((unsigned)__cvta_generic_to_shared(bar))
      : "memory");
}

}  // namespace
