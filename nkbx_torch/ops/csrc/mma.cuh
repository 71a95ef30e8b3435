// The primitives of the mma.sync kernels (grouped_conv.cu, attention.cu,
// attention_bwd.cu): 16-byte cp.async copies into shared memory with their
// commit groups, ldmatrix, the special-function unit's 2^x, and the
// warp-level m16n8k16 product of bf16 operands into float
// accumulators. Fragment layouts are PTX's: A (16 x 16) in four registers,
// a0 = row lane/4, k 2(lane%4) + {0, 1}; a1 the row + 8; a2, a3 k + 8. B
// (16 x 8) in two, b0 = k 2(lane%4) + {0, 1}, column lane/4; b1 k + 8. C
// (16 x 8) c0, c1 = row lane/4, columns 2(lane%4) + {0, 1}; c2, c3 the row + 8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nkbx {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices, row addresses from lanes 0-7, 8-15, 16-23, 24-31.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b. Not volatile: a product on registers the compiler may schedule.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 (to nearest even) in one register, lo first.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

}  // namespace nkbx
