// The primitives of the mma.sync kernels (grouped_conv.cu, attention.cu,
// attention_bwd.cu, window_attention.cu, window_attention_bwd.cu): 16-byte
// cp.async copies into shared memory with their commit groups, a padded head
// slice copied by rows, ldmatrix, the special-function unit's 2^x, the
// warp-level m16n8k16 product of bf16 operands into float accumulators, quad
// reductions, and the window and backward kernels' products of a warp's 16
// rows with the rows of a shared bf16 tile of row stride LD. Fragment layouts
// are PTX's: A (16 x 16) in four registers, a0 = row lane/4, k 2(lane%4) +
// {0, 1}; a1 the row + 8; a2, a3 k + 8. B (16 x 8) in two, b0 = k 2(lane%4) +
// {0, 1}, column lane/4; b1 k + 8. C (16 x 8) c0, c1 = row lane/4, columns
// 2(lane%4) + {0, 1}; c2, c3 the row + 8.
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

// Rows 0 .. ROWS-1 of an (n, D) bf16 slice (src at its first element, row
// stride ld) into a shared tile of row stride LD by 16-byte cp.async, spread
// over the block's THREADS threads; rows at or past n are zero-filled.
template <int ROWS, int D, int LD, int THREADS>
__device__ __forceinline__ void copy_rows(unsigned dst, const __nv_bfloat16* __restrict__ src,
                                          int ld, int n) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, ch = i % kChunks;
    const bool in = r < n;
    cp_async16(dst + (r * LD + ch * 8) * 2, src + static_cast<size_t>(in ? r : 0) * ld + ch * 8,
               in ? 16 : 0);
  }
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

// The lanes of a quad (the four that share a fragment row) combined.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The A fragments of a warp's 16 rows r0 .. r0 + 15 of a tile, over all its
// D = 16 * KC columns.
template <int LD, int KC>
__device__ __forceinline__ void load_a(unsigned (&a)[KC][4], unsigned tile, int r0) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
  const int r = r0 + (mi % 2) * 8 + lane % 8;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) ldmatrix_x4(a[kc], tile + (r * LD + kc * 16 + (mi / 2) * 8) * 2);
}

// c = a (16 x D) times (rows r0 .. r0 + 15 of a tile)^T: the products of a
// warp's 16 rows with 16 rows of a shared tile. c[nt] holds rows lane/4
// (elements 0, 1) and lane/4 + 8 (2, 3) at the tile rows r0 + nt*8 +
// 2 (lane % 4) + {0, 1}.
template <int LD, int KC>
__device__ __forceinline__ void dot_rows(float (&c)[2][4], const unsigned (&a)[KC][4],
                                         unsigned tile, int r0) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
  const int row = r0 + (mi / 2) * 8 + lane % 8;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    // matrices: rows +0..7 / d +0..7, rows +0..7 / d +8..15, rows +8..15 / ...
    unsigned b[4];
    ldmatrix_x4(b, tile + (row * LD + kc * 16 + (mi % 2) * 8) * 2);
    mma_bf16(c[0], a[kc], b[0], b[1]);
    mma_bf16(c[1], a[kc], b[2], b[3]);
  }
}

// acc += a (16 x 16, k = the tile rows r0 .. r0 + 15) times those rows of a
// tile over all its D = 8 * NT columns (ldmatrix.trans).
template <int LD, int NT>
__device__ __forceinline__ void acc_rows(float (&acc)[NT][4], const unsigned (&a)[4],
                                         unsigned tile, int r0) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
  const int row = r0 + (mi % 2) * 8 + lane % 8;
#pragma unroll
  for (int dp = 0; dp < NT / 2; ++dp) {
    // matrices: rows +0..7 / d +0..7, rows +8..15 / d +0..7, rows +0..7 / d +8..15, ...
    unsigned b[4];
    ldmatrix_x4_trans(b, tile + (row * LD + dp * 16 + (mi / 2) * 8) * 2);
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// Store a warp's 16 x (8 * NT) float accumulator as bf16 rows row0 + lane/4
// (+ 8) of dst (row stride ld), rows at or past n skipped.
template <int NT>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst,
                                           const float (&acc)[NT][4], int row0, int n, int ld) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int i = row0 + lane / 4 + hi * 8;
    if (i >= n) continue;
    __nv_bfloat16* p = dst + static_cast<size_t>(i) * ld + (lane % 4) * 2;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<unsigned*>(p + nt * 8) = pack_bf16(acc[nt][2 * hi], acc[nt][2 * hi + 1]);
  }
}

}  // namespace nkbx
