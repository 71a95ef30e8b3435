// What the full-sequence attention kernels (attention.cu, attention_bwd.cu)
// share: the head width, the tile loader, and warp-level 16x16 tile
// products, in which one warp accumulates C (16 x 16, float) += A (16 x K) *
// B (K x 16) from operands in shared memory.
//
// bf16 storage runs on the tensor cores (WMMA 16x16x16, float accumulators);
// float storage runs the same product with float FMAs on the CUDA cores, so
// one kernel body serves both types with the same rounding points. Either
// operand may be row- or column-major: element (r, c) of a matrix with
// leading dimension ld sits at r*ld + c (RowMajor) or c*ld + r (ColMajor).
//
// WMMA needs 32-byte aligned tile pointers and a leading dimension that is a
// multiple of 8 elements (bf16) or 4 (the float store); the callers keep
// every tile at a multiple of 16 rows and columns of 128-byte aligned buffers.
#pragma once

#include <mma.h>

#include <type_traits>

#include "dtype.cuh"

namespace nkbx {

struct RowMajor {};
struct ColMajor {};

template <typename L>
__device__ __forceinline__ int tile_offset(int row, int col, int ld) {
  if constexpr (std::is_same<L, RowMajor>::value) return row * ld + col;
  return col * ld + row;
}

template <typename L> struct WmmaLayout { using type = nvcuda::wmma::row_major; };
template <> struct WmmaLayout<ColMajor> { using type = nvcuda::wmma::col_major; };

template <typename T> struct WarpTile;

// Float FMAs: lane l owns row l / 2 and the 8 columns starting at (l % 2) * 8.
template <> struct WarpTile<float> {
  float acc[8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < 8; ++t) acc[t] = 0.f;
  }

  template <typename LA, typename LB>
  __device__ __forceinline__ void mma(const float* a, int lda, const float* b, int ldb, int k) {
    const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
    for (int kk = 0; kk < k; ++kk) {
      const float av = a[tile_offset<LA>(r, kk, lda)];
#pragma unroll
      for (int t = 0; t < 8; ++t) acc[t] = fmaf(av, b[tile_offset<LB>(kk, c0 + t, ldb)], acc[t]);
    }
  }

  __device__ __forceinline__ void store(float* c, int ldc) const {
    const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int t = 0; t < 8; ++t) c[r * ldc + c0 + t] = acc[t];
  }
};

// bf16 tensor cores: k must be a multiple of 16.
template <> struct WarpTile<__nv_bfloat16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc;

  __device__ __forceinline__ void zero() { nvcuda::wmma::fill_fragment(acc, 0.f); }

  template <typename LA, typename LB>
  __device__ __forceinline__ void mma(const __nv_bfloat16* a, int lda, const __nv_bfloat16* b,
                                      int ldb, int k) {
    using namespace nvcuda;
    for (int kk = 0; kk < k; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, typename WmmaLayout<LA>::type> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, typename WmmaLayout<LB>::type> fb;
      wmma::load_matrix_sync(fa, a + tile_offset<LA>(0, kk, lda), lda);
      wmma::load_matrix_sync(fb, b + tile_offset<LB>(kk, 0, ldb), ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
  }

  __device__ __forceinline__ void store(float* c, int ldc) const {
    nvcuda::wmma::store_matrix_sync(c, acc, ldc, nvcuda::wmma::mem_row_major);
  }
};

constexpr int kHeadDim = 64;          // D: every ViT of the zoo
constexpr int kLdTile = kHeadDim + 8;  // row stride of q/k/v/go tiles (elements)
constexpr int kKeyTile = 64;           // keys per streamed tile
constexpr int kAttnThreads = 128;      // 4 warps
constexpr int kAttnWarps = kAttnThreads / 32;

// The key count rounded up to whole key tiles.
__host__ __device__ __forceinline__ int padded_keys(int n) {
  return (n + kKeyTile - 1) / kKeyTile * kKeyTile;
}

__host__ __device__ __forceinline__ size_t align128(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

// Rows row0 .. row0+rows-1 of one head's (n, kHeadDim) slice of a (G, N,
// H*D) tensor (src points at the head's first element, stride = H*D) into a
// shared tile with row stride kLdTile; rows past n become zeros. 16-byte
// loads: a head's row is 128 (bf16) or 256 (float) contiguous bytes.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, size_t stride,
                                          int row0, int rows, int n) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPer = kHeadDim / kVec;
  for (int idx = threadIdx.x; idx < rows * kPer; idx += kAttnThreads) {
    const int r = idx / kPer, v = idx - r * kPer;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * stride +
                                            v * kVec);
    }
    *reinterpret_cast<uint4*>(dst + r * kLdTile + v * kVec) = val;
  }
}

}  // namespace nkbx
