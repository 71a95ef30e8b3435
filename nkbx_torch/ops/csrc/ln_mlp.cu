// Fused LayerNorm -> Dense -> exact GELU -> Dense -> layer-scale -> residual,
// forward only: the transformer-block MLP half.
//
// Replaces the Pallas kernel nkbx/ops/mlp.py:504 `_lnmlp_fwd_kernel` (entry
// `fused_ln_mlp`). For each row of x (R, C):
//   h   = LayerNorm(x) in float (flax fast variance E[x^2] - mu^2, clamped
//         at 0), rounded to the storage type T
//   g   = gelu(h @ w0 + b0) with float accumulation and the exact (erf) GELU
//         in float, rounded to T
//   y   = g @ w1 + b1 with float accumulation, rounded to T
//   out = sc + y * gamma, in T (mlp.py:515-517)
// The (R, F) hidden activations never reach device memory: F is walked in
// chunks of kChunk, and each chunk's g lives in shared memory only.
//
// What bounds it on an H100: at Swin-T stage 1 (C=96, F=384) the function
// moves x, sc and out (6*C bytes a row in bf16) for 4*C*F operations, about
// 256 operations per byte, close to the bf16 ridge of ~295; at the wider
// stages (F = 4C) the operations per byte grow with C and the tensor cores
// are the roof. So the products must run on the tensor cores, and the
// design keeps device traffic to one pass: a block holds its rows' LN output,
// one GELU chunk and the float accumulators in shared memory, and streams
// the weights from L2 (every block reads the same w0 and w1).
//
// Two kernels:
// - ln_mlp_tc_kernel, bf16 with C % 32 == 0 and F % 64 == 0 (every Swin
//   width): warp-level bf16 tensor-core products (WMMA 16x16x16, float
//   accumulators). 8 warps; a block owns TR = 16*NRT rows. A (h or g) is
//   read from shared memory; the weights come through shared memory in
//   32-row slabs, two in flight (cp.async, double-buffered), so the
//   products do not wait on L2. Not yet Hopper's wgmma/TMA.
// - ln_mlp_fma_kernel, float (and bf16 at other widths): the same steps with
//   float FMAs on the CUDA cores; 256 threads in a 16 x 16 grid, thread
//   (ty, tx) computing rows ty + 16*r and columns tx + 16*q of each 64-wide
//   tile, everything in shared memory as float.
// A ragged last tile computes on zero rows past R and stores nothing there.

#include <mma.h>

#include "dtype.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kChunk = 64;  // hidden units per chunk, and output columns per FMA tile

__device__ __forceinline__ float gelu(float u) {
  return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
}

// LayerNorm of rows row0 .. row0+tr-1 into hs (row stride ldh, element H),
// each value rounded to T; rows past R become zeros. One warp per row.
template <typename T, typename H, int kThreads>
__device__ void layer_norm_tile(const T* __restrict__ x, const float* __restrict__ ln_s,
                                const float* __restrict__ ln_b, H* hs, int ldh, int tr,
                                int row0, int rows, int c, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float inv_c = 1.f / c;
  for (int r = warp; r < tr; r += kThreads / 32) {
    H* hr = hs + r * ldh;
    const int gr = row0 + r;
    if (gr >= rows) {
      for (int j = lane; j < c; j += 32) hr[j] = nkbx::from_f<H>(0.f);
      continue;
    }
    const T* xr = x + static_cast<size_t>(gr) * c;
    float s = 0.f, s2 = 0.f;
    for (int j = lane; j < c; j += 32) {
      const float v = nkbx::to_f(xr[j]);
      s += v;
      s2 += v * v;
    }
    const float mu = nkbx::warp_sum(s) * inv_c;
    const float var = fmaxf(nkbx::warp_sum(s2) * inv_c - mu * mu, 0.f);
    const float rstd = rsqrtf(var + eps);
    for (int j = lane; j < c; j += 32) {
      const float v = (nkbx::to_f(xr[j]) - mu) * rstd * ln_s[j] + ln_b[j];
      hr[j] = nkbx::from_f<H>(nkbx::round_to<T>(v));
    }
  }
}

// out = sc + round(y + b1) * round(gamma), each step rounded to T.
template <typename T, int kThreads>
__device__ void epilogue(const float* ys, int ldy, const float* __restrict__ b1,
                         const float* __restrict__ gamma, const T* __restrict__ sc,
                         T* __restrict__ out, int tr, int row0, int rows, int c) {
  for (int idx = threadIdx.x; idx < tr * c; idx += kThreads) {
    const int r = idx / c, j = idx - r * c;
    const int gr = row0 + r;
    if (gr >= rows) break;
    const size_t o = static_cast<size_t>(gr) * c + j;
    const float y = nkbx::round_to<T>(ys[r * ldy + j] + b1[j]);
    const float t = nkbx::round_to<T>(y * nkbx::round_to<T>(gamma[j]));
    out[o] = nkbx::from_f<T>(nkbx::to_f(sc[o]) + t);
  }
}

// --- tensor cores (bf16) ------------------------------------------------------

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kLdu = kChunk + 4;          // float row stride of the u chunk
constexpr int kLdg = kChunk + 8;          // bf16 row stride of the g chunk
constexpr int kSlabK = 32;                // weight rows per staged slab
constexpr int kLdA = kChunk + 8;          // w0 slab (kSlabK, 64) row stride
constexpr int kSlabN = 16 * kTcWarps;     // w1 slab width: one column tile per warp
constexpr int kLdB = kSlabN + 8;          // w1 slab (kSlabK, 128) row stride
constexpr int kWbufBytes = 2 * kSlabK * kLdB * 2;  // two w1 slabs (the largest use)

// Shared memory: hs bf16 (TR, C+8) | ys float (TR, C+4) | us float (TR, kLdu)
// | gs bf16 (TR, kLdg) | wbuf: two staged weight slabs, or step 2a's second
// partial sum (TR, kLdu) float. Every part starts 256-byte aligned when
// TR % 16 == 0 and C % 32 == 0. nkbx_torch/ops/mlp.py `smem_bytes` mirrors it.
size_t tc_smem_bytes(int tr, int c) {
  return static_cast<size_t>(tr) * (2 * (c + 8) + 4 * (c + 4) + 4 * kLdu + 2 * kLdg) +
         kWbufBytes;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Start copying a (rows, cols) bf16 tile (cols % 8 == 0, 16-byte aligned
// rows) into shared memory as one cp.async group of the calling thread.
__device__ __forceinline__ void stage_tile(bf16* dst, int ldd, const bf16* src, size_t lds,
                                           int rows, int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kTcThreads) {
    const int r = i / per_row, v = i - r * per_row;
    cp_async16(dst + r * ldd + 8 * v, src + r * lds + 8 * v);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for the slab issued before the one just issued (or for all, when
// nothing was issued after it), then make it visible to every warp.
__device__ __forceinline__ void slab_ready(bool issued_next) {
  if (issued_next) cp_async_wait_one(); else cp_async_wait_all();
  __syncthreads();
}

template <int NRT>
__global__ void __launch_bounds__(kTcThreads)
ln_mlp_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, const bf16* __restrict__ w0,
                 const float* __restrict__ b0, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ gamma,
                 const bf16* __restrict__ sc, bf16* __restrict__ out, int rows, int c, int f,
                 float eps) {
  using namespace nvcuda;
  using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
  using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
  using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  constexpr int TR = 16 * NRT;
  extern __shared__ __align__(256) unsigned char smem[];
  const int ldh = c + 8, ldy = c + 4;
  bf16* hs = reinterpret_cast<bf16*>(smem);
  float* ys = reinterpret_cast<float*>(hs + TR * ldh);
  float* us = ys + TR * ldy;
  bf16* gs = reinterpret_cast<bf16*>(us + TR * kLdu);
  bf16* wbuf = gs + TR * kLdg;
  float* us2 = reinterpret_cast<float*>(wbuf);  // step 2a's second partial sum
  const int row0 = blockIdx.x * TR;
  const int warp = threadIdx.x / 32;

  // 1. LayerNorm into hs (bf16); zero the accumulators.
  layer_norm_tile<bf16, bf16, kTcThreads>(x, ln_s, ln_b, hs, ldh, TR, row0, rows, c, eps);
  for (int i = threadIdx.x; i < TR * ldy; i += kTcThreads) ys[i] = 0.f;
  __syncthreads();

  const int nslab_a = c / kSlabK;
  const int ncol = (c + kSlabN - 1) / kSlabN;
  const int nslab_b = ncol * (kChunk / kSlabK);
  for (int f0 = 0; f0 < f; f0 += kChunk) {
    // 2a. us + us2 = hs @ w0[:, f0:f0+64]. w0 comes in (32, 64) slabs; warp
    // w takes column tile w % 4 and, of each slab's two k-steps, step w / 4,
    // into its own partial sum, for every row tile.
    {
      const int ct = warp % 4, kpart = warp / 4;
      FragC acc[NRT];
#pragma unroll
      for (int rt = 0; rt < NRT; ++rt) wmma::fill_fragment(acc[rt], 0.f);
      stage_tile(wbuf, kLdA, w0 + f0, f, kSlabK, kChunk);
      for (int s = 0; s < nslab_a; ++s) {
        const bool next = s + 1 < nslab_a;
        if (next)
          stage_tile(wbuf + ((s + 1) & 1) * kSlabK * kLdA, kLdA,
                     w0 + static_cast<size_t>(s + 1) * kSlabK * f + f0, f, kSlabK, kChunk);
        slab_ready(next);
        FragB b;
        wmma::load_matrix_sync(b, wbuf + (s & 1) * kSlabK * kLdA + 16 * kpart * kLdA + 16 * ct,
                               kLdA);
#pragma unroll
        for (int rt = 0; rt < NRT; ++rt) {
          FragA a;
          wmma::load_matrix_sync(a, hs + 16 * rt * ldh + s * kSlabK + 16 * kpart, ldh);
          wmma::mma_sync(acc[rt], a, b, acc[rt]);
        }
        __syncthreads();  // the slab buffer is refilled two steps on
      }
      float* dst = kpart ? us2 : us;
#pragma unroll
      for (int rt = 0; rt < NRT; ++rt)
        wmma::store_matrix_sync(dst + 16 * rt * kLdu + 16 * ct, acc[rt], kLdu,
                                wmma::mem_row_major);
    }
    __syncthreads();

    // 2b. gs = gelu(us + us2 + b0) in float, rounded to bf16.
    for (int idx = threadIdx.x; idx < TR * kChunk; idx += kTcThreads) {
      const int r = idx / kChunk, j = idx % kChunk;
      const int o = r * kLdu + j;
      gs[r * kLdg + j] = __float2bfloat16(gelu(us[o] + us2[o] + b0[f0 + j]));
    }
    __syncthreads();

    // 2c. ys += gs @ w1[f0:f0+64, :]. w1 comes in (32, 128) slabs, two per
    // 128-column band; warp w owns column tile w of each band.
    {
      FragC acc[NRT];
      stage_tile(wbuf, kLdB, w1 + static_cast<size_t>(f0) * c, c, kSlabK, min(kSlabN, c));
      for (int t = 0; t < nslab_b; ++t) {
        const int band = t / 2, kh = t % 2;
        const int ct = band * kTcWarps + warp;
        const bool active = ct < c / 16;
        if (kh == 0 && active) {
#pragma unroll
          for (int rt = 0; rt < NRT; ++rt)
            wmma::load_matrix_sync(acc[rt], ys + 16 * rt * ldy + 16 * ct, ldy,
                                   wmma::mem_row_major);
        }
        const bool next = t + 1 < nslab_b;
        if (next) {
          const int nb = (t + 1) / 2, nk = (t + 1) % 2;
          const int c0 = nb * kSlabN;
          stage_tile(wbuf + ((t + 1) & 1) * kSlabK * kLdB, kLdB,
                     w1 + static_cast<size_t>(f0 + nk * kSlabK) * c + c0, c, kSlabK,
                     min(kSlabN, c - c0));
        }
        slab_ready(next);
        if (active) {
          const bf16* slab = wbuf + (t & 1) * kSlabK * kLdB;
#pragma unroll
          for (int kk = 0; kk < kSlabK; kk += 16) {
            FragB b;
            wmma::load_matrix_sync(b, slab + kk * kLdB + 16 * warp, kLdB);
#pragma unroll
            for (int rt = 0; rt < NRT; ++rt) {
              FragA a;
              wmma::load_matrix_sync(a, gs + 16 * rt * kLdg + kh * kSlabK + kk, kLdg);
              wmma::mma_sync(acc[rt], a, b, acc[rt]);
            }
          }
          if (kh == 1) {
#pragma unroll
            for (int rt = 0; rt < NRT; ++rt)
              wmma::store_matrix_sync(ys + 16 * rt * ldy + 16 * ct, acc[rt], ldy,
                                      wmma::mem_row_major);
          }
        }
        __syncthreads();
      }
    }
  }

  // 3. Epilogue.
  epilogue<bf16, kTcThreads>(ys, ldy, b1, gamma, sc, out, TR, row0, rows, c);
}

// --- float FMAs (float, and bf16 at widths the tensor-core kernel does not take)

constexpr int kFmaThreads = 256;

// Shared memory: hs, ys float (TR, C+1) and gs float (TR, kChunk+1); the +1
// pads rows onto distinct banks. Mirrored by nkbx_torch/ops/mlp.py.
size_t fma_smem_bytes(int tr, int c) {
  return static_cast<size_t>(tr) * (2 * (c + 1) + kChunk + 1) * sizeof(float);
}

template <typename T, int RT>
__global__ void __launch_bounds__(kFmaThreads)
ln_mlp_fma_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, const T* __restrict__ w0,
                  const float* __restrict__ b0, const T* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ gamma,
                  const T* __restrict__ sc, T* __restrict__ out, int rows, int c, int f,
                  float eps) {
  constexpr int TR = 16 * RT;
  extern __shared__ float fsmem[];
  const int ldc = c + 1;
  constexpr int ldg = kChunk + 1;
  float* hs = fsmem;
  float* ys = hs + TR * ldc;
  float* gs = ys + TR * ldc;
  const int row0 = blockIdx.x * TR;

  // 1. LayerNorm into hs (float holding T-rounded values); zero ys.
  layer_norm_tile<T, float, kFmaThreads>(x, ln_s, ln_b, hs, ldc, TR, row0, rows, c, eps);
  for (int i = threadIdx.x; i < TR * ldc; i += kFmaThreads) ys[i] = 0.f;
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int f0 = 0; f0 < f; f0 += kChunk) {
    // 2a. gs = gelu(hs @ w0[:, f0:f0+kChunk] + b0), rounded to T.
    float acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    for (int k = 0; k < c; ++k) {
      const T* wr = w0 + static_cast<size_t>(k) * f + f0;
      float wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int fi = tx + 16 * q;
        wv[q] = f0 + fi < f ? nkbx::to_f(wr[fi]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float hv = hs[(ty + 16 * r) * ldc + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(hv, wv[q], acc[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int fi = tx + 16 * q;
        gs[(ty + 16 * r) * ldg + fi] =
            f0 + fi < f ? nkbx::round_to<T>(gelu(acc[r][q] + b0[f0 + fi])) : 0.f;
      }
    __syncthreads();

    // 2b. ys += gs @ w1[f0:f0+kChunk, :], one 64-column tile at a time.
    const int fn = min(kChunk, f - f0);
    for (int c0 = 0; c0 < c; c0 += kChunk) {
      float a2[RT][4];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) a2[r][q] = 0.f;
      for (int k = 0; k < fn; ++k) {
        const T* wr = w1 + static_cast<size_t>(f0 + k) * c + c0;
        float wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ci = tx + 16 * q;
          wv[q] = c0 + ci < c ? nkbx::to_f(wr[ci]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float gv = gs[(ty + 16 * r) * ldg + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) a2[r][q] = fmaf(gv, wv[q], a2[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ci = c0 + tx + 16 * q;
          if (ci < c) ys[(ty + 16 * r) * ldc + ci] += a2[r][q];
        }
    }
    __syncthreads();
  }

  // 3. Epilogue.
  epilogue<T, kFmaThreads>(ys, ldc, b1, gamma, sc, out, TR, row0, rows, c);
}

// --- launch -------------------------------------------------------------------

struct Args {
  const void *x, *ln_s, *ln_b, *w0, *b0, *w1, *b1, *gamma, *sc;
  void* out;
  int rows, c, f;
  float eps;
};

template <typename K, typename T>
cudaError_t launch(K kernel, int tr, size_t smem, int threads, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = nkbx::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((a.rows + tr - 1) / tr);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.ln_s),
      static_cast<const float*>(a.ln_b), static_cast<const T*>(a.w0),
      static_cast<const float*>(a.b0), static_cast<const T*>(a.w1),
      static_cast<const float*>(a.b1), static_cast<const float*>(a.gamma),
      static_cast<const T*>(a.sc), static_cast<T*>(a.out), a.rows, a.c, a.f, a.eps);
  return cudaGetLastError();
}

cudaError_t launch_tc(int tr, const Args& a, cudaStream_t s) {
  const size_t smem = tc_smem_bytes(tr, a.c);
  switch (tr) {
    case 16: return launch<decltype(&ln_mlp_tc_kernel<1>), bf16>(ln_mlp_tc_kernel<1>, tr, smem, kTcThreads, a, s);
    case 32: return launch<decltype(&ln_mlp_tc_kernel<2>), bf16>(ln_mlp_tc_kernel<2>, tr, smem, kTcThreads, a, s);
    case 64: return launch<decltype(&ln_mlp_tc_kernel<4>), bf16>(ln_mlp_tc_kernel<4>, tr, smem, kTcThreads, a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_fma(int tr, const Args& a, cudaStream_t s) {
  const size_t smem = fma_smem_bytes(tr, a.c);
  switch (tr) {
    case 16: return launch<decltype(&ln_mlp_fma_kernel<T, 1>), T>(ln_mlp_fma_kernel<T, 1>, tr, smem, kFmaThreads, a, s);
    case 32: return launch<decltype(&ln_mlp_fma_kernel<T, 2>), T>(ln_mlp_fma_kernel<T, 2>, tr, smem, kFmaThreads, a, s);
    case 64: return launch<decltype(&ln_mlp_fma_kernel<T, 4>), T>(ln_mlp_fma_kernel<T, 4>, tr, smem, kFmaThreads, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, sc, out (R, C); w0 (C, F); w1 (F, C) in float (is_bf16 = 0) or bf16;
// ln_s, ln_b, b1, gamma (C) and b0 (F) in float. tile_rows is 16, 32 or 64;
// tensor_cores = 1 takes the bf16 tensor-core kernel (C % 32 == 0,
// F % 64 == 0). Returns the CUDA error code of the launch (0 on success).
extern "C" int nkbx_ln_mlp(const void* x, const void* ln_s, const void* ln_b, const void* w0,
                           const void* b0, const void* w1, const void* b1, const void* gamma,
                           const void* sc, void* out, int rows, int c, int f, int tile_rows,
                           float eps, int is_bf16, int tensor_cores, void* stream) {
  const Args a{x, ln_s, ln_b, w0, b0, w1, b1, gamma, sc, out, rows, c, f, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (!is_bf16 || c % kSlabK || f % kChunk) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_tc(tile_rows, a, s));
  }
  return static_cast<int>(is_bf16 ? launch_fma<bf16>(tile_rows, a, s)
                                  : launch_fma<float>(tile_rows, a, s));
}
