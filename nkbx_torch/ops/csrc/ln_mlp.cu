// Fused LayerNorm -> Dense -> exact GELU -> Dense -> layer-scale -> residual,
// forward only: the transformer-block MLP half; and its LN-free member, the
// MLP alone.
//
// Replaces two Pallas kernels: nkbx/ops/mlp.py:504 `_lnmlp_fwd_kernel`
// (entry `fused_ln_mlp`, K5; C entries `nkbx_ln_mlp_gemm` and `nkbx_ln_mlp`)
// and nkbx/ops/mlp.py:250 `_fwd_kernel` (entry `fused_mlp`, K7; C entry
// `nkbx_mlp`). For each row of x (R, C), K5 computes:
//   h   = LayerNorm(x) in float (flax fast variance E[x^2] - mu^2, clamped
//         at 0), rounded to the storage type T
//   g   = gelu(h @ w0 + b0) with float accumulation and the exact (erf) GELU
//         in float, rounded to T
//   y   = g @ w1 + b1 with float accumulation, rounded to T
//   out = sc + y * gamma, in T (mlp.py:515-517)
// K7 is the same function without the LayerNorm, layer-scale or residual:
// out = y (mlp.py:250-262).
//
// What bounds it on an H100: the operations. The function moves x, sc and
// out (6*C bytes a row in bf16) for 4*C*F operations, 256 operations a byte
// at C = 96 and F = 4C, growing with C; the bf16 ridge is ~295. So the
// products must run on the tensor cores at a high share of their rate.
//
// K5's route in bf16 with C % 32 == 0 and F % 64 == 0 (every Swin, ConvNeXt
// and ViT width), `nkbx_ln_mlp_gemm`: three kernels.
// 1. ln_mlp_layernorm_kernel: h = round(LN(x)) (R, C), one warp a row.
// 2. ln_mlp_gemm_kernel, h w0 on 128 x 128 tiles of eight 64 x 32 warp
//    tiles (gemm_tc.cuh), epilogue + b0, exact GELU in float, round: g (R,
//    F) in bf16, stored through shared memory.
// 3. ln_mlp_gemm_kernel, g w1 on the same tiles, epilogue + b1, round,
//    * round(gamma), round, + sc: out. Where its tiles would fill the card
//    poorly (few rows, K = F long) K is split into slabs whose float
//    partials ln_mlp_fc2_finish_kernel adds in order before that epilogue.
// The hidden g goes through device memory once (R*F*2 bytes written and
// read: 77 MB at ViT-B bucket 64, about 0.05 ms): nkbx rounds g to T at that
// point, so no number changes. In exchange every weight byte feeds a
// 128-row tile instead of 16 rows.
//
// The first design, a row-tile kernel in both members (LN on or off), stays
// for f32, other widths and K7:
// - ln_mlp_tc_kernel, bf16 with C % 32 == 0 and F % 64 == 0: warp-level
//   bf16 tensor-core products (WMMA 16x16x16, float accumulators). 8 warps;
//   a block owns TR = 16*NRT rows. A (h or g) is read from shared memory;
//   the weights come through shared memory in 32-row slabs, two in flight
//   (cp.async, double-buffered). The (R, F) hidden never reaches device
//   memory: F is walked in chunks of kChunk, each chunk's g in shared
//   memory. Every block streams all of w0 and w1 from L2.
// - ln_mlp_fma_kernel, float (and bf16 at other widths): the same steps with
//   float FMAs on the CUDA cores; 256 threads in a 16 x 16 grid, thread
//   (ty, tx) computing rows ty + 16*r and columns tx + 16*q of each 64-wide
//   tile, everything in shared memory as float.
// A ragged last tile computes on zero rows past R and stores nothing there.

#include <mma.h>

#include "dtype.cuh"
#include "gemm_tc.cuh"

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

// Without the LayerNorm (K7): rows row0 .. row0+tr-1 of x into hs as they
// are; rows past R become zeros (mlp.py:253-255).
template <typename T, typename H, int kThreads>
__device__ void load_tile(const T* __restrict__ x, H* hs, int ldh, int tr, int row0, int rows,
                          int c) {
  for (int idx = threadIdx.x; idx < tr * c; idx += kThreads) {
    const int r = idx / c, j = idx - r * c;
    const int gr = row0 + r;
    hs[r * ldh + j] = nkbx::from_f<H>(gr < rows ? nkbx::to_f(x[static_cast<size_t>(gr) * c + j])
                                                : 0.f);
  }
}

// LN: out = sc + round(y + b1) * round(gamma), each step rounded to T.
// Without (K7): out = round(y + b1).
template <typename T, int kThreads, bool LN>
__device__ void epilogue(const float* ys, int ldy, const float* __restrict__ b1,
                         const float* __restrict__ gamma, const T* __restrict__ sc,
                         T* __restrict__ out, int tr, int row0, int rows, int c) {
  for (int idx = threadIdx.x; idx < tr * c; idx += kThreads) {
    const int r = idx / c, j = idx - r * c;
    const int gr = row0 + r;
    if (gr >= rows) break;
    const size_t o = static_cast<size_t>(gr) * c + j;
    const float y = nkbx::round_to<T>(ys[r * ldy + j] + b1[j]);
    if constexpr (LN) {
      const float t = nkbx::round_to<T>(y * nkbx::round_to<T>(gamma[j]));
      out[o] = nkbx::from_f<T>(nkbx::to_f(sc[o]) + t);
    } else {
      out[o] = nkbx::from_f<T>(y);
    }
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

template <bool LN, int NRT>
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

  // 1. LayerNorm (or x itself) into hs (bf16); zero the accumulators.
  if constexpr (LN)
    layer_norm_tile<bf16, bf16, kTcThreads>(x, ln_s, ln_b, hs, ldh, TR, row0, rows, c, eps);
  else
    load_tile<bf16, bf16, kTcThreads>(x, hs, ldh, TR, row0, rows, c);
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
  epilogue<bf16, kTcThreads, LN>(ys, ldy, b1, gamma, sc, out, TR, row0, rows, c);
}

// --- float FMAs (float, and bf16 at widths the tensor-core kernel does not take)

constexpr int kFmaThreads = 256;

// Shared memory: hs, ys float (TR, C+1) and gs float (TR, kChunk+1); the +1
// pads rows onto distinct banks. Mirrored by nkbx_torch/ops/mlp.py.
size_t fma_smem_bytes(int tr, int c) {
  return static_cast<size_t>(tr) * (2 * (c + 1) + kChunk + 1) * sizeof(float);
}

template <typename T, bool LN, int RT>
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

  // 1. LayerNorm (or x itself) into hs (float holding T values); zero ys.
  if constexpr (LN)
    layer_norm_tile<T, float, kFmaThreads>(x, ln_s, ln_b, hs, ldc, TR, row0, rows, c, eps);
  else
    load_tile<T, float, kFmaThreads>(x, hs, ldc, TR, row0, rows, c);
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
  epilogue<T, kFmaThreads, LN>(ys, ldc, b1, gamma, sc, out, TR, row0, rows, c);
}

// --- the GEMM route (bf16, C % 32 == 0, F % 64 == 0) ---------------------------

namespace gm = nkbx::gemm;

// 128 x 128 tiles of 8 warps of 64 x 32, a 4-slab ring of 32-deep slabs: on
// the H100 at least as fast at every Swin-T and ViT-B shape as 4 warps of 64
// x 64, 128 x 64 tiles (g w1) or 64-deep slabs (PERF.md)
using Fc1 = gm::Config<128, 2, 4, 4>;  // h w0 (N = F)
using Fc2 = gm::Config<128, 2, 4, 4>;  // g w1 (N = C)
constexpr int kLnRows = 8;             // rows a block of the LayerNorm kernel, one a warp

// h = round(LN(x)) for rows blockIdx.x * kLnRows + warp, four values a
// lane.
__global__ void __launch_bounds__(32 * kLnRows)
ln_mlp_layernorm_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                        const float* __restrict__ ln_b, bf16* __restrict__ h, int rows, int c,
                        float eps) {
  const int r = blockIdx.x * kLnRows + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;
  const size_t o = static_cast<size_t>(r) * c;
  const float2 st = gm::row_stats(x + o, c, eps);
  for (int j = 4 * lane; j < c; j += 128) {
    const float4 v = gm::load4(x + o + j);
    gm::store4(h + o + j, (v.x - st.x) * st.y * ln_s[j] + ln_b[j],
               (v.y - st.x) * st.y * ln_s[j + 1] + ln_b[j + 1],
               (v.z - st.x) * st.y * ln_s[j + 2] + ln_b[j + 2],
               (v.w - st.x) * st.y * ln_s[j + 3] + ln_b[j + 3]);
  }
}

// Step 2's epilogue: g = round(gelu(acc + b0)), rows < R, through shared
// memory.
struct Fc1Epilogue {
  const float* __restrict__ b0;
  bf16* __restrict__ g;
  int rows, f;

  template <class J>
  __device__ __forceinline__ void operator()(J& j, const gm::Tile& t, float* smem) const {
    const float* bias = b0 + t.n0;
    const int n_valid = f - t.n0;
    gm::store_tile<typename J::P, Fc1::BN>(
        [&](int, int col, int mt, int nt, int hi) {
          if (col >= n_valid) return 0u;  // a ragged last tile: nothing stored there
          return nkbx::pack_bf16(gm::gelu(j.acc[mt][nt][2 * hi] + bias[col]),
                                 gm::gelu(j.acc[mt][nt][2 * hi + 1] + bias[col + 1]));
        },
        reinterpret_cast<bf16*>(smem), j.wm, j.wn, g + static_cast<size_t>(t.m0) * f + t.n0, f,
        rows - t.m0, n_valid);
  }
};

// out = sc + round(round(y + b1) * round(gamma)), each step rounded to bf16.
__device__ __forceinline__ unsigned fc2_out(float y0, float y1, int col, const float* b1,
                                            const float* gamma, const bf16* sc) {
  const float2 s = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc));
  const float t0 = nkbx::round_to<bf16>(nkbx::round_to<bf16>(y0 + b1[col]) *
                                        nkbx::round_to<bf16>(gamma[col]));
  const float t1 = nkbx::round_to<bf16>(nkbx::round_to<bf16>(y1 + b1[col + 1]) *
                                        nkbx::round_to<bf16>(gamma[col + 1]));
  return nkbx::pack_bf16(s.x + t0, s.y + t1);
}

// Step 3's epilogue, K unsplit: out from acc, rows < R.
struct Fc2Epilogue {
  const float* __restrict__ b1;
  const float* __restrict__ gamma;
  const bf16* __restrict__ sc;
  bf16* __restrict__ out;
  int rows, c;

  template <class J>
  __device__ __forceinline__ void operator()(J& j, const gm::Tile& t, float*) const {
    gm::for_pairs<J::P::MT, J::P::NT>(t.m0 + j.wm, t.n0 + j.wn, [&](int r, int col, int mt, int nt,
                                                                    int hi) {
      if (r >= rows || col >= c) return;
      const size_t o = static_cast<size_t>(r) * c + col;
      *reinterpret_cast<unsigned*>(out + o) =
          fc2_out(j.acc[mt][nt][2 * hi], j.acc[mt][nt][2 * hi + 1], col, b1, gamma, sc + o);
    });
  }
};

// Step 3's epilogue, K split into slabs: the float partial of slab
// blockIdx.y into part (slabs, R, C).
struct PartialEpilogue {
  float* __restrict__ part;
  int rows, c;

  template <class J>
  __device__ __forceinline__ void operator()(J& j, const gm::Tile& t, float*) const {
    float* base = part + static_cast<size_t>(blockIdx.y) * rows * c;
    gm::for_pairs<J::P::MT, J::P::NT>(t.m0 + j.wm, t.n0 + j.wn, [&](int r, int col, int mt, int nt,
                                                                    int hi) {
      if (r >= rows || col >= c) return;
      *reinterpret_cast<float2*>(base + static_cast<size_t>(r) * c + col) =
          make_float2(j.acc[mt][nt][2 * hi], j.acc[mt][nt][2 * hi + 1]);
    });
  }
};

template <class Cfg, bool A_KC, bool B_KC, class Epi>
__global__ void __launch_bounds__(Cfg::kThreads)
ln_mlp_gemm_kernel(gm::Operand a, gm::Operand b, int M, int N, int K, int slab_k, Epi epi) {
  gm::run<Cfg, A_KC, B_KC>(a, b, M, N, K, slab_k, epi);
}

template <class Cfg, bool A_KC, bool B_KC, class Epi>
cudaError_t launch_gemm(gm::Operand a, gm::Operand b, int M, int N, int K, int slab_k,
                        const Epi& epi, cudaStream_t s) {
  return gm::launch<Cfg, gm::Single<Cfg, A_KC, B_KC>>(ln_mlp_gemm_kernel<Cfg, A_KC, B_KC, Epi>, M,
                                                      N, (K + slab_k - 1) / slab_k, s, a, b, M, N,
                                                      K, slab_k, epi);
}

// Step 3 after a split of K: out from the sum of the slabs' partials, added
// in slab order; one thread a pair of columns.
__global__ void __launch_bounds__(256)
ln_mlp_fc2_finish_kernel(const float* __restrict__ part, int slabs, const float* __restrict__ b1,
                         const float* __restrict__ gamma, const bf16* __restrict__ sc,
                         bf16* __restrict__ out, int rows, int c) {
  const size_t n = static_cast<size_t>(rows) * c;
  const size_t o = 2 * (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (o >= n) return;
  float2 y = *reinterpret_cast<const float2*>(part + o);
  for (int s = 1; s < slabs; ++s) {
    const float2 p = *reinterpret_cast<const float2*>(part + s * n + o);
    y.x += p.x;
    y.y += p.y;
  }
  *reinterpret_cast<unsigned*>(out + o) = fc2_out(y.x, y.y, static_cast<int>(o % c), b1, gamma,
                                                  sc + o);
}

// --- launch -------------------------------------------------------------------

struct Args {
  const void *x, *ln_s, *ln_b, *w0, *b0, *w1, *b1, *gamma, *sc;  // K7: ln_s, ln_b, gamma, sc null
  void* out;
  int rows, c, f;
  float eps;
};

template <typename T, typename K>
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

template <bool LN>
cudaError_t launch_tc(int tr, const Args& a, cudaStream_t s) {
  const size_t smem = tc_smem_bytes(tr, a.c);
  switch (tr) {
    case 16: return launch<bf16>(ln_mlp_tc_kernel<LN, 1>, tr, smem, kTcThreads, a, s);
    case 32: return launch<bf16>(ln_mlp_tc_kernel<LN, 2>, tr, smem, kTcThreads, a, s);
    case 64: return launch<bf16>(ln_mlp_tc_kernel<LN, 4>, tr, smem, kTcThreads, a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool LN>
cudaError_t launch_fma(int tr, const Args& a, cudaStream_t s) {
  const size_t smem = fma_smem_bytes(tr, a.c);
  switch (tr) {
    case 16: return launch<T>(ln_mlp_fma_kernel<T, LN, 1>, tr, smem, kFmaThreads, a, s);
    case 32: return launch<T>(ln_mlp_fma_kernel<T, LN, 2>, tr, smem, kFmaThreads, a, s);
    case 64: return launch<T>(ln_mlp_fma_kernel<T, LN, 4>, tr, smem, kFmaThreads, a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool LN>
int launch_any(const Args& a, int tile_rows, int is_bf16, int tensor_cores, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores) {
    if (!is_bf16 || a.c % kSlabK || a.f % kChunk) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_tc<LN>(tile_rows, a, s));
  }
  return static_cast<int>(is_bf16 ? launch_fma<bf16, LN>(tile_rows, a, s)
                                  : launch_fma<float, LN>(tile_rows, a, s));
}

}  // namespace

// K5's first design. x, sc, out (R, C); w0 (C, F); w1 (F, C) in float
// (is_bf16 = 0) or bf16; ln_s, ln_b, b1, gamma (C) and b0 (F) in float.
// tile_rows is 16, 32 or 64; tensor_cores = 1 takes the bf16 tensor-core
// kernel (C % 32 == 0, F % 64 == 0). Returns the CUDA error code of the
// launch (0 on success).
extern "C" int nkbx_ln_mlp(const void* x, const void* ln_s, const void* ln_b, const void* w0,
                           const void* b0, const void* w1, const void* b1, const void* gamma,
                           const void* sc, void* out, int rows, int c, int f, int tile_rows,
                           float eps, int is_bf16, int tensor_cores, void* stream) {
  const Args a{x, ln_s, ln_b, w0, b0, w1, b1, gamma, sc, out, rows, c, f, eps};
  return launch_any<true>(a, tile_rows, is_bf16, tensor_cores, stream);
}

// K7: out = gelu(x @ w0 + b0) @ w1 + b1 on x, out (R, C), the other
// arguments as for nkbx_ln_mlp.
extern "C" int nkbx_mlp(const void* x, const void* w0, const void* b0, const void* w1,
                        const void* b1, void* out, int rows, int c, int f, int tile_rows,
                        int is_bf16, int tensor_cores, void* stream) {
  const Args a{x, nullptr, nullptr, w0, b0, w1, b1, nullptr, nullptr, out, rows, c, f, 0.f};
  return launch_any<false>(a, tile_rows, is_bf16, tensor_cores, stream);
}

// K5 on the GEMM route: x, sc, out (R, C); w0 (C, F); w1 (F, C) in bf16,
// C % 32 == 0 and F % 64 == 0, every pointer 16-byte aligned; ln_s, ln_b,
// b1, gamma (C) and b0 (F) in float; scratch h (R, C) and g (R, F) in bf16.
// g w1 runs in slabs of K = F of slab_f rows (a multiple of 32); with more
// than one, part (ceil(F / slab_f), R, C) in float holds their partials.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int nkbx_ln_mlp_gemm(const void* x, const void* ln_s, const void* ln_b, const void* w0,
                                const void* b0, const void* w1, const void* b1, const void* gamma,
                                const void* sc, void* out, void* h, void* g, void* part, int rows,
                                int c, int f, int slab_f, float eps, void* stream) {
  if (c % 32 || f % 64 || slab_f <= 0 || slab_f % gm::kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* hb = static_cast<const bf16*>(h);
  const bf16* gb = static_cast<const bf16*>(g);
  const float* b1f = static_cast<const float*>(b1);
  const float* gmf = static_cast<const float*>(gamma);
  const bf16* scb = static_cast<const bf16*>(sc);
  bf16* outb = static_cast<bf16*>(out);
  ln_mlp_layernorm_kernel<<<(rows + kLnRows - 1) / kLnRows, 32 * kLnRows, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<bf16*>(h), rows, c, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // h w0: A = h contiguous in K = C; B = w0 (C, F) contiguous in N
  err = launch_gemm<Fc1, true, false>(
      {hb, c}, {static_cast<const bf16*>(w0), f}, rows, f, c, c,
      Fc1Epilogue{static_cast<const float*>(b0), static_cast<bf16*>(g), rows, f}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // g w1: A = g contiguous in K = F; B = w1 (F, C) contiguous in N
  const gm::Operand ga{gb, f}, w1b{static_cast<const bf16*>(w1), c};
  const int slabs = (f + slab_f - 1) / slab_f;
  if (slabs == 1)
    return static_cast<int>(launch_gemm<Fc2, true, false>(
        ga, w1b, rows, c, f, f, Fc2Epilogue{b1f, gmf, scb, outb, rows, c}, s));
  float* pf = static_cast<float*>(part);
  err = launch_gemm<Fc2, true, false>(ga, w1b, rows, c, f, slab_f, PartialEpilogue{pf, rows, c}, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t pairs = static_cast<size_t>(rows) * c / 2;
  ln_mlp_fc2_finish_kernel<<<static_cast<unsigned>((pairs + 255) / 256), 256, 0, s>>>(
      pf, slabs, b1f, gmf, scb, outb, rows, c);
  return static_cast<int>(cudaGetLastError());
}
