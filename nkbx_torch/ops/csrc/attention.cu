// Full-sequence attention on separate q, k, v (the ViT family), forward.
//
// Replaces the Pallas kernel nkbx/ops/attention.py:275 `_fwd_kernel_sep`
// (entry `fused_attention`). Per group g and head h it computes
//   o = softmax(q k^T * scale + bias[min(h, Hb-1)] + mask[g % M]) v
// from q, k, v of shape (G, N, H*D) with D = 64; head h sits at lanes h*D.
// Scores and the softmax stay in float with one reciprocal per row; P is
// rounded to the storage type T before P*V, and P*V accumulates in float
// (attention.py:226-236).
//
// What bounds it on an H100: at ViT-B/16 (N = 197) a (g, h) reads 3*N*D and
// writes N*D values for 4*N*N*D operations, about 200 operations per byte
// in bf16, under the ~295 the card needs before its tensor cores are the
// limit, so the bytes bound it, but only just: the products have to run on
// the tensor cores, or they are the limit many times over. The design keeps
// the (N, N) scores and probabilities out of device memory.
//
// Design: a block owns kTq = 32 query rows of one (g, h). It holds those
// rows' whole float score rows and their rounded probabilities in shared
// memory (82 + 41 KB in bf16 at N = 577) and streams K, then V, through
// one shared tile of 64 keys. The products are warp-level 16x16 tiles
// (attention_tile.cuh): bf16 WMMA on the tensor cores, float FMAs for
// float storage. Keys past N are zero rows whose probabilities are 0; rows
// past N compute on zeros and store nothing. Not yet Hopper's wgmma/TMA, and
// the tiles are loaded without overlap.
//
// Shared memory (see attention_fwd_smem_bytes): q tile (kTq, D+8) T | key or
// value tile (64, D+8) T | scores (kTq, Np+4) float | P (kTq, Np+8) T, with
// Np = N rounded up to 64. nkbx_torch/ops/attention.py mirrors it.

#include <cfloat>

#include "attention_tile.cuh"

namespace {

using nkbx::ColMajor;
using nkbx::RowMajor;
using nkbx::WarpTile;
constexpr int D = nkbx::kHeadDim;
constexpr int kLd = nkbx::kLdTile;
constexpr int kTk = nkbx::kKeyTile;
constexpr int kThreads = nkbx::kAttnThreads;
constexpr int kWarps = nkbx::kAttnWarps;
constexpr int kTq = 32;  // query rows per block

template <typename T>
size_t attention_fwd_smem_bytes(int n) {
  const int np = nkbx::padded_keys(n);
  return nkbx::align128(kTq * kLd * sizeof(T)) + nkbx::align128(kTk * kLd * sizeof(T)) +
         nkbx::align128(static_cast<size_t>(kTq) * (np + 4) * 4) +
         nkbx::align128(static_cast<size_t>(kTq) * (np + 8) * sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, const float* __restrict__ mask,
                     T* __restrict__ out, int n, int heads, int bias_heads, int m, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int np = nkbx::padded_keys(n), lds = np + 4, ldp = np + 8;
  const int i0 = blockIdx.x * kTq, h = blockIdx.y, g = blockIdx.z;
  const int c = heads * D;
  T* qs = reinterpret_cast<T*>(smem);
  T* kv = reinterpret_cast<T*>(smem + nkbx::align128(kTq * kLd * sizeof(T)));
  float* ss = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(kv) +
                                       nkbx::align128(kTk * kLd * sizeof(T)));
  T* ps = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(ss) +
                               nkbx::align128(static_cast<size_t>(kTq) * lds * 4));
  const size_t head0 = static_cast<size_t>(g) * n * c + h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  nkbx::load_rows(qs, q + head0, c, i0, kTq, n);

  // 1. Raw scores q k^T, one 64-key tile at a time: 2 x 4 warp tiles.
  for (int j0 = 0; j0 < np; j0 += kTk) {
    __syncthreads();  // the previous key tile is consumed
    nkbx::load_rows(kv, k + head0, c, j0, kTk, n);
    __syncthreads();
    for (int f = warp; f < (kTq / 16) * (kTk / 16); f += kWarps) {
      const int rf = f / (kTk / 16), cf = f % (kTk / 16);
      WarpTile<T> t;
      t.zero();
      t.template mma<RowMajor, ColMajor>(qs + rf * 16 * kLd, kLd, kv + cf * 16 * kLd, kLd, D);
      t.store(ss + rf * 16 * lds + j0 + cf * 16, lds);
    }
  }
  __syncthreads();

  // 2. Row softmax in float, one warp per row: s*scale + bias + mask, the max,
  //    the exponentials, one reciprocal of their sum; P rounded to T, zero
  //    past N.
  const float* bh = bias + static_cast<size_t>(min(h, bias_heads - 1)) * n * n;
  const float* mg = mask + static_cast<size_t>(g % m) * n * n;
  for (int r = warp; r < kTq; r += kWarps) {
    const int i = i0 + r;
    float* sr = ss + r * lds;
    T* pr = ps + r * ldp;
    if (i >= n) {
      for (int j = lane; j < np; j += 32) pr[j] = nkbx::from_f<T>(0.f);
      continue;
    }
    const float* bi = bh + static_cast<size_t>(i) * n;
    const float* mi = mg + static_cast<size_t>(i) * n;
    float mx = -FLT_MAX;
    for (int j = lane; j < n; j += 32) {
      const float s = sr[j] * scale + bi[j] + mi[j];
      sr[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = nkbx::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(sr[j] - mx);
      sr[j] = e;
      sum += e;
    }
    const float inv = 1.f / nkbx::warp_sum(sum);
    for (int j = lane; j < np; j += 32) pr[j] = nkbx::from_f<T>(j < n ? sr[j] * inv : 0.f);
  }

  // 3. o = P v, one 64-key value tile at a time: 2 x 4 warp tiles, two per
  //    warp, accumulated in registers across the tiles.
  constexpr int kPerWarp = (kTq / 16) * (D / 16) / kWarps;
  WarpTile<T> acc[kPerWarp];
#pragma unroll
  for (int t = 0; t < kPerWarp; ++t) acc[t].zero();
  for (int j0 = 0; j0 < np; j0 += kTk) {
    __syncthreads();  // P is complete; the previous value tile is consumed
    nkbx::load_rows(kv, v + head0, c, j0, kTk, n);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kPerWarp; ++t) {
      const int f = warp + kWarps * t, rf = f / (D / 16), df = f % (D / 16);
      acc[t].template mma<RowMajor, RowMajor>(ps + rf * 16 * ldp + j0, ldp, kv + df * 16, kLd,
                                              kTk);
    }
  }
  __syncthreads();  // every warp is done with the scores buffer
#pragma unroll
  for (int t = 0; t < kPerWarp; ++t) {
    const int f = warp + kWarps * t, rf = f / (D / 16), df = f % (D / 16);
    acc[t].store(ss + rf * 16 * lds + df * 16, lds);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTq * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    if (i0 + r < n) {
      out[head0 + static_cast<size_t>(i0 + r) * c + d] = nkbx::from_f<T>(ss[r * lds + d]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* mask, void* out, int g, int n, int heads, int bias_heads, int m,
                   float scale, cudaStream_t stream) {
  const size_t smem = attention_fwd_smem_bytes<T>(n);
  cudaError_t err = nkbx::allow_smem(attention_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTq - 1) / kTq, heads, g);
  attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<T*>(out), n,
      heads, bias_heads, m, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out (G, N, H*64) in float (is_bf16 = 0) or bf16; bias
// (bias_heads, N, N) and mask (M, N, N) in float. Returns the CUDA error code
// of the launch (0 on success).
extern "C" int nkbx_attention(const void* q, const void* k, const void* v, const void* bias,
                              const void* mask, void* out, int g, int n, int heads,
                              int bias_heads, int m, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, bias, mask, out, g, n, heads, bias_heads, m,
                                      scale, s)
              : launch<float>(q, k, v, bias, mask, out, g, n, heads, bias_heads, m, scale, s));
}
