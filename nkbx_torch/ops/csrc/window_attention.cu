// Packed-qkv window attention for Swin, forward only.
//
// Replaces the Pallas kernel nkbx/ops/attention.py:302 `_fwd_kernel_packed`
// (entry `fused_attention_qkv`). Per window g and head h it computes
//   o = softmax(q k^T * scale + bias[min(h, Hb-1)] + mask[g % M]) v
// from the qkv Dense output (G, N, 3*H*D), whose minor dim factors as
// (3, H, D): q of head h sits at lane h*D, k at C + h*D, v at 2C + h*D
// (C = H*D). The output is written head-major into (G, N, C). Scores and the
// softmax stay in float; P is rounded to the storage type before P*V, and
// P*V accumulates in float, as attention.py:233-236 does.
//
// What bounds it on an H100: the bytes. Each window reads 3*N*C values and
// writes N*C; the two products are 4*N*N*D operations per head, about 25
// operations per byte at N=49, D=32 in bf16, far under the ~295 the card
// needs before its tensor cores are the limit. The design keeps the (N, N)
// scores and probabilities in shared memory and never in device memory, so
// device traffic is qkv in, o out, plus the small bias and mask that every
// block re-reads from L2. This first version does the products with float
// FMAs on the CUDA cores, one block per (window, head).
//
// Shared memory: q, k, v as float with a padded row stride (D+1, so the
// threads of a warp that walk different rows hit different banks), plus the
// (N, N) float scores: 29 KB at N=49, D=32 and 140 KB at N=144 (window 12),
// which needs the raised dynamic shared-memory limit.

#include "dtype.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                        const float* __restrict__ mask, T* __restrict__ out, int n,
                        int heads, int d, int bias_heads, int m, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x % heads;
  const int g = blockIdx.x / heads;
  const int c = heads * d;
  const int ld = d + 1;
  float* qs = smem;
  float* ks = qs + n * ld;
  float* vs = ks + n * ld;
  float* ps = vs + n * ld;  // (n, n): scores, then probabilities

  const T* base = qkv + static_cast<size_t>(g) * n * 3 * c + h * d;
  for (int idx = threadIdx.x; idx < n * d; idx += kThreads) {
    const int i = idx / d, j = idx - i * d;
    const T* row = base + static_cast<size_t>(i) * 3 * c + j;
    qs[i * ld + j] = nkbx::to_f(row[0]);
    ks[i * ld + j] = nkbx::to_f(row[c]);
    vs[i * ld + j] = nkbx::to_f(row[2 * c]);
  }
  __syncthreads();

  const float* bh = bias + static_cast<size_t>(min(h, bias_heads - 1)) * n * n;
  const float* mg = mask + static_cast<size_t>(g % m) * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx - i * n;
    const float* qi = qs + i * ld;
    const float* kj = ks + j * ld;
    float acc = 0.f;
    for (int t = 0; t < d; ++t) acc = fmaf(qi[t], kj[t], acc);
    ps[idx] = acc * scale + bh[idx] + mg[idx];
  }
  __syncthreads();

  // Row softmax in float, one warp per row; one reciprocal per row.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < n; i += kThreads / 32) {
    float* pr = ps + i * n;
    float mx = -3.402823466e38f;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pr[j]);
    mx = nkbx::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(pr[j] - mx);
      pr[j] = e;
      sum += e;
    }
    const float inv = 1.f / nkbx::warp_sum(sum);
    for (int j = lane; j < n; j += 32) pr[j] = nkbx::round_to<T>(pr[j] * inv);
  }
  __syncthreads();

  T* ob = out + static_cast<size_t>(g) * n * c + h * d;
  for (int idx = threadIdx.x; idx < n * d; idx += kThreads) {
    const int i = idx / d, j = idx - i * d;
    const float* pr = ps + i * n;
    float acc = 0.f;
    for (int t = 0; t < n; ++t) acc = fmaf(pr[t], vs[t * ld + j], acc);
    ob[static_cast<size_t>(i) * c + j] = nkbx::from_f<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* qkv, const void* bias, const void* mask, void* out, int g,
                   int n, int heads, int d, int bias_heads, int m, float scale,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(3 * n * (d + 1) + n * n) * sizeof(float);
  cudaError_t err = nkbx::allow_smem(window_attention_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  window_attention_kernel<T><<<static_cast<unsigned>(g) * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<T*>(out), n, heads, d, bias_heads, m,
      scale);
  return cudaGetLastError();
}

}  // namespace

// qkv (G, N, 3*H*D) and out (G, N, H*D) in float (is_bf16 = 0) or bf16;
// bias (bias_heads, N, N) and mask (M, N, N) in float. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int nkbx_window_attention(const void* qkv, const void* bias, const void* mask,
                                     void* out, int g, int n, int heads, int d,
                                     int bias_heads, int m, float scale, int is_bf16,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch<__nv_bfloat16>(qkv, bias, mask, out, g, n, heads, d, bias_heads, m,
                                      scale, s)
              : launch<float>(qkv, bias, mask, out, g, n, heads, d, bias_heads, m, scale, s));
}
