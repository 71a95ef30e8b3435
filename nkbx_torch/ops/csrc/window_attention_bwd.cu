// Packed-qkv window attention for Swin, backward.
//
// Replaces the Pallas kernel nkbx/ops/attention.py:313 `_bwd_kernel_packed`
// (the VJP of `fused_attention_qkv`). Per window g and head h, from the
// saved qkv, bias and mask and the cotangent go (G, N, H*D):
//   P  = softmax(q k^T * scale + bias[min(h, Hb-1)] + mask[g % M])  in float
//   dV = round(P)^T go                  (P rounded to the storage type T)
//   dP = go V^T;  dS = P o (dP - rowsum(dP o P))                     in float
//   dQ = round(dS * scale) K;  dK = round(dS * scale)^T Q
// every product accumulating in float, each output rounded once to T
// (attention.py:239-269). dQ, dK, dV land in the packed dqkv at lanes h*D,
// C + h*D and 2C + h*D. dbias = sum over windows of dS, in float.
//
// What bounds it on an H100: the bytes. A window reads 3*N*C + N*C values
// and writes 3*N*C; the five products are 10*N*N*D operations per head,
// about 30 operations per byte at N=49, D=32 in bf16, far under the ~295
// the card needs before its tensor cores are the limit. As in the forward,
// the (N, N) probabilities and score gradients live in shared memory only.
// This first version computes with float FMAs on the CUDA cores.
//
// Layout: a block takes one head and a run of `wpb` consecutive windows,
// one after the other, so that it can sum its windows' dS in a fixed order
// into its own slice of a float partial buffer (heads, chunks, N, N). A
// second kernel sums the chunks, again in a fixed order: dbias is
// deterministic, with no atomics. Shared memory: q, k, v, go as float rows
// padded to D+1 and ONE (N, N) float buffer, which holds P, then, row by
// row, round(dS * scale): dS[i, :] needs only P[i, :] and dP[i, :] = go_i V^T,
// so no (N, N) dP buffer is kept. 159 KB at N=144 (window 12), D=32.

#include "dtype.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_bwd_kernel(const T* __restrict__ qkv, const float* __restrict__ bias,
                            const float* __restrict__ mask, const T* __restrict__ go,
                            T* __restrict__ dqkv, float* __restrict__ partial, int g_total,
                            int n, int heads, int d, int bias_heads, int m, float scale,
                            int wpb) {
  extern __shared__ float smem[];
  const int h = blockIdx.x % heads;
  const int chunk = blockIdx.x / heads;
  const int c = heads * d;
  const int ld = d + 1;
  float* qs = smem;
  float* ks = qs + n * ld;
  float* vs = ks + n * ld;
  float* gs = vs + n * ld;
  float* ps = gs + n * ld;  // (n, n): P, then round(dS * scale)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* bh = bias + static_cast<size_t>(min(h, bias_heads - 1)) * n * n;
  float* part = partial + (static_cast<size_t>(h) * gridDim.x / heads + chunk) * n * n;

  const int g0 = chunk * wpb;
  const int g1 = min(g0 + wpb, g_total);
  for (int g = g0; g < g1; ++g) {
    const T* base = qkv + static_cast<size_t>(g) * n * 3 * c + h * d;
    const T* gbase = go + static_cast<size_t>(g) * n * c + h * d;
    for (int idx = threadIdx.x; idx < n * d; idx += kThreads) {
      const int i = idx / d, j = idx - i * d;
      const T* row = base + static_cast<size_t>(i) * 3 * c + j;
      qs[i * ld + j] = nkbx::to_f(row[0]);
      ks[i * ld + j] = nkbx::to_f(row[c]);
      vs[i * ld + j] = nkbx::to_f(row[2 * c]);
      gs[i * ld + j] = nkbx::to_f(gbase[static_cast<size_t>(i) * c + j]);
    }
    __syncthreads();

    // 1. Scores, then the row softmax in float (the forward's arithmetic).
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
    for (int i = warp; i < n; i += kWarps) {
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
      for (int j = lane; j < n; j += 32) pr[j] *= inv;
    }
    __syncthreads();

    // 2. dV = round(P)^T go.
    T* out = dqkv + static_cast<size_t>(g) * n * 3 * c + h * d;
    for (int idx = threadIdx.x; idx < n * d; idx += kThreads) {
      const int j = idx / d, t = idx - j * d;
      float acc = 0.f;
      for (int i = 0; i < n; ++i) acc = fmaf(nkbx::round_to<T>(ps[i * n + j]), gs[i * ld + t], acc);
      out[static_cast<size_t>(j) * 3 * c + 2 * c + t] = nkbx::from_f<T>(acc);
    }
    __syncthreads();  // every P column is read before the rows are overwritten

    // 3. One warp per row: dP[i, :] = go_i V^T, dS = P o (dP - rowsum(dP o P)),
    //    dS into this block's dbias partial (each element always by the same
    //    thread, windows in order), round(dS * scale) over P[i, :].
    for (int i = warp; i < n; i += kWarps) {
      float* pr = ps + i * n;
      const float* gi = gs + i * ld;
      float rs = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float* vj = vs + j * ld;
        float dp = 0.f;
        for (int t = 0; t < d; ++t) dp = fmaf(gi[t], vj[t], dp);
        rs = fmaf(dp, pr[j], rs);
      }
      rs = nkbx::warp_sum(rs);
      for (int j = lane; j < n; j += 32) {
        const float* vj = vs + j * ld;
        float dp = 0.f;
        for (int t = 0; t < d; ++t) dp = fmaf(gi[t], vj[t], dp);
        const float ds = pr[j] * (dp - rs);
        const int e = i * n + j;
        part[e] = g == g0 ? ds : part[e] + ds;
        pr[j] = nkbx::round_to<T>(ds * scale);
      }
    }
    __syncthreads();

    // 4. dQ = dSc K and dK = dSc^T Q.
    for (int idx = threadIdx.x; idx < n * d; idx += kThreads) {
      const int i = idx / d, t = idx - i * d;
      float aq = 0.f, ak = 0.f;
      for (int j = 0; j < n; ++j) {
        aq = fmaf(ps[i * n + j], ks[j * ld + t], aq);
        ak = fmaf(ps[j * n + i], qs[j * ld + t], ak);
      }
      T* row = out + static_cast<size_t>(i) * 3 * c + t;
      row[0] = nkbx::from_f<T>(aq);
      row[c] = nkbx::from_f<T>(ak);
    }
    __syncthreads();  // before the next window overwrites q, k, v, go and P
  }
}

// dbias[hb, e] = sum over (head, chunk) of partial, in a fixed order: the
// chunks of head hb, or of every head when the bias is shared (Hb = 1).
__global__ void dbias_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dbias,
                                    int nn, int heads, int chunks, int bias_heads) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int hb = blockIdx.y;
  if (e >= nn) return;
  const int h0 = bias_heads == 1 ? 0 : hb;
  const int h1 = bias_heads == 1 ? heads : hb + 1;
  float acc = 0.f;
  for (int h = h0; h < h1; ++h) {
    const float* p = partial + static_cast<size_t>(h) * chunks * nn + e;
    for (int k = 0; k < chunks; ++k) acc += p[static_cast<size_t>(k) * nn];
  }
  dbias[static_cast<size_t>(hb) * nn + e] = acc;
}

template <typename T>
cudaError_t launch(const void* qkv, const void* bias, const void* mask, const void* go,
                   void* dqkv, void* dbias, void* partial, int g, int n, int heads, int d,
                   int bias_heads, int m, float scale, int wpb, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(4 * n * (d + 1) + n * n) * sizeof(float);
  cudaError_t err = nkbx::allow_smem(window_attention_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int chunks = (g + wpb - 1) / wpb;
  window_attention_bwd_kernel<T><<<static_cast<unsigned>(chunks) * heads, kThreads, smem,
                                   stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const T*>(go), static_cast<T*>(dqkv),
      static_cast<float*>(partial), g, n, heads, d, bias_heads, m, scale, wpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((n * n + 255) / 256, bias_heads);
  dbias_reduce_kernel<<<grid, 256, 0, stream>>>(static_cast<const float*>(partial),
                                                static_cast<float*>(dbias), n * n, heads,
                                                chunks, bias_heads);
  return cudaGetLastError();
}

}  // namespace

// qkv, dqkv (G, N, 3*H*D) and go (G, N, H*D) in float (is_bf16 = 0) or bf16;
// bias (bias_heads, N, N), mask (M, N, N), dbias (bias_heads, N, N) and the
// scratch partial (H, ceil(G / windows_per_block), N, N) in float. Returns the
// CUDA error code of the launches (0 on success).
extern "C" int nkbx_window_attention_bwd(const void* qkv, const void* bias, const void* mask,
                                         const void* go, void* dqkv, void* dbias,
                                         void* partial, int g, int n, int heads, int d,
                                         int bias_heads, int m, float scale,
                                         int windows_per_block, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_bf16 ? launch<__nv_bfloat16>(qkv, bias, mask, go, dqkv, dbias, partial, g, n, heads,
                                      d, bias_heads, m, scale, windows_per_block, s)
              : launch<float>(qkv, bias, mask, go, dqkv, dbias, partial, g, n, heads, d,
                              bias_heads, m, scale, windows_per_block, s));
}
