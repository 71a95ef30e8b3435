// Packed-qkv window attention for Swin, forward only.
//
// Replaces the Pallas kernel nkbx/ops/attention.py:302 `_fwd_kernel_packed`
// (entry `fused_attention_qkv`). Per window g and head h it computes
//   o = softmax(q k^T * scale + bias[min(h, Hb-1)] + mask[g % M]) v
// from the qkv Dense output (G, N, 3*H*D), whose minor dim factors as
// (3, H, D): q of head h sits at lane h*D, k at C + h*D, v at 2C + h*D
// (C = H*D). The output is written head-major into (G, N, C). Scores and the
// softmax stay in float; P is normalised, then rounded to the storage type
// before P*V, and P*V accumulates in float, as attention.py:233-236 does.
//
// What bounds it on an H100: the bytes. Each window reads 3*N*C values and
// writes N*C; the two products are 4*N*N*D operations per head, about 25
// operations per byte at N=49, D=32 in bf16, far under the ~295 the card
// needs before its tensor cores are the limit. So the (N, N) scores and
// probabilities never reach device memory: device traffic is qkv in, o out,
// plus the small bias and mask planes, which blocks read from L1/L2.
//
// Which inputs go where (the wrapper chooses by dtype and shape, as for the
// backward):
// - bf16 with D = 32 (every Swin) and N <= 144 (window 7: 49, window 12:
//   144): window_attention_tc, on the tensor cores. A block takes one head
//   and a run of windows in the order of their mask index, the runs sized
//   so that the blocks fill the card's resident slots about once. The
//   window is padded to KP = N rounded up to 16 rows and keys, one warp a
//   16-row slab (4 warps at N = 49, 9 at N = 144). The next window's q, k
//   and v tiles (KP, D+8) come through a 2-slot ring of 16-byte cp.async
//   copies (padded rows zero-filled) while this one is multiplied. S = q K^T
//   is mma.sync m16n8k16 fed by ldmatrix. bias + mask at the thread's
//   fragment positions (loaded at a clamped index, so that all of a warp's
//   loads are in flight together) stays in float registers while the run's
//   windows share a mask: reading both planes at every window took 57% of
//   the time at Swin-T's stage 0 (PERF.md, PR 12). Scores are s * scale +
//   (bias + mask), a float rounding order other than the plain version's
//   (s * scale + bias) + mask. Padded keys are zeros by selection, with no
//   -inf arithmetic. Row max and sum by quad shuffles,
//   exp as the first design's expf, one reciprocal a row; P times it is
//   rounded to bf16 in registers, and two adjacent n-tiles of S are the A
//   fragment of one k-step of P V (V by ldmatrix.trans), so P never goes to
//   shared memory. O (16 x 32 float a warp) is rounded to bf16 through the
//   warp's own q rows of the ring slot and leaves as 16-byte stores. Shared
//   memory is the ring alone: 30 KB at N = 49, 68 KB at N = 144.
// - f32, bf16 with another head width or N > 144: the first design,
//   window_attention_kernel, unchanged: one block per (window, head), float
//   FMAs on the CUDA cores, q, k, v as float rows padded to D+1 (so the
//   threads of a warp that walk different rows hit different banks) and the
//   (N, N) float scores in shared memory: 29 KB at N=49, D=32 and 140 KB at
//   N=144 (window 12), which needs the raised dynamic shared-memory limit.

#include <cfloat>

#include "dtype.cuh"
#include "mma.cuh"

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


// --- bf16, D = 32, N <= 144: the tensor-core design ----------------------------------

using bf16 = __nv_bfloat16;
using nkbx::acc_rows;
using nkbx::dot_rows;
using nkbx::load_a;
using nkbx::pack_bf16;
using nkbx::quad_max;
using nkbx::quad_sum;
constexpr int kTcD = 32;         // the head width it takes (every Swin's)
constexpr int kTcLd = kTcD + 8;  // row stride of the q, k, v tiles: 80 bytes

// A window padded to KP rows and keys (N rounded up to 16), one warp a
// 16-row slab; shared memory is a 2-slot ring of the q, k, v tiles (KP, D+8)
// bf16. kBlocks is the blocks an SM its launch bounds promise, and the
// wrapper's (attention.py, fwd_tc_blocks_per_sm) to size the runs of windows:
// four of 4 warps (128 registers a thread) at KP <= 64; one above, where
// the scores and bias + mask alone take KP registers a thread (at KP = 144
// the 9 warps put three on a scheduler, which caps a thread at 168).
template <int KP>
struct Tc {
  static constexpr int kWarps = KP / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlocks = KP <= 64 ? 4 : 1;
  static constexpr int kTile = KP * kTcLd * 2;
  static constexpr int kSlot = 3 * kTile;
  static constexpr int kSmem = 2 * kSlot;
};

// A block owns one head and a run of windows, one after the other, taken in
// the order of their mask index: u = (g % M) * (G / M) + g / M, the block's
// run u0 .. u1 - 1. So a run's windows share one mask (or two where it
// crosses an index), and bias[h] + mask[g % M] at this thread's fragment
// positions stays in registers until the index changes: no window but the
// first of a mask reads either plane. Window u + 1's q, k and v tiles come
// in through the ring while window u is multiplied. Per window, each warp
// its 16 query rows: S = q K^T on the tensor cores; the scores and P in
// float registers (row max and sum by quad shuffles; a padded key is 0 by
// selection, whatever its bias and mask loads read); round(P) packed as A
// fragments, O = round(P) V; O staged in the warp's q rows and stored 16
// bytes a lane, rows at or past N skipped.
template <int KP>
__global__ void __launch_bounds__(Tc<KP>::kThreads, Tc<KP>::kBlocks)
window_attention_tc(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                    const float* __restrict__ mask, bf16* __restrict__ out, int g_total, int n,
                    int heads, int bias_heads, int m, float scale, int wpb) {
  using S = Tc<KP>;
  constexpr int D = kTcD, NC = KP / 16;  // NC chunks of 16 keys
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const unsigned ring = nkbx::smem_addr(tc_smem);
  const int h = blockIdx.x % heads, chunk = blockIdx.x / heads;
  const int c = heads * D, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const float* bh = bias + static_cast<size_t>(min(h, bias_heads - 1)) * n * n;
  const int per = g_total / m;  // windows of each mask index (the wrapper checks G % M == 0)
  const int u0 = chunk * wpb, u1 = min(u0 + wpb, g_total);
  auto window = [&](int u) { return u / per + m * (u % per); };

  auto issue = [&](int u) {  // window u's tiles into slot (u - u0) % 2
    if (u < u1) {
      const unsigned slot = ring + ((u - u0) % 2) * S::kSlot;
      const bf16* src = qkv + static_cast<size_t>(window(u)) * n * 3 * c + h * D;
#pragma unroll
      for (int t = 0; t < 3; ++t)
        nkbx::copy_rows<KP, D, kTcLd, S::kThreads>(slot + t * S::kTile, src + t * c, 3 * c, n);
    }
    nkbx::cp_async_commit();
  };

  float bm[NC][2][4];  // bias + mask of mask index r at this thread's score positions
  int r = -1;
  issue(u0);
  for (int u = u0; u < u1; ++u) {
    __syncthreads();  // window u - 1 no longer reads the slot refilled here
    issue(u + 1);
    if (u / per != r) {  // the block's first window of a mask index: both planes read
      r = u / per;
      const float* mr = mask + static_cast<size_t>(r) * n * n;
#pragma unroll
      for (int kc = 0; kc < NC; ++kc)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = r0 + lane / 4 + (e / 2) * 8;
            const int j = kc * 16 + nt * 8 + (lane % 4) * 2 + e % 2;
            // a load for every element (padding reads element 0): the loads issue
            // together, where guarded loads run one after the other
            const int idx = i < n && j < n ? i * n + j : 0;
            bm[kc][nt][e] = __ldg(bh + idx) + __ldg(mr + idx);
          }
    }
    nkbx::cp_async_wait<1>();
    __syncthreads();
    const int g = window(u), slot = ((u - u0) % 2) * S::kSlot;
    const unsigned qs = ring + slot, ks = qs + S::kTile, vs = ks + S::kTile;

    // 1. S on the tensor cores; the scores in float.
    unsigned qf[D / 16][4];
    load_a<kTcLd>(qf, qs, r0);
    float s[NC][2][4];
#pragma unroll
    for (int kc = 0; kc < NC; ++kc) dot_rows<kTcLd>(s[kc], qf, ks, kc * 16);
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int kc = 0; kc < NC; ++kc)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + lane / 4 + (e / 2) * 8;
          const int j = kc * 16 + nt * 8 + (lane % 4) * 2 + e % 2;
          const float x = i < n && j < n ? s[kc][nt][e] * scale + bm[kc][nt][e] : -FLT_MAX;
          s[kc][nt][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }

    // 2. The row softmax: exp, then one reciprocal a row (a padded key is 0).
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) mx[hi] = quad_max(mx[hi]);
#pragma unroll
    for (int kc = 0; kc < NC; ++kc)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kc * 16 + nt * 8 + (lane % 4) * 2 + e % 2;
          const float ex = j < n ? expf(s[kc][nt][e] - mx[e / 2]) : 0.f;
          s[kc][nt][e] = ex;
          sum[e / 2] += ex;
        }
    float inv[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) inv[hi] = 1.f / quad_sum(sum[hi]);

    // 3. round(P) as the A fragment of keys kc*16 .. kc*16 + 15; O += it V.
    float acc[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NC; ++kc) {
      unsigned pf[4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        pf[2 * nt] = pack_bf16(s[kc][nt][0] * inv[0], s[kc][nt][1] * inv[0]);
        pf[2 * nt + 1] = pack_bf16(s[kc][nt][2] * inv[1], s[kc][nt][3] * inv[1]);
      }
      acc_rows<kTcLd>(acc, pf, vs, kc * 16);
    }

    // 4. O rounded to bf16 into this warp's 16 q rows of the slot (no other
    //    warp reads them, and the slot is refilled only after the next
    //    window's first barrier), then 16-byte stores of rows below N.
    unsigned char* stage = tc_smem + slot + r0 * kTcLd * 2;
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        *reinterpret_cast<unsigned*>(stage + ((lane / 4 + hi * 8) * kTcLd + nt * 8 +
                                              (lane % 4) * 2) * 2) =
            pack_bf16(acc[nt][2 * hi], acc[nt][2 * hi + 1]);
    __syncwarp();
    bf16* ob = out + static_cast<size_t>(g) * n * c + h * D;
#pragma unroll
    for (int t = lane; t < 16 * D / 8; t += 32) {
      const int r = t / (D / 8), ch = t % (D / 8);
      if (r0 + r < n)
        *reinterpret_cast<uint4*>(ob + static_cast<size_t>(r0 + r) * c + ch * 8) =
            *reinterpret_cast<const uint4*>(stage + (r * kTcLd + ch * 8) * 2);
    }
  }
  nkbx::cp_async_wait<0>();
}

template <int KP>
cudaError_t launch_tc(const void* qkv, const void* bias, const void* mask, void* out, int g,
                      int n, int heads, int bias_heads, int m, float scale, int wpb,
                      cudaStream_t stream) {
  cudaError_t err = nkbx::allow_smem(window_attention_tc<KP>, Tc<KP>::kSmem);
  if (err != cudaSuccess) return err;
  const int chunks = (g + wpb - 1) / wpb;
  window_attention_tc<KP><<<static_cast<unsigned>(chunks) * heads, Tc<KP>::kThreads,
                            Tc<KP>::kSmem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(out), g, n, heads, bias_heads, m,
      scale, wpb);
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

// The tensor-core design: qkv (G, N, 3*H*32) and out (G, N, H*32) in bf16,
// 1 <= N <= 144; bias and mask as above; a block takes windows_per_block
// consecutive windows of one head. Returns the CUDA error code of the launch
// (0 on success; cudaErrorInvalidValue for a shape it does not take).
extern "C" int nkbx_window_attention_tc(const void* qkv, const void* bias, const void* mask,
                                        void* out, int g, int n, int heads, int d,
                                        int bias_heads, int m, float scale,
                                        int windows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != kTcD || n < 1 || n > 144 || windows_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define NKBX_TC(KP)                                                                      \
  case KP / 16:                                                                          \
    return static_cast<int>(launch_tc<KP>(qkv, bias, mask, out, g, n, heads, bias_heads, \
                                          m, scale, windows_per_block, s))
  switch ((n + 15) / 16) {
    NKBX_TC(16);
    NKBX_TC(32);
    NKBX_TC(48);
    NKBX_TC(64);
    NKBX_TC(80);
    NKBX_TC(96);
    NKBX_TC(112);
    NKBX_TC(128);
    NKBX_TC(144);
  }
#undef NKBX_TC
  return static_cast<int>(cudaErrorInvalidValue);
}
