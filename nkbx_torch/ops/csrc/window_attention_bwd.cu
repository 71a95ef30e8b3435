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
// the card needs before its tensor cores are the limit. So the (N, N) P,
// dP and dS never reach device memory, q, k, v and go are read once and
// dqkv written once, and the dbias partial stays on chip across a block's
// windows. Both designs give a block one head and a run of `wpb`
// consecutive windows, one after the other, so that it sums its windows'
// dS in a fixed order (each element always by the same thread) into its
// own slice of a float partial buffer (heads, chunks, N, N); a second
// kernel sums the chunks, again in a fixed order: dbias is deterministic,
// with no atomics, and a second launch is bit-identical.
//
// Which inputs go where (the wrapper chooses by dtype and shape):
// - bf16 with D = 32 (every Swin) and N <= 144 (window 7: 49, window 12:
//   144): window_attention_bwd_tc, on the tensor cores. The window is
//   padded to KP = N rounded up to 16 rows and keys, one warp a 16-row
//   slab (4 warps at N = 49, 9 at N = 144). The next window's q, k, v and
//   go come through a 2-slot ring of 16-byte cp.async copies while this
//   one is multiplied. S = q K^T and dP = go V^T (once) are mma.sync
//   m16n8k16 fed by ldmatrix; scale, bias and mask are added in float
//   registers (read from L1/L2 at the fragment positions, all of a warp's
//   loads in flight together), row max, sum
//   and rowsum(dP o P) by quad shuffles, exp as the first design's expf;
//   padded rows and keys are zeros by selection, with no -inf arithmetic.
//   round(dS * scale), packed to bf16 in registers, is dQ's A fragments
//   (K by ldmatrix.trans). dV and dK sum over the rows of every warp, so
//   round(P) and then round(dS * scale) go through one shared bf16 tile,
//   and each warp takes 16 keys of dV = round(P)^T go and dK = round(dS *
//   scale)^T q (ldmatrix.trans). The dbias partial lives in shared memory
//   at the score fragments' positions, each thread its own float4s, and
//   is written once per block. 65 KB of shared memory at N = 49 (three
//   blocks an SM), 214 KB at N = 144 (one).
// - f32, bf16 with another head width or N > 144: the first design,
//   window_attention_bwd_kernel, unchanged: float FMAs on the CUDA cores,
//   q, k, v, go as float rows padded to D+1 and ONE (N, N) float buffer,
//   which holds P, then, row by row, round(dS * scale): dS[i, :] needs only
//   P[i, :] and dP[i, :] = go_i V^T, so no (N, N) dP buffer is kept. 159
//   KB at N=144 (window 12), D=32. Its dbias partial is read, added to and
//   written in device memory once per window.

#include <cfloat>

#include "dtype.cuh"
#include "mma.cuh"

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
// Both designs launch it; its name keeps the prefix a profile sums as K2.
__global__ void window_attention_bwd_reduce(const float* __restrict__ partial,
                                            float* __restrict__ dbias, int nn, int heads,
                                            int chunks, int bias_heads) {
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

cudaError_t reduce(const void* partial, void* dbias, int n, int heads, int chunks,
                   int bias_heads, cudaStream_t stream) {
  const dim3 grid((n * n + 255) / 256, bias_heads);
  window_attention_bwd_reduce<<<grid, 256, 0, stream>>>(static_cast<const float*>(partial),
                                                        static_cast<float*>(dbias), n * n,
                                                        heads, chunks, bias_heads);
  return cudaGetLastError();
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
  return reduce(partial, dbias, n, heads, chunks, bias_heads, stream);
}

// --- bf16, D = 32, N <= 144: the tensor-core design ----------------------------------

using bf16 = __nv_bfloat16;
using nkbx::acc_rows;
using nkbx::cp_async16;
using nkbx::dot_rows;
using nkbx::ldmatrix_x4_trans;
using nkbx::load_a;
using nkbx::pack_bf16;
using nkbx::quad_max;
using nkbx::quad_sum;
using nkbx::smem_addr;
using nkbx::store_rows;
constexpr int kTcD = 32;         // the head width it takes (every Swin's)
constexpr int kTcLd = kTcD + 8;  // row stride of the q, k, v, go tiles: 80 bytes

// A window padded to KP rows and keys (N rounded up to 16), one warp a
// 16-row slab. Shared memory: a 2-slot ring of the q, k, v and go tiles
// (KP, D+8) bf16; one (KP, KP+8) bf16 tile that holds round(P), then
// round(dS * scale); the block's dbias partial, KP*KP floats where the score
// fragments lie (each thread its own float4s). 65 KB at KP = 64 (three
// blocks an SM), 214 KB at KP = 144 (one).
template <int KP>
struct Tc {
  static constexpr int kWarps = KP / 16;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTile = KP * kTcLd * 2;
  static constexpr int kSlot = 4 * kTile;
  static constexpr int kPLd = KP + 8;  // an odd multiple of 4 words: ldmatrix without conflicts
  static constexpr int kPBytes = KP * kPLd * 2;
  static constexpr size_t kSmem = 2 * kSlot + kPBytes + static_cast<size_t>(4) * KP * KP;
};

// The A fragment of the transpose of a (rows, keys) tile of row stride ld:
// A[m][k] = tile[k0 + k][m0 + m] for m, k in 0 .. 15 (ldmatrix.trans).
__device__ __forceinline__ void load_a_trans(unsigned (&a)[4], unsigned tile, int ld, int k0,
                                             int m0) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
  ldmatrix_x4_trans(a, tile + ((k0 + (mi / 2) * 8 + lane % 8) * ld + m0 + (mi % 2) * 8) * 2);
}

// A warp's 16 x KP slab of packed bf16 A fragments (f[kc]: keys kc*16 ..
// kc*16 + 15, mma.cuh's layout) into the (KP, KP+8) tile at rows r0 .. r0 + 15.
template <int KP>
__device__ __forceinline__ void store_slab(unsigned char* tile, const unsigned (&f)[KP / 16][4],
                                           int r0) {
  const int lane = threadIdx.x % 32;
  const int row = r0 + lane / 4, col = (lane % 4) * 2;
#pragma unroll
  for (int kc = 0; kc < KP / 16; ++kc)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = row + (q % 2) * 8, k = kc * 16 + col + (q / 2) * 8;
      *reinterpret_cast<unsigned*>(tile + (r * Tc<KP>::kPLd + k) * 2) = f[kc][q];
    }
}

// A block owns one head and the windows g0 .. g1 - 1, one after the other;
// window g + 1's q, k, v and go tiles come in through the ring while window
// g is multiplied. Per window, each warp its 16 query rows: S = q K^T and dP
// = go V^T on the tensor cores; the scores, P and dS in float registers
// (row max, sum and rowsum(dP o P) by quad shuffles; a padded row or key is
// 0 by selection, whatever its bias and mask loads read); dS into the dbias
// partial; round(dS * scale) packed as dQ's A fragments, dQ += it K. Then
// round(P) through the shared tile, each warp its 16 keys of dV = round(P)^T
// go; then round(dS * scale) through the same tile, dK = round(dS * scale)^T q.
template <int KP>
__global__ void __launch_bounds__(Tc<KP>::kThreads, KP <= 64 ? 3 : 1)
window_attention_bwd_tc(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                        const float* __restrict__ mask, const bf16* __restrict__ go,
                        bf16* __restrict__ dqkv, float* __restrict__ partial, int g_total, int n,
                        int heads, int bias_heads, int m, float scale, int wpb) {
  using S = Tc<KP>;
  constexpr int D = kTcD, NC = KP / 16;  // NC chunks of 16 keys
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const unsigned ring = smem_addr(tc_smem), pt = ring + 2 * S::kSlot;
  unsigned char* ptile = tc_smem + 2 * S::kSlot;
  const int h = blockIdx.x % heads, chunk = blockIdx.x / heads;
  const int c = heads * D, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const float* bh = bias + static_cast<size_t>(min(h, bias_heads - 1)) * n * n;
  const int g0 = chunk * wpb, g1 = min(g0 + wpb, g_total);
  // this thread's dbias float4s: fragment (kc, nt) at my_dbias[(kc * 2 + nt) * 32]
  float4* my_dbias = reinterpret_cast<float4*>(ptile + S::kPBytes) + warp * 2 * NC * 32 + lane;

  auto issue = [&](int g) {  // window g's tiles into slot (g - g0) % 2
    if (g < g1) {
      const unsigned slot = ring + ((g - g0) % 2) * S::kSlot;
      const bf16* src = qkv + static_cast<size_t>(g) * n * 3 * c + h * D;
      auto copy = [&](unsigned dst, const bf16* from, int ld) {
        nkbx::copy_rows<KP, D, kTcLd, S::kThreads>(dst, from, ld, n);
      };
      copy(slot, src, 3 * c);
      copy(slot + S::kTile, src + c, 3 * c);
      copy(slot + 2 * S::kTile, src + 2 * c, 3 * c);
      copy(slot + 3 * S::kTile, go + static_cast<size_t>(g) * n * c + h * D, c);
    }
    nkbx::cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < 2 * NC; ++t) my_dbias[t * 32] = make_float4(0.f, 0.f, 0.f, 0.f);
  issue(g0);
  for (int g = g0; g < g1; ++g) {
    __syncthreads();  // window g - 1 no longer reads the slot refilled here, nor the P tile
    issue(g + 1);
    nkbx::cp_async_wait<1>();
    __syncthreads();
    const unsigned qs = ring + ((g - g0) % 2) * S::kSlot, ks = qs + S::kTile;
    const unsigned vs = ks + S::kTile, gs = vs + S::kTile;
    bf16* out = dqkv + static_cast<size_t>(g) * n * 3 * c + h * D;
    const float* mg = mask + static_cast<size_t>(g % m) * n * n;

    // 1. S and dP on the tensor cores; the scores in float.
    unsigned qf[D / 16][4], gf[D / 16][4];
    load_a<kTcLd>(qf, qs, r0);
    load_a<kTcLd>(gf, gs, r0);
    float s[NC][2][4], dp[NC][2][4];
#pragma unroll
    for (int kc = 0; kc < NC; ++kc) {
      dot_rows<kTcLd>(s[kc], qf, ks, kc * 16);
      dot_rows<kTcLd>(dp[kc], gf, vs, kc * 16);
    }
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int kc = 0; kc < NC; ++kc)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + lane / 4 + (e / 2) * 8;
          const int j = kc * 16 + nt * 8 + (lane % 4) * 2 + e % 2;
          const bool in = i < n && j < n;
          // a load for every element (padding reads element 0), selected after: the
          // loads issue together, where guarded loads ran one after the other
          const int idx = in ? i * n + j : 0;
          const float b = __ldg(bh + idx), mk = __ldg(mg + idx);
          const float x = in ? s[kc][nt][e] * scale + b + mk : -FLT_MAX;
          s[kc][nt][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }

    // 2. P = softmax (a padded row or key is 0 by selection), rowsum(dP o P).
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
    float inv[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float total = quad_sum(sum[hi]);
      inv[hi] = r0 + lane / 4 + hi * 8 < n ? 1.f / total : 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < NC; ++kc)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[kc][nt][e] *= inv[e / 2];
          rs[e / 2] = fmaf(dp[kc][nt][e], s[kc][nt][e], rs[e / 2]);
        }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) rs[hi] = quad_sum(rs[hi]);

    // 3. dS = P o (dP - rs) into the dbias partial (windows in order, each
    //    element always by this thread); round(dS * scale) as A fragments,
    //    dQ = round(dS * scale) K; round(P) packed for the tile.
    unsigned pf[NC][4], df[NC][4];
    float acc[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NC; ++kc) {
      float ds[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[nt][e] = s[kc][nt][e] * (dp[kc][nt][e] - rs[e / 2]);
        float4& a = my_dbias[(kc * 2 + nt) * 32];
        a.x += ds[nt][0];
        a.y += ds[nt][1];
        a.z += ds[nt][2];
        a.w += ds[nt][3];
      }
      df[kc][0] = pack_bf16(ds[0][0] * scale, ds[0][1] * scale);
      df[kc][1] = pack_bf16(ds[0][2] * scale, ds[0][3] * scale);
      df[kc][2] = pack_bf16(ds[1][0] * scale, ds[1][1] * scale);
      df[kc][3] = pack_bf16(ds[1][2] * scale, ds[1][3] * scale);
      pf[kc][0] = pack_bf16(s[kc][0][0], s[kc][0][1]);
      pf[kc][1] = pack_bf16(s[kc][0][2], s[kc][0][3]);
      pf[kc][2] = pack_bf16(s[kc][1][0], s[kc][1][1]);
      pf[kc][3] = pack_bf16(s[kc][1][2], s[kc][1][3]);
      acc_rows<kTcLd>(acc, df[kc], ks, kc * 16);
    }
    store_rows(out, acc, r0, n, 3 * c);

    // 4. dV = round(P)^T go, this warp's 16 keys, through the tile.
    store_slab<KP>(ptile, pf, r0);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int ic = 0; ic < NC; ++ic) {
      unsigned a[4];
      load_a_trans(a, pt, S::kPLd, ic * 16, r0);
      acc_rows<kTcLd>(acc, a, gs, ic * 16);
    }
    store_rows(out + 2 * c, acc, r0, n, 3 * c);
    __syncthreads();  // every warp has read round(P)

    // 5. dK = round(dS * scale)^T q, the same way.
    store_slab<KP>(ptile, df, r0);
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int ic = 0; ic < NC; ++ic) {
      unsigned a[4];
      load_a_trans(a, pt, S::kPLd, ic * 16, r0);
      acc_rows<kTcLd>(acc, a, qs, ic * 16);
    }
    store_rows(out + c, acc, r0, n, 3 * c);
  }
  nkbx::cp_async_wait<0>();

  // The block's dbias partial, written once: element (i, j) of its fragments.
  float* part = partial + (static_cast<size_t>(h) * (gridDim.x / heads) + chunk) * n * n;
#pragma unroll
  for (int t = 0; t < 2 * NC; ++t) {
    const float4 a = my_dbias[t * 32];
    const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = r0 + lane / 4 + (e / 2) * 8;
      const int j = (t / 2) * 16 + (t % 2) * 8 + (lane % 4) * 2 + e % 2;
      if (i < n && j < n) part[i * n + j] = v[e];
    }
  }
}

template <int KP>
cudaError_t launch_tc(const void* qkv, const void* bias, const void* mask, const void* go,
                      void* dqkv, void* dbias, void* partial, int g, int n, int heads,
                      int bias_heads, int m, float scale, int wpb, cudaStream_t stream) {
  cudaError_t err = nkbx::allow_smem(window_attention_bwd_tc<KP>, Tc<KP>::kSmem);
  if (err != cudaSuccess) return err;
  const int chunks = (g + wpb - 1) / wpb;
  window_attention_bwd_tc<KP><<<static_cast<unsigned>(chunks) * heads, Tc<KP>::kThreads,
                                Tc<KP>::kSmem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const bf16*>(go), static_cast<bf16*>(dqkv),
      static_cast<float*>(partial), g, n, heads, bias_heads, m, scale, wpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(partial, dbias, n, heads, chunks, bias_heads, stream);
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

// The tensor-core design: qkv, dqkv (G, N, 3*H*32) and go (G, N, H*32) in
// bf16, 1 <= N <= 144; the other operands as above. Returns the CUDA error
// code of the launches (0 on success; cudaErrorInvalidValue for a shape it
// does not take).
extern "C" int nkbx_window_attention_bwd_tc(const void* qkv, const void* bias, const void* mask,
                                            const void* go, void* dqkv, void* dbias,
                                            void* partial, int g, int n, int heads, int d,
                                            int bias_heads, int m, float scale,
                                            int windows_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != kTcD || n < 1 || n > 144) return static_cast<int>(cudaErrorInvalidValue);
#define NKBX_TC(KP)                                                                        \
  case KP / 16:                                                                            \
    return static_cast<int>(launch_tc<KP>(qkv, bias, mask, go, dqkv, dbias, partial, g, n, \
                                          heads, bias_heads, m, scale, windows_per_block, s))
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
