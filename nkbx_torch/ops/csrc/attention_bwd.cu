// Full-sequence attention on separate q, k, v (the ViT family), backward.
//
// Replaces the Pallas kernel nkbx/ops/attention.py:285 `_bwd_kernel_sep`
// (the VJP of `fused_attention`). Per group g and head h, from the saved q,
// k, v, bias and mask and the cotangent go, all (G, N, H*D) with D = 64:
//   P  = softmax(q k^T * scale + bias[min(h, Hb-1)] + mask[g % M])  in float
//   dV = round(P)^T go                  (P rounded to the storage type T)
//   dP = go V^T;  dS = P o (dP - rowsum(dP o P))                     in float
//   dQ = round(dS * scale) K;  dK = round(dS * scale)^T Q
// every product accumulating in float, each output rounded once to T
// (attention.py:239-269). dbias = sum over groups of dS (also over heads
// when the bias is shared), in float, only when asked for. A null bias or
// mask adds nothing and is never read (the ViT's zeros).
//
// What bounds it on an H100: at ViT-B/16 (N = 197) a (g, h) reads 4*N*D and
// writes 3*N*D values for 10*N*N*D operations (five products), about 280
// operations per byte in bf16: at the ridge of the card, so the products
// run on the tensor cores. The (N, N) P, dP and dS never reach device
// memory. dK and dV sum over every query row, and dQ over every key, so
// each output has a kernel of its own that recomputes P from the same score
// products: a rows kernel (dQ and the per-row statistics max, 1/sum and
// rs = rowsum(dP o P), 3*G*H*Np floats, Np = N rounded up to 64) and then a
// cols kernel (dK, dV) that reads them. No atomics: each output element is
// written once by one thread, and a second launch is bit-identical.
//
// Which operands go where:
// - bf16 with a null bias and mask (the ViT's path): the tensor-core pair
//   attention_bwd_rows_tc / attention_bwd_cols_tc below. Its rs is taken
//   online as sum(exp(s - max) dP) / sum(exp(s - max)), equal to nkbx's
//   rowsum(dP o P) in exact arithmetic but summed in another float order.
//   It does 9 N*N*D-sized products for the function's 5 (S twice in the
//   rows kernel, once more in the cols kernel; dP likewise), and buys with
//   them what bound the first design: no score row in shared memory, no
//   bias or mask plane read, K and V read twice per 64 query rows (the
//   first design: K twice and V once per 16), and every copy in flight
//   behind products. The products are
//   mma.sync m16n8k16 (bf16 in, float accumulate) fed by ldmatrix (.trans
//   where the tile's rows are the product's depth); exp is the
//   special-function unit's 2^x. 4 warps a block, 16 rows or keys a warp,
//   three blocks an SM (73.7 and 76.0 KB of shared memory whatever N is).
//   - rows_tc: a block owns 64 query rows of one (g, h), their q and go
//     fragments in registers. K and V stream in 64-key tiles, a K and a V
//     tile a step, through a 3-slot cp.async ring two steps ahead of the one
//     multiplied. Pass 1: S = q K^T and dP = go V^T; a running max, sum of
//     exp(s - max) and sum of exp(s - max) dP, rescaled online, give the
//     statistics. Pass 2: S and dP again 16 keys at a time, P and dS in
//     float registers, round(dS * scale) as the A fragments of dQ +=
//     round(dS * scale) K; dQ rounded once.
//   - cols_tc: a block owns 64 keys of one (g, h), their K and V fragments
//     in registers, and walks the queries in 64-row tiles of q, go and the
//     three statistics through the same kind of ring. Per 16 query rows:
//     S^T = K q^T, dP^T = V go^T, P^T from the statistics, dS^T; dV +=
//     round(P^T) go and dK += round(dS^T * scale) q in float registers,
//     each rounded once at the end. Query rows past N read statistics that
//     were never written and contribute zeros by selection.
// - f32, a given bias or mask (the zeros yardstick, a frozen learned
//   bias), and dbias: the first design, rows and cols kernels on warp-level
//   16x16 tiles (bf16 WMMA, float FMAs through attention_tile.cuh), kept as
//   K3's f32 kernel was. rows: a block owns 16 query rows of one head and a
//   run of `wpb` groups, holds their whole float P and dP rows in shared
//   memory (streaming K and V in 64-key tiles, loaded without overlap),
//   reads the bias and mask at every score, forms dS and dQ and writes the
//   statistics. With dbias it sums the groups' dS rows, each element always
//   by the same thread in group order, into its own slice of a float partial
//   buffer (heads, chunks, N, N); a third kernel sums the slices in a fixed
//   order. Without dbias a block takes one group. cols: a block owns 64 keys
//   of one (g, h), holds their K and V tiles and dK, dV accumulators, and
//   walks the queries in 32-row tiles, staging P and dS through shared
//   memory.

#include <cfloat>

#include "attention_tile.cuh"
#include "mma.cuh"

namespace {

using nkbx::ColMajor;
using nkbx::RowMajor;
using nkbx::WarpTile;
constexpr int D = nkbx::kHeadDim;
constexpr int kLd = nkbx::kLdTile;
constexpr int kTk = nkbx::kKeyTile;
constexpr int kThreads = nkbx::kAttnThreads;
constexpr int kWarps = nkbx::kAttnWarps;
constexpr int kRowsA = 16;  // query rows per block of the rows kernel
constexpr int kRowsB = 32;  // query rows per step of the cols kernel
constexpr int kLdB = kTk + 4;  // float row stride of the cols kernel's tiles

// Rows kernel: q, go (16, D+8) T | k, v tiles (64, D+8) T | P and dP rows
// (16, Np+4) float each | round(dS*scale) rows (16, Np+8) T.
template <typename T>
size_t rows_smem_bytes(int n) {
  const int np = nkbx::padded_keys(n);
  return 2 * nkbx::align128(kRowsA * kLd * sizeof(T)) +
         2 * nkbx::align128(kTk * kLd * sizeof(T)) +
         2 * nkbx::align128(static_cast<size_t>(kRowsA) * (np + 4) * 4) +
         nkbx::align128(static_cast<size_t>(kRowsA) * (np + 8) * sizeof(T));
}

// Cols kernel: k, v (64, D+8) T | q, go (32, D+8) T | s and dP tiles
// (32, 64+4) float each, contiguous, which also stage the (64, 64+4) float
// outputs | round(P) and round(dS*scale) tiles (32, D+8) T | statistics.
template <typename T>
size_t cols_smem_bytes() {
  return 2 * nkbx::align128(kTk * kLd * sizeof(T)) +
         2 * nkbx::align128(kRowsB * kLd * sizeof(T)) + nkbx::align128(2 * kRowsB * kLdB * 4) +
         2 * nkbx::align128(kRowsB * kLd * sizeof(T)) + nkbx::align128(3 * kRowsB * 4);
}

struct Stats {
  float* max;  // (G, H, Np), Np = N rounded up to 64: the row maximum of the scores
  float* inv;  // the reciprocal of the row sum of exp(s - max)
  float* rs;   // rowsum(dP o P)
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ bias,
                          const float* __restrict__ mask, const T* __restrict__ go,
                          T* __restrict__ dq, Stats stats, float* __restrict__ partial,
                          int g_total, int n, int heads, int bias_heads, int m, int sld,
                          float scale, int wpb) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int np = nkbx::padded_keys(n), lds = np + 4, ldp = np + 8;
  const int i0 = blockIdx.x * kRowsA, h = blockIdx.y, chunk = blockIdx.z;
  const int c = heads * D;
  unsigned char* p = smem;
  auto carve = [&p](size_t bytes) {
    unsigned char* r = p;
    p += nkbx::align128(bytes);
    return r;
  };
  T* qs = reinterpret_cast<T*>(carve(kRowsA * kLd * sizeof(T)));
  T* gs = reinterpret_cast<T*>(carve(kRowsA * kLd * sizeof(T)));
  T* ks = reinterpret_cast<T*>(carve(kTk * kLd * sizeof(T)));
  T* vs = reinterpret_cast<T*>(carve(kTk * kLd * sizeof(T)));
  float* ps = reinterpret_cast<float*>(carve(static_cast<size_t>(kRowsA) * lds * 4));
  float* dps = reinterpret_cast<float*>(carve(static_cast<size_t>(kRowsA) * lds * 4));
  T* dss = reinterpret_cast<T*>(carve(static_cast<size_t>(kRowsA) * ldp * sizeof(T)));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* bh = bias ? bias + static_cast<size_t>(min(h, bias_heads - 1)) * n * n : nullptr;
  float* part = partial == nullptr
                    ? nullptr
                    : partial + (static_cast<size_t>(h) * gridDim.z + chunk) * n * n;

  const int g0 = chunk * wpb, g1 = min(g0 + wpb, g_total);
  for (int g = g0; g < g1; ++g) {
    const size_t head0 = static_cast<size_t>(g) * n * c + h * D;
    __syncthreads();  // the previous group is written out
    nkbx::load_rows(qs, q + head0, c, i0, kRowsA, n);
    nkbx::load_rows(gs, go + head0, c, i0, kRowsA, n);

    // 1. Raw scores q k^T and dP = go v^T, one 64-key tile at a time; warp w
    //    owns key columns 16w .. 16w+15 of each tile.
    for (int j0 = 0; j0 < np; j0 += kTk) {
      __syncthreads();
      nkbx::load_rows(ks, k + head0, c, j0, kTk, n);
      nkbx::load_rows(vs, v + head0, c, j0, kTk, n);
      __syncthreads();
      WarpTile<T> t;
      t.zero();
      t.template mma<RowMajor, ColMajor>(qs, kLd, ks + warp * 16 * kLd, kLd, D);
      t.store(ps + j0 + warp * 16, lds);
      t.zero();
      t.template mma<RowMajor, ColMajor>(gs, kLd, vs + warp * 16 * kLd, kLd, D);
      t.store(dps + j0 + warp * 16, lds);
    }
    __syncthreads();

    // 2. One warp per row: P (the forward's arithmetic), rowsum(dP o P), dS,
    //    its partial dbias sum, round(dS * scale), and the row statistics.
    const float* mg = mask ? mask + static_cast<size_t>(g % m) * n * n : nullptr;
    for (int r = warp; r < kRowsA; r += kWarps) {
      const int i = i0 + r;
      float* pr = ps + r * lds;
      const float* dpr = dps + r * lds;
      T* dsr = dss + r * ldp;
      if (i >= n) {
        for (int j = lane; j < np; j += 32) dsr[j] = nkbx::from_f<T>(0.f);
        continue;
      }
      const float* bi = bh ? bh + static_cast<size_t>(i) * n : nullptr;
      const float* mi = mg ? mg + static_cast<size_t>(i) * n : nullptr;
      float mx = -FLT_MAX;
      for (int j = lane; j < n; j += 32) {
        float s = pr[j] * scale;
        if (bi) s += bi[j];
        if (mi) s += mi[j];
        pr[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = nkbx::warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(pr[j] - mx);
        pr[j] = e;
        sum += e;
      }
      const float inv = 1.f / nkbx::warp_sum(sum);
      float rs = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float pj = pr[j] * inv;
        pr[j] = pj;
        rs = fmaf(dpr[j], pj, rs);
      }
      rs = nkbx::warp_sum(rs);
      float* prt = part == nullptr ? nullptr : part + static_cast<size_t>(i) * n;
      for (int j = lane; j < np; j += 32) {
        float ds = 0.f;
        if (j < n) {
          ds = pr[j] * (dpr[j] - rs);
          if (prt != nullptr) prt[j] = g == g0 ? ds : prt[j] + ds;
        }
        dsr[j] = nkbx::from_f<T>(ds * scale);
      }
      if (lane == 0) {
        const size_t row = (static_cast<size_t>(g) * heads + h) * sld + i;
        stats.max[row] = mx;
        stats.inv[row] = inv;
        stats.rs[row] = rs;
      }
    }

    // 3. dQ = round(dS * scale) K, one 64-key tile at a time; warp w owns
    //    head columns 16w .. 16w+15.
    WarpTile<T> acc;
    acc.zero();
    for (int j0 = 0; j0 < np; j0 += kTk) {
      __syncthreads();  // dS is complete; the previous key tile is consumed
      nkbx::load_rows(ks, k + head0, c, j0, kTk, n);
      __syncthreads();
      acc.template mma<RowMajor, RowMajor>(dss + j0, ldp, ks + warp * 16, kLd, kTk);
    }
    __syncthreads();  // every warp is done with the P rows
    acc.store(ps + warp * 16, lds);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kRowsA * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      if (i0 + r < n) {
        dq[head0 + static_cast<size_t>(i0 + r) * c + d] = nkbx::from_f<T>(ps[r * lds + d]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ bias,
                          const float* __restrict__ mask, const T* __restrict__ go,
                          T* __restrict__ dk, T* __restrict__ dv, Stats stats, int n, int heads,
                          int bias_heads, int m, int sld, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int j0 = blockIdx.x * kTk, h = blockIdx.y, g = blockIdx.z;
  const int c = heads * D;
  unsigned char* p = smem;
  auto carve = [&p](size_t bytes) {
    unsigned char* r = p;
    p += nkbx::align128(bytes);
    return r;
  };
  T* ks = reinterpret_cast<T*>(carve(kTk * kLd * sizeof(T)));
  T* vs = reinterpret_cast<T*>(carve(kTk * kLd * sizeof(T)));
  T* qs = reinterpret_cast<T*>(carve(kRowsB * kLd * sizeof(T)));
  T* gs = reinterpret_cast<T*>(carve(kRowsB * kLd * sizeof(T)));
  float* ss = reinterpret_cast<float*>(carve(2 * kRowsB * kLdB * 4));
  float* dps = ss + kRowsB * kLdB;
  T* pt = reinterpret_cast<T*>(carve(kRowsB * kLd * sizeof(T)));
  T* dst = reinterpret_cast<T*>(carve(kRowsB * kLd * sizeof(T)));
  float* st = reinterpret_cast<float*>(carve(3 * kRowsB * 4));
  const size_t head0 = static_cast<size_t>(g) * n * c + h * D;
  const size_t row0 = (static_cast<size_t>(g) * heads + h) * sld;
  const float* bh = bias ? bias + static_cast<size_t>(min(h, bias_heads - 1)) * n * n : nullptr;
  const float* mg = mask ? mask + static_cast<size_t>(g % m) * n * n : nullptr;
  const int warp = threadIdx.x / 32;

  nkbx::load_rows(ks, k + head0, c, j0, kTk, n);
  nkbx::load_rows(vs, v + head0, c, j0, kTk, n);
  // warp w owns keys j0 + 16w .. +15, all D columns of dK and of dV
  constexpr int kDf = D / 16;
  WarpTile<T> dk_acc[kDf], dv_acc[kDf];
#pragma unroll
  for (int t = 0; t < kDf; ++t) {
    dk_acc[t].zero();
    dv_acc[t].zero();
  }
  for (int i0 = 0; i0 < n; i0 += kRowsB) {
    __syncthreads();  // the previous query tile is consumed
    nkbx::load_rows(qs, q + head0, c, i0, kRowsB, n);
    nkbx::load_rows(gs, go + head0, c, i0, kRowsB, n);
    for (int r = threadIdx.x; r < kRowsB; r += kThreads) {
      const bool in = i0 + r < n;
      st[r] = in ? stats.max[row0 + i0 + r] : 0.f;
      st[kRowsB + r] = in ? stats.inv[row0 + i0 + r] : 0.f;
      st[2 * kRowsB + r] = in ? stats.rs[row0 + i0 + r] : 0.f;
    }
    __syncthreads();
    // raw scores and dP of the (32, 64) tile: 2 x 4 warp tiles each
    for (int f = warp; f < (kRowsB / 16) * (kTk / 16); f += kWarps) {
      const int rf = f / (kTk / 16), cf = f % (kTk / 16);
      WarpTile<T> t;
      t.zero();
      t.template mma<RowMajor, ColMajor>(qs + rf * 16 * kLd, kLd, ks + cf * 16 * kLd, kLd, D);
      t.store(ss + rf * 16 * kLdB + cf * 16, kLdB);
      t.zero();
      t.template mma<RowMajor, ColMajor>(gs + rf * 16 * kLd, kLd, vs + cf * 16 * kLd, kLd, D);
      t.store(dps + rf * 16 * kLdB + cf * 16, kLdB);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kRowsB * kTk; idx += kThreads) {
      const int r = idx / kTk, cc = idx - r * kTk;
      const int i = i0 + r, j = j0 + cc;
      float pv = 0.f, ds = 0.f;
      if (i < n && j < n) {
        const size_t e = static_cast<size_t>(i) * n + j;
        float s = ss[r * kLdB + cc] * scale;
        if (bh) s += bh[e];
        if (mg) s += mg[e];
        pv = expf(s - st[r]) * st[kRowsB + r];
        ds = pv * (dps[r * kLdB + cc] - st[2 * kRowsB + r]);
      }
      pt[r * kLd + cc] = nkbx::from_f<T>(pv);
      dst[r * kLd + cc] = nkbx::from_f<T>(ds * scale);
    }
    __syncthreads();
    // dV += round(P)^T go and dK += round(dS*scale)^T q over this tile's rows
#pragma unroll
    for (int t = 0; t < kDf; ++t) {
      dv_acc[t].template mma<ColMajor, RowMajor>(pt + warp * 16, kLd, gs + t * 16, kLd, kRowsB);
      dk_acc[t].template mma<ColMajor, RowMajor>(dst + warp * 16, kLd, qs + t * 16, kLd, kRowsB);
    }
  }
  // stage each (64, 64) float result through the s/dP tiles and write it
  auto emit = [&](const WarpTile<T>(&acc)[kDf], T* __restrict__ out) {
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kDf; ++t) acc[t].store(ss + warp * 16 * kLdB + t * 16, kLdB);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTk * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      if (j0 + r < n) {
        out[head0 + static_cast<size_t>(j0 + r) * c + d] = nkbx::from_f<T>(ss[r * kLdB + d]);
      }
    }
  };
  emit(dk_acc, dk);
  emit(dv_acc, dv);
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
    const float* pp = partial + static_cast<size_t>(h) * chunks * nn + e;
    for (int kk = 0; kk < chunks; ++kk) acc += pp[static_cast<size_t>(kk) * nn];
  }
  dbias[static_cast<size_t>(hb) * nn + e] = acc;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* mask, const void* go, void* dq, void* dk, void* dv,
                   float* stats, void* dbias, void* partial, int g, int n, int heads,
                   int bias_heads, int m, float scale, int wpb, cudaStream_t stream) {
  const size_t rows_smem = rows_smem_bytes<T>(n), cols_smem = cols_smem_bytes<T>();
  cudaError_t err = nkbx::allow_smem(attention_bwd_rows_kernel<T>, rows_smem);
  if (err != cudaSuccess) return err;
  err = nkbx::allow_smem(attention_bwd_cols_kernel<T>, cols_smem);
  if (err != cudaSuccess) return err;
  const int sld = nkbx::padded_keys(n);
  const size_t rows = static_cast<size_t>(g) * heads * sld;
  const Stats st{stats, stats + rows, stats + 2 * rows};
  const int chunks = (g + wpb - 1) / wpb;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* got = static_cast<const T*>(go);
  const float* bt = static_cast<const float*>(bias);
  const float* mt = static_cast<const float*>(mask);
  attention_bwd_rows_kernel<T>
      <<<dim3((n + kRowsA - 1) / kRowsA, heads, chunks), kThreads, rows_smem, stream>>>(
          qt, kt, vt, bt, mt, got, static_cast<T*>(dq), st, static_cast<float*>(partial), g, n,
          heads, bias_heads, m, sld, scale, wpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_cols_kernel<T>
      <<<dim3((n + kTk - 1) / kTk, heads, g), kThreads, cols_smem, stream>>>(
          qt, kt, vt, bt, mt, got, static_cast<T*>(dk), static_cast<T*>(dv), st, n, heads,
          bias_heads, m, sld, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  const dim3 grid((n * n + 255) / 256, bias_heads);
  dbias_reduce_kernel<<<grid, 256, 0, stream>>>(static_cast<const float*>(partial),
                                                static_cast<float*>(dbias), n * n, heads, chunks,
                                                bias_heads);
  return cudaGetLastError();
}

// --- bf16, no bias and no mask: the tensor-core pair ---------------------------------

using bf16 = __nv_bfloat16;
using nkbx::cp_async16;
using nkbx::exp2_approx;
using nkbx::ldmatrix_x4;
using nkbx::ldmatrix_x4_trans;
using nkbx::mma_bf16;
using nkbx::pack_bf16;
using nkbx::smem_addr;
constexpr int kTcThreads = 128;              // 4 warps, 16 rows or keys each
constexpr int kTcRows = 64;                  // query rows (rows_tc) or keys (cols_tc) a block
constexpr int kTcLd = D + 8;                 // row stride of the shared tiles: 144 bytes
constexpr int kTcTile = kTcRows * kTcLd * 2;  // bytes of one 64-row tile
constexpr int kTcSlots = 3;                  // ring slots: the step's and two steps ahead
constexpr int kTcStats = 3 * kTcRows * 4;    // bytes of 64 rows' max, inv and rs
// rows_tc: the q and go tiles, then 3 slots of a K and a V tile (73,728 B)
constexpr size_t kRowsTcSmem = static_cast<size_t>(2 + 2 * kTcSlots) * kTcTile;
// cols_tc: the k and v tiles, then 3 slots of a q and a go tile and their rows'
// statistics (76,032 B); either kernel fits three blocks an SM
constexpr int kColsSlot = 2 * kTcTile + kTcStats;
constexpr size_t kColsTcSmem = 2 * kTcTile + static_cast<size_t>(kTcSlots) * kColsSlot;
constexpr float kLog2e = 1.4426950408889634f;

// Rows row0 .. row0 + 63 of one head's (n, D) slice (src at the head's first
// element, stride c) into a shared tile by 16-byte cp.async; rows past n are
// zero-filled.
__device__ __forceinline__ void copy_tile(unsigned dst, const bf16* __restrict__ src, int c,
                                          int row0, int n) {
  for (int i = threadIdx.x; i < kTcRows * (D / 8); i += kTcThreads) {
    const int r = i / (D / 8), ch = i % (D / 8);
    const bool in = row0 + r < n;
    cp_async16(dst + (r * kTcLd + ch * 8) * 2,
               src + static_cast<size_t>(in ? row0 + r : 0) * c + ch * 8, in ? 16 : 0);
  }
}

// The A fragments of a warp's 16 rows r0 .. r0 + 15 of a tile, over all D.
__device__ __forceinline__ void load_a(unsigned (&a)[D / 16][4], unsigned tile, int r0) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
  const int r = r0 + (mi % 2) * 8 + lane % 8;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldmatrix_x4(a[kc], tile + (r * kTcLd + kc * 16 + (mi / 2) * 8) * 2);
}

// c = a (16 x D) times (rows r0 .. r0 + 15 of a tile)^T: the products of a
// warp's 16 rows with 16 rows of a shared tile. c[nt] holds rows lane/4
// (elements 0, 1) and lane/4 + 8 (2, 3) at the tile rows r0 + nt*8 +
// 2 (lane % 4) + {0, 1}.
__device__ __forceinline__ void dot_rows(float (&c)[2][4], const unsigned (&a)[D / 16][4],
                                         unsigned tile, int r0) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
  const int row = r0 + (mi / 2) * 8 + lane % 8;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    // matrices: rows +0..7 / d +0..7, rows +0..7 / d +8..15, rows +8..15 / ...
    unsigned b[4];
    ldmatrix_x4(b, tile + (row * kTcLd + kc * 16 + (mi % 2) * 8) * 2);
    mma_bf16(c[0], a[kc], b[0], b[1]);
    mma_bf16(c[1], a[kc], b[2], b[3]);
  }
}

// acc += a (16 x 16, k = the tile rows r0 .. r0 + 15) times those rows of a
// tile over all D columns (ldmatrix.trans).
__device__ __forceinline__ void acc_rows(float (&acc)[D / 8][4], const unsigned (&a)[4],
                                         unsigned tile, int r0) {
  const int lane = threadIdx.x % 32, mi = lane / 8;
  const int row = r0 + (mi % 2) * 8 + lane % 8;
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    // matrices: rows +0..7 / d +0..7, rows +8..15 / d +0..7, rows +0..7 / d +8..15, ...
    unsigned b[4];
    ldmatrix_x4_trans(b, tile + (row * kTcLd + dp * 16 + (mi / 2) * 8) * 2);
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// Store a warp's 16 x D float accumulator as bf16 rows row0 + lane/4 (+ 8),
// rows at or past n skipped.
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[D / 8][4],
                                           int row0, int n, int c) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int i = row0 + lane / 4 + hi * 8;
    if (i >= n) continue;
    bf16* p = dst + static_cast<size_t>(i) * c + (lane % 4) * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<unsigned*>(p + nt * 8) = pack_bf16(acc[nt][2 * hi], acc[nt][2 * hi + 1]);
  }
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

// Rows kernel: a block owns 64 query rows of one (g, h), 16 a warp, with
// their q and go fragments in registers. The stream is the key tiles twice,
// each step a K and a V tile in one ring slot (one cp.async commit group; the
// q and go tiles ride in the first), two steps ahead of the one multiplied.
// Pass 1: S = q K^T and dP = go V^T; a running max, sum of exp(s - max) and
// sum of exp(s - max) dP, rescaled online, give each row's max, 1/sum and
// rs = rowsum(dP o P). Pass 2: S and dP again, P = exp(s - max) / sum and
// dS = P o (dP - rs) in float, round(dS * scale) as the A fragments of
// dQ += round(dS * scale) K.
__global__ void __launch_bounds__(kTcThreads, 3)
attention_bwd_rows_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ go,
                      bf16* __restrict__ dq, Stats stats, int n, int heads, int sld,
                      float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned qs = smem_addr(smem), gs = qs + kTcTile, ring = gs + kTcTile;
  const int i0 = blockIdx.x * kTcRows, h = blockIdx.y, g = blockIdx.z;
  const int c = heads * D, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head0 = static_cast<size_t>(g) * n * c + h * D;
  const int nk = (n + kTk - 1) / kTk, steps = 2 * nk;
  const int row0 = i0 + warp * 16;
  const bool busy = row0 < n;  // a warp with no row below n only copies and waits

  copy_tile(qs, q + head0, c, i0, n);
  copy_tile(gs, go + head0, c, i0, n);
  int issued = 0;
  auto issue = [&](int t) {  // step t's K and V tiles (key tile t % nk) into slot t % 3
    if (t < steps) {
      const unsigned slot = ring + (t % kTcSlots) * 2 * kTcTile;
      copy_tile(slot, k + head0, c, (t % nk) * kTk, n);
      copy_tile(slot + kTcTile, v + head0, c, (t % nk) * kTk, n);
    }
    nkbx::cp_async_commit();
  };
  auto ready = [&](int t) {  // step t's tiles resident in every thread's view
    __syncthreads();  // the slot about to be refilled is no longer read
    while (issued <= t + kTcSlots - 1) issue(issued++);
    nkbx::cp_async_wait<kTcSlots - 1>();
    __syncthreads();
  };

  unsigned qf[D / 16][4], gf[D / 16][4];
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};

  // 1. Statistics over the key tiles.
  for (int t = 0; t < nk; ++t) {
    ready(t);
    if (t == 0 && busy) {
      load_a(qf, qs, warp * 16);
      load_a(gf, gs, warp * 16);
    }
    if (!busy) continue;
    const unsigned kt = ring + (t % kTcSlots) * 2 * kTcTile, vt = kt + kTcTile;
    const int j0 = t * kTk;
    float s[4][2][4], dp[4][2][4];
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      dot_rows(s[np], qf, kt, np * 16);
      dot_rows(dp[np], gf, vt, np * 16);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j0 + np * 16 + nt * 8 + (lane % 4) * 2 + e % 2;
          s[np][nt][e] = key < n ? s[np][nt][e] * scale : -INFINITY;
        }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float tmax = -INFINITY;
#pragma unroll
      for (int np = 0; np < 4; ++np)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          tmax = fmaxf(tmax, fmaxf(s[np][nt][2 * hi], s[np][nt][2 * hi + 1]));
      const float mnew = fmaxf(mx[hi], quad_max(tmax));
      const float alpha = mx[hi] == -INFINITY ? 0.f : exp2_approx((mx[hi] - mnew) * kLog2e);
      float a_sum = sum[hi] * alpha, a_dot = dot[hi] * alpha;
#pragma unroll
      for (int np = 0; np < 4; ++np)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 2 * hi; e < 2 * hi + 2; ++e) {
            const float ex = exp2_approx((s[np][nt][e] - mnew) * kLog2e);
            a_sum += ex;
            a_dot = fmaf(ex, dp[np][nt][e], a_dot);
          }
      mx[hi] = mnew;
      sum[hi] = a_sum;  // this lane's share; the quad adds its four after the pass
      dot[hi] = a_dot;
    }
  }
  float inv[2], rs[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    inv[hi] = 1.f / quad_sum(sum[hi]);
    rs[hi] = quad_sum(dot[hi]) * inv[hi];
    const int i = row0 + lane / 4 + hi * 8;
    if (busy && lane % 4 == 0 && i < n) {
      const size_t row = (static_cast<size_t>(g) * heads + h) * sld + i;
      stats.max[row] = mx[hi];
      stats.inv[row] = inv[hi];
      stats.rs[row] = rs[hi];
    }
  }

  // 2. dQ: recompute each tile's S and dP 16 keys at a time, dS in float,
  //    round(dS * scale) in registers as the A fragments of dS K.
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int t = 0; t < nk; ++t) {
    ready(nk + t);
    if (!busy) continue;
    const unsigned kt = ring + ((nk + t) % kTcSlots) * 2 * kTcTile, vt = kt + kTcTile;
#pragma unroll
    for (int kc = 0; kc < kTk / 16; ++kc) {
      float s[2][4], dp[2][4];
      dot_rows(s, qf, kt, kc * 16);
      dot_rows(dp, gf, vt, kc * 16);
      float ds[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t * kTk + kc * 16 + nt * 8 + (lane % 4) * 2 + e % 2;
          const float p = exp2_approx((s[nt][e] * scale - mx[e / 2]) * kLog2e) * inv[e / 2];
          ds[nt][e] = key < n ? p * (dp[nt][e] - rs[e / 2]) * scale : 0.f;
        }
      const unsigned a[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                             pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
      acc_rows(acc, a, kt, kc * 16);
    }
  }
  nkbx::cp_async_wait<0>();
  if (busy) store_rows(dq + head0, acc, row0, n, c);
}

// Cols kernel: a block owns 64 keys of one (g, h), 16 a warp, with their K
// and V fragments in registers, and walks the queries in 64-row tiles of q,
// go and the rows kernel's three statistics through a 3-slot cp.async ring,
// two tiles ahead. Per 16 query rows: S^T = K q^T and dP^T = V go^T, P^T =
// exp(s - max) / sum from the statistics (the same score products, so the
// same P), dS^T = P^T o (dP^T - rs); dV += round(P^T) go and dK +=
// round(dS^T * scale) q in float registers, each rounded once at the end.
__global__ void __launch_bounds__(kTcThreads, 3)
attention_bwd_cols_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ go,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, Stats stats, int n,
                      int heads, int sld, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned ks = smem_addr(smem), vs = ks + kTcTile, ring = vs + kTcTile;
  const int j0 = blockIdx.x * kTcRows, h = blockIdx.y, g = blockIdx.z;
  const int c = heads * D, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head0 = static_cast<size_t>(g) * n * c + h * D;
  const size_t srow = (static_cast<size_t>(g) * heads + h) * sld;
  const int nq = (n + kTcRows - 1) / kTcRows;
  const int key0 = j0 + warp * 16;
  const bool busy = key0 < n;

  copy_tile(ks, k + head0, c, j0, n);
  copy_tile(vs, v + head0, c, j0, n);
  int issued = 0;
  auto issue = [&](int t) {  // query tile t: q, go and 64 rows of each statistic
    if (t < nq) {
      const unsigned slot = ring + (t % kTcSlots) * kColsSlot;
      copy_tile(slot, q + head0, c, t * kTcRows, n);
      copy_tile(slot + kTcTile, go + head0, c, t * kTcRows, n);
      if (threadIdx.x < 3 * kTcRows / 4) {  // 16 chunks of 4 rows a statistic
        const int which = threadIdx.x / (kTcRows / 4), ch = threadIdx.x % (kTcRows / 4);
        const float* src = which == 0 ? stats.max : which == 1 ? stats.inv : stats.rs;
        cp_async16(slot + 2 * kTcTile + (which * kTcRows + ch * 4) * 4,
                   src + srow + t * kTcRows + ch * 4, 16);
      }
    }
    nkbx::cp_async_commit();
  };
  auto ready = [&](int t) {
    __syncthreads();
    while (issued <= t + kTcSlots - 1) issue(issued++);
    nkbx::cp_async_wait<kTcSlots - 1>();
    __syncthreads();
  };

  unsigned kf[D / 16][4], vf[D / 16][4];
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;
  for (int t = 0; t < nq; ++t) {
    ready(t);
    if (t == 0 && busy) {
      load_a(kf, ks, warp * 16);
      load_a(vf, vs, warp * 16);
    }
    if (!busy) continue;
    const unsigned qt = ring + (t % kTcSlots) * kColsSlot, gt = qt + kTcTile;
    const float* st = reinterpret_cast<const float*>(smem + (qt - ks) + 2 * kTcTile);
    const int i0 = t * kTcRows;
#pragma unroll
    for (int kc = 0; kc < kTcRows / 16; ++kc) {
      float s[2][4], dp[2][4];
      dot_rows(s, kf, qt, kc * 16);
      dot_rows(dp, vf, gt, kc * 16);
      float p[2][4], ds[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int r = kc * 16 + nt * 8 + (lane % 4) * 2;  // query rows r, r + 1 of the tile
        const float2 m2 = *reinterpret_cast<const float2*>(st + r);
        const float2 i2 = *reinterpret_cast<const float2*>(st + kTcRows + r);
        const float2 r2 = *reinterpret_cast<const float2*>(st + 2 * kTcRows + r);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e % 2;
          const float pv = exp2_approx((s[nt][e] * scale - (odd ? m2.y : m2.x)) * kLog2e) *
                           (odd ? i2.y : i2.x);
          const bool in = i0 + r + odd < n;  // statistics past n are never written
          p[nt][e] = in ? pv : 0.f;
          ds[nt][e] = in ? pv * (dp[nt][e] - (odd ? r2.y : r2.x)) * scale : 0.f;
        }
      }
      const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
      const unsigned da[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                              pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
      acc_rows(dv_acc, pa, gt, kc * 16);
      acc_rows(dk_acc, da, qt, kc * 16);
    }
  }
  nkbx::cp_async_wait<0>();
  if (!busy) return;
  store_rows(dk + head0, dk_acc, key0, n, c);
  store_rows(dv + head0, dv_acc, key0, n, c);
}

cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* go, void* dq,
                      void* dk, void* dv, float* stats, int g, int n, int heads, float scale,
                      cudaStream_t stream) {
  cudaError_t err = nkbx::allow_smem(attention_bwd_rows_tc, kRowsTcSmem);
  if (err != cudaSuccess) return err;
  err = nkbx::allow_smem(attention_bwd_cols_tc, kColsTcSmem);
  if (err != cudaSuccess) return err;
  const int sld = nkbx::padded_keys(n);
  const size_t rows = static_cast<size_t>(g) * heads * sld;
  const Stats st{stats, stats + rows, stats + 2 * rows};
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* got = static_cast<const bf16*>(go);
  const dim3 grid((n + kTcRows - 1) / kTcRows, heads, g);
  attention_bwd_rows_tc<<<grid, kTcThreads, kRowsTcSmem, stream>>>(
      qt, kt, vt, got, static_cast<bf16*>(dq), st, n, heads, sld, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_cols_tc<<<grid, kTcThreads, kColsTcSmem, stream>>>(
      qt, kt, vt, got, static_cast<bf16*>(dk), static_cast<bf16*>(dv), st, n, heads, sld, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, go, dq, dk, dv (G, N, H*64) in float (is_bf16 = 0) or bf16; bias
// (bias_heads, N, N) and mask (M, N, N) in float, or null for zeros (never
// read); stats, float scratch of 3*G*H*Np, Np = N rounded up to 64. With dbias (bias_heads, N, N) float and the scratch partial
// (H, ceil(G / groups_per_block), N, N) float, dbias is computed; pass null
// for both to skip it (groups_per_block is then 1). Returns the CUDA error
// code of the launches (0 on success).
extern "C" int nkbx_attention_bwd(const void* q, const void* k, const void* v, const void* bias,
                                  const void* mask, const void* go, void* dq, void* dk, void* dv,
                                  void* stats, void* dbias, void* partial, int g, int n,
                                  int heads, int bias_heads, int m, float scale,
                                  int groups_per_block, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (is_bf16 && bias == nullptr && mask == nullptr)
    return static_cast<int>(launch_tc(q, k, v, go, dq, dk, dv, st, g, n, heads, scale, s));
  const int wpb = partial == nullptr ? 1 : groups_per_block;
  return static_cast<int>(
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, bias, mask, go, dq, dk, dv, st, dbias, partial, g,
                                      n, heads, bias_heads, m, scale, wpb, s)
              : launch<float>(q, k, v, bias, mask, go, dq, dk, dv, st, dbias, partial, g, n,
                              heads, bias_heads, m, scale, wpb, s));
}
