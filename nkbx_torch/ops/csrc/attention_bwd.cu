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
// when the bias is shared), in float, only when asked for.
//
// What bounds it on an H100: at ViT-B/16 (N = 197) a (g, h) reads 4*N*D and
// writes 3*N*D values for 10*N*N*D operations (five products), about 280
// operations per byte in bf16: at the ridge of the card, so the products
// run on the tensor cores (bf16 WMMA; float FMAs for float storage, through
// attention_tile.cuh). The (N, N) P, dP and dS never reach device memory.
//
// dK and dV sum over every query row, and at N = 577 their float
// accumulators would not fit a block beside the rows they sum. So two
// kernels, each recomputing P from the same tile products:
// - rows: a block owns 16 query rows of one head and a run of `wpb` groups,
//   one after the other. It holds the rows' whole float P and dP rows
//   (streaming K and V in 64-key tiles), forms rowsum(dP o P) and dS, writes
//   dQ = round(dS*scale) K (streaming K again), and writes the per-row max,
//   reciprocal sum and rowsum(dP o P) of each group (G*H*N floats each).
//   With dbias it sums the groups' dS rows, each element always by the same
//   thread in group order, into its own slice of a float partial buffer
//   (heads, chunks, N, N); a third kernel sums the slices in a fixed order:
//   deterministic, no atomics. Without dbias (ViT's constant zero bias) a
//   block takes one group and nothing is summed.
// - cols: a block owns 64 keys of one (g, h), holds their K and V tiles and
//   dK, dV accumulators in registers, and walks the queries in 32-row tiles:
//   it recomputes the P and dP tile, P = exp(s - max) * reciprocal sum from
//   the rows kernel's statistics (the same score products, so the same P),
//   dS from the rowsum, and accumulates round(P)^T go and round(dS*scale)^T q.
// Not yet Hopper's wgmma/TMA, and tiles are loaded without overlap.

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
  float* max;  // (G, H, N): the row maximum of the scores
  float* inv;  // the reciprocal of the row sum of exp(s - max)
  float* rs;   // rowsum(dP o P)
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ bias,
                          const float* __restrict__ mask, const T* __restrict__ go,
                          T* __restrict__ dq, Stats stats, float* __restrict__ partial,
                          int g_total, int n, int heads, int bias_heads, int m, float scale,
                          int wpb) {
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
  const float* bh = bias + static_cast<size_t>(min(h, bias_heads - 1)) * n * n;
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
    const float* mg = mask + static_cast<size_t>(g % m) * n * n;
    for (int r = warp; r < kRowsA; r += kWarps) {
      const int i = i0 + r;
      float* pr = ps + r * lds;
      const float* dpr = dps + r * lds;
      T* dsr = dss + r * ldp;
      if (i >= n) {
        for (int j = lane; j < np; j += 32) dsr[j] = nkbx::from_f<T>(0.f);
        continue;
      }
      const float* bi = bh + static_cast<size_t>(i) * n;
      const float* mi = mg + static_cast<size_t>(i) * n;
      float mx = -FLT_MAX;
      for (int j = lane; j < n; j += 32) {
        const float s = pr[j] * scale + bi[j] + mi[j];
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
        const size_t row = (static_cast<size_t>(g) * heads + h) * n + i;
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
                          int bias_heads, int m, float scale) {
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
  const size_t row0 = (static_cast<size_t>(g) * heads + h) * n;
  const float* bh = bias + static_cast<size_t>(min(h, bias_heads - 1)) * n * n;
  const float* mg = mask + static_cast<size_t>(g % m) * n * n;
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
        const float s = ss[r * kLdB + cc] * scale + bh[e] + mg[e];
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
  const size_t rows = static_cast<size_t>(g) * heads * n;
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
          heads, bias_heads, m, scale, wpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_cols_kernel<T>
      <<<dim3((n + kTk - 1) / kTk, heads, g), kThreads, cols_smem, stream>>>(
          qt, kt, vt, bt, mt, got, static_cast<T*>(dk), static_cast<T*>(dv), st, n, heads,
          bias_heads, m, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return err;
  const dim3 grid((n * n + 255) / 256, bias_heads);
  dbias_reduce_kernel<<<grid, 256, 0, stream>>>(static_cast<const float*>(partial),
                                                static_cast<float*>(dbias), n * n, heads, chunks,
                                                bias_heads);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, go, dq, dk, dv (G, N, H*64) in float (is_bf16 = 0) or bf16; bias
// (bias_heads, N, N) and mask (M, N, N) in float; stats, float scratch of
// 3*G*H*N. With dbias (bias_heads, N, N) float and the scratch partial
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
  const int wpb = partial == nullptr ? 1 : groups_per_block;
  return static_cast<int>(
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, bias, mask, go, dq, dk, dv, st, dbias, partial, g,
                                      n, heads, bias_heads, m, scale, wpb, s)
              : launch<float>(q, k, v, bias, mask, go, dq, dk, dv, st, dbias, partial, g, n,
                              heads, bias_heads, m, scale, wpb, s));
}
