// The fused ResNet bottleneck chain's building blocks, shared by K9
// (bottleneck.cu) and K10 (bottleneck_bwd.cu). See bottleneck.cu for what
// the chain computes and why it is a sequence of kernels.
//
// Layouts. x, out, u2, a2, u3 and their gradients are "global" rows: the
// (B, H, W) positions in order, one row of C or M values each. a1 and its
// gradients are "ext" rows: for each statistics tile t = i * (H/th) + j
// (batch group i of g samples, row band j of th rows), g samples x (th + 2)
// rows x W, the band with one halo row above and below. u1 is computed once
// per global row (it does not depend on the tile); a1 is not: a halo row is
// normalised with the statistics of the tile that reads it.
//
// The products are one tiled kernel, `gemm_kernel`, whose A rows are
// gathered through a row map (flat, global -> ext at a 3x3 tap, ext ->
// global at a 3x3 tap), so the 3x3 convolution and its input gradient are
// nine accumulated products over shifted rows, with zeros where a tap falls
// in the padding. The weight gradients are `wgrad_kernel`, A^T D over slabs
// of rows into f32 partials that `sum_parts` adds in a fixed order. The
// per-tile statistics and BN-backward sums reduce each tile's rows in a
// fixed order. Every result is deterministic: no atomics.
//
// Products: bf16 takes warp-level tensor cores (WMMA 16x16x16, f32
// accumulators), f32 takes float FMAs on the CUDA cores; both stage 64x32
// (or 32x64) tiles through shared memory.
#pragma once

#include <mma.h>

#include <type_traits>

#include "dtype.cuh"

namespace chain {

using bf16 = __nv_bfloat16;
using nkbx::from_f;
using nkbx::round_to;
using nkbx::to_f;

struct Geo {
  int b, h, w, c, m, g, th;
  int nh, nt, the;  // row bands, tiles, th + 2
  int rows;         // b*h*w global rows
  int ext_rows;     // nt*g*(th+2)*w ext rows
};

inline Geo make_geo(int b, int h, int w, int c, int m, int g, int th) {
  Geo G;
  G.b = b; G.h = h; G.w = w; G.c = c; G.m = m; G.g = g; G.th = th;
  G.nh = h / th;
  G.nt = (b / g) * G.nh;
  G.the = th + 2;
  G.rows = b * h * w;
  G.ext_rows = G.nt * g * G.the * w;
  return G;
}

enum Map { kFlat = 0, kG2E = 1, kE2GTile = 2, kE2GImage = 3 };

// Source row of output row `row` at 3x3 tap (dy, dx), or -1 where the tap
// reads zero padding.
//   kG2E: global row (b, h, w) -> ext row (t, b % g, h % th + dy, w + dx - 1)
//     of its own tile: the 3x3 conv's input rows (and, at the centre tap
//     (1, 1), a global row's own core row in the ext layout).
//   kE2GTile: ext row (t, gi, he, w) -> global row of the same tile's core at
//     band row he + dy - 2, column w + dx - 1: the input gradient of the 3x3
//     conv, a full correlation over the th + 2 ext rows.
//   kE2GImage: as kE2GTile but valid anywhere in the image: at the centre tap,
//     an ext row's x row (halo rows read the neighbouring bands; rows off
//     the image are zero).
template <int MAP>
__device__ __forceinline__ int src_row(const Geo& G, int row, int dy, int dx) {
  if (MAP == kFlat) return row;
  const int w = row % G.w;
  const int ww = w + dx - 1;
  if (ww < 0 || ww >= G.w) return -1;
  if (MAP == kG2E) {
    const int bh = row / G.w, h = bh % G.h, b = bh / G.h;
    const int t = (b / G.g) * G.nh + h / G.th;
    return ((t * G.g + b % G.g) * G.the + h % G.th + dy) * G.w + ww;
  }
  int r = row / G.w;
  const int he = r % G.the;
  r /= G.the;
  const int gi = r % G.g, t = r / G.g;
  const int i = t / G.nh, j = t % G.nh;
  const int hr = he + dy - 2;
  if (MAP == kE2GTile) {
    if (hr < 0 || hr >= G.th) return -1;
  } else {
    const int hh = j * G.th + hr;
    if (hh < 0 || hh >= G.h) return -1;
  }
  return ((i * G.g + gi) * G.h + j * G.th + hr) * G.w + ww;
}

// The r-th core row of tile t (r < g*th*w) as a global row.
__device__ __forceinline__ int core_row(const Geo& G, int t, int r) {
  const int per = G.th * G.w;
  const int i = t / G.nh, j = t % G.nh;
  return ((i * G.g + r / per) * G.h + j * G.th) * G.w + r % per;
}

// The tile of a global row.
__device__ __forceinline__ int tile_of_global(const Geo& G, int row) {
  const int bh = row / G.w, h = bh % G.h, b = bh / G.h;
  return (b / G.g) * G.nh + h / G.th;
}

// --- products --------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 32, kThreads = 128;

enum Epi { kStoreF32 = 0, kResid = 1 };

struct GemmArgs {
  const void* a;      // source rows of width k, storage T
  const void* b;      // (taps, k, n) row-major, or with BT (taps, n, k)
  void* out;          // (rows, n): float, or T for kResid
  const void* resid;  // kResid: (rows, n) storage T, added after rounding
  int rows, k, n, taps, flip;
  Geo G;
};

__device__ __forceinline__ void tap_of(int tap, int taps, int* dy, int* dx) {
  if (taps == 1) { *dy = 1; *dx = 1; } else { *dy = tap / 3; *dx = tap % 3; }
}

// out[r, :] = sum over taps and k of A[src(r, tap), k] * B_tap[k, :], f32
// accumulation. With `flip`, tap s reads B tap 8 - s (the 3x3 input gradient
// uses the flipped kernel). K and N are multiples of the 16-byte vector.
template <typename T, int MAP, bool BT, int EPI>
__global__ void __launch_bounds__(kThreads) gemm_kernel(GemmArgs p) {
  constexpr bool kTC = std::is_same<T, bf16>::value;
  constexpr int kV = 16 / sizeof(T);
  constexpr int kLdA = kTC ? kBK + 8 : kBK + 4;
  // bf16: B as [k][n] or, transposed, [n][k] (col-major fragments); f32: [k][n]
  constexpr int kLdB = (kTC && BT) ? kBK + 8 : kBN + (kTC ? 8 : 4);
  constexpr int kBRows = (kTC && BT) ? kBN : kBK;
  __shared__ __align__(128) T As[kBM * kLdA];
  __shared__ __align__(128) T Bs[kBRows * kLdB];
  __shared__ __align__(128) float Cs[kTC ? kBM * (kBN + 4) : 1];
  __shared__ int srow[kBM];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const T* A = static_cast<const T*>(p.a);
  const T* Bw = static_cast<const T*>(p.b);

  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  float facc[4][8];
  if constexpr (kTC) {
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  } else {
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 8; ++j) facc[i][j] = 0.f;
  }
  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;
  const int ty = tid / 8, tx = tid % 8;  // FMA: rows ty + 16 i, cols tx + 8 j

  for (int tap = 0; tap < p.taps; ++tap) {
    int dy, dx;
    tap_of(tap, p.taps, &dy, &dx);
    const int tb = p.taps == 1 ? 0 : (p.flip ? 8 - tap : tap);
    const T* Bt = Bw + static_cast<size_t>(tb) * p.k * p.n;
    __syncthreads();
    if (tid < kBM) {
      const int r = m0 + tid;
      srow[tid] = r < p.rows ? src_row<MAP>(p.G, r, dy, dx) : -1;
    }
    __syncthreads();
    for (int k0 = 0; k0 < p.k; k0 += kBK) {
      // A tile: kBM rows x kBK columns, 16-byte vectors
      for (int idx = tid; idx < kBM * (kBK / kV); idx += kThreads) {
        const int r = idx / (kBK / kV), v = idx % (kBK / kV);
        const int kk = k0 + v * kV, sr = srow[r];
        uint4 val = make_uint4(0, 0, 0, 0);
        if (sr >= 0 && kk < p.k)
          val = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(sr) * p.k + kk);
        *reinterpret_cast<uint4*>(As + r * kLdA + v * kV) = val;
      }
      if constexpr (!BT) {  // B (k, n) row-major: kBK rows x kBN columns
        for (int idx = tid; idx < kBK * (kBN / kV); idx += kThreads) {
          const int kr = idx / (kBN / kV), v = idx % (kBN / kV);
          const int kk = k0 + kr, nn = n0 + v * kV;
          uint4 val = make_uint4(0, 0, 0, 0);
          if (kk < p.k && nn < p.n)
            val = *reinterpret_cast<const uint4*>(Bt + static_cast<size_t>(kk) * p.n + nn);
          *reinterpret_cast<uint4*>(Bs + kr * kLdB + v * kV) = val;
        }
      } else {  // B stored (n, k): kBN rows of kBK
        for (int idx = tid; idx < kBN * (kBK / kV); idx += kThreads) {
          const int nr = idx / (kBK / kV), v = idx % (kBK / kV);
          const int nn = n0 + nr, kk = k0 + v * kV;
          uint4 val = make_uint4(0, 0, 0, 0);
          if (kk < p.k && nn < p.n)
            val = *reinterpret_cast<const uint4*>(Bt + static_cast<size_t>(nn) * p.k + kk);
          if constexpr (kTC) {
            *reinterpret_cast<uint4*>(Bs + nr * kLdB + v * kV) = val;
          } else {
            const float* f = reinterpret_cast<const float*>(&val);
            for (int e = 0; e < kV; ++e) Bs[(v * kV + e) * kLdB + nr] = f[e];
          }
        }
      }
      __syncthreads();
      if constexpr (kTC) {
        for (int ks = 0; ks < kBK; ks += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * kLdA + ks, kLdA);
          for (int j = 0; j < 2; ++j) {
            const int nc = wn * 32 + j * 16;
            if constexpr (BT) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
              wmma::load_matrix_sync(fb, Bs + nc * kLdB + ks, kLdB);
              for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
            } else {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
              wmma::load_matrix_sync(fb, Bs + ks * kLdB + nc, kLdB);
              for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
            }
          }
        }
      } else {
        for (int kk = 0; kk < kBK; ++kk) {
          float av[4], bv[8];
          for (int i = 0; i < 4; ++i) av[i] = to_f(As[(ty + 16 * i) * kLdA + kk]);
          for (int j = 0; j < 8; ++j) bv[j] = to_f(Bs[kk * kLdB + tx + 8 * j]);
          for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 8; ++j) facc[i][j] = fmaf(av[i], bv[j], facc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  auto store = [&](int r, int cidx, float v) {
    const int row = m0 + r, col = n0 + cidx;
    if (row >= p.rows || col >= p.n) return;
    const size_t o = static_cast<size_t>(row) * p.n + col;
    if constexpr (EPI == kStoreF32) {
      static_cast<float*>(p.out)[o] = v;
    } else {
      const float sum = round_to<T>(v) + to_f(static_cast<const T*>(p.resid)[o]);
      static_cast<T*>(p.out)[o] = from_f<T>(sum);
    }
  };
  if constexpr (kTC) {
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * (kBN + 4) + wn * 32 + j * 16,
                                acc[i][j], kBN + 4, wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < kBM * kBN; idx += kThreads)
      store(idx / kBN, idx % kBN, Cs[(idx / kBN) * (kBN + 4) + idx % kBN]);
  } else {
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 8; ++j) store(ty + 16 * i, tx + 8 * j, facc[i][j]);
  }
}

template <typename T, int MAP, bool BT, int EPI>
void gemm(const GemmArgs& p, cudaStream_t s) {
  if (p.rows == 0) return;
  dim3 grid((p.rows + kBM - 1) / kBM, (p.n + kBN - 1) / kBN);
  gemm_kernel<T, MAP, BT, EPI><<<grid, kThreads, 0, s>>>(p);
}

// --- weight gradients --------------------------------------------------------------

constexpr int kWR = 32;  // rows per staged chunk

struct WgradArgs {
  const void* a;  // source rows of width k, storage T
  const void* d;  // (rows, n), storage T
  float* part;    // (slabs, taps, k, n)
  int rows, k, n, taps, slab;
  Geo G;
};

// part[z, tap, :, :] = sum over the rows r of slab z of A[src(r, tap), :]^T
// D[r, :], a 64x64 output tile per block, f32 accumulation.
template <typename T, int MAP>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(WgradArgs p) {
  constexpr bool kTC = std::is_same<T, bf16>::value;
  constexpr int kV = 16 / sizeof(T);
  constexpr int kLd = 64 + (kTC ? 8 : 4);
  __shared__ __align__(128) T As[kWR * kLd];
  __shared__ __align__(128) T Ds[kWR * kLd];
  __shared__ __align__(128) float Cs[kTC ? 64 * 68 : 1];
  __shared__ int srow[kWR];
  const int tid = threadIdx.x;
  const int ktiles = (p.k + 63) / 64;
  const int k0 = (blockIdx.x % ktiles) * 64, n0 = (blockIdx.x / ktiles) * 64;
  const int tap = blockIdx.y, z = blockIdx.z;
  const int r_begin = z * p.slab, r_end = min(p.rows, r_begin + p.slab);
  int dy, dx;
  tap_of(tap, p.taps, &dy, &dx);
  const T* A = static_cast<const T*>(p.a);
  const T* D = static_cast<const T*>(p.d);

  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  float facc[4][8];
  if constexpr (kTC) {
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  } else {
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 8; ++j) facc[i][j] = 0.f;
  }
  const int warp = tid / 32, wk = warp / 2, wn = warp % 2;
  const int ty = tid / 8, tx = tid % 8;

  for (int r0 = r_begin; r0 < r_end; r0 += kWR) {
    __syncthreads();
    if (tid < kWR) {
      const int r = r0 + tid;
      srow[tid] = r < r_end ? src_row<MAP>(p.G, r, dy, dx) : -1;
    }
    __syncthreads();
    for (int idx = tid; idx < kWR * (64 / kV); idx += kThreads) {
      const int r = idx / (64 / kV), v = idx % (64 / kV);
      const int kk = k0 + v * kV, nn = n0 + v * kV, sr = srow[r];
      uint4 va = make_uint4(0, 0, 0, 0), vd = make_uint4(0, 0, 0, 0);
      if (sr >= 0 && kk < p.k)
        va = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(sr) * p.k + kk);
      if (r0 + r < r_end && nn < p.n)
        vd = *reinterpret_cast<const uint4*>(D + static_cast<size_t>(r0 + r) * p.n + nn);
      *reinterpret_cast<uint4*>(As + r * kLd + v * kV) = va;
      *reinterpret_cast<uint4*>(Ds + r * kLd + v * kV) = vd;
    }
    __syncthreads();
    if constexpr (kTC) {
      for (int rs = 0; rs < kWR; rs += 16) {
        // A^T: element (k, r) at As[r * kLd + k], a column-major k x r tile
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + rs * kLd + wk * 32 + i * 16, kLd);
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, Ds + rs * kLd + wn * 32 + j * 16, kLd);
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
        }
      }
    } else {
      for (int r = 0; r < kWR; ++r) {
        float av[4], dv[8];
        for (int i = 0; i < 4; ++i) av[i] = to_f(As[r * kLd + ty + 16 * i]);
        for (int j = 0; j < 8; ++j) dv[j] = to_f(Ds[r * kLd + tx + 8 * j]);
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 8; ++j) facc[i][j] = fmaf(av[i], dv[j], facc[i][j]);
      }
    }
  }

  float* out = p.part + (static_cast<size_t>(z) * p.taps + tap) * p.k * p.n;
  auto store = [&](int kr, int nc, float v) {
    const int kk = k0 + kr, nn = n0 + nc;
    if (kk < p.k && nn < p.n) out[static_cast<size_t>(kk) * p.n + nn] = v;
  };
  if constexpr (kTC) {
    __syncthreads();
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wk * 32 + i * 16) * 68 + wn * 32 + j * 16, acc[i][j], 68,
                                wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < 64 * 64; idx += kThreads)
      store(idx / 64, idx % 64, Cs[(idx / 64) * 68 + idx % 64]);
  } else {
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 8; ++j) store(ty + 16 * i, tx + 8 * j, facc[i][j]);
  }
}

// out[i] = sum over z of part[z * len + i], in order of z.
__global__ void sum_parts(const float* part, float* out, int nparts, int len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int z = 0; z < nparts; ++z) s += part[static_cast<size_t>(z) * len + i];
  out[i] = s;
}

template <typename T, int MAP>
void wgrad(const WgradArgs& p, float* out, cudaStream_t s) {
  const int slabs = (p.rows + p.slab - 1) / p.slab;
  const int len = p.taps * p.k * p.n;
  if (p.rows > 0) {
    dim3 grid(((p.k + 63) / 64) * ((p.n + 63) / 64), p.taps, slabs);
    wgrad_kernel<T, MAP><<<grid, kThreads, 0, s>>>(p);
  }
  sum_parts<<<(len + 255) / 256, 256, 0, s>>>(p.part, out, p.rows > 0 ? slabs : 0, len);
}

// --- per-tile statistics -----------------------------------------------------------

// Block: 32 channels x 8 row lanes of one tile; each lane sums its rows in
// order, then lane 0 adds the 8 lanes in order.
constexpr int kSC = 32, kSL = 8;

// mean and var = max(E[u^2] - mean^2, 0) of each channel over tile t's core
// rows of the global f32 rows u (rows, cn).
__global__ void tile_stats(const float* u, float* mean, float* var, Geo G, int cn) {
  __shared__ float red[2][kSL][kSC];
  const int ch = blockIdx.y * kSC + threadIdx.x, t = blockIdx.x, lane = threadIdx.y;
  const int n = G.g * G.th * G.w;
  float s = 0.f, s2 = 0.f;
  if (ch < cn)
    for (int r = lane; r < n; r += kSL) {
      const float v = u[static_cast<size_t>(core_row(G, t, r)) * cn + ch];
      s += v;
      s2 += v * v;
    }
  red[0][lane][threadIdx.x] = s;
  red[1][lane][threadIdx.x] = s2;
  __syncthreads();
  if (lane == 0 && ch < cn) {
    for (int l = 1; l < kSL; ++l) {
      s += red[0][l][threadIdx.x];
      s2 += red[1][l][threadIdx.x];
    }
    const float mu = s / n;
    mean[static_cast<size_t>(t) * cn + ch] = mu;
    var[static_cast<size_t>(t) * cn + ch] = fmaxf(s2 / n - mu * mu, 0.f);
  }
}

inline void stats(const float* u, float* mean, float* var, const Geo& G, int cn,
                  cudaStream_t s) {
  tile_stats<<<dim3(G.nt, (cn + kSC - 1) / kSC), dim3(kSC, kSL), 0, s>>>(u, mean, var, G, cn);
}

struct Bn {
  const float *mean, *var, *scale, *bias;  // (nt, cn), (nt, cn), (cn), (cn)
};

// ((u - mean) * rstd) * scale + bias of tile t, channel ch; also xhat, rstd.
__device__ __forceinline__ float bn_z(const Bn& bn, int t, int cn, int ch, float u, float eps,
                                      float* xhat, float* rstd) {
  const size_t o = static_cast<size_t>(t) * cn + ch;
  *rstd = rsqrtf(bn.var[o] + eps);
  *xhat = (u - bn.mean[o]) * *rstd;
  return *xhat * bn.scale[ch] + bn.bias[ch];
}

// a1 over the ext rows: relu(BN1(u1)) with the reading tile's statistics,
// zero on the halo rows off the image; rounded to T.
template <typename T>
__global__ void act_ext(const float* u1, Bn bn, T* a1, Geo G, int cn, float eps) {
  const size_t total = static_cast<size_t>(G.ext_rows) * cn;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int er = static_cast<int>(idx / cn), ch = static_cast<int>(idx % cn);
    const int src = src_row<kE2GImage>(G, er, 1, 1);
    float a = 0.f;
    if (src >= 0) {
      float xhat, rstd;
      const float z = bn_z(bn, er / (G.g * G.the * G.w), cn, ch,
                           u1[static_cast<size_t>(src) * cn + ch], eps, &xhat, &rstd);
      a = fmaxf(z, 0.f);
    }
    a1[idx] = from_f<T>(a);
  }
}

// a2 over the global rows: relu(BN2(u2)), rounded to T.
template <typename T>
__global__ void act_global(const float* u, Bn bn, T* a, Geo G, int cn, float eps) {
  const size_t total = static_cast<size_t>(G.rows) * cn;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(idx / cn), ch = static_cast<int>(idx % cn);
    float xhat, rstd;
    const float z = bn_z(bn, tile_of_global(G, row), cn, ch, u[idx], eps, &xhat, &rstd);
    a[idx] = from_f<T>(fmaxf(z, 0.f));
  }
}

// round(BN3(u3)) + x in T (the residual sum, rounded), as float.
template <typename T>
__device__ __forceinline__ float residual_sum(const float* u3, Bn bn, const T* x, const Geo& G,
                                              int cn, size_t idx, float eps) {
  const int row = static_cast<int>(idx / cn), ch = static_cast<int>(idx % cn);
  float xhat, rstd;
  const float y3 = round_to<T>(bn_z(bn, tile_of_global(G, row), cn, ch, u3[idx], eps, &xhat,
                                    &rstd));
  return round_to<T>(y3 + to_f(x[idx]));
}

inline int grid_for(size_t total) {
  const size_t blocks = (total + 255) / 256;
  return static_cast<int>(blocks < 132 * 32 ? (blocks ? blocks : 1) : 132 * 32);
}

struct Chain {
  const void *x, *w1, *w2, *w3;
  Bn bn1, bn2, bn3;  // mean/var point at the per-tile statistics outputs
  float* u1;         // (rows, m)
  void* a1;          // (ext_rows, m) T
  float* u2;         // (rows, m)
  void* a2;          // (rows, m) T
  float* u3;         // (rows, c)
};

// The forward up to u3 and the three BNs' per-tile statistics (K9's body,
// and K10's recompute).
template <typename T>
void forward_to_u3(const Chain& ch, const Geo& G, float eps, cudaStream_t s) {
  GemmArgs p{};
  p.G = G;
  p.taps = 1;
  // u1 = x w1 over every global row
  p.a = ch.x; p.b = ch.w1; p.out = ch.u1; p.rows = G.rows; p.k = G.c; p.n = G.m;
  gemm<T, kFlat, false, kStoreF32>(p, s);
  stats(ch.u1, const_cast<float*>(ch.bn1.mean), const_cast<float*>(ch.bn1.var), G, G.m, s);
  act_ext<T><<<grid_for(static_cast<size_t>(G.ext_rows) * G.m), 256, 0, s>>>(
      ch.u1, ch.bn1, static_cast<T*>(ch.a1), G, G.m, eps);
  // u2 = 3x3 conv of a1 over each tile's core rows
  p.a = ch.a1; p.b = ch.w2; p.out = ch.u2; p.rows = G.rows; p.k = G.m; p.n = G.m; p.taps = 9;
  p.flip = 0;
  gemm<T, kG2E, false, kStoreF32>(p, s);
  stats(ch.u2, const_cast<float*>(ch.bn2.mean), const_cast<float*>(ch.bn2.var), G, G.m, s);
  act_global<T><<<grid_for(static_cast<size_t>(G.rows) * G.m), 256, 0, s>>>(
      ch.u2, ch.bn2, static_cast<T*>(ch.a2), G, G.m, eps);
  // u3 = a2 w3
  p.a = ch.a2; p.b = ch.w3; p.out = ch.u3; p.rows = G.rows; p.k = G.m; p.n = G.c; p.taps = 1;
  gemm<T, kFlat, false, kStoreF32>(p, s);
  stats(ch.u3, const_cast<float*>(ch.bn3.mean), const_cast<float*>(ch.bn3.var), G, G.c, s);
}

}  // namespace chain
