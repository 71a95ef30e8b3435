// Fused LayerNorm -> Dense -> exact GELU -> Dense -> layer-scale -> residual,
// backward: the transformer-block MLP half; and its LN-free member, the
// backward of the MLP alone.
//
// Replaces two Pallas kernels: nkbx/ops/mlp.py:520 `_lnmlp_bwd_kernel` (the
// VJP of `fused_ln_mlp`, K6; C entries `nkbx_ln_mlp_bwd_gemm` and
// `nkbx_ln_mlp_bwd`) and nkbx/ops/mlp.py:265 `_bwd_kernel` (the VJP of
// `fused_mlp`, K8; C entries `nkbx_mlp_bwd_gemm` and `nkbx_mlp_bwd`).
//
// K6. For rows x (R, C), the cotangent dy and the forward's
// parameters it returns dx and the f32 sums over rows of ds, db (LayerNorm),
// dw0, db0, dw1, db1 and dgamma, at the rounding points of mlp.py:520-570:
//   h = round(LN(x)), u = h w0 + b0, g = round(gelu(u)), gelu'(u) from the
//   same erf; y = round(g w1 + b1) (only with a layer-scale, for dgamma =
//   sum round(dy * y)); dy2 = round(dy * round(gamma)); dw1 = g^T dy2;
//   db1 = sum dy2; du = (dy2 w1^T) * gelu'(u); dw0 = h^T round(du);
//   db0 = sum du; dh = round(du) w0^T; ds = sum dh * xhat; db = sum dh;
//   dx = rstd * (dh*s - mean(dh*s) - xhat * mean(dh*s*xhat)).
//
// K8 (mlp.py:265-305): u = x w0 + b0, g = round(gelu(u)), dw1 = g^T dy,
// db1 = sum dy, du = (dy w1^T) * gelu'(u), dw0 = x^T round(du), db0 = sum
// du, and dx = round(round(du) w0^T), with no LayerNorm backward after it.
//
// What bounds it on an H100: the operations. K6 does 12*R*C*F (two products
// to recompute u and y, four backward products; K8 and K6 without a
// layer-scale 10*R*C*F: y is not recomputed), which at
// Swin-T's F = 4C is far above the ~295 operations per byte of the bf16
// ridge; x, dy and dx are a small share of the bytes.
//
// The TPU kernel keeps dw0 and dw1 resident in VMEM across a sequential grid
// of row tiles; an SM cannot hold them (C*F*4 bytes: 147 KB at C=96, 9.4 MB
// at C=768), and blocks run in no order. So the work is split, and every sum
// over rows is added in a fixed order (no atomics: a relaunch is
// bit-identical).
//
// K6's route in bf16 with C % 32 == 0 and F % 64 == 0 (every Swin, ConvNeXt
// and ViT width), `nkbx_ln_mlp_bwd_gemm`: products on gemm_tc.cuh's
// tensor-core GEMM, 128-row block tiles, so that every weight byte feeds 128
// rows.
// 1. ln_mlp_bwd_rows_kernel: h, the row statistics and dy2, one warp a row;
//    ln_mlp_bwd_db1_kernel: db1's partials over 64-row by 64-column tiles.
// 2. ln_mlp_bwd_dual_kernel: u = h w0 and dgl = dy2 w1^T on one (128-row,
//    64-column) tile into two accumulators; epilogue g and round(du) (bf16,
//    through shared memory to device memory) and the row tile's db0 of the
//    float du.
// 3. ln_mlp_bwd_gemm_kernel: dh = round(du) w0^T in float (R, C), K = F
//    split into slabs where the tiles would fill the card poorly; epilogue
//    the (slab, row tile)'s partials of ds = sum dh * xhat and db = sum dh
//    (linear in dh, so the slabs' partials add up).
// 4. ln_mlp_bwd_lnb_kernel: dx from the sum of dh's slabs, one warp a row.
// 5. ln_mlp_bwd_gemm_kernel twice, split over slabs of rows: dw1 = g^T dy2
//    and dw0 = h^T round(du), in bf16 when the rows are one slab, else into
//    float slab partials that ln_mlp_bwd_slab_sum_kernel adds in order.
// 6. With a layer-scale only, ln_mlp_bwd_gemm_kernel: g w1, epilogue the row
//    tile's dgamma = sum round(dy * round(g w1 + b1)); y is not stored.
// Then ln_mlp_bwd_colsum_kernel adds each set of vector partials in order.
// The hidden goes through device memory (g, round(du): 4*R*F*2 bytes
// written and read) at the points where nkbx rounds it to bf16, so no
// number changes.
//
// K8's route at the same widths, `nkbx_mlp_bwd_gemm`: K6's without the row
// kernels. x and dy are the dual GEMM's A operands where h and dy2 are in
// K6; db1's partials come from dy; du w0^T's epilogue stores dx = round(acc)
// itself (when K = F is split, ln_mlp_bwd_slab_sum_kernel adds the slabs'
// float partials in order and rounds); no ds/db partials, no LayerNorm
// backward; then the column sums of db1 and db0 and the two weight gradients
// as in step 5.
//
// The first design, kept for f32 and other widths (K8 is the same row
// kernel with the template flag LN off, x and dy read straight into the
// operand buffers that hold h and dy2 in K6); its tensor-core members, which
// no wrapper takes any more, stay reachable through the C entries
// (tensor_cores = 1) as the yardstick the GEMM route is timed against:
// 1. A row-tile kernel recomputes the forward of TR rows, walking F in
//    chunks of 64 as the forward kernel does, and emits dx, per-tile partial
//    sums of the C- and F-sized vector gradients, and, in the storage type,
//    h, dy2, g and round(du) for the weight gradients.
// 2. A weight-gradient kernel computes A^T B over slabs of rows (dw1 = g^T
//    dy2, dw0 = h^T du) into float partials, one 64x64 tile per block.
// 3. A column-sum kernel adds the partials in a fixed order.
// Products: bf16 with C % 32 == 0 and F % 64 == 0 take warp-level tensor
// cores (WMMA 16x16x16, float accumulators), weights staged through shared
// memory in 32-deep slabs with cp.async double-buffering; float (and bf16 at
// other widths) take float FMAs on the CUDA cores.

#include <mma.h>

#include <type_traits>

#include "dtype.cuh"
#include "gemm_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;           // hidden units per chunk
constexpr int kLdu = kChunk + 4;     // tensor cores: float chunk row stride
constexpr int kLdg = kChunk + 8;     // tensor cores: bf16 chunk row stride
constexpr int kLdf = kChunk + 1;     // FMA: float chunk row stride
constexpr int kSlabK = 32;           // depth of a staged weight slab
constexpr int kLdR = 128 + 8;        // row-major slab [k][n], n <= 128
constexpr int kLdC = kSlabK + 8;     // column-major slab [n][k], n <= 128
constexpr int kSlabElems = 128 * kLdC;  // one slab buffer (>= 32 * kLdR)

__device__ __forceinline__ void gelu_and_grad(float u, float* g, float* dg) {
  const float cdf = 0.5f * (1.f + erff(u * 0.70710678118654752f));
  const float pdf = expf(-0.5f * u * u) * 0.39894228040143268f;
  *g = u * cdf;
  *dg = cdf + u * pdf;
}

__host__ __device__ inline size_t align256(size_t b) { return (b + 255) / 256 * 256; }

// Byte offsets of the row kernel's shared memory; every part 256-byte
// aligned. K8 (ln false) keeps no row statistics. Mirrored by
// `bwd_smem_bytes` and `mlp_bwd_smem_bytes` in nkbx_torch/ops/mlp.py.
struct RowLayout {
  size_t hs, d2s, acc, ch, gch, wbuf, stats, red, total;
};

__host__ __device__ inline RowLayout row_layout(int tr, int c, bool tc, bool ln) {
  RowLayout L;
  size_t o = 0;
  const size_t hbytes = tc ? 2 : 4;
  const int ldh = tc ? c + 8 : c + 1, lda = tc ? c + 4 : c + 1;
  L.hs = o;    o += align256(tr * ldh * hbytes);
  L.d2s = o;   o += align256(tr * ldh * hbytes);
  L.acc = o;   o += align256(static_cast<size_t>(tr) * lda * 4);
  L.ch = o;    o += align256(tc ? 4 * tr * kLdu * 4 : 2 * tr * kLdf * 4);
  L.gch = o;   o += align256(tc ? tr * kLdg * 2 : tr * kLdf * 4);
  L.wbuf = o;  o += tc ? align256(2 * kSlabElems * 2) : 0;
  L.stats = o; o += ln ? align256(2 * tr * 4) : 0;
  L.red = o;   o += align256(kThreads * 4);
  L.total = o;
  return L;
}

struct RowArgs {
  const void *x, *dy, *w0, *w1;          // storage type T
  const float *ln_s, *ln_b, *b0, *b1, *gamma;  // K8: ln_s, ln_b, gamma null
  void *dx, *h, *dy2, *gact, *du;        // storage type T; K8: h, dy2 null
  float *part_c, *part_f;                // (4, tiles, C) (K8: (tiles, C)), (tiles, F)
  int rows, c, f, tiles, has_gamma;
  float eps;
};

// --- tensor-core products ------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Copy a (rows, cols) bf16 tile (cols % 8 == 0, 16-byte aligned rows) into
// shared memory as one cp.async group of the calling thread.
__device__ __forceinline__ void stage_tile(bf16* dst, int ldd, const bf16* src, size_t lds,
                                           int rows, int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, v = i - r * per_row;
    cp_async16(dst + r * ldd + 8 * v, src + r * lds + 8 * v);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for the slab issued before the one just issued (or for all), then
// make it visible to every warp.
__device__ __forceinline__ void slab_ready(bool issued_next) {
  if (issued_next) asm volatile("cp.async.wait_group 1;\n" ::);
  else asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

namespace wm = nvcuda::wmma;
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragBr = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragBc = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

// Slab s of a (K, 64) operand B: element (k, j) at Bg[k*ldb + j] (row-major)
// or Bg[j*ldb + k] (ColB).
template <bool ColB>
__device__ __forceinline__ void stage_chunk_slab(bf16* buf, const bf16* Bg, int ldb, int s) {
  if (ColB) stage_tile(buf, kLdC, Bg + s * kSlabK, ldb, kChunk, kSlabK);
  else stage_tile(buf, kLdR, Bg + static_cast<size_t>(s) * kSlabK * ldb, ldb, kSlabK, kChunk);
}

// out + out2 = A (TR, K) @ B (K, 64); A bf16 in shared memory. Warp w takes
// column tile w % 4 and, of each slab's two k-steps, step w / 4, into its own
// partial sum (out or out2), for every row tile.
template <int NRT, bool ColB>
__device__ void tc_gemm_chunk(const bf16* A, int lda, int K, const bf16* Bg, int ldb,
                              float* out, float* out2, bf16* wbuf) {
  const int warp = threadIdx.x / 32;
  const int ct = warp % 4, kpart = warp / 4;
  FragC acc[NRT];
#pragma unroll
  for (int rt = 0; rt < NRT; ++rt) wm::fill_fragment(acc[rt], 0.f);
  const int nslab = K / kSlabK;
  stage_chunk_slab<ColB>(wbuf, Bg, ldb, 0);
  for (int s = 0; s < nslab; ++s) {
    const bool next = s + 1 < nslab;
    if (next) stage_chunk_slab<ColB>(wbuf + ((s + 1) & 1) * kSlabElems, Bg, ldb, s + 1);
    slab_ready(next);
    const bf16* slab = wbuf + (s & 1) * kSlabElems;
    if constexpr (ColB) {
      FragBc b;
      wm::load_matrix_sync(b, slab + 16 * ct * kLdC + 16 * kpart, kLdC);
#pragma unroll
      for (int rt = 0; rt < NRT; ++rt) {
        FragA a;
        wm::load_matrix_sync(a, A + 16 * rt * lda + s * kSlabK + 16 * kpart, lda);
        wm::mma_sync(acc[rt], a, b, acc[rt]);
      }
    } else {
      FragBr b;
      wm::load_matrix_sync(b, slab + 16 * kpart * kLdR + 16 * ct, kLdR);
#pragma unroll
      for (int rt = 0; rt < NRT; ++rt) {
        FragA a;
        wm::load_matrix_sync(a, A + 16 * rt * lda + s * kSlabK + 16 * kpart, lda);
        wm::mma_sync(acc[rt], a, b, acc[rt]);
      }
    }
    __syncthreads();  // the slab buffer is refilled two steps on
  }
  float* dst = kpart ? out2 : out;
#pragma unroll
  for (int rt = 0; rt < NRT; ++rt)
    wm::store_matrix_sync(dst + 16 * rt * kLdu + 16 * ct, acc[rt], kLdu, wm::mem_row_major);
}

// Slab t of a (64, C) operand B walked in 128-column bands, two 32-deep
// slabs per band: element (k, n) at Bg[k*ldb + n] (row-major) or
// Bg[n*ldb + k] (ColB).
template <bool ColB>
__device__ __forceinline__ void stage_wide_slab(bf16* buf, const bf16* Bg, int ldb, int c,
                                                int t) {
  const int c0 = (t / 2) * 128, kh = t % 2;
  const int nc = min(128, c - c0);
  if (ColB) stage_tile(buf, kLdC, Bg + static_cast<size_t>(c0) * ldb + kh * kSlabK, ldb, nc, kSlabK);
  else stage_tile(buf, kLdR, Bg + static_cast<size_t>(kh * kSlabK) * ldb + c0, ldb, kSlabK, nc);
}

// acc (TR, C) += A (TR, 64) @ B (64, C); A bf16 (row stride kLdg). Warp w
// owns column tile w of each 128-column band.
template <int NRT, bool ColB>
__device__ void tc_gemm_wide(const bf16* A, float* accs, int lda, int c, const bf16* Bg, int ldb,
                             bf16* wbuf) {
  const int warp = threadIdx.x / 32;
  const int nslab = 2 * ((c + 127) / 128);
  FragC acc[NRT];
  stage_wide_slab<ColB>(wbuf, Bg, ldb, c, 0);
  for (int t = 0; t < nslab; ++t) {
    const int kh = t % 2;
    const int ct = (t / 2) * kWarps + warp;
    const bool active = ct < c / 16;
    if (kh == 0 && active) {
#pragma unroll
      for (int rt = 0; rt < NRT; ++rt)
        wm::load_matrix_sync(acc[rt], accs + 16 * rt * lda + 16 * ct, lda, wm::mem_row_major);
    }
    const bool next = t + 1 < nslab;
    if (next) stage_wide_slab<ColB>(wbuf + ((t + 1) & 1) * kSlabElems, Bg, ldb, c, t + 1);
    slab_ready(next);
    if (active) {
      const bf16* slab = wbuf + (t & 1) * kSlabElems;
#pragma unroll
      for (int kk = 0; kk < kSlabK; kk += 16) {
        if constexpr (ColB) {
          FragBc b;
          wm::load_matrix_sync(b, slab + 16 * warp * kLdC + kk, kLdC);
#pragma unroll
          for (int rt = 0; rt < NRT; ++rt) {
            FragA a;
            wm::load_matrix_sync(a, A + 16 * rt * kLdg + kh * kSlabK + kk, kLdg);
            wm::mma_sync(acc[rt], a, b, acc[rt]);
          }
        } else {
          FragBr b;
          wm::load_matrix_sync(b, slab + kk * kLdR + 16 * warp, kLdR);
#pragma unroll
          for (int rt = 0; rt < NRT; ++rt) {
            FragA a;
            wm::load_matrix_sync(a, A + 16 * rt * kLdg + kh * kSlabK + kk, kLdg);
            wm::mma_sync(acc[rt], a, b, acc[rt]);
          }
        }
      }
      if (kh == 1) {
#pragma unroll
        for (int rt = 0; rt < NRT; ++rt)
          wm::store_matrix_sync(accs + 16 * rt * lda + 16 * ct, acc[rt], lda, wm::mem_row_major);
      }
    }
    __syncthreads();
  }
}

// --- float-FMA products: thread (ty, tx) of a 16 x 16 grid computes rows
// ty + 16r and columns tx + 16q of each 64-wide tile ---------------------------

// out (TR, 64) = A (TR, K) @ B (K, 64), B(k, j) at Bg[k*sk + j*sj], j < fn.
template <typename T, int NRT>
__device__ void fma_gemm_chunk(const float* A, int lda, int K, const T* Bg, int sk, int sj,
                               int fn, float* out) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[NRT][4] = {};
  for (int k = 0; k < K; ++k) {
    float wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = tx + 16 * q;
      wv[q] = j < fn ? nkbx::to_f(Bg[static_cast<size_t>(k) * sk + static_cast<size_t>(j) * sj]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < NRT; ++r) {
      const float av = A[(ty + 16 * r) * lda + k];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av, wv[q], acc[r][q]);
    }
  }
#pragma unroll
  for (int r = 0; r < NRT; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) out[(ty + 16 * r) * kLdf + tx + 16 * q] = acc[r][q];
}

// acc (TR, C) += A (TR, K = fn) @ B (fn, C), B(k, n) at Bg[k*sk + n*sj].
template <typename T, int NRT>
__device__ void fma_gemm_wide(const float* A, int fn, float* accs, int lda, int c, const T* Bg,
                              int sk, int sj) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    float a2[NRT][4] = {};
    for (int k = 0; k < fn; ++k) {
      float wv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = c0 + tx + 16 * q;
        wv[q] = n < c ? nkbx::to_f(Bg[static_cast<size_t>(k) * sk + static_cast<size_t>(n) * sj]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < NRT; ++r) {
        const float av = A[(ty + 16 * r) * kLdf + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) a2[r][q] = fmaf(av, wv[q], a2[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < NRT; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = c0 + tx + 16 * q;
        if (n < c) accs[(ty + 16 * r) * lda + n] += a2[r][q];
      }
  }
}

// --- the row-tile kernel ---------------------------------------------------------

template <typename T, bool TC, bool LN, int NRT>
__global__ void __launch_bounds__(kThreads) ln_mlp_bwd_row_kernel(RowArgs a) {
  using AT = typename std::conditional<TC, bf16, float>::type;
  constexpr int TR = 16 * NRT;
  constexpr int ldc = TC ? kLdu : kLdf;  // float chunk stride
  constexpr int ldg = TC ? kLdg : kLdf;  // A-operand chunk stride
  extern __shared__ __align__(256) unsigned char smem[];
  const RowLayout L = row_layout(TR, a.c, TC, LN);
  const int c = a.c, f = a.f;
  const int ldh = TC ? c + 8 : c + 1, lda = TC ? c + 4 : c + 1;
  AT* hs = reinterpret_cast<AT*>(smem + L.hs);
  AT* d2s = reinterpret_cast<AT*>(smem + L.d2s);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* us = reinterpret_cast<float*>(smem + L.ch);
  float* us2 = us + TR * ldc;                       // tensor cores: split-k halves
  float* gl = TC ? us + 2 * TR * ldc : us + TR * ldc;
  float* gl2 = gl + TR * ldc;
  AT* gch = reinterpret_cast<AT*>(smem + L.gch);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + L.wbuf);
  float* mu_s = reinterpret_cast<float*>(smem + L.stats);
  float* rstd_s = mu_s + TR;
  float* red = reinterpret_cast<float*>(smem + L.red);

  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* w0 = static_cast<const T*>(a.w0);
  const T* w1 = static_cast<const T*>(a.w1);
  const int tile = blockIdx.x, row0 = tile * TR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float inv_c = 1.f / c;

  // 0. LayerNorm: h = round(LN(x)) and dy2 = round(dy * round(gamma)) into
  //    shared memory (zeros past R) and to device memory; row statistics.
  //    K8: x and dy into shared memory as they are (zeros past R).
  if constexpr (!LN) {
    for (int idx = threadIdx.x; idx < TR * c; idx += kThreads) {
      const int r = idx / c, j = idx - r * c;
      const bool in = row0 + r < a.rows;
      const size_t o = static_cast<size_t>(row0 + r) * c + j;
      hs[r * ldh + j] = nkbx::from_f<AT>(in ? nkbx::to_f(x[o]) : 0.f);
      d2s[r * ldh + j] = nkbx::from_f<AT>(in ? nkbx::to_f(dy[o]) : 0.f);
    }
  } else {
    for (int r = warp; r < TR; r += kWarps) {
      const int gr = row0 + r;
      AT* hr = hs + r * ldh;
      AT* dr = d2s + r * ldh;
      if (gr >= a.rows) {
        for (int j = lane; j < c; j += 32) hr[j] = dr[j] = nkbx::from_f<AT>(0.f);
        if (lane == 0) mu_s[r] = rstd_s[r] = 0.f;
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
      const float rstd = rsqrtf(var + a.eps);
      if (lane == 0) {
        mu_s[r] = mu;
        rstd_s[r] = rstd;
      }
      const size_t o = static_cast<size_t>(gr) * c;
      for (int j = lane; j < c; j += 32) {
        const float hv = nkbx::round_to<T>((nkbx::to_f(xr[j]) - mu) * rstd * a.ln_s[j] + a.ln_b[j]);
        const float dv = nkbx::round_to<T>(nkbx::to_f(dy[o + j]) * nkbx::round_to<T>(a.gamma[j]));
        hr[j] = nkbx::from_f<AT>(hv);
        dr[j] = nkbx::from_f<AT>(dv);
        static_cast<T*>(a.h)[o + j] = nkbx::from_f<T>(hv);
        static_cast<T*>(a.dy2)[o + j] = nkbx::from_f<T>(dv);
      }
    }
  }
  for (int i = threadIdx.x; i < TR * lda; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  // u chunk = h @ w0[:, f0:f0+64] into us (+ us2).
  auto u_chunk = [&](int f0) {
    if constexpr (TC) tc_gemm_chunk<NRT, false>(hs, ldh, c, w0 + f0, f, us, us2, wbuf);
    else fma_gemm_chunk<T, NRT>(hs, ldh, c, w0 + f0, f, 1, min(kChunk, f - f0), us);
  };
  auto u_at = [&](int o, int f0, int j) {
    return (TC ? us[o] + us2[o] : us[o]) + a.b0[f0 + j];
  };

  // 1. With a layer-scale only: y = round(g @ w1 + b1) into acc, and the
  //    tile's dgamma = sum over rows of round(dy * y).
  if (LN && a.has_gamma) {
    for (int f0 = 0; f0 < f; f0 += kChunk) {
      u_chunk(f0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < TR * kChunk; idx += kThreads) {
        const int r = idx / kChunk, j = idx % kChunk;
        float gv = 0.f, gd;
        if (f0 + j < f) gelu_and_grad(u_at(r * ldc + j, f0, j), &gv, &gd);
        gch[r * ldg + j] = nkbx::from_f<AT>(nkbx::round_to<T>(gv));
      }
      __syncthreads();
      if constexpr (TC) tc_gemm_wide<NRT, false>(gch, acc, lda, c, w1 + static_cast<size_t>(f0) * c, c, wbuf);
      else fma_gemm_wide<T, NRT>(gch, min(kChunk, f - f0), acc, lda, c, w1 + static_cast<size_t>(f0) * c, c, 1);
      __syncthreads();
    }
    for (int j = threadIdx.x; j < c; j += kThreads) {
      float sg = 0.f;
      for (int r = 0; r < TR && row0 + r < a.rows; ++r) {
        const float y = nkbx::round_to<T>(acc[r * lda + j] + a.b1[j]);
        sg += nkbx::round_to<T>(nkbx::to_f(dy[static_cast<size_t>(row0 + r) * c + j]) * y);
      }
      a.part_c[(3 * static_cast<size_t>(a.tiles) + tile) * c + j] = sg;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TR * lda; i += kThreads) acc[i] = 0.f;
    __syncthreads();
  }

  // 2. Per chunk: u, dgl = dy2 @ w1[f0:f0+64, :]^T, then g, du = dgl * gelu'(u)
  //    (g and round(du) to device memory, db0's tile sum), then
  //    dh (acc) += round(du) @ w0[:, f0:f0+64]^T.
  T* gact = static_cast<T*>(a.gact);
  T* du_out = static_cast<T*>(a.du);
  for (int f0 = 0; f0 < f; f0 += kChunk) {
    const int fn = min(kChunk, f - f0);
    u_chunk(f0);
    if constexpr (TC) tc_gemm_chunk<NRT, true>(d2s, ldh, c, w1 + static_cast<size_t>(f0) * c, c, gl, gl2, wbuf);
    else fma_gemm_chunk<T, NRT>(d2s, ldh, c, w1 + static_cast<size_t>(f0) * c, 1, c, fn, gl);
    __syncthreads();
    const int j = threadIdx.x % kChunk;  // this thread's column for all its rows
    float col = 0.f;
    for (int idx = threadIdx.x; idx < TR * kChunk; idx += kThreads) {
      const int r = idx / kChunk, gr = row0 + r;
      const int o = r * ldc + j;
      float dub = 0.f;
      if (j < fn && gr < a.rows) {
        float gv, gd;
        gelu_and_grad(u_at(o, f0, j), &gv, &gd);
        const float du = (TC ? gl[o] + gl2[o] : gl[o]) * gd;
        dub = nkbx::round_to<T>(du);
        col += du;
        const size_t go = static_cast<size_t>(gr) * f + f0 + j;
        gact[go] = nkbx::from_f<T>(gv);
        du_out[go] = nkbx::from_f<T>(dub);
      }
      gch[r * ldg + j] = nkbx::from_f<AT>(dub);
    }
    red[threadIdx.x] = col;
    __syncthreads();
    if (threadIdx.x < fn)
      a.part_f[static_cast<size_t>(tile) * f + f0 + threadIdx.x] =
          red[threadIdx.x] + red[threadIdx.x + 64] + red[threadIdx.x + 128] + red[threadIdx.x + 192];
    if constexpr (TC) tc_gemm_wide<NRT, true>(gch, acc, lda, c, w0 + f0, f, wbuf);
    else fma_gemm_wide<T, NRT>(gch, fn, acc, lda, c, w0 + f0, 1, f);
    __syncthreads();
  }

  // 3. K8: the tile's db1 = sum of dy, one thread per column, rows in
  //    order; dx = round(dh).
  if constexpr (!LN) {
    for (int j = threadIdx.x; j < c; j += kThreads) {
      float sdb1 = 0.f;
      for (int r = 0; r < TR && row0 + r < a.rows; ++r) sdb1 += nkbx::to_f(d2s[r * ldh + j]);
      a.part_c[static_cast<size_t>(tile) * c + j] = sdb1;
    }
    T* dx = static_cast<T*>(a.dx);
    for (int idx = threadIdx.x; idx < TR * c; idx += kThreads) {
      const int r = idx / c, j = idx - r * c;
      if (row0 + r < a.rows)
        dx[static_cast<size_t>(row0 + r) * c + j] = nkbx::from_f<T>(acc[r * lda + j]);
    }
  } else {
    // 3. LayerNorm backward. Column sums of the tile (ds, db, db1), one thread
    //    per column, rows in order; then dx, one warp per row.
    for (int j = threadIdx.x; j < c; j += kThreads) {
      float sds = 0.f, sdb = 0.f, sdb1 = 0.f;
      for (int r = 0; r < TR && row0 + r < a.rows; ++r) {
        const float xh = (nkbx::to_f(x[static_cast<size_t>(row0 + r) * c + j]) - mu_s[r]) * rstd_s[r];
        const float dh = acc[r * lda + j];
        sds = fmaf(dh, xh, sds);
        sdb += dh;
        sdb1 += nkbx::to_f(d2s[r * ldh + j]);
      }
      a.part_c[(0 * static_cast<size_t>(a.tiles) + tile) * c + j] = sds;
      a.part_c[(1 * static_cast<size_t>(a.tiles) + tile) * c + j] = sdb;
      a.part_c[(2 * static_cast<size_t>(a.tiles) + tile) * c + j] = sdb1;
    }
    T* dx = static_cast<T*>(a.dx);
    for (int r = warp; r < TR; r += kWarps) {
      const int gr = row0 + r;
      if (gr >= a.rows) continue;
      const T* xr = x + static_cast<size_t>(gr) * c;
      const float mu = mu_s[r], rstd = rstd_s[r];
      float m1 = 0.f, m2 = 0.f;
      for (int j = lane; j < c; j += 32) {
        const float dxh = acc[r * lda + j] * a.ln_s[j];
        m1 += dxh;
        m2 += dxh * ((nkbx::to_f(xr[j]) - mu) * rstd);
      }
      m1 = nkbx::warp_sum(m1) * inv_c;
      m2 = nkbx::warp_sum(m2) * inv_c;
      for (int j = lane; j < c; j += 32) {
        const float xh = (nkbx::to_f(xr[j]) - mu) * rstd;
        const float dxh = acc[r * lda + j] * a.ln_s[j];
        dx[static_cast<size_t>(gr) * c + j] = nkbx::from_f<T>(rstd * (dxh - m1 - xh * m2));
      }
    }
  }
}

// --- weight gradients: part[slab] = A[slab rows]^T B[slab rows] ------------------
// A (R, M) and B (R, N) row-major in T; part (slabs, M, N) float. Block
// (blockIdx.x, blockIdx.y, blockIdx.z) = (n tile, m tile, slab) of 64 x 64.

constexpr int kWTile = 64;
constexpr int kWLd = kWTile + 8;

__global__ void __launch_bounds__(kThreads)
wgrad_tc_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ part,
                int rows, int M, int N, int slab_rows) {
  __shared__ __align__(128) bf16 As[kSlabK * kWLd];
  __shared__ __align__(128) bf16 Bs[kSlabK * kWLd];
  const int n0 = blockIdx.x * kWTile, m0 = blockIdx.y * kWTile;
  const int r0 = blockIdx.z * slab_rows, r1 = min(r0 + slab_rows, rows);
  const int warp = threadIdx.x / 32;
  const int mt = warp / 2, nt0 = (warp % 2) * 2;
  using FragAc = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::col_major>;
  FragC acc[2];
  wm::fill_fragment(acc[0], 0.f);
  wm::fill_fragment(acc[1], 0.f);
  // each thread moves one 8-element vector of each 32 x 64 operand slab
  const int lr = threadIdx.x / 8, lc = 8 * (threadIdx.x % 8);
  for (int k0 = r0; k0 < r1; k0 += kSlabK) {
    const int r = k0 + lr;
    uint4 va = make_uint4(0, 0, 0, 0), vb = make_uint4(0, 0, 0, 0);
    if (r < r1 && m0 + lc < M) va = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(r) * M + m0 + lc);
    if (r < r1 && n0 + lc < N) vb = *reinterpret_cast<const uint4*>(B + static_cast<size_t>(r) * N + n0 + lc);
    *reinterpret_cast<uint4*>(As + lr * kWLd + lc) = va;
    *reinterpret_cast<uint4*>(Bs + lr * kWLd + lc) = vb;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlabK; kk += 16) {
      FragAc fa;  // element (m, k) = As[k][m]
      wm::load_matrix_sync(fa, As + kk * kWLd + 16 * mt, kWLd);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        FragBr fb;
        wm::load_matrix_sync(fb, Bs + kk * kWLd + 16 * (nt0 + i), kWLd);
        wm::mma_sync(acc[i], fa, fb, acc[i]);
      }
    }
    __syncthreads();
  }
  const int m = m0 + 16 * mt;
  if (m >= M) return;
  for (int i = 0; i < 2; ++i) {
    const int n = n0 + 16 * (nt0 + i);
    if (n < N)
      wm::store_matrix_sync(part + (static_cast<size_t>(blockIdx.z) * M + m) * N + n, acc[i], N,
                            wm::mem_row_major);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_fma_kernel(const T* __restrict__ A, const T* __restrict__ B, float* __restrict__ part,
                 int rows, int M, int N, int slab_rows) {
  __shared__ float As[kSlabK][kWTile + 1];
  __shared__ float Bs[kSlabK][kWTile + 1];
  const int n0 = blockIdx.x * kWTile, m0 = blockIdx.y * kWTile;
  const int r0 = blockIdx.z * slab_rows, r1 = min(r0 + slab_rows, rows);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int k0 = r0; k0 < r1; k0 += kSlabK) {
    for (int i = threadIdx.x; i < kSlabK * kWTile; i += kThreads) {
      const int lr = i / kWTile, lc = i % kWTile, r = k0 + lr;
      As[lr][lc] = r < r1 && m0 + lc < M ? nkbx::to_f(A[static_cast<size_t>(r) * M + m0 + lc]) : 0.f;
      Bs[lr][lc] = r < r1 && n0 + lc < N ? nkbx::to_f(B[static_cast<size_t>(r) * N + n0 + lc]) : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kSlabK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[k][ty + 16 * i];
        bv[i] = Bs[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * q;
      if (m < M && n < N) part[(static_cast<size_t>(blockIdx.z) * M + m) * N + n] = acc[i][q];
    }
}

// out[b, j] = sum over i < rows of in[b, i, j], in a fixed order: 8 strided
// partial sums per column, then added in order. blockIdx.y = b.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
ln_mlp_bwd_colsum_kernel(const float* __restrict__ in, OutT* __restrict__ out, int rows,
                         long long cols) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const long long j = static_cast<long long>(blockIdx.x) * 32 + tx;
  const float* base = in + static_cast<size_t>(blockIdx.y) * rows * cols;
  float s = 0.f;
  if (j < cols)
    for (int i = ty; i < rows; i += 8) s += base[static_cast<size_t>(i) * cols + j];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && j < cols) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += red[k][tx];
    out[static_cast<size_t>(blockIdx.y) * cols + j] = nkbx::from_f<OutT>(t);
  }
}

// --- launch ------------------------------------------------------------------------

template <typename T, bool TC, bool LN, int NRT>
cudaError_t launch_tile(const RowArgs& a, cudaStream_t s) {
  const size_t smem = row_layout(16 * NRT, a.c, TC, LN).total;
  cudaError_t err = nkbx::allow_smem(ln_mlp_bwd_row_kernel<T, TC, LN, NRT>, smem);
  if (err != cudaSuccess) return err;
  ln_mlp_bwd_row_kernel<T, TC, LN, NRT><<<a.tiles, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool TC, bool LN>
cudaError_t launch_rows(int tr, const RowArgs& a, cudaStream_t s) {
  switch (tr) {
    case 16: return launch_tile<T, TC, LN, 1>(a, s);
    case 32: return launch_tile<T, TC, LN, 2>(a, s);
    case 64: return launch_tile<T, TC, LN, 4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename OutT>
cudaError_t colsum(const float* in, void* out, int batch, int rows, long long cols,
                   cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((cols + 31) / 32), batch);
  ln_mlp_bwd_colsum_kernel<OutT><<<grid, kThreads, 0, s>>>(in, static_cast<OutT*>(out), rows, cols);
  return cudaGetLastError();
}

// out (M, N) in T = A^T B over R rows, through the slab partials.
template <typename T>
cudaError_t weight_grad(const void* A, const void* B, void* out, float* part, int rows, int M,
                        int N, int slab_rows, bool tc, cudaStream_t s) {
  const int slabs = (rows + slab_rows - 1) / slab_rows;
  const dim3 grid((N + kWTile - 1) / kWTile, (M + kWTile - 1) / kWTile, slabs);
  if (tc)
    wgrad_tc_kernel<<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(A),
                                               static_cast<const bf16*>(B), part, rows, M, N,
                                               slab_rows);
  else
    wgrad_fma_kernel<T><<<grid, kThreads, 0, s>>>(static_cast<const T*>(A),
                                                   static_cast<const T*>(B), part, rows, M, N,
                                                   slab_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return colsum<T>(part, out, 1, slabs, static_cast<long long>(M) * N, s);
}

// The row kernel, then the fixed-order sums: the C-sized vectors (K6: ds,
// db, db1[, dgamma]; K8: db1), db0, dw1 = g^T dy2 (K8: g^T dy) and
// dw0 = h^T du (K8: x^T du).
template <typename T, bool LN>
cudaError_t launch_all(const RowArgs& a, int tr, bool tc, void* dw0, void* dw1, void* dvec_c,
                       void* db0, float* part_w, int slab_rows, cudaStream_t s) {
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value)
    err = tc ? launch_rows<bf16, true, LN>(tr, a, s) : launch_rows<bf16, false, LN>(tr, a, s);
  else
    err = launch_rows<T, false, LN>(tr, a, s);
  if (err != cudaSuccess) return err;
  err = colsum<float>(a.part_c, dvec_c, LN ? 3 + a.has_gamma : 1, a.tiles, a.c, s);
  if (err != cudaSuccess) return err;
  err = colsum<float>(a.part_f, db0, 1, a.tiles, a.f, s);
  if (err != cudaSuccess) return err;
  const void* b1op = LN ? static_cast<const void*>(a.dy2) : a.dy;
  const void* a0op = LN ? static_cast<const void*>(a.h) : a.x;
  err = weight_grad<T>(a.gact, b1op, dw1, part_w, a.rows, a.f, a.c, slab_rows, tc, s);
  if (err != cudaSuccess) return err;
  return weight_grad<T>(a0op, a.du, dw0, part_w, a.rows, a.c, a.f, slab_rows, tc, s);
}

// --- the GEMM route (bf16, C % 32 == 0, F % 64 == 0) ---------------------------

namespace gm = nkbx::gemm;

constexpr int kRowTile = 64;  // rows a block of the row kernels (steps 1 and 4)
// du w0^T, g w1 and the weight gradients: 128 x 128 tiles of 4 warps of 64 x
// 64; step 2: 128 x 64 tiles of 4 warps, each two 64 x 32 accumulators
// (a 3-slab ring of both products' slabs). On the H100 about as fast as or
// faster than 8 warps a block, 64-deep slabs or another ring depth at the
// models' shapes (PERF.md).
using Wide = gm::Config<128, 2, 2, 4>;
using DualCfg = gm::Config<64, 2, 2, 3>;

constexpr int kLnRows = 8;  // rows a block of the warp-a-row kernels (steps 1 and 4)

// Step 1: h = round(LN(x)), dy2 = round(dy * round(gamma)) and the row
// statistics (mean at stats[r], rstd at stats[R + r]), one warp a row, four
// values a lane.
__global__ void __launch_bounds__(32 * kLnRows)
ln_mlp_bwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                       const float* __restrict__ ln_b, const float* __restrict__ gamma,
                       const bf16* __restrict__ dy, bf16* __restrict__ h, bf16* __restrict__ dy2,
                       float* __restrict__ stats, int rows, int c, float eps) {
  const int r = blockIdx.x * kLnRows + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;
  const size_t o = static_cast<size_t>(r) * c;
  const float2 st = gm::row_stats(x + o, c, eps);
  if (lane == 0) {
    stats[r] = st.x;
    stats[rows + r] = st.y;
  }
  for (int j = 4 * lane; j < c; j += 128) {
    const float4 v = gm::load4(x + o + j), d = gm::load4(dy + o + j);
    gm::store4(h + o + j, (v.x - st.x) * st.y * ln_s[j] + ln_b[j],
               (v.y - st.x) * st.y * ln_s[j + 1] + ln_b[j + 1],
               (v.z - st.x) * st.y * ln_s[j + 2] + ln_b[j + 2],
               (v.w - st.x) * st.y * ln_s[j + 3] + ln_b[j + 3]);
    gm::store4(dy2 + o + j, d.x * nkbx::round_to<bf16>(gamma[j]),
               d.y * nkbx::round_to<bf16>(gamma[j + 1]), d.z * nkbx::round_to<bf16>(gamma[j + 2]),
               d.w * nkbx::round_to<bf16>(gamma[j + 3]));
  }
}

// db1's partials: block (tile, chunk) sums rows 64 tile .. 64 tile + 63 of
// columns 64 chunk .. 64 chunk + 63 of dy2 into part[tile][col]; thread
// (rg, j) of a 4 x 64 grid adds 16 rows of column j in order, then the four
// groups are added in order.
__global__ void __launch_bounds__(kThreads)
ln_mlp_bwd_db1_kernel(const bf16* __restrict__ dy2, float* __restrict__ part, int rows, int c) {
  __shared__ float red[kThreads];
  const int j = threadIdx.x % 64, rg = threadIdx.x / 64;
  const int col = blockIdx.y * 64 + j, r0 = blockIdx.x * kRowTile + rg * (kRowTile / 4);
  const int r1 = min(r0 + kRowTile / 4, rows);
  float s = 0.f;
  if (col < c)
    for (int r = r0; r < r1; ++r) s += nkbx::to_f(dy2[static_cast<size_t>(r) * c + col]);
  red[threadIdx.x] = s;
  __syncthreads();
  if (rg == 0 && col < c)
    part[static_cast<size_t>(blockIdx.x) * c + col] = red[j] + red[64 + j] + red[128 + j] +
                                                      red[192 + j];
}

// Step 4: dx = rstd (dh s - mean(dh s) - xhat mean(dh s xhat)) for rows
// blockIdx.x * kLnRows + warp, where dh is the sum of its `slabs` float
// partials (stride R * C) added in order; four values a lane.
__global__ void __launch_bounds__(32 * kLnRows)
ln_mlp_bwd_lnb_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                      const float* __restrict__ stats, const float* __restrict__ dh, int slabs,
                      bf16* __restrict__ dx, int rows, int c) {
  const int r = blockIdx.x * kLnRows + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;
  const size_t o = static_cast<size_t>(r) * c, plane = static_cast<size_t>(rows) * c;
  auto dh4 = [&](int j) {
    float4 v = *reinterpret_cast<const float4*>(dh + o + j);
    for (int s = 1; s < slabs; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(dh + s * plane + o + j);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    return make_float4(v.x * ln_s[j], v.y * ln_s[j + 1], v.z * ln_s[j + 2], v.w * ln_s[j + 3]);
  };
  const float mu = stats[r], rstd = stats[rows + r];
  float m1 = 0.f, m2 = 0.f;
  for (int j = 4 * lane; j < c; j += 128) {
    const float4 d = dh4(j), v = gm::load4(x + o + j);
    m1 += (d.x + d.y) + (d.z + d.w);
    m2 += (d.x * ((v.x - mu) * rstd) + d.y * ((v.y - mu) * rstd)) +
          (d.z * ((v.z - mu) * rstd) + d.w * ((v.w - mu) * rstd));
  }
  const float inv_c = 1.f / c;
  m1 = nkbx::warp_sum(m1) * inv_c;
  m2 = nkbx::warp_sum(m2) * inv_c;
  for (int j = 4 * lane; j < c; j += 128) {
    const float4 d = dh4(j), v = gm::load4(x + o + j);
    gm::store4(dx + o + j, rstd * (d.x - m1 - (v.x - mu) * rstd * m2),
               rstd * (d.y - m1 - (v.y - mu) * rstd * m2),
               rstd * (d.z - m1 - (v.z - mu) * rstd * m2),
               rstd * (d.w - m1 - (v.w - mu) * rstd * m2));
  }
}

// Step 2's epilogue, on u = h w0 (acc) and dgl = dy2 w1^T (acc2) (K8: x w0
// and dy w1^T): g = round(gelu(u + b0)) and round(du), du = dgl * gelu'(u +
// b0) (one erf), to device memory through two shared bf16 tiles; the row
// tile's db0 = sum of the float du. Padded rows (gelu(b0) != 0 there) reach
// no store and no sum.
struct DualEpilogue {
  const float* __restrict__ b0;
  bf16* __restrict__ gact;
  bf16* __restrict__ du;
  float* __restrict__ part_f;
  int rows, f;

  template <class J>
  __device__ __forceinline__ void operator()(J& j, const gm::Tile& t, float* smem) const {
    constexpr int BN = DualCfg::BN, LD = BN + gm::kPad;
    bf16* gt = reinterpret_cast<bf16*>(smem);
    bf16* dt = gt + gm::kBM * LD;
    const float* bias = b0 + t.n0;
    const int rows_valid = rows - t.m0;
    float s[J::P::NT][2] = {};
    gm::for_pairs<J::P::MT, J::P::NT>(j.wm, j.wn, [&](int r, int col, int mt, int nt, int hi) {
      float gv[2], dv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float gd;
        gelu_and_grad(j.acc[mt][nt][2 * hi + e] + bias[col + e], &gv[e], &gd);
        dv[e] = j.acc2[mt][nt][2 * hi + e] * gd;
        if (r < rows_valid) s[nt][e] += dv[e];
      }
      *reinterpret_cast<unsigned*>(gt + r * LD + col) = nkbx::pack_bf16(gv[0], gv[1]);
      *reinterpret_cast<unsigned*>(dt + r * LD + col) = nkbx::pack_bf16(dv[0], dv[1]);
    });
    __syncthreads();
    const size_t o = static_cast<size_t>(t.m0) * f + t.n0;
    gm::copy_tile<BN, DualCfg::kThreads>(gt, gact + o, f, rows_valid, f - t.n0);
    gm::copy_tile<BN, DualCfg::kThreads>(dt, du + o, f, rows_valid, f - t.n0);
    __syncthreads();
    gm::block_column_sums<typename J::P, BN>(
        s, smem, j.wm, j.wn, part_f + static_cast<size_t>(t.m0 / gm::kBM) * f + t.n0, f - t.n0);
  }
};

// Step 6's epilogue (a layer-scale only), on g w1 (acc): the row tile's
// dgamma = sum of round(dy * round(acc + b1)); y itself is not stored.
struct GammaEpilogue {
  const float* __restrict__ b1;
  const bf16* __restrict__ dy;
  float* __restrict__ part_g;
  int rows, c;

  template <class J>
  __device__ __forceinline__ void operator()(J& j, const gm::Tile& t, float* red) const {
    float s[J::P::NT][2] = {};
    gm::for_pairs<J::P::MT, J::P::NT>(t.m0 + j.wm, t.n0 + j.wn, [&](int r, int col, int mt, int nt,
                                                                    int hi) {
      if (r >= rows || col >= c) return;
      const float2 d = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dy + static_cast<size_t>(r) * c + col));
      const float dd[2] = {d.x, d.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float y = nkbx::round_to<bf16>(j.acc[mt][nt][2 * hi + e] + b1[col + e]);
        s[nt][e] += nkbx::round_to<bf16>(dd[e] * y);
      }
    });
    gm::block_column_sums<typename J::P, Wide::BN>(
        s, red, j.wm, j.wn, part_g + static_cast<size_t>(t.m0 / gm::kBM) * c + t.n0, c - t.n0);
  }
};

// Step 3's epilogue, on slab blockIdx.y of dh = round(du) w0^T (acc): its
// float partial into dh (slabs, R, C), and the (slab, row tile)'s partials
// of ds = sum dh * xhat and db = sum dh into part_ds and part_db (row
// blockIdx.y * tiles_m + tile of each): the sums are linear in dh, so the
// slabs' partials add up to them. Padded rows reach no store and no sum.
struct DhEpilogue {
  float* __restrict__ dh;
  const bf16* __restrict__ x;
  const float* __restrict__ stats;
  float* __restrict__ part_ds;
  float* __restrict__ part_db;
  int rows, c;

  template <class J>
  __device__ __forceinline__ void operator()(J& j, const gm::Tile& t, float* red) const {
    float* base = dh + static_cast<size_t>(blockIdx.y) * rows * c;
    float sx[J::P::NT][2] = {}, sd[J::P::NT][2] = {};
    gm::for_pairs<J::P::MT, J::P::NT>(t.m0 + j.wm, t.n0 + j.wn, [&](int r, int col, int mt, int nt,
                                                                    int hi) {
      if (r >= rows || col >= c) return;
      const size_t o = static_cast<size_t>(r) * c + col;
      const float v0 = j.acc[mt][nt][2 * hi], v1 = j.acc[mt][nt][2 * hi + 1];
      *reinterpret_cast<float2*>(base + o) = make_float2(v0, v1);
      const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + o));
      const float mu = stats[r], rstd = stats[rows + r];
      sx[nt][0] += v0 * ((xv.x - mu) * rstd);
      sx[nt][1] += v1 * ((xv.y - mu) * rstd);
      sd[nt][0] += v0;
      sd[nt][1] += v1;
    });
    const size_t prow = static_cast<size_t>(blockIdx.y) * ((rows + gm::kBM - 1) / gm::kBM) +
                        t.m0 / gm::kBM;
    gm::block_column_sums<typename J::P, Wide::BN>(sx, red, j.wm, j.wn,
                                                   part_ds + prow * c + t.n0, c - t.n0);
    gm::block_column_sums<typename J::P, Wide::BN>(sd, red + J::P::kWarpsM * Wide::BN, j.wm, j.wn,
                                                   part_db + prow * c + t.n0, c - t.n0);
  }
};

// Rows of acc out (M, N) in T: the weight gradients' slab partials (out +
// blockIdx.y * M * N, float), or a weight gradient itself when its rows are
// one slab (bf16).
template <class T>
struct StoreEpilogue {
  T* __restrict__ out;
  int M, N;

  template <class J>
  __device__ __forceinline__ void operator()(J& j, const gm::Tile& t, float*) const {
    T* base = out + static_cast<size_t>(blockIdx.y) * M * N;
    gm::for_pairs<J::P::MT, J::P::NT>(t.m0 + j.wm, t.n0 + j.wn, [&](int r, int col, int mt, int nt,
                                                                    int hi) {
      if (r >= M || col >= N) return;
      T* p = base + static_cast<size_t>(r) * N + col;
      if constexpr (std::is_same<T, float>::value)
        *reinterpret_cast<float2*>(p) =
            make_float2(j.acc[mt][nt][2 * hi], j.acc[mt][nt][2 * hi + 1]);
      else
        *reinterpret_cast<unsigned*>(p) = nkbx::pack_bf16(j.acc[mt][nt][2 * hi],
                                                          j.acc[mt][nt][2 * hi + 1]);
    });
  }
};

template <class Cfg, bool A_KC, bool B_KC, class Epi>
__global__ void __launch_bounds__(Cfg::kThreads)
ln_mlp_bwd_gemm_kernel(gm::Operand a, gm::Operand b, int M, int N, int K, int slab_k, Epi epi) {
  gm::run<Cfg, A_KC, B_KC>(a, b, M, N, K, slab_k, epi);
}

template <class Cfg, bool A_KC, bool B_KC, class Epi>
cudaError_t launch_gemm(gm::Operand a, gm::Operand b, int M, int N, int K, int slab_k,
                        const Epi& epi, cudaStream_t s) {
  return gm::launch<Cfg, gm::Single<Cfg, A_KC, B_KC>>(ln_mlp_bwd_gemm_kernel<Cfg, A_KC, B_KC, Epi>,
                                                      M, N, (K + slab_k - 1) / slab_k, s, a, b, M,
                                                      N, K, slab_k, epi);
}

using DualJob = gm::Dual<DualCfg, true, false, true, true>;

// Step 2: u = h w0 and dgl = dy2 w1^T (K8: x w0 and dy w1^T) on one
// (128-row, 64-column) tile, both of depth C: A = h and dy2 contiguous in K,
// B = w0 (C, F) contiguous in N and w1^T (w1 is (F, C)) contiguous in K.
__global__ void __launch_bounds__(DualCfg::kThreads)
ln_mlp_bwd_dual_kernel(gm::Operand h, gm::Operand w0, gm::Operand dy2, gm::Operand w1t, int M,
                       int N, int K, DualEpilogue epi) {
  extern __shared__ __align__(256) unsigned char smem[];
  const gm::Tile t = gm::tile_of<DualCfg::BN>(M, N, K, K);
  DualJob job(h, w0, dy2, w1t, t, M, N);
  gm::mainloop<DualCfg::STAGES>(job, nkbx::smem_addr(smem), t.k0, t.k1);
  epi(job, t, reinterpret_cast<float*>(smem));
}

// out[i] = sum over slabs of part[slab][i] (n = M*N values, slab stride n),
// added in slab order, in bf16; four values a thread.
__global__ void __launch_bounds__(256)
ln_mlp_bwd_slab_sum_kernel(const float* __restrict__ part, int slabs, bf16* __restrict__ out,
                           long long n) {
  const long long i = 4 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float4 v = *reinterpret_cast<const float4*>(part + i);
  for (int s = 1; s < slabs; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(part + s * n + i);
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  uint2 o;
  o.x = nkbx::pack_bf16(v.x, v.y);
  o.y = nkbx::pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(out + i) = o;
}

struct GemmArgs {
  const bf16 *x, *w0, *w1, *dy;
  const float *ln_s, *ln_b, *b0, *b1, *gamma;
  bf16 *dx, *dw0, *dw1, *h, *dy2, *gact, *du;
  float *dvec_c, *db0, *dh, *stats, *part_c, *part_b1, *part_g, *part_f, *part_w;
  int rows, c, f, slab_f, slab_rows, has_gamma;
  float eps;
};

// out (M, N) in bf16 = A B over K = depth in slabs of slab_k (A_KC: A
// contiguous in K, else in M; B_KC: B contiguous in K, else in N): one launch
// when K is one slab, else the slabs' float partials in part and their sum,
// added in slab order.
template <bool A_KC, bool B_KC>
cudaError_t split_gemm(gm::Operand a, gm::Operand b, bf16* out, float* part, int M, int N,
                       int depth, int slab_k, cudaStream_t s) {
  const int slabs = (depth + slab_k - 1) / slab_k;
  if (slabs == 1)
    return launch_gemm<Wide, A_KC, B_KC>(a, b, M, N, depth, depth, StoreEpilogue<bf16>{out, M, N},
                                         s);
  cudaError_t err = launch_gemm<Wide, A_KC, B_KC>(a, b, M, N, depth, slab_k,
                                                  StoreEpilogue<float>{part, M, N}, s);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(M) * N;
  ln_mlp_bwd_slab_sum_kernel<<<static_cast<unsigned>((n / 4 + 255) / 256), 256, 0, s>>>(
      part, slabs, out, n);
  return cudaGetLastError();
}

// A^T B over R rows (A: rows of M values, B: of N) into out (M, N) in bf16,
// the rows in slabs of slab_rows (partials in part_w when there are several).
cudaError_t weight_grad_gemm(const bf16* A, const bf16* B, bf16* out, float* part_w, int rows,
                             int M, int N, int slab_rows, cudaStream_t s) {
  return split_gemm<false, false>({A, M}, {B, N}, out, part_w, M, N, rows, slab_rows, s);
}

// Steps 1-6 and the fixed-order sums of every vector and weight gradient.
cudaError_t launch_gemm_route(const GemmArgs& a, cudaStream_t s) {
  const int rows = a.rows, c = a.c, f = a.f;
  const int tiles = (rows + kRowTile - 1) / kRowTile, tiles_m = (rows + gm::kBM - 1) / gm::kBM;
  const int dh_slabs = (f + a.slab_f - 1) / a.slab_f;
  const unsigned row_blocks = static_cast<unsigned>((rows + kLnRows - 1) / kLnRows);
  ln_mlp_bwd_rows_kernel<<<row_blocks, 32 * kLnRows, 0, s>>>(a.x, a.ln_s, a.ln_b, a.gamma, a.dy,
                                                            a.h, a.dy2, a.stats, rows, c, a.eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_mlp_bwd_db1_kernel<<<dim3(tiles, (c + 63) / 64), kThreads, 0, s>>>(a.dy2, a.part_b1, rows, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = gm::launch<DualCfg, DualJob>(ln_mlp_bwd_dual_kernel, rows, f, 1, s, gm::Operand{a.h, c},
                                     gm::Operand{a.w0, f}, gm::Operand{a.dy2, c},
                                     gm::Operand{a.w1, c}, rows, f, c,
                                     DualEpilogue{a.b0, a.gact, a.du, a.part_f, rows, f});
  if (err != cudaSuccess) return err;
  if (a.has_gamma) {  // g w1: A = g contiguous in K = F, B = w1 (F, C) contiguous in N
    err = launch_gemm<Wide, true, false>({a.gact, f}, {a.w1, c}, rows, c, f, f,
                                         GammaEpilogue{a.b1, a.dy, a.part_g, rows, c}, s);
    if (err != cudaSuccess) return err;
  }
  // dh = round(du) w0^T in slabs of K = F, with the partials of ds and db:
  // A = du contiguous in K, B = w0^T contiguous in K
  const size_t ds_rows = static_cast<size_t>(dh_slabs) * tiles_m;
  err = launch_gemm<Wide, true, true>(
      {a.du, f}, {a.w0, f}, rows, c, f, a.slab_f,
      DhEpilogue{a.dh, a.x, a.stats, a.part_c, a.part_c + ds_rows * c, rows, c}, s);
  if (err != cudaSuccess) return err;
  ln_mlp_bwd_lnb_kernel<<<row_blocks, 32 * kLnRows, 0, s>>>(a.x, a.ln_s, a.stats, a.dh, dh_slabs,
                                                           a.dx, rows, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = colsum<float>(a.part_c, a.dvec_c, 2, static_cast<int>(ds_rows), c, s)) != cudaSuccess)
    return err;
  if ((err = colsum<float>(a.part_b1, a.dvec_c + 2 * c, 1, tiles, c, s)) != cudaSuccess)
    return err;
  if (a.has_gamma &&
      (err = colsum<float>(a.part_g, a.dvec_c + 3 * c, 1, tiles_m, c, s)) != cudaSuccess)
    return err;
  if ((err = colsum<float>(a.part_f, a.db0, 1, tiles_m, f, s)) != cudaSuccess) return err;
  // dw1 = g^T dy2 and dw0 = h^T round(du) over slabs of rows: A given
  // transposed (contiguous in M), B contiguous in N
  err = weight_grad_gemm(a.gact, a.dy2, a.dw1, a.part_w, rows, f, c, a.slab_rows, s);
  if (err != cudaSuccess) return err;
  return weight_grad_gemm(a.h, a.du, a.dw0, a.part_w, rows, c, f, a.slab_rows, s);
}

// K8's route: db1's partials of dy; the dual GEMM u = x w0 and dgl = dy w1^T
// (epilogue g, round(du) and db0's partials); dx = round(round(du) w0^T), K =
// F in slabs; the column sums of db1 and db0; dw1 = g^T dy and dw0 = x^T
// round(du) over slabs of rows. Reads x, dy, w0, w1, b0 and writes dx, dw0,
// dw1, dvec_c (= db1), db0 and the scratch gact, du, dh, part_b1, part_f,
// part_w of `a`; its other members are not read.
cudaError_t launch_mlp_bwd_gemm_route(const GemmArgs& a, cudaStream_t s) {
  const int rows = a.rows, c = a.c, f = a.f;
  const int tiles = (rows + kRowTile - 1) / kRowTile, tiles_m = (rows + gm::kBM - 1) / gm::kBM;
  ln_mlp_bwd_db1_kernel<<<dim3(tiles, (c + 63) / 64), kThreads, 0, s>>>(a.dy, a.part_b1, rows, c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = gm::launch<DualCfg, DualJob>(ln_mlp_bwd_dual_kernel, rows, f, 1, s, gm::Operand{a.x, c},
                                     gm::Operand{a.w0, f}, gm::Operand{a.dy, c},
                                     gm::Operand{a.w1, c}, rows, f, c,
                                     DualEpilogue{a.b0, a.gact, a.du, a.part_f, rows, f});
  if (err != cudaSuccess) return err;
  // dx: A = du contiguous in K = F, B = w0^T contiguous in K
  err = split_gemm<true, true>({a.du, f}, {a.w0, f}, a.dx, a.dh, rows, c, f, a.slab_f, s);
  if (err != cudaSuccess) return err;
  if ((err = colsum<float>(a.part_b1, a.dvec_c, 1, tiles, c, s)) != cudaSuccess) return err;
  if ((err = colsum<float>(a.part_f, a.db0, 1, tiles_m, f, s)) != cudaSuccess) return err;
  err = weight_grad_gemm(a.gact, a.dy, a.dw1, a.part_w, rows, f, c, a.slab_rows, s);
  if (err != cudaSuccess) return err;
  return weight_grad_gemm(a.x, a.du, a.dw0, a.part_w, rows, c, f, a.slab_rows, s);
}

}  // namespace

// K6's first design. x, dy, dx, h, dy2 (R, C); w0, dw0 (C, F); w1, dw1
// (F, C); gact, du (R, F) in float (is_bf16 = 0) or bf16; ln_s, ln_b, b1,
// gamma (C), b0 (F), dvec_c (4, C: ds, db, db1, dgamma) and db0 (F) in
// float; scratch part_c (4, tiles, C), part_f (tiles, F) and part_w
// (ceil(R / slab_rows), C*F) in float, where tiles = ceil(R / tile_rows).
// tile_rows is 16, 32 or 64; tensor_cores = 1 takes the bf16 tensor-core
// kernels (C % 32 == 0, F % 64 == 0); has_gamma = 0 skips y and dgamma.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int nkbx_ln_mlp_bwd(const void* x, const void* ln_s, const void* ln_b,
                               const void* w0, const void* b0, const void* w1, const void* b1,
                               const void* gamma, const void* dy, void* dx, void* dw0,
                               void* dw1, void* dvec_c, void* db0, void* h, void* dy2,
                               void* gact, void* du, void* part_c, void* part_f, void* part_w,
                               int rows, int c, int f, int tile_rows, int slab_rows, float eps,
                               int is_bf16, int tensor_cores, int has_gamma, void* stream) {
  if (tensor_cores && (!is_bf16 || c % kSlabK || f % kChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowArgs a{x, dy, w0, w1,
                  static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
                  static_cast<const float*>(b0), static_cast<const float*>(b1),
                  static_cast<const float*>(gamma),
                  dx, h, dy2, gact, du,
                  static_cast<float*>(part_c), static_cast<float*>(part_f),
                  rows, c, f, (rows + tile_rows - 1) / tile_rows, has_gamma, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pw = static_cast<float*>(part_w);
  return static_cast<int>(
      is_bf16 ? launch_all<bf16, true>(a, tile_rows, tensor_cores != 0, dw0, dw1, dvec_c, db0,
                                       pw, slab_rows, s)
              : launch_all<float, true>(a, tile_rows, false, dw0, dw1, dvec_c, db0, pw,
                                        slab_rows, s));
}

// K8. x, dy, dx (R, C); w0, dw0 (C, F); w1, dw1 (F, C); gact, du (R, F) in
// float (is_bf16 = 0) or bf16; b0 (F), b1 (C), db1 (C) and db0 (F) in
// float; scratch part_c (tiles, C), part_f (tiles, F) and part_w as for
// nkbx_ln_mlp_bwd. Returns the CUDA error code of the launches.
extern "C" int nkbx_mlp_bwd(const void* x, const void* w0, const void* b0, const void* w1,
                            const void* b1, const void* dy, void* dx, void* dw0, void* dw1,
                            void* db1, void* db0, void* gact, void* du, void* part_c,
                            void* part_f, void* part_w, int rows, int c, int f, int tile_rows,
                            int slab_rows, int is_bf16, int tensor_cores, void* stream) {
  if (tensor_cores && (!is_bf16 || c % kSlabK || f % kChunk))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowArgs a{x, dy, w0, w1,
                  nullptr, nullptr,
                  static_cast<const float*>(b0), static_cast<const float*>(b1), nullptr,
                  dx, nullptr, nullptr, gact, du,
                  static_cast<float*>(part_c), static_cast<float*>(part_f),
                  rows, c, f, (rows + tile_rows - 1) / tile_rows, 0, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pw = static_cast<float*>(part_w);
  return static_cast<int>(
      is_bf16 ? launch_all<bf16, false>(a, tile_rows, tensor_cores != 0, dw0, dw1, db1, db0,
                                        pw, slab_rows, s)
              : launch_all<float, false>(a, tile_rows, false, dw0, dw1, db1, db0, pw,
                                         slab_rows, s));
}

// K6 on the GEMM route. x, dy, dx (R, C); w0, dw0 (C, F); w1, dw1 (F, C) in
// bf16 with C % 32 == 0 and F % 64 == 0, every pointer 16-byte aligned; ln_s,
// ln_b, b1, gamma (C), b0 (F), dvec_c (4, C: ds, db, db1, dgamma) and db0 (F)
// in float. du w0^T runs in slabs of K = F of slab_f rows, the weight
// gradients in slabs of slab_rows rows (both multiples of 32). Scratch: h,
// dy2 (R, C) and gact, du (R, F) in bf16; in float dh (S, R, C) (S =
// ceil(F / slab_f): du w0^T's slab partials), stats (2, R), the partials
// part_c (2, S * ceil(R / 128), C) of ds and db, part_b1 (ceil(R / 64), C),
// part_g (ceil(R / 128), C) (has_gamma), part_f (ceil(R / 128), F) and part_w
// (ceil(R / slab_rows), C*F; unused when slab_rows >= R). has_gamma = 0 skips
// dgamma. Returns the CUDA error code of the launches (0 on success).
extern "C" int nkbx_ln_mlp_bwd_gemm(const void* x, const void* ln_s, const void* ln_b,
                                    const void* w0, const void* b0, const void* w1,
                                    const void* b1, const void* gamma, const void* dy, void* dx,
                                    void* dw0, void* dw1, void* dvec_c, void* db0, void* h,
                                    void* dy2, void* gact, void* du, void* dh, void* stats,
                                    void* part_c, void* part_b1, void* part_g, void* part_f,
                                    void* part_w, int rows, int c, int f, int slab_f,
                                    int slab_rows, float eps, int has_gamma, void* stream) {
  if (c % 32 || f % 64 || slab_f <= 0 || slab_f % gm::kBK || slab_rows <= 0 ||
      slab_rows % gm::kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  const GemmArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(w0),
                   static_cast<const bf16*>(w1), static_cast<const bf16*>(dy),
                   static_cast<const float*>(ln_s), static_cast<const float*>(ln_b),
                   static_cast<const float*>(b0), static_cast<const float*>(b1),
                   static_cast<const float*>(gamma),
                   static_cast<bf16*>(dx), static_cast<bf16*>(dw0), static_cast<bf16*>(dw1),
                   static_cast<bf16*>(h), static_cast<bf16*>(dy2), static_cast<bf16*>(gact),
                   static_cast<bf16*>(du),
                   static_cast<float*>(dvec_c), static_cast<float*>(db0),
                   static_cast<float*>(dh), static_cast<float*>(stats),
                   static_cast<float*>(part_c), static_cast<float*>(part_b1),
                   static_cast<float*>(part_g), static_cast<float*>(part_f),
                   static_cast<float*>(part_w),
                   rows, c, f, slab_f, slab_rows, has_gamma, eps};
  return static_cast<int>(launch_gemm_route(a, static_cast<cudaStream_t>(stream)));
}

// K8 on the GEMM route. x, dy, dx (R, C); w0, dw0 (C, F); w1, dw1 (F, C) in
// bf16 with C % 32 == 0 and F % 64 == 0, every pointer 16-byte aligned; b0
// (F), db1 (C) and db0 (F) in float. dx = round(du) w0^T runs in slabs of K =
// F of slab_f rows, the weight gradients in slabs of slab_rows rows (both
// multiples of 32). Scratch: gact, du (R, F) in bf16; in float dh (S, R, C)
// (S = ceil(F / slab_f), unused when S = 1), part_b1 (ceil(R / 64), C),
// part_f (ceil(R / 128), F) and part_w (ceil(R / slab_rows), C*F; unused when
// slab_rows >= R). Returns the CUDA error code of the launches (0 on success).
extern "C" int nkbx_mlp_bwd_gemm(const void* x, const void* w0, const void* b0, const void* w1,
                                 const void* dy, void* dx, void* dw0, void* dw1, void* db1,
                                 void* db0, void* gact, void* du, void* dh, void* part_b1,
                                 void* part_f, void* part_w, int rows, int c, int f, int slab_f,
                                 int slab_rows, void* stream) {
  if (c % 32 || f % 64 || slab_f <= 0 || slab_f % gm::kBK || slab_rows <= 0 ||
      slab_rows % gm::kBK)
    return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.w0 = static_cast<const bf16*>(w0);
  a.w1 = static_cast<const bf16*>(w1);
  a.dy = static_cast<const bf16*>(dy);
  a.b0 = static_cast<const float*>(b0);
  a.dx = static_cast<bf16*>(dx);
  a.dw0 = static_cast<bf16*>(dw0);
  a.dw1 = static_cast<bf16*>(dw1);
  a.gact = static_cast<bf16*>(gact);
  a.du = static_cast<bf16*>(du);
  a.dvec_c = static_cast<float*>(db1);
  a.db0 = static_cast<float*>(db0);
  a.dh = static_cast<float*>(dh);
  a.part_b1 = static_cast<float*>(part_b1);
  a.part_f = static_cast<float*>(part_f);
  a.part_w = static_cast<float*>(part_w);
  a.rows = rows;
  a.c = c;
  a.f = f;
  a.slab_f = slab_f;
  a.slab_rows = slab_rows;
  return static_cast<int>(launch_mlp_bwd_gemm_route(a, static_cast<cudaStream_t>(stream)));
}
