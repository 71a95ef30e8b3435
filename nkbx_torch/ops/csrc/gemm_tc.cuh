// The bf16 tensor-core GEMM of the LN -> MLP kernels (ln_mlp.cu: K5's
// route; ln_mlp_bwd.cu: K6's): C (M x N) = A (M x K) B (K x N), bf16
// operands, float accumulation, an epilogue chosen at compile time.
//
// What bounds it: at the MLP's shapes (K = C or F = 4C, M = rows) a block's
// 128-row tile reuses every weight byte 128 times, so the products, not the
// weights' traffic, set the time; each product then needs the tensor cores
// fed without stalls. So:
// - a block owns a 128 x BN tile, its warps in a WARPS_M x WARPS_N grid,
//   each a warp tile (64 x 64 for a single product: 8 ldmatrix.x4 feed 32
//   mma.sync.m16n8k16, so shared memory keeps pace with the tensor cores)
//   fed by ldmatrix (.trans for an operand whose contiguous dimension is not
//   the one ldmatrix walks);
// - the operands come through a STAGES-deep ring of BK-deep slabs (32 or
//   64), copied by 16-byte cp.async (one commit group a slab, STAGES - 1 in
//   flight); one barrier a slab;
// - each operand may lie either way in device memory: A contiguous in K
//   (row-major) or in M (given as its transpose, e.g. h^T, g^T), B contiguous
//   in N (row-major, w0 and w1) or in K (w0^T, w1^T);
// - rows past M, columns past N and depth past K are loaded as zeros by the
//   copy's zero-fill (src_bytes = 0); the epilogue stores nothing there;
// - the blocks walk the tiles in groups of kGroupM row tiles, column tile
//   after column tile, so neighbouring blocks share their B (weight) tiles
//   and their A tiles in L2;
// - an optional split of K (blockIdx.y a slab of K) gives each slab's float
//   partials to the epilogue, which writes them for a fixed-order sum: no
//   atomics, and a relaunch is bit-identical.
// The mainloop (`mainloop`, with a job's `load` and `compute`) is the seam
// where a later design puts wgmma and TMA; the epilogues see only the
// accumulator fragments and their coordinates.
//
// Fragment layouts are PTX's (mma.cuh): accumulator c[mt][nt][0..1] at row
// lane/4, columns 2 (lane % 4) + {0, 1} of the 16 x 8 tile (mt, nt); [2..3]
// the row + 8.
#pragma once

#include "dtype.cuh"
#include "mma.cuh"

namespace nkbx {
namespace gemm {

constexpr int kBM = 128;       // rows of a block tile
constexpr int kBK = 32;        // depth of a ring slab by default, and the unit of a split of K
constexpr int kPad = 8;        // bf16 padding of a shared row: 16 bytes, so the eight
                               // row addresses of an ldmatrix fall on distinct banks
constexpr int kGroupM = 8;     // row tiles of a group of the block order

using bf16 = __nv_bfloat16;

// An operand in device memory: element (i, j) of its stored (row-major) form
// at p[i * ld + j].
struct Operand {
  const bf16* p;
  int ld;
};

// A block's tile: rows m0 .., columns n0 .., and its slab of K.
struct Tile {
  int m0, n0, k0, k1;
};

// Tile of block (blockIdx.x, blockIdx.y) in the grouped order: kGroupM row
// tiles, then the next column tile. blockIdx.y is the slab of K (slab_k deep).
template <int BN>
__device__ __forceinline__ Tile tile_of(int M, int N, int K, int slab_k) {
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + BN - 1) / BN;
  const int pid = blockIdx.x, per_group = kGroupM * tiles_n;
  const int first = (pid / per_group) * kGroupM;
  const int size = min(tiles_m - first, kGroupM);
  const int in_group = pid % per_group;
  Tile t;
  t.m0 = (first + in_group % size) * kBM;
  t.n0 = (in_group / size) * BN;
  t.k0 = blockIdx.y * slab_k;
  t.k1 = min(K, t.k0 + slab_k);
  return t;
}

// Blocks of a launch: the tiles, times the slabs (gridDim.y).
template <int BN>
inline dim3 grid_of(int M, int N, int slabs) {
  return dim3(static_cast<unsigned>(((M + kBM - 1) / kBM) * ((N + BN - 1) / BN)),
              static_cast<unsigned>(slabs));
}

// Copy OUTER x INNER bf16 (INNER % 8 == 0) of a stored operand, rows outer0
// .., columns inner0 .., into shared memory at dst (row stride INNER + kPad)
// as 16-byte cp.async spread over the block's THREADS threads; rows at or
// past outer_end and columns at or past inner_end (a multiple of 8) are
// zero-filled.
template <int OUTER, int INNER, int THREADS>
__device__ __forceinline__ void load_tile(unsigned dst, Operand g, int outer0, int outer_end,
                                          int inner0, int inner_end) {
  constexpr int kChunks = INNER / 8, kTotal = OUTER * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + THREADS - 1) / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    if (kTotal % THREADS == 0 || i < kTotal) {
      const int o = i / kChunks, ci = (i % kChunks) * 8;
      const int go = outer0 + o, gi = inner0 + ci;
      const bool in = go < outer_end && gi < inner_end;
      cp_async16(dst + (o * (INNER + kPad) + ci) * 2,
                 in ? g.p + static_cast<size_t>(go) * g.ld + gi : g.p, in ? 16 : 0);
    }
  }
}

// One product A B on a 128 x BN block tile of WARPS_M x WARPS_N warps, a
// ring slab BK deep. A_KC: A contiguous in K (else in M); B_KC: B contiguous
// in K (else in N). A warp owns a WM x WN tile: MT x NT tiles of 16 x 8.
template <int BN, int WARPS_M, int WARPS_N, bool A_KC, bool B_KC, int BK>
struct Product {
  static constexpr int kWarpsM = WARPS_M, kWarpsN = WARPS_N;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = kBM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "a warp tile is whole 16 x 16 fragments");
  // shared row strides (elements) and slab sizes (bytes)
  static constexpr int LDA = A_KC ? BK + kPad : kBM + kPad;
  static constexpr int LDB = B_KC ? BK + kPad : BN + kPad;
  static constexpr int kABytes = (A_KC ? kBM : BK) * LDA * 2;
  static constexpr int kBBytes = (B_KC ? BN : BK) * LDB * 2;
  static constexpr int kBytes = kABytes + kBBytes;
  static_assert(kABytes % 128 == 0 && kBBytes % 128 == 0, "slabs keep 128-byte alignment");

  // Slab [k, k + BK) of the block tile (m0, n0) into the slot at `slot`.
  __device__ __forceinline__ static void load(unsigned slot, Operand a, Operand b, int m0, int M,
                                              int n0, int N, int k, int k_end) {
    if constexpr (A_KC) load_tile<kBM, BK, kThreads>(slot, a, m0, M, k, k_end);
    else load_tile<BK, kBM, kThreads>(slot, a, k, k_end, m0, M);
    if constexpr (B_KC) load_tile<BN, BK, kThreads>(slot + kABytes, b, n0, N, k, k_end);
    else load_tile<BK, BN, kThreads>(slot + kABytes, b, k, k_end, n0, N);
  }

  // acc += the slab in the slot at `slot`, for the warp tile at (wm, wn) of
  // the block tile.
  __device__ __forceinline__ static void compute(float (&acc)[MT][NT][4], unsigned slot, int wm,
                                                 int wn) {
    const unsigned as = slot, bs = slot + kABytes;
    const int lane = threadIdx.x % 32, mi = lane / 8, r8 = lane % 8;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[MT][4], b[NT / 2][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = wm + mt * 16;
        // matrices: rows m +0..7 / k +0..7, m +8..15 / k +0..7, m +0..7 / k +8..15, ...
        if constexpr (A_KC)
          ldmatrix_x4(a[mt], as + ((m + (mi % 2) * 8 + r8) * LDA + kk + (mi / 2) * 8) * 2);
        else
          ldmatrix_x4_trans(a[mt], as + ((kk + (mi / 2) * 8 + r8) * LDA + m + (mi % 2) * 8) * 2);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int n = wn + np * 16;
        // matrices: k +0..7 / n +0..7, k +8..15 / n +0..7, k +0..7 / n +8..15, ...
        if constexpr (B_KC)
          ldmatrix_x4(b[np], bs + ((n + (mi / 2) * 8 + r8) * LDB + kk + (mi % 2) * 8) * 2);
        else
          ldmatrix_x4_trans(b[np], bs + ((kk + (mi % 2) * 8 + r8) * LDB + n + (mi / 2) * 8) * 2);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          mma_bf16(acc[mt][2 * np], a[mt], b[np][0], b[np][1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[np][2], b[np][3]);
        }
    }
  }
};

// The mainloop: slabs [k_begin, k_end) in steps of Job::kBK through a ring
// of STAGES slots of Job::kStageBytes at `ring`. The job loads a slab into a slot
// (job.load(slot, k, k_end)) and multiplies the slot into its accumulators
// (job.compute(slot)). Returns with every copy landed and the ring free.
template <int STAGES, class Job>
__device__ __forceinline__ void mainloop(Job& job, unsigned ring, int k_begin, int k_end) {
  constexpr int BK = Job::kBK;
  const int slabs = (k_end - k_begin + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slabs) job.load(ring + s * Job::kStageBytes, k_begin + s * BK, k_end);
    cp_async_commit();
  }
  for (int t = 0; t < slabs; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab t landed for all; slot (t - 1) % STAGES is free
    const int next = t + STAGES - 1;
    if (next < slabs)
      job.load(ring + (next % STAGES) * Job::kStageBytes, k_begin + next * BK, k_end);
    cp_async_commit();
    job.compute(ring + (t % STAGES) * Job::kStageBytes);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// A launch configuration: 128 x BN block tiles of WARPS_M x WARPS_N warps, a
// ring of STAGES slabs BK deep.
template <int BN_, int WARPS_M_, int WARPS_N_, int STAGES_, int BK_ = kBK>
struct Config {
  static constexpr int BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, STAGES = STAGES_;
  static constexpr int BK = BK_;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
};

// One product into one accumulator.
template <class Cfg, bool A_KC, bool B_KC>
struct Single {
  using P = Product<Cfg::BN, Cfg::WARPS_M, Cfg::WARPS_N, A_KC, B_KC, Cfg::BK>;
  static constexpr int kStageBytes = P::kBytes, kBK = Cfg::BK;
  Operand a, b;
  int m0, M, n0, N, wm, wn;
  float acc[P::MT][P::NT][4];

  __device__ __forceinline__ Single(Operand a_, Operand b_, const Tile& t, int M_, int N_)
      : a(a_), b(b_), m0(t.m0), M(M_), n0(t.n0), N(N_) {
    const int warp = threadIdx.x / 32;
    wm = (warp / P::kWarpsN) * P::WM;
    wn = (warp % P::kWarpsN) * P::WN;
#pragma unroll
    for (int i = 0; i < P::MT; ++i)
#pragma unroll
      for (int j = 0; j < P::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }
  __device__ __forceinline__ void load(unsigned slot, int k, int k_end) {
    P::load(slot, a, b, m0, M, n0, N, k, k_end);
  }
  __device__ __forceinline__ void compute(unsigned slot) { P::compute(acc, slot, wm, wn); }
};

// Two products of the same depth on the same block tile, each into its own
// accumulator (K6's u = h w0 and dgl = dy2 w1^T).
template <class Cfg, bool A_KC, bool B_KC, bool A2_KC, bool B2_KC>
struct Dual {
  using P = Product<Cfg::BN, Cfg::WARPS_M, Cfg::WARPS_N, A_KC, B_KC, Cfg::BK>;
  using P2 = Product<Cfg::BN, Cfg::WARPS_M, Cfg::WARPS_N, A2_KC, B2_KC, Cfg::BK>;
  static constexpr int kStageBytes = P::kBytes + P2::kBytes, kBK = Cfg::BK;
  Operand a, b, a2, b2;
  int m0, M, n0, N, wm, wn;
  float acc[P::MT][P::NT][4], acc2[P2::MT][P2::NT][4];

  __device__ __forceinline__ Dual(Operand a_, Operand b_, Operand a2_, Operand b2_, const Tile& t,
                                  int M_, int N_)
      : a(a_), b(b_), a2(a2_), b2(b2_), m0(t.m0), M(M_), n0(t.n0), N(N_) {
    const int warp = threadIdx.x / 32;
    wm = (warp / P::kWarpsN) * P::WM;
    wn = (warp % P::kWarpsN) * P::WN;
#pragma unroll
    for (int i = 0; i < P::MT; ++i)
#pragma unroll
      for (int j = 0; j < P::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = acc2[i][j][e] = 0.f;
  }
  __device__ __forceinline__ void load(unsigned slot, int k, int k_end) {
    P::load(slot, a, b, m0, M, n0, N, k, k_end);
    P2::load(slot + P::kBytes, a2, b2, m0, M, n0, N, k, k_end);
  }
  __device__ __forceinline__ void compute(unsigned slot) {
    P::compute(acc, slot, wm, wn);
    P2::compute(acc2, slot + P::kBytes, wm, wn);
  }
};

// The body of a single-product kernel: block (blockIdx.x, blockIdx.y)'s tile
// and slab of K (slab_k deep) through the mainloop, then epi(job, tile,
// shared memory as floats).
template <class Cfg, bool A_KC, bool B_KC, class Epi>
__device__ __forceinline__ void run(Operand a, Operand b, int M, int N, int K, int slab_k,
                                    const Epi& epi) {
  extern __shared__ __align__(256) unsigned char smem[];
  const Tile t = tile_of<Cfg::BN>(M, N, K, slab_k);
  Single<Cfg, A_KC, B_KC> job(a, b, t, M, N);
  mainloop<Cfg::STAGES>(job, smem_addr(smem), t.k0, t.k1);
  epi(job, t, reinterpret_cast<float*>(smem));
}

// Launch a kernel of the job Job (Single or Dual) under Cfg: one block a
// tile of the (M, N) output and slab of K; Job's ring in dynamic shared
// memory. Returns the launch's error.
template <class Cfg, class Job, class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int M, int N, int slabs, cudaStream_t s, Args... args) {
  constexpr size_t smem = Cfg::STAGES * Job::kStageBytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of<Cfg::BN>(M, N, slabs), Cfg::kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

// f(row, col, mt, nt, hi) for each pair of adjacent columns (col, col + 1) of
// a warp's accumulators: acc[mt][nt][2 hi], acc[mt][nt][2 hi + 1]. Rows and
// columns are the block tile's plus (m0, n0).
template <int MT, int NT, class F>
__device__ __forceinline__ void for_pairs(int m0, int n0, F&& f) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        f(m0 + mt * 16 + lane / 4 + hi * 8, n0 + nt * 8 + 2 * (lane % 4), mt, nt, hi);
}

// Copy rows < rows_valid and columns < n_valid (a multiple of 8) of a
// shared bf16 tile (kBM rows of BN + kPad) to dst (row stride ld) as 16-byte
// stores, so each row's bytes leave in whole sectors.
template <int BN, int THREADS>
__device__ __forceinline__ void copy_tile(const bf16* tile, bf16* __restrict__ dst, size_t ld,
                                          int rows_valid, int n_valid) {
  constexpr int LD = BN + kPad, kChunks = BN / 8;
  for (int i = threadIdx.x; i < kBM * kChunks; i += THREADS) {
    const int r = i / kChunks, col = (i % kChunks) * 8;
    if (r < rows_valid && col < n_valid)
      *reinterpret_cast<uint4*>(dst + r * ld + col) =
          *reinterpret_cast<const uint4*>(tile + r * LD + col);
  }
}

// A block tile's bf16 output through shared memory: each thread writes its
// pairs (f(row, col, mt, nt, hi) gives the two values packed, in tile
// coordinates) into `tile` (kBM rows of BN + kPad bf16: the fragments' eight
// rows fall on distinct banks), then copy_tile. All threads call it; `tile`
// is free again when it returns.
template <class P, int BN, class F>
__device__ __forceinline__ void store_tile(F&& f, bf16* tile, int wm, int wn,
                                           bf16* __restrict__ dst, size_t ld, int rows_valid,
                                           int n_valid) {
  for_pairs<P::MT, P::NT>(wm, wn, [&](int r, int col, int mt, int nt, int hi) {
    *reinterpret_cast<unsigned*>(tile + r * (BN + kPad) + col) = f(r, col, mt, nt, hi);
  });
  __syncthreads();
  copy_tile<BN, P::kThreads>(tile, dst, ld, rows_valid, n_valid);
  __syncthreads();
}

// Column sums of a block tile in a fixed order. s[nt][j] is this thread's
// sum over its rows of column wn + nt*8 + 2 (lane % 4) + j of the block tile;
// the lanes of a column are added by a butterfly, then the kWarpsM warps of a
// column band in order through `red` (kWarpsM * BN floats of shared memory),
// and out[col] receives column col for col < n_valid. All threads call it.
template <class P, int BN>
__device__ __forceinline__ void block_column_sums(float (&s)[P::NT][2], float* red, int wm, int wn,
                                                  float* __restrict__ out, int n_valid) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < P::NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = s[nt][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      s[nt][j] = v;
    }
  if (lane < 4) {
#pragma unroll
    for (int nt = 0; nt < P::NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) red[(wm / P::WM) * BN + wn + nt * 8 + 2 * lane + j] = s[nt][j];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < BN; col += P::kThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < P::kWarpsM; ++w) t += red[w * BN + col];
    if (col < n_valid) out[col] = t;
  }
}

// --- rows ----------------------------------------------------------------------

// Four bf16 at p (8-byte aligned) as floats, and four floats rounded to
// bf16 into p.
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(a, b), pack_bf16(c, d));
}

// (mean, 1 / sqrt(var + eps)) of a bf16 row of c values (c % 4 == 0), by
// one warp in float, four values a lane: flax's fast variance E[x^2] -
// mean^2, clamped at 0.
__device__ __forceinline__ float2 row_stats(const bf16* __restrict__ xr, int c, float eps) {
  const int lane = threadIdx.x % 32;
  float s = 0.f, s2 = 0.f;
  for (int j = 4 * lane; j < c; j += 128) {
    const float4 v = load4(xr + j);
    s += (v.x + v.y) + (v.z + v.w);
    s2 += (v.x * v.x + v.y * v.y) + (v.z * v.z + v.w * v.w);
  }
  const float inv_c = 1.f / c;
  const float mu = warp_sum(s) * inv_c;
  const float var = fmaxf(warp_sum(s2) * inv_c - mu * mu, 0.f);
  return make_float2(mu, rsqrtf(var + eps));
}

__device__ __forceinline__ float gelu(float u) {
  return 0.5f * u * (1.f + erff(u * 0.70710678118654752f));
}

}  // namespace gemm
}  // namespace nkbx
