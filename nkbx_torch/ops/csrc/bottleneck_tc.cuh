// The chain's route on gemm_tc.cuh's tensor-core GEMM: K9's C entry
// nkbx_chain_fwd_gemm (bottleneck.cu) and K10's nkbx_chain_bwd_gemm
// (bottleneck_bwd.cu), bf16 with C and M multiples of 32 (every chain block
// of the ResNets). The same function as the first design (bottleneck.cuh),
// at the same rounding points and with the same tile-local statistics; f32
// and other widths keep the first design.
//
// What held the first design back: WMMA from shared memory without a ring,
// every f32 intermediate (u1, u2, u3, da1, da2) written and read again by a
// statistics pass and an elementwise pass of one scalar a thread. Here:
// - Every product is one GEMM on the engine (mma.sync fed by ldmatrix from a
//   cp.async ring; 128 x 64 block tiles of 4 warps of 64 x 32). Its A rows
//   come through a row map (`FlatRows`, `G2ERows`, `E2GTileRows`): each
//   thread copies the same four rows of every ring slab, so it computes
//   their map once and, per slab, only the tap's offset; a row that maps to
//   nothing is zero-filled by the copy (src_bytes = 0). The 3x3 convolution
//   and its input gradient are one GEMM each with K = 9 M (M % 32 == 0, so a
//   slab lies inside one tap), w2 read per tap, flipped and transposed for
//   the input gradient.
// - The weight gradients are GEMMs over slabs of rows (blockIdx.y), the row
//   map along K read from a table built once a call (`maps_kernel`) a slab
//   ahead of the copies that use it, into float partials that `wgrad_sum`
//   adds in slab order.
// - The per-tile statistics and the BN-backward sums come from the GEMM
//   epilogues, from the float accumulators before any rounding: the block
//   tile's values are staged in shared memory and each column is summed over
//   every piece of a run of rows the tile meets (a run: one sample's band of
//   th W rows in the global layout, one tile's g (th + 2) W rows in the ext
//   layout; a 128-row block tile may meet several). `stats_finish` and
//   `bn_finish` add a tile's pieces in a fixed order (`stats_finish` also
//   writes rstd = rsqrt(var + eps) once a tile and channel, for every later
//   reader). No atomics: a relaunch is bit-identical.
// - An epilogue that reads a row-major operand at its tile (x, dout, dy, u1,
//   u2) copies the tile into shared memory by 16-byte cp.async once the
//   mainloop is done, and a block computes its rows' tiles once (a row
//   table), not each thread for each of its fragment rows.
// - u3 is never stored: K9 computes a2 w3 twice (its statistics, then the
//   output in the epilogue) and K10 three times (statistics; dy and its
//   sums; du3), 2 R M C operations each against 2 x 4 R C bytes of f32.
// - a1, a2, du2 and du1 come from 16-byte vector passes over the stored f32
//   u1, u2, dz2 and dz1 (the gated da2 and da1), eight channels a thread.
#pragma once

#include "bottleneck.cuh"
#include "gemm_tc.cuh"

namespace chain {
namespace tc {

namespace gm = nkbx::gemm;

// 128 x 64 block tiles, 4 warps of 64 x 32, a ring of 4 slabs 32 deep.
using Cfg = gm::Config<64, 2, 2, 4>;
constexpr int kBN = Cfg::BN, kThreads = Cfg::kThreads;
constexpr int kLdF = kBN + 8;  // floats a row of a staged tile: the fragments' float2
                               // stores of a half-warp fall on distinct banks
constexpr int kTileBytes = gm::kBM * kLdF * 4;  // bytes of a float tile

// --- runs of rows and their partial sums -----------------------------------------

// Runs of `len` consecutive rows of a product (run q: rows [q len, (q + 1)
// len)); block tile b's part of run q is its piece b - first(q), first(q) =
// q len / 128, and a run has at most `pieces` of them. part holds two planes
// of (count * pieces, n) floats.
struct Runs {
  float* part;
  int len, pieces, count, n;
};

inline int most_pieces(int len) { return (len + gm::kBM - 1) / gm::kBM + 1; }

// The global layout's runs: one sample's band, th W rows (count B H / th).
inline Runs global_runs(const Geo& G, float* part, int n) {
  const int len = G.th * G.w;
  return Runs{part, len, most_pieces(len), G.b * G.nh, n};
}

// The ext layout's runs: one tile's g (th + 2) W rows (count nt).
inline Runs ext_runs(const Geo& G, float* part, int n) {
  const int len = G.g * G.the * G.w;
  return Runs{part, len, most_pieces(len), G.nt, n};
}

// Run q's pieces of column col of one plane, added in order.
__device__ __forceinline__ float run_total(const float* plane, const Runs& R, int q, int col) {
  const int first = (q * R.len) / gm::kBM, last = ((q + 1) * R.len - 1) / gm::kBM;
  float s = 0.f;
  for (int b = first; b <= last; ++b)
    s += plane[(static_cast<size_t>(q) * R.pieces + b - first) * R.n + col];
  return s;
}

// Run q of tile t's r-th run: the global layout's runs of its g samples at
// band j, or (ext) the tile itself.
__device__ __forceinline__ int run_of(const Geo& G, bool ext, int t, int r) {
  return ext ? t : ((t / G.nh) * G.g + r) * G.nh + t % G.nh;
}

// mean, var = max(E[u^2] - mean^2, 0) and rstd = rsqrt(var + eps) of tile
// blockIdx.y over its core rows, from the pieces of Σu (plane 0) and Σu²
// (plane 1); one thread a column.
__global__ void stats_finish(Runs R, Geo G, float* __restrict__ mean, float* __restrict__ var,
                             float* __restrict__ rstd, float eps) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x, t = blockIdx.y;
  if (col >= R.n) return;
  const size_t plane = static_cast<size_t>(R.count) * R.pieces * R.n;
  float s = 0.f, s2 = 0.f;
  for (int r = 0; r < G.g; ++r) {
    const int q = run_of(G, false, t, r);
    s += run_total(R.part, R, q, col);
    s2 += run_total(R.part + plane, R, q, col);
  }
  const int n = G.g * G.th * G.w;
  const float mu = s / n, v = fmaxf(s2 / n - mu * mu, 0.f);
  const size_t o = static_cast<size_t>(t) * R.n + col;
  mean[o] = mu;
  var[o] = v;
  rstd[o] = rsqrtf(v + eps);
}

// A BN as the route reads it: the per-tile mean and rstd (nt, n), scale and
// bias (n).
struct Norm {
  const float *mean, *rstd, *scale, *bias;
};

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// A BN backward's per-tile sums over all the tile's rows (its core rows, or
// with `ext` its ext rows): sums[t][col] = Σ dz (plane 0), sums[nt + t][col]
// = Σ dz xhat (plane 1).
__global__ void bn_finish(Runs R, Geo G, int ext, float* __restrict__ sums) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x, t = blockIdx.y;
  if (col >= R.n) return;
  const size_t plane = static_cast<size_t>(R.count) * R.pieces * R.n;
  float s = 0.f, s2 = 0.f;
  for (int r = 0; r < (ext ? 1 : G.g); ++r) {
    const int q = run_of(G, ext != 0, t, r);
    s += run_total(R.part, R, q, col);
    s2 += run_total(R.part + plane, R, q, col);
  }
  sums[static_cast<size_t>(t) * R.n + col] = s;
  sums[(static_cast<size_t>(G.nt) + t) * R.n + col] = s2;
}

// db = Σ over tiles of plane 0 and ds = of plane 1 (blockIdx.z), in a fixed
// order: kSL lanes add strided tiles in order, then lane 0 adds the lanes.
__global__ void tile_colsum(const float* __restrict__ sums, float* __restrict__ db,
                            float* __restrict__ ds, int nt, int n) {
  __shared__ float red[kSL][kSC];
  const int col = blockIdx.x * kSC + threadIdx.x, lane = threadIdx.y;
  const float* in = sums + static_cast<size_t>(blockIdx.z) * nt * n;
  float s = 0.f;
  if (col < n)
    for (int t = lane; t < nt; t += kSL) s += in[static_cast<size_t>(t) * n + col];
  red[lane][threadIdx.x] = s;
  __syncthreads();
  if (lane == 0 && col < n) {
    for (int l = 1; l < kSL; ++l) s += red[l][threadIdx.x];
    (blockIdx.z ? ds : db)[col] = s;
  }
}

// --- the products ----------------------------------------------------------------

// A row maps of the products: `at` computes a row's state once, `src` the
// source row at 3x3 tap (dy, dx) or -1 (zeros).
struct FlatRows {  // the row itself
  struct Row {
    int r;
  };
  __device__ __forceinline__ Row at(const Geo&, int row, int rows) const {
    return {row < rows ? row : -1};
  }
  __device__ __forceinline__ int src(const Geo&, const Row& s, int, int) const { return s.r; }
};

struct G2ERows {  // bottleneck.cuh's kG2E: global row -> ext row of its tile
  struct Row {
    int base, w;  // the ext row at tap (0, 1); -1 past the rows
  };
  __device__ __forceinline__ Row at(const Geo& G, int row, int rows) const {
    if (row >= rows) return {-1, 0};
    const int w = row % G.w, bh = row / G.w, h = bh % G.h, b = bh / G.h;
    const int t = (b / G.g) * G.nh + h / G.th;
    return {((t * G.g + b % G.g) * G.the + h % G.th) * G.w + w, w};
  }
  __device__ __forceinline__ int src(const Geo& G, const Row& s, int dy, int dx) const {
    const int ww = s.w + dx - 1;
    return (s.base < 0 || ww < 0 || ww >= G.w) ? -1 : s.base + dy * G.w + dx - 1;
  }
};

struct E2GTileRows {  // kE2GTile: ext row -> global row of its tile's core
  struct Row {
    int base, he, w;  // the global row of band row he - 2 at tap (0, 1)
  };
  __device__ __forceinline__ Row at(const Geo& G, int row, int rows) const {
    if (row >= rows) return {0, -G.the, 0};
    const int w = row % G.w;
    int r = row / G.w;
    const int he = r % G.the;
    r /= G.the;
    const int gi = r % G.g, t = r / G.g, i = t / G.nh, j = t % G.nh;
    return {((i * G.g + gi) * G.h + j * G.th + he - 2) * G.w + w, he, w};
  }
  __device__ __forceinline__ int src(const Geo& G, const Row& s, int dy, int dx) const {
    const int hr = s.he + dy - 2, ww = s.w + dx - 1;
    return (hr < 0 || hr >= G.th || ww < 0 || ww >= G.w) ? -1 : s.base + dy * G.w + dx - 1;
  }
};

// out (M, N) = sum over taps of A[src(r, tap)] (rows of kt values) times B's
// tap: B_KC false, B (taps kt, N) row-major; B_KC true, tap s stored (N, kt)
// at b + s' N kt with s' = taps - 1 - s when flip (the 3x3 input gradient's
// flipped, transposed w2), else s. One tap: (dy, dx) = (1, 1).
struct ConvArgs {
  const bf16* a;
  const bf16* b;
  int M, N, kt, taps, flip;
  Geo G;
};

template <class Map, bool B_KC>
struct ConvJob {
  using P = gm::Product<Cfg::BN, Cfg::WARPS_M, Cfg::WARPS_N, true, B_KC, Cfg::BK>;
  static constexpr int kStageBytes = P::kBytes, kBK = Cfg::BK;
  static constexpr int kChunks = kBK / 8, kRowStep = kThreads / kChunks;
  static constexpr int kRows = gm::kBM / kRowStep;  // A rows a thread copies, the same each slab
  ConvArgs p;
  Map map;
  int m0, n0, wm, wn;
  typename Map::Row rows[kRows];
  float acc[P::MT][P::NT][4];

  __device__ __forceinline__ ConvJob(const ConvArgs& p_, const Map& map_, const gm::Tile& t)
      : p(p_), map(map_), m0(t.m0), n0(t.n0) {
    const int warp = threadIdx.x / 32;
    wm = (warp / P::kWarpsN) * P::WM;
    wn = (warp % P::kWarpsN) * P::WN;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      rows[i] = map.at(p.G, m0 + i * kRowStep + threadIdx.x / kChunks, p.M);
#pragma unroll
    for (int i = 0; i < P::MT; ++i)
#pragma unroll
      for (int j = 0; j < P::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  __device__ __forceinline__ void load(unsigned slot, int k, int k_end) {
    const int tap = k / p.kt, kk = k - tap * p.kt;
    const int dy = p.taps == 1 ? 1 : tap / 3, dx = p.taps == 1 ? 1 : tap % 3;
    const int ci = (threadIdx.x % kChunks) * 8;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int o = i * kRowStep + threadIdx.x / kChunks;
      const int s = map.src(p.G, rows[i], dy, dx);
      nkbx::cp_async16(slot + (o * P::LDA + ci) * 2,
                       s >= 0 ? p.a + static_cast<size_t>(s) * p.kt + kk + ci : p.a,
                       s >= 0 ? 16 : 0);
    }
    if constexpr (B_KC) {
      const int tb = p.flip ? p.taps - 1 - tap : tap;
      gm::load_tile<kBN, kBK, kThreads>(
          slot + P::kABytes, gm::Operand{p.b + static_cast<size_t>(tb) * p.N * p.kt, p.kt}, n0,
          p.N, kk, p.kt);
    } else {
      gm::load_tile<kBK, kBN, kThreads>(slot + P::kABytes, gm::Operand{p.b, p.N}, k, k_end, n0,
                                        p.N);
    }
  }
  __device__ __forceinline__ void compute(unsigned slot) { P::compute(acc, slot, wm, wn); }
};

// Shared memory of a block: the ring, then, once the mainloop is done, the
// epilogue's operand tiles (kPre bytes, fetched then: fetched before the
// mainloop they would need their own room, and fewer blocks would share an
// SM) and its own tiles and row table (kPost bytes), which its `prepare`
// starts.
template <int STAGES, class Map, bool B_KC, class Epi>
__global__ void __launch_bounds__(kThreads) chain_gemm(ConvArgs p, Map map, Epi epi) {
  extern __shared__ __align__(256) unsigned char smem[];
  const int depth = p.kt * p.taps;
  const gm::Tile t = gm::tile_of<kBN>(p.M, p.N, depth, depth);
  ConvJob<Map, B_KC> job(p, map, t);
  gm::mainloop<STAGES>(job, nkbx::smem_addr(smem), 0, depth);
  epi.prepare(t, smem, smem + Epi::kPre);
  nkbx::cp_async_wait<0>();
  __syncthreads();
  epi(job, t, smem, smem + Epi::kPre);
}

template <int STAGES, bool B_KC, class Map, class Epi>
cudaError_t product_in(const ConvArgs& p, const Map& map, const Epi& epi, cudaStream_t s) {
  constexpr size_t ring = STAGES * ConvJob<Map, B_KC>::kStageBytes;
  constexpr size_t bytes = ring > Epi::kPre + Epi::kPost ? ring : Epi::kPre + Epi::kPost;
  auto kernel = chain_gemm<STAGES, Map, B_KC, Epi>;
  cudaError_t err = nkbx::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<gm::grid_of<kBN>(p.M, p.N, 1), kThreads, bytes, s>>>(p, map, epi);
  return cudaGetLastError();
}

// One product, a block a 128 x 64 tile: a ring of 4 slabs, or of 2 where K
// is at most 3 slabs (a2 w3 and du1 w1^T at M = 64: the smaller ring lets
// more blocks share an SM).
template <bool B_KC, class Map, class Epi>
cudaError_t product(const ConvArgs& p, const Map& map, const Epi& epi, cudaStream_t s) {
  static_assert(Epi::kPre % 256 == 0, "the epilogue's tiles stay aligned");
  if (p.M == 0) return cudaSuccess;
  return p.kt * p.taps <= 3 * Cfg::BK ? product_in<2, B_KC>(p, map, epi, s)
                                      : product_in<Cfg::STAGES, B_KC>(p, map, epi, s);
}

// --- epilogue helpers ------------------------------------------------------------

constexpr int kLdH = kBN + gm::kPad;            // bf16 a row of an operand tile
constexpr int kHalfTile = gm::kBM * kLdH * 2;   // bytes of a bf16 operand tile
constexpr int kCarryBytes = 2 * kBN * 4;        // run_sums' carry between row halves

// Rows [m0, m0 + 128) x columns [n0, n0 + kBN) of a row-major operand (row
// stride ld) into a shared tile of row stride LD elements by 16-byte
// cp.async, one commit group; tile row r reads operand row src(m0 + r), and
// -1 or a column at or past n reads zeros.
template <typename T, int LD, class Src>
__device__ __forceinline__ void fetch(T* tile, const T* __restrict__ g, size_t ld, int m0,
                                      int n0, int n, Src&& src) {
  constexpr int kV = 16 / sizeof(T), kC = kBN / kV;
  const unsigned base = nkbx::smem_addr(tile);
  for (int i = threadIdx.x; i < gm::kBM * kC; i += kThreads) {
    const int r = i / kC, col = (i % kC) * kV;
    const int s = src(m0 + r);
    const bool in = s >= 0 && n0 + col < n;
    nkbx::cp_async16(base + (r * LD + col) * static_cast<int>(sizeof(T)),
                     in ? g + static_cast<size_t>(s) * ld + n0 + col : g, in ? 16 : 0);
  }
  nkbx::cp_async_commit();
}

// The staged float tile's rows < rows_valid and columns < n_valid (multiples
// of 8) to dst (row stride ld), 16-byte stores.
__device__ __forceinline__ void copy_f32(const float* tile, float* __restrict__ dst, size_t ld,
                                         int rows_valid, int n_valid) {
  constexpr int kC = kBN / 4;
  for (int i = threadIdx.x; i < gm::kBM * kC; i += kThreads) {
    const int r = i / kC, col = (i % kC) * 4;
    if (r < rows_valid && col < n_valid)
      *reinterpret_cast<float4*>(dst + r * ld + col) =
          *reinterpret_cast<const float4*>(tile + r * kLdF + col);
  }
}

__device__ __forceinline__ float2 get2(const bf16* tile, int r, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + r * kLdH + col));
}

__device__ __forceinline__ void put2(bf16* tile, int r, int col, float a, float b) {
  *reinterpret_cast<unsigned*>(tile + r * kLdH + col) = nkbx::pack_bf16(a, b);
}

// Two sums of each column over every piece of a run the block tile meets,
// in a fixed order, into planes 0 and 1 of R.part: vals(r, col, a, b) gives
// tile row r's two values. Thread (half, col) adds rows [64 half, 64 half +
// 64) of each piece with four interleaved accumulators; a piece that spans
// row 64 is the lower half's sum plus the upper's (through `carry`).
template <class V>
__device__ __forceinline__ void run_sums(const gm::Tile& t, int rows, const Runs& R, float* carry,
                                         V&& vals) {
  static_assert(kThreads == 2 * kBN, "two threads a column");
  constexpr int kHalf = gm::kBM / 2;
  const int col = threadIdx.x % kBN, half = threadIdx.x / kBN;
  const int rows_valid = min(gm::kBM, rows - t.m0), blk = t.m0 / gm::kBM;
  const bool ok = t.n0 + col < R.n;
  const bool split = rows_valid > kHalf && (t.m0 + kHalf) % R.len != 0;
  const size_t plane = static_cast<size_t>(R.count) * R.pieces * R.n;
  const int r_end = min(rows_valid, (half + 1) * kHalf);
  float pend0 = 0.f, pend1 = 0.f;
  int pend_o = -1;  // the upper half's first piece, finished after the barrier
  for (int r = half * kHalf; r < r_end;) {
    const int q = (t.m0 + r) / R.len, r0 = r;
    const int end = min(r_end, (q + 1) * R.len - t.m0);
    float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
    for (; r + 4 <= end; r += 4)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float va, vb;
        vals(r + k, col, va, vb);
        a[k] += va;
        b[k] += vb;
      }
    for (; r < end; ++r) {
      float va, vb;
      vals(r, col, va, vb);
      a[0] += va;
      b[0] += vb;
    }
    const float s0 = (a[0] + a[1]) + (a[2] + a[3]), s1 = (b[0] + b[1]) + (b[2] + b[3]);
    const int o = static_cast<int>((static_cast<size_t>(q) * R.pieces + blk -
                                    (q * R.len) / gm::kBM) * R.n) + t.n0 + col;
    if (split && half == 0 && end == kHalf) {
      carry[col] = s0;
      carry[kBN + col] = s1;
    } else if (split && half == 1 && r0 == kHalf) {
      pend0 = s0;
      pend1 = s1;
      pend_o = o;
    } else if (ok) {
      R.part[o] = s0;
      R.part[plane + o] = s1;
    }
  }
  __syncthreads();
  if (pend_o >= 0 && ok) {
    R.part[pend_o] = carry[col] + pend0;
    R.part[plane + pend_o] = carry[kBN + col] + pend1;
  }
}

constexpr int kRowBytes = gm::kBM * 4;  // a block's row table

// The block tile's row table: entry r = (tile << 1) | has for product row
// m0 + r, -1 past the rows; the tile is the global layout's (tile_of_global)
// or, ext, row / (g (th + 2) W), and `has` says whether the row has an
// image row (ext rows: e2g[row] >= 0). One row a thread, so that no thread
// divides for each of its fragment rows.
template <bool EXT>
__device__ __forceinline__ void row_table(const gm::Tile& t, const Geo& G, int rows,
                                          const int* e2g, int* rt) {
  for (int r = threadIdx.x; r < gm::kBM; r += kThreads) {
    const int row = t.m0 + r;
    int v = -1;
    if (row < rows)
      v = EXT ? (row / (G.g * G.the * G.w)) << 1 | (e2g[row] >= 0 ? 1 : 0)
              : tile_of_global(G, row) << 1 | 1;
    rt[r] = v;
  }
}

// A BN's scale and bias at a thread's fragment columns c0 + 8 nt + {0, 1},
// and its per-element arithmetic.
template <int NT>
struct Cols {
  float scale[NT][2], bias[NT][2];
  __device__ __forceinline__ Cols(const Norm& nm, int c0, int n) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + nt * 8 + e;
        scale[nt][e] = col < n ? nm.scale[col] : 0.f;
        bias[nt][e] = col < n ? nm.bias[col] : 0.f;
      }
  }
  // round(round(xhat scale + bias) + x): the residual sum (bottleneck.cuh's
  // residual_sum)
  __device__ __forceinline__ float residual(int nt, int e, float xh, float x) const {
    return nkbx::round_to<bf16>(nkbx::round_to<bf16>(xh * scale[nt][e] + bias[nt][e]) + x);
  }
  // rstd (s dz - corr (S1 + xhat S2) / n) with S1 = s Σdz, S2 = s Σdz xhat
  __device__ __forceinline__ float du(int nt, int e, float rstd, float dz, float xh, float sum0,
                                      float sum1, bool corr, float inv_n) const {
    const float s = scale[nt][e];
    const float k = corr ? (s * sum0 + xh * (s * sum1)) * inv_n : 0.f;
    return rstd * (dz * s - k);
  }
};

// --- epilogues --------------------------------------------------------------------

// u: stored in float when out is set; its pieces of Σu and Σu².
struct StatsEpi {
  static constexpr int kPre = 0, kPost = kTileBytes + kCarryBytes;
  float* out;
  Runs R;
  int rows, n;
  __device__ __forceinline__ void prepare(const gm::Tile&, unsigned char*, unsigned char*) const {}
  template <class J>
  __device__ __forceinline__ void operator()(J& j, const gm::Tile& t, unsigned char*,
                                             unsigned char* smem) const {
    float* tile = reinterpret_cast<float*>(smem);
    gm::for_pairs<J::P::MT, J::P::NT>(j.wm, j.wn, [&](int r, int col, int mt, int nt, int hi) {
      *reinterpret_cast<float2*>(tile + r * kLdF + col) =
          make_float2(j.acc[mt][nt][2 * hi], j.acc[mt][nt][2 * hi + 1]);
    });
    __syncthreads();
    if (out)
      copy_f32(tile, out + static_cast<size_t>(t.m0) * n + t.n0, n, rows - t.m0, n - t.n0);
    run_sums(t, rows, R, reinterpret_cast<float*>(smem + kTileBytes),
             [&](int r, int col, float& a, float& b) {
               a = tile[r * kLdF + col];
               b = a * a;
             });
  }
};

// K9's output: out = relu(round(round(BN3(u3)) + x)) in bf16, written over
// x's tile in shared memory and stored from there.
struct OutEpi {
  static constexpr int kPre = kHalfTile, kPost = kRowBytes;
  Norm bn;
  const bf16* x;
  bf16* out;
  Geo G;
  __device__ __forceinline__ void prepare(const gm::Tile& t, unsigned char* pre,
                                          unsigned char* post) const {
    fetch<bf16, kLdH>(reinterpret_cast<bf16*>(pre), x, G.c, t.m0, t.n0, G.c,
                      [&](int row) { return row < G.rows ? row : -1; });
    row_table<false>(t, G, G.rows, nullptr, reinterpret_cast<int*>(post));
  }
  template <class J>
  __device__ __forceinline__ void operator()(J& j, const gm::Tile& t, unsigned char* pre,
                                             unsigned char* post) const {
    const int rows = G.rows, n = G.c;
    bf16* xs = reinterpret_cast<bf16*>(pre);
    const int* rt = reinterpret_cast<const int*>(post);
    const Cols<J::P::NT> cs(bn, t.n0 + j.wn + 2 * (threadIdx.x % 4), n);
    gm::for_pairs<J::P::MT, J::P::NT>(j.wm, j.wn, [&](int r, int col, int mt, int nt, int hi) {
      const int v = rt[r];
      if (v < 0 || t.n0 + col >= n) return;
      const int o = (v >> 1) * n + t.n0 + col;
      const float2 mu = ld2(bn.mean + o), rs = ld2(bn.rstd + o), xv = get2(xs, r, col);
      const float o0 = cs.residual(nt, 0, (j.acc[mt][nt][2 * hi] - mu.x) * rs.x, xv.x);
      const float o1 = cs.residual(nt, 1, (j.acc[mt][nt][2 * hi + 1] - mu.y) * rs.y, xv.y);
      put2(xs, r, col, fmaxf(o0, 0.f), fmaxf(o1, 0.f));
    });
    __syncthreads();
    gm::copy_tile<kBN, kThreads>(xs, out + static_cast<size_t>(t.m0) * n + t.n0, n, rows - t.m0,
                                 n - t.n0);
  }
};

// K10's dy = dout where the residual sum is positive (bf16, written over
// dout's tile), and the pieces of BN3's sums Σ dy and Σ dy xhat3 (no gate:
// dy carries the relu's mask).
struct DyEpi {
  static constexpr int kPre = 2 * kHalfTile, kPost = kTileBytes + kCarryBytes + kRowBytes;
  Norm bn;
  const bf16* x;
  const bf16* dout;
  bf16* dy;
  Runs R;
  Geo G;
  __device__ __forceinline__ void prepare(const gm::Tile& t, unsigned char* pre,
                                          unsigned char* post) const {
    auto same = [&](int row) { return row < G.rows ? row : -1; };
    fetch<bf16, kLdH>(reinterpret_cast<bf16*>(pre), x, G.c, t.m0, t.n0, G.c, same);
    fetch<bf16, kLdH>(reinterpret_cast<bf16*>(pre + kHalfTile), dout, G.c, t.m0, t.n0, G.c,
                      same);
    row_table<false>(t, G, G.rows, nullptr,
                     reinterpret_cast<int*>(post + kTileBytes + kCarryBytes));
  }
  template <class J>
  __device__ __forceinline__ void operator()(J& j, const gm::Tile& t, unsigned char* pre,
                                             unsigned char* post) const {
    const int rows = G.rows, n = G.c;
    float* f = reinterpret_cast<float*>(post);
    bf16* xs = reinterpret_cast<bf16*>(pre);
    bf16* ds = reinterpret_cast<bf16*>(pre + kHalfTile);
    const int* rt = reinterpret_cast<const int*>(post + kTileBytes + kCarryBytes);
    const Cols<J::P::NT> cs(bn, t.n0 + j.wn + 2 * (threadIdx.x % 4), n);
    gm::for_pairs<J::P::MT, J::P::NT>(j.wm, j.wn, [&](int r, int col, int mt, int nt, int hi) {
      float d[2] = {0.f, 0.f}, xh[2] = {0.f, 0.f};
      const int v = rt[r];
      if (v >= 0 && t.n0 + col < n) {
        const int o = (v >> 1) * n + t.n0 + col;
        const float2 mu = ld2(bn.mean + o), rs = ld2(bn.rstd + o);
        const float2 xv = get2(xs, r, col), dv = get2(ds, r, col);
        const float xx[2] = {xv.x, xv.y}, dd[2] = {dv.x, dv.y}, m2[2] = {mu.x, mu.y},
                    r2[2] = {rs.x, rs.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          xh[e] = (j.acc[mt][nt][2 * hi + e] - m2[e]) * r2[e];
          if (cs.residual(nt, e, xh[e], xx[e]) > 0.f) d[e] = dd[e];
        }
      }
      put2(ds, r, col, d[0], d[1]);
      *reinterpret_cast<float2*>(f + r * kLdF + col) = make_float2(d[0] * xh[0], d[1] * xh[1]);
    });
    __syncthreads();
    gm::copy_tile<kBN, kThreads>(ds, dy + static_cast<size_t>(t.m0) * n + t.n0, n, rows - t.m0,
                                 n - t.n0);
    run_sums(t, rows, R, reinterpret_cast<float*>(post + kTileBytes),
             [&](int r, int col, float& a, float& b) {
               a = nkbx::to_f(ds[r * kLdH + col]);
               b = f[r * kLdF + col];
             });
  }
};

// K10's du3 from u3 (the accumulators), dy and BN3's sums, in bf16 (written
// over dy's tile).
struct Du3Epi {
  static constexpr int kPre = kHalfTile, kPost = kRowBytes;
  Norm bn;
  const float* sums;
  const bf16* dy;
  bf16* du3;
  Geo G;
  __device__ __forceinline__ void prepare(const gm::Tile& t, unsigned char* pre,
                                          unsigned char* post) const {
    fetch<bf16, kLdH>(reinterpret_cast<bf16*>(pre), dy, G.c, t.m0, t.n0, G.c,
                      [&](int row) { return row < G.rows ? row : -1; });
    row_table<false>(t, G, G.rows, nullptr, reinterpret_cast<int*>(post));
  }
  template <class J>
  __device__ __forceinline__ void operator()(J& j, const gm::Tile& t, unsigned char* pre,
                                             unsigned char* post) const {
    const int rows = G.rows, n = G.c;
    const float inv_n = 1.f / static_cast<float>(G.g * G.th * G.w);
    bf16* ys = reinterpret_cast<bf16*>(pre);
    const int* rt = reinterpret_cast<const int*>(post);
    const Cols<J::P::NT> cs(bn, t.n0 + j.wn + 2 * (threadIdx.x % 4), n);
    const int plane = G.nt * n;
    gm::for_pairs<J::P::MT, J::P::NT>(j.wm, j.wn, [&](int r, int col, int mt, int nt, int hi) {
      const int v = rt[r];
      if (v < 0 || t.n0 + col >= n) return;
      const int o = (v >> 1) * n + t.n0 + col;
      const float2 mu = ld2(bn.mean + o), rs = ld2(bn.rstd + o), a = ld2(sums + o),
                   b = ld2(sums + plane + o), yv = get2(ys, r, col);
      const float x0 = (j.acc[mt][nt][2 * hi] - mu.x) * rs.x;
      const float x1 = (j.acc[mt][nt][2 * hi + 1] - mu.y) * rs.y;
      put2(ys, r, col, cs.du(nt, 0, rs.x, yv.x, x0, a.x, b.x, true, inv_n),
           cs.du(nt, 1, rs.y, yv.y, x1, a.y, b.y, true, inv_n));
    });
    __syncthreads();
    gm::copy_tile<kBN, kThreads>(ys, du3 + static_cast<size_t>(t.m0) * n + t.n0, n, rows - t.m0,
                                 n - t.n0);
  }
};

// A gated BN backward's dz = da where z > 0 (and the row has an input),
// stored in float, and its sums' pieces. Global rows read u at the same row;
// ext rows (EXT) read u1 at their image row (e2g; none off the image).
template <bool EXT>
struct DzEpi {
  static constexpr int kPre = kTileBytes, kPost = kTileBytes + kCarryBytes + kRowBytes;
  Norm bn;
  const float* u;
  const int* e2g;
  float* dz;
  Runs R;
  Geo G;
  __device__ __forceinline__ int src(int row) const {
    return row >= (EXT ? G.ext_rows : G.rows) ? -1 : (EXT ? e2g[row] : row);
  }
  __device__ __forceinline__ void prepare(const gm::Tile& t, unsigned char* pre,
                                          unsigned char* post) const {
    fetch<float, kLdF>(reinterpret_cast<float*>(pre), u, G.m, t.m0, t.n0, G.m,
                       [&](int row) { return src(row); });
    row_table<EXT>(t, G, EXT ? G.ext_rows : G.rows, e2g,
                   reinterpret_cast<int*>(post + kTileBytes + kCarryBytes));
  }
  template <class J>
  __device__ __forceinline__ void operator()(J& j, const gm::Tile& t, unsigned char* pre,
                                             unsigned char* post) const {
    const int rows = EXT ? G.ext_rows : G.rows, n = G.m;
    float* f = reinterpret_cast<float*>(post);
    float* us = reinterpret_cast<float*>(pre);
    const int* rt = reinterpret_cast<const int*>(post + kTileBytes + kCarryBytes);
    const Cols<J::P::NT> cs(bn, t.n0 + j.wn + 2 * (threadIdx.x % 4), n);
    gm::for_pairs<J::P::MT, J::P::NT>(j.wm, j.wn, [&](int r, int col, int mt, int nt, int hi) {
      float d[2] = {0.f, 0.f}, xh[2] = {0.f, 0.f};
      const int v = rt[r];
      if (v >= 0 && t.n0 + col < n) {
        const int o = (v >> 1) * n + t.n0 + col;
        const float2 mu = ld2(bn.mean + o), rs = ld2(bn.rstd + o);
        const float2 uv = *reinterpret_cast<const float2*>(us + r * kLdF + col);
        const float uu[2] = {uv.x, uv.y}, m2[2] = {mu.x, mu.y}, r2[2] = {rs.x, rs.y};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          xh[e] = (uu[e] - m2[e]) * r2[e];
          if ((v & 1) && xh[e] * cs.scale[nt][e] + cs.bias[nt][e] > 0.f)
            d[e] = j.acc[mt][nt][2 * hi + e];
        }
      }
      *reinterpret_cast<float2*>(f + r * kLdF + col) = make_float2(d[0], d[1]);
      *reinterpret_cast<float2*>(us + r * kLdF + col) = make_float2(d[0] * xh[0], d[1] * xh[1]);
    });
    __syncthreads();
    copy_f32(f, dz + static_cast<size_t>(t.m0) * n + t.n0, n, rows - t.m0, n - t.n0);
    run_sums(t, rows, R, reinterpret_cast<float*>(post + kTileBytes),
             [&](int r, int col, float& a, float& b) {
               a = f[r * kLdF + col];
               b = us[r * kLdF + col];
             });
  }
};

// K10's dx core rows = round(round(du1_core w1^T) + dy) in bf16 (written
// over dy's tile).
struct DxEpi {
  static constexpr int kPre = kHalfTile, kPost = 0;
  const bf16* dy;
  bf16* dx;
  int rows, n;
  __device__ __forceinline__ void prepare(const gm::Tile& t, unsigned char* pre,
                                          unsigned char*) const {
    fetch<bf16, kLdH>(reinterpret_cast<bf16*>(pre), dy, n, t.m0, t.n0, n,
                      [&](int row) { return row < rows ? row : -1; });
  }
  template <class J>
  __device__ __forceinline__ void operator()(J& j, const gm::Tile& t, unsigned char* pre,
                                             unsigned char*) const {
    bf16* ys = reinterpret_cast<bf16*>(pre);
    gm::for_pairs<J::P::MT, J::P::NT>(j.wm, j.wn, [&](int r, int col, int mt, int nt, int hi) {
      const float2 yv = get2(ys, r, col);
      put2(ys, r, col, nkbx::round_to<bf16>(j.acc[mt][nt][2 * hi]) + yv.x,
           nkbx::round_to<bf16>(j.acc[mt][nt][2 * hi + 1]) + yv.y);
    });
    __syncthreads();
    gm::copy_tile<kBN, kThreads>(ys, dx + static_cast<size_t>(t.m0) * n + t.n0, n, rows - t.m0,
                                 n - t.n0);
  }
};

// --- weight gradients --------------------------------------------------------------

// K-side maps of the weight gradients: the source row of product row k at
// tap (dy, dx), from the tables of maps_kernel.
enum KMap { kKFlat = 0, kKG2E = 1, kKE2G = 2 };

// Tables of one call: g2e[r] = (the ext row of global row r at tap (0, 1)) *
// 4 + (w == 0) + 2 (w == W - 1); e2g[er] = ext row er's image row or -1.
__global__ void maps_kernel(Geo G, int* __restrict__ g2e, int* __restrict__ e2g) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < G.rows) {
    const int w = i % G.w;
    g2e[i] = (src_row<kG2E>(G, i, 0, 1) << 2) | (w == 0 ? 1 : 0) | (w == G.w - 1 ? 2 : 0);
  } else if (i < G.rows + G.ext_rows) {
    e2g[i - G.rows] = src_row<kE2GImage>(G, i - G.rows, 1, 1);
  }
}

// part[blockIdx.y] (mo, no) = A^T D over the rows of slab blockIdx.y: A
// element (k, (tap, i)) = a[src(k, tap) kt + i] (mo = taps kt), D (rows, no).
struct WgradArgs {
  const bf16* a;
  const bf16* d;
  float* part;
  const int* map;
  int rows, slab, mo, no, kt, taps;
  Geo G;
};

template <int KMAP>
struct WgradJob {
  using P = gm::Product<Cfg::BN, Cfg::WARPS_M, Cfg::WARPS_N, false, false, Cfg::BK>;
  static constexpr int kStageBytes = P::kBytes, kBK = Cfg::BK;
  static constexpr int kChunks = gm::kBM / 8, kRowStep = kThreads / kChunks;
  static constexpr int kRows = kBK / kRowStep;  // rows of K a thread copies each slab
  WgradArgs p;
  int m0, n0, wm, wn, col, dy, dx;  // col < 0: the thread's columns are past mo
  int next[kRows];  // the table's entries for the thread's rows of the next slab: loaded
                    // a slab ahead, so that no slab's copies wait on the table
  float acc[P::MT][P::NT][4];

  __device__ __forceinline__ WgradJob(const WgradArgs& p_, const gm::Tile& t)
      : p(p_), m0(t.m0), n0(t.n0) {
    const int warp = threadIdx.x / 32;
    wm = (warp / P::kWarpsN) * P::WM;
    wn = (warp % P::kWarpsN) * P::WN;
    const int mm = m0 + (threadIdx.x % kChunks) * 8, tap = mm / p.kt;
    col = mm < p.mo ? mm - tap * p.kt : -1;
    dy = p.taps == 1 ? 1 : tap / 3;
    dx = p.taps == 1 ? 1 : tap % 3;
    fetch_map(t.k0);
#pragma unroll
    for (int i = 0; i < P::MT; ++i)
#pragma unroll
      for (int j = 0; j < P::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // The table's entries of the thread's rows of the slab at k.
  __device__ __forceinline__ void fetch_map(int k) {
    if (KMAP == kKFlat) return;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kr = k + i * kRowStep + threadIdx.x / kChunks;
      next[i] = kr < p.rows ? p.map[kr] : -1;
    }
  }

  // The source row of product row k from its table entry v.
  __device__ __forceinline__ int src(int k, int v) const {
    if (KMAP == kKFlat) return k;
    if (KMAP == kKE2G) return v;
    if ((dx == 0 && (v & 1)) || (dx == 2 && (v & 2))) return -1;
    return (v >> 2) + dy * p.G.w + dx - 1;
  }

  __device__ __forceinline__ void load(unsigned slot, int k, int k_end) {
    const int ci = (threadIdx.x % kChunks) * 8;
    int v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) v[i] = next[i];
    fetch_map(k + kBK);  // the mainloop loads the slabs in order
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int o = i * kRowStep + threadIdx.x / kChunks, kr = k + o;
      const int s = (col >= 0 && kr < k_end) ? src(kr, v[i]) : -1;
      nkbx::cp_async16(slot + (o * P::LDA + ci) * 2,
                       s >= 0 ? p.a + static_cast<size_t>(s) * p.kt + col : p.a, s >= 0 ? 16 : 0);
    }
    gm::load_tile<kBK, kBN, kThreads>(slot + P::kABytes, gm::Operand{p.d, p.no}, k, k_end, n0,
                                      p.no);
  }
  __device__ __forceinline__ void compute(unsigned slot) { P::compute(acc, slot, wm, wn); }
};

template <int KMAP>
__global__ void __launch_bounds__(kThreads) chain_wgrad(WgradArgs p) {
  extern __shared__ __align__(256) unsigned char smem[];
  const gm::Tile t = gm::tile_of<kBN>(p.mo, p.no, p.rows, p.slab);
  WgradJob<KMAP> job(p, t);
  gm::mainloop<Cfg::STAGES>(job, nkbx::smem_addr(smem), t.k0, t.k1);
  float* base = p.part + static_cast<size_t>(blockIdx.y) * p.mo * p.no;
  gm::for_pairs<WgradJob<KMAP>::P::MT, WgradJob<KMAP>::P::NT>(
      t.m0 + job.wm, t.n0 + job.wn, [&](int r, int c, int mt, int nt, int hi) {
        if (r < p.mo && c < p.no)
          *reinterpret_cast<float2*>(base + static_cast<size_t>(r) * p.no + c) =
              make_float2(job.acc[mt][nt][2 * hi], job.acc[mt][nt][2 * hi + 1]);
      });
}

// out = the sum of the slabs' partials in slab order; transpose: out is
// (no, mo), the partials (mo, no).
__global__ void wgrad_sum(const float* __restrict__ part, int slabs, float* __restrict__ out,
                          int mo, int no, int transpose) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x, len = mo * no;
  if (i >= len) return;
  float v = 0.f;
  for (int z = 0; z < slabs; ++z) v += part[static_cast<size_t>(z) * len + i];
  out[transpose ? (i % no) * mo + i / no : i] = v;
}

template <int KMAP>
cudaError_t weight_grad(const WgradArgs& p, float* out, int transpose, cudaStream_t s) {
  const int slabs = (p.rows + p.slab - 1) / p.slab;
  cudaError_t err =
      gm::launch<Cfg, WgradJob<KMAP>>(chain_wgrad<KMAP>, p.mo, p.no, slabs, s, p);
  if (err != cudaSuccess) return err;
  const int len = p.mo * p.no;
  wgrad_sum<<<(len + 255) / 256, 256, 0, s>>>(p.part, slabs, out, p.mo, p.no, transpose);
  return cudaGetLastError();
}

// --- vector passes: eight channels a thread, 16-byte bf16 stores ----------------

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(nkbx::pack_bf16(v[0], v[1]), nkbx::pack_bf16(v[2], v[3]),
                 nkbx::pack_bf16(v[4], v[5]), nkbx::pack_bf16(v[6], v[7]));
}

// Eight channels c0 .. c0 + 7 of a BN at tile t: mean, rstd = rsqrt(var +
// eps), scale and bias.
struct Bn8 {
  float mean[8], rstd[8], scale[8], bias[8];
  __device__ __forceinline__ Bn8(const Norm& bn, int t, int n, int c0) {
    const size_t o = static_cast<size_t>(t) * n + c0;
    load8(bn.mean + o, mean);
    load8(bn.rstd + o, rstd);
    load8(bn.scale + c0, scale);
    load8(bn.bias + c0, bias);
  }
};

// a = round(relu(BN(u))) of each row (ext rows: u1 at the row's image row
// with the row's tile's statistics, zero off the image; else the global
// rows' u2), width n.
template <bool EXT>
__global__ void act_pass(const float* __restrict__ u, Norm bn, bf16* __restrict__ a, Geo G,
                         int n) {
  const int per = n / 8;
  const size_t total = static_cast<size_t>(EXT ? G.ext_rows : G.rows) * per;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(idx / per), c0 = static_cast<int>(idx % per) * 8;
    const int src = EXT ? src_row<kE2GImage>(G, row, 1, 1) : row;
    const int t = EXT ? row / (G.g * G.the * G.w) : tile_of_global(G, row);
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (src >= 0) {
      const Bn8 c(bn, t, n, c0);
      load8(u + static_cast<size_t>(src) * n + c0, v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = fmaxf((v[e] - c.mean[e]) * c.rstd[e] * c.scale[e] + c.bias[e], 0.f);
    }
    store8(a + static_cast<size_t>(row) * n + c0, v);
  }
}

// du = rstd (s dz - corr (S1 + xhat S2) / n), S1 = s Σdz and S2 = s Σdz xhat
// of the row's tile (sums: planes of (nt, n)), from the gated dz (float), u
// and the BN's sums, rounded to bf16: ext rows (EXT) read u1 at their image
// row (zero off the image) and take the correction on their core rows only.
template <bool EXT>
__global__ void du_pass(const float* __restrict__ dz, const float* __restrict__ u, Norm bn,
                        const float* __restrict__ sums, bf16* __restrict__ du, Geo G, int n) {
  const int per = n / 8;
  const float inv_n = 1.f / static_cast<float>(G.g * G.th * G.w);
  const size_t total = static_cast<size_t>(EXT ? G.ext_rows : G.rows) * per;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(idx / per), c0 = static_cast<int>(idx % per) * 8;
    const int src = EXT ? src_row<kE2GImage>(G, row, 1, 1) : row;
    const int t = EXT ? row / (G.g * G.the * G.w) : tile_of_global(G, row);
    bool corr = true;
    if (EXT) {
      const int he = (row / G.w) % G.the;
      corr = he >= 1 && he <= G.th;
    }
    const Bn8 c(bn, t, n, c0);
    const size_t o = static_cast<size_t>(t) * n + c0;
    float d[8], s1[8], s2[8], uv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    load8(dz + static_cast<size_t>(row) * n + c0, d);
    load8(sums + o, s1);
    load8(sums + static_cast<size_t>(G.nt) * n + o, s2);
    if (src >= 0) load8(u + static_cast<size_t>(src) * n + c0, uv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xhat = (uv[e] - c.mean[e]) * c.rstd[e], s = c.scale[e];
      const float k = corr ? (s * s1[e] + xhat * (s * s2[e])) * inv_n : 0.f;
      d[e] = c.rstd[e] * (d[e] * s - k);
    }
    store8(du + static_cast<size_t>(row) * n + c0, d);
  }
}

// --- the forward -------------------------------------------------------------------

struct Chain {
  const bf16 *x, *w1, *w2, *w3;
  Bn bn1, bn2, bn3;  // mean/var point at the per-tile statistics outputs
  float* rstd;       // rstd1, rstd2 (nt, m), rstd3 (nt, c)
  float* u1;         // (rows, m)
  bf16* a1;          // (ext_rows, m)
  float* u2;         // (rows, m)
  bf16* a2;          // (rows, m)
  float* part;       // the runs' partial sums
};

inline dim3 finish_grid(int n, int nt) { return dim3((n + 127) / 128, nt); }

// rstd of BN i (1, 2, 3) in the chain's scratch.
inline float* rstd_of(const Chain& ch, const Geo& G, int i) {
  return ch.rstd + static_cast<size_t>(i - 1) * G.nt * G.m;
}

// BN i as the route's epilogues and passes read it.
inline Norm norm(const Chain& ch, const Geo& G, int i) {
  const Bn& bn = i == 1 ? ch.bn1 : i == 2 ? ch.bn2 : ch.bn3;
  return Norm{bn.mean, rstd_of(ch, G, i), bn.scale, bn.bias};
}

inline cudaError_t stats(const Runs& R, const Chain& ch, const Geo& G, int i, float eps,
                         cudaStream_t s) {
  const Bn& bn = i == 1 ? ch.bn1 : i == 2 ? ch.bn2 : ch.bn3;
  stats_finish<<<finish_grid(R.n, G.nt), 128, 0, s>>>(
      R, G, const_cast<float*>(bn.mean), const_cast<float*>(bn.var), rstd_of(ch, G, i), eps);
  return cudaGetLastError();
}

// u1, the BN1 statistics, a1, u2, the BN2 statistics, a2 and the BN3
// statistics of u3 = a2 w3 (not stored): K9's body up to its output, and
// K10's recompute.
inline cudaError_t forward_to_a2(const Chain& ch, const Geo& G, float eps, cudaStream_t s) {
  const Runs Rm = global_runs(G, ch.part, G.m), Rc = global_runs(G, ch.part, G.c);
  cudaError_t err;
  // u1 = x w1 over every global row
  if ((err = product<false>(ConvArgs{ch.x, ch.w1, G.rows, G.m, G.c, 1, 0, G}, FlatRows{},
                            StatsEpi{ch.u1, Rm, G.rows, G.m}, s)) != cudaSuccess)
    return err;
  if ((err = stats(Rm, ch, G, 1, eps, s)) != cudaSuccess) return err;
  act_pass<true><<<grid_for(static_cast<size_t>(G.ext_rows) * G.m / 8), 256, 0, s>>>(
      ch.u1, norm(ch, G, 1), ch.a1, G, G.m);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // u2 = the 3x3 conv of a1: K = 9 M over the taps of each global row's tile
  if ((err = product<false>(ConvArgs{ch.a1, ch.w2, G.rows, G.m, G.m, 9, 0, G}, G2ERows{},
                            StatsEpi{ch.u2, Rm, G.rows, G.m}, s)) != cudaSuccess)
    return err;
  if ((err = stats(Rm, ch, G, 2, eps, s)) != cudaSuccess) return err;
  act_pass<false><<<grid_for(static_cast<size_t>(G.rows) * G.m / 8), 256, 0, s>>>(
      ch.u2, norm(ch, G, 2), ch.a2, G, G.m);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // u3 = a2 w3: its statistics only
  if ((err = product<false>(ConvArgs{ch.a2, ch.w3, G.rows, G.c, G.m, 1, 0, G}, FlatRows{},
                            StatsEpi{nullptr, Rc, G.rows, G.c}, s)) != cudaSuccess)
    return err;
  return stats(Rc, ch, G, 3, eps, s);
}

}  // namespace tc
}  // namespace chain
