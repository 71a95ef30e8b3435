// A 1x1 convolution as a matrix product with the BatchNorm-apply + relu
// epilogue and the output's per-channel statistics (X1):
//   y = relu((x @ w) * scale + bias), x (N, Cin), w (Cin, Cout), f32
//   accumulation, y written in x's type; sum and sumsq (Cout,) f32 over
//   the rows of the f32 y, before it is rounded: the next BatchNorm's
//   inputs, with no second pass over y.
//
// Replaces experiments/pallas_fused_matmul_bn.py:30 `_kernel` (its
// pallas_call at :69, entry `fused_matmul_bn_relu_stats` :53). C entries
// `nkbx_matmul_bn_wgmma` (the route) and `nkbx_matmul_bn` (the first
// design).
//
// What bounds it on an H100: at the probe's shapes (Cin = Cout = C = 128,
// 256, 512 over 50k-800k rows, bf16) the bytes of x in and y out at
// 3.35 TB/s; at C = 512 the 2*N*C*C operations at 989 TFLOP/s take nearly
// as long (0.027 ms against 0.031). So the design streams x from device
// memory once, writes y once, keeps w and the statistics out of device
// memory but for one f32 row of partial sums per block, and keeps the
// tensor cores fed while it streams.
//
// The TPU kernel carries the sums from one grid step to the next; blocks
// here run in no order, so each block writes its rows' column sums to a
// scratch row, and `column_sums` adds the rows in a fixed order: two runs
// agree bit for bit.
//
// The route, matmul_bn_wgmma_kernel<BN> (bf16, Cin and Cout multiples of
// 64, Cin <= 512; sm90.cuh's pieces):
// - A persistent grid: one block an SM, each owning one BN-wide column
//   tile (BN = 128, or 64 where Cout is not a multiple of 128) and walking
//   the 128-row tiles g, g + G, ... of its group g in order. The blocks of
//   one row tile run side by side, so x comes from device memory once and
//   from L2 for the other column tiles.
// - w's (Cin, BN) slice is loaded once by TMA and stays in shared memory;
//   only x streams, in (128 x 64) boxes through a ring of up to 8 stages
//   (full/empty mbarriers) filled by one producer thread (its warpgroup at
//   40 registers a thread).
// - Two consumer warpgroups (232 registers) take 64 rows each: wgmma
//   m64nBNk16, A (x) K-major and B (w) N-major from shared memory, f32
//   accumulators in registers, one group of 4 products in flight while the
//   next stage's wait runs.
// - The epilogue works on the accumulator fragments: scale, bias and relu
//   in registers, bf16 pairs into a swizzled staging tile, a TMA store that
//   clips rows >= N and overlaps the next tile's products. The sums keep
//   rows < N by selection (relu(bias) != 0 on a padded row): a thread's
//   two rows, then an xor-shuffle reduce-scatter over the 8 lanes of a
//   column ((l0+l4)+(l2+l6)) + ((l1+l5)+(l3+l7)), added to the lane's
//   running sums tile after tile; at the end the 8 warps' running sums are
//   added in order into the block's partial row.
//
// The first design, for f32 and bf16 at other widths:
// - matmul_bn_tc_kernel, bf16: warp-level tensor cores (WMMA 16x16x16,
//   f32 accumulators), a 128x128 output tile per block of 8 warps (each
//   32x64), 32-deep slabs of x and w staged through shared memory by
//   cp.async, two in flight.
// - matmul_bn_fma_kernel, f32: float FMAs on the CUDA cores, a 64x64 tile
//   per block of 256 threads, each 4x4 outputs.
// Both stage the f32 product tile in shared memory and share one epilogue.
// Cin and Cout are multiples of 16; rows past N compute on zeros and are
// neither stored nor summed.

#include <mma.h>

#include <algorithm>
#include <initializer_list>

#include "dtype.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using nkbx::from_f;
using nkbx::to_f;

constexpr int kTM = 128, kTN = 128, kTK = 32, kTcThreads = 256;
constexpr int kLdA = kTK + 8;   // bf16 x slab row (80 bytes: rows stay 16-byte aligned)
constexpr int kLdB = kTN + 8;   // bf16 w slab row
constexpr int kLdC = kTN + 4;   // f32 product tile row
constexpr int kStageElems = kTM * kLdA + kTK * kLdB;
constexpr size_t kTcSmem = (2 * kStageElems * 2 > kTM * kLdC * 4) ? 2 * kStageElems * 2
                                                                  : static_cast<size_t>(kTM) * kLdC * 4;

constexpr int kFM = 64, kFN = 64, kFK = 16, kFmaThreads = 256;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// The epilogue of one (BM x BN) product tile in shared memory (row stride
// ldc): y = relu(u * scale + bias) (a product and a sum, each rounded, as
// the plain version computes them) stored in T, and each column's sum and
// sum of squares over the tile's rows < n into row `tile` of the partials.
// Thread t owns column t % BN and, in order, the kRows rows of row lane
// t / BN; the lanes' sums are then added in order, lane 0 first.
template <typename T, int BM, int BN, int THREADS>
__device__ void epilogue(const float* cs, int ldc, int m0, int n0, int n, int cout,
                         const float* __restrict__ scale, const float* __restrict__ bias,
                         T* __restrict__ y, float* __restrict__ part_s,
                         float* __restrict__ part_q, int tile) {
  constexpr int kLanes = THREADS / BN, kRows = BM / kLanes;
  __shared__ float red[2][kLanes][BN];
  const int col = threadIdx.x % BN, lane = threadIdx.x / BN, c = n0 + col;
  float s = 0.f, q = 0.f;
  if (c < cout) {
    const float sc = scale[c], bi = bias[c];
    for (int i = 0; i < kRows; ++i) {
      const int r = lane * kRows + i, row = m0 + r;
      if (row >= n) break;
      const float v = fmaxf(__fadd_rn(__fmul_rn(cs[r * ldc + col], sc), bi), 0.f);
      y[static_cast<size_t>(row) * cout + c] = from_f<T>(v);
      s += v;
      q += v * v;
    }
  }
  red[0][lane][col] = s;
  red[1][lane][col] = q;
  __syncthreads();
  if (lane == 0 && c < cout) {
    for (int l = 1; l < kLanes; ++l) {
      s += red[0][l][col];
      q += red[1][l][col];
    }
    part_s[static_cast<size_t>(tile) * cout + c] = s;
    part_q[static_cast<size_t>(tile) * cout + c] = q;
  }
}

struct Args {
  const void* x;
  const void* w;
  const float* scale;
  const float* bias;
  void* y;
  float* part_s;
  float* part_q;
  int n, cin, cout, col_tiles;
};

__global__ void __launch_bounds__(kTcThreads) matmul_bn_tc_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stage = reinterpret_cast<bf16*>(smem);  // two (x slab, w slab) stages
  float* cs = reinterpret_cast<float*>(smem);   // the product tile, after the loop
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.w);
  const int tid = threadIdx.x;
  const int tile = blockIdx.x / p.col_tiles;  // the column tiles of a row tile run together
  const int m0 = tile * kTM, n0 = (blockIdx.x % p.col_tiles) * kTN;

  auto load = [&](int st, int k0) {
    bf16* as = stage + st * kStageElems;
    bf16* bs = as + kTM * kLdA;
    for (int i = tid; i < kTM * (kTK / 8); i += kTcThreads) {
      const int r = i / (kTK / 8), v = i % (kTK / 8);
      const int row = m0 + r, kk = k0 + 8 * v;
      bf16* dst = as + r * kLdA + 8 * v;
      if (row < p.n && kk < p.cin)
        cp_async16(dst, x + static_cast<size_t>(row) * p.cin + kk);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    for (int i = tid; i < kTK * (kTN / 8); i += kTcThreads) {
      const int kr = i / (kTN / 8), v = i % (kTN / 8);
      const int kk = k0 + kr, col = n0 + 8 * v;
      bf16* dst = bs + kr * kLdB + 8 * v;
      if (kk < p.cin && col < p.cout)
        cp_async16(dst, w + static_cast<size_t>(kk) * p.cout + col);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int warp = tid / 32, wm = warp / 2, wn = warp % 2;  // warp tile: rows 32 wm, cols 64 wn

  const int nk = (p.cin + kTK - 1) / kTK;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const bool next = kt + 1 < nk;
    if (next) load((kt + 1) & 1, (kt + 1) * kTK);
    if (next)
      asm volatile("cp.async.wait_group 1;\n" ::);
    else
      asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    const bf16* as = stage + (kt & 1) * kStageElems;
    const bf16* bs = as + kTM * kLdA;
    for (int ks = 0; ks < kTK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * kLdA + ks, kLdA);
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, bs + ks * kLdB + wn * 64 + j * 16, kLdB);
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kLdC + wn * 64 + j * 16, acc[i][j],
                              kLdC, wmma::mem_row_major);
  __syncthreads();
  epilogue<bf16, kTM, kTN, kTcThreads>(cs, kLdC, m0, n0, p.n, p.cout, p.scale, p.bias,
                                       static_cast<bf16*>(p.y), p.part_s, p.part_q, tile);
}

__global__ void __launch_bounds__(kFmaThreads) matmul_bn_fma_kernel(Args p) {
  __shared__ __align__(16) float as[kFM][kFK + 4];
  __shared__ __align__(16) float bs[kFK][kFN + 4];
  __shared__ float cs[kFM * (kFN + 4)];
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;  // rows ty + 16 i, cols tx + 16 j
  const int tile = blockIdx.x / p.col_tiles;
  const int m0 = tile * kFM, n0 = (blockIdx.x % p.col_tiles) * kFN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.cin; k0 += kFK) {
    {  // one float4 of x and one of w a thread
      const int r = tid / 4, v = tid % 4, row = m0 + r;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < p.n)
        val = *reinterpret_cast<const float4*>(x + static_cast<size_t>(row) * p.cin + k0 + 4 * v);
      *reinterpret_cast<float4*>(&as[r][4 * v]) = val;
      const int kr = tid / 16, u = tid % 16, col = n0 + 4 * u;
      float4 wv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (col < p.cout)
        wv = *reinterpret_cast<const float4*>(w + static_cast<size_t>(k0 + kr) * p.cout + col);
      *reinterpret_cast<float4*>(&bs[kr][4 * u]) = wv;
    }
    __syncthreads();
    for (int kk = 0; kk < kFK; ++kk) {
      float av[4], bv[4];
      for (int i = 0; i < 4; ++i) av[i] = as[ty + 16 * i][kk];
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) cs[(ty + 16 * i) * (kFN + 4) + tx + 16 * j] = acc[i][j];
  __syncthreads();
  epilogue<float, kFM, kFN, kFmaThreads>(cs, kFN + 4, m0, n0, p.n, p.cout, p.scale, p.bias,
                                         static_cast<float*>(p.y), p.part_s, p.part_q, tile);
}

// ------------------------------------------------------------------ the route

constexpr int kWgBM = 128;                   // rows of a tile: two warpgroups of 64
constexpr int kWgKC = 64;                    // x columns of one ring stage (128 bytes)
constexpr int kWgStage = kWgBM * kWgKC * 2;  // bytes of one ring stage
constexpr int kWgMaxStages = 8;
constexpr int kWgThreads = 384;              // warpgroups 0-1 consume, warp 8 produces
constexpr int kWgMaxCin = 512;
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory one H100 block may have

struct WgArgs {
  const float* scale;
  const float* bias;
  float* part_s;
  float* part_q;
  int n, cin, cout, col_tiles, row_tiles, groups, stages;
};

// Shared memory of the route: w's slice, the x ring, the y staging tile
// (also the warps' sums at the end), scale and bias of the block's columns,
// the barriers; the 1024-byte atoms need an aligned base.
__host__ __device__ constexpr size_t wg_w_bytes(int cin, int bn) {
  return static_cast<size_t>(cin) * bn * 2;
}
__host__ __device__ constexpr size_t wg_fixed_bytes(int cin, int bn) {
  return wg_w_bytes(cin, bn) + static_cast<size_t>(kWgBM) * bn * 2 + 2 * bn * 4 +
         (2 * kWgMaxStages + 1) * 8 + 1024;
}

// One step of the reduce-scatter of a warp's column sums: lanes whose bit
// `BIT` is clear keep values [0, HALF), the others [HALF, 2 HALF), each
// adding its partner's copy; the kept values move to [0, HALF).
template <int HALF, int BIT, int N>
__device__ __forceinline__ void scatter_half(float (&ps)[N], float (&pq)[N], int lane) {
  const bool up = lane & BIT;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float ss = up ? ps[k] : ps[k + HALF], sq = up ? pq[k] : pq[k + HALF];
    const float ks = up ? ps[k + HALF] : ps[k], kq = up ? pq[k + HALF] : pq[k];
    ps[k] = ks + __shfl_xor_sync(0xffffffffu, ss, BIT);
    pq[k] = kq + __shfl_xor_sync(0xffffffffu, sq, BIT);
  }
}

template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
    matmul_bn_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tw,
                           const __grid_constant__ CUtensorMap ty, WgArgs p) {
  constexpr int kAcc = BN / 2;      // accumulators a thread (m64nBN)
  constexpr int kCols = BN / 4;     // columns a thread holds, two rows each
  constexpr int kKeep = kCols / 8;  // columns a lane keeps after the reduce-scatter
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* w_s = smem;
  unsigned char* ring = w_s + wg_w_bytes(p.cin, BN);
  unsigned char* y_s = ring + static_cast<size_t>(p.stages) * kWgStage;
  float* sc_s = reinterpret_cast<float*>(y_s + kWgBM * BN * 2);
  float* bi_s = sc_s + BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(bi_s + BN);
  uint64_t* empty = full + kWgMaxStages;
  uint64_t* w_full = empty + kWgMaxStages;

  const int col_tile = blockIdx.x % p.col_tiles, group = blockIdx.x / p.col_tiles;
  const int n0 = col_tile * BN, nk = p.cin / kWgKC;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    sm90::mbar_init(w_full, 1);
    sm90::fence_barrier_init();
  }
  if (threadIdx.x < BN) {
    sc_s[threadIdx.x] = p.scale[n0 + threadIdx.x];
    bi_s[threadIdx.x] = p.bias[n0 + threadIdx.x];
  }
  __syncthreads();

  if (wg == 2) {  // ------------------------------------------------ producer
    sm90::reg_dealloc<40>();
    if (threadIdx.x == 256) {
      sm90::prefetch_map(&tx);
      sm90::prefetch_map(&tw);
      sm90::mbar_expect_tx(w_full, static_cast<uint32_t>(wg_w_bytes(p.cin, BN)));
      for (int nb = 0; nb < BN / 64; ++nb)  // 64-column atoms of N, each cin rows of 128 bytes
        for (int k0 = 0; k0 < p.cin; k0 += 64)
          sm90::tma_load_2d(w_s + (static_cast<size_t>(nb) * p.cin + k0) * 128, &tw,
                            n0 + nb * 64, k0, w_full);
      int it = 0;
      for (int t = group; t < p.row_tiles; t += p.groups)
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % p.stages;
          const uint32_t ph = (it / p.stages) & 1;
          sm90::mbar_wait(&empty[s], ph ^ 1);
          sm90::mbar_expect_tx(&full[s], kWgStage);
          sm90::tma_load_2d(ring + static_cast<size_t>(s) * kWgStage, &tx, kc * kWgKC,
                            t * kWgBM, &full[s]);
        }
    }
  } else {  // ------------------------------------------------------ consumers
    sm90::reg_alloc<232>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int rl = warp * 16 + lane / 4;  // the thread's first row in its warpgroup's 64
    float acc[kAcc];
    float run_s[kKeep], run_q[kKeep];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll
    for (int k = 0; k < kKeep; ++k) run_s[k] = run_q[k] = 0.f;
    sm90::mbar_wait(w_full, 0);
    const uint32_t w_lbo = static_cast<uint32_t>(p.cin) * 128;
    int it = 0;
    for (int t = group; t < p.row_tiles; t += p.groups) {
      int prev = 0;
      for (int kc = 0; kc < nk; ++kc, ++it) {
        const int s = it % p.stages;
        sm90::mbar_wait(&full[s], (it / p.stages) & 1);
        const unsigned char* a_s = ring + static_cast<size_t>(s) * kWgStage + wg * 64 * 128;
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgKC / 16; ++kk) {
          const uint64_t a = sm90::make_desc(a_s + kk * 32, 16, 1024);
          const uint64_t b = sm90::make_desc(w_s + (kc * 4 + kk) * 2048, w_lbo, 1024);
          if constexpr (BN == 128)
            sm90::wgmma_m64n128k16(acc, a, b, kc | kk);
          else
            sm90::wgmma_m64n64k16(acc, a, b, kc | kk);
        }
        sm90::wgmma_commit();
        sm90::fence_regs(acc);
        if (kc > 0) {  // the previous stage's products are done: free it
          sm90::wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) sm90::mbar_arrive(&empty[prev]);
        }
        prev = s;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[prev]);

      // epilogue: the staging tile is free once the last store has read it
      if (threadIdx.x % 128 == 0) sm90::bulk_wait_read();
      sm90::named_sync(1 + wg, 128);
      const int row0 = t * kWgBM + wg * 64 + rl;
      const bool in0 = row0 < p.n, in1 = row0 + 8 < p.n;
      float ps[kCols], pq[kCols];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = 8 * j + 2 * (lane % 4);
        float v[4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[2 * h + e] = fmaxf(
                __fadd_rn(__fmul_rn(acc[4 * j + 2 * h + e], sc_s[cl + e]), bi_s[cl + e]), 0.f);
        // rows rl and rl + 8 of the 64-column box j / 8, chunk j % 8 swizzled by the row
        unsigned char* box = y_s + (wg * (BN / 64) + j / 8) * 8192;
        const int chunk = ((j % 8) ^ (rl % 8)) * 16 + (lane % 4) * 4;
        *reinterpret_cast<__nv_bfloat162*>(box + rl * 128 + chunk) =
            __floats2bfloat162_rn(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(box + (rl + 8) * 128 + chunk) =
            __floats2bfloat162_rn(v[2], v[3]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = in0 ? v[e] : 0.f, b = in1 ? v[2 + e] : 0.f;
          ps[2 * j + e] = a + b;
          pq[2 * j + e] = a * a + b * b;
        }
      }
      sm90::fence_async_shared();
      sm90::named_sync(1 + wg, 128);
      if (threadIdx.x % 128 == 0 && t * kWgBM + wg * 64 < p.n) {
#pragma unroll
        for (int nb = 0; nb < BN / 64; ++nb)
          sm90::tma_store_2d(&ty, y_s + (wg * (BN / 64) + nb) * 8192, n0 + nb * 64,
                             t * kWgBM + wg * 64);
        sm90::bulk_commit();
      }
      // reduce-scatter over the 8 lanes of a column (lane bits 4, 3, 2)
      scatter_half<kCols / 2, 16>(ps, pq, lane);
      scatter_half<kCols / 4, 8>(ps, pq, lane);
      scatter_half<kCols / 8, 4>(ps, pq, lane);
#pragma unroll
      for (int k = 0; k < kKeep; ++k) {
        run_s[k] += ps[k];
        run_q[k] += pq[k];
      }
    }
    // the block's partial row: the 8 warps' running sums added in order
    if (threadIdx.x % 128 == 0) sm90::bulk_wait();
    sm90::named_sync(3, 256);
    float* red_s = reinterpret_cast<float*>(y_s);
    float* red_q = red_s + 8 * BN;
    const int w8 = wg * 4 + warp;
#pragma unroll
    for (int k = 0; k < kKeep; ++k) {
      const int i = (lane / 4) * kKeep + k;  // index into the thread's kCols columns
      const int cl = 8 * (i / 2) + 2 * (lane % 4) + (i % 2);
      red_s[w8 * BN + cl] = run_s[k];
      red_q[w8 * BN + cl] = run_q[k];
    }
    sm90::named_sync(3, 256);
    if (threadIdx.x < BN) {
      float s = red_s[threadIdx.x], q = red_q[threadIdx.x];
      for (int w = 1; w < 8; ++w) {
        s += red_s[w * BN + threadIdx.x];
        q += red_q[w * BN + threadIdx.x];
      }
      p.part_s[static_cast<size_t>(group) * p.cout + n0 + threadIdx.x] = s;
      p.part_q[static_cast<size_t>(group) * p.cout + n0 + threadIdx.x] = q;
    }
  }
}

// sum[c] and sumsq[c] over the row tiles' partials: block (32 columns x 32
// lanes); lane l adds tiles l, l + 32, ... in order, then lane 0 adds the
// lanes in order.
constexpr int kRC = 32, kRL = 32;

__global__ void column_sums(const float* __restrict__ part_s, const float* __restrict__ part_q,
                            float* __restrict__ sum, float* __restrict__ sumsq, int tiles,
                            int cout) {
  __shared__ float red[2][kRL][kRC + 1];
  const int c = blockIdx.x * kRC + threadIdx.x, lane = threadIdx.y;
  float s = 0.f, q = 0.f;
  if (c < cout) {
#pragma unroll 4
    for (int t = lane; t < tiles; t += kRL) {
      s += part_s[static_cast<size_t>(t) * cout + c];
      q += part_q[static_cast<size_t>(t) * cout + c];
    }
  }
  red[0][lane][threadIdx.x] = s;
  red[1][lane][threadIdx.x] = q;
  __syncthreads();
  if (lane == 0 && c < cout) {
    for (int l = 1; l < kRL; ++l) {
      s += red[0][l][threadIdx.x];
      q += red[1][l][threadIdx.x];
    }
    sum[c] = s;
    sumsq[c] = q;
  }
}

}  // namespace

// x (n, cin) and w (cin, cout) in float (is_bf16 = 0) or bf16, both
// row-major; scale, bias (cout) float; y (n, cout) in x's type; sum, sumsq
// (cout) float; scratch part_s, part_q (row tiles, cout) float, row tiles
// = ceil(n / 128) in bf16 and ceil(n / 64) in float. cin and cout are
// multiples of 16. Returns the CUDA error code of the launches.
extern "C" int nkbx_matmul_bn(const void* x, const void* w, const void* scale, const void* bias,
                              void* y, void* sum, void* sumsq, void* part_s, void* part_q, int n,
                              int cin, int cout, int is_bf16, void* stream) {
  if (n <= 0 || cin <= 0 || cout <= 0 || cin % 16 || cout % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tm = is_bf16 ? kTM : kFM, tn = is_bf16 ? kTN : kFN;
  const int tiles = (n + tm - 1) / tm, col_tiles = (cout + tn - 1) / tn;
  if (static_cast<long long>(tiles) * col_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{x, w, static_cast<const float*>(scale), static_cast<const float*>(bias), y,
         static_cast<float*>(part_s), static_cast<float*>(part_q), n, cin, cout, col_tiles};
  if (is_bf16) {
    const cudaError_t e = nkbx::allow_smem(matmul_bn_tc_kernel, kTcSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    matmul_bn_tc_kernel<<<tiles * col_tiles, kTcThreads, kTcSmem, s>>>(p);
  } else {
    matmul_bn_fma_kernel<<<tiles * col_tiles, kFmaThreads, 0, s>>>(p);
  }
  column_sums<<<(cout + kRC - 1) / kRC, dim3(kRC, kRL), 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const float*>(part_q),
      static_cast<float*>(sum), static_cast<float*>(sumsq), tiles, cout);
  return static_cast<int>(cudaGetLastError());
}


// The route: x (n, cin) and w (cin, cout) bf16, row-major, 16-byte
// aligned; scale, bias (cout) float; y (n, cout) bf16; sum, sumsq (cout)
// float; scratch part_s, part_q (at least ceil(n / 128) rows of cout)
// float. cin and cout are multiples of 64, cin <= 512. The grid is one
// block an SM of the current device (their count alone fixes the order of
// the sums). Returns the CUDA error code of the launches, or
// cudaErrorInvalidValue for what the route does not take.
extern "C" int nkbx_matmul_bn_wgmma(const void* x, const void* w, const void* scale,
                                    const void* bias, void* y, void* sum, void* sumsq,
                                    void* part_s, void* part_q, int n, int cin, int cout,
                                    void* stream) {
  if (n <= 0 || cin <= 0 || cout <= 0 || cin % 64 || cout % 64 || cin > kWgMaxCin)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* ptr : {x, w, static_cast<const void*>(y)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int bn = cout % 128 == 0 ? 128 : 64;
  const int col_tiles = cout / bn, row_tiles = (n + kWgBM - 1) / kWgBM;
  const int groups = std::max(1, std::min(row_tiles, sms / col_tiles));
  const size_t fixed = wg_fixed_bytes(cin, bn);
  const int stages =
      static_cast<int>(std::min<size_t>(kWgMaxStages, (kMaxSmem - fixed) / kWgStage));
  if (fixed >= kMaxSmem || stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fixed + static_cast<size_t>(stages) * kWgStage;
  CUtensorMap tx, tw, ty;
  if (!sm90::encode_bf16_2d(&tx, x, n, cin, kWgBM) || !sm90::encode_bf16_2d(&tw, w, cin, cout, 64) ||
      !sm90::encode_bf16_2d(&ty, y, n, cout, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  WgArgs p{static_cast<const float*>(scale), static_cast<const float*>(bias),
           static_cast<float*>(part_s), static_cast<float*>(part_q), n, cin, cout, col_tiles,
           row_tiles, groups, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 128) {
    e = nkbx::allow_smem(matmul_bn_wgmma_kernel<128>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    matmul_bn_wgmma_kernel<128><<<col_tiles * groups, kWgThreads, smem, s>>>(tx, tw, ty, p);
  } else {
    e = nkbx::allow_smem(matmul_bn_wgmma_kernel<64>, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    matmul_bn_wgmma_kernel<64><<<col_tiles * groups, kWgThreads, smem, s>>>(tx, tw, ty, p);
  }
  column_sums<<<(cout + kRC - 1) / kRC, dim3(kRC, kRL), 0, s>>>(
      static_cast<const float*>(part_s), static_cast<const float*>(part_q),
      static_cast<float*>(sum), static_cast<float*>(sumsq), groups, cout);
  return static_cast<int>(cudaGetLastError());
}
