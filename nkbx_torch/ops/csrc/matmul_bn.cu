// A 1x1 convolution as a matrix product with the BatchNorm-apply + relu
// epilogue and the output's per-channel statistics (X1):
//   y = relu((x @ w) * scale + bias), x (N, Cin), w (Cin, Cout), f32
//   accumulation, y written in x's type; sum and sumsq (Cout,) f32 over
//   the rows of the f32 y, before it is rounded: the next BatchNorm's
//   inputs, with no second pass over y.
//
// Replaces experiments/pallas_fused_matmul_bn.py:30 `_kernel` (its
// pallas_call at :69, entry `fused_matmul_bn_relu_stats` :53). C entry
// `nkbx_matmul_bn`.
//
// What bounds it on an H100: at the probe's shapes (Cin = Cout = C = 128,
// 256, 512 over 50k-800k rows, bf16) the bytes of x in and y out at
// 3.35 TB/s, about twice the time of the 2*N*C*C operations on the tensor
// cores; so the design reads x once per 128-wide column tile (the blocks of
// one row tile run next to each other and share it through L2), writes y
// once, and keeps the statistics out of device memory but for one f32 row
// of partial sums per row tile.
//
// The TPU kernel carries the sums from one grid step to the next; blocks
// here run in no order, so each block writes its rows' column sums to a
// (row tiles, Cout) scratch, and `column_sums` adds the tiles in a fixed
// order: two runs agree bit for bit.
//
// Two kernels:
// - matmul_bn_tc_kernel, bf16: warp-level tensor cores (WMMA 16x16x16,
//   f32 accumulators), a 128x128 output tile per block of 8 warps (each
//   32x64), 32-deep slabs of x and w staged through shared memory by
//   cp.async, two in flight. Not yet Hopper's wgmma/TMA.
// - matmul_bn_fma_kernel, f32: float FMAs on the CUDA cores, a 64x64 tile
//   per block of 256 threads, each 4x4 outputs.
// Both stage the f32 product tile in shared memory and share one epilogue.
// Cin and Cout are multiples of 16; rows past N compute on zeros and are
// neither stored nor summed.

#include <mma.h>

#include "dtype.cuh"

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
