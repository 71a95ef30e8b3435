// Full-sequence attention on separate q, k, v (the ViT family), forward.
//
// Replaces the Pallas kernel nkbx/ops/attention.py:275 `_fwd_kernel_sep`
// (entry `fused_attention`). Per group g and head h it computes
//   o = softmax(q k^T * scale + bias[min(h, Hb-1)] + mask[g % M]) v
// from q, k, v of shape (G, N, H*D) with D = 64; head h sits at lanes h*D.
// A null bias or mask adds nothing (the ViT's zeros). Scores and the softmax
// stay in float with one reciprocal per row; the normalised P is rounded to
// the storage type (bf16 or float) before P*V, and P*V accumulates in float
// (attention.py:226-236).
//
// What bounds it on an H100: at ViT-B/16 (N = 197) a (g, h) reads 3*N*D and
// writes N*D values for 4*N*N*D operations, about 200 operations per byte
// in bf16, under the ~295 the card needs before its tensor cores are the
// limit, so the bytes bound it, but only just: the products have to run on
// the tensor cores, or they are the limit many times over. The (N, N)
// scores and probabilities never leave the chip.
//
// bf16 (attention_fwd_tc): a block of 8 warps owns 128 query rows of one
// (g, h), 16 a warp, their Q fragments in registers. To keep the rounding
// points above without holding score rows, it makes two passes over K: the
// first keeps each row's running max and sum of exponentials in registers
// (rescaled online), the second recomputes each 64-key tile of scores,
// forms P = bf16(exp(s - max) / sum) in registers as the A fragments of
// P*V, and accumulates P*V in registers. The products are mma.sync
// m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix (V transposed by
// ldmatrix.trans); exp is the special-function unit's 2^x of (s - max)
// log2(e). K and V tiles (64 x 64) stream through a ring of 4
// shared-memory slots by 16-byte cp.async, two tiles ahead of the tile the
// warps multiply, so the copies overlap the products; shared memory is 54
// KB whatever N is. Keys past N score -inf; query rows past N store nothing
// (a warp whose 16 rows all lie past N skips the products). A given bias or
// mask (attention_fwd_tc<true>) is read a 64-key tile at a time, in both
// passes: each warp copies its 16 rows of the tile by 16-byte cp.async (17
// aligned chunks cover a row's 64 keys whatever N % 4) into 8.5 KB of
// shared memory of its own a plane, as one commit group started before the
// step's ring copies, so it is in flight behind the ring wait and the
// products, and waiting for it leaves the later K/V tiles in flight. The
// staging rows lie over the q tile (dead once in registers): 104 KB a
// block, two blocks an SM. Not wgmma/TMA: mma.sync keeps P in the registers
// the next product reads, and at ViT sizes the kernel sits near its bytes
// bound.
//
// float (attention_fwd_kernel, the first design, kept: TF32 tensor cores
// would miss the f32 tolerance): 32 query rows a block hold their whole
// float score rows and probabilities in shared memory (see
// attention_fwd_smem_bytes); K and V stream through one tile; the products
// are float FMAs in warp-level 16x16 tiles (attention_tile.cuh).

#include <cfloat>
#include <cmath>

#include "attention_tile.cuh"
#include "mma.cuh"

namespace {

using nkbx::ColMajor;
using nkbx::cp_async16;
using nkbx::ldmatrix_x4;
using nkbx::ldmatrix_x4_trans;
using nkbx::mma_bf16;
using nkbx::pack_bf16;
using nkbx::smem_addr;
using nkbx::RowMajor;
using nkbx::WarpTile;
constexpr int D = nkbx::kHeadDim;
constexpr int kLd = nkbx::kLdTile;
constexpr int kTk = nkbx::kKeyTile;
constexpr int kThreads = nkbx::kAttnThreads;
constexpr int kWarps = nkbx::kAttnWarps;
constexpr int kTq = 32;  // query rows per block

size_t attention_fwd_smem_bytes(int n) {
  const int np = nkbx::padded_keys(n);
  return nkbx::align128(kTq * kLd * 4) + nkbx::align128(kTk * kLd * 4) +
         nkbx::align128(static_cast<size_t>(kTq) * (np + 4) * 4) +
         nkbx::align128(static_cast<size_t>(kTq) * (np + 8) * 4);
}

__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const float* __restrict__ mask, float* __restrict__ out, int n, int heads,
                     int bias_heads, int m, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int np = nkbx::padded_keys(n), lds = np + 4, ldp = np + 8;
  const int i0 = blockIdx.x * kTq, h = blockIdx.y, g = blockIdx.z;
  const int c = heads * D;
  float* qs = reinterpret_cast<float*>(smem);
  float* kv = reinterpret_cast<float*>(smem + nkbx::align128(kTq * kLd * 4));
  float* ss = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(kv) +
                                       nkbx::align128(kTk * kLd * 4));
  float* ps = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ss) +
                                       nkbx::align128(static_cast<size_t>(kTq) * lds * 4));
  const size_t head0 = static_cast<size_t>(g) * n * c + h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  nkbx::load_rows(qs, q + head0, c, i0, kTq, n);

  // 1. Raw scores q k^T, one 64-key tile at a time: 2 x 4 warp tiles.
  for (int j0 = 0; j0 < np; j0 += kTk) {
    __syncthreads();  // the previous key tile is consumed
    nkbx::load_rows(kv, k + head0, c, j0, kTk, n);
    __syncthreads();
    for (int f = warp; f < (kTq / 16) * (kTk / 16); f += kWarps) {
      const int rf = f / (kTk / 16), cf = f % (kTk / 16);
      WarpTile<float> t;
      t.zero();
      t.mma<RowMajor, ColMajor>(qs + rf * 16 * kLd, kLd, kv + cf * 16 * kLd, kLd, D);
      t.store(ss + rf * 16 * lds + j0 + cf * 16, lds);
    }
  }
  __syncthreads();

  // 2. Row softmax, one warp per row: s*scale + bias + mask, the max, the
  //    exponentials, one reciprocal of their sum; P zero past N.
  const float* bh = bias ? bias + static_cast<size_t>(min(h, bias_heads - 1)) * n * n : nullptr;
  const float* mg = mask ? mask + static_cast<size_t>(g % m) * n * n : nullptr;
  for (int r = warp; r < kTq; r += kWarps) {
    const int i = i0 + r;
    float* sr = ss + r * lds;
    float* pr = ps + r * ldp;
    if (i >= n) {
      for (int j = lane; j < np; j += 32) pr[j] = 0.f;
      continue;
    }
    const float* bi = bh ? bh + static_cast<size_t>(i) * n : nullptr;
    const float* mi = mg ? mg + static_cast<size_t>(i) * n : nullptr;
    float mx = -FLT_MAX;
    for (int j = lane; j < n; j += 32) {
      float s = sr[j] * scale;
      if (bi) s += bi[j];
      if (mi) s += mi[j];
      sr[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = nkbx::warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(sr[j] - mx);
      sr[j] = e;
      sum += e;
    }
    const float inv = 1.f / nkbx::warp_sum(sum);
    for (int j = lane; j < np; j += 32) pr[j] = j < n ? sr[j] * inv : 0.f;
  }

  // 3. o = P v, one 64-key value tile at a time: 2 x 4 warp tiles, two per
  //    warp, accumulated in registers across the tiles.
  constexpr int kPerWarp = (kTq / 16) * (D / 16) / kWarps;
  WarpTile<float> acc[kPerWarp];
#pragma unroll
  for (int t = 0; t < kPerWarp; ++t) acc[t].zero();
  for (int j0 = 0; j0 < np; j0 += kTk) {
    __syncthreads();  // P is complete; the previous value tile is consumed
    nkbx::load_rows(kv, v + head0, c, j0, kTk, n);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kPerWarp; ++t) {
      const int f = warp + kWarps * t, rf = f / (D / 16), df = f % (D / 16);
      acc[t].mma<RowMajor, RowMajor>(ps + rf * 16 * ldp + j0, ldp, kv + df * 16, kLd, kTk);
    }
  }
  __syncthreads();  // every warp is done with the scores buffer
#pragma unroll
  for (int t = 0; t < kPerWarp; ++t) {
    const int f = warp + kWarps * t, rf = f / (D / 16), df = f % (D / 16);
    acc[t].store(ss + rf * 16 * lds + df * 16, lds);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTq * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    if (i0 + r < n) out[head0 + static_cast<size_t>(i0 + r) * c + d] = ss[r * lds + d];
  }
}

// --- bf16: the streaming tensor-core kernel -----------------------------------------

constexpr int kTcThreads = 256;        // 8 warps
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcRows = 128;           // query rows a block, 16 a warp
constexpr int kTcLd = D + 8;           // row stride of the shared tiles: 144 bytes
constexpr int kTcStages = 4;           // K/V tile slots
constexpr int kTcAhead = 2;            // tiles in flight beyond those a step reads
constexpr int kTcTile = kTk * kTcLd;   // elements of one 64-row tile
constexpr int kTcQTile = kTcRows * kTcLd;  // elements of the q tile
constexpr size_t kTcSmem = static_cast<size_t>(kTcQTile + kTcStages * kTcTile) * 2;  // 55,296 B
constexpr float kLog2e = 1.4426950408889634f;

// A given bias or mask: each warp stages its 16 rows x 64 keys of both
// (N, N) planes in 16-byte chunks. A row of a plane starts at any float when
// N % 4 != 0, so 17 aligned chunks (68 floats) cover its 64 keys. The
// staging rows lie over the q tile, which is dead once its fragments are in
// registers, so two blocks still fit an SM.
constexpr int kExChunks = kTk / 4 + 1;
constexpr int kExLd = 4 * kExChunks;                     // floats a staged row
constexpr int kExFloats = 16 * kExLd;                    // one plane's rows of a warp
constexpr int kExBytes = kTcWarps * 2 * kExFloats * 4;   // 69,632 B
constexpr size_t kTcExtraSmem = kExBytes + static_cast<size_t>(kTcStages) * kTcTile * 2;
static_assert(kExBytes >= kTcQTile * 2, "the staging rows cover the q tile");

// 2^x on the special-function unit.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows row0 .. row0 + rows - 1 of one head's (n, D) slice (src at the head's
// first element, stride c) into a shared tile; rows past n are zero-filled.
__device__ __forceinline__ void copy_tile(unsigned dst, const __nv_bfloat16* __restrict__ src,
                                          int c, int row0, int rows, int n) {
  for (int i = threadIdx.x; i < rows * (D / 8); i += kTcThreads) {
    const int r = i / (D / 8), ch = i % (D / 8);
    const bool in = row0 + r < n;
    cp_async16(dst + (r * kTcLd + ch * 8) * 2,
               src + static_cast<size_t>(in ? row0 + r : 0) * c + ch * 8, in ? 16 : 0);
  }
}

// One (N, N) plane of a bias or mask: the tensor (16-byte aligned), the
// plane's first element and the tensor's element count; base null when absent.
struct Plane {
  const float* base;
  size_t first, total;
};

// Copy the warp's rows row0 .. row0 + 15 of a plane at keys j0 .. j0 + 63
// into its staging rows (shared address sc) by 16-byte cp.async: chunk c of
// a row holds the plane's elements from (the row's element j0, rounded down
// to a multiple of 4) + 4c. Chunks wholly past the row's last key and rows
// past n are zero-filled, and so are the bytes past the tensor's end.
__device__ __forceinline__ void stage_plane(unsigned sc, const Plane& p, int row0, int j0,
                                            int n) {
  const int lane = threadIdx.x % 32, keys = min(kTk, n - j0);
  for (int idx = lane; idx < 16 * kExChunks; idx += 32) {
    const int rr = idx / kExChunks, c = idx - rr * kExChunks;
    const size_t e0 = p.first + static_cast<size_t>(row0 + rr) * n + j0;
    const size_t cs = (e0 & ~static_cast<size_t>(3)) + 4 * c;
    int bytes = 0;
    if (row0 + rr < n && 4 * c < static_cast<int>(e0 & 3) + keys)
      bytes = cs + 4 <= p.total ? 16 : static_cast<int>(p.total - cs) * 4;
    cp_async16(sc + (rr * kExLd + 4 * c) * 4, bytes ? p.base + cs : p.base, bytes);
  }
}

// s += the plane's values at this warp's scores (layout of tile_scores),
// from its staging rows sc.
__device__ __forceinline__ void add_plane(float (&s)[8][4], const float* sc, const Plane& p,
                                          int row0, int j0, int n) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int rr = lane / 4 + hi * 8;
    const int off = static_cast<int>((p.first + static_cast<size_t>(row0 + rr) * n + j0) & 3);
    const float* src = sc + rr * kExLd + off + (lane % 4) * 2;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][2 * hi] += src[nt * 8];
      s[nt][2 * hi + 1] += src[nt * 8 + 1];
    }
  }
}

// Wait until at most `newer` of this thread's latest cp.async groups are
// pending, every older one landed (more than 3 waits as for 3).
__device__ __forceinline__ void cp_async_wait_newer(int newer) {
  if (newer >= 3)
    nkbx::cp_async_wait<3>();
  else if (newer == 2)
    nkbx::cp_async_wait<2>();
  else if (newer == 1)
    nkbx::cp_async_wait<1>();
  else
    nkbx::cp_async_wait<0>();
}

// Scores of this warp's 16 rows against one 64-key tile (keys j0 ..): s[nt]
// holds rows lane/4 (elements 0, 1) and lane/4 + 8 (2, 3) at keys
// j0 + nt*8 + 2 (lane % 4) + {0, 1}; scaled, plus bias and mask (kExtra:
// from the warp's staging rows ex, whose copies, `newer` groups back, were
// in flight behind the products), -inf past n.
template <bool kExtra>
__device__ __forceinline__ void tile_scores(float (&s)[8][4], const unsigned (&qf)[4][4],
                                            unsigned kt, int j0, int row0, int n, float scale,
                                            const Plane& bias, const Plane& mask,
                                            const float* ex, int newer) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      // matrices: keys +0..7 / d +0..7, keys +0..7 / d +8..15, keys +8..15 / ...
      const int mi = lane / 8;
      const int key = np * 16 + (mi / 2) * 8 + lane % 8, d = kc * 16 + (mi % 2) * 8;
      unsigned b[4];
      ldmatrix_x4(b, kt + (key * kTcLd + d) * 2);
      mma_bf16(s[2 * np], qf[kc], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf[kc], b[2], b[3]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] *= scale;
  if constexpr (kExtra) {
    cp_async_wait_newer(newer);
    __syncwarp();  // every lane's copies are visible
    if (bias.base) add_plane(s, ex, bias, row0, j0, n);
    if (mask.base) add_plane(s, ex + kExFloats, mask, row0, j0, n);
  }
  if (j0 + kTk <= n) return;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (j0 + nt * 8 + (lane % 4) * 2 + e % 2 >= n) s[nt][e] = -INFINITY;
}

// kExtra: a bias or a mask is given, staged a key tile at a time.
template <bool kExtra>
__global__ void __launch_bounds__(kTcThreads, 2)
attention_fwd_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                 const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, int n,
                 int heads, int bias_heads, int m, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned qs = smem_addr(smem), ring = qs + (kExtra ? kExBytes : kTcQTile * 2);
  const int i0 = blockIdx.x * kTcRows, h = blockIdx.y, g = blockIdx.z;
  const int c = heads * D, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t head0 = static_cast<size_t>(g) * n * c + h * D;
  const size_t nn = static_cast<size_t>(n) * n;
  const Plane pb{bias, bias ? min(h, bias_heads - 1) * nn : 0, bias_heads * nn};
  const Plane pm{mask, mask ? (g % m) * nn : 0, m * nn};
  const float* ex = reinterpret_cast<const float*>(smem) + warp * 2 * kExFloats;
  const int nk = (n + kTk - 1) / kTk, tiles = 3 * nk;
  const int row0 = i0 + warp * 16;
  const bool busy = row0 < n;  // a warp with no row below n only copies and waits

  // The tile stream: K tiles 0 .. nk-1 (pass 1), then K and V of tile j in turn
  // (pass 2). Tile t goes to slot t % kTcStages; one commit group a tile, and
  // the Q tile rides in the first group. kExtra: a warp's staging of a step's
  // bias and mask rows is one more group, committed before that step's ring
  // copies, so waiting for either leaves the later ring copies in flight.
  copy_tile(qs, q + head0, c, i0, kTcRows, n);
  int issued = 0, committed = 0, staged = 0, slot_group[kTcStages] = {};
  auto commit = [&] {
    nkbx::cp_async_commit();
    return committed++;
  };
  auto issue = [&](int t) {
    if (t < tiles) {
      const int j = t < nk ? t : (t - nk) / 2;
      const bool is_v = t >= nk && (t - nk) % 2;
      copy_tile(ring + (t % kTcStages) * kTcTile * 2, (is_v ? v : k) + head0, c, j * kTk, kTk,
                n);
    }
    slot_group[t % kTcStages] = commit();
  };
  auto stage = [&](int j0) {  // this warp's bias and mask rows at the key tile j0
    if (pb.base) stage_plane(smem_addr(ex), pb, row0, j0, n);
    if (pm.base) stage_plane(smem_addr(ex + kExFloats), pm, row0, j0, n);
    staged = commit();
  };
  // make tiles up to `need` resident in every thread's view, two more in flight;
  // kExtra: first start the staging for the key tile at j0 (none if j0 < 0)
  auto ready = [&](int need, int j0) {
    __syncthreads();  // the slots about to be refilled are no longer read
    if constexpr (kExtra) {
      if (busy && j0 >= 0) stage(j0);
    }
    while (issued <= need + kTcAhead) issue(issued++);
    if constexpr (kExtra)
      cp_async_wait_newer(committed - 1 - slot_group[need % kTcStages]);
    else
      nkbx::cp_async_wait<kTcAhead>();
    __syncthreads();
  };

  unsigned qf[D / 16][4];
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  float s[8][4];

  // 1. Statistics: the running row max and sum of exp over the key tiles.
  for (int t = 0; t < nk; ++t) {
    ready(t, t > 0 ? t * kTk : -1);
    if (t == 0) {
      if (busy) {
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          const int mi = lane / 8, r = warp * 16 + (mi % 2) * 8 + lane % 8;
          ldmatrix_x4(qf[kc], qs + (r * kTcLd + kc * 16 + (mi / 2) * 8) * 2);
        }
      }
      if constexpr (kExtra) {
        __syncthreads();  // every warp holds its q fragments: the staging may overwrite them
        if (busy) stage(0);
      }
    }
    if (!busy) continue;
    tile_scores<kExtra>(s, qf, ring + (t % kTcStages) * kTcTile * 2, t * kTk, row0, n, scale,
                        pb, pm, ex, committed - 1 - staged);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float tmax = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) tmax = fmaxf(tmax, fmaxf(s[nt][2 * hi], s[nt][2 * hi + 1]));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float mnew = fmaxf(mx[hi], tmax);
      float acc = mx[hi] == -INFINITY ? 0.f : sum[hi] * exp2_approx((mx[hi] - mnew) * kLog2e);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        acc += exp2_approx((s[nt][2 * hi] - mnew) * kLog2e) +
               exp2_approx((s[nt][2 * hi + 1] - mnew) * kLog2e);
      mx[hi] = mnew;
      sum[hi] = acc;  // this lane's share; the quad adds its four after the pass
    }
  }
  float inv[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    float t = sum[hi];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    inv[hi] = 1.f / t;
  }

  // 2. Output: recompute each tile's scores, P = bf16(exp(s - max) * inv) in
  //    registers as the A fragments of P*V, accumulate P*V in float.
  float o[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  for (int t = 0; t < nk; ++t) {
    ready(nk + 2 * t + 1, t * kTk);
    if (!busy) continue;
    const unsigned kt = ring + ((nk + 2 * t) % kTcStages) * kTcTile * 2;
    const unsigned vt = ring + ((nk + 2 * t + 1) % kTcStages) * kTcTile * 2;
    tile_scores<kExtra>(s, qf, kt, t * kTk, row0, n, scale, pb, pm, ex, committed - 1 - staged);
#pragma unroll
    for (int kc = 0; kc < kTk / 16; ++kc) {
      auto p = [&](int nt, int e) {
        return exp2_approx((s[nt][e] - mx[e / 2]) * kLog2e) * inv[e / 2];
      };
      unsigned pa[4];
      pa[0] = pack_bf16(p(2 * kc, 0), p(2 * kc, 1));
      pa[1] = pack_bf16(p(2 * kc, 2), p(2 * kc, 3));
      pa[2] = pack_bf16(p(2 * kc + 1, 0), p(2 * kc + 1, 1));
      pa[3] = pack_bf16(p(2 * kc + 1, 2), p(2 * kc + 1, 3));
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        // matrices: keys +0..7 / d +0..7, keys +8..15 / d +0..7, keys +0..7 / d +8..15, ...
        const int mi = lane / 8;
        const int key = kc * 16 + (mi % 2) * 8 + lane % 8, d = dp * 16 + (mi / 2) * 8;
        unsigned b[4];
        ldmatrix_x4_trans(b, vt + (key * kTcLd + d) * 2);
        mma_bf16(o[2 * dp], pa, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pa, b[2], b[3]);
      }
    }
  }
  nkbx::cp_async_wait<0>();
  if (!busy) return;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int i = row0 + lane / 4 + hi * 8;
    if (i >= n) continue;
    __nv_bfloat16* dst = out + head0 + static_cast<size_t>(i) * c + (lane % 4) * 2;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<unsigned*>(dst + nt * 8) = pack_bf16(o[nt][2 * hi], o[nt][2 * hi + 1]);
  }
}

template <bool kExtra>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* bias,
                      const void* mask, void* out, int g, int n, int heads, int bias_heads,
                      int m, float scale, cudaStream_t stream) {
  const size_t smem = kExtra ? kTcExtraSmem : kTcSmem;
  const cudaError_t err = nkbx::allow_smem(attention_fwd_tc<kExtra>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTcRows - 1) / kTcRows, heads, g);
  attention_fwd_tc<kExtra><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out), n, heads, bias_heads, m,
      scale);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* bias,
                       const void* mask, void* out, int g, int n, int heads, int bias_heads,
                       int m, float scale, cudaStream_t stream) {
  const size_t smem = attention_fwd_smem_bytes(n);
  const cudaError_t err = nkbx::allow_smem(attention_fwd_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTq - 1) / kTq, heads, g);
  attention_fwd_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<float*>(out),
      n, heads, bias_heads, m, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out (G, N, H*64) in float (is_bf16 = 0) or bf16, and bias
// (bias_heads, N, N) and mask (M, N, N) in float or null for zeros, all
// 16-byte aligned. Returns the CUDA error code of the launch (0 on success).
extern "C" int nkbx_attention(const void* q, const void* k, const void* v, const void* bias,
                              const void* mask, void* out, int g, int n, int heads,
                              int bias_heads, int m, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (!is_bf16)
    err = launch_f32(q, k, v, bias, mask, out, g, n, heads, bias_heads, m, scale, s);
  else if (bias || mask)
    err = launch_tc<true>(q, k, v, bias, mask, out, g, n, heads, bias_heads, m, scale, s);
  else
    err = launch_tc<false>(q, k, v, bias, mask, out, g, n, heads, bias_heads, m, scale, s);
  return static_cast<int>(err);
}
