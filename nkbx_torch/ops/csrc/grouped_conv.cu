// A stride-1, pad-1 3x3 grouped convolution over NHWC (X2):
//   out[b, h, w, o] = sum over taps (ty, tx) and j < gw of
//                     w[ty, tx, j, o] * x[b, h + ty - 1, w + tx - 1, g*gw + j],
// g = o / gw, zero outside the image; f32 accumulation, out in x's type.
// The weights come in the probe's rotation order, wvec (9*gw, C) with
// wvec[tap*gw + r, o] = w[ty, tx, (o % gw + r) % gw, o] (`build_wvec`).
//
// Replaces experiments/r3_grouped_conv_vpu.py:75 `_gconv_kernel` (its
// pallas_call at :98 in `gconv_pallas`). C entry `nkbx_gconv`.
//
// The TPU kernel keeps the channels in the 128 lanes and makes gw - 1
// within-group lane rotations of the input tile, then runs 9 taps x gw
// rotations of elementwise FMAs. Here the same function is an implicit GEMM
// per group on the tensor cores.
//
// What bounds it on an H100: at resnext50_32x4d's stages (batch 64, bf16)
// the bytes of x in and out at 3.35 TB/s (0.031 / 0.015 / 0.008 / 0.004 ms
// at stages 1-4); the 1.85 GFLOP of a stage is 0.002 ms on the tensor cores.
// So the design moves each byte of x once and keeps everything else on chip.
//
// bf16 (gconv_tc_kernel): mma.sync.m16n8k16 (bf16 in, f32 accumulate). M =
// 16 output pixels, N = 8 output channels, K = (tap, input channel of the
// N tile's window), the window being the channels that feed the tile:
// its group (gw >= 8) or, for gw < 8, the 8 channels of the 8/gw groups it
// packs, with block-diagonal weights (zero across groups). A block owns
// CB = 64 channels (32 when C is not a multiple of 64), so a pixel's staged
// run is 128 bytes, and walks whole bands of output rows of one or more
// images: input rows stream through a ring of shared-memory slots by 16-byte
// cp.async, each row once per band (no halo within a band), the next step's
// rows in flight behind the current step's products (one commit group a
// step, two steps ahead). A step computes TR
// output rows (TR*W about 128 pixels: 2 rows at W = 56, the whole image at
// W = 7) from TR + 2 staged rows. The A fragments come from the slots with
// ldmatrix, one row address per pixel, so a tap is only an address shift.
// The block unscrambles its CB channels' weights once into B fragments in
// shared memory, B[(tap, j), o] = wvec[tap*gw + (j - o % gw) mod gw, o],
// and a persistent grid (about one wave) reuses them for every band it
// walks. wgmma does not fit: its A operand would have to be an im2col tile
// in a canonical shared-memory layout, rebuilt for every tap, and the
// kernel is bound by its bytes anyway. What holds it above that bound
// (PERF.md, "Port to H100"): at stages 1-2 the shared-memory reads of the fragments
// (each input byte is read for 9 taps, and for gw < 8 half of each A tile
// meets zero weights); at stages 3-4, with a whole image a step, each
// block's weight staging and its first rows' latency.
//
// float (gconv_kernel, kept from the first design: TF32 tensor cores would
// miss the f32 tolerance): each thread owns one output channel and reads its
// group's input channels from an f32 band in shared memory at the probe's
// rotations, kP = 4 outputs per weight read, on the CUDA cores.

#include <algorithm>
#include <array>
#include <map>
#include <mutex>

#include "dtype.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using nkbx::cp_async16;
using nkbx::cp_async_commit;
using nkbx::ldmatrix_x4;
using nkbx::mma_bf16;
using nkbx::pack_bf16;
using nkbx::smem_addr;
using nkbx::to_f;

constexpr int kCC = 32, kTH = 4, kLanes = 8, kP = 4, kThreads = kCC * kLanes;

struct Geo {
  int b, h, w, c;
  int wp, ws;    // output columns rounded up to kP; staged columns (wp + 2)
  int bands, chunks;
};

__host__ __device__ inline size_t smem_floats(int ws, int gw) {
  return static_cast<size_t>(kTH + 2) * ws * kCC + static_cast<size_t>(9) * gw * kCC;
}

template <int GW>
__global__ void __launch_bounds__(kThreads) gconv_kernel(const float* __restrict__ x,
                                                        const float* __restrict__ wvec,
                                                        float* __restrict__ out, Geo G) {
  extern __shared__ float sm[];
  float* xs = sm;                            // (kTH + 2, ws, kCC)
  float* wsm = sm + (kTH + 2) * G.ws * kCC;  // (9 * GW, kCC)
  int id = blockIdx.x;
  const int cb = id % G.chunks;
  id /= G.chunks;
  const int band = id % G.bands, bi = id / G.bands;
  const int c0 = cb * kCC, h0 = band * kTH;

  for (int i = threadIdx.x; i < (kTH + 2) * G.ws * kCC; i += kThreads) {
    const int ch = i % kCC, rest = i / kCC;
    const int hh = h0 - 1 + rest / G.ws, ww = rest % G.ws - 1;
    float v = 0.f;
    if (hh >= 0 && hh < G.h && ww >= 0 && ww < G.w)
      v = x[((static_cast<size_t>(bi) * G.h + hh) * G.w + ww) * G.c + c0 + ch];
    xs[i] = v;
  }
  for (int i = threadIdx.x; i < 9 * GW * kCC; i += kThreads)
    wsm[i] = wvec[static_cast<size_t>(i / kCC) * G.c + c0 + i % kCC];
  __syncthreads();

  // rotations unrolled kRU at a time: fully unrolled, gw = 16 and 32 spill
  constexpr int kRU = GW < 8 ? GW : 8;
  const int oc = threadIdx.x % kCC, lane = threadIdx.x / kCC;
  const int og = oc - oc % GW, oj = oc % GW;  // the group's first channel; o % gw
  const int per_row = G.wp / kP;
  for (int s = lane; s < kTH * per_row; s += kLanes) {
    const int r = s / per_row, col0 = (s % per_row) * kP;
    float acc[kP] = {};
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const float* xrow = xs + ((r + tap / 3) * G.ws + col0 + tap % 3) * kCC + og;
      const float* wrow = wsm + tap * GW * kCC + oc;
#pragma unroll 1
      for (int r0 = 0; r0 < GW; r0 += kRU) {
#pragma unroll
        for (int u = 0; u < kRU; ++u) {
          const int j = (oj + r0 + u) & (GW - 1);
          const float wv = wrow[(r0 + u) * kCC];
#pragma unroll
          for (int p = 0; p < kP; ++p) acc[p] = fmaf(wv, xrow[p * kCC + j], acc[p]);
        }
      }
    }
    const int hh = h0 + r;
    if (hh >= G.h) continue;
    for (int p = 0; p < kP; ++p) {
      const int ww = col0 + p;
      if (ww < G.w)
        out[((static_cast<size_t>(bi) * G.h + hh) * G.w + ww) * G.c + c0 + oc] = acc[p];
    }
  }
}

template <int GW>
cudaError_t launch(const void* x, const void* wvec, void* out, const Geo& G, cudaStream_t s) {
  const size_t bytes = smem_floats(G.ws, GW) * sizeof(float);
  const cudaError_t e = nkbx::allow_smem(gconv_kernel<GW>, bytes);
  if (e != cudaSuccess) return e;
  gconv_kernel<GW><<<G.b * G.bands * G.chunks, kThreads, bytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wvec), static_cast<float*>(out), G);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, const void* wvec, void* out, const Geo& G, int gw,
                     cudaStream_t s) {
  switch (gw) {
    case 1: return launch<1>(x, wvec, out, G, s);
    case 2: return launch<2>(x, wvec, out, G, s);
    case 4: return launch<4>(x, wvec, out, G, s);
    case 8: return launch<8>(x, wvec, out, G, s);
    case 16: return launch<16>(x, wvec, out, G, s);
    case 32: return launch<32>(x, wvec, out, G, s);
    default: return cudaErrorInvalidValue;
  }
}

// --- bf16: the tensor-core kernel ----------------------------------------------------

constexpr int kTcThreads = 256, kTcWarps = kTcThreads / 32;
constexpr int kMaxTr = 12;  // output rows of a step at most

struct TcGeo {
  int b, h, w, c;
  int tr;     // output rows a step
  int spi;    // steps a band
  int th;     // output rows a band, spi * tr (rows past H compute on zeros, store nothing)
  int rpi;    // input rows a band streams, th + 2
  int bands, items;  // bands an image; b * bands bands of one channel chunk
  int ahead;  // steps whose rows are in flight beyond the current one's: 2, or 1
  int nr;     // ring slots, (ahead + 1) * (tr + 2)
};

template <int GW, int CB>
struct Tc {
  static constexpr int kKw = GW < 8 ? 8 : GW;      // input channels of an N tile's window
  static constexpr int kNkc = (9 * kKw + 15) / 16;  // K chunks of 16 over (tap, window channel)
  static constexpr int kNt = CB / 8;                // N tiles of the block's channels
  static constexpr int kNtw = kNt / 2;              // N tiles of a warp's task
  static constexpr int kPs = CB * 2 + 16;  // bytes a staged pixel; +16: no ldmatrix conflicts
  __host__ __device__ static size_t wf_bytes() {
    return static_cast<size_t>(kNkc) * kNt * 32 * 8;
  }
  static constexpr int kRawLd = CB * 2 + 16;  // bytes a staged wvec row (+16: fewer conflicts)
  static constexpr size_t kRawBytes = static_cast<size_t>(9) * GW * kRawLd;  // wvec's chunk
  // the B fragments, then the ring of (ahead + 1) (tr + 2) slots (which first
  // holds the raw weights while the block unscrambles them)
  __host__ static size_t smem(int w, int tr, int ahead) {
    const size_t ring = static_cast<size_t>(ahead + 1) * (tr + 2) * (w + 2) * kPs;
    return wf_bytes() + (ring > kRawBytes ? ring : kRawBytes);
  }
};

// Blocks (grid.x, C / CB): block (i, cb) walks bands i, i + grid.x, ... of
// channel chunk cb. Shared memory: the B fragments (kNkc, kNt, 32 lanes,
// 2 words), then nr ring slots of (w + 2) staged pixels (columns -1 .. w).
template <int GW, int CB>
__global__ void __launch_bounds__(kTcThreads, 2)
gconv_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wvec,
                bf16* __restrict__ out, TcGeo G) {
  using K = Tc<GW, CB>;
  constexpr int kKw = K::kKw, kNkc = K::kNkc, kNt = K::kNt, kNtw = K::kNtw, kPs = K::kPs;
  constexpr int kChunks = CB / 8;  // 16-byte copies a pixel
  extern __shared__ __align__(128) unsigned char smem[];
  uint2* wf = reinterpret_cast<uint2*>(smem);
  unsigned char* ring = smem + K::wf_bytes();
  const unsigned ring_s = smem_addr(ring);
  const int slot_bytes = (G.w + 2) * kPs;
  const int c0 = blockIdx.y * CB, tid = threadIdx.x;

  // 1. The chunk's weights as B fragments, once: wvec's (9 gw, CB) chunk into
  //    the ring by 16-byte copies, then lane l of tile (kc, nt) takes B[k][n]
  //    for n = l / 4 and k = 2 (l % 4) + {0, 1} (word x) and + 8 (word y).
  const bf16* raw = reinterpret_cast<const bf16*>(ring);
  for (int i = tid; i < 9 * GW * kChunks; i += kTcThreads) {
    const int row = i / kChunks, ch = i % kChunks;
    cp_async16(ring_s + row * K::kRawLd + ch * 16,
               wvec + static_cast<size_t>(row) * G.c + c0 + ch * 8, 16);
  }
  cp_async_commit();
  nkbx::cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < kNkc * kNt * 32; i += kTcThreads) {
    const int lane = i % 32, f = i / 32, nt = f % kNt, kc = f / kNt;
    const int o = nt * 8 + lane / 4, win0 = nt * 8 / kKw * kKw;
    unsigned word[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float e[2];  // bf16 values, exact in float
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kk = kc * 16 + half * 8 + (lane % 4) * 2 + u;
        const int tap = kk / kKw, ci = win0 + kk % kKw;
        e[u] = 0.f;
        if (tap < 9 && ci / GW == o / GW)
          e[u] = to_f(raw[(tap * GW + ((ci - o) & (GW - 1))) * (K::kRawLd / 2) + o]);
      }
      word[half] = pack_bf16(e[0], e[1]);
    }
    wf[i] = make_uint2(word[0], word[1]);
  }
  __syncthreads();  // the raw weights are read; the ring is free
  // the zero columns -1 and w of every slot; the loads never write them
  for (int i = tid; i < G.nr * 2 * kChunks; i += kTcThreads) {
    const int ch = i % kChunks, side = (i / kChunks) % 2, slot = i / (2 * kChunks);
    *reinterpret_cast<uint4*>(ring + slot * slot_bytes + (side ? G.w + 1 : 0) * kPs + ch * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // The block's stream of input rows: row rr of its band `item` (bands
  // blockIdx.x, + gridDim.x, ...) goes to ring slot `slot`; issue_rows(n)
  // puts the next n rows in flight as one commit group.
  int nx_rr = 0, nx_slot = 0, nx_item = blockIdx.x;
  int nx_bi = nx_item / G.bands, nx_band = nx_item - nx_bi * G.bands;
  auto issue_rows = [&](int n) {
    for (; n > 0; --n) {
      if (nx_item < G.items) {
        const int hh = nx_band * G.th - 1 + nx_rr;
        const bool in = hh >= 0 && hh < G.h;
        const bf16* src = x + (static_cast<size_t>(nx_bi) * G.h + (in ? hh : 0)) * G.w * G.c + c0;
        const unsigned dst = ring_s + nx_slot * slot_bytes + kPs;
        for (int i = tid; i < G.w * kChunks; i += kTcThreads) {
          const int px = i / kChunks, ch = i % kChunks;
          cp_async16(dst + px * kPs + ch * 16, src + static_cast<size_t>(px) * G.c + ch * 8,
                     in ? 16 : 0);
        }
      }
      if (++nx_slot == G.nr) nx_slot = 0;
      if (++nx_rr == G.rpi) {
        nx_rr = 0;
        nx_item += gridDim.x;
        nx_bi = nx_item / G.bands;
        nx_band = nx_item - nx_bi * G.bands;
      }
    }
    cp_async_commit();
  };
  // the last stream row that step v reads
  auto last_row = [&](int v) {
    const int k = v / G.spi, t = v - k * G.spi;
    return k * G.rpi + t * G.tr + G.tr + 1;
  };

  const int warp = tid / 32, lane = tid % 32, hsel = lane >> 4;
  const int pixels = G.tr * G.w, tasks = (pixels + 15) / 16 * 2;
  int issued = 0, issued_step = -1;  // stream rows and steps whose rows are in flight
  for (int u = 0;; ++u) {
    const int k = u / G.spi, t = u - k * G.spi;
    const int item = blockIdx.x + k * gridDim.x;
    if (item >= G.items) break;
    const int s_first = k * G.rpi + t * G.tr;
    __syncthreads();  // the previous step is done with the slots about to be refilled
    // one commit group a step, issued `ahead` steps before the step reads it
    while (issued_step < u + G.ahead) {
      const int upto = last_row(++issued_step) + 1;
      issue_rows(upto - issued);
      issued = upto;
    }
    // this thread's copies of this step's rows have landed
    G.ahead == 2 ? nkbx::cp_async_wait<2>() : nkbx::cp_async_wait<1>();
    __syncthreads();         // and everyone's
    const int bi = item / G.bands, band = item - bi * G.bands;
    const int h0 = band * G.th + t * G.tr;
    for (int task = warp; task < tasks; task += kTcWarps) {
      const int m = task >> 1, nh = task & 1;
      // this lane's A row: pixel p of the step (a pad pixel reads pixel 0)
      int p = m * 16 + (lane & 15);
      if (p >= pixels) p = 0;
      const int r = p / G.w, c = p - r * G.w;
      unsigned toff[9];
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) {
        const unsigned row = ring_s + ((s_first + r + ty) % G.nr) * slot_bytes + c * kPs;
#pragma unroll
        for (int tx = 0; tx < 3; ++tx) toff[ty * 3 + tx] = row + tx * kPs;
      }
      float acc[kNtw][4];
#pragma unroll
      for (int j = 0; j < kNtw; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kNkc; ++kc) {
        // K half 0 (lanes 0-15) and half 1 (lanes 16-31) of this chunk: tap and channel
        const int ka = kc * 16, kb = kc * 16 + 8;
        const int tap_a = ka / kKw, tap_b = kb / kKw < 9 ? kb / kKw : 8;  // tap 9: zero weights
        const unsigned abase = hsel ? toff[tap_b] + (kb % kKw) * 2 : toff[tap_a] + (ka % kKw) * 2;
        unsigned a[4];
#pragma unroll
        for (int j = 0; j < kNtw; ++j) {
          const int nt = nh * kNtw + j;
          if (j == 0 || (j * 8) % kKw == 0) ldmatrix_x4(a, abase + (nt * 8 / kKw * kKw) * 2);
          const uint2 b = wf[(kc * kNt + nt) * 32 + lane];
          mma_bf16(acc[j], a, b.x, b.y);
        }
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int q = m * 16 + lane / 4 + hi * 8;
        if (q >= pixels) continue;
        const int hh = h0 + q / G.w, ww = q % G.w;
        if (hh >= G.h) continue;
        bf16* dst = out + ((static_cast<size_t>(bi) * G.h + hh) * G.w + ww) * G.c + c0 +
                    nh * kNtw * 8 + (lane % 4) * 2;
#pragma unroll
        for (int j = 0; j < kNtw; ++j)
          *reinterpret_cast<unsigned*>(dst + j * 8) = pack_bf16(acc[j][2 * hi], acc[j][2 * hi + 1]);
      }
    }
  }
  nkbx::cp_async_wait<0>();
}

struct TcPlan {
  TcGeo geo;
  int grid;
  size_t smem;
};

// Shapes the steps and bands of a launch and sizes its persistent grid: one
// wave of blocks, each chunk's bands dealt out evenly, the band count that
// streams the fewest rows a block (ties: fewer bands, so fewer halo rows).
// cudaErrorInvalidValue when no block fits.
template <int GW, int CB>
cudaError_t plan_tc(int b, int h, int w, int c, TcPlan* plan) {
  using K = Tc<GW, CB>;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int chunks = c / CB;
  const int tr0 = std::min(std::max(128 / w, 1), kMaxTr);
  long long best_cost = -1;
  for (int bands = 1; bands <= h; ++bands) {
    const int th0 = (h + bands - 1) / bands;
    if ((h + th0 - 1) / th0 != bands) continue;
    const int steps = (th0 + tr0 - 1) / tr0, tr = (th0 + steps - 1) / steps;
    int ahead = 2;  // two steps in flight, or one where that does not fit
    if (K::smem(w, tr, ahead) > 232448) ahead = 1;
    const size_t smem = K::smem(w, tr, ahead);
    if (smem > 232448) continue;
    e = nkbx::allow_smem(gconv_tc_kernel<GW, CB>, smem);
    int per_sm = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gconv_tc_kernel<GW, CB>,
                                                        kTcThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm == 0) continue;
    const long long items = static_cast<long long>(b) * bands;
    const long long cap = static_cast<long long>(per_sm) * sms;
    const long long per_chunk = std::max(1LL, std::min(items, cap / chunks));
    const long long ipb = (items + per_chunk - 1) / per_chunk;
    const long long grid = (items + ipb - 1) / ipb;
    const long long waves = (grid * chunks + cap - 1) / cap;
    const long long cost = waves * ipb * (steps * tr + 2);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      plan->geo = TcGeo{b, h, w, c, tr, steps, steps * tr, steps * tr + 2, bands,
                        static_cast<int>(items), ahead, (ahead + 1) * (tr + 2)};
      plan->grid = static_cast<int>(grid);
      plan->smem = smem;
    }
  }
  if (best_cost < 0) return cudaErrorInvalidValue;
  return nkbx::allow_smem(gconv_tc_kernel<GW, CB>, 232448);
}

// One plan per shape and device, made at its first launch.
template <int GW, int CB>
cudaError_t launch_tc(const void* x, const void* wvec, void* out, int b, int h, int w, int c,
                      cudaStream_t s) {
  static std::mutex mu;
  static std::map<std::array<int, 5>, TcPlan> plans;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  TcPlan plan;
  {
    std::lock_guard<std::mutex> lock(mu);
    const std::array<int, 5> key{dev, b, h, w, c};
    auto it = plans.find(key);
    if (it == plans.end()) {
      e = plan_tc<GW, CB>(b, h, w, c, &plan);
      if (e != cudaSuccess) return e;
      it = plans.emplace(key, plan).first;
    }
    plan = it->second;
  }
  gconv_tc_kernel<GW, CB><<<dim3(plan.grid, c / CB), kTcThreads, plan.smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wvec), static_cast<bf16*>(out),
      plan.geo);
  return cudaGetLastError();
}

template <int GW>
cudaError_t launch_tc(const void* x, const void* wvec, void* out, int b, int h, int w, int c,
                      cudaStream_t s) {
  return c % 64 ? launch_tc<GW, 32>(x, wvec, out, b, h, w, c, s)
                : launch_tc<GW, 64>(x, wvec, out, b, h, w, c, s);
}

cudaError_t dispatch_tc(const void* x, const void* wvec, void* out, int b, int h, int w, int c,
                        int gw, cudaStream_t s) {
  switch (gw) {
    case 1: return launch_tc<1>(x, wvec, out, b, h, w, c, s);
    case 2: return launch_tc<2>(x, wvec, out, b, h, w, c, s);
    case 4: return launch_tc<4>(x, wvec, out, b, h, w, c, s);
    case 8: return launch_tc<8>(x, wvec, out, b, h, w, c, s);
    case 16: return launch_tc<16>(x, wvec, out, b, h, w, c, s);
    case 32: return launch_tc<32>(x, wvec, out, b, h, w, c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory of one block, in bytes, for an image width w and group
// width gw: the larger of the two kernels' at their least (the f32 band of
// kTH + 2 rows; the bf16 ring at one output row a step and one in flight). The wrapper refuses
// what no block can hold.
extern "C" int nkbx_gconv_smem_bytes(int w, int gw) {
  const size_t f32 = smem_floats((w + kP - 1) / kP * kP + 2, gw) * sizeof(float);
  const size_t tc = Tc<32, 64>::smem(w, 1, 1);
  const size_t bytes = f32 > tc ? f32 : tc;
  return bytes > 0x7fffffff ? 0x7fffffff : static_cast<int>(bytes);
}

// x, out (b, h, w, c) NHWC and wvec (9*gw, c) in float (is_bf16 = 0) or
// bf16, 16-byte aligned; gw a power of two up to 32, c a multiple of 32.
// Returns the CUDA error code of the launch.
extern "C" int nkbx_gconv(const void* x, const void* wvec, void* out, int b, int h, int w, int c,
                          int gw, int is_bf16, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || c % kCC || gw <= 0 || gw > kCC || (gw & (gw - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return static_cast<int>(dispatch_tc(x, wvec, out, b, h, w, c, gw, s));
  Geo G;
  G.b = b; G.h = h; G.w = w; G.c = c;
  G.wp = (w + kP - 1) / kP * kP;
  G.ws = G.wp + 2;
  G.bands = (h + kTH - 1) / kTH;
  G.chunks = c / kCC;
  if (static_cast<long long>(b) * G.bands * G.chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(x, wvec, out, G, gw, s));
}
