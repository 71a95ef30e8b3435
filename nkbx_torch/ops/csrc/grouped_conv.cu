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
// rotations of elementwise FMAs. A CUDA thread has no lanes to rotate: here
// each thread owns one output channel o and reads the input channels of its
// group from shared memory, g*gw + (o % gw + r) % gw at rotation r, against
// wvec's row tap*gw + r. The same function, without the copies.
//
// What bounds it on an H100: at resnext50_32x4d's stages (batch 64, bf16)
// the bytes of x in and out at 3.35 TB/s (0.03 ms at stage 1); the 1.85
// GFLOP of a stage is 0.002 ms on the tensor cores. This first kernel runs
// on the CUDA cores (f32 FMAs, 67 TFLOP/s: 0.028 ms) and its inner loop
// reads shared memory five times for every four FMAs, so shared-memory
// bandwidth bounds it well above either; tensor cores (a block-diagonal
// product per group) are later work.
//
// One block: image b, a band of kTH output rows, kCC = 32 channels (whole
// groups, gw <= 32). It stages the zero-padded (kTH + 2) x (W' + 2) input
// band of its channels and its (9*gw, kCC) weights in shared memory as f32
// (W' = W rounded up to kP). 256 threads = 32 channels x 8 pixel lanes;
// each thread computes kP = 4 neighbouring outputs of its channel at a time,
// so a weight read from shared memory serves 4 FMAs.

#include "dtype.cuh"

namespace {

using bf16 = __nv_bfloat16;
using nkbx::from_f;
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

template <typename T, int GW>
__global__ void __launch_bounds__(kThreads) gconv_kernel(const T* __restrict__ x,
                                                        const T* __restrict__ wvec,
                                                        T* __restrict__ out, Geo G) {
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
      v = to_f(x[((static_cast<size_t>(bi) * G.h + hh) * G.w + ww) * G.c + c0 + ch]);
    xs[i] = v;
  }
  for (int i = threadIdx.x; i < 9 * GW * kCC; i += kThreads)
    wsm[i] = to_f(wvec[static_cast<size_t>(i / kCC) * G.c + c0 + i % kCC]);
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
        out[((static_cast<size_t>(bi) * G.h + hh) * G.w + ww) * G.c + c0 + oc] =
            from_f<T>(acc[p]);
    }
  }
}

template <typename T, int GW>
cudaError_t launch(const void* x, const void* wvec, void* out, const Geo& G, cudaStream_t s) {
  const size_t bytes = smem_floats(G.ws, GW) * sizeof(float);
  const cudaError_t e = nkbx::allow_smem(gconv_kernel<T, GW>, bytes);
  if (e != cudaSuccess) return e;
  gconv_kernel<T, GW><<<G.b * G.bands * G.chunks, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wvec), static_cast<T*>(out), G);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* wvec, void* out, const Geo& G, int gw,
                     cudaStream_t s) {
  switch (gw) {
    case 1: return launch<T, 1>(x, wvec, out, G, s);
    case 2: return launch<T, 2>(x, wvec, out, G, s);
    case 4: return launch<T, 4>(x, wvec, out, G, s);
    case 8: return launch<T, 8>(x, wvec, out, G, s);
    case 16: return launch<T, 16>(x, wvec, out, G, s);
    case 32: return launch<T, 32>(x, wvec, out, G, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory of one block, in bytes, for an image width w and group
// width gw (the wrapper refuses what no block can hold).
extern "C" int nkbx_gconv_smem_bytes(int w, int gw) {
  const size_t bytes = smem_floats((w + kP - 1) / kP * kP + 2, gw) * sizeof(float);
  return bytes > 0x7fffffff ? 0x7fffffff : static_cast<int>(bytes);
}

// x, out (b, h, w, c) NHWC and wvec (9*gw, c) in float (is_bf16 = 0) or
// bf16; gw a power of two up to 32, c a multiple of 32. Returns the CUDA
// error code of the launch.
extern "C" int nkbx_gconv(const void* x, const void* wvec, void* out, int b, int h, int w, int c,
                          int gw, int is_bf16, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || c % kCC || gw <= 0 || gw > kCC || (gw & (gw - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Geo G;
  G.b = b; G.h = h; G.w = w; G.c = c;
  G.wp = (w + kP - 1) / kP * kP;
  G.ws = G.wp + 2;
  G.bands = (h + kTH - 1) / kTH;
  G.chunks = c / kCC;
  if (static_cast<long long>(b) * G.bands * G.chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch<bf16>(x, wvec, out, G, gw, s)
                                  : dispatch<float>(x, wvec, out, G, gw, s));
}
