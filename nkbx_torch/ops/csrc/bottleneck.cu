// The fused ResNet bottleneck chain, forward (K9): one stride-1 identity
// bottleneck block, conv1x1 + BN + relu -> conv3x3 + BN + relu -> conv1x1 +
// BN -> + x -> relu, with tile-local BatchNorm statistics.
//
// Replaces nkbx/ops/bottleneck.py:177 `_fwd_kernel` (its pallas_call at :356,
// via `_chain_fwd` :339). C entry `nkbx_chain_fwd`.
//
// Semantics (nkbx's labelled opt-in, ResNet(ghost_bn=g, fused_bottleneck=
// True)): each BatchNorm statistics group is one tile of g ghost-batch
// samples x th image rows x the full width, th from nkbx's rule
// (`stat_band` in nkbx_torch/ops/bottleneck.py). Per tile, at the rounding
// points of `_recompute` and `_fwd_kernel`:
//   u1 = x_ext w1 (f32) over the th + 2 ext rows (one halo row above and
//   below, zero off the image); BN1 statistics over the th core rows only;
//   a1 = round(relu(BN1(u1))) on every ext row with this tile's statistics,
//   zero on the halo rows off the image; u2 = 3x3 conv of a1 (f32, zero
//   padding in W) on the core rows; a2 = round(relu(BN2(u2))); u3 = a2 w3;
//   out = relu(round(round(BN3(u3)) + x)). Statistics: mean and E[u^2] -
//   mean^2 clamped at 0, f32, written per tile (m1, v1, m2, v2, m3, v3) for
//   the running statistics.
//
// What bounds it on an H100: at ResNet-50's stages (bf16, batch 64) the
// bytes of x in (the halo rows read again) and out, at 3.35 TB/s, at
// stages 1-2; the operations at stage 3, where th = 2 doubles conv1's rows
// (chip_smoke.py reckons each). The TPU kernel keeps a whole tile in VMEM;
// one tile does not fit an SM (stage 1: u1 of 1,120 ext rows x 64 f32 is
// 287 KB; stage 2: w2 alone is 295 KB), and blocks run in no order. So this
// first design is a sequence of kernels in one call (bottleneck.cuh): the
// u1 product over every image row once (u1 does not depend on the tile),
// the per-tile BN1 statistics, a1 over the ext rows, the 3x3 conv as nine
// gathered products, BN2 statistics, a2, the u3 product, BN3 statistics,
// then the output. u1, a1, u2, a2 and u3 go through device memory, about
// 16x the bytes of x and out at stage 1: the price of a simple first
// kernel, to be won back by later designs that keep a tile on chip
// (clusters, wgmma, TMA).
//
// The route in bf16 with C and M multiples of 32, `nkbx_chain_fwd_gemm`
// (bottleneck_tc.cuh): the products as GEMMs on gemm_tc.cuh's tensor-core
// engine (u2 one GEMM with K = 9 M through a row map), the statistics from
// their epilogues, a1 and a2 by 16-byte vector passes, and a2 w3 twice (its
// statistics, then the output in the epilogue) instead of u3 in f32. The
// first design above stays for f32 and other widths, and reachable in bf16
// through `nkbx_chain_fwd`.

#include "bottleneck_tc.cuh"

namespace {

using namespace chain;

// out = relu(round(round(BN3(u3)) + x)).
template <typename T>
__global__ void output_kernel(const float* u3, Bn bn3, const T* x, T* out, Geo G, float eps) {
  const size_t total = static_cast<size_t>(G.rows) * G.c;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x)
    out[idx] = from_f<T>(fmaxf(residual_sum(u3, bn3, x, G, G.c, idx, eps), 0.f));
}

template <typename T>
cudaError_t run(const Chain& ch, void* out, const Geo& G, float eps, cudaStream_t s) {
  forward_to_u3<T>(ch, G, eps, s);
  output_kernel<T><<<grid_for(static_cast<size_t>(G.rows) * G.c), 256, 0, s>>>(
      ch.u3, ch.bn3, static_cast<const T*>(ch.x), static_cast<T*>(out), G, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out (B, H, W, C); w1 (C, M), w2 (3, 3, M, M), w3 (M, C) in float
// (is_bf16 = 0) or bf16; s1, b1, s2, b2 (M), s3, b3 (C) float; the per-tile
// statistics m1, v1, m2, v2 (nt, M), m3, v3 (nt, C) float, nt = B/g * H/th;
// scratch u1 (B*H*W, M) float, a1 (nt*g*(th+2)*W, M) in the storage type,
// u2 (B*H*W, M) float, a2 (B*H*W, M) storage, u3 (B*H*W, C) float. C and M
// are multiples of 8. Returns the CUDA error code of the launches.
extern "C" int nkbx_chain_fwd(const void* x, const void* w1, const void* w2, const void* w3,
                              const void* s1, const void* b1, const void* s2, const void* b2,
                              const void* s3, const void* b3, void* out, void* m1, void* v1,
                              void* m2, void* v2, void* m3, void* v3, void* u1, void* a1,
                              void* u2, void* a2, void* u3, int b, int h, int w, int c, int m,
                              int g, int th, float eps, int is_bf16, void* stream) {
  if (c % 8 || m % 8 || g <= 0 || b % g || th <= 0 || h % th)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo G = make_geo(b, h, w, c, m, g, th);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const Chain ch{x, w1, w2, w3,
                 Bn{f(m1), f(v1), f(s1), f(b1)}, Bn{f(m2), f(v2), f(s2), f(b2)},
                 Bn{f(m3), f(v3), f(s3), f(b3)},
                 static_cast<float*>(u1), a1, static_cast<float*>(u2), a2,
                 static_cast<float*>(u3)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? run<bf16>(ch, out, G, eps, s)
                                  : run<float>(ch, out, G, eps, s));
}

// K9 on the tensor-core route: bf16 x, out (B, H, W, C); w1 (C, M), w2 (3,
// 3, M, M), w3 (M, C) in bf16 with C and M multiples of 32, every pointer
// 16-byte aligned; the BN vectors and the per-tile statistics as for
// nkbx_chain_fwd. Scratch: u1, u2 (B*H*W, M) float, a1 (nt*g*(th+2)*W, M)
// and a2 (B*H*W, M) bf16, part float (the runs' partial sums), rstd
// (nt, 2 M + C) float (the three BNs' rsqrt(var + eps);
// `chain_scratch` in nkbx_torch/ops/bottleneck.py sizes every buffer). Returns the CUDA
// error code of the launches.
extern "C" int nkbx_chain_fwd_gemm(const void* x, const void* w1, const void* w2, const void* w3,
                                   const void* s1, const void* b1, const void* s2,
                                   const void* b2, const void* s3, const void* b3, void* out,
                                   void* m1, void* v1, void* m2, void* v2, void* m3, void* v3,
                                   void* u1, void* a1, void* u2, void* a2, void* part,
                                   void* rstd, int b, int h, int w, int c, int m, int g, int th,
                                   float eps, void* stream) {
  if (c % 32 || m % 32 || g <= 0 || b % g || th <= 0 || h % th)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo G = make_geo(b, h, w, c, m, g, th);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h16 = [](const void* p) { return static_cast<const bf16*>(p); };
  const tc::Chain ch{h16(x), h16(w1), h16(w2), h16(w3),
                     Bn{f(m1), f(v1), f(s1), f(b1)}, Bn{f(m2), f(v2), f(s2), f(b2)},
                     Bn{f(m3), f(v3), f(s3), f(b3)}, static_cast<float*>(rstd),
                     static_cast<float*>(u1), static_cast<bf16*>(a1), static_cast<float*>(u2),
                     static_cast<bf16*>(a2), static_cast<float*>(part)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = tc::forward_to_a2(ch, G, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // out = relu(round(round(BN3(a2 w3)) + x)) in the epilogue of a2 w3
  return static_cast<int>(tc::product<false>(
      tc::ConvArgs{ch.a2, ch.w3, G.rows, G.c, G.m, 1, 0, G}, tc::FlatRows{},
      tc::OutEpi{tc::norm(ch, G, 3), ch.x, static_cast<bf16*>(out), G}, s));
}
