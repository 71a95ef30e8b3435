// The fused ResNet bottleneck chain, backward (K10).
//
// Replaces nkbx/ops/bottleneck.py:222 `_bwd_kernel` (its pallas_call at
// :387, via `_chain_bwd_raw` :375). C entry `nkbx_chain_bwd`.
//
// Given x, the block's parameters and dout it recomputes the forward per tile
// (the same kernels as K9, bottleneck.cuh) and runs the chain backward in
// the order of `_bwd_kernel`:
//   dy = dout where round(round(BN3(u3)) + x) > 0 (the forward's relu mask
//   from the same rounded sum); BN3 backward over each tile's core rows:
//   du3 = rstd3 * (s3*dy - (S1 + xhat3*S2)/n), S1 = sum s3*dy, S2 = sum
//   s3*dy*xhat3, rounded; dw3 = a2^T du3; da2 = du3 w3^T; BN2 backward
//   through the relu gate of z2, du2 rounded; dw2[tap] = a1(tap)^T du2 (nine
//   products over shifted ext rows); da1 = the full correlation of du2 with
//   the flipped, transposed w2 over the th + 2 ext rows; BN1 backward through
//   the relu gate of z1 and the image-edge halo rows, whose sums S1, S2, ds1
//   and db1 run over every ext row while the correction applies to the core
//   rows only; du1 rounded; dw1 = x_ext^T du1; dx = round(round(du1_core
//   w1^T) + dy). The halo rows' du1 stay in the du1 buffer: the wrapper folds
//   them into dx of the neighbouring bands (nkbx does it outside its kernel).
//   dw1, dw2, dw3 and the six BN vector gradients are f32 sums over tiles
//   and slabs of rows in a fixed order, so two runs agree bit for bit.
//
// What bounds it on an H100: the operations (the recompute and five
// backward products, about 3x the forward's) at stage 3 and the bytes at
// stages 1-2, as for K9; the intermediates that go through device memory
// (u1..u3, a1, a2, dy, du1..du3, da1, da2) are again the price of a simple
// first design.
//
// The route in bf16 with C and M multiples of 32, `nkbx_chain_bwd_gemm`
// (bottleneck_tc.cuh): the recompute as K9's route; a2 w3 twice more, its
// epilogues giving dy with BN3's sums, then du3; da2 = du3 w3^T with the
// gate, dz2 in float and BN2's sums in its epilogue; du2 by a vector pass;
// da1 as one GEMM over the ext rows (K = 9 M, w2 flipped and transposed per
// tap) with dz1 and BN1's sums in its epilogue; du1 by a vector pass; dx
// with the residual in its epilogue; dw3, dw2 and dw1 as GEMMs over slabs of
// rows (the row maps along K from a table), their partials added in order.
// u3, da2 and da1 are never stored unrounded: dz2 and dz1 are the gated
// products BN2's and BN1's backward need. The first design above stays for
// f32 and other widths, and reachable in bf16 through `nkbx_chain_bwd`.

#include "bottleneck_tc.cuh"

namespace {

using namespace chain;

enum Layout { kCore = 0, kExt = 1 };

// dy = dout where the forward's residual sum is positive, else 0.
template <typename T>
__global__ void dy_kernel(const float* u3, Bn bn3, const T* x, const T* dout, T* dy, Geo G,
                          float eps) {
  const size_t total = static_cast<size_t>(G.rows) * G.c;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x)
    dy[idx] = residual_sum(u3, bn3, x, G, G.c, idx, eps) > 0.f ? dout[idx] : from_f<T>(0.f);
}

// One row of a BN backward: the gated cotangent dz and xhat, rstd of the
// row's tile. kCore rows are global rows (u at the same row); kExt rows are
// ext rows (u1 at the global row they read; halo rows off the image have no
// row and no gradient).
template <typename Tz, int LAYOUT, bool GATE>
__device__ __forceinline__ float bn_row(const Tz* dz, const float* u, const Bn& bn,
                                        const Geo& G, int cn, int t, int row, int ch, float eps,
                                        float* xhat, float* rstd) {
  int ur = row;
  if (LAYOUT == kExt) ur = src_row<kE2GImage>(G, row, 1, 1);
  const float uv = ur >= 0 ? u[static_cast<size_t>(ur) * cn + ch] : 0.f;
  const float z = bn_z(bn, t, cn, ch, uv, eps, xhat, rstd);
  float d = to_f(dz[static_cast<size_t>(row) * cn + ch]);
  if (GATE && !(z > 0.f && ur >= 0)) d = 0.f;
  return d;
}

// Per tile and channel, over all the tile's rows (core rows, or ext rows):
// sums[0] = S1 = sum s*dz, sums[1] = S2 = sum s*dz*xhat, sums[2] = sum
// dz*xhat, sums[3] = sum dz; each (nt, cn). Lanes sum rows in order, then
// lane 0 adds the lanes in order.
template <typename Tz, int LAYOUT, bool GATE>
__global__ void bn_bwd_sums(const Tz* dz, const float* u, Bn bn, float* sums, Geo G, int cn,
                            float eps) {
  __shared__ float red[4][kSL][kSC];
  const int ch = blockIdx.y * kSC + threadIdx.x, t = blockIdx.x, lane = threadIdx.y;
  const int n = LAYOUT == kExt ? G.g * G.the * G.w : G.g * G.th * G.w;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (ch < cn) {
    const float s = bn.scale[ch];
    for (int r = lane; r < n; r += kSL) {
      const int row = LAYOUT == kExt ? t * n + r : core_row(G, t, r);
      float xhat, rstd;
      const float d = bn_row<Tz, LAYOUT, GATE>(dz, u, bn, G, cn, t, row, ch, eps, &xhat, &rstd);
      acc[0] += d * s;
      acc[1] += d * s * xhat;
      acc[2] += d * xhat;
      acc[3] += d;
    }
  }
  for (int k = 0; k < 4; ++k) red[k][lane][threadIdx.x] = acc[k];
  __syncthreads();
  if (lane == 0 && ch < cn)
    for (int k = 0; k < 4; ++k) {
      float v = acc[k];
      for (int l = 1; l < kSL; ++l) v += red[k][l][threadIdx.x];
      sums[(static_cast<size_t>(k) * G.nt + t) * cn + ch] = v;
    }
}

// du = rstd * (s*dz - [core] * (S1 + xhat*S2) / n), n = g*th*W, rounded to T.
template <typename T, typename Tz, int LAYOUT, bool GATE>
__global__ void bn_bwd_apply(const Tz* dz, const float* u, Bn bn, const float* sums, T* du,
                             Geo G, int cn, float eps) {
  const int rows = LAYOUT == kExt ? G.ext_rows : G.rows;
  const int per_tile = G.g * G.the * G.w;
  const float inv_n = 1.f / static_cast<float>(G.g * G.th * G.w);
  const size_t total = static_cast<size_t>(rows) * cn;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(idx / cn), ch = static_cast<int>(idx % cn);
    const int t = LAYOUT == kExt ? row / per_tile : tile_of_global(G, row);
    float xhat, rstd;
    const float d = bn_row<Tz, LAYOUT, GATE>(dz, u, bn, G, cn, t, row, ch, eps, &xhat, &rstd);
    const size_t o = static_cast<size_t>(t) * cn + ch;
    float corr = (sums[o] + xhat * sums[static_cast<size_t>(G.nt) * cn + o]) * inv_n;
    if (LAYOUT == kExt) {
      const int he = (row / G.w) % G.the;
      if (he < 1 || he > G.th) corr = 0.f;
    }
    du[idx] = from_f<T>(rstd * (d * bn.scale[ch] - corr));
  }
}

template <typename T, typename Tz, int LAYOUT, bool GATE>
void bn_backward(const Tz* dz, const float* u, const Bn& bn, float* sums, T* du, float* ds,
                 float* db, const Geo& G, int cn, float eps, cudaStream_t s) {
  bn_bwd_sums<Tz, LAYOUT, GATE><<<dim3(G.nt, (cn + kSC - 1) / kSC), dim3(kSC, kSL), 0, s>>>(
      dz, u, bn, sums, G, cn, eps);
  const size_t rows = LAYOUT == kExt ? G.ext_rows : G.rows;
  bn_bwd_apply<T, Tz, LAYOUT, GATE><<<grid_for(rows * cn), 256, 0, s>>>(dz, u, bn, sums, du, G,
                                                                       cn, eps);
  const size_t plane = static_cast<size_t>(G.nt) * cn;
  sum_parts<<<(cn + 255) / 256, 256, 0, s>>>(sums + 2 * plane, ds, G.nt, cn);
  sum_parts<<<(cn + 255) / 256, 256, 0, s>>>(sums + 3 * plane, db, G.nt, cn);
}

struct Grads {
  const void* dout;
  void* dx;
  float *dw1, *dw2, *dw3, *ds1, *db1, *ds2, *db2, *ds3, *db3;
  void *dy, *du3;  // (rows, c) T
  float* da2;      // (rows, m)
  void* du2;       // (rows, m) T
  float* da1;      // (ext_rows, m)
  void* du1;       // (ext_rows, m) T: the halo rows are read by the wrapper
  float *sums, *part;
  int slab3, slab2, slab1;
};

template <typename T>
cudaError_t run(const Chain& ch, const Grads& gr, const Geo& G, float eps, cudaStream_t s) {
  forward_to_u3<T>(ch, G, eps, s);
  T* dy = static_cast<T*>(gr.dy);
  T* du3 = static_cast<T*>(gr.du3);
  T* du2 = static_cast<T*>(gr.du2);
  T* du1 = static_cast<T*>(gr.du1);
  dy_kernel<T><<<grid_for(static_cast<size_t>(G.rows) * G.c), 256, 0, s>>>(
      ch.u3, ch.bn3, static_cast<const T*>(ch.x), static_cast<const T*>(gr.dout), dy, G, eps);
  // BN3 (no gate: dy already carries the output relu's mask)
  bn_backward<T, T, kCore, false>(dy, ch.u3, ch.bn3, gr.sums, du3, gr.ds3, gr.db3, G, G.c, eps,
                                  s);
  wgrad<T, kFlat>(WgradArgs{ch.a2, du3, gr.part, G.rows, G.m, G.c, 1, gr.slab3, G}, gr.dw3, s);
  GemmArgs p{};
  p.G = G;
  // da2 = du3 w3^T: w3 (M, C) is B^T of (K = C, N = M)
  p.a = du3; p.b = ch.w3; p.out = gr.da2; p.rows = G.rows; p.k = G.c; p.n = G.m; p.taps = 1;
  gemm<T, kFlat, true, kStoreF32>(p, s);
  bn_backward<T, float, kCore, true>(gr.da2, ch.u2, ch.bn2, gr.sums, du2, gr.ds2, gr.db2, G, G.m,
                                     eps, s);
  wgrad<T, kG2E>(WgradArgs{ch.a1, du2, gr.part, G.rows, G.m, G.m, 9, gr.slab2, G}, gr.dw2, s);
  // da1 over the ext rows: taps of du2 in the tile's core, w2 flipped and transposed
  p.a = du2; p.b = ch.w2; p.out = gr.da1; p.rows = G.ext_rows; p.k = G.m; p.n = G.m; p.taps = 9;
  p.flip = 1;
  gemm<T, kE2GTile, true, kStoreF32>(p, s);
  bn_backward<T, float, kExt, true>(gr.da1, ch.u1, ch.bn1, gr.sums, du1, gr.ds1, gr.db1, G, G.m,
                                    eps, s);
  wgrad<T, kE2GImage>(WgradArgs{ch.x, du1, gr.part, G.ext_rows, G.c, G.m, 1, gr.slab1, G},
                      gr.dw1, s);
  // dx core rows = round(round(du1_core w1^T) + dy): w1 (C, M) is B^T of (K = M, N = C)
  p.a = du1; p.b = ch.w1; p.out = gr.dx; p.resid = dy; p.rows = G.rows; p.k = G.m; p.n = G.c;
  p.taps = 1; p.flip = 0;
  gemm<T, kG2E, true, kResid>(p, s);
  return cudaGetLastError();
}

}  // namespace

// x, dout, dx (B, H, W, C); w1 (C, M), w2 (3, 3, M, M), w3 (M, C) in float
// (is_bf16 = 0) or bf16; s1, b1, s2, b2 (M), s3, b3 (C) float. Outputs: dx
// (before the halo fold), dw1 (C, M), dw2 (3, 3, M, M), dw3 (M, C), ds1,
// db1, ds2, db2 (M), ds3, db3 (C) float, and du1 (nt*g*(th+2)*W, M) in the
// storage type, whose halo rows the wrapper folds into dx. Scratch: the
// per-tile statistics m1..v3 and u1, a1, u2, a2, u3 as for nkbx_chain_fwd;
// dy, du3 (B*H*W, C) storage; da2 (B*H*W, M) float; du2 (B*H*W, M) storage;
// da1 (nt*g*(th+2)*W, M) float; sums (4, nt, max(C, M)) float; part, the
// weight-gradient partials, (slabs, taps, k, n) float for the largest of the
// three with slab3, slab2 and slab1 rows a slab (dw3, dw2, dw1). Returns
// the CUDA error code of the launches.
extern "C" int nkbx_chain_bwd(const void* x, const void* w1, const void* w2, const void* w3,
                              const void* s1, const void* b1, const void* s2, const void* b2,
                              const void* s3, const void* b3, const void* dout, void* dx,
                              void* dw1, void* dw2, void* dw3, void* ds1, void* db1, void* ds2,
                              void* db2, void* ds3, void* db3, void* m1, void* v1, void* m2,
                              void* v2, void* m3, void* v3, void* u1, void* a1, void* u2,
                              void* a2, void* u3, void* dy, void* du3, void* da2, void* du2,
                              void* da1, void* du1, void* sums, void* part, int b, int h, int w,
                              int c, int m, int g, int th, int slab3, int slab2, int slab1,
                              float eps, int is_bf16, void* stream) {
  if (c % 8 || m % 8 || g <= 0 || b % g || th <= 0 || h % th || slab1 <= 0 || slab2 <= 0 ||
      slab3 <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo G = make_geo(b, h, w, c, m, g, th);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fw = [](void* p) { return static_cast<float*>(p); };
  const Chain ch{x, w1, w2, w3,
                 Bn{f(m1), f(v1), f(s1), f(b1)}, Bn{f(m2), f(v2), f(s2), f(b2)},
                 Bn{f(m3), f(v3), f(s3), f(b3)},
                 fw(u1), a1, fw(u2), a2, fw(u3)};
  const Grads gr{dout, dx, fw(dw1), fw(dw2), fw(dw3), fw(ds1), fw(db1), fw(ds2), fw(db2),
                 fw(ds3), fw(db3), dy, du3, fw(da2), du2, fw(da1), du1, fw(sums), fw(part),
                 slab3, slab2, slab1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? run<bf16>(ch, gr, G, eps, s)
                                  : run<float>(ch, gr, G, eps, s));
}

// K10 on the tensor-core route. Inputs and outputs as nkbx_chain_bwd's, in
// bf16 with C and M multiples of 32, every pointer 16-byte aligned; du1
// (nt*g*(th+2)*W, M) bf16 is again an output. Scratch: the per-tile
// statistics m1..v3, u1, a1, u2, a2 as for nkbx_chain_fwd_gemm; dy (B*H*W, C) bf16; du3, the larger of (B*H*W, C)
// bf16 and (nt*g*(th+2)*W, M) float (it later holds dz1); dz2 (B*H*W, M)
// float; du2 (B*H*W, M) bf16; sums (2, nt, max(C, M)) float; part, the
// runs' partial sums, float; wpart (the weight gradients' slab partials)
// float; maps (B*H*W + nt*g*(th+2)*W) int; rstd (nt, 2 M + C) float. slab3,
// slab2 and slab1 are the rows of a slab of dw3, dw2 and dw1 (multiples of
// 32); `chain_scratch` in nkbx_torch/ops/bottleneck.py sizes every buffer.
// Returns the CUDA error code of the launches.
extern "C" int nkbx_chain_bwd_gemm(const void* x, const void* w1, const void* w2, const void* w3,
                                   const void* s1, const void* b1, const void* s2,
                                   const void* b2, const void* s3, const void* b3,
                                   const void* dout, void* dx, void* dw1, void* dw2, void* dw3,
                                   void* ds1, void* db1, void* ds2, void* db2, void* ds3,
                                   void* db3, void* m1, void* v1, void* m2, void* v2, void* m3,
                                   void* v3, void* u1, void* a1, void* u2, void* a2, void* dy,
                                   void* du3, void* dz2, void* du2, void* du1,
                                   void* sums, void* part, void* wpart, void* maps, void* rstd,
                                   int b, int h, int w, int c, int m, int g, int th, int slab3,
                                   int slab2, int slab1, float eps, void* stream) {
  if (c % 32 || m % 32 || g <= 0 || b % g || th <= 0 || h % th || slab1 <= 0 || slab1 % 32 ||
      slab2 <= 0 || slab2 % 32 || slab3 <= 0 || slab3 % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo G = make_geo(b, h, w, c, m, g, th);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto fw = [](void* p) { return static_cast<float*>(p); };
  auto h16 = [](const void* p) { return static_cast<const bf16*>(p); };
  auto hw = [](void* p) { return static_cast<bf16*>(p); };
  const tc::Chain ch{h16(x), h16(w1), h16(w2), h16(w3),
                     Bn{f(m1), f(v1), f(s1), f(b1)}, Bn{f(m2), f(v2), f(s2), f(b2)},
                     Bn{f(m3), f(v3), f(s3), f(b3)}, fw(rstd),
                     fw(u1), hw(a1), fw(u2), hw(a2), fw(part)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* g2e = static_cast<int*>(maps);
  int* e2g = g2e + G.rows;
  float* bsum = fw(sums);
  // dz1 in du3's buffer: du3 is read for the last time by da2 = du3 w3^T, which
  // runs before da1's epilogue writes dz1
  void* dz1 = du3;
  cudaError_t err;
  auto ok = [&](cudaError_t e) { return (err = e) == cudaSuccess; };
  auto launched = [&]() { return ok(cudaGetLastError()); };
  // a BN backward's per-tile sums from its runs' pieces, then ds and db
  auto bn_sums = [&](const tc::Runs& R, int ext, void* ds, void* db) {
    tc::bn_finish<<<tc::finish_grid(R.n, G.nt), 128, 0, s>>>(R, G, ext, bsum);
    if (!launched()) return false;
    tc::tile_colsum<<<dim3((R.n + kSC - 1) / kSC, 1, 2), dim3(kSC, kSL), 0, s>>>(
        bsum, fw(db), fw(ds), G.nt, R.n);
    return launched();
  };
  const int total = G.rows + G.ext_rows;
  tc::maps_kernel<<<(total + 255) / 256, 256, 0, s>>>(G, g2e, e2g);
  if (!launched() || !ok(tc::forward_to_a2(ch, G, eps, s))) return static_cast<int>(err);
  const tc::Runs Rc = tc::global_runs(G, fw(part), G.c), Rm = tc::global_runs(G, fw(part), G.m);
  const tc::Runs Re = tc::ext_runs(G, fw(part), G.m);
  const tc::ConvArgs u3{ch.a2, ch.w3, G.rows, G.c, G.m, 1, 0, G};
  // BN3: dy and its sums, then du3 (a2 w3 again in each epilogue)
  if (!ok(tc::product<false>(u3, tc::FlatRows{},
                             tc::DyEpi{tc::norm(ch, G, 3), ch.x, h16(dout), hw(dy), Rc, G}, s)) ||
      !bn_sums(Rc, 0, ds3, db3) ||
      !ok(tc::product<false>(u3, tc::FlatRows{}, tc::Du3Epi{tc::norm(ch, G, 3), bsum, h16(dy), hw(du3), G},
                             s)))
    return static_cast<int>(err);
  // dw3 = a2^T du3, as (du3^T a2)^T: the longer side on the 128-row tiles
  if (!ok(tc::weight_grad<tc::kKFlat>(
          tc::WgradArgs{h16(du3), h16(a2), fw(wpart), nullptr, G.rows, slab3, G.c, G.m, G.c, 1,
                        G},
          fw(dw3), 1, s)))
    return static_cast<int>(err);
  // BN2: dz2 = da2 = du3 w3^T where z2 > 0, and its sums; du2
  if (!ok(tc::product<true>(tc::ConvArgs{h16(du3), ch.w3, G.rows, G.m, G.c, 1, 0, G},
                            tc::FlatRows{}, tc::DzEpi<false>{tc::norm(ch, G, 2), ch.u2, nullptr, fw(dz2), Rm, G},
                            s)) ||
      !bn_sums(Rm, 0, ds2, db2))
    return static_cast<int>(err);
  tc::du_pass<false><<<grid_for(static_cast<size_t>(G.rows) * G.m / 8), 256, 0, s>>>(
      fw(dz2), ch.u2, tc::norm(ch, G, 2), bsum, hw(du2), G, G.m);
  if (!launched()) return static_cast<int>(err);
  // dw2[tap] = a1(tap)^T du2: the taps' rows of dw2 (9 M, M) in one product
  if (!ok(tc::weight_grad<tc::kKG2E>(
          tc::WgradArgs{ch.a1, h16(du2), fw(wpart), g2e, G.rows, slab2, 9 * G.m, G.m, G.m, 9, G},
          fw(dw2), 0, s)))
    return static_cast<int>(err);
  // BN1: dz1 = da1 where z1 > 0 over the ext rows (du2's taps in the tile's
  // core, w2 flipped and transposed), and its sums over every ext row; du1
  if (!ok(tc::product<true>(tc::ConvArgs{h16(du2), ch.w2, G.ext_rows, G.m, G.m, 9, 1, G},
                            tc::E2GTileRows{},
                            tc::DzEpi<true>{tc::norm(ch, G, 1), ch.u1, e2g, fw(dz1), Re, G}, s)) ||
      !bn_sums(Re, 1, ds1, db1))
    return static_cast<int>(err);
  tc::du_pass<true><<<grid_for(static_cast<size_t>(G.ext_rows) * G.m / 8), 256, 0, s>>>(
      fw(dz1), ch.u1, tc::norm(ch, G, 1), bsum, hw(du1), G, G.m);
  if (!launched()) return static_cast<int>(err);
  // dw1 = x_ext^T du1 over the ext rows
  if (!ok(tc::weight_grad<tc::kKE2G>(
          tc::WgradArgs{ch.x, h16(du1), fw(wpart), e2g, G.ext_rows, slab1, G.c, G.m, G.c, 1, G},
          fw(dw1), 0, s)))
    return static_cast<int>(err);
  // dx core rows = round(round(du1_core w1^T) + dy): w1 (C, M) stored (N, K)
  return static_cast<int>(tc::product<true>(
      tc::ConvArgs{h16(du1), ch.w1, G.rows, G.c, G.m, 1, 0, G}, tc::G2ERows{},
      tc::DxEpi{h16(dy), hw(dx), G.rows, G.c}, s));
}
