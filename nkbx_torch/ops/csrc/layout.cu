// The Swin layout probes (X3-X7): copies and permutations of bf16 or f32
// tensors, moved as raw bits.
//
// Replaces:
//   X3  experiments/r3_layout_tax.py:52 `_stream_kernel` (pallas_call :70):
//       the identity copy of (G, N, C)                       -> nkbx_layout_copy
//   X4  r3_layout_tax.py:56 `_transpose_kernel` (pallas_call :84): a G-minor
//       (N, C, G) input to (G, N, C), the transpose of an (N*C) x G matrix
//                                                             -> nkbx_layout_transpose
//   X5  experiments/r3_map_attention_probe.py:44 `gather_kernel` (pallas_call
//       :97, :68): a (7, 7K, C3) stripe to its K (49, C3) windows,
//       out[t, 7r + c] = in[r, 7t + c]                        -> nkbx_layout_rows, mode 0
//   X6  r3_map_attention_probe.py:52 `scatter_kernel` (:105, :68): the
//       inverse, (K, 49, C3) windows to the (7, 7K, C3) stripe -> nkbx_layout_rows, mode 1
//   X7  experiments/r3_map_attention_probe2.py (pallas_call :64): A-C merge
//       (7, 7, C3) to (49, C3) and D splits it back, which on a row-major
//       card are the identity on the bytes               -> nkbx_layout_copy;
//       E scatters row r of each window row into rows 8r..8r+6 of a
//       zero-filled (56, C3)                                  -> nkbx_layout_rows, mode 2
//
// The TPU kernels move (w, N, C) blocks through VMEM on a sequential grid
// (`_pick_w`, 512 grid steps); those block sizes are VMEM tiling and do not
// carry over. What bounds every kernel here on an H100 is the bytes: each
// input byte read once and each output byte written once at 3.35 TB/s (X3
// and X4 at swin_tiny's stage 1, batch 64, bf16: 115.6 MB each way, 0.069
// ms). No arithmetic is done. So the design is only about memory
// transactions:
//   - copy: by its size. From 32 MiB up, with pointers and a byte count
//     that are multiples of 16 (every tensor PyTorch allocates), a TMA
//     bulk-copy ring: one block of one issuing thread an SM, 16 KB chunks
//     (block b takes chunks b, b + grid, ...), each loaded by cp.async.bulk
//     onto an mbarrier and stored by cp.async.bulk from the same stage of
//     shared memory, the stores draining while the loads of the other
//     stages are in flight. No thread moves a byte. The ring's depth
//     follows the copy: half of a block's chunks, 8 to 13 stages (a deeper
//     ring keeps more bytes in flight on a long copy, but its shared memory
//     costs set-up time that a short one does not earn back). Below 32 MiB
//     (Swin-T's stages 3-4 and X7's blocks: 28.9 and 14.5 MB), where that
//     set-up is a visible share, and for a misaligned view or an odd byte
//     count, a grid of 512-thread blocks moves the widest vector (16, 8, 4,
//     2 or 1 bytes) that the pointers and the length allow, 2 loads in
//     flight a thread (in scratch runs on the H100, 1-2 vectors a thread
//     came closest to clone there; 4 or 8, and persistent grids, were
//     slower).
//   - rows moves the widest vector (16, 8, 4, 2 or 1 bytes) that the
//     pointers and the row width allow, in a grid-stride loop in which a
//     warp reads and writes whole consecutive rows (a 576-byte bf16 row of
//     C3 = 288 is 36 16-byte vectors).
//   - transpose: a tile in shared memory, read along G and written along
//     N*C, so both sides are coalesced. A bf16 tile is 64 x 64 and each
//     lane moves one 32-bit word (two bf16) on both sides, as a naive 2-byte
//     tile would halve the bandwidth; the tile's row stride of 65 elements
//     keeps the column reads free of bank conflicts. f32 takes 32 x 32.
//   - pad8 writes its zero rows itself: no memset, no second launch.
// Every kernel writes a fresh output; none returns its input.

#include <cuda_runtime.h>

#include <cstdint>

#include "dtype.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 resident 256-thread blocks on each of 132 SMs
constexpr int kCopyThreads = 512, kCopyUnroll = 2;  // the vector copy
constexpr int kChunk = 16384;                      // bytes of one bulk copy
constexpr int kMinStages = 8, kMaxStages = 13;     // the ring's depth (13 x 16 KB = 208 KB)
constexpr long long kBulkMin = 32ll << 20;         // bytes from which a copy takes the ring

int grid_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

// The widest vector of 16, 8, 4, 2 or 1 bytes that divides every value.
int vec_bytes(uintptr_t a, uintptr_t b, long long c) {
  const uintptr_t all = a | b | static_cast<uintptr_t>(c);
  for (int v = 16; v > 1; v >>= 1)
    if (all % v == 0) return v;
  return 1;
}

// ------------------------------------------------------------------ copy (X3, X7 A-D)

// The ring: thread 0 of block b copies chunks b, b + gridDim.x, ... (local
// index i) through stage i % stages: the first `stages` loads at once, then
// for each chunk its store, and the refill of the stage whose store went
// out one chunk earlier once that store has read it.
__global__ void copy_bulk_kernel(const unsigned char* __restrict__ x,
                                 unsigned char* __restrict__ y, long long nbytes, int stages) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[kMaxStages];
  const long long chunks = (nbytes + kChunk - 1) / kChunk;
  if (threadIdx.x != 0 || blockIdx.x >= chunks) return;
  for (int s = 0; s < stages; ++s) sm90::mbar_init(&full[s], 1);
  sm90::fence_barrier_init();
  const long long mine = (chunks - blockIdx.x + gridDim.x - 1) / gridDim.x;
  auto bytes = [&](long long i) {
    const long long left = nbytes - (blockIdx.x + i * gridDim.x) * kChunk;
    return static_cast<uint32_t>(left < kChunk ? left : kChunk);
  };
  auto load = [&](long long i) {
    uint64_t* bar = &full[i % stages];
    sm90::mbar_expect_tx(bar, bytes(i));
    sm90::bulk_load(ring + (i % stages) * kChunk, x + (blockIdx.x + i * gridDim.x) * kChunk,
                    bytes(i), bar);
  };
  for (long long i = 0; i < mine && i < stages; ++i) load(i);
  for (long long i = 0; i < mine; ++i) {
    sm90::mbar_wait(&full[i % stages], static_cast<uint32_t>(i / stages) & 1);
    sm90::bulk_store(y + (blockIdx.x + i * gridDim.x) * kChunk, ring + (i % stages) * kChunk,
                     bytes(i));
    sm90::bulk_commit();
    if (i >= 1 && i - 1 + stages < mine) {  // store i - 1 has read its stage: refill it
      sm90::bulk_wait_read<1>();
      load(i - 1 + stages);
    }
  }
  sm90::bulk_wait();
}

cudaError_t launch_copy_bulk(const void* x, void* y, long long nbytes, cudaStream_t s) {
  const long long chunks = (nbytes + kChunk - 1) / kChunk;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = nkbx::allow_smem(copy_bulk_kernel, kMaxStages * kChunk);
  if (e != cudaSuccess) return e;
  const long long blocks = chunks < sms ? chunks : sms;
  const long long half = (chunks + 2 * blocks - 1) / (2 * blocks);
  const int stages = static_cast<int>(half < kMinStages ? kMinStages
                                                        : (half > kMaxStages ? kMaxStages : half));
  copy_bulk_kernel<<<static_cast<unsigned>(blocks), 32, static_cast<size_t>(stages) * kChunk, s>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y), nbytes, stages);
  return cudaGetLastError();
}

// The vector copy: a block moves kCopyThreads * kCopyUnroll consecutive
// vectors, each thread kCopyUnroll of them kCopyThreads apart, all its loads
// in flight before its stores.
template <typename V>
__global__ void __launch_bounds__(kCopyThreads) copy_kernel(const V* __restrict__ x,
                                                            V* __restrict__ y, long long n) {
  const long long base =
      static_cast<long long>(blockIdx.x) * (kCopyThreads * kCopyUnroll) + threadIdx.x;
  V v[kCopyUnroll];
#pragma unroll
  for (int u = 0; u < kCopyUnroll; ++u)
    if (base + u * kCopyThreads < n) v[u] = x[base + u * kCopyThreads];
#pragma unroll
  for (int u = 0; u < kCopyUnroll; ++u)
    if (base + u * kCopyThreads < n) y[base + u * kCopyThreads] = v[u];
}

template <typename V>
cudaError_t launch_copy(const void* x, void* y, long long nbytes, cudaStream_t s) {
  const long long n = nbytes / static_cast<long long>(sizeof(V));
  const long long blocks = (n + kCopyThreads * kCopyUnroll - 1) / (kCopyThreads * kCopyUnroll);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  copy_kernel<V><<<static_cast<unsigned>(blocks), kCopyThreads, 0, s>>>(
      static_cast<const V*>(x), static_cast<V*>(y), n);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ rows (X5, X6, X7 E)

enum Mode { kGather = 0, kScatter = 1, kPad8 = 2 };

// The input row that output row i reads, or -1 for a zero row.
//   gather  in (B, win, win*K) rows, out (B, K, win*win):  out[t, win*r + c] = in[r, win*t + c]
//   scatter in (B, K, win*win),  out (B, win, win*K):      out[r, win*t + c] = in[t, win*r + c]
//   pad8    in (B, win*win),     out (B, win*(win+1)):     out[(win+1)*r + c] = in[win*r + c],
//                                                          out[(win+1)*r + win] = 0
__device__ __forceinline__ long long source_row(int mode, long long i, int win, int k) {
  const long long nw = static_cast<long long>(win) * win;
  if (mode == kPad8) {
    const long long per = nw + win, b = i / per, j = i % per;
    const int r = static_cast<int>(j / (win + 1)), c = static_cast<int>(j % (win + 1));
    return c == win ? -1 : b * nw + static_cast<long long>(r) * win + c;
  }
  const long long per = nw * k, b = i / per, j = i % per;
  if (mode == kGather) {  // j = (t, win*r + c)
    const long long t = j / nw, rc = j % nw, r = rc / win, c = rc % win;
    return b * per + r * win * k + win * t + c;
  }
  // scatter: j = (r, win*t + c)
  const long long r = j / (static_cast<long long>(win) * k), tc = j % (static_cast<long long>(win) * k);
  const long long t = tc / win, c = tc % win;
  return b * per + t * nw + win * r + c;
}

template <typename V>
__global__ void rows_kernel(const V* __restrict__ x, V* __restrict__ y, int mode, long long rows,
                            int vpr, int win, int k) {
  const long long n = rows * vpr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long row = i / vpr;
    const int v = static_cast<int>(i - row * vpr);
    const long long src = source_row(mode, row, win, k);
    y[i] = src < 0 ? V{} : x[src * vpr + v];
  }
}

template <typename V>
cudaError_t launch_rows(const void* x, void* y, int mode, long long rows, long long row_bytes,
                        int win, int k, cudaStream_t s) {
  const int vpr = static_cast<int>(row_bytes / static_cast<long long>(sizeof(V)));
  rows_kernel<V><<<grid_for(rows * vpr), kThreads, 0, s>>>(
      static_cast<const V*>(x), static_cast<V*>(y), mode, rows, vpr, win, k);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ transpose (X4)

// in (R, G) row-major, out (G, R): out[g, r] = in[r, g]. T holds the bits of
// one element (uint16_t for bf16, uint32_t for f32); P of them make the
// 32-bit word a lane moves when `vec` (R and G multiples of P).
template <typename T>
__global__ void transpose_kernel(const T* __restrict__ in, T* __restrict__ out, long long R,
                                 long long G, int vec) {
  constexpr int P = 4 / sizeof(T);
  constexpr int TILE = 32 * P;
  __shared__ T tile[TILE][TILE + 1];
  const long long r0 = static_cast<long long>(blockIdx.x) * TILE;
  const long long g0 = static_cast<long long>(blockIdx.y) * TILE;
  const int lane = threadIdx.x, wy = threadIdx.y;  // 32 x 8 threads

  // read TILE rows of `in` along g: lane moves elements g0 + P*lane .. + P-1
  for (int rr = wy; rr < TILE; rr += 8) {
    const long long r = r0 + rr, g = g0 + P * lane;
    if (r >= R) break;
    const T* src = in + r * G + g;
    if (vec && g + P <= G) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
      for (int q = 0; q < P; ++q) tile[rr][P * lane + q] = static_cast<T>(w >> (16 * q * (P - 1)));
    } else {
      for (int q = 0; q < P; ++q)
        if (g + q < G) tile[rr][P * lane + q] = src[q];
    }
  }
  __syncthreads();
  // write TILE rows of `out` along r: lane moves elements r0 + P*lane .. + P-1
  for (int gg = wy; gg < TILE; gg += 8) {
    const long long g = g0 + gg, r = r0 + P * lane;
    if (g >= G) break;
    T* dst = out + g * R + r;
    if (vec && r + P <= R) {
      uint32_t w = 0;
#pragma unroll
      for (int q = 0; q < P; ++q) w |= static_cast<uint32_t>(tile[P * lane + q][gg]) << (16 * q * (P - 1));
      *reinterpret_cast<uint32_t*>(dst) = w;
    } else {
      for (int q = 0; q < P; ++q)
        if (r + q < R) dst[q] = tile[P * lane + q][gg];
    }
  }
}

template <typename T>
cudaError_t launch_transpose(const void* x, void* y, long long R, long long G, cudaStream_t s) {
  constexpr int P = 4 / sizeof(T);
  constexpr long long TILE = 32 * P;
  const long long bx = (R + TILE - 1) / TILE, by = (G + TILE - 1) / TILE;
  if (bx > 0x7fffffffLL || by > 65535) return cudaErrorInvalidValue;
  const int vec = (R % P == 0 && G % P == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 4 == 0);
  transpose_kernel<T><<<dim3(static_cast<unsigned>(bx), static_cast<unsigned>(by)), dim3(32, 8),
                        0, s>>>(static_cast<const T*>(x), static_cast<T*>(y), R, G, vec);
  return cudaGetLastError();
}

}  // namespace

// y = x, nbytes bytes. Returns the CUDA error code of the launch.
extern "C" int nkbx_layout_copy(const void* x, void* y, long long nbytes, void* stream) {
  if (nbytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes(reinterpret_cast<uintptr_t>(x), reinterpret_cast<uintptr_t>(y), nbytes)) {
    case 16:
      return static_cast<int>(nbytes >= kBulkMin ? launch_copy_bulk(x, y, nbytes, s)
                                                 : launch_copy<uint4>(x, y, nbytes, s));
    case 8: return static_cast<int>(launch_copy<uint2>(x, y, nbytes, s));
    case 4: return static_cast<int>(launch_copy<uint32_t>(x, y, nbytes, s));
    case 2: return static_cast<int>(launch_copy<uint16_t>(x, y, nbytes, s));
    default: return static_cast<int>(launch_copy<uint8_t>(x, y, nbytes, s));
  }
}

// x (rows, cols) -> y (cols, rows), elements of elem_bytes = 2 (bf16) or 4
// (f32). Returns the CUDA error code of the launch.
extern "C" int nkbx_layout_transpose(const void* x, void* y, long long rows, long long cols,
                                     int elem_bytes, void* stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) return static_cast<int>(launch_transpose<uint16_t>(x, y, rows, cols, s));
  if (elem_bytes == 4) return static_cast<int>(launch_transpose<uint32_t>(x, y, rows, cols, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The row permutations: mode 0 gather (X5), 1 scatter (X6), 2 pad8 (X7 E),
// over `blocks` independent stripes or windows of rows of row_bytes bytes
// (source_row above); win the window side, k the windows of a stripe (1 for
// pad8). Returns the CUDA error code of the launch.
extern "C" int nkbx_layout_rows(const void* x, void* y, int mode, long long blocks, int win, int k,
                                long long row_bytes, void* stream) {
  if (blocks <= 0 || win <= 0 || k <= 0 || row_bytes <= 0 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per = mode == kPad8 ? static_cast<long long>(win) * (win + 1)
                                      : static_cast<long long>(win) * win * k;
  const long long rows = blocks * per;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes(reinterpret_cast<uintptr_t>(x), reinterpret_cast<uintptr_t>(y), row_bytes)) {
    case 16: return static_cast<int>(launch_rows<uint4>(x, y, mode, rows, row_bytes, win, k, s));
    case 8: return static_cast<int>(launch_rows<uint2>(x, y, mode, rows, row_bytes, win, k, s));
    case 4: return static_cast<int>(launch_rows<uint32_t>(x, y, mode, rows, row_bytes, win, k, s));
    case 2: return static_cast<int>(launch_rows<uint16_t>(x, y, mode, rows, row_bytes, win, k, s));
    default: return static_cast<int>(launch_rows<uint8_t>(x, y, mode, rows, row_bytes, win, k, s));
  }
}
