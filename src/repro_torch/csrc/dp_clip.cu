// DP-SGD per-example clip, sum and noise, for Hopper (sm_90a).
//
//   scale[b] = min(1, clip / max(||x[b, :]||_2, 1e-12))
//   out[n]   = sum_b scale[b] * x[b, n]  +  noise_scale * z[n]
//
//   x: (B, N) row-major fp32 per-example gradients, z: (N,) fp32 noise.
//
// Replaces the TPU kernel src/repro/kernels/dp_clip/kernel.py:58
// (dp_clip_noise_kernel, a two-phase sequential pl.pallas_call grid that
// carries the per-example squared norms in a (B, 1) VMEM scratch from
// phase 0 to phase 1).
//
// What bounds it on the card: memory.  On the main path (B = 256 examples,
// N = 1,030,913 discriminator parameters) x is 1.06 GB, twenty times the
// 50 MB L2, and the work is about 4 flops per element of x: a flop per
// byte, far below where the 67 TFLOP/s of fp32 would matter next to
// 3.35 TB/s.  The norms are complete before the sum starts, so x is read
// from device memory twice (0.63 ms at 3.35 TB/s), less what the second
// read finds in L2.
//
// What the design does about that, in three launches on one stream.  The
// two that read x are persistent grids of one CTA an SM that stream long
// contiguous runs of it through a shared-memory ring: one thread of a
// producer warp copies each run with a TMA bulk copy (cp.async.bulk,
// completion on an mbarrier), so an SM keeps up to 192 KB in flight and
// spends no registers or instructions on addresses, and consumer warps
// release a stage by an mbarrier arrive.
//  1. row_pass: x is cut into spans of kSpan elements that never cross a
//     row (span c of row b holds x[b, c*kSpan : (c+1)*kSpan]); the CTAs
//     take them round-robin, rows from the last down.  Four consumer
//     warps take the stages in turn, each a whole span: its sum of squares
//     in a fixed order (lanes stride the span's float4 words, four partial
//     sums a lane, a butterfly of xor shuffles) goes to work[b][c].
//  2. row_scales: one warp a row sums work[b][0..spans) in a fixed order
//     (lane l: spans l, l + 32, ..., a butterfly) into scale[b].
//  3. col_pass: the columns are cut into as many tiles of equal width (at
//     most kColMax) as there are CTAs, or a multiple of that; a CTA copies
//     its tile's stretch of row 0, row 1, ... in order, so all CTAs move
//     down the rows together and the first rows, which the row pass read
//     last, come from L2.  Eight consumer warps own 32 columns a thread
//     and fmaf(scale[b], x[b, n], acc) in row order b = 0..B-1 (scale[b]
//     loaded a row ahead); at the end they add noise_scale * z[n] and
//     store.
// No float atomics: two launches on the same input give the same bits.
// Rows start at b * N * 4 bytes, which is not 16-byte aligned for N not a
// multiple of 4 (the main path's N is odd), and a bulk copy needs 16-byte
// aligned addresses and sizes: every copy takes the 16-byte-aligned range
// that encloses its elements (at most 3 elements either side, in the same
// 16-byte block as an element of x, so never outside x's pages), and the
// consumers skip the elements outside it.  Any N and any 4-byte-aligned x
// take the same path.
// A single kernel that sums each row as soon as its norm is known, a few
// rows behind the norms and so from L2, would read x from device memory
// once; on an H100 it ran slower than this design, because every row then
// waits on the slowest SM's share of its norm (PERF.md §6).
// Build without --use_fast_math: sqrtf and the division stay IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_sync.cuh"

namespace {

constexpr int kSpan = 6144;               // elements a row-pass span: 24 KB
constexpr int kSpanBuf = kSpan + 8;       // + the copy's alignment slack
constexpr int kRowWarps = 4;              // consumer warps
constexpr int kRowStages = 8;
// consumer warp w takes the stages s = w (mod kRowWarps), so it has seen a
// stage's previous phase complete before it waits on the next
static_assert(kRowStages % kRowWarps == 0, "a stage has one consumer");
constexpr int kRowThreads = 32 * (kRowWarps + 1);
constexpr int kRowSmem = kRowStages * kSpanBuf * 4 + 2 * kRowStages * 8;

constexpr int kColMax = 8192;             // columns a tile, at most
constexpr int kColBuf = kColMax + 8;
constexpr int kColStages = 6;
constexpr int kColWarps = 8;
constexpr int kColPerThread = kColMax / (32 * kColWarps);   // 32
constexpr int kColThreads = 32 * (kColWarps + 1);
constexpr int kColSmem = kColStages * kColBuf * 4 + 2 * kColStages * 8;

// the 16-byte-aligned range enclosing elements [e, e + len) of x: its
// start and its size in bytes (element e sits elem_off(x, e) floats in)
struct Span {
  const float* start;
  uint32_t bytes;
};

__device__ __forceinline__ Span enclosing(const float* x, int64_t e,
                                          int64_t len) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x + e);
  const uintptr_t lo = a & ~uintptr_t(15);
  const uintptr_t hi = (a + 4 * len + 15) & ~uintptr_t(15);
  return {reinterpret_cast<const float*>(lo), (uint32_t)(hi - lo)};
}

__device__ __forceinline__ int elem_off(const float* x, int64_t e) {
  return (int)((reinterpret_cast<uintptr_t>(x + e) & 15) >> 2);
}

__global__ void __launch_bounds__(kRowThreads, 1)
row_pass(const float* __restrict__ x, float* __restrict__ work, int64_t B,
         int64_t N, int64_t spans) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kRowStages * kSpanBuf);
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = smem_u32(bars + kRowStages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRowStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 1);        // the consuming warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int64_t total = B * spans;

  if (warp == kRowWarps) {                 // producer
    if (lane != 0) return;
    int64_t it = 0;
    for (int64_t q = blockIdx.x; q < total; q += gridDim.x, ++it) {
      const int s = (int)(it % kRowStages);
      if (it >= kRowStages)
        mbar_wait(empty0 + 8 * s, (uint32_t)((it / kRowStages - 1) & 1));
      const int64_t b = B - 1 - q / spans, c = q % spans;
      const int64_t n0 = c * kSpan;
      const Span sp = enclosing(x, b * N + n0, min((int64_t)kSpan, N - n0));
      mbar_expect_tx(full0 + 8 * s, sp.bytes);
      bulk_load(smem_u32(smem + s * kSpanBuf), sp.start, sp.bytes,
                full0 + 8 * s);
    }
    return;
  }

  // consumer warp `warp` takes iterations warp, warp + kRowWarps, ...
  int64_t it = warp;
  for (int64_t q = blockIdx.x + (int64_t)warp * gridDim.x; q < total;
       q += (int64_t)kRowWarps * gridDim.x, it += kRowWarps) {
    const int s = (int)(it % kRowStages);
    mbar_wait(full0 + 8 * s, (uint32_t)((it / kRowStages) & 1));
    const int64_t b = B - 1 - q / spans, c = q % spans;
    const int64_t n0 = c * kSpan;
    const int len = (int)min((int64_t)kSpan, N - n0);
    const int off = elem_off(x, b * N + n0);
    const int end = off + len;
    const float4* buf = reinterpret_cast<const float4*>(smem + s * kSpanBuf);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
    for (int v = lane; 4 * v < end; v += 32) {
      float4 f = buf[v];
      const int i = 4 * v;
      if (i < off || i + 4 > end) {        // the span's first or last word
        f.x = (i >= off && i < end) ? f.x : 0.f;
        f.y = (i + 1 >= off && i + 1 < end) ? f.y : 0.f;
        f.z = (i + 2 >= off && i + 2 < end) ? f.z : 0.f;
        f.w = (i + 3 >= off && i + 3 < end) ? f.w : 0.f;
      }
      a0 = fmaf(f.x, f.x, a0);
      a1 = fmaf(f.y, f.y, a1);
      a2 = fmaf(f.z, f.z, a2);
      a3 = fmaf(f.w, f.w, a3);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);   // the stage is read
    float ss = (a0 + a1) + (a2 + a3);
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) work[b * spans + c] = ss;
  }
}

// scale[b] from work[b][0..spans), in a fixed order: lane l sums spans l,
// l + 32, ... in order (eight loads in flight), then a butterfly of xor
// shuffles
__global__ void __launch_bounds__(256)
row_scales(const float* __restrict__ work, float* __restrict__ scale,
           int64_t B, int64_t spans, float clip) {
  const int lane = threadIdx.x & 31;
  const int64_t b = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (b >= B) return;                      // whole warps leave together
  const float* w = work + b * spans;
  float ss = 0.f;
  for (int64_t c0 = 0; c0 < spans; c0 += 256) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int64_t c = c0 + lane + 32 * k;
      v[k] = c < spans ? w[c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) ss += v[k];
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) scale[b] = fminf(1.f, clip / fmaxf(sqrtf(ss), 1e-12f));
}

__global__ void __launch_bounds__(kColThreads, 1)
col_pass(const float* __restrict__ x, const float* __restrict__ scale,
         const float* __restrict__ z, float* __restrict__ out, int64_t B,
         int64_t N, int64_t width, float noise_scale) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kColStages * kColBuf);
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = smem_u32(bars + kColStages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kColStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kColWarps);   // lane 0 of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int64_t tiles = (N + width - 1) / width;

  if (warp == kColWarps) {                 // producer
    if (lane != 0) return;
    int64_t it = 0;
    for (int64_t k = blockIdx.x; k < tiles; k += gridDim.x) {
      const int64_t n0 = k * width;
      const int64_t w = min(width, N - n0);
      for (int64_t b = 0; b < B; ++b, ++it) {
        const int s = (int)(it % kColStages);
        if (it >= kColStages)
          mbar_wait(empty0 + 8 * s, (uint32_t)((it / kColStages - 1) & 1));
        const Span sp = enclosing(x, b * N + n0, w);
        mbar_expect_tx(full0 + 8 * s, sp.bytes);
        bulk_load(smem_u32(smem + s * kColBuf), sp.start, sp.bytes,
                  full0 + 8 * s);
      }
    }
    return;
  }

  const int t = threadIdx.x;               // columns t + 256 i of a tile
  int64_t it = 0;
  for (int64_t k = blockIdx.x; k < tiles; k += gridDim.x) {
    const int64_t n0 = k * width;
    const int w = (int)min(width, N - n0);
    float acc[kColPerThread];
#pragma unroll
    for (int i = 0; i < kColPerThread; ++i) acc[i] = 0.f;
    float next = __ldg(scale);
    for (int64_t b = 0; b < B; ++b, ++it) {  // rows in order
      const float sc = next;
      if (b + 1 < B) next = __ldg(scale + b + 1);   // a row ahead
      const int s = (int)(it % kColStages);
      mbar_wait(full0 + 8 * s, (uint32_t)((it / kColStages) & 1));
      const float* row = smem + s * kColBuf + elem_off(x, b * N + n0);
#pragma unroll
      for (int i = 0; i < kColPerThread; ++i) {
        const int col = t + 32 * kColWarps * i;
        if (col < w) acc[i] = fmaf(sc, row[col], acc[i]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }
#pragma unroll
    for (int i = 0; i < kColPerThread; ++i) {
      const int col = t + 32 * kColWarps * i;
      if (col < w)
        out[n0 + col] = fmaf(noise_scale, __ldg(z + n0 + col), acc[i]);
    }
  }
}

// the persistent grid of `kernel` on the current device: its resident
// CTAs (SMs x CTAs an SM, after the shared-memory opt-in), worked out
// once a device
template <int kId, typename K>
int resident(K kernel, int threads, int smem, int* grid) {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int g = dev < kDevices ? cached[dev] : 0;
  if (g == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    g = sms * per_sm;
    if (dev < kDevices) cached[dev] = g;
  }
  *grid = g;
  return 0;
}

}  // namespace

// Floats of the `work` scratch dp_clip_noise_f32 needs for (B, N): one
// partial sum of squares a (row, span), then scale[b].
extern "C" int64_t dp_clip_work_floats(int64_t B, int64_t N) {
  return B * ((N + kSpan - 1) / kSpan) + B;
}

// Launches the three kernels on `stream`; `work` is dp_clip_work_floats(B,
// N) fp32 scratch.  Returns cudaGetLastError() (0 = all launched).
extern "C" int dp_clip_noise_f32(const float* x, const float* z, float* work,
                                 float* out, int64_t B, int64_t N, float clip,
                                 float noise_scale, void* stream) {
  if (B <= 0 || N <= 0 || B > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t spans = (N + kSpan - 1) / kSpan;
  float* scale = work + B * spans;
  int grid = 0;
  int err = resident<0>(row_pass, kRowThreads, kRowSmem, &grid);
  if (err != 0) return err;
  row_pass<<<(unsigned)std::min((int64_t)grid, B * spans), kRowThreads,
             kRowSmem, s>>>(x, work, B, N, spans);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  row_scales<<<(unsigned)((B + 7) / 8), 256, 0, s>>>(work, scale, B, spans,
                                                     clip);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if ((err = resident<1>(col_pass, kColThreads, kColSmem, &grid)) != 0)
    return err;
  // column tiles of equal width (a multiple of 4, at most kColMax), as
  // many as the CTAs or a multiple of them
  const int64_t waves = (N + (int64_t)grid * kColMax - 1) /
                        ((int64_t)grid * kColMax);
  const int64_t width =
      ((N + grid * waves - 1) / (grid * waves) + 3) / 4 * 4;
  const int64_t tiles = (N + width - 1) / width;
  col_pass<<<(unsigned)std::min((int64_t)grid, tiles), kColThreads, kColSmem,
             s>>>(
      x, scale, z, out, B, N, width, noise_scale);
  return (int)cudaGetLastError();
}
