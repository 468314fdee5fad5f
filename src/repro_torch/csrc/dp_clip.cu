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
// 3.35 TB/s.  Every norm must be complete before the first scaled element
// is summed, so x is read from device memory twice.
//
// What the design does about that, in two launches on one stream:
//  1. row_scales: one CTA per example walks its row with coalesced loads
//     (float4 when N % 4 == 0 and the rows are 16-byte aligned), four
//     independent partial sums per thread to keep loads in flight, then a
//     warp-shuffle and shared-memory reduction in a fixed order.  The CTA
//     owns the whole row, so no cross-CTA sum is needed: scale[b] is
//     written directly and the result is the same bits on every run (no
//     float atomics).  256 rows of 1024 threads fill all 132 SMs twice.
//  2. clip_sum_noise: each thread owns one column (four with float4) and
//     walks the B rows, fmaf(scale[b], x[b, n], acc) in row order, then
//     adds noise_scale * z[n].  Neighbouring threads read neighbouring
//     addresses of each row.
// Build without --use_fast_math: sqrtf and the division stay IEEE.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 1024;
constexpr int kColThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride beyond this

__device__ __forceinline__ float block_sum(float v, float* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    if (lane < (int)(blockDim.x >> 5)) v = smem[lane];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;  // valid in thread 0
}

template <bool kVec>
__global__ void __launch_bounds__(kRowThreads)
row_scales(const float* __restrict__ x, float* __restrict__ scale,
           int64_t N, float clip) {
  __shared__ float smem[32];
  const float* row = x + (int64_t)blockIdx.x * N;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if constexpr (kVec) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const int64_t n4 = N / 4;
    for (int64_t i = threadIdx.x; i < n4; i += kRowThreads) {
      const float4 v = __ldg(r4 + i);
      a0 = fmaf(v.x, v.x, a0);
      a1 = fmaf(v.y, v.y, a1);
      a2 = fmaf(v.z, v.z, a2);
      a3 = fmaf(v.w, v.w, a3);
    }
  } else {
    int64_t i = threadIdx.x;
    for (; i + 3 * kRowThreads < N; i += 4 * kRowThreads) {
      const float v0 = __ldg(row + i);
      const float v1 = __ldg(row + i + kRowThreads);
      const float v2 = __ldg(row + i + 2 * kRowThreads);
      const float v3 = __ldg(row + i + 3 * kRowThreads);
      a0 = fmaf(v0, v0, a0);
      a1 = fmaf(v1, v1, a1);
      a2 = fmaf(v2, v2, a2);
      a3 = fmaf(v3, v3, a3);
    }
    for (; i < N; i += kRowThreads) {
      const float v = __ldg(row + i);
      a0 = fmaf(v, v, a0);
    }
  }
  const float ss = block_sum((a0 + a1) + (a2 + a3), smem);
  if (threadIdx.x == 0) {
    scale[blockIdx.x] = fminf(1.f, clip / fmaxf(sqrtf(ss), 1e-12f));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kColThreads)
clip_sum_noise(const float* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ z, float* __restrict__ out,
               int64_t B, int64_t N, float noise_scale) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if constexpr (kVec) {
    const int64_t n4 = N / 4;
    for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < n4;
         g += stride) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int64_t b = 0; b < B; ++b) {
        const float s = __ldg(scale + b);
        const float4 v = __ldg(reinterpret_cast<const float4*>(x + b * N) + g);
        acc.x = fmaf(s, v.x, acc.x);
        acc.y = fmaf(s, v.y, acc.y);
        acc.z = fmaf(s, v.z, acc.z);
        acc.w = fmaf(s, v.w, acc.w);
      }
      const float4 zz = __ldg(reinterpret_cast<const float4*>(z) + g);
      acc.x = fmaf(noise_scale, zz.x, acc.x);
      acc.y = fmaf(noise_scale, zz.y, acc.y);
      acc.z = fmaf(noise_scale, zz.z, acc.z);
      acc.w = fmaf(noise_scale, zz.w, acc.w);
      reinterpret_cast<float4*>(out)[g] = acc;
    }
  } else {
    for (int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; n < N;
         n += stride) {
      float acc = 0.f;
#pragma unroll 8
      for (int64_t b = 0; b < B; ++b) {
        acc = fmaf(__ldg(scale + b), __ldg(x + b * N + n), acc);
      }
      out[n] = fmaf(noise_scale, __ldg(z + n), acc);
    }
  }
}

}  // namespace

// Launches both passes on `stream`; `scale` is (B,) fp32 scratch.  Returns
// cudaGetLastError() (0 = both launched).
extern "C" int dp_clip_noise_f32(const float* x, const float* z, float* scale,
                                 float* out, int64_t B, int64_t N, float clip,
                                 float noise_scale, void* stream) {
  if (B <= 0 || N <= 0 || B > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (N % 4 == 0) && ((uintptr_t)x % 16 == 0) &&
                   ((uintptr_t)z % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (vec) {
    row_scales<true><<<(unsigned)B, kRowThreads, 0, s>>>(x, scale, N, clip);
  } else {
    row_scales<false><<<(unsigned)B, kRowThreads, 0, s>>>(x, scale, N, clip);
  }
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int64_t items = vec ? N / 4 : N;
  int64_t blocks = (items + kColThreads - 1) / kColThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vec) {
    clip_sum_noise<true><<<(unsigned)blocks, kColThreads, 0, s>>>(
        x, scale, z, out, B, N, noise_scale);
  } else {
    clip_sum_noise<false><<<(unsigned)blocks, kColThreads, 0, s>>>(
        x, scale, z, out, B, N, noise_scale);
  }
  return (int)cudaGetLastError();
}
