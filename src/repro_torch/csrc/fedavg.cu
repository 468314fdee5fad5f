// Weighted FedAvg reduce over stacked client parameters, for Hopper (sm_90a).
//
//   out[n] = sum_c w[c] * x[c, n]      x: (C, N) row-major fp32, w: (C,) fp32
//
// The caller normalises w (repro_torch/kernels/fedavg/ops.py).
//
// Replaces the TPU kernel src/repro/kernels/fedavg/kernel.py:24
// (fedavg_kernel, a pl.pallas_call over (C, block_n) VMEM tiles with N
// zero-padded to a block multiple).
//
// What bounds it on the card: memory.  The work is one read of C*N fp32
// values and one write of N, against 2*C*N flops: at most half a flop per
// byte, far below the ~20 fp32 flops per byte where the H100's 67 TFLOP/s
// would start to matter next to its 3.35 TB/s.
//
// What the design does about that:
//  * one pass: each thread owns 4 contiguous columns and walks the C rows,
//    so every x element is read once and every out element written once;
//  * no padding copy: the grid covers N and the last group masks itself
//    (the scalar tail for ragged N);
//  * coalesced 16-byte loads: when N % 4 == 0 and the pointers are 16-byte
//    aligned, each thread loads its columns as one float4, neighbouring
//    threads on neighbouring addresses;
//  * the weights go through the read-only cache: every thread of a row
//    step reads the same w[c].
// The sum over clients runs in client order with fmaf in fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride beyond this

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
fedavg_reduce(const float* __restrict__ x, const float* __restrict__ w,
              float* __restrict__ out, int64_t C, int64_t N) {
  const int64_t groups = (N + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t n0 = g * 4;
    if constexpr (kVec) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int64_t c = 0; c < C; ++c) {
        const float wc = __ldg(w + c);
        const float4 v = __ldg(reinterpret_cast<const float4*>(x + c * N + n0));
        acc.x = fmaf(wc, v.x, acc.x);
        acc.y = fmaf(wc, v.y, acc.y);
        acc.z = fmaf(wc, v.z, acc.z);
        acc.w = fmaf(wc, v.w, acc.w);
      }
      *reinterpret_cast<float4*>(out + n0) = acc;
    } else {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int64_t c = 0; c < C; ++c) {
        const float wc = __ldg(w + c);
        const float* row = x + c * N + n0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n0 + j < N) acc[j] = fmaf(wc, __ldg(row + j), acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + j < N) out[n0 + j] = acc[j];
      }
    }
  }
}

}  // namespace

// Launches the reduce on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int fedavg_f32(const float* x, const float* w, float* out,
                          int64_t C, int64_t N, void* stream) {
  if (C <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int64_t groups = (N + 3) / 4;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const bool vec = (N % 4 == 0) && ((uintptr_t)x % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    fedavg_reduce<true><<<(unsigned)blocks, kThreads, 0, s>>>(x, w, out, C, N);
  } else {
    fedavg_reduce<false><<<(unsigned)blocks, kThreads, 0, s>>>(x, w, out, C, N);
  }
  return (int)cudaGetLastError();
}
