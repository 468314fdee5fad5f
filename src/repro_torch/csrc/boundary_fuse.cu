// Fused split-boundary stage: codec quantize-dequantize, per-example clip
// and Gaussian noise, for Hopper (sm_90a).
//
//   q[b, n]  = qdq(x[b, n])               none | fp16 | int8 (one global amax)
//   s[b]     = min(1, clip / max(||q[b, :]||_2, 1e-12))
//   out[b,n] = q[b, n] * s[b] + noise_scale * z[b, n]
//
//   x, z, out: (B, N) row-major fp32.
//
// Replaces the TPU kernel src/repro/kernels/boundary_fuse/kernel.py:84
// (boundary_fuse_kernel / _make_fuse_kernel, a 2-phase — 3 for int8 —
// sequential pl.pallas_call grid carrying the amax in a (1, 1) and the
// per-example squared norms in a (B, 1) VMEM scratch).
//
// What bounds it on the card: memory and launches.  On the main path a
// boundary tensor is (256, 6272) or (256, 4096) fp32, 6.4 or 4.2 MB, at a
// few flops per element; it fits the 50 MB L2.  The least traffic is one
// read of x, one read of z and one write of out.
//
// What the design does about that:
//  * one CTA per example row: the row (at most 25 KB on the main path) is
//    the unit of the clip, so the per-row norm is a block reduction in a
//    fixed order (warp shuffles, then shared memory) and needs no second
//    launch; the row's second traversal, which applies the scale, finds it
//    in L1/L2;
//  * int8 needs the amax of the whole tensor before any element is
//    rounded: a first small launch writes one maximum per CTA, and every
//    row CTA folds those few partial maxima itself (max is exact in any
//    order, so the result does not depend on scheduling, and no atomics
//    or zeroed scratch are needed);
//  * coalesced loads: thread t reads elements t, t + blockDim, ... of the
//    row.
// Semantics matched bit for bit with the reference before the clip:
//  * int8: s = amax > 0 ? amax / 127 : 1;  q = clamp(rint(x / s), -127, 127)
//    * s, with a true IEEE division and round-half-even (rintf);
//  * fp16: __half2float(__float2half_rn(x)).
// Build without --use_fast_math: the division, sqrtf and rintf stay IEEE.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAmaxBlocks = 256;  // partial maxima folded by every row CTA

enum Codec { kNone = 0, kFp16 = 1, kInt8 = 2 };

__device__ __forceinline__ float block_reduce(float v, float* smem,
                                              bool is_max) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // smem may still be read by a previous reduction
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = 0.f;  // the identity of both: maxima here are of |x|
  for (int i = 0; i < nwarps; ++i) v = is_max ? fmaxf(v, smem[i]) : v + smem[i];
  return v;  // the same value in every thread
}

__global__ void __launch_bounds__(kThreads)
amax_partial(const float* __restrict__ x, float* __restrict__ partial,
             int64_t total) {
  __shared__ float smem[32];
  float m = 0.f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    m = fmaxf(m, fabsf(__ldg(x + i)));
  }
  m = block_reduce(m, smem, true);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

template <int kCodec>
__device__ __forceinline__ float qdq(float v, float s) {
  if constexpr (kCodec == kFp16) {
    return __half2float(__float2half_rn(v));
  } else if constexpr (kCodec == kInt8) {
    return fminf(fmaxf(rintf(v / s), -127.f), 127.f) * s;
  } else {
    return v;
  }
}

template <int kCodec>
__global__ void __launch_bounds__(kThreads)
fuse_rows(const float* __restrict__ x, const float* __restrict__ z,
          const float* __restrict__ partial, int n_partial,
          float* __restrict__ out, int64_t N, float clip, float noise_scale) {
  __shared__ float smem[32];
  float s = 1.f;
  if constexpr (kCodec == kInt8) {
    float m = 0.f;
    for (int i = threadIdx.x; i < n_partial; i += blockDim.x) {
      m = fmaxf(m, __ldg(partial + i));
    }
    const float amax = block_reduce(m, smem, true);
    s = amax > 0.f ? amax / 127.f : 1.f;
  }
  const int64_t off = (int64_t)blockIdx.x * N;
  const float* row = x + off;
  float ss = 0.f;
  for (int64_t i = threadIdx.x; i < N; i += blockDim.x) {
    const float q = qdq<kCodec>(__ldg(row + i), s);
    ss = fmaf(q, q, ss);
  }
  ss = block_reduce(ss, smem, false);
  const float scale = fminf(1.f, clip / fmaxf(sqrtf(ss), 1e-12f));
  const float* zr = z + off;
  float* o = out + off;
  for (int64_t i = threadIdx.x; i < N; i += blockDim.x) {
    const float q = qdq<kCodec>(__ldg(row + i), s);
    o[i] = fmaf(noise_scale, __ldg(zr + i), q * scale);
  }
}

}  // namespace

// codec: 0 none, 1 fp16, 2 int8.  `partial` is (256,) fp32 scratch, read
// only for int8.  Launches on `stream`; returns cudaGetLastError() (0 =
// launched).
extern "C" int boundary_fuse_f32(const float* x, const float* z,
                                 float* partial, float* out, int64_t B,
                                 int64_t N, int codec, float clip,
                                 float noise_scale, void* stream) {
  if (B <= 0 || N <= 0 || B > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (codec) {
    case kNone:
      fuse_rows<kNone><<<(unsigned)B, kThreads, 0, st>>>(
          x, z, partial, 0, out, N, clip, noise_scale);
      break;
    case kFp16:
      fuse_rows<kFp16><<<(unsigned)B, kThreads, 0, st>>>(
          x, z, partial, 0, out, N, clip, noise_scale);
      break;
    case kInt8: {
      const int64_t total = B * N;
      int64_t blocks = (total + kThreads - 1) / kThreads;
      if (blocks > kAmaxBlocks) blocks = kAmaxBlocks;
      amax_partial<<<(unsigned)blocks, kThreads, 0, st>>>(x, partial, total);
      const int err = (int)cudaGetLastError();
      if (err != 0) return err;
      fuse_rows<kInt8><<<(unsigned)B, kThreads, 0, st>>>(
          x, z, partial, (int)blocks, out, N, clip, noise_scale);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
