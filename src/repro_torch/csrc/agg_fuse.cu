// Compressed-domain server reduce: codec decode fused into the weighted
// FedAvg, for Hopper (sm_90a).  Three kernels:
//
//   dequant_reduce  out[n]   = sum_c (w[c] * s[c]) * x[c, n]
//                   x: (C, N) row-major wires, coefs: (C, 2) fp32 [w, s]
//   dequant_acc     acc[n]  += (w * s) * x[n]          (in place)
//   scatter_acc     acc_l[i_k] += w * v_l[k] for every leaf l of a table
//                   (in place; colliding indices sum; indices outside
//                   [0, N_l) are dropped)
//
// Wires are int8 (symmetric quantisation, s = the leaf's scale), fp16 or
// fp32 (s = 1), read at their own width and widened in registers; nothing
// dequantised is written to device memory.  dtype codes: 0 fp32, 1 fp16,
// 2 int8 (repro_torch/kernels/agg_fuse/kernel.py).
//
// Replaces the TPU kernels of src/repro/kernels/agg_fuse/kernel.py:
// dequant_reduce_kernel (:61; a (n_blocks, C) grid with the client sweep
// innermost carrying a (1, block_n) VMEM accumulator), dequant_acc_kernel
// (:91; elementwise over padded blocks, acc donated) and scatter_acc_kernel
// (:133; a broadcast-compare one-hot sum of K x block_n per block).
//
// What bounds them on the card: memory and launches.  dequant_reduce reads
// C*N wire elements and writes N floats (9 bytes a column at C = 5 int8),
// dequant_acc reads a wire and reads and writes acc (9 bytes an element
// for int8), scatter_acc touches 16 bytes a kept entry (value, index, and
// the read-modify-write of acc).  All are a few operations a byte.
//
// What the design does about that:
//  * dequant_reduce: the TPU kernel's sequential client axis and VMEM
//    accumulator become a loop over the C clients inside each thread, in
//    client order, with one fmaf a client: no atomics, no padding copy (the
//    grid covers N and masks the ragged edge), the same bits every launch.
//    The C coefficients w*s are formed once a block into shared memory;
//  * dequant_acc: one grid-stride elementwise pass;
//  * four columns a thread, with one vector load of four wire elements
//    (16 bytes fp32, 8 fp16, 4 int8) and a float4 acc/out access where N is
//    a multiple of 4 and the pointers are aligned; scalar loads otherwise;
//  * scatter_acc: one thread a kept entry and one atomicAdd, O(K) work.
//    The Pallas one-hot is O(K*N) compares (6.7e9 for conv2.w's 8192 of
//    819,200): it suits a TPU's vector unit, not a card with atomics.  A
//    top-k wire's indices are distinct, so each element takes one add and
//    the result is deterministic; colliding indices add in an order that
//    varies from run to run.  A fold's work is small (about 10,000 kept
//    entries over 12 leaves on the main path) and was one launch a leaf,
//    so launches set its time: one launch now covers a table of up to
//    kMaxLeaves leaves, passed by value in the kernel's parameters.  Leaf
//    l owns blocks [first[l], first[l + 1]) (a prefix sum of its
//    ceil(K_l / kThreads) blocks, computed on the host from the sizes the
//    caller knows: no device read), and a block finds its leaf by a
//    search over that prefix, which every thread of it reads alike from
//    the constant bank.
// Rounding: dequant_acc and scatter_acc round the product and the sum
// separately (__fmul_rn, __fadd_rn), as the plain version does, so they
// match it bit for bit; dequant_reduce accumulates with fmaf (one rounding
// a client instead of two), within an ulp a client of the plain sum.
// The scale s of an int8 wire is a device scalar read by pointer: no host
// synchronisation.  Build without --use_fast_math.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride beyond this
constexpr int64_t kMaxClients = 12288;   // C floats in 48 KB of shared memory
constexpr int kMaxLeaves = 64;           // leaves a scatter launch: 3 KB of
                                         // kernel parameters

enum Dtype { kF32 = 0, kF16 = 1, kI8 = 2 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }

// four consecutive wire elements at p (aligned to 4 elements) as floats
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __half* p, float (&v)[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&q.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float (&v)[4]) {
  const char4 q = __ldg(reinterpret_cast<const char4*>(p));
  v[0] = (float)q.x; v[1] = (float)q.y; v[2] = (float)q.z; v[3] = (float)q.w;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
dequant_reduce(const T* __restrict__ x, const float* __restrict__ coefs,
               float* __restrict__ out, int64_t C, int64_t N) {
  extern __shared__ float coef[];
  for (int64_t c = threadIdx.x; c < C; c += blockDim.x) {
    coef[c] = __ldg(coefs + 2 * c) * __ldg(coefs + 2 * c + 1);
  }
  __syncthreads();
  const int64_t groups = (N + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t n0 = g * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int64_t c = 0; c < C; ++c) {
      const T* row = x + c * N + n0;
      const float k = coef[c];
      if constexpr (kVec) {
        float v[4];
        load4(row, v);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = fmaf(k, v[j], acc[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n0 + j < N) acc[j] = fmaf(k, widen(__ldg(row + j)), acc[j]);
        }
      }
    }
    if constexpr (kVec) {
      *reinterpret_cast<float4*>(out + n0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + j < N) out[n0 + j] = acc[j];
      }
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
dequant_acc(float* __restrict__ acc, const T* __restrict__ x,
            const float* __restrict__ scale, float w, int64_t N) {
  const float k = scale == nullptr ? w : __fmul_rn(w, __ldg(scale));
  const int64_t groups = (N + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t n0 = g * 4;
    if constexpr (kVec) {
      float v[4];
      load4(x + n0, v);
      float4 a = *reinterpret_cast<const float4*>(acc + n0);
      a.x = __fadd_rn(a.x, __fmul_rn(k, v[0]));
      a.y = __fadd_rn(a.y, __fmul_rn(k, v[1]));
      a.z = __fadd_rn(a.z, __fmul_rn(k, v[2]));
      a.w = __fadd_rn(a.w, __fmul_rn(k, v[3]));
      *reinterpret_cast<float4*>(acc + n0) = a;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t n = n0 + j;
        if (n < N) acc[n] = __fadd_rn(acc[n], __fmul_rn(k, widen(__ldg(x + n))));
      }
    }
  }
}

// the leaves of one scatter launch, by value in the kernel's parameters
struct LeafTable {
  float* acc[kMaxLeaves];
  const float* vals[kMaxLeaves];
  const int32_t* idx[kMaxLeaves];
  int64_t K[kMaxLeaves];
  int64_t N[kMaxLeaves];
  int64_t first[kMaxLeaves + 1];  // leaf l's first block; first[n] = grid
  int n;
  float w;
};

__global__ void __launch_bounds__(kThreads)
scatter_acc(const __grid_constant__ LeafTable t) {
  int l = 0;  // the last leaf whose first block is at or before this one
  while (l + 1 < t.n && t.first[l + 1] <= (int64_t)blockIdx.x) ++l;
  const int64_t k =
      ((int64_t)blockIdx.x - t.first[l]) * kThreads + threadIdx.x;
  if (k >= t.K[l]) return;
  const int64_t i = __ldg(t.idx[l] + k);
  if (i >= 0 && i < t.N[l]) {
    atomicAdd(t.acc[l] + i, __fmul_rn(t.w, __ldg(t.vals[l] + k)));
  }
}

unsigned grid_for(int64_t items) {
  int64_t blocks = (items + kThreads - 1) / kThreads;
  return (unsigned)(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch_reduce(const void* x, const float* coefs, float* out, int64_t C,
                  int64_t N, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const unsigned grid = grid_for((N + 3) / 4);
  const size_t smem = (size_t)C * sizeof(float);
  if (N % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(out, 16)) {
    dequant_reduce<T, true><<<grid, kThreads, smem, st>>>(xt, coefs, out, C, N);
  } else {
    dequant_reduce<T, false><<<grid, kThreads, smem, st>>>(xt, coefs, out, C, N);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_acc(float* acc, const void* x, const float* scale, float w,
               int64_t N, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const unsigned grid = grid_for((N + 3) / 4);
  if (N % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(acc, 16)) {
    dequant_acc<T, true><<<grid, kThreads, 0, st>>>(acc, xt, scale, w, N);
  } else {
    dequant_acc<T, false><<<grid, kThreads, 0, st>>>(acc, xt, scale, w, N);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out (N,) = sum_c coefs[c,0]*coefs[c,1] * wires[c, :].  Launches on
// `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int agg_dequant_reduce(const void* wires, int dtype,
                                  const float* coefs, float* out, int64_t C,
                                  int64_t N, void* stream) {
  if (C <= 0 || C > kMaxClients || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_reduce<float>(wires, coefs, out, C, N, st);
    case kF16: return launch_reduce<__half>(wires, coefs, out, C, N, st);
    case kI8: return launch_reduce<int8_t>(wires, coefs, out, C, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// acc (N,) += (w * *scale) * wire; scale may be null (1.0).
extern "C" int agg_dequant_acc(float* acc, const void* wire, int dtype,
                               const float* scale, float w, int64_t N,
                               void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_acc<float>(acc, wire, scale, w, N, st);
    case kF16: return launch_acc<__half>(acc, wire, scale, w, N, st);
    case kI8: return launch_acc<int8_t>(acc, wire, scale, w, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// For each of n <= kMaxLeaves leaves l, with desc[5l .. 5l + 5) = (acc,
// vals, idx, K, N): acc[idx[k]] += w * vals[k] for k < K, idx in [0, N).
// One launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int agg_scatter_acc_leaves(const int64_t* desc, int n, float w,
                                      void* stream) {
  if (n <= 0 || n > kMaxLeaves) return (int)cudaErrorInvalidValue;
  LeafTable t = {};
  t.n = n;
  t.w = w;
  int64_t blocks = 0;
  for (int l = 0; l < n; ++l) {
    const int64_t* d = desc + 5 * l;
    if (d[3] <= 0 || d[4] <= 0) return (int)cudaErrorInvalidValue;
    t.acc[l] = reinterpret_cast<float*>(d[0]);
    t.vals[l] = reinterpret_cast<const float*>(d[1]);
    t.idx[l] = reinterpret_cast<const int32_t*>(d[2]);
    t.K[l] = d[3];
    t.N[l] = d[4];
    t.first[l] = blocks;
    blocks += (d[3] + kThreads - 1) / kThreads;
  }
  t.first[n] = blocks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  scatter_acc<<<(unsigned)blocks, kThreads, 0, st>>>(t);
  return (int)cudaGetLastError();
}
