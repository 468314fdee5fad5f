// Compressed-domain server reduce: codec decode fused into the weighted
// FedAvg, for Hopper (sm_90a).  Three kernels, each over a table of leaves
// passed by value in the kernel's parameters:
//
//   dequant_reduce  out_l[n]  = sum_c (w[c] * s_lc) * x_lc[n]   for every
//                   leaf l; x_lc is client c's wire of leaf l, read where
//                   the codec left it (no (C, N) stack)
//   dequant_acc     acc_l[n] += (w * s_l) * x_l[n]   for every leaf l of
//                   one client's uplink (in place)
//   scatter_acc     acc_l[i_k] += w * v_l[k] for every leaf l (in place;
//                   colliding indices sum; indices outside [0, N_l) are
//                   dropped)
//
// Wires are int8 (symmetric quantisation, s = the leaf's scale), fp16 or
// fp32 (s = 1, a null scale pointer), read at their own width and widened
// in registers; nothing dequantised is written to device memory.  dtype
// codes: 0 fp32, 1 fp16, 2 int8 (repro_torch/kernels/agg_fuse/kernel.py).
//
// Replaces the TPU kernels of src/repro/kernels/agg_fuse/kernel.py:
// dequant_reduce_kernel (:61; a (n_blocks, C) grid with the client sweep
// innermost carrying a (1, block_n) VMEM accumulator), dequant_acc_kernel
// (:91; elementwise over padded blocks, acc donated) and scatter_acc_kernel
// (:133; a broadcast-compare one-hot sum of K x block_n per block).
//
// What bounds them on the card: memory, and launches.  dequant_reduce
// reads C*N wire elements and writes N floats (9 bytes a column at C = 5
// int8), dequant_acc reads a wire and reads and writes acc (9 bytes an
// element for int8), scatter_acc touches 16 bytes a kept entry (value,
// index, and the read-modify-write of acc).  All are a few operations a
// byte.  The main path's discriminator has 12 leaves of 1 to 819,200
// elements (1,030,913 in all), ten of them under 5,000: one launch a leaf
// costs ~1.4 us of launch against ~0.2 us of bytes for most of them, and a
// Python call a leaf on the host.
//
// What the design does about that:
//  * one launch covers a table of leaves (a whole uplink's fold, a whole
//    round's reduce), passed by value as a __grid_constant__ parameter, so
//    a CUDA graph captures it.  Leaf l owns blocks [first[l], first[l+1]),
//    a prefix sum computed on the host from the sizes the caller knows (no
//    device read); a block finds its leaf by a search over that prefix,
//    which every thread of it reads alike from the constant bank, so each
//    block belongs to one leaf and every choice below is uniform in it;
//  * dequant_reduce: the TPU kernel's sequential client axis and VMEM
//    accumulator become a loop over the clients inside each thread, in
//    client order, with one fmaf a client: no atomics, no padding copy,
//    the same bits every launch.  A block forms its leaf's C coefficients
//    w*s once into shared memory.  The table holds 16 bytes of pointers a
//    (leaf, client): more clients than kReduceClients take several
//    launches, the later ones starting their fmaf chain from out, still
//    in client order, so the result is bit for bit that of one launch;
//  * dequant_acc, scatter_acc: one pass; scatter_acc one thread a kept
//    entry and one atomicAdd, O(K) work (the Pallas one-hot is O(K*N)
//    compares: 6.7e9 for conv2.w's 8192 of 819,200; it suits a TPU's
//    vector unit, not a card with atomics).  A top-k wire's indices are
//    distinct, so each element takes one add and the result is
//    deterministic; colliding indices add in an order that varies;
//  * the dense kernels: four elements a thread, a block 4 x kThreads
//    elements of one leaf, with one vector load of four wire elements (16
//    bytes fp32, 8 fp16, 4 int8) and a float4 acc/out access where the
//    leaf's N is a multiple of 4 and its pointers are aligned (chosen per
//    leaf on the host: the main path mixes N = 1, 1600 and 819,200);
//    scalar loads otherwise.
// Rounding: dequant_acc and scatter_acc round the product and the sum
// separately (__fmul_rn, __fadd_rn), as the plain version does, so they
// match it bit for bit; dequant_reduce accumulates with fmaf (one rounding
// a client instead of two), within an ulp a client of the plain sum.
// Scales are device scalars read by pointer: no host synchronisation.
// Build without --use_fast_math.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kBlockElems = 4 * kThreads;  // a dense block's elements
constexpr int kMaxLeaves = 64;        // leaves a scatter or acc launch
constexpr int kReduceClients = 16;    // clients a reduce launch
constexpr int kReduceLeaves = 32;     // leaves a reduce launch
constexpr int kReduceEntries = 192;   // (leaf, client) pairs a reduce launch

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

// This block's leaf in a table: the last whose first block is at or
// before this one.
template <typename Table>
__device__ __forceinline__ int leaf_of(const Table& t) {
  int l = 0;
  while (l + 1 < t.n && t.first[l + 1] <= (int64_t)blockIdx.x) ++l;
  return l;
}

// the leaves of one reduce launch
struct ReduceTable {
  const void* wire[kReduceEntries];    // leaf l, client c at l * C + c
  const float* scale[kReduceEntries];  // the same; null: 1.0
  float* out[kReduceLeaves];
  int64_t N[kReduceLeaves];
  int64_t first[kReduceLeaves + 1];    // leaf l's first block; first[n] = grid
  const float* w;                      // client c's weight at w[c * w_stride]
  int64_t w_stride;
  uint64_t vec;                        // bit l: leaf l takes the vector path
  int n, C;
  int accumulate;                      // start from out: a later client chunk
};
static_assert(sizeof(ReduceTable) <= 4096, "kernel parameters over 4 KB");

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_reduce(const __grid_constant__ ReduceTable t) {
  __shared__ float coef[kReduceClients];
  const int l = leaf_of(t);
  const int C = t.C;
  if ((int)threadIdx.x < C) {
    const float w = __ldg(t.w + threadIdx.x * t.w_stride);
    const float* s = t.scale[l * C + threadIdx.x];
    coef[threadIdx.x] = s == nullptr ? w : __fmul_rn(w, __ldg(s));
  }
  __syncthreads();
  const int64_t N = t.N[l];
  const int64_t n0 =
      ((int64_t)blockIdx.x - t.first[l]) * kBlockElems + 4 * threadIdx.x;
  if (n0 >= N) return;
  float* out = t.out[l] + n0;
  const bool vec = (t.vec >> l) & 1;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (t.accumulate) {
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(out);
      acc[0] = a.x; acc[1] = a.y; acc[2] = a.z; acc[3] = a.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + j < N) acc[j] = out[j];
      }
    }
  }
  for (int c = 0; c < C; ++c) {
    const T* x = static_cast<const T*>(t.wire[l * C + c]) + n0;
    const float k = coef[c];
    if (vec) {
      float v[4];
      load4(x, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(k, v[j], acc[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + j < N) acc[j] = fmaf(k, widen(__ldg(x + j)), acc[j]);
      }
    }
  }
  if (vec) {
    *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2],
                                                  acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n0 + j < N) out[j] = acc[j];
    }
  }
}

// the leaves of one dequant_acc launch: one client's uplink
struct AccTable {
  float* acc[kMaxLeaves];
  const void* wire[kMaxLeaves];
  const float* scale[kMaxLeaves];      // null: 1.0
  int64_t N[kMaxLeaves];
  int64_t first[kMaxLeaves + 1];       // leaf l's first block; first[n] = grid
  uint64_t vec;                        // bit l: leaf l takes the vector path
  int n;
  float w;
};
static_assert(sizeof(AccTable) <= 4096, "kernel parameters over 4 KB");

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_acc(const __grid_constant__ AccTable t) {
  const int l = leaf_of(t);
  const int64_t N = t.N[l];
  const int64_t n0 =
      ((int64_t)blockIdx.x - t.first[l]) * kBlockElems + 4 * threadIdx.x;
  if (n0 >= N) return;
  const float* s = t.scale[l];
  const float k = s == nullptr ? t.w : __fmul_rn(t.w, __ldg(s));
  float* acc = t.acc[l] + n0;
  const T* x = static_cast<const T*>(t.wire[l]) + n0;
  if ((t.vec >> l) & 1) {
    float v[4];
    load4(x, v);
    float4 a = *reinterpret_cast<const float4*>(acc);
    a.x = __fadd_rn(a.x, __fmul_rn(k, v[0]));
    a.y = __fadd_rn(a.y, __fmul_rn(k, v[1]));
    a.z = __fadd_rn(a.z, __fmul_rn(k, v[2]));
    a.w = __fadd_rn(a.w, __fmul_rn(k, v[3]));
    *reinterpret_cast<float4*>(acc) = a;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n0 + j < N) {
        acc[j] = __fadd_rn(acc[j], __fmul_rn(k, widen(__ldg(x + j))));
      }
    }
  }
}

// the leaves of one scatter launch
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
  const int l = leaf_of(t);
  const int64_t k =
      ((int64_t)blockIdx.x - t.first[l]) * kThreads + threadIdx.x;
  if (k >= t.K[l]) return;
  const int64_t i = __ldg(t.idx[l] + k);
  if (i >= 0 && i < t.N[l]) {
    atomicAdd(t.acc[l] + i, __fmul_rn(t.w, __ldg(t.vals[l] + k)));
  }
}

bool aligned(const void* p, int64_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int64_t elem_bytes(int dtype) {
  switch (dtype) {
    case kF32: return 4;
    case kF16: return 2;
    case kI8: return 1;
    default: return 0;
  }
}

// the dense blocks of a leaf of N elements
int64_t dense_blocks(int64_t N) { return (N + kBlockElems - 1) / kBlockElems; }

int launch_reduce(const ReduceTable& t, int dtype, cudaStream_t st) {
  const unsigned grid = (unsigned)t.first[t.n];
  switch (dtype) {
    case kF32: dequant_reduce<float><<<grid, kThreads, 0, st>>>(t); break;
    case kF16: dequant_reduce<__half><<<grid, kThreads, 0, st>>>(t); break;
    default: dequant_reduce<int8_t><<<grid, kThreads, 0, st>>>(t); break;
  }
  return (int)cudaGetLastError();
}

int launch_acc(const AccTable& t, int dtype, cudaStream_t st) {
  const unsigned grid = (unsigned)t.first[t.n];
  switch (dtype) {
    case kF32: dequant_acc<float><<<grid, kThreads, 0, st>>>(t); break;
    case kF16: dequant_acc<__half><<<grid, kThreads, 0, st>>>(t); break;
    default: dequant_acc<int8_t><<<grid, kThreads, 0, st>>>(t); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One reduce launch over n <= kReduceLeaves leaves and clients [c0, c0 +
// C) of C_all, C <= kReduceClients, n * C <= kReduceEntries.  leaves[2l ..
// 2l + 2) = (out, N) of leaf l; wires[2 (l * C_all + c) .. + 2) = (wire,
// scale or 0) of leaf l, client c; w: the C clients' fp32 weights, client
// c at w[c * w_stride] (w points at client c0's).  The launch with c0 = 0
// writes out; a later one adds to it.  Returns cudaGetLastError() (0 =
// launched on `stream`).
extern "C" int agg_dequant_reduce_leaves(const int64_t* leaves,
                                         const int64_t* wires, int n,
                                         int64_t C_all, int64_t c0, int C,
                                         int dtype, const float* w,
                                         int64_t w_stride, void* stream) {
  const int64_t eb = elem_bytes(dtype);
  if (n <= 0 || n > kReduceLeaves || C <= 0 || C > kReduceClients ||
      n * C > kReduceEntries || c0 < 0 || c0 + C > C_all || eb == 0) {
    return (int)cudaErrorInvalidValue;
  }
  ReduceTable t = {};
  t.n = n;
  t.C = C;
  t.w = w;
  t.w_stride = w_stride;
  t.accumulate = c0 > 0;
  int64_t blocks = 0;
  for (int l = 0; l < n; ++l) {
    float* out = reinterpret_cast<float*>(leaves[2 * l]);
    const int64_t N = leaves[2 * l + 1];
    if (N <= 0) return (int)cudaErrorInvalidValue;
    bool vec = N % 4 == 0 && aligned(out, 16);
    for (int c = 0; c < C; ++c) {
      const int64_t* e = wires + 2 * (l * C_all + c0 + c);
      t.wire[l * C + c] = reinterpret_cast<const void*>(e[0]);
      t.scale[l * C + c] = reinterpret_cast<const float*>(e[1]);
      vec = vec && aligned(t.wire[l * C + c], 4 * eb);
    }
    t.out[l] = out;
    t.N[l] = N;
    t.vec |= (uint64_t)vec << l;
    t.first[l] = blocks;
    blocks += dense_blocks(N);
  }
  t.first[n] = blocks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return launch_reduce(t, dtype, static_cast<cudaStream_t>(stream));
}

// One fold launch over n <= kMaxLeaves leaves, with desc[4l .. 4l + 4) =
// (acc, wire, scale or 0, N): acc_l += (w * *scale_l) * wire_l.  Returns
// cudaGetLastError() (0 = launched on `stream`).
extern "C" int agg_dequant_acc_leaves(const int64_t* desc, int n, int dtype,
                                      float w, void* stream) {
  const int64_t eb = elem_bytes(dtype);
  if (n <= 0 || n > kMaxLeaves || eb == 0) return (int)cudaErrorInvalidValue;
  AccTable t = {};
  t.n = n;
  t.w = w;
  int64_t blocks = 0;
  for (int l = 0; l < n; ++l) {
    const int64_t* d = desc + 4 * l;
    if (d[3] <= 0) return (int)cudaErrorInvalidValue;
    t.acc[l] = reinterpret_cast<float*>(d[0]);
    t.wire[l] = reinterpret_cast<const void*>(d[1]);
    t.scale[l] = reinterpret_cast<const float*>(d[2]);
    t.N[l] = d[3];
    const bool vec = d[3] % 4 == 0 && aligned(t.acc[l], 16) &&
                     aligned(t.wire[l], 4 * eb);
    t.vec |= (uint64_t)vec << l;
    t.first[l] = blocks;
    blocks += dense_blocks(d[3]);
  }
  t.first[n] = blocks;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return launch_acc(t, dtype, static_cast<cudaStream_t>(stream));
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
