// Weighted FedAvg reduce of a round's client parameters, for Hopper
// (sm_90a).  One kernel over a table of leaves passed by value:
//
//   out_l[n] = sum_c w[c] * x_lc[n]      for every leaf l of the table
//
// x_lc is client c's fp32 parameter leaf l, read where it lies (no (C, N)
// stack); out_l is fp32; w holds the C fp32 weights on the device, already
// normalised by the caller (repro_torch/kernels/fedavg/ops.py).
//
// Replaces the TPU kernel src/repro/kernels/fedavg/kernel.py:24
// (fedavg_kernel, a pl.pallas_call over (C, block_n) VMEM tiles of one
// stacked leaf, with N zero-padded to a block multiple).
//
// What bounds it on the card: memory, and launches.  A round reads C*N
// fp32 values and writes N, against 2*C*N flops: at most half a flop per
// byte, far below the ~20 fp32 flops per byte where the H100's 67 TFLOP/s
// would start to matter next to its 3.35 TB/s.  The main path's
// discriminator has 12 leaves of 1 to 819,200 elements (1,030,913 in all,
// 24.7 MB to move at C = 5), ten of them under 5,000: one launch a leaf
// costs more in launches than in bytes, and a stack of every client's
// leaf before each launch moves the bytes twice more.
//
// What the design does about that:
//  * one launch covers a round's table of (leaf, client) pointers, passed
//    by value as a __grid_constant__ parameter (so a CUDA graph captures
//    it).  Leaf l owns blocks [first[l], first[l+1]), a prefix sum the
//    host computes from the sizes it knows; a block finds its leaf by a
//    search over that prefix, which every thread of it reads alike from
//    the constant bank, so every choice below is uniform in a block;
//  * one pass: each thread owns 4 columns of its leaf and runs one fmaf
//    chain over the clients in client order, starting from 0 (the order
//    of the single-stack kernel this one replaced, so the bits are its
//    bits): each x element is read once, each out element written once,
//    no atomics, no padding copy (the last block of a leaf masks itself);
//  * more clients than a 4 KB table holds (kClients a launch) take a
//    launch a chunk, in client order; a later chunk starts its chain from
//    out, so the result is bit for bit that of one chain;
//  * coalesced 16-byte loads where the leaf's N is a multiple of 4 and its
//    pointers are 16-byte aligned (chosen per leaf on the host into a bit
//    mask: the main path mixes N = 1, 1600 and 819,200); scalar loads
//    otherwise;
//  * the weights are read by pointer (no host synchronisation) through the
//    read-only cache, every thread of a block the same word, beside its
//    parameter loads: no barrier between the two.
// Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kBlockElems = 4 * kThreads;  // a block's elements
constexpr int kClients = 16;    // clients a launch
constexpr int kLeaves = 32;     // leaves a launch
constexpr int kEntries = 384;   // (leaf, client) pairs a launch

// the leaves of one launch
struct Table {
  const float* x[kEntries];     // leaf l, client c at l * C + c
  float* out[kLeaves];
  int64_t N[kLeaves];
  int64_t first[kLeaves + 1];   // leaf l's first block; first[n] = grid
  const float* w;               // the C weights of this launch's clients
  uint64_t vec;                 // bit l: leaf l takes the vector path
  int n, C;
  int accumulate;               // start from out: a later client chunk
};
static_assert(sizeof(Table) <= 4096, "kernel parameters over 4 KB");

__global__ void __launch_bounds__(kThreads)
fedavg_leaves(const __grid_constant__ Table t) {
  int l = 0;
  while (l + 1 < t.n && t.first[l + 1] <= (int64_t)blockIdx.x) ++l;
  const int C = t.C;
  const int64_t N = t.N[l];
  const int64_t n0 =
      ((int64_t)blockIdx.x - t.first[l]) * kBlockElems + 4 * threadIdx.x;
  if (n0 >= N) return;
  float* out = t.out[l] + n0;
  const float* const* x = t.x + l * C;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if ((t.vec >> l) & 1) {
    if (t.accumulate) {
      const float4 a = *reinterpret_cast<const float4*>(out);
      acc[0] = a.x; acc[1] = a.y; acc[2] = a.z; acc[3] = a.w;
    }
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x[c] + n0));
      const float k = __ldg(t.w + c);
      acc[0] = fmaf(k, v.x, acc[0]);
      acc[1] = fmaf(k, v.y, acc[1]);
      acc[2] = fmaf(k, v.z, acc[2]);
      acc[3] = fmaf(k, v.w, acc[3]);
    }
    *reinterpret_cast<float4*>(out) = make_float4(acc[0], acc[1], acc[2],
                                                  acc[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (t.accumulate && n0 + j < N) acc[j] = out[j];
    }
    for (int c = 0; c < C; ++c) {
      const float* xc = x[c] + n0;
      const float k = __ldg(t.w + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + j < N) acc[j] = fmaf(k, __ldg(xc + j), acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (n0 + j < N) out[j] = acc[j];
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One launch over a table built on the host
// (repro_torch/kernels/fedavg/kernel.py:build_tables): n <= kLeaves leaves
// of C <= kClients clients, n * C <= kEntries, laid out as int64 words
//
//   [x: n * C pointers, leaf l client c at l * C + c] [out: n pointers]
//   [N: n sizes, each >= 1] [first: n + 1 block offsets] [vec: 1 mask]
//
// w: the C clients' fp32 weights on the device; accumulate != 0 adds to
// out (a later client chunk).  The table is checked before the launch: the
// blocks must be each leaf's ceil(N / 1024) in order, and a leaf on the
// vector path must have N % 4 == 0 and 16-byte aligned pointers.  Returns
// cudaGetLastError() (0 = launched on `stream`), or cudaErrorInvalidValue
// for a table the kernel does not take.
extern "C" int fedavg_leaves_f32(const int64_t* table, int n, int C,
                                 int accumulate, const float* w,
                                 void* stream) {
  if (n <= 0 || n > kLeaves || C <= 0 || C > kClients || n * C > kEntries ||
      w == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Table t = {};
  t.n = n;
  t.C = C;
  t.w = w;
  t.accumulate = accumulate != 0;
  const int64_t* xs = table;
  const int64_t* outs = xs + (int64_t)n * C;
  const int64_t* Ns = outs + n;
  const int64_t* first = Ns + n;
  t.vec = (uint64_t)first[n + 1];
  if (first[0] != 0 || (t.vec >> n) != 0) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n; ++l) {
    const int64_t N = Ns[l];
    t.out[l] = reinterpret_cast<float*>(outs[l]);
    t.N[l] = N;
    t.first[l] = first[l];
    if (N <= 0 || t.out[l] == nullptr ||
        first[l + 1] - first[l] != (N + kBlockElems - 1) / kBlockElems) {
      return (int)cudaErrorInvalidValue;
    }
    bool vec_ok = N % 4 == 0 && aligned16(t.out[l]);
    for (int c = 0; c < C; ++c) {
      t.x[l * C + c] = reinterpret_cast<const float*>(xs[l * C + c]);
      if (t.x[l * C + c] == nullptr) return (int)cudaErrorInvalidValue;
      vec_ok = vec_ok && aligned16(t.x[l * C + c]);
    }
    if (((t.vec >> l) & 1) && !vec_ok) return (int)cudaErrorInvalidValue;
  }
  t.first[n] = first[n];
  if (first[n] > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fedavg_leaves<<<(unsigned)first[n], kThreads, 0, st>>>(t);
  return (int)cudaGetLastError();
}
