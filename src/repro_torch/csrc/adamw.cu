// AdamW over a whole parameter tree for Hopper (sm_90a): the global-norm
// clip and the update of every leaf, over a table of leaves passed by value.
//
//   scale  = min(max_norm / max(||g||, 1e-9), 1)           (under a clip)
//   g'     = g * scale, rounded to g's dtype
//   m'     = beta1 * m + (1 - beta1) * g'
//   v'     = beta2 * v + (1 - beta2) * g' * g'
//   p'     = p - lr * ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd * p)
//
// g, m, v, p are each fp32 or bf16 (computed in fp32); p', m', v' are fresh
// tensors of p's, m's and v's dtypes: the update is out of place, as the
// optimizer's contract says (callers pass views of stacked trees).
//
// Rows: a table entry carries a row r, and reads bc1[r], bc2[r], lr[r] and
// the clip scale[r].  One tree is one row.  The vectorized client programs
// update C clients' stacked trees in one call: each leaf (C, ...) gives C
// entries, client c's slice of it in row c, and under a clip each row's
// norm is taken over its own entries, as each client's update alone would
// take it.  bc1, bc2, the scales and a device lr are device words read by
// pointer, so no call synchronises with the host; a host lr comes by value.
//
// Replaces no TPU kernel: the JAX optimizer (src/repro/optim/optimizers.py)
// is plain JAX, which XLA fuses.  The port's eager form of it
// (repro_torch/kernels/adamw/ref.py and the global-norm clip of
// repro_torch/optim/optimizers.py) runs a dozen elementwise passes a leaf,
// each reading and writing whole fp32 tensors: about 172 B a parameter with
// the clip and the decay.
//
// What bounds it on the card: memory.  An element costs ~20 fp32 flops
// against 28 B (fp32: read g, m, v, p once; write p', m', v' once), plus a
// 4 B read of g for the norm under a clip: under one flop a byte, far below
// the ~20 a byte where the H100's 67 TFLOP/s would matter next to its
// 3.35 TB/s.  An OLMoE stage's 1.88 B parameters are 60.2 GB a step, 18.0 ms.
//
// What the design does about that:
//  * the norm pass (only under a clip): kNormBlocks blocks stride over the
//    table's 1024-element chunks, each thread summing its squares (rounded
//    in fp32, as the eager form squares) in double; a table's entries come
//    in rows that never decrease, so a block meets each row in one run of
//    chunks, and writes that row's partial to its own slot (rows it does not
//    meet get 0).  One block a row of adamw_clip_scale sums the row's slots
//    in a fixed order and writes its scale.  No atomics: the same bits on
//    every run and every card;
//  * the update pass: one kernel over the table.  A block strides over the
//    chunks, advancing its entry index as it goes (entry l owns chunks
//    [first[l], first[l+1]), a prefix sum the host computes), so every
//    choice below is uniform in a block.  A thread owns 4 elements of a
//    chunk: it reads g, m, v, p once, computes in registers in the eager
//    form's order of operations with __fmul_rn / __fadd_rn / __fdiv_rn /
//    __fsqrt_rn (nothing contracts into an FMA, so the result has the eager
//    form's bits), and writes p', m', v' once;
//  * 16-byte loads (8-byte for a bf16 tensor) where the entry's N is a
//    multiple of 4 and its seven addresses allow them (a per-entry mask the
//    host computes, as in fedavg.cu); scalar code elsewhere;
//  * the table lives in the kernel's parameters (__grid_constant__, so a
//    CUDA graph captures it): kLeaves entries a launch, a launch more for
//    each further kLeaves.
// Build without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kBlockElems = 4 * kThreads;  // a chunk: 4 elements a thread
constexpr int kLeaves = 48;                    // entries a launch
constexpr int kNormBlocks = 1024;              // partial sums a row a launch
constexpr int kFoldThreads = 1024;
constexpr int kMaxRows = 65535;                // rows fit the uint16 row

// kind bits: which of an entry's tensors are bf16 (the rest fp32); p' shares
// p's dtype, m' m's, v' v's
constexpr int kGBf16 = 1, kMBf16 = 2, kVBf16 = 4, kPBf16 = 8;

struct Table {
  const void* g[kLeaves];
  const void* m[kLeaves];
  const void* v[kLeaves];
  const void* p[kLeaves];
  void* po[kLeaves];
  void* mo[kLeaves];
  void* vo[kLeaves];
  int64_t N[kLeaves];
  int64_t first[kLeaves + 1];   // entry l's first chunk; first[n] = chunks
  uint8_t kind[kLeaves];
  uint16_t row[kLeaves];        // never decreasing along the table
  uint64_t vec;                 // bit l: entry l takes the vector path
  int n;
};

struct Hyper {
  const float* bc1;     // 1 - beta1^t, a word a row, on the device
  const float* bc2;     // 1 - beta2^t
  const float* lr_row;  // lr a row on the device, or null: lr below
  const float* scale;   // the clip scale a row, or null: no clip
  float lr, beta1, c1, beta2, c2, eps, wd;  // c1 = 1 - beta1, c2 = 1 - beta2
};
static_assert(sizeof(Table) + sizeof(Hyper) <= 4096,
              "kernel parameters over 4 KB");

__device__ __forceinline__ float bf2f(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// round to bf16 as PyTorch does on sm_80 and later (__float2bfloat16)
__device__ __forceinline__ uint16_t f2bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float round_bf16(float x) {
  return bf2f(f2bf(x));
}

__device__ __forceinline__ void load4(const void* base, int64_t i, bool bf,
                                      float (&x)[4]) {
  if (bf) {
    const uint2 u =
        __ldg(reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(base)
                                             + i));
    x[0] = bf2f(u.x & 0xffffu);
    x[1] = bf2f(u.x >> 16);
    x[2] = bf2f(u.y & 0xffffu);
    x[3] = bf2f(u.y >> 16);
  } else {
    const float4 f =
        __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(base)
                                              + i));
    x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
  }
}

__device__ __forceinline__ void store4(void* base, int64_t i, bool bf,
                                       const float (&x)[4]) {
  if (bf) {
    uint2 u;
    u.x = (uint32_t)f2bf(x[0]) | ((uint32_t)f2bf(x[1]) << 16);
    u.y = (uint32_t)f2bf(x[2]) | ((uint32_t)f2bf(x[3]) << 16);
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(base) + i) = u;
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + i) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

__device__ __forceinline__ float load1(const void* base, int64_t i, bool bf) {
  return bf ? bf2f(__ldg(static_cast<const uint16_t*>(base) + i))
            : __ldg(static_cast<const float*>(base) + i);
}

__device__ __forceinline__ void store1(void* base, int64_t i, bool bf,
                                       float x) {
  if (bf) {
    static_cast<uint16_t*>(base)[i] = f2bf(x);
  } else {
    static_cast<float*>(base)[i] = x;
  }
}

// a row's words: bias corrections, lr and clip scale
struct Row {
  float bc1, bc2, lr, scale;
};

__device__ __forceinline__ Row row_words(const Hyper& h, int r) {
  return {__ldg(h.bc1 + r), __ldg(h.bc2 + r),
          h.lr_row != nullptr ? __ldg(h.lr_row + r) : h.lr,
          h.scale != nullptr ? __ldg(h.scale + r) : 1.f};
}

// One element, in the eager form's order of operations, each step rounded
// once.  Returns p'; m and v become m' and v' in fp32 (the caller rounds
// them to their dtypes).
__device__ __forceinline__ float adamw_elem(float g, float& m, float& v,
                                            float p, const Hyper& h,
                                            bool clip, bool g_bf16,
                                            const Row& w) {
  if (clip) {
    g = __fmul_rn(g, w.scale);
    if (g_bf16) g = round_bf16(g);
  }
  m = __fadd_rn(__fmul_rn(h.beta1, m), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(h.beta2, v), __fmul_rn(__fmul_rn(h.c2, g), g));
  const float mh = __fdiv_rn(m, w.bc1);
  const float vh = __fdiv_rn(v, w.bc2);
  float delta = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps));
  if (h.wd != 0.f) delta = __fadd_rn(delta, __fmul_rn(h.wd, p));
  return __fsub_rn(p, __fmul_rn(w.lr, delta));
}

__global__ void __launch_bounds__(kThreads)
adamw_update(const __grid_constant__ Table t, const Hyper h) {
  const bool clip = h.scale != nullptr;
  const int64_t chunks = t.first[t.n];
  int l = 0;
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (t.first[l + 1] <= c) ++l;
    const int64_t N = t.N[l];
    const int64_t i = (c - t.first[l]) * kBlockElems + 4 * threadIdx.x;
    if (i >= N) continue;
    const Row w = row_words(h, t.row[l]);
    const int kind = t.kind[l];
    const bool gb = kind & kGBf16, mb = kind & kMBf16, vb = kind & kVBf16,
               pb = kind & kPBf16;
    if ((t.vec >> l) & 1) {
      float g[4], m[4], v[4], p[4];
      load4(t.g[l], i, gb, g);
      load4(t.m[l], i, mb, m);
      load4(t.v[l], i, vb, v);
      load4(t.p[l], i, pb, p);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = adamw_elem(g[j], m[j], v[j], p[j], h, clip, gb, w);
      }
      store4(t.po[l], i, pb, p);
      store4(t.mo[l], i, mb, m);
      store4(t.vo[l], i, vb, v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t k = i + j;
        if (k < N) {
          float m = load1(t.m[l], k, mb), v = load1(t.v[l], k, vb);
          const float p = adamw_elem(load1(t.g[l], k, gb), m, v,
                                     load1(t.p[l], k, pb), h, clip, gb, w);
          store1(t.po[l], k, pb, p);
          store1(t.mo[l], k, mb, m);
          store1(t.vo[l], k, vb, v);
        }
      }
    }
  }
}

// sum over a block of one double a thread, in a fixed order; the result in
// thread 0.  Every thread of the block calls it; it may be called again.
template <int kBlock>
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warps[kBlock / 32];
  __syncthreads();  // the previous call's reads of warps are done
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x < 32) {
    x = threadIdx.x < kBlock / 32 ? warps[threadIdx.x] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  return x;
}

// each block's sum of the table's squared gradients, a row at a time, into
// partials[r * gridDim.x + blockIdx.x] for every row r < rows (0 for a row
// the block meets no chunk of)
__global__ void __launch_bounds__(kThreads)
adamw_sumsq(const __grid_constant__ Table t, int rows, double* partials) {
  const int64_t chunks = t.first[t.n];
  double acc = 0.0;
  int l = 0, r = 0;  // r: the row being summed; the rows below it written
  auto flush = [&](int next) {
    acc = block_sum<kThreads>(acc);
    if (threadIdx.x == 0) {
      partials[(int64_t)r * gridDim.x + blockIdx.x] = acc;
      for (int k = r + 1; k < next; ++k) {
        partials[(int64_t)k * gridDim.x + blockIdx.x] = 0.0;
      }
    }
    acc = 0.0;
    r = next;
  };
  for (int64_t c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (t.first[l + 1] <= c) ++l;
    if (t.row[l] != r) flush(t.row[l]);  // uniform in the block
    const int64_t N = t.N[l];
    const int64_t i = (c - t.first[l]) * kBlockElems + 4 * threadIdx.x;
    if (i >= N) continue;
    const bool gb = t.kind[l] & kGBf16;
    if ((t.vec >> l) & 1) {
      float g[4];
      load4(t.g[l], i, gb, g);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc += (double)__fmul_rn(g[j], g[j]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j < N) {
          const float g = load1(t.g[l], i + j, gb);
          acc += (double)__fmul_rn(g, g);
        }
      }
    }
  }
  flush(rows);
}

// block r: scale[r] = min(max_norm / max(sqrt(row r's sum), 1e-9), 1), NaN
// kept, from row r's slots of `launches` norm launches (launch k's partials
// at k * rows * kNormBlocks), added in a fixed order; in the eager form's
// operations: the sum rounded to fp32, sqrt, clamp, reciprocal times
// max_norm (Python's float / tensor), clamp
__global__ void __launch_bounds__(kFoldThreads)
adamw_clip_scale_kernel(const double* partials, int launches, int rows,
                        float max_norm, float* scale) {
  const int r = blockIdx.x;
  const int count = launches * kNormBlocks;
  double acc = 0.0;
  for (int j = threadIdx.x; j < count; j += kFoldThreads) {
    const int k = j / kNormBlocks, b = j % kNormBlocks;
    acc += partials[((int64_t)k * rows + r) * kNormBlocks + b];
  }
  acc = block_sum<kFoldThreads>(acc);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn((float)acc);
    const float floor = norm < 1e-9f ? 1e-9f : norm;
    const float s = __fmul_rn(__frcp_rn(floor), max_norm);
    scale[r] = s > 1.f ? 1.f : s;
  }
}

bool aligned(int64_t p, bool bf) { return p % (bf ? 8 : 16) == 0; }

// The table of one launch, checked, from the host's int64 words (see
// adamw_update_leaves); false for a table the kernels do not take.
bool unpack(const int64_t* table, int n, int rows, Table* t) {
  if (n <= 0 || n > kLeaves || rows <= 0 || rows > kMaxRows) return false;
  *t = Table{};
  t->n = n;
  const int64_t* w = table;
  const int64_t* Ns = w + 7 * (int64_t)n;
  const int64_t* first = Ns + n;
  const int64_t* kinds = first + n + 1;
  const int64_t* row = kinds + n;
  t->vec = (uint64_t)row[n];
  if (first[0] != 0 || (t->vec >> n) != 0) return false;
  for (int l = 0; l < n; ++l) {
    const int64_t N = Ns[l], kind = kinds[l];
    if (N <= 0 || kind < 0 || kind > 15 ||
        first[l + 1] - first[l] != (N + kBlockElems - 1) / kBlockElems ||
        row[l] < (l > 0 ? row[l - 1] : 0) || row[l] >= rows) {
      return false;
    }
    const bool bf[7] = {(kind & kGBf16) != 0, (kind & kMBf16) != 0,
                        (kind & kVBf16) != 0, (kind & kPBf16) != 0,
                        (kind & kPBf16) != 0, (kind & kMBf16) != 0,
                        (kind & kVBf16) != 0};
    bool vec_ok = N % 4 == 0;
    for (int k = 0; k < 7; ++k) {
      const int64_t a = w[k * (int64_t)n + l];
      if (a == 0) return false;
      vec_ok = vec_ok && aligned(a, bf[k]);
    }
    if (((t->vec >> l) & 1) && !vec_ok) return false;
    t->g[l] = reinterpret_cast<const void*>(w[l]);
    t->m[l] = reinterpret_cast<const void*>(w[n + l]);
    t->v[l] = reinterpret_cast<const void*>(w[2 * n + l]);
    t->p[l] = reinterpret_cast<const void*>(w[3 * n + l]);
    t->po[l] = reinterpret_cast<void*>(w[4 * n + l]);
    t->mo[l] = reinterpret_cast<void*>(w[5 * n + l]);
    t->vo[l] = reinterpret_cast<void*>(w[6 * n + l]);
    t->N[l] = N;
    t->first[l] = first[l];
    t->kind[l] = (uint8_t)kind;
    t->row[l] = (uint16_t)row[l];
  }
  t->first[n] = first[n];
  return true;
}

// blocks of adamw_update resident on the current device at once
int update_grid() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adamw_update,
                                                      kThreads, 0) !=
            cudaSuccess) {
      return 0;
    }
    cached[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cached[dev];
}

}  // namespace

// One update launch over a table built on the host
// (repro_torch/kernels/adamw/kernel.py:build_tables): n <= kLeaves entries,
// laid out as int64 words
//
//   [g: n] [m: n] [v: n] [p: n] [p': n] [m': n] [v': n]   (addresses)
//   [N: n sizes, each >= 1] [first: n + 1 chunk offsets] [kind: n]
//   [row: n, never decreasing, each < rows] [vec]
//
// bc1, bc2: `rows` device fp32 words; lr_row: `rows` device fp32 words, or
// null to take `lr` for every row; scale: the clip scales' `rows` device
// words, or null for no clip.  The table is checked before the launch: each
// entry's chunks must be its ceil(N / 1024) in order, and an entry on the
// vector path must have N % 4 == 0 and addresses aligned to 4 elements.
// Returns cudaGetLastError() (0 = launched on `stream`), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int adamw_update_leaves(const int64_t* table, int n, int rows,
                                   const float* bc1, const float* bc2,
                                   const float* lr_row, const float* scale,
                                   float lr, float beta1, float c1,
                                   float beta2, float c2, float eps, float wd,
                                   void* stream) {
  Table t;
  if (bc1 == nullptr || bc2 == nullptr || !unpack(table, n, rows, &t)) {
    return (int)cudaErrorInvalidValue;
  }
  const Hyper h = {bc1, bc2, lr_row, scale, lr, beta1, c1, beta2, c2, eps,
                   wd};
  const int64_t chunks = t.first[n];
  const int resident = update_grid();
  if (resident <= 0) return (int)cudaErrorInvalidValue;
  const int64_t grid = chunks < resident ? chunks : resident;
  adamw_update<<<(unsigned)grid, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(t, h);
  return (int)cudaGetLastError();
}

// The norm pass of one table (same layout; only g, N, first, kind, row and
// vec are read): writes rows x kNormBlocks partial sums of squares at
// `partials`, row r's at r * kNormBlocks.
extern "C" int adamw_sumsq_leaves(const int64_t* table, int n, int rows,
                                  double* partials, void* stream) {
  Table t;
  if (partials == nullptr || !unpack(table, n, rows, &t)) {
    return (int)cudaErrorInvalidValue;
  }
  adamw_sumsq<<<kNormBlocks, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(t, rows, partials);
  return (int)cudaGetLastError();
}

// The clip scales of `rows` rows from `launches` norm launches' partial
// sums (launch k's at partials + k * rows * kNormBlocks), one block a row:
// written to the `rows` device words at `scale`.
extern "C" int adamw_clip_scale(const double* partials, int launches,
                                int rows, float max_norm, float* scale,
                                void* stream) {
  if (partials == nullptr || scale == nullptr || launches <= 0 ||
      rows <= 0 || rows > kMaxRows) {
    return (int)cudaErrorInvalidValue;
  }
  adamw_clip_scale_kernel<<<rows, kFoldThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      partials, launches, rows, max_norm, scale);
  return (int)cudaGetLastError();
}
