// Flash attention (online softmax over kv blocks) for Hopper (sm_90a).
//
//   o[b,h,i] = sum_j softmax_j(scale * q[b,h,i] . k[b,g(h),j] + mask) v[b,g(h),j]
//
// q: (B, H, Sq, D), k/v: (B, Hkv, Sk, D), o like q, each addressed by its
// own (b, h, s) element strides with d contiguous, so the caller's model
// layout (B, S, H, D) is read and written in place, with no transpose.
// fp32 or bf16 in, fp32 math, o in q's dtype.  GQA: q head h reads kv head
// h / (H / Hkv); K and V are never repeated in memory.  Masks: causal
// (q_offset + i >= j), a sliding window (q_offset + i - j < window) and a
// valid length (j < seq_k_valid); a masked logit is the finite -1e30 of
// the reference, so a row with no unmasked key averages v uniformly over
// all Sk keys, as the plain version does.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:91
// (flash_attention_kernel, a pl.pallas_call over a (B, H, q block, kv
// block) grid whose innermost kv axis runs in order and carries the
// running max, denominator and accumulator in VMEM scratch).
//
// What bounds it on the card: operations.  At the main path's shape (B 2,
// H 40, Hkv 8, S 2048, D 128, causal) the work is about 8.6e10 flops
// against about 101 MB of q, k, v and o: some 850 flops a byte, above the
// H100's ~295 bf16 tensor-core flops per byte of HBM, so the bound is the
// tensor cores' 989 TFLOP/s (87 us), not the 3.35 TB/s (30 us).
//
// What this first design does about that: it keeps every score and
// probability out of device memory (one read of q, k, v, one write of o)
// and skips fully masked kv blocks, but computes on the CUDA cores in
// fp32, not the tensor cores, so it sits far above the bound; wgmma and
// TMA are for a later change.
//  * one CTA per (q block of 64 rows, head, batch), 256 threads: thread
//    (r, c) owns row r and the score columns c, c+4, ..., c+60 of each kv
//    block, and the output columns c, c+4, ... of row r;
//  * Q (scaled later, as the reference), K and V tiles staged in shared
//    memory as fp32: Q and K with a padded row stride (D + 1) so the
//    threads of a warp hit distinct banks; above 48 KB (D >= 64) this is
//    dynamic shared memory with the cudaFuncSetAttribute opt-in;
//  * the row max and the row sum go between the row's 4 threads, which
//    sit in one warp, by shuffles; the probabilities go through a shared
//    64 x 65 tile to the P.V product;
//  * the kv loop runs only over the blocks some valid row can see: below
//    the diagonal (first_k <= last_q), inside the window (last_k >=
//    first_q - window + 1) and under the valid length.  Where a row of the
//    block can have no key at all, every block runs, so that row gets the
//    reference's uniform average;
//  * ragged edges are masked by the real lengths: rows past Sq are not
//    written, keys past Sk do not exist (probability 0); no padded copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;             // kBlockQ rows x 4 threads a row
constexpr int kCols = kBlockK / 4;        // score columns a thread owns
constexpr int kPStride = kBlockK + 1;
constexpr float kNegInf = -1e30f;         // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {            // element strides of (b, h, s); d is 1
  int64_t b, h, s;
};

struct Params {
  int H, Hkv, Sq, Sk, Skv, causal, window, q_offset;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBlockQ * (D + 1) + kBlockK * D +
                          kBlockQ * kPStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
          Strides vs, Strides os, Params p) {
  constexpr int QS = D + 1;               // padded row stride of Q and K
  constexpr int kAcc = D / 4;             // output columns a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;                       // kBlockQ x QS
  float* Ks = Qs + kBlockQ * QS;          // kBlockK x QS
  float* Vs = Ks + kBlockK * QS;          // kBlockK x D
  float* Ps = Vs + kBlockK * D;           // kBlockQ x kPStride

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int cg = tid & 3;
  const int nq = min(kBlockQ, p.Sq - q0);  // valid rows of this block

  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + hk * ks.h;
  const T* vp = v + b * vs.b + hk * vs.h;
  T* op = o + b * os.b + h * os.h;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    Qs[r * QS + d] = r < nq ? to_f32(qp[(int64_t)(q0 + r) * qs.s + d]) : 0.f;
  }

  // the kv blocks some valid row of this q block can see
  const int first_q = p.q_offset + q0;
  const int last_q = first_q + nq - 1;
  const int nkb = (p.Sk + kBlockK - 1) / kBlockK;
  int kb_lo = 0, kb_hi = nkb;
  const bool row_may_be_empty =
      p.Skv <= 0 ||
      (p.causal && p.window > 0 && last_q - p.window + 1 > p.Skv - 1);
  if (!row_may_be_empty) {
    int k_end = p.Skv;                     // keys [0, k_end) can be unmasked
    if (p.causal) {
      k_end = min(k_end, last_q + 1);
      if (p.window > 0) kb_lo = max(0, first_q - p.window + 1) / kBlockK;
    }
    kb_hi = min(nkb, (k_end + kBlockK - 1) / kBlockK);
  }

  float m_i = kNegInf, l_i = 0.f;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const int qpos = first_q + row;
  const float* qrow = Qs + row * QS;
  float* prow = Ps + row * kPStride;

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();                       // last block's K, V, P are read
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const int kk = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kk < p.Sk) {
        kx = to_f32(kp[(int64_t)kk * ks.s + d]);
        vx = to_f32(vp[(int64_t)kk * vs.s + d]);
      }
      Ks[r * QS + d] = kx;
      Vs[r * D + d] = vx;
    }
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        s[j] = fmaf(qd, Ks[(cg + 4 * j) * QS + d], s[j]);
    }

    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kpos = k0 + cg + 4 * j;
      float x;
      if (kpos >= p.Sk) {
        x = -INFINITY;                     // no such key: probability 0
      } else {
        bool ok = kpos < p.Skv;
        if (p.causal) {
          ok = ok && qpos >= kpos;
          if (p.window > 0) ok = ok && (qpos - kpos) < p.window;
        }
        x = ok ? s[j] * p.scale : kNegInf;
      }
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_i, mx);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s[j] = expf(s[j] - m_new);
      rs += s[j];
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    const float corr = expf(m_i - m_new);
    l_i = l_i * corr + rs;
    m_i = m_new;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] *= corr;

#pragma unroll
    for (int j = 0; j < kCols; ++j) prow[cg + 4 * j] = s[j];
    __syncwarp();                          // the row's 4 threads share a warp
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float pk = prow[kk];
      const float* vr = Vs + kk * D;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = fmaf(pk, vr[cg + 4 * i], acc[i]);
    }
  }

  if (row < nq) {
    const float denom = fmaxf(l_i, 1e-30f);
    T* orow = op + (int64_t)(q0 + row) * os.s;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) orow[cg + 4 * i] = from_f32<T>(acc[i] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, Strides os, int B, Params p,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool opted_in = false;            // once per instantiation
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, B);
  flash_fwd<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               Strides qs, Strides ks, Strides vs, Strides os, int B,
               Params p, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, qs, ks, vs, os, B, p, s);
    case 64: return launch<T, 64>(q, k, v, o, qs, ks, vs, os, B, p, s);
    case 128: return launch<T, 128>(q, k, v, o, qs, ks, vs, os, B, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  D: 32, 64 or 128.  Strides are in
// elements, (b, h, s) for each of q, k, v, o.  Launches on `stream`;
// returns cudaGetLastError() (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int D,
    int B, int H, int Hkv, int Sq, int Sk, int Skv, int64_t qsb, int64_t qsh,
    int64_t qss, int64_t ksb, int64_t ksh, int64_t kss, int64_t vsb,
    int64_t vsh, int64_t vss, int64_t osb, int64_t osh, int64_t oss,
    int causal, int window, int q_offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      q_offset < 0 || window < 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  const Params p{H, Hkv, Sq, Sk, Skv, causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(D, q, k, v, o, qs, ks, vs, os, B, p, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, qs, ks, vs, os, B, p, s);
  return (int)cudaErrorInvalidValue;
}
