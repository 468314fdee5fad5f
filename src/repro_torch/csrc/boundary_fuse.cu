// Fused split-boundary stage: codec quantize-dequantize, per-example clip
// and Gaussian noise, for Hopper (sm_90a).
//
//   q[b, n]  = qdq(x[b, n])        none | fp16 | int8 (one amax over the
//                                  whole tensor, or one a row)
//   s[b]     = min(1, clip / max(||q[b, :]||_2, 1e-12))
//   out[b,n] = q[b, n] * s[b] + noise_scale * z[b, n]
//
//   x, z, out: (B, N) row-major fp32.
//
// Replaces the TPU kernel src/repro/kernels/boundary_fuse/kernel.py:84
// (boundary_fuse_kernel / _make_fuse_kernel, a 2-phase — 3 for int8 —
// sequential pl.pallas_call grid carrying the amax in a (1, 1) and the
// per-example squared norms in a (B, 1) VMEM scratch).  The per-row amax
// mode is what jax.vmap of that kernel over (1, N) rows computes.
//
// What bounds it on the card: memory and the launch.  On the main path a
// boundary tensor is (256, 12544), (256, 6272) or (256, 4096) fp32, at
// most 12.8 MB, at a few flops per element; it fits the 50 MB L2.  The
// least traffic is one read of x, one read of z and one write of out.
//
// What the design does about that, in one launch for every codec and mode:
//  * one CTA a row, and the row stays on chip: at the start one thread
//    issues two TMA bulk copies (cp.async.bulk, completion on an mbarrier)
//    that bring the row of x and the row of z into shared memory, so x
//    is read from device memory once and all of a row's loads are in
//    flight at once.  The amax, the squared norm (a fixed-order block
//    reduction: warp shuffles, then shared memory) and the emit pass all
//    read the on-chip copy; out is written with 16-byte stores;
//  * rows start at b * N * 4 bytes, not 16-byte aligned when N is not a
//    multiple of 4, and a bulk copy needs 16-byte-aligned addresses and
//    sizes: each copy takes the aligned range that encloses the row (at
//    most 3 elements either side, in the same 16-byte block as an element
//    of the tensor, so never outside its pages) and the passes mask the
//    ends.  When x, z and out sit at the same offset in their 16-byte
//    blocks a thread takes whole 16-byte words; otherwise single elements;
//  * int8 with the tensor-wide amax needs every element's magnitude before
//    any is rounded: each CTA folds the maximum of its rows into one word
//    by an integer atomicMax on the bits of |x| (max is exact in any
//    order, so the result does not depend on scheduling), a grid-wide
//    barrier follows in the same launch, and every CTA then reads the
//    word.  The z row is being copied in while the CTA waits there.  That
//    grid is persistent: its size is the number of CTAs that can be
//    resident at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
//    SMs), and when B is larger each CTA walks rows b, b + grid, ...; it
//    holds its first row on chip and reads the others from L2/device
//    memory;
//  * rows longer than kOnChipMax elements (not on the main path) take the
//    same kernel with nothing held on chip: each pass reads the row again,
//    mostly from L2.
// The grid-wide barrier: one arrival word in the module's device memory,
// counted the way cooperative groups count (CTA 0 adds 2^31 - (G - 1), the
// others 1, so the top bit flips when the last CTA arrives and the low
// bits come back to where they were: the next launch finds it ready, and
// a CUDA graph can replay the launch).  The launch carries the cooperative
// attribute, so the CUDA runtime refuses it (an error, never a hang) unless
// all G CTAs can be resident together; with G no larger than what fits on
// the idle card, CTAs that another stream's kernels keep out start as those
// kernels finish, while the CTAs already in spin.  One barrier word a
// device: launches of this mode must not run concurrently on two streams
// of one device (the port runs them on one stream).
// Semantics matched bit for bit with the reference before the clip:
//  * int8: s = amax > 0 ? amax / 127 : 1;  q = clamp(rint(x / s), -127, 127)
//    * s, with a true IEEE division and round-half-even (rintf);
//  * fp16: __half2float(__float2half_rn(x)).
// NaN propagates as in the reference (jnp.max, jnp.clip, jnp.maximum): a
// NaN makes the amax NaN, so the int8 scale is 1.0 (NaN > 0 is false) for
// the whole tensor, or in the row mode for the NaN's row only; a NaN
// element stays NaN through the qdq; a NaN in a row makes its norm and
// clip scale NaN, so the whole row comes out NaN.  fmaxf and fminf drop a
// NaN operand, so they never see one here.
// Build without --use_fast_math: the division, sqrtf and rintf stay IEEE.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kOnChipMax = 16384;  // longest row held on chip: 64 KB

enum Codec { kNone = 0, kFp16 = 1, kInt8 = 2 };
enum AmaxMode { kTensor = 0, kRow = 1 };

// the tensor-amax barrier and maxima, zero when the module loads.  Each
// barrier flips the top bit of g_arrive (its phase) and leaves the low bits
// as they were.  A launch folds its CTAs' maxima into g_amax[phase] (as
// the bits of |x|, which order as unsigned integers, a NaN above +inf) and
// zeroes g_amax[phase ^ 1], the next launch's slot.
__device__ unsigned int g_arrive;
__device__ unsigned int g_amax[2];

// max that returns NaN when either operand is NaN (fmaxf returns the other)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float block_reduce(float v, float* red,
                                              bool is_max) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? nan_max(v, w) : v + w;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = 0.f;  // the identity of both: maxima here are of |x|
  for (int i = 0; i < kThreads / 32; ++i) {
    v = is_max ? nan_max(v, red[i]) : v + red[i];
  }
  return v;  // the same value in every thread
}

template <int kCodec>
__device__ __forceinline__ float qdq(float v, float s) {
  if constexpr (kCodec == kFp16) {
    return __half2float(__float2half_rn(v));
  } else if constexpr (kCodec == kInt8) {
    const float r = rintf(v / s);
    return (r != r ? r : fminf(fmaxf(r, -127.f), 127.f)) * s;
  } else {
    return v;
  }
}

// p's element offset in its 16-byte block (0..3)
__device__ __forceinline__ int block_off(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
}

// word v of the 16-byte words that cover a row p[0 .. N) (generic address:
// shared or global); elements outside the row, in the first and last
// words, are set to 0 when `mask`
__device__ __forceinline__ float4 row_word(const float* p, int h, int64_t v,
                                           int64_t N, bool mask) {
  float4 f = reinterpret_cast<const float4*>(p - h)[v];
  const int64_t j = 4 * v - h;
  if (mask && (j < 0 || j + 4 > N)) {
    f.x = (j >= 0 && j < N) ? f.x : 0.f;
    f.y = (j + 1 >= 0 && j + 1 < N) ? f.y : 0.f;
    f.z = (j + 2 >= 0 && j + 2 < N) ? f.z : 0.f;
    f.w = (j + 3 >= 0 && j + 3 < N) ? f.w : 0.f;
  }
  return f;
}

// this thread's share of max |p[j]|
__device__ __forceinline__ float row_absmax(const float* p, int64_t N) {
  const int h = block_off(p);
  const int64_t words = (h + N + 3) / 4;
  float m = 0.f;
  for (int64_t v = threadIdx.x; v < words; v += kThreads) {
    const float4 f = row_word(p, h, v, N, true);
    m = nan_max(nan_max(m, fabsf(f.x)), nan_max(fabsf(f.y), fabsf(f.z)));
    m = nan_max(m, fabsf(f.w));
  }
  return m;
}

// this thread's share of sum_j qdq(p[j])^2, in a fixed order (a masked
// element is 0, and qdq(0) = 0 for every codec)
template <int kCodec>
__device__ __forceinline__ float row_sumsq(const float* p, int64_t N,
                                           float s) {
  const int h = block_off(p);
  const int64_t words = (h + N + 3) / 4;
  float ss = 0.f;
  for (int64_t v = threadIdx.x; v < words; v += kThreads) {
    const float4 f = row_word(p, h, v, N, true);
    const float a = qdq<kCodec>(f.x, s), b = qdq<kCodec>(f.y, s);
    const float c = qdq<kCodec>(f.z, s), d = qdq<kCodec>(f.w, s);
    ss = fmaf(a, a, ss);
    ss = fmaf(b, b, ss);
    ss = fmaf(c, c, ss);
    ss = fmaf(d, d, ss);
  }
  return ss;
}

// o[j] = qdq(px[j]) * scale + noise_scale * pz[j]
template <int kCodec>
__device__ __forceinline__ void row_emit(const float* px, const float* pz,
                                         float* o, int64_t N, float s,
                                         float scale, float noise_scale) {
  const int h = block_off(o);
  if (block_off(px) == h && block_off(pz) == h) {
    const int64_t words = (h + N + 3) / 4;
    float4* ow = reinterpret_cast<float4*>(o - h);
    for (int64_t v = threadIdx.x; v < words; v += kThreads) {
      const float4 f = row_word(px, h, v, N, false);
      const float4 g = row_word(pz, h, v, N, false);
      float4 r;
      r.x = fmaf(noise_scale, g.x, qdq<kCodec>(f.x, s) * scale);
      r.y = fmaf(noise_scale, g.y, qdq<kCodec>(f.y, s) * scale);
      r.z = fmaf(noise_scale, g.z, qdq<kCodec>(f.z, s) * scale);
      r.w = fmaf(noise_scale, g.w, qdq<kCodec>(f.w, s) * scale);
      const int64_t j = 4 * v - h;
      if (j >= 0 && j + 4 <= N) {
        ow[v] = r;
      } else {  // the row's first or last word: only its own elements
        if (j >= 0 && j < N) o[j] = r.x;
        if (j + 1 >= 0 && j + 1 < N) o[j + 1] = r.y;
        if (j + 2 >= 0 && j + 2 < N) o[j + 2] = r.z;
        if (j + 3 >= 0 && j + 3 < N) o[j + 3] = r.w;
      }
    }
  } else {
    for (int64_t j = threadIdx.x; j < N; j += kThreads) {
      o[j] = fmaf(noise_scale, pz[j], qdq<kCodec>(px[j], s) * scale);
    }
  }
}

// the enclosing 16-byte-aligned range of p[0 .. N): start and bytes
__device__ __forceinline__ void enclosing(const float* p, int64_t N,
                                          const float** start,
                                          uint32_t* bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t lo = a & ~uintptr_t(15);
  const uintptr_t hi = (a + 4 * N + 15) & ~uintptr_t(15);
  *start = reinterpret_cast<const float*>(lo);
  *bytes = (uint32_t)(hi - lo);
}

// every CTA of the grid arrives before any leaves (see the header)
__device__ __forceinline__ void grid_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(&g_arrive, add);
    unsigned int now;
    do {
      __nanosleep(32);  // fewer polls of the word the arrivals update
      asm volatile("ld.acquire.gpu.u32 %0, [%1];\n"
                   : "=r"(now) : "l"(&g_arrive) : "memory");
    } while (((old ^ now) & 0x80000000u) == 0);
    __threadfence();
  }
  __syncthreads();
}

// floats of one on-chip row buffer: the row and its alignment slack
__host__ __device__ __forceinline__ int64_t row_buf(int64_t N) {
  return (N + 6 + 3) & ~int64_t(3);
}

template <int kCodec, int kAmax>
__global__ void __launch_bounds__(kThreads)
fuse(const float* __restrict__ x, const float* __restrict__ z,
     float* __restrict__ out, int64_t B, int64_t N, int held, float clip,
     float noise_scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[32];
  __shared__ __align__(8) uint64_t bars[2];
  constexpr bool kTensorAmax = kCodec == kInt8 && kAmax == kTensor;
  const int64_t b0 = blockIdx.x;
  float* bx = smem;
  float* bz = smem + row_buf(N);
  const uint32_t bar_x = smem_u32(&bars[0]), bar_z = smem_u32(&bars[1]);
  int hx = 0, hz = 0;
  if (held) {  // the same in every CTA
    hx = block_off(x + b0 * N);
    hz = block_off(z + b0 * N);
    if (threadIdx.x == 0) {
      mbar_init(bar_x, 1);
      mbar_init(bar_z, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const float* start;
      uint32_t bytes;
      enclosing(x + b0 * N, N, &start, &bytes);
      mbar_expect_tx(bar_x, bytes);
      bulk_load(smem_u32(bx), start, bytes, bar_x);
      enclosing(z + b0 * N, N, &start, &bytes);
      mbar_expect_tx(bar_z, bytes);
      bulk_load(smem_u32(bz), start, bytes, bar_z);
    }
    __syncthreads();  // the barriers are initialised before anyone waits
  }

  float s = 1.f;
  if constexpr (kTensorAmax) {
    float m = 0.f;
    for (int64_t b = b0; b < B; b += gridDim.x) {
      if (held && b == b0) {
        mbar_wait(bar_x, 0);
        m = nan_max(m, row_absmax(bx + hx, N));
      } else {
        m = nan_max(m, row_absmax(x + b * N, N));
      }
    }
    m = block_reduce(m, red, true);
    unsigned int phase = 0;
    if (threadIdx.x == 0) {
      // this launch's phase: the top bit cannot flip before this CTA
      // arrives at the barrier
      phase = *reinterpret_cast<volatile unsigned int*>(&g_arrive) >> 31;
      atomicMax(&g_amax[phase], __float_as_uint(m));  // m is +0.. or +NaN
      if (blockIdx.x == 0) g_amax[phase ^ 1] = 0u;
    }
    grid_barrier();
    if (threadIdx.x == 0) red[0] = __uint_as_float(__ldcg(&g_amax[phase]));
    __syncthreads();
    const float a = red[0];
    s = a > 0.f ? a / 127.f : 1.f;
  }

  for (int64_t b = b0; b < B; b += gridDim.x) {
    const bool on_chip = held && b == b0;
    const float* px = on_chip ? bx + hx : x + b * N;
    const float* pz = on_chip ? bz + hz : z + b * N;
    if (on_chip) mbar_wait(bar_x, 0);
    float sr = s;
    if constexpr (kCodec == kInt8 && kAmax == kRow) {
      const float m = block_reduce(row_absmax(px, N), red, true);
      sr = m > 0.f ? m / 127.f : 1.f;
    }
    const float norm =
        sqrtf(block_reduce(row_sumsq<kCodec>(px, N, sr), red, false));
    const float scale =
        norm != norm ? norm : fminf(1.f, clip / fmaxf(norm, 1e-12f));
    if (on_chip) mbar_wait(bar_z, 0);
    row_emit<kCodec>(px, pz, out + b * N, N, sr, scale, noise_scale);
  }
}

template <int kCodec, int kAmax>
int launch(const float* x, const float* z, float* out, int64_t B, int64_t N,
           float clip, float noise_scale, cudaStream_t st) {
  auto kernel = fuse<kCodec, kAmax>;
  const int held = N <= kOnChipMax;
  const size_t smem = held ? 2 * sizeof(float) * (size_t)row_buf(N) : 0;
  int err;
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  int64_t grid = B;
  if (kCodec == kInt8 && kAmax == kTensor) {
    // a persistent grid of the CTAs the card holds at once; the launch is
    // refused unless all of them are resident together
    int dev = 0, per_sm = 0, sms = 0;
    err = (int)cudaGetDevice(&dev);
    if (err == 0) {
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, smem);
    }
    if (err == 0) {
      err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev);
    }
    if (err != 0) return err;
    const int64_t resident = (int64_t)per_sm * sms;
    if (resident <= 0) return (int)cudaErrorInvalidConfiguration;
    grid = grid < resident ? grid : resident;
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  err = (int)cudaLaunchKernelEx(&cfg, kernel, x, z, out, B, N, held, clip,
                                noise_scale);
  return err != 0 ? err : (int)cudaGetLastError();
}

}  // namespace

// codec: 0 none, 1 fp16, 2 int8.  amax: 0 one amax over the tensor, 1 one
// a row (int8 only; the other codecs take none).  One launch on `stream`;
// returns its CUDA error (0 = launched).
extern "C" int boundary_fuse_f32(const float* x, const float* z, float* out,
                                 int64_t B, int64_t N, int codec, int amax,
                                 float clip, float noise_scale,
                                 void* stream) {
  if (B <= 0 || N <= 0 || B > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (amax != kTensor && amax != kRow) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (codec * 2 + amax) {
    case kNone * 2 + kTensor:
    case kNone * 2 + kRow:
      return launch<kNone, kRow>(x, z, out, B, N, clip, noise_scale, st);
    case kFp16 * 2 + kTensor:
    case kFp16 * 2 + kRow:
      return launch<kFp16, kRow>(x, z, out, B, N, clip, noise_scale, st);
    case kInt8 * 2 + kTensor:
      return launch<kInt8, kTensor>(x, z, out, B, N, clip, noise_scale, st);
    case kInt8 * 2 + kRow:
      return launch<kInt8, kRow>(x, z, out, B, N, clip, noise_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
