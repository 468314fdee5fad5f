// The fp32 LM head's three products on Hopper's tensor cores (sm_90a), a
// split-bf16 GEMM that keeps every product exact in fp32.
//
//   forward  Y  = x . w      M tokens, N vocab, K d
//   dW       dW = x^T . G    M d,      N vocab, K tokens
//   dX       dX = G . w^T    M tokens, N d,     K vocab
//
// x is bf16 (the final norm's output in the compute dtype); w (the head's
// fp32 parameter) and G (the fp32 logits' gradient) are fp32.  An fp32
// value v with |v| >= 2^-110 is exactly hi + mid + lo, three bf16 values
// (hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid); ref.py), and
// a product of two bf16 values is exact in fp32.  So x.w = x.w_lo + x.w_mid
// + x.w_hi, and x^T.G likewise, is the set of the plain fp32 product's own
// products, summed in another order.  G.w^T takes the six terms that
// reach fp32's 24 bits (mid.mid, lo.hi, hi.lo, mid.hi, hi.mid, hi.hi, in
// that order); each of the three it drops (mid.lo, lo.mid, lo.lo) is below
// 2^-24 of its product, and against a float64 oracle the nine-term form
// measured no closer.  No TF32, and no single rounding of w or G to bf16.
//
// Replaces no TPU kernel: the reference leaves the head to XLA (an fp32
// contraction, preferred_element_type float32).  It replaces the port's
// plain form x.float() @ w.float() (models/layers.py _f32_matmul), which
// runs on the CUDA cores at most at their 67 TFLOP/s.
//
// What bounds it: operations.  A DeepSeek-V2-Lite micro-batch's forward,
// 8192 x 2048 x 102,400, is 3.436 TFLOP of fp32 products: 51 ms at 67
// TFLOP/s; split, 3 x 3.436 TFLOP of bf16 products, 10.4 ms at 989.
// dW is the same; dX twice that.
//
// head_split: the split pass.  One read of an fp32 operand (R, C) through
// its row stride, one write of its parts (3, R, C) bf16 in the same layout
// (1.5x the operand's bytes): for a DeepSeek micro-batch G is read 3.36 GB
// and written 5.03 GB, w 0.84 GB and 1.26 GB.
//
// head_gemm: one persistent CTA an SM walks 128 x 128 output tiles; the
// tile index varies fastest along the dimension with fewer tiles, so the
// CTAs running together share operand panels in L2.  384 threads: a
// producer warpgroup (one thread issues every TMA copy through an mbarrier
// ring of stages, each stage one k-block of 64 with every part of A and B
// that the terms read: 64 KB forward and dW, 96 KB dX; 3 and 2 stages) and
// two consumer warpgroups of 64 rows each (setmaxnreg 40 / 232).  Per
// k-block a consumer issues, for each term, four wgmma m64n128k16 (bf16
// operands from shared memory, either operand K-major or MN-major, so
// every operand is read in its own layout: nothing is transposed) into a
// chunk accumulator, the first with scale-d 0, and then adds the chunk to
// the tile's fp32 accumulator with one round-to-nearest fp32 add an
// element: the tensor cores' own accumulation (its alignment and rounding
// are the hardware's) spans one k-block, and the tile's sum takes K / 64
// IEEE adds, fewer than the plain product's K.  The epilogue writes fp32
// straight from the registers.  No atomics: every run gives the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"
#include "hopper_sync.cuh"

namespace {

constexpr int kThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kOperand = 128 * kBK * 2;  // one part's tile: 16 KB
constexpr int kPanel = 64 * kBK * 2;     // an MN-major 64-column panel: 8 KB
constexpr int kRowBytes = 128;           // a swizzled row of 64 bf16

// the products: A has PA parts (1: x, 3: an fp32 operand's hi, mid, lo), B
// three; term t multiplies A part a(t) by B part b(t), smallest first
template <int PA, int NT>
struct Plan {
  static_assert((PA == 1 && NT == 3) || (PA == 3 && NT == 6),
                "head_gemm: 1 x 3 parts in 3 terms, 3 x 3 in 6");
  static constexpr int kStages = PA == 1 ? 3 : 2;
  static constexpr int kStageBytes = (PA + 3) * kOperand;
  static constexpr int kBarOff = kStages * kStageBytes;
  static constexpr int kSmemBytes = kBarOff + 16 * kStages + 1024;
  __device__ static constexpr int a(int t) {
    constexpr int six[6] = {1, 2, 0, 1, 0, 0};
    return PA == 1 ? 0 : six[t];
  }
  __device__ static constexpr int b(int t) {
    constexpr int six[6] = {1, 0, 2, 0, 1, 0};
    return PA == 1 ? 2 - t : six[t];
  }
};

// a K-major operand tile (128 rows of 64 k): the 64 rows from `row`, k16
// step kk
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int row, int kk) {
  return smem_desc(tile + row * kRowBytes + kk * 32, 16, 8 * kRowBytes, 1);
}

// an MN-major operand tile (two panels of 64 columns x 64 k rows): from
// panel `panel` on, k16 step kk (the leading byte offset steps across
// panels)
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int panel,
                                            int kk) {
  return smem_desc(tile + panel * kPanel + kk * 16 * kRowBytes, kPanel,
                   8 * kRowBytes, 1);
}

struct Shape {
  int M, N, K, mt, nt;
  bool m_fast;   // tile index varies fastest along M
};

__device__ __forceinline__ void tile_origin(const Shape& s, int tile,
                                            int& m0, int& n0) {
  if (s.m_fast) {
    m0 = (tile % s.mt) * kBM;
    n0 = (tile / s.mt) * kBN;
  } else {
    n0 = (tile % s.nt) * kBN;
    m0 = (tile / s.nt) * kBM;
  }
}

// one part's tile of a k-block into `dst`: K-major, a box of (64 k, 128
// rows); MN-major, two boxes of (64 columns, 64 k rows)
template <int T>
__device__ __forceinline__ void load_part(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int k0, int mn0,
                                          int part) {
  if (T == 0) {
    tma_load_3d(dst, map, bar, k0, mn0, part);
  } else {
    tma_load_3d(dst, map, bar, mn0, k0, part);
    tma_load_3d(dst + kPanel, map, bar, mn0 + 64, k0, part);
  }
}

// out (M, N) fp32 = sum over terms of A_a(t) . B_b(t); A (PA, M, K) K-major
// (TA 0) or (PA, K, M) MN-major (TA 1), B (3, N, K) K-major (TB 0) or (3, K,
// N) MN-major (TB 1), bf16 through the tensor maps
template <int PA, int NT, int TA, int TB>
__global__ void __launch_bounds__(kThreads, 1)
head_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 float* __restrict__ out, int64_t ldo, Shape s) {
  using P = Plan<PA, NT>;
  constexpr int kStages = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar = base + P::kBarOff;
  auto full = [&](int st) { return bar + 8 * st; };
  auto empty = [&](int st) { return bar + 8 * (kStages + st); };
  auto a_tile = [&](int st, int p) {
    return base + st * P::kStageBytes + p * kOperand;
  };
  auto b_tile = [&](int st, int p) {
    return base + st * P::kStageBytes + (PA + p) * kOperand;
  };
  const int tiles = s.mt * s.nt;
  const int nk = (s.K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 2 * 128);       // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(s, tile, m0, n0);
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int st = it % kStages;
          mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full(st), P::kStageBytes);
#pragma unroll
          for (int p = 0; p < PA; ++p)
            load_part<TA>(a_tile(st, p), &ta, full(st), kb * kBK, m0, p);
#pragma unroll
          for (int p = 0; p < 3; ++p)
            load_part<TB>(b_tile(st, p), &tb, full(st), kb * kBK, n0, p);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x / 128 - 1;    // consumer warpgroup: 64 rows
  const int t = threadIdx.x % 128;
  const int g = (t % 32) / 4, c4 = t % 4;
  const int row0 = 64 * wg + 16 * (t / 32) + g;   // rows row0, row0 + 8
  float acc[64], ch[64];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin(s, tile, m0, n0);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int st = it % kStages;
      mbar_wait(full(st), (it / kStages) & 1);
      reg_fence(ch);
      wgmma_fence();
#pragma unroll
      for (int term = 0; term < NT; ++term) {
        const uint32_t at = a_tile(st, P::a(term));
        const uint32_t bt = b_tile(st, P::b(term));
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          mma_ss_n128_t<TA, TB>(
              ch, TA == 0 ? kmajor(at, 64 * wg, kk) : mnmajor(at, wg, kk),
              TB == 0 ? kmajor(bt, 0, kk) : mnmajor(bt, 0, kk),
              term > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(ch);
      mbar_arrive(empty(st));
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += ch[i];
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + row0 + 8 * half;
      if (r >= s.M) continue;
      float* orow = out + (int64_t)r * ldo + n0;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int c = 8 * j + 2 * c4;
        if (n0 + c < s.N)
          *reinterpret_cast<float2*>(orow + c) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

__global__ void head_split_kernel(const float* __restrict__ src, int64_t rows,
                                  int64_t cols, int64_t ld,
                                  __nv_bfloat16* __restrict__ dst) {
  const int64_t part = rows * cols, n4 = part / 4;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = 4 * i, r = e / cols, c = e - r * cols;
    const float4 v = __ldg(reinterpret_cast<const float4*>(src + r * ld + c));
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t hi[2], mid[2], lo[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      __nv_bfloat16 h[2], m[2], l[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        h[q] = __float2bfloat16_rn(x[2 * j + q]);
        const float r1 = x[2 * j + q] - __bfloat162float(h[q]);   // exact
        m[q] = __float2bfloat16_rn(r1);
        l[q] = __float2bfloat16_rn(r1 - __bfloat162float(m[q]));  // exact
      }
      hi[j] = bf16x2_bits(__halves2bfloat162(h[0], h[1]));
      mid[j] = bf16x2_bits(__halves2bfloat162(m[0], m[1]));
      lo[j] = bf16x2_bits(__halves2bfloat162(l[0], l[1]));
    }
    *reinterpret_cast<uint2*>(dst + e) = make_uint2(hi[0], hi[1]);
    *reinterpret_cast<uint2*>(dst + part + e) = make_uint2(mid[0], mid[1]);
    *reinterpret_cast<uint2*>(dst + 2 * part + e) = make_uint2(lo[0], lo[1]);
  }
}

// a (C, R, P) bf16 tensor map over parts (P, R, C) with row stride ld and
// part stride ps (elements), boxes of (64, rows, 1), 128-byte swizzle
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t C, int64_t R,
                int P, int64_t ld, int64_t ps, int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)R, (cuuint64_t)P};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)ps * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <int PA, int NT, int TA, int TB>
int launch(const void* a, int64_t lda, int64_t psa, const void* b,
           int64_t ldb, int64_t psb, float* out, int64_t ldo, int M, int N,
           int K, cudaStream_t st) {
  using P = Plan<PA, NT>;
  CUtensorMap ta, tb;
  if (PA == 1) psa = lda * (TA == 0 ? M : K);   // one part: any valid stride
  // A: K-major (PA, M, K) or MN-major (PA, K, M); B likewise with N
  const bool ok =
      (TA == 0 ? tensor_map(&ta, a, K, M, PA, lda, psa, 128)
               : tensor_map(&ta, a, M, K, PA, lda, psa, 64)) &&
      (TB == 0 ? tensor_map(&tb, b, K, N, 3, ldb, psb, 128)
               : tensor_map(&tb, b, N, K, 3, ldb, psb, 64));
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kernel = head_gemm_kernel<PA, NT, TA, TB>;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  Shape s{M, N, K, (M + kBM - 1) / kBM, (N + kBN - 1) / kBN, false};
  s.m_fast = s.mt <= s.nt;
  const int tiles = s.mt * s.nt, grid = sm_count();
  kernel<<<tiles < grid ? tiles : grid, kThreads, P::kSmemBytes, st>>>(
      ta, tb, out, ldo, s);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int64_t ld, int64_t ps) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0 &&
         ps % 8 == 0;
}

}  // namespace

// src (rows, cols) fp32 with row stride ld (16-byte-aligned address, ld and
// cols multiples of 4) -> dst (3, rows, cols) bf16 contiguous: hi, mid, lo.
extern "C" int head_split(const float* src, int64_t rows, int64_t cols,
                          int64_t ld, void* dst, void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 4 || ld % 4 ||
      reinterpret_cast<uintptr_t>(src) % 16)
    return (int)cudaErrorInvalidValue;
  const int64_t n4 = rows * cols / 4;
  const int64_t blocks = (n4 + 255) / 256;
  const int cap = 16 * sm_count();
  head_split_kernel<<<(int)(blocks < cap ? blocks : cap), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      src, rows, cols, ld, static_cast<__nv_bfloat16*>(dst));
  return (int)cudaGetLastError();
}

// kind 0, forward: out (M tokens, N vocab) = x (M, K) . w, x bf16 with row
//   stride lda, w's parts (3, K, N) with row stride ldb, part stride psb;
// kind 1, dW: out (M d, N vocab) = x^T . G, x (K tokens, M) bf16 with row
//   stride lda, G's parts (3, K, N);
// kind 2, dX: out (M tokens, N d) = G . w^T in 6 terms, G's parts (3, M,
//   K) with row stride lda, part stride psa, w's (3, N, K).
// out fp32 with row stride ldo (even); every bf16 row stride a multiple of
// 8 elements and every address 16-byte aligned.  One CTA an SM.
extern "C" int head_gemm(int kind, const void* a, int64_t lda, int64_t psa,
                         const void* b, int64_t ldb, int64_t psb, float* out,
                         int64_t ldo, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldo % 2 || !aligned(a, lda, psa) ||
      !aligned(b, ldb, psb))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch<1, 3, 0, 1>(a, lda, 0, b, ldb, psb, out, ldo, M, N, K,
                                st);
    case 1:
      return launch<1, 3, 1, 1>(a, lda, 0, b, ldb, psb, out, ldo, M, N, K,
                                st);
    case 2:
      return launch<3, 6, 0, 0>(a, lda, psa, b, ldb, psb, out, ldo, M, N, K,
                                st);
  }
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one CTA of kind 0-2 (-1 for another kind)
extern "C" int head_gemm_smem_bytes(int kind) {
  switch (kind) {
    case 0:
    case 1: return Plan<1, 3>::kSmemBytes;
    case 2: return Plan<3, 6>::kSmemBytes;
  }
  return -1;
}
