// Flash attention (online softmax over kv blocks) for Hopper (sm_90a).
//
//   o[b,h,i] = sum_j softmax_j(scale * q[b,h,i] . k[b,g(h),j] + mask) v[b,g(h),j]
//
// q: (B, H, Sq, D), k/v: (B, Hkv, Sk, D), o like q, each addressed by its
// own (b, h, s) element strides with d contiguous, so the caller's model
// layout (B, S, H, D) is read and written in place, with no transpose.
// o in q's dtype.  GQA: q head h reads kv head h / (H / Hkv); K and V are
// never repeated in memory.  Masks: causal (q_offset + i >= j), a sliding
// window (q_offset + i - j < window) and a valid length (j < seq_k_valid);
// a masked logit is the finite -1e30 of the reference, so a row with no
// unmasked key averages v uniformly over all Sk keys, as the plain version
// does.  A key at or past Sk does not exist (probability 0).
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
// Two kernels, chosen by dtype alone:
//
// bf16 (D = 32, 64, 128, 256): flash_fwd_tc, on the tensor cores (FA3's
// shape).
//  * one CTA per (q tile of 128 rows, head, batch), 384 threads: one
//    producer warpgroup, of which one thread issues every copy, and two
//    consumer warpgroups of 64 q rows each; setmaxnreg moves registers
//    from the producer (24) to the consumers (240);
//  * Q arrives once, K and V tiles of Tile<D>::kBlockK keys (128 up to
//    D = 128, 64 at D = 256) through a 2-stage ring, all by TMA (4-d
//    tensor maps over (D, H, S, B) with the caller's byte strides, encoded
//    on the host and passed as __grid_constant__), into 128-byte-swizzled
//    shared memory (64-byte for D = 32) in panels of 64 columns, with
//    mbarrier full (expect-tx) and empty (consumer release) barriers; K
//    and V have barriers of their own, so S = Q.K^T starts while V is in
//    flight;
//  * S = Q.K^T by wgmma m64nBk16 (B = the kv block) from shared memory
//    (K-major Q and K), fp32 accumulator in registers; the online softmax
//    runs on the accumulator fragments (a row's max and sum across its 4
//    threads by shuffles), exp2 on logits prescaled by scale * log2(e);
//  * P stays in registers: the S accumulator's layout is the A-operand
//    layout of the next wgmma.  P is split into hi = bf16(p) and lo =
//    bf16(p - hi), and O += hi.V, O += lo.V are two register-A wgmmas
//    (m64nDk16; n256 at D = 256, the largest wgmma N) with V read
//    transposed through its descriptor (MN-major).  One bf16 rounding of
//    P would miss the bf16 pin (one ulp of the fp32 result) on about a
//    tenth of the outputs; the split keeps p to ~16 bits, for 1.5x the
//    tensor-core work;
//  * the softmax is hidden behind products twice over: block j's S is
//    issued with block j-1's P.V and its softmax runs while that P.V is
//    in flight, and the two warpgroups take turns (named barriers) to
//    issue, so one's softmax overlaps the other's wgmmas;
//  * masks only on the blocks that need them (the diagonal, the window's
//    edge, the valid length and Sk); blocks wholly inside take the
//    unmasked path.  TMA zero-fills rows past Sq and Sk: a zero key is
//    not a masked key, so keys past Sk get probability 0 by position;
//  * causal q tiles run heaviest first: the q tile is the grid's slowest
//    axis, walked from the last tile down.
//  Tile sizes: registers bind.  A consumer thread holds O (D / 2 fp32),
//  S (kBlockK / 2), and P hi and lo (kBlockK / 2 packed) of the block
//  before, all live at once while the next S is issued: 64 + 64 + 64 at
//  D = 128 with 128-key blocks, 128 + 32 + 32 at D = 256 with 64-key
//  blocks, within the 240 registers either way.  Shared memory: Q and two
//  stages of K and V take 32 + 128 KB at D = 128 and 64 + 4 x 32 KB =
//  192 KB at D = 256, one CTA an SM.  On an H100 at D = 128, 128-key
//  blocks ran faster than 64-key ones and a third stage gained nothing; at
//  D = 256 a third stage does not fit.
//
// fp32 (D = 32, 64, 128, 256): flash_fwd_f32, on the CUDA cores (TF32
// would break the fp32 pin).
//  * one CTA per (q block of 64 rows, head, batch), 256 threads: thread
//    (r, c) owns row r and the score columns c, c+4, ..., c+60 of each kv
//    block, and the output columns c, c+4, ... of row r;
//  * Q (scaled later, as the reference), K and V tiles staged in shared
//    memory: Q and K with a padded row stride (D + 1) so the threads of a
//    warp hit distinct banks; above 48 KB (D >= 64) this is dynamic
//    shared memory with the cudaFuncSetAttribute opt-in (213,760 B at
//    D = 256, one CTA an SM);
//  * the row max and the row sum go between the row's 4 threads, which
//    sit in one warp, by shuffles; the probabilities go through a shared
//    64 x 65 tile to the P.V product.
//
// Both run only the kv blocks some valid row of the CTA can see: below
// the diagonal (first_k <= last_q), inside the window (last_k >= first_q
// - window + 1) and under the valid length.  Where a row of the CTA can
// have no key at all, every block runs, so that row gets the reference's
// uniform average.  Rows past Sq are not written; nothing is padded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"
#include "hopper_sync.cuh"

namespace {

constexpr float kNegInf = -1e30f;         // the reference's NEG_INF

struct Strides {            // element strides of (b, h, s); d is 1
  int64_t b, h, s;
};

struct Params {
  int H, Hkv, Sq, Sk, Skv, causal, window, q_offset;
  float scale;
};

// kv blocks [lo, hi) of size block_k that some valid row of the q rows
// [q0, q0 + nq) can see; every block where a row may see none
__device__ __forceinline__ void kv_range(const Params& p, int q0, int nq,
                                         int block_k, int* lo, int* hi) {
  const int first_q = p.q_offset + q0;
  const int last_q = first_q + nq - 1;
  const int nkb = (p.Sk + block_k - 1) / block_k;
  *lo = 0;
  *hi = nkb;
  const bool row_may_be_empty =
      p.Skv <= 0 ||
      (p.causal && p.window > 0 && last_q - p.window + 1 > p.Skv - 1);
  if (row_may_be_empty) return;
  int k_end = p.Skv;                       // keys [0, k_end) can be unmasked
  if (p.causal) {
    k_end = min(k_end, last_q + 1);
    if (p.window > 0) *lo = max(0, first_q - p.window + 1) / block_k;
  }
  *hi = min(nkb, (k_end + block_k - 1) / block_k);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;             // kBlockQ rows x 4 threads a row
constexpr int kCols = kBlockK / 4;        // score columns a thread owns
constexpr int kPStride = kBlockK + 1;

template <int D>
constexpr size_t smem_bytes_f32() {
  return sizeof(float) * (2 * kBlockQ * (D + 1) + kBlockK * D +
                          kBlockQ * kPStride);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              Strides qs, Strides ks, Strides vs, Strides os, Params p) {
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

  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;
  float* op = o + b * os.b + h * os.h;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    Qs[r * QS + d] = r < nq ? qp[(int64_t)(q0 + r) * qs.s + d] : 0.f;
  }

  int kb_lo, kb_hi;
  kv_range(p, q0, nq, kBlockK, &kb_lo, &kb_hi);
  const int first_q = p.q_offset + q0;

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
        kx = kp[(int64_t)kk * ks.s + d];
        vx = vp[(int64_t)kk * vs.s + d];
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
    float* orow = op + (int64_t)(q0 + row) * os.s;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) orow[cg + 4 * i] = acc[i] / denom;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               Strides qs, Strides ks, Strides vs, Strides os, int B,
               Params p, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes_f32<D>();
  static bool opted_in = false;            // once per instantiation
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, B);
  flash_fwd_f32<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os,
      p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, warp specialisation
// ---------------------------------------------------------------------------

constexpr int kTcBlockQ = 128;            // q rows a CTA: 2 warpgroups x 64
constexpr int kStages = 2;                // K/V ring depth
constexpr int kTcThreads = 384;           // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct Tile {
  // keys a kv block (S: m64nBk16): 128 up to D = 128; 64 at D = 256, where
  // O takes 128 registers a thread and a K/V stage 32 KB
  static constexpr int kBlockK = D <= 128 ? 128 : 64;
  static constexpr int kPanel = D < 64 ? D : 64;      // columns a swizzle row
  static constexpr int kPanels = D / kPanel;
  static constexpr int kRowBytes = 2 * kPanel;        // 64 or 128
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // B128 / B64
  static constexpr int kQPanelBytes = kTcBlockQ * kRowBytes;
  static constexpr int kKvPanelBytes = kBlockK * kRowBytes;
  static constexpr int kQBytes = kPanels * kQPanelBytes;
  static constexpr int kKvBytes = kPanels * kKvPanelBytes;
  // Q, then K stages, then V stages (each a multiple of 1024 B, so every
  // tile keeps the swizzle atom's alignment), then the barriers
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKvBytes;
  static constexpr int kBarOff = kVOff + kStages * kKvBytes;
  static constexpr int kSmemBytes = kBarOff + 8 * (1 + 4 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ o, Strides os, Params p) {
  using T = Tile<D>;
  constexpr int kBK = T::kBlockK;
  constexpr int kS = kBK / 2;              // S accumulator registers
  constexpr int kO = D / 2;                // O accumulator registers
  constexpr int kPSteps = kBK / 16;        // k16 steps of P.V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, k_s = base + T::kKOff, v_s = base + T::kVOff;
  const uint32_t bar = base + T::kBarOff;
  const uint32_t q_full = bar;
  auto k_full = [&](int s) { return bar + 8 * (1 + s); };
  auto v_full = [&](int s) { return bar + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bar + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bar + 8 * (1 + 3 * kStages + s); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tile =                          // causal: heaviest tiles first
      p.causal ? (int)(gridDim.z - 1 - blockIdx.z) : (int)blockIdx.z;
  const int q0 = tile * kTcBlockQ;
  const int hk = h / (p.H / p.Hkv);
  int kb_lo, kb_hi;
  kv_range(p, q0, min(kTcBlockQ, p.Sq - q0), kBK, &kb_lo, &kb_hi);
  const int nblocks = kb_hi - kb_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 2 * 128);      // every consumer thread
      mbar_init(v_empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < T::kPanels; ++c)
        tma_load(q_s + c * T::kQPanelBytes, &tq, q_full, c * T::kPanel, h,
                 q0, b);
      for (int it = 0; it < nblocks; ++it) {
        const int s = it % kStages;
        const uint32_t ph = ((it / kStages) & 1) ^ 1;
        const int k0 = (kb_lo + it) * kBK;
        mbar_wait(k_empty(s), ph);
        mbar_expect_tx(k_full(s), T::kKvBytes);
        for (int c = 0; c < T::kPanels; ++c)
          tma_load(k_s + s * T::kKvBytes + c * T::kKvPanelBytes, &tk,
                   k_full(s), c * T::kPanel, hk, k0, b);
        mbar_wait(v_empty(s), ph);
        mbar_expect_tx(v_full(s), T::kKvBytes);
        for (int c = 0; c < T::kPanels; ++c)
          tma_load(v_s + s * T::kKvBytes + c * T::kKvPanelBytes, &tv,
                   v_full(s), c * T::kPanel, hk, k0, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x / 128 - 1;    // consumer warpgroup: 64 rows
  const int t = threadIdx.x % 128;
  const int g = (t % 32) / 4, c4 = t % 4;
  const int row0 = 64 * wg + 16 * (t / 32) + g;  // this thread's rows in the
  const int row1 = row0 + 8;                      // tile: row0 and row0 + 8
  const int wq_first = p.q_offset + q0 + 64 * wg; // the warpgroup's rows
  const int wq_last = wq_first + 63;
  const int qpos0 = p.q_offset + q0 + row0, qpos1 = qpos0 + 8;
  const int k_lim = min(p.Sk, p.Skv);
  const float sl2 = p.scale * 1.4426950408889634f;  // scale * log2(e)

  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float sc[kS];                            // S, then P, of the newest block
  uint32_t p_hi[kPSteps][4], p_lo[kPSteps][4];  // P of the block before
  const uint32_t q_wg = q_s + 64 * wg * T::kRowBytes;

  // S = Q.K^T from stage s: D / 16 k-steps through the panels of Q and K
  auto issue_s = [&](int s) {
    const uint32_t k_tile = k_s + s * T::kKvBytes;
    reg_fence(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 / T::kPanel;
      const uint32_t off = (kk * 16 % T::kPanel) * 2;
      mma_ss<kBK>(
          sc,
          smem_desc(q_wg + c * T::kQPanelBytes + off, 16, 8 * T::kRowBytes,
                    T::kLayout),
          smem_desc(k_tile + c * T::kKvPanelBytes + off, 16,
                    8 * T::kRowBytes, T::kLayout),
          kk > 0);
    }
    wgmma_commit();
  };

  // O += hi.V + lo.V from stage s; V read MN-major: 16 keys a k-step, D
  // columns in panels of 64 (the leading byte offset steps across panels)
  auto issue_pv = [&](int s) {
    const uint32_t v_tile = v_s + s * T::kKvBytes;
    reg_fence(acc);
    reg_fence(p_hi);
    reg_fence(p_lo);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kPSteps; ++j) {
      const uint64_t dv = smem_desc(v_tile + j * 16 * T::kRowBytes,
                                    T::kKvPanelBytes, 8 * T::kRowBytes,
                                    T::kLayout);
      mma_rs<D>(acc, p_hi[j], dv);
      mma_rs<D>(acc, p_lo[j], dv);
    }
    wgmma_commit();
  };

  // online softmax of the block at k0 on the S fragment: sc[i] is row
  // (i & 2 ? row1 : row0), column 8 * (i / 4) + 2 * c4 + (i & 1).  Leaves
  // p in sc, updates m and l, returns the factors O must be rescaled by.
  auto softmax = [&](int k0, float& corr0, float& corr1) {
    // logits in log2 units; masks only where the block needs them
    const bool masked =
        k0 + kBK > k_lim ||
        (p.causal && (k0 + kBK - 1 > wq_first ||
                      (p.window > 0 && wq_last - k0 >= p.window)));
    if (masked) {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int kpos = k0 + 8 * (i / 4) + 2 * c4 + (i & 1);
        const int qpos = (i & 2) ? qpos1 : qpos0;
        bool ok = kpos < p.Skv;
        if (p.causal) {
          ok = ok && qpos >= kpos;
          if (p.window > 0) ok = ok && (qpos - kpos) < p.window;
        }
        sc[i] = kpos >= p.Sk ? -INFINITY : (ok ? sc[i] * sl2 : kNegInf);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kS; ++i) sc[i] *= sl2;
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, sc[i]);
      else mx0 = fmaxf(mx0, sc[i]);
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, sh));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, sh));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      sc[i] = exp2f(sc[i] - ((i & 2) ? mn1 : mn0));
      if (i & 2) rs1 += sc[i];
      else rs0 += sc[i];
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh *= 2) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, sh);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, sh);
    }
    corr0 = exp2f(m0 - mn0);
    corr1 = exp2f(m1 - mn1);
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
    m0 = mn0;
    m1 = mn1;
  };

  // P as the A fragments of P.V: k-step j takes sc[8j .. 8j + 7] in
  // pairs, each split into a bf16 high part and a bf16 residual
  auto split_p = [&]() {
#pragma unroll
    for (int j = 0; j < kPSteps; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = sc[8 * j + 2 * r], y = sc[8 * j + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[j][r] = bf16x2_bits(hi);
        p_lo[j][r] = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
      }
  };

  // the two warpgroups take turns to issue their products (named barrier
  // 1 + wg is this one's turn), so one's softmax overlaps the other's
  // wgmmas; the first turn is warpgroup 0's
  auto turn_wait = [&]() { bar_sync(1 + wg, 256); };
  auto turn_pass = [&]() { bar_arrive(2 - wg, 256); };
  if (wg == 0) bar_arrive(1, 256);

  // Block it's S = Q.K^T is issued together with block it-1's P.V, and
  // its softmax runs while that P.V is on the tensor cores; O is rescaled
  // once the P.V has landed.  The first block is peeled off, so that no
  // wait on a wgmma is conditional (ptxas then serialises them).
  mbar_wait(q_full, 0);
  if (nblocks > 0) {
    float corr0, corr1;
    mbar_wait(k_full(0), 0);
    turn_wait();
    issue_s(0);
    turn_pass();
    wgmma_wait<0>();
    reg_fence(sc);
    mbar_arrive(k_empty(0));
    softmax(kb_lo * kBK, corr0, corr1);  // O is still 0
    split_p();
    for (int it = 1; it < nblocks; ++it) {
      const int s = it % kStages, prev = (it - 1) % kStages;
      mbar_wait(k_full(s), (it / kStages) & 1);
      turn_wait();
      issue_s(s);
      mbar_wait(v_full(prev), ((it - 1) / kStages) & 1);
      issue_pv(prev);
      turn_pass();
      wgmma_wait<1>();                     // S has landed, P.V may not
      reg_fence(sc);
      mbar_arrive(k_empty(s));
      softmax((kb_lo + it) * kBK, corr0, corr1);
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(p_hi);
      reg_fence(p_lo);
      mbar_arrive(v_empty(prev));
#pragma unroll
      for (int i = 0; i < kO; ++i) acc[i] *= (i & 2) ? corr1 : corr0;
      split_p();
    }
    const int last = (nblocks - 1) % kStages;
    mbar_wait(v_full(last), ((nblocks - 1) / kStages) & 1);
    turn_wait();
    issue_pv(last);
    turn_pass();
    wgmma_wait<0>();
    reg_fence(acc);
    mbar_arrive(v_empty(last));
  }

  // o = acc / l; acc[i] is row (i & 2 ? row1 : row0), column
  // 8 * (i / 4) + 2 * c4 + (i & 1)
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + (half ? row1 : row0);
    if (r >= p.Sq) continue;
    const float inv = half ? inv1 : inv0;
    __nv_bfloat16* orow = ob + (int64_t)r * os.s;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int i = 4 * j + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * c4) =
          __floats2bfloat162_rn(acc[i] * inv, acc[i + 1] * inv);
    }
  }
}

// a (D, H, S, B) bf16 tensor map over a (B, H, S, D) strided tensor,
// boxes of (panel, 1, rows, 1)
template <int D>
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int H, int S,
                Strides st, int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Tile<D>::kPanel, 1, (cuuint32_t)rows,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            Tile<D>::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              Strides qs, Strides ks, Strides vs, Strides os, int B,
              Params p, cudaStream_t stream) {
  constexpr int bytes = Tile<D>::kSmemBytes;
  static bool opted_in = false;            // once per instantiation
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  CUtensorMap tq, tk, tv;
  if (!tensor_map<D>(&tq, q, B, p.H, p.Sq, qs, kTcBlockQ) ||
      !tensor_map<D>(&tk, k, B, p.Hkv, p.Sk, ks, Tile<D>::kBlockK) ||
      !tensor_map<D>(&tv, v, B, p.Hkv, p.Sk, vs, Tile<D>::kBlockK))
    return (int)cudaErrorInvalidValue;
  dim3 grid(p.H, B, (p.Sq + kTcBlockQ - 1) / kTcBlockQ);
  flash_fwd_tc<D><<<grid, kTcThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), os, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32 (CUDA cores, any strides), 1 = bf16 (tensor cores; q, k,
// v 16-byte aligned with strides of multiples of 8 elements, as TMA needs,
// o 4-byte aligned with even strides).  D: 32, 64, 128 or 256.  Strides
// are in elements, (b, h, s) for each of q, k, v, o.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
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
  if (dtype == 0) {
    switch (D) {
      case 32:
        return launch_f32<32>(q, k, v, o, qs, ks, vs, os, B, p, s);
      case 64:
        return launch_f32<64>(q, k, v, o, qs, ks, vs, os, B, p, s);
      case 128:
        return launch_f32<128>(q, k, v, o, qs, ks, vs, os, B, p, s);
      case 256:
        return launch_f32<256>(q, k, v, o, qs, ks, vs, os, B, p, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 32: return launch_tc<32>(q, k, v, o, qs, ks, vs, os, B, p, s);
      case 64: return launch_tc<64>(q, k, v, o, qs, ks, vs, os, B, p, s);
      case 128: return launch_tc<128>(q, k, v, o, qs, ks, vs, os, B, p, s);
      case 256: return launch_tc<256>(q, k, v, o, qs, ks, vs, os, B, p, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one CTA of the kernel for (dtype, D); -1 for
// a pair the source does not instantiate
extern "C" int flash_attention_smem_bytes(int dtype, int D) {
  switch (dtype * 1000 + D) {
    case 32: return (int)smem_bytes_f32<32>();
    case 64: return (int)smem_bytes_f32<64>();
    case 128: return (int)smem_bytes_f32<128>();
    case 256: return (int)smem_bytes_f32<256>();
    case 1032: return Tile<32>::kSmemBytes;
    case 1064: return Tile<64>::kSmemBytes;
    case 1128: return Tile<128>::kSmemBytes;
    case 1256: return Tile<256>::kSmemBytes;
  }
  return -1;
}

// keys a kv block of the tensor-core kernel at D (bf16); -1 for a D it is
// not instantiated for
extern "C" int flash_attention_tc_block_k(int D) {
  switch (D) {
    case 32: return Tile<32>::kBlockK;
    case 64: return Tile<64>::kBlockK;
    case 128: return Tile<128>::kBlockK;
    case 256: return Tile<256>::kBlockK;
  }
  return -1;
}
