// Causal flash attention for training on Hopper (sm_90a): a forward that
// keeps the row log-sum-exp, and a backward, both on the tensor cores.
//
//   o[b,s,h] = sum_j softmax_j(scale * q[b,s,h] . k[b,j,g(h)] + mask) v[b,j,g(h)]
//
// q: (B, S, H, Dqk), k: (B, S, Hkv, Dqk), v: (B, S, Hkv, Dv), bf16, each read
// through its own (b, h, s) element strides with d contiguous, so the model
// layout is read in place.  GQA: q head h reads kv head h / (H / Hkv); K and
// V are never repeated.  The mask is causal by position value, banded by a
// window: key j is visible to query i iff pos[i] >= pos[j] and (window <= 0
// or pos[i] - pos[j] < window), for one int64 position vector read on the
// device (self-attention: query i always sees key i, so no row is empty).
// Instantiated for (Dqk, Dv) = (192, 128) (MLA: 128 nope + 64 rope, v 128)
// and (128, 128) (GQA); nothing is padded.
//
// Replaces no TPU kernel: the reference trains through plain attention (its
// Pallas flash kernel has no VJP).  It replaces the port's plain chunked
// attention under autograd (models/layers.py attention_chunked), whose
// scores are fp32 products of the same bf16 operands: here they are wgmma
// products of bf16 operands with fp32 accumulation, P is rounded to bf16
// once, as the plain path rounds it, and causal tiles above the diagonal
// are neither loaded nor computed.
//
// What bounds it: operations.  At (S 8192, H 16, Dqk 192, Dv 128) the
// causal forward is 2 x 8192^2 / 2 x 16 x 320 = 344 GFLOP a sequence
// against ~100 MB of operands: the tensor cores' 989 TFLOP/s bind.
//
// Position bounds.  flash_train_bounds writes the least and largest
// position of each 64 rows; a tile pair is skipped when these bounds show
// every pair masked, computed unmasked when they show none masked (and the
// tiles lie inside S), and masked element by element otherwise (the
// diagonal, the window's edge, the ragged end).
//
// Forward (flash_train_fwd): one CTA per (q tile of 128 rows, head,
// sequence), 384 threads: a producer warpgroup (one thread issues every TMA
// copy: Q once, K and V tiles of 128 keys through a 2-stage mbarrier ring)
// and two consumer warpgroups of 64 rows each (setmaxnreg 24 / 240).
// S = Q.K^T by wgmma from shared memory; online softmax in fp32 registers
// (the rows' running max of the raw scores m, p = exp2(s sl2 - m sl2) by
// one fma, sl2 = scale log2 e, lse = m scale + ln l at the end, rounded as
// the plain path's m + log l); P rounded to bf16 once and
// O += P.V by a register-A wgmma; block j's S is issued with block j-1's
// P.V, and the two warpgroups take turns to issue.  Writes O (bf16, through
// its strides), O in fp32 (for the backward's row sums) and the row
// log-sum-exp (fp32, natural log, (B, H, S_pad)).  q tiles launch from the
// last down: under a causal arange the longest first.  Shared memory at
// Dqk 192: Q 48 KB + 2 x (K 48 KB + V 32 KB) = 208 KB; registers: O 64, S
// 64, P 32.
//
// Backward: three launches, no atomics, so every run gives the same bits.
//  * flash_train_delta: Delta = rowsum(dO * O) in fp32, from the fp32 O (the
//    bf16 O would put its rounding into every dS of a peaked row).
//  * flash_train_dkdv: one CTA per (64-key tile, kv head, sequence); K and
//    V stay in shared memory while Q and dO tiles (with their LSE and Delta)
//    stream through a 2-stage ring over the q tiles that see the keys, from
//    the diagonal down, for every q head of the kv head's group.  The two
//    consumer warpgroups split the work, each holding one accumulator:
//    warpgroup 0 computes S^T = K.Q^T, P^T = exp2(S^T scale log2e - LSE)
//    and dV += P^T.dO; warpgroup 1 computes dP^T = V.dO^T, takes P^T from
//    warpgroup 0 through shared memory (fp32), dS^T = P^T (dP^T - Delta)
//    and dK += dS^T.Q.  So a thread holds dV (32 or 64) or dK (96 at Dqk
//    192) and one score tile, within its 240 registers.  q tiles of 64 rows
//    at Dqk 192 (shared memory: K 24 + V 16 + 2 x (Q 24 + dO 16) + P 16 KB),
//    128 at Dqk 128.
//  * flash_train_dq: one CTA per (q tile of 128 rows, head, sequence), as
//    the forward, K and V tiles of 64 keys through the ring; each consumer
//    warpgroup recomputes S = Q.K^T and dP = dO.V^T for its 64 rows, P and
//    dS = P (dP - Delta), and accumulates dQ += dS.K (K read MN-major).
//  dS enters the dK and dQ products rounded to bf16 once: against a float64
//  oracle this keeps both gradients' errors within those of the plain
//  chunked path, which multiplies an fp32 dS (see tests).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"
#include "hopper_sync.cuh"

namespace {

constexpr int kThreads = 384;             // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kPosRows = 64;              // rows one position bound covers
constexpr int kPad = 128;                 // LSE / Delta rows padded to this
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kPanelBytes = 128;          // a row of a 64-column bf16 panel

struct Strides {            // element strides of (b, h, s); d is 1
  int64_t b, h, s;
};

struct Params {
  int H, Hkv, S, s_pad, window;
  float scale;
  const int64_t* pos;       // (S,) the rows' positions
  const int64_t* bmin;      // (ceil(S / 64),) least position of 64 rows
  const int64_t* bmax;      // largest
};

struct Span {
  int64_t lo, hi;
};

// the least and largest position of rows [r0, r0 + rows) (r0 < S)
__device__ __forceinline__ Span pos_span(const Params& p, int r0, int rows) {
  const int b0 = r0 / kPosRows;
  const int b1 = min((r0 + rows + kPosRows - 1) / kPosRows,
                     (p.S + kPosRows - 1) / kPosRows);
  Span s{__ldg(p.bmin + b0), __ldg(p.bmax + b0)};
  for (int i = b0 + 1; i < b1; ++i) {
    s.lo = min(s.lo, __ldg(p.bmin + i));
    s.hi = max(s.hi, __ldg(p.bmax + i));
  }
  return s;
}

enum Rel { kSkip = 0, kMask = 1, kFull = 2 };

// how queries with positions in q relate to keys with positions in k: every
// pair masked, some, or none (`edge`: a tile runs past S)
__device__ __forceinline__ int relation(Span q, Span k, int window,
                                        bool edge) {
  if (q.hi < k.lo) return kSkip;
  if (window > 0 && q.lo - k.hi >= window) return kSkip;
  const bool all_in = q.lo >= k.hi && (window <= 0 || q.hi - k.lo < window);
  return all_in && !edge ? kFull : kMask;
}

__device__ __forceinline__ bool visible(int64_t qp, int64_t kp, int window) {
  return qp >= kp && (window <= 0 || qp - kp < window);
}

// the row's position, or a sentinel that no key sees past S
__device__ __forceinline__ int64_t row_pos(const Params& p, int r) {
  return r < p.S ? __ldg(p.pos + r) : INT64_MIN;
}

// a (D, H, S, B) bf16 tensor map over a (B, H, S, D) strided tensor, boxes
// of (64, 1, rows, 1), 128-byte swizzle
bool tensor_map(CUtensorMap* map, const void* ptr, int D, int B, int H, int S,
                Strides st, int rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a K-major operand of 64 rows from a tile of `panel_bytes` panels: k16 step
// kk of the reduction over the tile's columns
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int panel_bytes,
                                           int kk) {
  const int c = kk * 16 / 64;
  const uint32_t off = (kk * 16 % 64) * 2;
  return smem_desc(tile + c * panel_bytes + off, 16, 8 * kPanelBytes, 1);
}

// an MN-major B operand: k16 step j over the tile's rows, its columns in
// panels of 64 (the leading byte offset steps across panels)
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int panel_bytes,
                                            int j) {
  return smem_desc(tile + j * 16 * kPanelBytes, panel_bytes, 8 * kPanelBytes,
                   1);
}

// accumulator fragment element i of a thread: row (i & 2 ? 8 : 0) + its
// row0, column 8 * (i / 4) + 2 * c4 + (i & 1)
__device__ __forceinline__ int frag_col(int i, int c4) {
  return 8 * (i / 4) + 2 * c4 + (i & 1);
}

// a score tile's fp32 fragment as the bf16 A fragments of the next product
template <int N>
__device__ __forceinline__ void pack_a(const float (&x)[N / 2],
                                       uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[j][r] = bf16x2_bits(
          __floats2bfloat162_rn(x[8 * j + 2 * r], x[8 * j + 2 * r + 1]));
}

// rows r0 and r0 + 8 (those below S) of an accumulator of N columns, times
// mul, in bf16 through the row stride
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2],
                                           float mul, __nv_bfloat16* out,
                                           int64_t row_stride, int r0, int c4,
                                           int S) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= S) continue;
    __nv_bfloat16* orow = out + (int64_t)r * row_stride;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int i = 4 * j + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * c4) =
          __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// position bounds
// ---------------------------------------------------------------------------

__global__ void flash_train_bounds_kernel(const int64_t* __restrict__ pos,
                                          int S, int64_t* __restrict__ bmin,
                                          int64_t* __restrict__ bmax) {
  const int blk = blockIdx.x;
  const int r = blk * kPosRows + threadIdx.x;   // 64 threads a block
  int64_t lo = r < S ? pos[r] : INT64_MAX;
  int64_t hi = r < S ? pos[r] : INT64_MIN;
#pragma unroll
  for (int sh = 16; sh >= 1; sh /= 2) {
    lo = min(lo, (int64_t)__shfl_xor_sync(0xffffffffu, (long long)lo, sh));
    hi = max(hi, (int64_t)__shfl_xor_sync(0xffffffffu, (long long)hi, sh));
  }
  __shared__ int64_t part[2][2];
  if (threadIdx.x % 32 == 0) {
    part[threadIdx.x / 32][0] = lo;
    part[threadIdx.x / 32][1] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bmin[blk] = min(part[0][0], part[1][0]);
    bmax[blk] = max(part[0][1], part[1][1]);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int DQK, int DV>
struct FwdTile {
  static constexpr int kBQ = 128, kBK = 128, kStages = 2;
  static constexpr int kQPanel = kBQ * kPanelBytes;     // 16 KB
  static constexpr int kKvPanel = kBK * kPanelBytes;    // 16 KB
  static constexpr int kQBytes = DQK / 64 * kQPanel;
  static constexpr int kKBytes = DQK / 64 * kKvPanel;
  static constexpr int kVBytes = DV / 64 * kKvPanel;
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kBarOff = kVOff + kStages * kVBytes;
  static constexpr int kSmemBytes = kBarOff + 8 * (1 + 4 * kStages) + 1024;
};

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_train_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, Strides os,
                       float* __restrict__ o32, Strides o32s,
                       float* __restrict__ lse, Params p) {
  using T = FwdTile<DQK, DV>;
  constexpr int kBK = T::kBK, kStages = T::kStages;
  constexpr int kS = kBK / 2;              // S accumulator registers
  constexpr int kO = DV / 2;               // O accumulator registers
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
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T::kBQ;
  const int hk = h / (p.H / p.Hkv);
  const int nkb = (p.S + kBK - 1) / kBK;
  const Span q_span = pos_span(p, q0, T::kBQ);
  const bool q_edge = q0 + T::kBQ > p.S;
  // the next kv block after kb that some row of the tile sees
  auto next_block = [&](int kb) {
    for (++kb; kb < nkb; ++kb)
      if (relation(q_span, pos_span(p, kb * kBK, kBK), p.window,
                   q_edge || (kb + 1) * kBK > p.S) != kSkip)
        break;
    return kb;
  };

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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int c = 0; c < DQK / 64; ++c)
        tma_load(q_s + c * T::kQPanel, &tq, q_full, 64 * c, h, q0, b);
      int it = 0;
      for (int kb = next_block(-1); kb < nkb; kb = next_block(kb), ++it) {
        const int s = it % kStages;
        const uint32_t ph = ((it / kStages) & 1) ^ 1;
        mbar_wait(k_empty(s), ph);
        mbar_expect_tx(k_full(s), T::kKBytes);
        for (int c = 0; c < DQK / 64; ++c)
          tma_load(k_s + s * T::kKBytes + c * T::kKvPanel, &tk, k_full(s),
                   64 * c, hk, kb * kBK, b);
        mbar_wait(v_empty(s), ph);
        mbar_expect_tx(v_full(s), T::kVBytes);
        for (int c = 0; c < DV / 64; ++c)
          tma_load(v_s + s * T::kVBytes + c * T::kKvPanel, &tv, v_full(s),
                   64 * c, hk, kb * kBK, b);
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
  const int wq0 = q0 + 64 * wg;                   // the warpgroup's rows
  const bool w_live = wq0 < p.S;
  const Span w_span = w_live ? pos_span(p, wq0, 64) : q_span;
  const bool w_edge = wq0 + 64 > p.S;
  const int64_t qp0 = row_pos(p, q0 + row0), qp1 = row_pos(p, q0 + row1);
  const float sl2 = p.scale * kLog2e;

  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float ms0 = 0.f, ms1 = 0.f;
  float sc[kS];                            // S, then P, of the newest block
  uint32_t pa[kPSteps][4];                 // P of the block before, bf16
  const uint32_t q_wg = q_s + 64 * wg * kPanelBytes;

  auto issue_s = [&](int s) {
    const uint32_t k_tile = k_s + s * T::kKBytes;
    reg_fence(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      mma_ss<kBK>(sc, kmajor(q_wg, T::kQPanel, kk),
                  kmajor(k_tile, T::kKvPanel, kk), kk > 0);
    wgmma_commit();
  };

  auto issue_pv = [&](int s) {
    const uint32_t v_tile = v_s + s * T::kVBytes;
    reg_fence(acc);
    reg_fence(pa);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kPSteps; ++j)
      mma_rs<DV>(acc, pa[j], mnmajor(v_tile, T::kKvPanel, j));
    wgmma_commit();
  };

  // online softmax of block kb on the S fragment: m is the rows' running
  // max of the raw scores (masked: -inf), ms = m sl2 rounded, p = exp2(s sl2
  // - ms) by one fma; leaves p in sc, updates m, ms and l, returns the
  // factors O must be rescaled by
  auto softmax = [&](int kb, float& corr0, float& corr1) {
    const int k0 = kb * kBK;
    const int rel = w_live ? relation(w_span, pos_span(p, k0, kBK), p.window,
                                      w_edge || k0 + kBK > p.S)
                           : kMask;
    if (rel != kFull) {
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int kidx = k0 + frag_col(i, c4);
        const int64_t qp = (i & 2) ? qp1 : qp0;
        if (kidx >= p.S || qp == INT64_MIN ||
            !visible(qp, __ldg(p.pos + kidx), p.window))
          sc[i] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
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
    // a row with no key seen yet subtracts 0: exp2(-inf) is 0 either way
    const float ns0 = mn0 == -INFINITY ? 0.f : mn0 * sl2;
    const float ns1 = mn1 == -INFINITY ? 0.f : mn1 * sl2;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      sc[i] = exp2f(fmaf(sc[i], sl2, (i & 2) ? -ns1 : -ns0));
      if (i & 2) rs1 += sc[i];
      else rs0 += sc[i];
    }
#pragma unroll
    for (int sh = 1; sh <= 2; sh *= 2) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, sh);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, sh);
    }
    // l and O were summed against the old ms: exactly 1 while m holds
    corr0 = m0 == -INFINITY ? 0.f : exp2f(ms0 - ns0);
    corr1 = m1 == -INFINITY ? 0.f : exp2f(ms1 - ns1);
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;
    m0 = mn0;
    m1 = mn1;
    ms0 = ns0;
    ms1 = ns1;
  };

  auto turn_wait = [&]() { bar_sync(1 + wg, 256); };
  auto turn_pass = [&]() { bar_arrive(2 - wg, 256); };
  if (wg == 0) bar_arrive(1, 256);

  mbar_wait(q_full, 0);
  int kb = next_block(-1);
  if (kb < nkb) {
    float corr0, corr1;
    mbar_wait(k_full(0), 0);
    turn_wait();
    issue_s(0);
    turn_pass();
    wgmma_wait<0>();
    reg_fence(sc);
    mbar_arrive(k_empty(0));
    softmax(kb, corr0, corr1);              // O is still 0
    pack_a<kBK>(sc, pa);
    int it = 1;
    for (kb = next_block(kb); kb < nkb; kb = next_block(kb), ++it) {
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
      softmax(kb, corr0, corr1);
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(pa);
      mbar_arrive(v_empty(prev));
#pragma unroll
      for (int i = 0; i < kO; ++i) acc[i] *= (i & 2) ? corr1 : corr0;
      pack_a<kBK>(sc, pa);
    }
    const int last = (it - 1) % kStages;
    mbar_wait(v_full(last), ((it - 1) / kStages) & 1);
    turn_wait();
    issue_pv(last);
    turn_pass();
    wgmma_wait<0>();
    reg_fence(acc);
    mbar_arrive(v_empty(last));
  }

  // o = acc / l, in bf16 and (unless o32 is null) in fp32; lse = m scale +
  // ln l less the rounding of ms that l carries: l = sum exp2(s sl2 - ms)
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + (half ? row1 : row0);
    if (r >= p.S) continue;
    const float inv = half ? inv1 : inv0;
    __nv_bfloat16* orow = o + b * os.b + h * os.h + (int64_t)r * os.s;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
      const int i = 4 * j + 2 * half;
      const float x = acc[i] * inv, y = acc[i + 1] * inv;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * c4) =
          __floats2bfloat162_rn(x, y);
      if (o32 != nullptr)
        *reinterpret_cast<float2*>(o32 + b * o32s.b + h * o32s.h +
                                   (int64_t)r * o32s.s + 8 * j + 2 * c4) =
            make_float2(x, y);
    }
  }
  if (c4 == 0) {
    float* lrow = lse + ((int64_t)b * p.H + h) * p.s_pad + q0;
    // rows past S (up to s_pad) get 0: the backward reads whole tiles
    const float d0 = fmaf(m0, sl2, -ms0), d1 = fmaf(m1, sl2, -ms1);
    lrow[row0] = q0 + row0 < p.S ? fmaf(m0, p.scale, logf(l0) - d0 * kLn2)
                                 : 0.f;
    lrow[row1] = q0 + row1 < p.S ? fmaf(m1, p.scale, logf(l1) - d1 * kLn2)
                                 : 0.f;
  }
}

// ---------------------------------------------------------------------------
// backward: Delta
// ---------------------------------------------------------------------------

// one warp a row (b, h, s) of (B, H, s_pad): rows past S get 0
__global__ void flash_train_delta_kernel(const __nv_bfloat16* __restrict__ dO,
                                         Strides ds,
                                         const float* __restrict__ o32,
                                         Strides o32s,
                                         float* __restrict__ delta, int B,
                                         int H, int S, int s_pad, int DV) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)B * H * s_pad) return;
  const int s = (int)(row % s_pad);
  const int h = (int)(row / s_pad % H);
  const int b = (int)(row / s_pad / H);
  float acc = 0.f;
  if (s < S) {
    const __nv_bfloat16* g = dO + b * ds.b + h * ds.h + (int64_t)s * ds.s;
    const float* x = o32 + b * o32s.b + h * o32s.h + (int64_t)s * o32s.s;
    for (int d = 2 * lane; d < DV; d += 64) {
      const float2 gv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(g + d));
      const float2 xv = *reinterpret_cast<const float2*>(x + d);
      acc = fmaf(gv.x, xv.x, acc);
      acc = fmaf(gv.y, xv.y, acc);
    }
#pragma unroll
    for (int sh = 16; sh >= 1; sh /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, sh);
  }
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// backward: dK, dV
// ---------------------------------------------------------------------------

template <int DQK, int DV>
struct KvTile {
  static constexpr int kBK = 64;                       // keys a CTA
  static constexpr int kBQ = DQK <= 128 ? 128 : 64;    // q rows a step
  static constexpr int kStages = 2;
  static constexpr int kKvPanel = kBK * kPanelBytes;   // 8 KB
  static constexpr int kQPanel = kBQ * kPanelBytes;
  static constexpr int kKBytes = DQK / 64 * kKvPanel;
  static constexpr int kVBytes = DV / 64 * kKvPanel;
  static constexpr int kQBytes = DQK / 64 * kQPanel;
  static constexpr int kOBytes = DV / 64 * kQPanel;
  static constexpr int kRowBytes = kBQ * 4;            // LSE or Delta
  static constexpr int kVOff = kKBytes;
  static constexpr int kQOff = kVOff + kVBytes;
  static constexpr int kOOff = kQOff + kStages * kQBytes;
  static constexpr int kPOff = kOOff + kStages * kOBytes;
  static constexpr int kLOff = kPOff + 128 * (kBQ / 2) * 4;  // P^T, fp32
  static constexpr int kDOff = kLOff + kStages * kRowBytes;
  static constexpr int kBarOff = kDOff + kStages * kRowBytes;
  static constexpr int kSmemBytes = kBarOff + 8 * (1 + 2 * kStages) + 1024;
};

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_train_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk, Strides dks,
                        __nv_bfloat16* __restrict__ dv, Strides dvs,
                        Params p) {
  using T = KvTile<DQK, DV>;
  constexpr int kBQ = T::kBQ, kStages = T::kStages;
  constexpr int kS = kBQ / 2;              // score accumulator registers
  constexpr int kSteps = kBQ / 16;         // k16 steps of dV and dK
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t k_s = base, v_s = base + T::kVOff, q_s = base + T::kQOff;
  const uint32_t o_s = base + T::kOOff, l_s = base + T::kLOff;
  const uint32_t d_s = base + T::kDOff;
  float* const p_buf = reinterpret_cast<float*>(base_ptr + T::kPOff);
  const float* const l_buf = reinterpret_cast<float*>(base_ptr + T::kLOff);
  const float* const d_buf = reinterpret_cast<float*>(base_ptr + T::kDOff);
  const uint32_t bar = base + T::kBarOff;
  const uint32_t kv_full = bar;
  auto full = [&](int s) { return bar + 8 * (1 + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + kStages + s); };

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * T::kBK;      // under a causal arange the
  const int group = p.H / p.Hkv;           // first key tiles see the most
  const int nqb = (p.S + kBQ - 1) / kBQ;
  const Span k_span = pos_span(p, k0, T::kBK);
  const bool k_edge = k0 + T::kBK > p.S;
  auto rel = [&](int qb) {
    return relation(pos_span(p, qb * kBQ, kBQ), k_span, p.window,
                    k_edge || (qb + 1) * kBQ > p.S);
  };
  auto next_q = [&](int qb) {
    for (++qb; qb < nqb; ++qb)
      if (rel(qb) != kSkip) break;
    return qb;
  };
  int n_q = 0;
  for (int qb = next_q(-1); qb < nqb; qb = next_q(qb)) ++n_q;
  const int n_iter = n_q * group;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, T::kKBytes + T::kVBytes);
      for (int c = 0; c < DQK / 64; ++c)
        tma_load(k_s + c * T::kKvPanel, &tk, kv_full, 64 * c, hk, k0, b);
      for (int c = 0; c < DV / 64; ++c)
        tma_load(v_s + c * T::kKvPanel, &tv, kv_full, 64 * c, hk, k0, b);
      int it = 0;
      for (int gi = 0; gi < group; ++gi) {
        const int h = hk * group + gi;
        const float* lrow = lse + ((int64_t)b * p.H + h) * p.s_pad;
        const float* drow = delta + ((int64_t)b * p.H + h) * p.s_pad;
        for (int qb = next_q(-1); qb < nqb; qb = next_q(qb), ++it) {
          const int s = it % kStages;
          const int q0 = qb * kBQ;
          mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full(s), T::kQBytes + T::kOBytes + 2 * T::kRowBytes);
          for (int c = 0; c < DQK / 64; ++c)
            tma_load(q_s + s * T::kQBytes + c * T::kQPanel, &tq, full(s),
                     64 * c, h, q0, b);
          for (int c = 0; c < DV / 64; ++c)
            tma_load(o_s + s * T::kOBytes + c * T::kQPanel, &tdo, full(s),
                     64 * c, h, q0, b);
          bulk_load(l_s + s * T::kRowBytes, lrow + q0, T::kRowBytes, full(s));
          bulk_load(d_s + s * T::kRowBytes, drow + q0, T::kRowBytes, full(s));
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  const int g = (t % 32) / 4, c4 = t % 4;
  const int row0 = 16 * (t / 32) + g, row1 = row0 + 8;  // keys of the tile
  const int64_t kp0 = k0 + row0 < p.S ? __ldg(p.pos + k0 + row0) : INT64_MAX;
  const int64_t kp1 = k0 + row1 < p.S ? __ldg(p.pos + k0 + row1) : INT64_MAX;
  const float sl2 = p.scale * kLog2e;
  float st[kS];                            // S^T or dP^T of the q tile
  uint32_t pa[kSteps][4];                  // P^T or dS^T, bf16

  // masked entries of the score tile (every column past S included)
  auto mask_of = [&](int q0, int i) {
    const int qidx = q0 + frag_col(i, c4);
    if (qidx >= p.S) return true;
    const int64_t kp = (i & 2) ? kp1 : kp0;
    return kp == INT64_MAX || !visible(__ldg(p.pos + qidx), kp, p.window);
  };

  // step(it, q0, masked, q tile, dO tile, LSE row, Delta row) for each q
  // tile of the ring, in the producer's order
  auto walk = [&](auto&& step) {
    mbar_wait(kv_full, 0);
    int it = 0;
    for (int gi = 0; gi < group; ++gi)
      for (int qb = next_q(-1); qb < nqb; qb = next_q(qb), ++it) {
        const int s = it % kStages;
        mbar_wait(full(s), (it / kStages) & 1);
        step(it, qb * kBQ, rel(qb) != kFull, q_s + s * T::kQBytes,
             o_s + s * T::kOBytes, l_buf + s * kBQ, d_buf + s * kBQ);
        mbar_arrive(empty(s));
      }
  };

  if (wg == 0) {
    float acc[DV / 2];                     // dV
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    walk([&](int it, int q0, bool masked, uint32_t q_tile, uint32_t o_tile,
             const float* lrow, const float*) {
      // S^T = K.Q^T, P^T = exp2(S^T scale log2e - LSE log2e)
      reg_fence(st);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        mma_ss<kBQ>(st, kmajor(k_s, T::kKvPanel, kk),
                    kmajor(q_tile, T::kQPanel, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(st);
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const float x =
            exp2f(fmaf(st[i], sl2, -lrow[frag_col(i, c4)] * kLog2e));
        st[i] = masked && mask_of(q0, i) ? 0.f : x;
      }
      if (it > 0) bar_sync(2, 256);        // warpgroup 1 has read P^T
#pragma unroll
      for (int i = 0; i < kS; ++i) p_buf[i * 128 + t] = st[i];
      bar_arrive(1, 256);
      pack_a<kBQ>(st, pa);
      // dV += P^T.dO
      reg_fence(acc);
      reg_fence(pa);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kSteps; ++j)
        mma_rs<DV>(acc, pa[j], mnmajor(o_tile, T::kQPanel, j));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(pa);
    });
    store_rows<DV>(acc, 1.f, dv + b * dvs.b + hk * dvs.h, dvs.s, k0 + row0,
                   c4, p.S);
  } else {
    float acc[DQK / 2];                    // dK / scale
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.f;
    walk([&](int it, int, bool, uint32_t q_tile, uint32_t o_tile,
             const float*, const float* drow) {
      // dP^T = V.dO^T, dS^T = P^T (dP^T - Delta)
      reg_fence(st);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk)
        mma_ss<kBQ>(st, kmajor(v_s, T::kKvPanel, kk),
                    kmajor(o_tile, T::kQPanel, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(st);
      bar_sync(1, 256);                    // warpgroup 0 has written P^T
#pragma unroll
      for (int i = 0; i < kS; ++i)
        st[i] = p_buf[i * 128 + t] * (st[i] - drow[frag_col(i, c4)]);
      if (it + 1 < n_iter) bar_arrive(2, 256);
      pack_a<kBQ>(st, pa);
      // dK += dS^T.Q
      reg_fence(acc);
      reg_fence(pa);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kSteps; ++j)
        mma_rs<DQK>(acc, pa[j], mnmajor(q_tile, T::kQPanel, j));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(pa);
    });
    store_rows<DQK>(acc, p.scale, dk + b * dks.b + hk * dks.h, dks.s,
                    k0 + row0, c4, p.S);
  }
}

// ---------------------------------------------------------------------------
// backward: dQ
// ---------------------------------------------------------------------------

template <int DQK, int DV>
struct QTile {
  static constexpr int kBQ = 128, kBK = 64, kStages = 2;
  static constexpr int kQPanel = kBQ * kPanelBytes;    // 16 KB
  static constexpr int kKvPanel = kBK * kPanelBytes;   // 8 KB
  static constexpr int kQBytes = DQK / 64 * kQPanel;
  static constexpr int kOBytes = DV / 64 * kQPanel;
  static constexpr int kKBytes = DQK / 64 * kKvPanel;
  static constexpr int kVBytes = DV / 64 * kKvPanel;
  static constexpr int kOOff = kQBytes;
  static constexpr int kKOff = kOOff + kOBytes;
  static constexpr int kVOff = kKOff + kStages * kKBytes;
  static constexpr int kBarOff = kVOff + kStages * kVBytes;
  static constexpr int kSmemBytes = kBarOff + 8 * (1 + 2 * kStages) + 1024;
};

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_train_dq_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, Strides dqs, Params p) {
  using T = QTile<DQK, DV>;
  constexpr int kBK = T::kBK, kStages = T::kStages;
  constexpr int kS = kBK / 2;
  constexpr int kSteps = kBK / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base, o_s = base + T::kOOff, k_s = base + T::kKOff;
  const uint32_t v_s = base + T::kVOff;
  const uint32_t bar = base + T::kBarOff;
  const uint32_t q_full = bar;
  auto full = [&](int s) { return bar + 8 * (1 + s); };
  auto empty = [&](int s) { return bar + 8 * (1 + kStages + s); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T::kBQ;
  const int hk = h / (p.H / p.Hkv);
  const int nkb = (p.S + kBK - 1) / kBK;
  const Span q_span = pos_span(p, q0, T::kBQ);
  const bool q_edge = q0 + T::kBQ > p.S;
  auto next_block = [&](int kb) {
    for (++kb; kb < nkb; ++kb)
      if (relation(q_span, pos_span(p, kb * kBK, kBK), p.window,
                   q_edge || (kb + 1) * kBK > p.S) != kSkip)
        break;
    return kb;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes + T::kOBytes);
      for (int c = 0; c < DQK / 64; ++c)
        tma_load(q_s + c * T::kQPanel, &tq, q_full, 64 * c, h, q0, b);
      for (int c = 0; c < DV / 64; ++c)
        tma_load(o_s + c * T::kQPanel, &tdo, q_full, 64 * c, h, q0, b);
      int it = 0;
      for (int kb = next_block(-1); kb < nkb; kb = next_block(kb), ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), T::kKBytes + T::kVBytes);
        for (int c = 0; c < DQK / 64; ++c)
          tma_load(k_s + s * T::kKBytes + c * T::kKvPanel, &tk, full(s),
                   64 * c, hk, kb * kBK, b);
        for (int c = 0; c < DV / 64; ++c)
          tma_load(v_s + s * T::kVBytes + c * T::kKvPanel, &tv, full(s),
                   64 * c, hk, kb * kBK, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  const int g = (t % 32) / 4, c4 = t % 4;
  const int row0 = 64 * wg + 16 * (t / 32) + g, row1 = row0 + 8;
  const int wq0 = q0 + 64 * wg;
  const bool w_live = wq0 < p.S;
  const Span w_span = w_live ? pos_span(p, wq0, 64) : q_span;
  const bool w_edge = wq0 + 64 > p.S;
  const int64_t qp0 = row_pos(p, q0 + row0), qp1 = row_pos(p, q0 + row1);
  const float sl2 = p.scale * kLog2e;
  const float* lrow = lse + ((int64_t)b * p.H + h) * p.s_pad + q0;
  const float* drow = delta + ((int64_t)b * p.H + h) * p.s_pad + q0;
  const float lse0 = lrow[row0] * kLog2e, lse1 = lrow[row1] * kLog2e;
  const float dl0 = drow[row0], dl1 = drow[row1];

  float acc[DQK / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.f;
  float sc[kS], dp[kS];
  uint32_t pa[kSteps][4];
  const uint32_t q_wg = q_s + 64 * wg * kPanelBytes;
  const uint32_t o_wg = o_s + 64 * wg * kPanelBytes;

  mbar_wait(q_full, 0);
  int it = 0;
  for (int kb = next_block(-1); kb < nkb; kb = next_block(kb), ++it) {
    const int s = it % kStages;
    const int k0 = kb * kBK;
    const uint32_t k_tile = k_s + s * T::kKBytes;
    const uint32_t v_tile = v_s + s * T::kVBytes;
    mbar_wait(full(s), (it / kStages) & 1);
    // S = Q.K^T and dP = dO.V^T
    reg_fence(sc);
    reg_fence(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk)
      mma_ss<kBK>(sc, kmajor(q_wg, T::kQPanel, kk),
                  kmajor(k_tile, T::kKvPanel, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DV / 16; ++kk)
      mma_ss<kBK>(dp, kmajor(o_wg, T::kQPanel, kk),
                  kmajor(v_tile, T::kKvPanel, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
    const bool masked =
        !w_live || relation(w_span, pos_span(p, k0, kBK), p.window,
                            w_edge || k0 + kBK > p.S) != kFull;
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const bool hi = i & 2;
      float x = exp2f(fmaf(sc[i], sl2, -(hi ? lse1 : lse0)));
      if (masked) {
        const int kidx = k0 + frag_col(i, c4);
        const int64_t qp = hi ? qp1 : qp0;
        if (kidx >= p.S || qp == INT64_MIN ||
            !visible(qp, __ldg(p.pos + kidx), p.window))
          x = 0.f;
      }
      sc[i] = x * (dp[i] - (hi ? dl1 : dl0));
    }
    pack_a<kBK>(sc, pa);
    // dQ += dS.K
    reg_fence(acc);
    reg_fence(pa);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
      mma_rs<DQK>(acc, pa[j], mnmajor(k_tile, T::kKvPanel, j));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(pa);
    mbar_arrive(empty(s));
  }
  store_rows<DQK>(acc, p.scale, dq + b * dqs.b + h * dqs.h, dqs.s, q0 + row0,
                  c4, p.S);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
int opt_in(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DQK, int DV>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* o32,
               float* lse, Strides qs, Strides ks, Strides vs, Strides os,
               Strides o32s, int B, Params p, cudaStream_t stream) {
  using T = FwdTile<DQK, DV>;
  static int opted = -1;                    // once per instantiation
  if (opted != 0) opted = opt_in(flash_train_fwd_kernel<DQK, DV>,
                                 T::kSmemBytes);
  if (opted != 0) return opted;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, DQK, B, p.H, p.S, qs, T::kBQ) ||
      !tensor_map(&tk, k, DQK, B, p.Hkv, p.S, ks, T::kBK) ||
      !tensor_map(&tv, v, DV, B, p.Hkv, p.S, vs, T::kBK))
    return (int)cudaErrorInvalidValue;
  dim3 grid(p.H, B, (p.S + T::kBQ - 1) / T::kBQ);
  flash_train_fwd_kernel<DQK, DV><<<grid, kThreads, T::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), os, static_cast<float*>(o32),
      o32s, lse, p);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_bwd(const void* q, const void* k, const void* v, const void* o32,
               const void* dO, void* dq, void* dk, void* dv, const float* lse,
               float* delta, Strides qs, Strides ks, Strides vs, Strides o32s,
               Strides dos, Strides dqs, Strides dks, Strides dvs, int B,
               Params p, cudaStream_t stream) {
  using KV = KvTile<DQK, DV>;
  using Q = QTile<DQK, DV>;
  static int opted = -1;
  if (opted != 0) {
    opted = opt_in(flash_train_dkdv_kernel<DQK, DV>, KV::kSmemBytes);
    if (opted == 0) opted = opt_in(flash_train_dq_kernel<DQK, DV>,
                                   Q::kSmemBytes);
  }
  if (opted != 0) return opted;
  CUtensorMap tq, tk, tv, tdo, tq2, tdo2;
  if (!tensor_map(&tq, q, DQK, B, p.H, p.S, qs, KV::kBQ) ||
      !tensor_map(&tdo, dO, DV, B, p.H, p.S, dos, KV::kBQ) ||
      !tensor_map(&tk, k, DQK, B, p.Hkv, p.S, ks, KV::kBK) ||
      !tensor_map(&tv, v, DV, B, p.Hkv, p.S, vs, KV::kBK) ||
      !tensor_map(&tq2, q, DQK, B, p.H, p.S, qs, Q::kBQ) ||
      !tensor_map(&tdo2, dO, DV, B, p.H, p.S, dos, Q::kBQ))
    return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)B * p.H * p.s_pad;
  flash_train_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(dO), dos,
      static_cast<const float*>(o32), o32s, delta, B, p.H, p.S, p.s_pad, DV);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid_kv(p.Hkv, B, (p.S + KV::kBK - 1) / KV::kBK);
  flash_train_dkdv_kernel<DQK, DV><<<grid_kv, kThreads, KV::kSmemBytes,
                                     stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk), dks,
      static_cast<__nv_bfloat16*>(dv), dvs, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid_q(p.H, B, (p.S + Q::kBQ - 1) / Q::kBQ);
  flash_train_dq_kernel<DQK, DV><<<grid_q, kThreads, Q::kSmemBytes, stream>>>(
      tq2, tk, tv, tdo2, lse, delta, static_cast<__nv_bfloat16*>(dq), dqs, p);
  return (int)cudaGetLastError();
}

bool valid(int B, int H, int Hkv, int S, int window) {
  return B > 0 && H > 0 && Hkv > 0 && H % Hkv == 0 && S > 0 && window >= 0 &&
         B <= 65535 && H <= 65535;
}

}  // namespace

// The least and largest of each 64 positions of pos (S,) into bmin, bmax
// (ceil(S / 64) each).  Launches on `stream`; returns cudaGetLastError().
extern "C" int flash_train_bounds(const int64_t* pos, int S, int64_t* bmin,
                                  int64_t* bmax, void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  flash_train_bounds_kernel<<<(S + kPosRows - 1) / kPosRows, kPosRows, 0,
                              static_cast<cudaStream_t>(stream)>>>(pos, S,
                                                                   bmin, bmax);
  return (int)cudaGetLastError();
}

// Forward.  q (B, S, H, Dqk), k (B, S, Hkv, Dqk), v (B, S, Hkv, Dv), o like
// v with H heads (bf16), o32 likewise in fp32 or null (not written: a
// forward with no backward to follow); strides in elements, (b, h,
// s) for each of q, k, v, o, o32 (q, k, v as TMA takes them: 16-byte-aligned
// addresses, strides of multiples of 8 elements); lse (B, H, s_pad) fp32
// with s_pad = S rounded up to 128.  pos (S,) int64 and its bounds from
// flash_train_bounds.  (Dqk, Dv): (192, 128) or (128, 128).
extern "C" int flash_train_fwd(
    const void* q, const void* k, const void* v, void* o, void* o32,
    float* lse, int Dqk, int Dv, int B, int H, int Hkv, int S, int64_t qsb,
    int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
    int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
    int64_t oss, int64_t fsb, int64_t fsh, int64_t fss, const int64_t* pos,
    const int64_t* bmin, const int64_t* bmax, int window, float scale,
    void* stream) {
  if (!valid(B, H, Hkv, S, window)) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss}, fs{fsb, fsh, fss};
  const Params p{H, Hkv, S, (S + kPad - 1) / kPad * kPad, window, scale, pos,
                 bmin, bmax};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dqk == 192 && Dv == 128)
    return launch_fwd<192, 128>(q, k, v, o, o32, lse, qs, ks, vs, os, fs, B,
                                p, st);
  if (Dqk == 128 && Dv == 128)
    return launch_fwd<128, 128>(q, k, v, o, o32, lse, qs, ks, vs, os, fs, B,
                                p, st);
  return (int)cudaErrorInvalidValue;
}

// Backward: Delta into delta (B, H, s_pad) fp32, then dK and dV, then dQ,
// each (bf16) like its input, through its strides.  o32 and lse from the
// forward; dO like o.
extern "C" int flash_train_bwd(
    const void* q, const void* k, const void* v, const void* o32,
    const void* dO, void* dq, void* dk, void* dv, const float* lse,
    float* delta, int Dqk, int Dv, int B, int H, int Hkv, int S, int64_t qsb,
    int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
    int64_t vsb, int64_t vsh, int64_t vss, int64_t fsb, int64_t fsh,
    int64_t fss, int64_t gsb, int64_t gsh, int64_t gss, int64_t dqsb,
    int64_t dqsh, int64_t dqss, int64_t dksb, int64_t dksh, int64_t dkss,
    int64_t dvsb, int64_t dvsh, int64_t dvss, const int64_t* pos,
    const int64_t* bmin, const int64_t* bmax, int window, float scale,
    void* stream) {
  if (!valid(B, H, Hkv, S, window)) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      fs{fsb, fsh, fss}, gs{gsb, gsh, gss}, dqs{dqsb, dqsh, dqss},
      dks{dksb, dksh, dkss}, dvs{dvsb, dvsh, dvss};
  const Params p{H, Hkv, S, (S + kPad - 1) / kPad * kPad, window, scale, pos,
                 bmin, bmax};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dqk == 192 && Dv == 128)
    return launch_bwd<192, 128>(q, k, v, o32, dO, dq, dk, dv, lse, delta, qs,
                                ks, vs, fs, gs, dqs, dks, dvs, B, p, st);
  if (Dqk == 128 && Dv == 128)
    return launch_bwd<128, 128>(q, k, v, o32, dO, dq, dk, dv, lse, delta, qs,
                                ks, vs, fs, gs, dqs, dks, dvs, B, p, st);
  return (int)cudaErrorInvalidValue;
}

// dynamic shared memory of one CTA: kernel 0 forward, 1 dK/dV, 2 dQ; -1 for
// a pair the source does not instantiate
extern "C" int flash_train_smem_bytes(int kernel, int Dqk, int Dv) {
  const int key = kernel * 1000000 + Dqk * 1000 + Dv;
  switch (key) {
    case 192128: return FwdTile<192, 128>::kSmemBytes;
    case 128128: return FwdTile<128, 128>::kSmemBytes;
    case 1192128: return KvTile<192, 128>::kSmemBytes;
    case 1128128: return KvTile<128, 128>::kSmemBytes;
    case 2192128: return QTile<192, 128>::kSmemBytes;
    case 2128128: return QTile<128, 128>::kSmemBytes;
  }
  return -1;
}
