// The RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// Per (batch b, head h), with an N x N fp32 state S (rows: key channel i,
// columns: value channel j):
//
//   o_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j]
//
// the output from the state before step t, then the update, in the
// reference's order (kv first, then the output, then the new state).
// r, k, v, w: (B, T, H, N) fp32 contiguous; u: (H, N); state0: (B, H, N, N)
// or null (zeros); out: (B, T, H, N) fp32; sT: (B, H, N, N) fp32.
//
// Replaces the TPU kernel src/repro/kernels/wkv6/kernel.py:64
// (wkv6_kernel, a pl.pallas_call over a (B, H, time chunk) grid whose
// chunk axis runs in order and keeps S in VMEM scratch across it; the op
// pads T to the chunk with w = 1, k = 0 steps).
//
// What bounds it on the card: the serial time chain, and on one SM the
// shared-memory pipe.  The bytes are one read of r, k, v, w and one write
// of out (at the main path's (4, 2048, 32, 64): about 340 MB, 0.10 ms at
// 3.35 TB/s), and the fp32 work 7 flops a (step, i, j) (7.5e9, 0.11 ms at
// 67 TFLOP/s), but the 2048 steps of one (b, h) depend on each other, and
// there are only B x H = 128 chains for the card's 132 SMs: one chain an
// SM, so the time is 2048 x what one step of one (b, h) takes on one SM.
// A step is 4 N^2 fp32 operations (128 issue cycles of the SM's four
// schedulers at N = 64), and every (i, j) needs r_t[i], k_t[i], w_t[i]
// and v_t[j] in the registers of the thread that holds S[i][j]: a thread
// holding one column reads 12 N^2 bytes of shared memory a step, 384
// cycles of the SM's 128 bytes a cycle, whatever the split of the rows.
//
// What the design does about that:
//  * one CTA per (b, h) with (N / C) x G threads: thread (jg, g) keeps an
//    R x C block of S in registers for the whole run, R = N / G rows of
//    slice g (the float4 groups 4 (g + G m) .. 4 (g + G m) + 3, so the G
//    slices of a float4 load are neighbouring 16-byte words) by the C
//    columns C jg .. C jg + C - 1.  A thread reads 3R + C values a step
//    for 4 R C operations, so the shared bytes a step fall to
//    4 N^2 (3 / C + 1 / R): at N = 64, G = 16, C = 4 (256 threads, two
//    warps on each scheduler) 16 KB, a third of what one column a thread
//    reads;
//  * a (step, i, j) costs four fp32 operations: kv = k v_j, t = u kv + S
//    (u in registers: it is constant in time), o += r t, S = w S + kv,
//    with r_t, k_t, w_t read as float4 and v_t as one C-wide load, all a
//    step ahead of their use, so a step waits on no shared load;
//  * the G partial sums of o_t[j] (one a row slice) go to shared memory,
//    and are summed once a chunk's steps are done, pairwise in slice
//    order, ((p_0 + p_1) + (p_2 + p_3)) + ..., by all threads at once, a
//    step's N outputs stored together: no shuffle and no store waits
//    inside a step.  Every sum's order is fixed by (i, j) alone, never by
//    where a chunk or T starts, so two halves chained through the state
//    equal one pass bit for bit;
//  * time runs in chunks of 2048 / N steps (1024 / N where a chunk's
//    partials would not fit beside the ring): r, k, v, w of a chunk are
//    copied into a 3-stage shared ring with 16-byte cp.async (4-byte
//    where a tensor is not 16-byte aligned) two chunks ahead of the one
//    being computed, so a step waits on no global load and two barriers
//    serve a whole chunk;
//  * the loop runs to T exactly: no padding steps and no padded copies.
// On an H100 80GB HBM3 at 700 W, (G, C) = (16, 4) ran fastest of (4, 1),
// (8, 1), (8, 2), (8, 4) and (16, 4) (PERF.md §6).  A step still
// takes about 0.2 us against the 128 issue cycles (~0.07 us) of its
// arithmetic.  What holds it there is not measured (ncu does not run on
// that machine); the suspects are the shared-memory pipe (a warp's float4
// load is four wavefronts, and a step makes 3 N^2 / (32 C) of them for r,
// k, w) and the latency inside one step.  The chunked, parallel-in-time
// form of the recurrence would take both off the serial path.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;
constexpr int kSmemMax = 232448;          // an SM's shared memory for a CTA

// shared bytes for (N, G) with chunks of E elements of each of r, k, v, w:
// the input ring, then the G partial outputs of each (step, column) of a
// chunk, rows padded by 4 floats so the G slices of a warp's stores hit
// distinct banks
__host__ __device__ constexpr int smem_bytes(int N, int G, int E) {
  return kStages * 4 * E * 4 + (E / N) * G * (N + 4) * 4;
}

// chunk steps x N: 2048, or 1024 where the partials of 2048 do not fit
__host__ __device__ constexpr int chunk_elems(int N, int G) {
  return smem_bytes(N, G, 2048) <= kSmemMax ? 2048 : 1024;
}

// One CTA per (b, h), (N / C) x G threads: thread (jg, g) holds columns
// C jg .. C jg + C - 1 of S, rows row(m) of slice g.
template <int N, int G, int C, bool kVec>
__global__ void __launch_bounds__(N / C * G)
wkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, const float* __restrict__ state0,
         float* __restrict__ out, float* __restrict__ sT, int T, int H) {
  static_assert(N % G == 0 && (C == 1 || C == 2 || C == 4) && N % C == 0,
                "a split of the state");
  constexpr int E = chunk_elems(N, G);    // chunk steps x N
  static_assert(smem_bytes(N, G, E) <= kSmemMax, "shared memory of an SM");
  constexpr int kThreads = N / C * G;
  constexpr int CH = E / N;               // steps a chunk
  constexpr int R = N / G;                // rows of S a thread holds
  constexpr bool kQuad = R % 4 == 0;      // rows in float4 groups
  constexpr int PS = N + 4;               // row stride of the partials
  extern __shared__ __align__(16) float smem[];   // [stage][r,k,v,w][CH][N]
  float* part = smem + kStages * 4 * E;          // [CH][G][PS]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int g = threadIdx.x % G;
  const int j0 = C * (threadIdx.x / G);   // this thread's first column
  const int64_t tstride = (int64_t)H * N;            // one step in r/k/v/w
  const int64_t base = (int64_t)b * T * tstride + (int64_t)h * N;
  const int64_t sbase = ((int64_t)b * H + h) * N * N;

  // row i of the m-th state row of this thread
  auto row = [&](int m) {
    return kQuad ? 4 * (g + G * (m / 4)) + (m % 4) : g + G * m;
  };
  float S[R][C], uu[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = row(m);
#pragma unroll
    for (int c = 0; c < C; ++c)
      S[m][c] = state0 != nullptr ? state0[sbase + (int64_t)i * N + j0 + c]
                                  : 0.f;
    uu[m] = u[(int64_t)h * N + i];
  }

  const int nchunks = (T + CH - 1) / CH;
  auto issue = [&](int c) {
    if (c < nchunks) {
      const int t0 = c * CH;
      const int steps = min(CH, T - t0);
      float* dst = smem + (c % kStages) * 4 * E;
      constexpr int kWidth = kVec ? 4 : 1;  // floats a copy
      constexpr int Q = N / kWidth;         // copies a step
      for (int e = threadIdx.x; e < 4 * CH * Q; e += kThreads) {
        const int a = e / (CH * Q);         // divisions by constants
        const int rem = e - a * CH * Q;
        const int tt = rem / Q, q = rem - tt * Q;
        if (tt >= steps) continue;
        const float* src = a == 0 ? r : a == 1 ? k : a == 2 ? v : w;
        __pipeline_memcpy_async(
            dst + a * E + tt * N + kWidth * q,
            src + base + (int64_t)(t0 + tt) * tstride + kWidth * q,
            4 * kWidth);
      }
    }
    __pipeline_commit();                   // empty past the end: counts stay
  };

  issue(0);
  issue(1);
  for (int c = 0; c < nchunks; ++c) {
    __pipeline_wait_prior(1);              // chunk c has landed ...
    __syncthreads();                       // ... for every thread, and chunk
    issue(c + 2);                          // c - 1's stage is free to refill
    const int t0 = c * CH;
    const int steps = min(CH, T - t0);
    const float* cur = smem + (c % kStages) * 4 * E;
    // a step's inputs, read into registers a step ahead of their use
    auto load_v = [&](int tt, float (&vv)[C]) {
      const float* vt = cur + 2 * E + tt * N + j0;
      if constexpr (C == 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(vt);
        vv[0] = v4.x, vv[1] = v4.y, vv[2] = v4.z, vv[3] = v4.w;
      } else if constexpr (C == 2) {
        const float2 v2 = *reinterpret_cast<const float2*>(vt);
        vv[0] = v2.x, vv[1] = v2.y;
      } else {
        vv[0] = vt[0];
      }
    };
    constexpr int Q4 = kQuad ? R / 4 : 1;
    auto load_rkw = [&](int tt, float4 (&r4)[Q4], float4 (&k4)[Q4],
                        float4 (&w4)[Q4]) {
      if constexpr (kQuad) {
#pragma unroll
        for (int m4 = 0; m4 < Q4; ++m4) {
          const int q = g + G * m4;
          r4[m4] = reinterpret_cast<const float4*>(cur + tt * N)[q];
          k4[m4] = reinterpret_cast<const float4*>(
              cur + E + tt * N)[q];
          w4[m4] = reinterpret_cast<const float4*>(
              cur + 3 * E + tt * N)[q];
        }
      }
    };
    float vn[C];
    float4 rn[Q4], kn[Q4], wn[Q4];
    if (steps > 0) {
      load_v(0, vn);
      load_rkw(0, rn, kn, wn);
    }
    for (int tt = 0; tt < steps; ++tt) {
      float vv[C];
      float4 r4[Q4], k4[Q4], w4[Q4];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) vv[cc] = vn[cc];
#pragma unroll
      for (int m4 = 0; m4 < Q4; ++m4) r4[m4] = rn[m4], k4[m4] = kn[m4],
                                      w4[m4] = wn[m4];
      if (tt + 1 < steps) {
        load_v(tt + 1, vn);
        load_rkw(tt + 1, rn, kn, wn);
      }
      float o[C];
#pragma unroll
      for (int cc = 0; cc < C; ++cc) o[cc] = 0.f;
      auto update = [&](int m, float rr, float kk, float ww) {
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          const float kv = kk * vv[cc];
          o[cc] = fmaf(rr, fmaf(uu[m], kv, S[m][cc]), o[cc]);
          S[m][cc] = fmaf(ww, S[m][cc], kv);
        }
      };
      if constexpr (kQuad) {
#pragma unroll
        for (int m4 = 0; m4 < Q4; ++m4) {
          update(4 * m4, r4[m4].x, k4[m4].x, w4[m4].x);
          update(4 * m4 + 1, r4[m4].y, k4[m4].y, w4[m4].y);
          update(4 * m4 + 2, r4[m4].z, k4[m4].z, w4[m4].z);
          update(4 * m4 + 3, r4[m4].w, k4[m4].w, w4[m4].w);
        }
      } else {
        const float* rt = cur + tt * N;
        const float* kt = cur + E + tt * N;
        const float* wt = cur + 3 * E + tt * N;
#pragma unroll
        for (int m = 0; m < R; ++m) {
          const int i = row(m);
          update(m, rt[i], kt[i], wt[i]);
        }
      }
      float* pt = part + (tt * G + g) * PS + j0;
      if constexpr (C == 4) {
        *reinterpret_cast<float4*>(pt) = make_float4(o[0], o[1], o[2], o[3]);
      } else if constexpr (C == 2) {
        *reinterpret_cast<float2*>(pt) = make_float2(o[0], o[1]);
      } else {
        pt[0] = o[0];
      }
    }
    __syncthreads();                       // every partial of the chunk
    // o_t[j]: the G slices' partials summed pairwise in slice order,
    // ((p0 + p1) + (p2 + p3)) + ..., one (step, column) a thread, and
    // stored a step's N columns together
    for (int e = threadIdx.x; e < steps * N; e += kThreads) {
      const int tt = e / N, j = e - tt * N;
      float p[G];
#pragma unroll
      for (int gg = 0; gg < G; ++gg) p[gg] = part[(tt * G + gg) * PS + j];
#pragma unroll
      for (int x = 1; x < G; x <<= 1)
#pragma unroll
        for (int gg = 0; gg < G; gg += 2 * x) p[gg] += p[gg + x];
      out[base + (int64_t)(t0 + tt) * tstride + j] = p[0];
    }
  }
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c)
      sT[sbase + (int64_t)row(m) * N + j0 + c] = S[m][c];
}

template <int N, int G, int C>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* out, float* sT, int B,
           int T, int H, cudaStream_t stream) {
  constexpr int kDevices = 64;
  static bool opted_in[2][kDevices] = {};  // the shared-memory opt-in
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const bool vec = ((reinterpret_cast<uintptr_t>(r) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) |
                     reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  auto kernel = vec ? wkv6_fwd<N, G, C, true> : wkv6_fwd<N, G, C, false>;
  constexpr int bytes = smem_bytes(N, G, chunk_elems(N, G));
  if (dev >= kDevices || !opted_in[vec][dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < kDevices) opted_in[vec][dev] = true;
  }
  kernel<<<(unsigned)(B * H), N / C * G, bytes, stream>>>(
      r, k, v, w, u, s0, out, sT, T, H);
  return (int)cudaGetLastError();
}

// the split of the state for N: 256 threads a CTA at N = 64 and 32, G
// row slices by C columns a thread
int dispatch(const float* r, const float* k, const float* v, const float* w,
             const float* u, const float* s0, float* out, float* sT, int B,
             int T, int H, int N, cudaStream_t s) {
  switch (N) {
    case 8: return launch<8, 8, 1>(r, k, v, w, u, s0, out, sT, B, T, H, s);
    case 16: return launch<16, 8, 1>(r, k, v, w, u, s0, out, sT, B, T, H, s);
    case 32: return launch<32, 8, 2>(r, k, v, w, u, s0, out, sT, B, T, H, s);
    case 64: return launch<64, 16, 4>(r, k, v, w, u, s0, out, sT, B, T, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// N: 8, 16, 32 or 64.  state0 may be null (zeros).  Launches on
// `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int wkv6_fwd_f32(const float* r, const float* k, const float* v,
                            const float* w, const float* u,
                            const float* state0, float* out, float* sT,
                            int B, int T, int H, int N, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || (int64_t)B * H > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return dispatch(r, k, v, w, u, state0, out, sT, B, T, H, N,
                  static_cast<cudaStream_t>(stream));
}
