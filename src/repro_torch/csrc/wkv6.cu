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
// What bounds it on the card: the serial time chain.  The bytes are one
// read of r, k, v, w and one write of out (at the main path's (4, 2048,
// 32, 64): about 340 MB, 0.10 ms at 3.35 TB/s), and the fp32 work 7 flops a
// (step, i, j) (7.5e9, 0.11 ms at 67 TFLOP/s), but the 2048 steps of one
// (b, h) depend on each other, and there are only B x H = 128 chains for
// the card's 132 SMs: the time is 2048 x the latency of one step.
//
// What the design does about that:
//  * one CTA per (b, h) with N threads; thread j owns column j of S in
//    registers for the whole run, so the state never leaves the SM;
//  * time runs in chunks of 1024 / N steps: r, k, v, w of a chunk are
//    copied into shared memory with cp.async while the previous chunk is
//    computed (double buffering), so a step waits on no global load and
//    two barriers serve a whole chunk; r_t[i], k_t[i], w_t[i] are
//    broadcast reads every thread of the CTA makes alike;
//  * the sum over i runs in four partial sums, which shortens the
//    dependent chain of a step fourfold;
//  * the loop runs to T exactly: no padding steps and no padded copies.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkElems = 1024;         // chunk steps x N

template <int N>
__global__ void __launch_bounds__(N)
wkv6_fwd(const float* __restrict__ r, const float* __restrict__ k,
         const float* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, const float* __restrict__ state0,
         float* __restrict__ out, float* __restrict__ sT, int T, int H) {
  constexpr int CH = kChunkElems / N;     // steps a chunk
  __shared__ float buf[2][4][CH][N];      // [buffer][r, k, v, w][step][i]
  __shared__ float us[N];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int j = threadIdx.x;
  const int64_t tstride = (int64_t)H * N;            // one step in r/k/v/w
  const int64_t base = (int64_t)b * T * tstride + (int64_t)h * N;
  const int64_t sbase = ((int64_t)b * H + h) * N * N;
  const float* src[4] = {r, k, v, w};

  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    S[i] = state0 != nullptr ? state0[sbase + (int64_t)i * N + j] : 0.f;
  us[j] = u[(int64_t)h * N + j];

  const int nchunks = (T + CH - 1) / CH;
  auto issue = [&](int c) {
    const int t0 = c * CH;
    const int steps = min(CH, T - t0);
    float(*dst)[CH][N] = buf[c & 1];
    for (int tt = 0; tt < steps; ++tt) {
      const int64_t off = base + (int64_t)(t0 + tt) * tstride + j;
#pragma unroll
      for (int a = 0; a < 4; ++a)
        __pipeline_memcpy_async(&dst[a][tt][j], src[a] + off, sizeof(float));
    }
    __pipeline_commit();
  };

  issue(0);
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      issue(c + 1);
      __pipeline_wait_prior(1);            // chunk c has landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();                       // ... for every thread
    const int t0 = c * CH;
    const int steps = min(CH, T - t0);
    const float(*cur)[CH][N] = buf[c & 1];
    for (int tt = 0; tt < steps; ++tt) {
      const float* rt = cur[0][tt];
      const float* kt = cur[1][tt];
      const float vj = cur[2][tt][j];
      const float* wt = cur[3][tt];
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float kv = kt[i] * vj;
        o[i & 3] += rt[i] * (S[i] + us[i] * kv);
        S[i] = wt[i] * S[i] + kv;
      }
      out[base + (int64_t)(t0 + tt) * tstride + j] = (o[0] + o[1]) + (o[2] + o[3]);
    }
    __syncthreads();                       // buf[c & 1] is free to refill
  }
#pragma unroll
  for (int i = 0; i < N; ++i) sT[sbase + (int64_t)i * N + j] = S[i];
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* out, float* sT, int B,
           int T, int H, cudaStream_t stream) {
  wkv6_fwd<N><<<(unsigned)(B * H), N, 0, stream>>>(r, k, v, w, u, s0, out,
                                                   sT, T, H);
  return (int)cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 8: return launch<8>(r, k, v, w, u, state0, out, sT, B, T, H, s);
    case 16: return launch<16>(r, k, v, w, u, state0, out, sT, B, T, H, s);
    case 32: return launch<32>(r, k, v, w, u, state0, out, sT, B, T, H, s);
    case 64: return launch<64>(r, k, v, w, u, state0, out, sT, B, T, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
