// Selective-scan (Mamba S6) backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dimsum_tpu/ops/selective_scan_bwd.py::
// _bwd_kernel (launched from selective_scan_bwd_pallas).  Given the saved
// chunk-start states of the training forward (selective_scan_fwd_train.cu)
// and go = dL/ds (s = sum_n C_n h_n, the pre-skip, pre-gate output), it
// solves the reverse recurrence of the JAX docstring
// (selective_scan_bwd.py:27-36) per batch b and channel d:
//
//   dt'   = softplus(raw), raw = <dt_low_t, dt_w[:, d]> + bias_d
//   a_t   = exp(dt'_t A_dn),  h_t = a_t h_{t-1} + dt'_t u_t B_tn
//   e_t   = C_tn go_t + a_{t+1} e_{t+1}                 (reverse in time)
//   du_t  = dt'_t sum_n e_t B_tn                        (scan part of du)
//   ddt_t = (u_t sum_n e_t B_tn + sum_n e_t h_{t-1} a_t A_dn) sigmoid(raw)
//   dB_tn = sum_d e_t dt'_t u_t     dC_tn = sum_d go_t h_tn
//   dA_dn = sum_{b,t} e_t h_{t-1} a_t dt'_t
//
// Outputs, all fp32: du, ddt (batch, L, dim); dB and dC as one partial per
// warp of 32 channels, (ceil(dim / 32), batch, L, N); dA as one partial per
// batch row, (batch, dim, N).  The wrapper sums the partials (no float
// atomics, so gradients are the same from run to run).  Inputs: u, dt_low
// (batch, L, r), dt_w (r, dim), B, C (batch, L, N) in T (float or bf16);
// A (dim, N), bias (dim,), go (batch, L, dim), bnd (batch, ceil(L / 16), N,
// dim) in fp32.
//
// What bounds it on an H100 at the DiM-L/2 training mixer shape (batch 16,
// L 256, dim 1024, N 16, r 32, bf16): inputs read once (u 8.4 MB, go and
// the states 16.8 MB each, the rest 0.7 MB) and du, ddt (16.8 MB each),
// dA, dB, dC written once, 76.7 MB or 22.9 us at 3.35 TB/s; the fp32 work
// is 2r + 20N + 18 = 402 flop per (b, t, d) (the replay: dt expansion,
// softplus, sigmoid, 5 per state; the reverse step: 15 per state), 1.69
// GFLOP or 25.2 us at 67 TFLOP/s.  Operations bound it, by a little; the
// 32 exp2 per (b, t, d) also need the special-function units (~48 us at 16
// per SM per clock and 1.98 GHz).
//
// Design (simple first): one thread per channel, a block of 64 channels
// (two warps) per (batch, channel block), each thread walking the chunks
// of kChunk = 16 steps from the last to the first with its N-long carry
// a_{t+1} e_{t+1} in registers.  Per chunk it
//   1. stages dt_low, B and C of the chunk (shared by the block), and its
//      own u and go, in shared memory;
//   2. replays the chunk forward from the saved state and keeps the 17
//      states h_{t0-1} .. h_{t0+15} in shared memory, laid out
//      [step][n][thread] so that a warp's accesses are conflict-free:
//      17 x N x 64 x 4 B = 68 KB at N 16 (139 KB at N 32), which is why
//      the chunk is 16 and the block 64 channels: 128 channels or 32 steps
//      would need 136 KB at N 16 and 278 KB at N 32, over the 227 KB a
//      block may have;
//   3. walks the chunk backwards, writing du and ddt (coalesced along d),
//      accumulating dA in registers, and reducing the dB and dC terms over
//      the warp's 32 channels with xor shuffles (lane n stores state n).
// Dynamic shared memory, ~90 KB at N 16: two blocks (4 warps) per SM.  The
// time loop is sequential and latency-bound, as kernel 1's is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // channels per block (two warps)
constexpr int kChunk = 16;    // steps between saved states (the contract)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int NMAX, int RMAX>
constexpr size_t smem_floats() {
  return (size_t)(kChunk + 1) * NMAX * kThreads  // states
         + kChunk * RMAX + 2 * kChunk * NMAX     // dt_low, B, C
         + 4 * kChunk * kThreads;                // u, go, dt', sigmoid
}

template <typename T, int NMAX, int RMAX>
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt_low,
                const T* __restrict__ dt_w, const float* __restrict__ A,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ bias, const float* __restrict__ go,
                const float* __restrict__ bnd, float* __restrict__ du,
                float* __restrict__ ddt, float* __restrict__ dB_part,
                float* __restrict__ dC_part, float* __restrict__ dA_part,
                int batch, int L, int dim, int N, int R, int use_softplus) {
  extern __shared__ __align__(16) float smem[];
  float* s_h = smem;  // [kChunk + 1][NMAX][kThreads]
  float* s_dtl = s_h + (kChunk + 1) * NMAX * kThreads;  // [kChunk][RMAX]
  float* s_B = s_dtl + kChunk * RMAX;                   // [kChunk][NMAX]
  float* s_C = s_B + kChunk * NMAX;                     // [kChunk][NMAX]
  float* s_u = s_C + kChunk * NMAX;                     // [kChunk][kThreads]
  float* s_go = s_u + kChunk * kThreads;
  float* s_dt = s_go + kChunk * kThreads;
  float* s_sig = s_dt + kChunk * kThreads;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int d = blockIdx.y * kThreads + tid;
  const bool active = d < dim;
  const int part = d >> 5;                  // this warp's dB/dC partial
  const bool warp_live = (part << 5) < dim;  // some lane of it is a channel
  const int n_chunks = (L + kChunk - 1) / kChunk;
  const size_t row0 = (size_t)b * L;

  // Lanes past the ragged edge of dim run with zero u, go and state, so
  // they add nothing to the warp sums and every lane takes the shuffles.
  float w[RMAX], a2[NMAX], carry[NMAX], dA[NMAX];
#pragma unroll
  for (int k = 0; k < RMAX; ++k)
    w[k] = (active && k < R) ? to_f32(dt_w[(size_t)k * dim + d]) : 0.f;
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    a2[n] = (active && n < N) ? A[(size_t)d * N + n] * kLog2e : 0.f;
    carry[n] = 0.f;
    dA[n] = 0.f;
  }
  const float dbias = (bias != nullptr && active) ? bias[d] : 0.f;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    const int nt = min(kChunk, L - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < kChunk * RMAX; i += kThreads) {
      const int tt = i / RMAX, k = i % RMAX;
      s_dtl[i] = (tt < nt && k < R)
                     ? to_f32(dt_low[(row0 + t0 + tt) * R + k]) : 0.f;
    }
    for (int i = tid; i < kChunk * NMAX; i += kThreads) {
      const int tt = i / NMAX, n = i % NMAX;
      const bool ok = tt < nt && n < N;
      const size_t src = (row0 + t0 + tt) * N + n;
      s_B[i] = ok ? to_f32(Bm[src]) : 0.f;
      s_C[i] = ok ? to_f32(Cm[src]) : 0.f;
    }
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      const bool ok = active && tt < nt;
      const size_t idx = (row0 + t0 + tt) * dim + d;
      s_u[tt * kThreads + tid] = ok ? to_f32(u[idx]) : 0.f;
      s_go[tt * kThreads + tid] = ok ? go[idx] : 0.f;
    }
    const float* h0 = bnd + (((size_t)b * n_chunks + c) * N) * dim + d;
    float h[NMAX];
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      h[n] = (active && n < N) ? h0[(size_t)n * dim] : 0.f;
      s_h[n * kThreads + tid] = h[n];
    }
    __syncthreads();

    // 1. replay: the states of the chunk from its saved start
    for (int tt = 0; tt < nt; ++tt) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const float4* dt4 = reinterpret_cast<const float4*>(s_dtl + tt * RMAX);
#pragma unroll
      for (int q = 0; q < RMAX / 4; ++q) {
        const float4 v = dt4[q];
        acc[0] = fmaf(v.x, w[4 * q], acc[0]);
        acc[1] = fmaf(v.y, w[4 * q + 1], acc[1]);
        acc[2] = fmaf(v.z, w[4 * q + 2], acc[2]);
        acc[3] = fmaf(v.w, w[4 * q + 3], acc[3]);
      }
      const float raw = (acc[0] + acc[1]) + (acc[2] + acc[3]) + dbias;
      const float dt = use_softplus ? softplus(raw) : raw;
      s_dt[tt * kThreads + tid] = dt;
      s_sig[tt * kThreads + tid] = 1.f / (1.f + expf(-raw));
      const float dtu = dt * s_u[tt * kThreads + tid];
      float* hs = s_h + (size_t)(tt + 1) * NMAX * kThreads + tid;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        h[n] = fmaf(exp2f(dt * a2[n]), h[n], dtu * s_B[tt * NMAX + n]);
        hs[n * kThreads] = h[n];
      }
    }

    // 2. the reverse step, last to first
    for (int tt = nt - 1; tt >= 0; --tt) {
      const float dt = s_dt[tt * kThreads + tid];
      const float uv = s_u[tt * kThreads + tid];
      const float gv = s_go[tt * kThreads + tid];
      const float dtu = dt * uv;
      const float* hp = s_h + (size_t)tt * NMAX * kThreads + tid;  // h_{t-1}
      const float* ht = hp + NMAX * kThreads;                      // h_t
      float eB = 0.f, daA = 0.f, outB = 0.f, outC = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        const float a = exp2f(dt * a2[n]);
        const float e = fmaf(s_C[tt * NMAX + n], gv, carry[n]);
        const float da_a = e * hp[n * kThreads] * a;
        eB = fmaf(e, s_B[tt * NMAX + n], eB);
        daA = fmaf(da_a, a2[n], daA);  // sum da*a*A, A = a2 * ln 2
        dA[n] = fmaf(da_a, dt, dA[n]);
        carry[n] = a * e;
        const float sB = warp_sum(e * dtu);
        const float sC = warp_sum(gv * ht[n * kThreads]);
        if (lane == n) {
          outB = sB;
          outC = sC;
        }
      }
      const size_t t = t0 + tt;
      if (active) {
        const size_t idx = (row0 + t) * dim + d;
        du[idx] = eB * dt;
        const float g = fmaf(eB, uv, daA * kLn2);
        ddt[idx] = use_softplus ? g * s_sig[tt * kThreads + tid] : g;
      }
      if (warp_live && lane < N) {
        const size_t o = (((size_t)part * batch + b) * L + t) * N + lane;
        dB_part[o] = outB;
        dC_part[o] = outC;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n)
      if (n < N) dA_part[((size_t)b * dim + d) * N + n] = dA[n];
  }
}

template <typename T, int NMAX, int RMAX>
int launch(const void* const* p, int batch, int L, int dim, int N, int R,
           int use_softplus, cudaStream_t stream) {
  auto kernel = scan_bwd_kernel<T, NMAX, RMAX>;
  const size_t bytes = smem_floats<NMAX, RMAX>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(batch, (dim + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const float*>(p[3]),
      static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
      static_cast<const float*>(p[6]), static_cast<const float*>(p[7]),
      static_cast<const float*>(p[8]),
      static_cast<float*>(const_cast<void*>(p[9])),
      static_cast<float*>(const_cast<void*>(p[10])),
      static_cast<float*>(const_cast<void*>(p[11])),
      static_cast<float*>(const_cast<void*>(p[12])),
      static_cast<float*>(const_cast<void*>(p[13])), batch, L, dim, N, R,
      use_softplus);
  return cudaGetLastError();
}

template <typename T, int NMAX>
int dispatch_r(const void* const* p, int batch, int L, int dim, int N, int R,
               int sp, cudaStream_t s) {
  if (R <= 16) return launch<T, NMAX, 16>(p, batch, L, dim, N, R, sp, s);
  if (R <= 32) return launch<T, NMAX, 32>(p, batch, L, dim, N, R, sp, s);
  if (R <= 64) return launch<T, NMAX, 64>(p, batch, L, dim, N, R, sp, s);
  return cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* const* p, int batch, int L, int dim, int N, int R,
             int sp, cudaStream_t s) {
  if (N <= 8) return dispatch_r<T, 8>(p, batch, L, dim, N, R, sp, s);
  if (N <= 16) return dispatch_r<T, 16>(p, batch, L, dim, N, R, sp, s);
  if (N <= 32) return dispatch_r<T, 32>(p, batch, L, dim, N, R, sp, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bias may be null.  bnd holds the
// states the training forward saved every kChunk steps.  Returns the CUDA
// error of the launch (0 on success), or cudaErrorInvalidValue for shapes
// the kernel does not take (1 <= N <= 32, 1 <= r <= 64).
extern "C" int dimsum_selective_scan_bwd(
    const void* u, const void* dt_low, const void* dt_w, const void* A,
    const void* B, const void* C, const void* bias, const void* go,
    const void* bnd, void* du, void* ddt, void* dB_part, void* dC_part,
    void* dA_part, int batch, int L, int dim, int n_state, int dt_rank,
    int dtype, int use_softplus, void* stream) {
  if (batch < 1 || L < 1 || dim < 1 || n_state < 1 || dt_rank < 1 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const void* p[14] = {u,  dt_low, dt_w,    A,       B,      C,  bias,
                       go, bnd,    du,      ddt,     dB_part, dC_part,
                       dA_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(p, batch, L, dim, n_state, dt_rank,
                                      use_softplus, s)
                    : dispatch<__nv_bfloat16>(p, batch, L, dim, n_state,
                                              dt_rank, use_softplus, s);
}
