// Selective-scan (Mamba S6) training forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// dimsum_tpu/ops/selective_scan_bwd.py::_fwd_train_kernel (launched from
// selective_scan_fwd_train): kernel 1's output y (selective_scan_fwd.cu)
// plus what the backward (selective_scan_bwd.cu) replays from:
//
//   o_t   = sum_n C_tn * h_tn + D_d * u_t      fp32 pre-gate output
//   bnd_c = h at the start of step 16 c        fp32, the first one zero
//
// dt_t = softplus(<dt_low_t, dt_w[:, d]> + bias_d) is expanded in fp32 in
// the kernel, h_t = exp(dt_t * A_dn) * h_{t-1} + dt_t * u_t * B_tn, and
// y_t = o_t * silu(z_t).  Layouts: u, z, y (batch, L, dim) in T; o
// (batch, L, dim) fp32; bnd (batch, ceil(L / 16), N, dim) fp32; dt_low
// (batch, L, r), B, C (batch, L, N), dt_w (r, dim) in T; A (dim, N), D and
// bias (dim,) fp32.  T is float or bf16.
//
// What bounds it on an H100 at the DiM-L/2 training mixer shape (batch 16,
// L 256, dim 1024, N 16, r 32, bf16, chunk 16): inputs read once 17.4 MB,
// y (8.4 MB), o (16.8 MB) and the states (16.8 MB) written once, 59.4 MB
// or 17.7 us at 3.35 TB/s; 2r + 7N + 12 = 188 fp32 flop per (b, t, d),
// 0.79 GFLOP or 11.8 us at 67 TFLOP/s.  Bytes bound it.
//
// Design: kernel 1's (one thread per channel, a block of 128 channels per
// (batch, channel block), dt_low/B/C of 32 steps staged in shared memory
// and read as float4 broadcasts, u and z staged per thread, the N states in
// registers), with two more stores per step: o, coalesced along d, and
// every kSaveEvery steps the N states, coalesced along d in the (N, dim)
// layout.  It inherits kernel 1's low warp count (B * dim / 32 = 512 warps
// for 132 SMs) and its latency-bound time loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 32;     // timesteps staged per shared-memory pass
// steps between saved states: the contract with selective_scan_bwd.cu's
// kChunk (and TRAIN_CHUNK in ops/selective_scan.py)
constexpr int kSaveEvery = 16;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// log(1 + exp(x)) in the overflow-free form jax.nn.softplus uses
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

template <typename T, int NMAX, int RMAX>
__global__ void __launch_bounds__(kThreads)
scan_fwd_train_kernel(const T* __restrict__ u, const T* __restrict__ dt_low,
                      const T* __restrict__ dt_w, const float* __restrict__ A,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ Dv, const T* __restrict__ z,
                      const float* __restrict__ bias, T* __restrict__ out,
                      float* __restrict__ o, float* __restrict__ bnd, int L,
                      int dim, int N, int R, int use_softplus) {
  __shared__ __align__(16) float s_dt[kChunk][RMAX];
  __shared__ __align__(16) float s_B[kChunk][NMAX];
  __shared__ __align__(16) float s_C[kChunk][NMAX];
  __shared__ T s_u[kChunk][kThreads];
  __shared__ T s_z[kChunk][kThreads];

  const int b = blockIdx.x;
  const int d = blockIdx.y * kThreads + threadIdx.x;
  const bool active = d < dim;
  const int n_saved = (L + kSaveEvery - 1) / kSaveEvery;

  float w[RMAX], a2[NMAX], h[NMAX];
#pragma unroll
  for (int k = 0; k < RMAX; ++k)
    w[k] = (active && k < R) ? to_f32(dt_w[(size_t)k * dim + d]) : 0.f;
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    a2[n] = (active && n < N) ? A[(size_t)d * N + n] * kLog2e : 0.f;
    h[n] = 0.f;
  }
  const float skip = (Dv != nullptr && active) ? Dv[d] : 0.f;
  const float dbias = (bias != nullptr && active) ? bias[d] : 0.f;
  const size_t row0 = (size_t)b * L;

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int nt = min(kChunk, L - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < kChunk * RMAX; i += kThreads) {
      const int tt = i / RMAX, k = i % RMAX;
      s_dt[tt][k] = (tt < nt && k < R)
                        ? to_f32(dt_low[(row0 + t0 + tt) * R + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < kChunk * NMAX; i += kThreads) {
      const int tt = i / NMAX, n = i % NMAX;
      const bool ok = tt < nt && n < N;
      const size_t src = (row0 + t0 + tt) * N + n;
      s_B[tt][n] = ok ? to_f32(Bm[src]) : 0.f;
      s_C[tt][n] = ok ? to_f32(Cm[src]) : 0.f;
    }
    if (active) {
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt) {
        if (tt < nt) {
          const size_t idx = (row0 + t0 + tt) * dim + d;
          s_u[tt][threadIdx.x] = u[idx];
          if (z != nullptr) s_z[tt][threadIdx.x] = z[idx];
        }
      }
    }
    __syncthreads();
    if (!active) continue;

    for (int tt = 0; tt < nt; ++tt) {
      const int t = t0 + tt;
      if (t % kSaveEvery == 0) {
        // the state entering step t
        float* dst = bnd + (((size_t)b * n_saved + t / kSaveEvery) * N) * dim
                     + d;
#pragma unroll
        for (int n = 0; n < NMAX; ++n)
          if (n < N) dst[(size_t)n * dim] = h[n];
      }
      const size_t idx = (row0 + t) * dim + d;
      const float uv = to_f32(s_u[tt][threadIdx.x]);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const float4* dt4 = reinterpret_cast<const float4*>(s_dt[tt]);
#pragma unroll
      for (int q = 0; q < RMAX / 4; ++q) {
        const float4 v = dt4[q];
        acc[0] = fmaf(v.x, w[4 * q], acc[0]);
        acc[1] = fmaf(v.y, w[4 * q + 1], acc[1]);
        acc[2] = fmaf(v.z, w[4 * q + 2], acc[2]);
        acc[3] = fmaf(v.w, w[4 * q + 3], acc[3]);
      }
      float dt = (acc[0] + acc[1]) + (acc[2] + acc[3]) + dbias;
      if (use_softplus) dt = softplus(dt);
      const float du = dt * uv;
      float ys[4] = {0.f, 0.f, 0.f, 0.f};
      const float4* b4 = reinterpret_cast<const float4*>(s_B[tt]);
      const float4* c4 = reinterpret_cast<const float4*>(s_C[tt]);
#pragma unroll
      for (int q = 0; q < NMAX / 4; ++q) {
        const float4 bq = b4[q], cq = c4[q];
        const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
        const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 4 * q + j;
          h[n] = fmaf(exp2f(dt * a2[n]), h[n], du * bv[j]);
          ys[j] = fmaf(h[n], cv[j], ys[j]);
        }
      }
      float y = fmaf(uv, skip, (ys[0] + ys[1]) + (ys[2] + ys[3]));
      o[idx] = y;
      if (z != nullptr) {
        const float zv = to_f32(s_z[tt][threadIdx.x]);
        y *= zv / (1.f + expf(-zv));
      }
      out[idx] = from_f32<T>(y);
    }
  }
}

template <typename T, int NMAX, int RMAX>
void launch(const void* const* p, int batch, int L, int dim, int N, int R,
            int use_softplus, cudaStream_t stream) {
  dim3 grid(batch, (dim + kThreads - 1) / kThreads);
  scan_fwd_train_kernel<T, NMAX, RMAX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const float*>(p[3]),
      static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
      static_cast<const float*>(p[6]), static_cast<const T*>(p[7]),
      static_cast<const float*>(p[8]),
      static_cast<T*>(const_cast<void*>(p[9])),
      static_cast<float*>(const_cast<void*>(p[10])),
      static_cast<float*>(const_cast<void*>(p[11])), L, dim, N, R,
      use_softplus);
}

template <typename T, int NMAX>
bool dispatch_r(const void* const* p, int batch, int L, int dim, int N,
                int R, int sp, cudaStream_t s) {
  if (R <= 16)
    launch<T, NMAX, 16>(p, batch, L, dim, N, R, sp, s);
  else if (R <= 32)
    launch<T, NMAX, 32>(p, batch, L, dim, N, R, sp, s);
  else if (R <= 64)
    launch<T, NMAX, 64>(p, batch, L, dim, N, R, sp, s);
  else
    return false;
  return true;
}

template <typename T>
bool dispatch(const void* const* p, int batch, int L, int dim, int N, int R,
              int sp, cudaStream_t s) {
  if (N <= 8) return dispatch_r<T, 8>(p, batch, L, dim, N, R, sp, s);
  if (N <= 16) return dispatch_r<T, 16>(p, batch, L, dim, N, R, sp, s);
  if (N <= 32) return dispatch_r<T, 32>(p, batch, L, dim, N, R, sp, s);
  return false;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D, z and bias may be null.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for shapes
// the kernel does not take (1 <= N <= 32, 1 <= r <= 64).
extern "C" int dimsum_selective_scan_fwd_train(
    const void* u, const void* dt_low, const void* dt_w, const void* A,
    const void* B, const void* C, const void* D, const void* z,
    const void* bias, void* out, void* o, void* bnd, int batch, int L,
    int dim, int n_state, int dt_rank, int dtype, int use_softplus,
    void* stream) {
  if (batch < 1 || L < 1 || dim < 1 || n_state < 1 || dt_rank < 1 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const void* p[12] = {u, dt_low, dt_w, A, B, C, D, z, bias, out, o, bnd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok =
      dtype == 0 ? dispatch<float>(p, batch, L, dim, n_state, dt_rank,
                                   use_softplus, s)
                 : dispatch<__nv_bfloat16>(p, batch, L, dim, n_state, dt_rank,
                                           use_softplus, s);
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
