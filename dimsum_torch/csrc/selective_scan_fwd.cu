// Fused selective-scan (Mamba S6) forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dimsum_tpu/ops/selective_scan.py::_scan_body
// (launched from _selective_scan_pallas_fwd_impl) on its inference route:
// dt_rank > 0 (dt = dt_low . dt_w expanded in the kernel), delta bias,
// softplus, D skip, silu(z) gate, one B/C per timestep (no groups), forward
// time, zero initial state.  Per batch b, channel d and state n:
//
//   dt_t  = softplus(<dt_low_t, dt_w[:, d]> + bias_d)
//   h_t   = exp(dt_t * A_dn) * h_{t-1} + dt_t * u_t * B_tn
//   y_t   = (sum_n C_tn * h_tn + D_d * u_t) * silu(z_t)
//
// u, z, out: (batch, L, dim); dt_low: (batch, L, r); B, C: (batch, L, N);
// dt_w: (r, dim), all in one type T (float or bf16).  A: (dim, N), D and
// bias: (dim,), fp32.  All math and the state are fp32; out is T.
//
// What bounds it on an H100 at the DiM-L/2 mixer shape (batch 24, L 256,
// dim 1024, N 16, r 32, bf16): each input read once and the output written
// once is 38.7 MB, 11.5 us at 3.35 TB/s; the fp32 work is 2r + 7N + 12 =
// 188 flop per (b, t, d) (dt expansion; dt*A, exp2, du*B and two FMAs per
// state; bias, softplus, skip, gate), 1.18 GFLOP or 17.6 us at 67 TFLOP/s,
// so operations bound it.  The 16 exp2 per (b, t, d) also need the
// special-function units (16 per SM per clock on sm_90): ~24 us at 1.98 GHz.
//
// Design (simple first): one thread per channel d, a block of 128 channels
// per (batch, channel block).  Each thread keeps its N states, its column of
// dt_w and its row of A (pre-scaled by log2 e, as _scan_body does) in
// registers.  The timesteps of dt_low, B and C, which every channel of the
// block shares, are staged in shared memory kChunk at a time and read back
// as float4 broadcasts; each thread's u and z are staged at the chunk's
// start too.  The r- and N-long sums run as 4 independent FMA chains.
// Loads of u and z and stores of out are coalesced along d; the ragged edge
// of dim is masked.  N and r are padded with zeros to the compile-time
// sizes NMAX and RMAX (a padded state stays 0 and adds nothing).  No TMA or
// wgmma.  With one thread per channel the grid holds B * dim / 32 = 768
// warps, ~6 per SM, too few to hide the latency of the sequential time
// loop: it runs at ~14x its bound (PERF.md); spreading each channel's
// states over several lanes is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 32;     // timesteps staged per shared-memory pass
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
scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dt_low,
                const T* __restrict__ dt_w, const float* __restrict__ A,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ Dv, const T* __restrict__ z,
                const float* __restrict__ bias, T* __restrict__ out, int L,
                int dim, int N, int R, int use_softplus) {
  // rows read back as float4: one 16-byte load serves four values
  __shared__ __align__(16) float s_dt[kChunk][RMAX];
  __shared__ __align__(16) float s_B[kChunk][NMAX];
  __shared__ __align__(16) float s_C[kChunk][NMAX];
  __shared__ T s_u[kChunk][kThreads];  // each thread's own column
  __shared__ T s_z[kChunk][kThreads];

  const int b = blockIdx.x;
  const int d = blockIdx.y * kThreads + threadIdx.x;
  const bool active = d < dim;

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
      // all of the chunk's loads in flight at once, not one per step
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
      const size_t idx = (row0 + t0 + tt) * dim + d;
      const float uv = to_f32(s_u[tt][threadIdx.x]);
      // 4 independent FMA chains for each sum, not one of r or N
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
      if (z != nullptr) {
        const float zv = to_f32(s_z[tt][threadIdx.x]);
        y *= zv / (1.f + expf(-zv));
      }
      out[idx] = from_f32<T>(y);
    }
  }
}

template <typename T, int NMAX, int RMAX>
void launch(const void* u, const void* dt_low, const void* dt_w,
            const void* A, const void* B, const void* C, const void* D,
            const void* z, const void* bias, void* out, int batch, int L,
            int dim, int N, int R, int use_softplus, cudaStream_t stream) {
  dim3 grid(batch, (dim + kThreads - 1) / kThreads);
  scan_fwd_kernel<T, NMAX, RMAX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt_low),
      static_cast<const T*>(dt_w), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(D), static_cast<const T*>(z),
      static_cast<const float*>(bias), static_cast<T*>(out), L, dim, N, R,
      use_softplus);
}

template <typename T, int NMAX>
bool dispatch_r(int R, const void* u, const void* dt_low, const void* dt_w,
                const void* A, const void* B, const void* C, const void* D,
                const void* z, const void* bias, void* out, int batch, int L,
                int dim, int N, int use_softplus, cudaStream_t s) {
  if (R <= 16) {
    launch<T, NMAX, 16>(u, dt_low, dt_w, A, B, C, D, z, bias, out, batch, L,
                        dim, N, R, use_softplus, s);
  } else if (R <= 32) {
    launch<T, NMAX, 32>(u, dt_low, dt_w, A, B, C, D, z, bias, out, batch, L,
                        dim, N, R, use_softplus, s);
  } else if (R <= 64) {
    launch<T, NMAX, 64>(u, dt_low, dt_w, A, B, C, D, z, bias, out, batch, L,
                        dim, N, R, use_softplus, s);
  } else {
    return false;
  }
  return true;
}

template <typename T>
bool dispatch(int N, int R, const void* u, const void* dt_low,
              const void* dt_w, const void* A, const void* B, const void* C,
              const void* D, const void* z, const void* bias, void* out,
              int batch, int L, int dim, int use_softplus, cudaStream_t s) {
  if (N <= 8)
    return dispatch_r<T, 8>(R, u, dt_low, dt_w, A, B, C, D, z, bias, out,
                            batch, L, dim, N, use_softplus, s);
  if (N <= 16)
    return dispatch_r<T, 16>(R, u, dt_low, dt_w, A, B, C, D, z, bias, out,
                             batch, L, dim, N, use_softplus, s);
  if (N <= 32)
    return dispatch_r<T, 32>(R, u, dt_low, dt_w, A, B, C, D, z, bias, out,
                             batch, L, dim, N, use_softplus, s);
  return false;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D, z and bias may be null.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// shapes the kernel does not take (1 <= N <= 32, 1 <= r <= 64).
extern "C" int dimsum_selective_scan_fwd(
    const void* u, const void* dt_low, const void* dt_w, const void* A,
    const void* B, const void* C, const void* D, const void* z,
    const void* bias, void* out, int batch, int L, int dim, int n_state,
    int dt_rank, int dtype, int use_softplus, void* stream) {
  if (batch < 1 || L < 1 || dim < 1 || n_state < 1 || dt_rank < 1 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok =
      dtype == 0
          ? dispatch<float>(n_state, dt_rank, u, dt_low, dt_w, A, B, C, D, z,
                            bias, out, batch, L, dim, use_softplus, s)
          : dispatch<__nv_bfloat16>(n_state, dt_rank, u, dt_low, dt_w, A, B,
                                    C, D, z, bias, out, batch, L, dim,
                                    use_softplus, s);
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}
