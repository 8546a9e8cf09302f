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
// bias: (dim,), fp32.  All math, the dt expansion and the state are fp32;
// out is T.
//
// What bounds it on an H100 (PERF.md §6).  At the DiM-L/2 mixer shape
// (batch 24, L 256, dim 1024, N 16, r 32, bf16) the N + 3 = 19
// transcendentals a (b, t, d) (an exp2 a state; exp and log in softplus;
// exp in the gate) take 28.6 us on the special-function units (SFU: 16 an
// SM a clock, 132 SMs, 1.98 GHz); the 188 fp32 flop a (b, t, d) take 17.7
// us and the 38.7 MB read and written 11.5 us.  At L 1024 the SFU floor is
// 0.114 ms.  The first design (one thread a channel, dt recomputed inside
// the serial loop, ~6 warps an SM) ran at 8.7x that floor, waiting on the
// loop's latency.
//
// Design.  A block takes 32 channels of one batch row and walks L in
// chunks of 16 timesteps; each chunk runs three phases between barriers.
//  A  Parallel over (t, d): the chunk's dt_low rows times the block's dt_w
//     columns (bf16: mma.sync m16n8k16, products exact in fp32 as the
//     Pallas MXU dot's; fp32: FMAs), + bias, softplus; dt and du = dt u
//     into shared memory as one float2; the skip D u and the gate silu(z)
//     kept in registers for phase C.  All of the chunk's global loads are
//     issued before the first is stored, so a chunk waits on memory once.
//  B  The recurrence, each channel's N states spread over 4 lanes (N <= 8,
//     16, 32: 2, 4, 8 states a lane; padded states have A = B = C = 0 and
//     stay 0), so 4 warps a block and ~23 an SM.  Only h = a h + du B is on
//     the serial chain; the chunk is unrolled, so later steps' exp2 run
//     ahead.  Each lane writes its partial sum of C h for every step.
//  C  Parallel over (t, d): the 4 partials + skip, times the gate, stored
//     along d.
// softplus and the gate run on the SFU (ex2 / lg2 / rcp.approx, ftz):
// log1p(e) is lg2(1 + e) ln 2 for e >= 2^-6 and its series below, so
// there is no threshold and the error is ~1e-6 relative; the state's exp2
// is ex2.approx.  A ragged last chunk runs all 16 steps with dt = 0 past
// the end (the state stays); a ragged dim masks its channels.  No
// atomics: the output repeats bit for bit.
//
// Measured (PERF.md §6, H100 80GB HBM3, 700 W): ~0.075 ms at the mixer
// shape and ~0.28 ms at L 1024 against 0.249 and 0.993 for the first
// design in the same run, ~2.5x the SFU floor.  The recurrence alone runs
// at about its floor; what is left is the other phases, which do not
// overlap it (the blocks of an SM run in lock step, and the kernel is
// bound by instruction issue).  Next: chunk i + 1's loads and phase A
// inside chunk i's recurrence (double buffers), or producer warps; and the
// variants the route refuses (h0 / last state, native reverse, grouped
// B/C, N > 32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 4;                      // lanes a channel (phase B)
constexpr int kChannels = kThreads / kLanes;   // channels a block
constexpr int kChunk = 16;                     // timesteps a chunk
constexpr int kSteps = kChunk / kLanes;        // timesteps a thread (A, C)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// one special-function-unit instruction each (ftz)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log(1 + exp(x)) = max(x, 0) + log1p(e), e = exp(-|x|) in (0, 1], the
// overflow-free form of jax.nn.softplus with no threshold: log1p(e) is
// lg2(1 + e) ln 2 (absolute error ~1e-7 against a value >= 0.0155) for
// e >= 2^-6, and e - e^2/2 + e^3/3 - e^4/4 (relative error < 2^-24 / 5)
// below
__device__ __forceinline__ float softplus(float x) {
  const float e = ex2(-fabsf(x) * kLog2e);
  const float series =
      e * fmaf(e, fmaf(e, fmaf(e, -0.25f, 1.f / 3.f), -0.5f), 1.f);
  const float tail = e < 0.015625f ? series : lg2(1.f + e) * kLn2;
  return fmaxf(x, 0.f) + tail;
}

// z sigmoid(z): exp2 of a large argument is inf and its reciprocal 0, so
// the gate tends to -0, not NaN
__device__ __forceinline__ float silu(float z) {
  return z * rcp(1.f + ex2(-z * kLog2e));
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NV consecutive floats of shared memory into registers as wide loads
// (16-byte aligned when NV % 4 == 0, 8-byte when NV == 2)
template <int NV>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NV / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else {
    static_assert(NV == 2, "lds");
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  }
}

// Shared memory of a block, in floats, each array 16-byte aligned.  bf16
// inputs keep dt_w (transposed) and dt_low as bf16 mma operands, with rows
// of RMAX + 8 (conflict-free fragments), inside the fp32 arrays' room.
template <int NMAX, int RMAX>
struct Plan {
  static constexpr int kW = 0;                            // [RMAX][32]
  static constexpr int kDtl = kW + RMAX * kChannels;      // [16][RMAX]
  static constexpr int kB = kDtl + kChunk * RMAX;         // [16][NMAX]
  static constexpr int kC = kB + kChunk * NMAX;           // [16][NMAX]
  static constexpr int kDd = kC + kChunk * NMAX;          // [16][32] float2
  static constexpr int kY = kDd + 2 * kChunk * kChannels; // [16][128]
  static constexpr int kBytes = (kY + kChunk * kThreads) * 4;  // <= 28 KB
};

// 6 blocks of 128 threads an SM (80 registers a thread): the 768 blocks of
// the DiM-L/2 mixer (24 x 1024 / 32) in one wave on 132 SMs
template <typename T, int NMAX, int RMAX>
__global__ void __launch_bounds__(kThreads, 6)
scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dt_low,
                const T* __restrict__ dt_w, const float* __restrict__ A,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ Dv, const T* __restrict__ z,
                const float* __restrict__ bias, T* __restrict__ out, int L,
                int dim, int N, int R, int use_softplus) {
  using P = Plan<NMAX, RMAX>;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NPL = NMAX / kLanes;  // states a lane
  constexpr int LDB = RMAX + 8;       // bf16 operand rows
  static_assert(RMAX % 16 == 0 && NPL >= 2, "plan");
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem + P::kW;
  float* s_dtl = smem + P::kDtl;
  float* s_B = smem + P::kB;
  float* s_C = smem + P::kC;
  float2* s_dd = reinterpret_cast<float2*>(smem + P::kDd);
  float* s_y = smem + P::kY;
  __nv_bfloat16* w_bf = reinterpret_cast<__nv_bfloat16*>(s_w);
  __nv_bfloat16* dtl_bf = reinterpret_cast<__nv_bfloat16*>(s_dtl);

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int d0 = blockIdx.y * kChannels;
  // phases A and C: channel ca, timesteps tg * kSteps .. + kSteps
  const int ca = tid % kChannels, tg = tid / kChannels;
  const int da = d0 + ca;
  const bool active = da < dim;
  // phase B: channel cb, states kb * NPL .. + NPL
  const int cb = tid / kLanes, kb = tid % kLanes;
  const int db = d0 + cb;

  for (int i = tid; i < RMAX * kChannels; i += kThreads) {
    const int k = i / kChannels, c = i % kChannels;
    const bool ok = k < R && d0 + c < dim;
    if constexpr (kMma) {
      w_bf[c * LDB + k] = ok ? dt_w[(size_t)k * dim + d0 + c]
                             : __float2bfloat16(0.f);
    } else {
      s_w[i] = ok ? dt_w[(size_t)k * dim + d0 + c] : 0.f;
    }
  }
  float a2[NPL], h[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = kb * NPL + j;
    a2[j] = (db < dim && n < N) ? A[(size_t)db * N + n] * kLog2e : 0.f;
    h[j] = 0.f;
  }
  const float skip_w = (Dv != nullptr && active) ? Dv[da] : 0.f;
  const float dbias = (bias != nullptr && active) ? bias[da] : 0.f;
  const size_t row0 = (size_t)b * L;

  // every global load of the chunk at c0 into registers, all issued before
  // the first is stored (one memory latency a chunk)
  constexpr int NDT = kChunk * RMAX / kThreads;
  constexpr int NBC = kChunk * NMAX / kThreads;
  T r_dt[NDT], r_b[NBC], r_c[NBC], r_u[kSteps], r_z[kSteps];
  const T zero = from_f32<T>(0.f);
  auto load_chunk = [&](int c0) {
    const int n_t = min(kChunk, L - c0);
    const T* pd = dt_low + (row0 + c0) * R;
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      const int i = tid + j * kThreads, tt = i / RMAX, k = i % RMAX;
      r_dt[j] = (tt < n_t && k < R) ? pd[tt * R + k] : zero;
    }
    const T* pb = Bm + (row0 + c0) * N;
    const T* pc = Cm + (row0 + c0) * N;
#pragma unroll
    for (int j = 0; j < NBC; ++j) {
      const int i = tid + j * kThreads, tt = i / NMAX, n = i % NMAX;
      const bool ok = tt < n_t && n < N;
      r_b[j] = ok ? pb[tt * N + n] : zero;
      r_c[j] = ok ? pc[tt * N + n] : zero;
    }
    const size_t base = (row0 + c0) * dim + da;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int tt = tg * kSteps + i;
      const bool ok = active && tt < n_t;
      r_u[i] = ok ? u[base + tt * dim] : zero;
      r_z[i] = (ok && z != nullptr) ? z[base + tt * dim] : zero;
    }
  };

  for (int t0 = 0; t0 < L; t0 += kChunk) {
    const int nt = min(kChunk, L - t0);
    load_chunk(t0);
    // the chunk's shared rows in fp32 (bf16: the mma operand as it is)
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      const int i = tid + j * kThreads, tt = i / RMAX, k = i % RMAX;
      if constexpr (kMma) {
        dtl_bf[tt * LDB + k] = r_dt[j];
      } else {
        s_dtl[i] = r_dt[j];
      }
    }
#pragma unroll
    for (int j = 0; j < NBC; ++j) {
      s_B[tid + j * kThreads] = to_f32(r_b[j]);
      s_C[tid + j * kThreads] = to_f32(r_c[j]);
    }
    float uv[kSteps], zv[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      uv[i] = to_f32(r_u[i]);
      zv[i] = to_f32(r_z[i]);
    }
    __syncthreads();

    // phase A: dt_low . dt_w for the thread's kSteps timesteps of channel ca
    float acc[kSteps];
    if constexpr (kMma) {
      // warp tg: its 4 timesteps as rows 0-3 of a 16-row tile (the other
      // rows zero) against the block's 32 channels; the accumulators pass
      // through s_y (free until phase B) to the (t, ca) layout
      const int lane = tid & 31, g = lane >> 2, q = lane & 3;
      const bool own = g < kSteps;
      const int row = tg * kSteps + (own ? g : 0);
      float c4[kChannels / 8][4];
#pragma unroll
      for (int j = 0; j < kChannels / 8; ++j)
        c4[j][0] = c4[j][1] = c4[j][2] = c4[j][3] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < RMAX; k0 += 16) {
        const __nv_bfloat16* ap = &dtl_bf[row * LDB + k0 + 2 * q];
        const uint32_t a[4] = {
            own ? *reinterpret_cast<const uint32_t*>(ap) : 0u, 0u,
            own ? *reinterpret_cast<const uint32_t*>(ap + 8) : 0u, 0u};
#pragma unroll
        for (int j = 0; j < kChannels / 8; ++j) {
          const __nv_bfloat16* wp = &w_bf[(j * 8 + g) * LDB + k0 + 2 * q];
          mma_bf16(c4[j], a, *reinterpret_cast<const uint32_t*>(wp),
                   *reinterpret_cast<const uint32_t*>(wp + 8));
        }
      }
#pragma unroll
      for (int j = 0; j < kChannels / 8; ++j) {
        if (own) {
          s_y[row * kChannels + j * 8 + 2 * q] = c4[j][0];
          s_y[row * kChannels + j * 8 + 2 * q + 1] = c4[j][1];
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kSteps; ++i)
        acc[i] = s_y[(tg * kSteps + i) * kChannels + ca];
    } else {
#pragma unroll
      for (int i = 0; i < kSteps; ++i) acc[i] = 0.f;
#pragma unroll
      for (int k = 0; k < RMAX; k += 4) {
        const float w0 = s_w[k * kChannels + ca];
        const float w1 = s_w[(k + 1) * kChannels + ca];
        const float w2 = s_w[(k + 2) * kChannels + ca];
        const float w3 = s_w[(k + 3) * kChannels + ca];
#pragma unroll
        for (int i = 0; i < kSteps; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(
              &s_dtl[(tg * kSteps + i) * RMAX + k]);
          acc[i] = fmaf(v.x, w0, acc[i]);
          acc[i] = fmaf(v.y, w1, acc[i]);
          acc[i] = fmaf(v.z, w2, acc[i]);
          acc[i] = fmaf(v.w, w3, acc[i]);
        }
      }
    }
    // + bias, softplus, du; the skip and the gate for phase C
    float skip[kSteps], gate[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int tt = tg * kSteps + i;
      float dt = acc[i] + dbias;
      if (use_softplus) dt = softplus(dt);
      if (tt >= nt) dt = 0.f;  // past the end: the state stays as it is
      s_dd[tt * kChannels + ca] = make_float2(dt, dt * uv[i]);
      skip[i] = uv[i] * skip_w;
      gate[i] = z != nullptr ? silu(zv[i]) : 1.f;
    }
    __syncthreads();

    // phase B, the recurrence: only h = a h + du B depends on the previous
    // step; the unrolled chunk lets later steps' exp2 run ahead
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      const float2 dd = s_dd[tt * kChannels + cb];
      float bv[NPL], cv[NPL];
      lds<NPL>(s_B + tt * NMAX + kb * NPL, bv);
      lds<NPL>(s_C + tt * NMAX + kb * NPL, cv);
      float y = 0.f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        h[j] = fmaf(ex2(dd.x * a2[j]), h[j], dd.y * bv[j]);
        y = fmaf(h[j], cv[j], y);
      }
      s_y[tt * kThreads + tid] = y;  // = [tt][cb][kb]
    }
    __syncthreads();

    // phase C: y = (the 4 partials + skip) * gate, stored along d
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int tt = tg * kSteps + i;
      float part[kLanes];
      lds<kLanes>(s_y + tt * kThreads + ca * kLanes, part);
      const float s = ((part[0] + part[1]) + part[2]) + part[3];
      if (active && tt < nt)
        out[(row0 + t0) * dim + da + tt * dim] =
            from_f32<T>((s + skip[i]) * gate[i]);
    }
  }
}

template <typename T, int NMAX, int RMAX>
cudaError_t launch(const void* u, const void* dt_low, const void* dt_w,
                   const void* A, const void* B, const void* C, const void* D,
                   const void* z, const void* bias, void* out, int batch,
                   int L, int dim, int N, int R, int use_softplus,
                   cudaStream_t stream) {
  constexpr int kBytes = Plan<NMAX, RMAX>::kBytes;
  dim3 grid(batch, (dim + kChannels - 1) / kChannels);
  scan_fwd_kernel<T, NMAX, RMAX><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt_low),
      static_cast<const T*>(dt_w), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<const float*>(D), static_cast<const T*>(z),
      static_cast<const float*>(bias), static_cast<T*>(out), L, dim, N, R,
      use_softplus);
  return cudaGetLastError();
}

#define SCAN_ARGS u, dt_low, dt_w, A, B, C, D, z, bias, out, batch, L, dim, \
                  N, R, use_softplus, s
#define SCAN_PARAMS const void *u, const void *dt_low, const void *dt_w,   \
    const void *A, const void *B, const void *C, const void *D,             \
    const void *z, const void *bias, void *out, int batch, int L, int dim,  \
    int N, int R, int use_softplus, cudaStream_t s

template <typename T, int NMAX>
cudaError_t dispatch_r(SCAN_PARAMS) {
  if (R <= 16) return launch<T, NMAX, 16>(SCAN_ARGS);
  if (R <= 32) return launch<T, NMAX, 32>(SCAN_ARGS);
  if (R <= 64) return launch<T, NMAX, 64>(SCAN_ARGS);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(SCAN_PARAMS) {
  if (N <= 8) return dispatch_r<T, 8>(SCAN_ARGS);
  if (N <= 16) return dispatch_r<T, 16>(SCAN_ARGS);
  if (N <= 32) return dispatch_r<T, 32>(SCAN_ARGS);
  return cudaErrorInvalidValue;
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
  const int N = n_state, R = dt_rank;
  return dtype == 0 ? dispatch<float>(SCAN_ARGS)
                    : dispatch<__nv_bfloat16>(SCAN_ARGS);
}
