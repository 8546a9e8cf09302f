// Selective-scan (Mamba S6) training forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// dimsum_tpu/ops/selective_scan_bwd.py::_fwd_train_kernel (launched from
// selective_scan_fwd_train): kernel 1's output y (selective_scan_fwd.cu)
// plus what the backward (selective_scan_bwd.cu) replays from.  Per batch
// b and channel d:
//
//   dt_t  = softplus(<dt_low_t, dt_w[:, d]> + bias_d)   expanded in fp32
//   h_t   = exp(dt_t A_dn) h_{t-1} + dt_t u_t B_tn
//   o_t   = sum_n C_tn h_tn + D_d u_t                   fp32 pre-gate output
//   y_t   = o_t silu(z_t)                               in u's type
//   bnd_c = h at the start of step 16 c                 fp32, the first zero
//
// Layouts: u, z, y (batch, L, dim) in T; o (batch, L, dim) fp32; bnd
// (batch, ceil(L / 16), N, dim) fp32; dt_low (batch, L, r), B, C (batch,
// L, N), dt_w (r, dim) in T; A (dim, N), D and bias (dim,) fp32.  T is
// float or bf16.
//
// What bounds it on an H100 at the DiM-L/2 training mixer shapes (16 x 256
// or 4 x 1024 tokens, dim 1024, N 16, r 32, bf16): inputs read once 17.4
// MB, y (8.4 MB), o (16.8 MB) and the states (16.8 MB) written once, 59.4
// MB or 17.7 us at 3.35 TB/s; 2r + 7N + 12 = 188 fp32 flop a (b, t, d),
// 0.79 GFLOP or 11.8 us; N + 3 = 19 transcendentals a (b, t, d) (an exp2 a
// state, exp and log in softplus, exp in the gate) on the special-function
// units (SFU), 19.1 us.  The SFU bounds it.  The first design (one thread
// a channel walking all of L, a block of 128 channels a batch row: 32
// blocks at batch 4) took 0.272 ms at 16 x 256 and 1.02 ms at 4 x 1024,
// L times the latency of one step of one thread's chain.
//
// Design: chunks in parallel along L, in two kernels.
//   State pass.  A chunk's effect on the state is affine, h_end = alpha_c
//     h_start + beta_c, with alpha_c = exp2(A log2e sum_{t in c} dt_t) and
//     beta_c the chunk's end state from a zero seed; both need only
//     dt_low, dt_w, bias, u and B.  A block takes 8 channels of a batch row
//     and 4 chunks at once (8 at N 32), a warp a chunk, from the first:
//     the warp expands dt for its 16 x 8 (t, d) (one m16n8k16 mma.sync per
//     16 of r for bf16, FMAs for fp32), walks its chunk with each
//     channel's states over 4 lanes, B read as it was copied, and leaves
//     (alpha, beta); the block chains bnd_{c+1} = alpha_c bnd_c + beta_c
//     from the left and writes bnd.  The next chunks' rows come in by
//     cp.async while these are walked.  It also leaves dt in o, which the
//     main pass reads and then overwrites.
//   Main pass.  Kernel 1's design (selective_scan_fwd.cu) without its dt
//     expansion: a block takes 32 channels of one batch row and a group of
//     4 chunks, starting from the state bnd holds at the group's first
//     chunk; each chunk runs three phases between barriers.
//      A  Parallel over (t, d): dt from o, dt u into shared memory; the
//         skip D u and the gate silu(z) kept for C.
//      B  The recurrence, each channel's N states over 4 lanes; each lane
//         writes its partial sum of C h for every step.
//      C  Parallel over (t, d): the 4 partials + skip is o, times the gate
//         y, both stored along d.
//   Each state's exp2 is computed in both passes, so the design's own floor
//   is about twice the function's bound; dt's round trip through o adds
//   33.6 MB of traffic (~10 us) and takes the expansion and softplus out
//   of the main pass.
// softplus and the gate run on the SFU (ex2 / lg2 / rcp.approx, ftz):
// log1p(e) is lg2(1 + e) ln 2 for e >= 2^-6 and its series below, so there
// is no threshold and the error is ~1e-6 relative.  A ragged last chunk
// runs all 16 steps with dt = 0 past the end (the state stays); a ragged
// dim masks its channels.  No atomics: the outputs repeat bit for bit.
//
// Measured (PERF.md §6, H100 80GB HBM3, 700 W): 0.087 ms at 16 x 256 and
// 0.090 ms at 4 x 1024 through the entry point, against 0.27 and 1.02 ms
// for the first design in the same call; the state pass ~0.047 / 0.052,
// the main pass ~0.040.  clock64 counters put half of a main-pass chunk in
// gathering its rows (load latency and barriers); the state pass spreads
// over its copies, dt phase, walk and chain.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// steps between saved states: the contract with selective_scan_bwd.cu's
// kChunk (and TRAIN_CHUNK in ops/selective_scan.py)
constexpr int kChunk = 16;
constexpr int kLanes = 4;                      // lanes a channel
constexpr int kWarpCh = 32 / kLanes;           // channels a state-pass block
constexpr int kThreads = 128;                  // a main-pass block
constexpr int kChannels = kThreads / kLanes;   // channels a main-pass block
constexpr int kSteps = kChunk / kLanes;        // steps a thread (A, C)
constexpr int kGroup = 4;                      // chunks a main-pass block
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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
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

// NV consecutive values of T in shared memory into fp32 registers as one
// wide load (bf16: 4, 8 or 16 bytes, aligned to their size)
template <int NV, typename T>
__device__ __forceinline__ void lds_t(const T* p, float* v) {
  if constexpr (std::is_same<T, float>::value) {
    lds<NV>(p, v);
  } else {
    auto unpack = [](uint32_t w, float* f) {
      f[0] = __uint_as_float(w << 16);
      f[1] = __uint_as_float(w & 0xffff0000u);
    };
    if constexpr (NV == 2) {
      unpack(*reinterpret_cast<const uint32_t*>(p), v);
    } else if constexpr (NV == 4) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      unpack(w.x, v);
      unpack(w.y, v + 2);
    } else {
      static_assert(NV == 8, "lds_t");
      const uint4 w = *reinterpret_cast<const uint4*>(p);
      unpack(w.x, v);
      unpack(w.y, v + 2);
      unpack(w.z, v + 4);
      unpack(w.w, v + 6);
    }
  }
}

// ---------------------------------------------------------------------------
// State pass
// ---------------------------------------------------------------------------

// raw[e] = <dt_low row tt, dt_w column c> for the four (tt, c) of a thread
// in the m16n8 accumulator layout: e = 2 i + j -> tt = g + 8 i, c = 2 q + j.
// bf16: one mma.sync per 16 of r, dt_low rows in shared memory (bf16, rows
// of RMAX + 8), dt_w's fragments in registers.  fp32: FMAs over rows of
// RMAX + 4 floats, w_rows the thread's channels 2q and 2q + 1.
template <bool kMma, int RMAX>
__device__ __forceinline__ void expand_dt(const float* s_dtl,
                                          const float* w_rows,
                                          const uint32_t (&bfr)[RMAX / 16][2],
                                          int g, int q, float (&raw)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) raw[e] = 0.f;
  if constexpr (kMma) {
    constexpr int LDB = RMAX + 8;
    const __nv_bfloat16* dtl = reinterpret_cast<const __nv_bfloat16*>(s_dtl);
#pragma unroll
    for (int k0 = 0; k0 < RMAX; k0 += 16) {
      const __nv_bfloat16* ap = dtl + g * LDB + k0 + 2 * q;
      const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * LDB), ld32(ap + 8),
                             ld32(ap + 8 * LDB + 8)};
      mma_bf16(raw, a, bfr[k0 / 16][0], bfr[k0 / 16][1]);
    }
  } else {
    constexpr int LDF = RMAX + 4;
#pragma unroll
    for (int k = 0; k < RMAX; k += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(s_dtl + g * LDF + k);
      const float4 x1 =
          *reinterpret_cast<const float4*>(s_dtl + (g + 8) * LDF + k);
      const float4 w0 = *reinterpret_cast<const float4*>(w_rows + k);
      const float4 w1 = *reinterpret_cast<const float4*>(w_rows + LDF + k);
      raw[0] = fmaf(x0.x, w0.x, fmaf(x0.y, w0.y,
               fmaf(x0.z, w0.z, fmaf(x0.w, w0.w, raw[0]))));
      raw[1] = fmaf(x0.x, w1.x, fmaf(x0.y, w1.y,
               fmaf(x0.z, w1.z, fmaf(x0.w, w1.w, raw[1]))));
      raw[2] = fmaf(x1.x, w0.x, fmaf(x1.y, w0.y,
               fmaf(x1.z, w0.z, fmaf(x1.w, w0.w, raw[2]))));
      raw[3] = fmaf(x1.x, w1.x, fmaf(x1.y, w1.y,
               fmaf(x1.z, w1.z, fmaf(x1.w, w1.w, raw[3]))));
    }
  }
}

// dt_w's bf16 B fragments for channel d (column g of the m16n8 tile):
// rows k0 + 2q, +1 and k0 + 2q + 8, +9 of each 16 of r, zero past r or dim
template <typename T, int RMAX>
__device__ __forceinline__ void load_w_frags(const T* dt_w, int d, int dim,
                                             int R, int q,
                                             uint32_t (&bfr)[RMAX / 16][2]) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    auto at = [&](int k) {
      return (k < R && d < dim) ? dt_w[(size_t)k * dim + d]
                                : __float2bfloat16(0.f);
    };
#pragma unroll
    for (int i = 0; i < RMAX / 16; ++i) {
      const int k = 16 * i + 2 * q;
      bfr[i][0] = pack_bf16(at(k), at(k + 1));
      bfr[i][1] = pack_bf16(at(k + 8), at(k + 9));
    }
  } else {
#pragma unroll
    for (int i = 0; i < RMAX / 16; ++i) bfr[i][0] = bfr[i][1] = 0u;
  }
}

// asynchronous 16-byte copies into shared memory (cp.async); a copy with
// no source reads nothing and fills zeros
__device__ __align__(16) float g_no_src[4];
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src != nullptr ? src : g_no_src),
               "r"(src != nullptr ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

template <typename T> __device__ __forceinline__ T zero_of() {
  return from_f32<T>(0.f);
}

// Copies `count` elements of a chunk's arrays into shared memory: element i
// of `src_of(i)` (nullptr: zero) to `dst_of(i)`.  As 16-byte cp.async
// vectors of kPer elements when `vec` (every run of kPer is whole and
// aligned), else as plain loads, all issued before any store.
template <typename T, int COUNT, int NT, typename Src, typename Dst>
__device__ __forceinline__ void stage(bool vec, int tid, Src src_of,
                                      Dst dst_of) {
  constexpr int kPer = 16 / sizeof(T);
  if (vec) {
    for (int v = tid; v < COUNT / kPer; v += NT) {
      cp_async16(dst_of(v * kPer), src_of(v * kPer));
    }
  } else {
    constexpr int M = (COUNT + NT - 1) / NT;
    T r[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int i = tid + m * NT;
      const T* src = i < COUNT ? src_of(i) : nullptr;
      r[m] = src != nullptr ? *src : zero_of<T>();
    }
#pragma unroll
    for (int m = 0; m < M; ++m)
      if (tid + m * NT < COUNT) *dst_of(tid + m * NT) = r[m];
  }
}

// Shared memory of a state-pass block, in floats: dt_w rows (fp32 only),
// then per warp two stages of its chunk (dt_low rows as the mma reads them,
// B rows and u 16 x 8 in T), (dt, dt u) per (t, c) and (alpha, beta) per
// (c, n).  kWarps chunks at once, at least 8 N threads for the chain.
template <int NMAX, int RMAX, bool kMma>
struct StatePlan {
  static constexpr int kWarps = NMAX / 4 > 4 ? NMAX / 4 : 4;
  static constexpr int kWSize = kMma ? 0 : kWarpCh * (RMAX + 4);
  static constexpr int kDtlW = kMma ? kChunk * (RMAX + 8) / 2
                                    : kChunk * (RMAX + 4);
  static constexpr int kBRawW = kChunk * NMAX / (kMma ? 2 : 1);
  static constexpr int kURawW = kChunk * kWarpCh / (kMma ? 2 : 1);
  static constexpr int kStageW = kDtlW + kBRawW + kURawW;
  static constexpr int kStW = kChunk * kWarpCh * 2;
  static constexpr int kAbW = kWarpCh * NMAX * 2;
  static constexpr int kW = 0;
  static constexpr int kStage = kW + kWSize;
  static constexpr int kSt = kStage + kWarps * 2 * kStageW;
  static constexpr int kAb = kSt + kWarps * kStW;
  static constexpr int kBytes = (kAb + kWarps * kAbW) * 4;
};

// grid (ceil(dim / 8), batch), StatePlan::kWarps warps and 24 warps an SM
// (80 registers a thread; without the bound the compiler takes ~150 and
// the pass runs ~20% slower): the chunks from the first, kWarps at once, a
// warp a chunk; the next kWarps chunks' rows are copied in while these are
// walked.
template <typename T, int NMAX, int RMAX>
__global__ void __launch_bounds__(
    StatePlan<NMAX, RMAX, true>::kWarps * 32,
    24 / StatePlan<NMAX, RMAX, true>::kWarps)
scan_fwd_train_states_kernel(const T* __restrict__ u,
                             const T* __restrict__ dt_low,
                             const T* __restrict__ dt_w,
                             const float* __restrict__ A,
                             const T* __restrict__ Bm,
                             const float* __restrict__ bias,
                             float* __restrict__ bnd,
                             float* __restrict__ dt_out, int L, int dim,
                             int N, int R, int use_softplus, int vec) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  using P = StatePlan<NMAX, RMAX, kMma>;
  constexpr int NPL = NMAX / kLanes;
  constexpr int nw = P::kWarps, kNT = nw * 32;
  constexpr int LDF = RMAX + 4, LDB = RMAX + 8, kPitch = kMma ? LDB : LDF;
  static_assert(RMAX % 16 == 0 && NPL >= 2, "plan");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int d0 = blockIdx.x * kWarpCh, b = blockIdx.y;
  const int nc = (L + kChunk - 1) / kChunk;
  const size_t row0 = (size_t)b * L;
  float* s_w = smem + P::kW;
  float* stage0 = smem + P::kStage + warp * 2 * P::kStageW;
  float2* s_st = reinterpret_cast<float2*>(smem + P::kSt + warp * P::kStW);
  const float2* s_ab_all = reinterpret_cast<const float2*>(smem + P::kAb);
  float2* s_ab = reinterpret_cast<float2*>(smem + P::kAb + warp * P::kAbW);

  // chunk c's dt_low, B and u into the warp's stage buffer
  auto stage_chunk = [&](int c, float* buf) {
    const int t0 = c * kChunk, nt = min(kChunk, L - t0);
    T* dtl = reinterpret_cast<T*>(buf);
    T* braw = reinterpret_cast<T*>(buf + P::kDtlW);
    T* uraw = reinterpret_cast<T*>(buf + P::kDtlW + P::kBRawW);
    stage<T, kChunk * RMAX, 32>(
        vec, lane,
        [&](int i) -> const T* {
          const int tt = i / RMAX, k = i % RMAX;
          return tt < nt && k < R ? dt_low + (row0 + t0 + tt) * R + k
                                  : nullptr;
        },
        [&](int i) { return dtl + i / RMAX * kPitch + i % RMAX; });
    stage<T, kChunk * NMAX, 32>(
        vec, lane,
        [&](int i) -> const T* {
          const int tt = i / NMAX, n = i % NMAX;
          return tt < nt && n < N ? Bm + (row0 + t0 + tt) * N + n : nullptr;
        },
        [&](int i) { return braw + i; });
    stage<T, kChunk * kWarpCh, 32>(
        vec, lane,
        [&](int i) -> const T* {
          const int tt = i / kWarpCh, d = d0 + i % kWarpCh;
          return tt < nt && d < dim ? u + (row0 + t0 + tt) * dim + d
                                    : nullptr;
        },
        [&](int i) { return uraw + i; });
  };

  uint32_t bfr[RMAX / 16][2];
  load_w_frags<T, RMAX>(dt_w, d0 + g, dim, R, q, bfr);
  if constexpr (!kMma) {
    for (int i = tid; i < kWarpCh * RMAX; i += kNT) {
      const int k = i / kWarpCh, c = i % kWarpCh;
      s_w[c * LDF + k] = (k < R && d0 + c < dim)
                             ? to_f32(dt_w[(size_t)k * dim + d0 + c]) : 0.f;
    }
  }
  float bias2[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = d0 + 2 * q + j;
    bias2[j] = (bias != nullptr && d < dim) ? bias[d] : 0.f;
  }
  float a2[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = q * NPL + j;
    a2[j] = (d0 + g < dim && n < N) ? A[(size_t)(d0 + g) * N + n] * kLog2e
                                    : 0.f;
  }

  float H = 0.f;  // the chain's state, for thread (n, c) = (tid / 8, tid % 8)
  if (vec) {
    if (warp < nc) stage_chunk(warp, stage0);
    cp_async_commit();
  }
  int it = 0;
  for (int lo = 0; lo < nc; lo += nw, ++it) {
    const int hi = min(nc, lo + nw);
    const int c = lo + warp;
    float* buf = stage0 + (it & 1) * P::kStageW;
    __syncthreads();  // the previous chain's reads are done; s_w is ready
    if (vec) {
      if (hi + warp < nc)
        stage_chunk(hi + warp, stage0 + ((it + 1) & 1) * P::kStageW);
      cp_async_commit();
      cp_async_wait<1>();
    } else if (c < hi) {
      stage_chunk(c, buf);
    }
    __syncwarp();
    if (c < hi) {
      const int t0 = c * kChunk, nt = min(kChunk, L - t0);
      const T* braw = reinterpret_cast<const T*>(buf + P::kDtlW);
      const T* uraw = reinterpret_cast<const T*>(buf + P::kDtlW + P::kBRawW);
      float raw[4], dts[4];
      expand_dt<kMma, RMAX>(buf, s_w + 2 * q * LDF, bfr, g, q, raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = g + 8 * (e >> 1), cc = 2 * q + (e & 1);
        float dt = raw[e] + bias2[e & 1];
        if (use_softplus) dt = softplus(dt);
        if (tt >= nt || d0 + cc >= dim) dt = 0.f;  // the state stays
        dts[e] = dt;
        s_st[tt * kWarpCh + cc] =
            make_float2(dt, dt * to_f32(uraw[tt * kWarpCh + cc]));
      }
      // dt for the main pass, in o's place (channel pairs 2q, 2q + 1)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int tt = g + 8 * i, d = d0 + 2 * q;
        if (tt >= nt || d >= dim) continue;
        float* dst = dt_out + (row0 + t0 + tt) * dim + d;
        if (vec) {  // dim even: the pair is 8-byte aligned
          *reinterpret_cast<float2*>(dst) =
              make_float2(dts[2 * i], dts[2 * i + 1]);
        } else {
          dst[0] = dts[2 * i];
          if (d + 1 < dim) dst[1] = dts[2 * i + 1];
        }
      }
      __syncwarp();
      // the chunk's walk from a zero state (channel g, states q * NPL ..):
      // beta = its end state, alpha = exp2(A log2e sum dt)
      float h[NPL], dsum = 0.f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) h[j] = 0.f;
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt) {
        const float2 p = s_st[tt * kWarpCh + g];
        float bv[NPL];
        lds_t<NPL>(braw + tt * NMAX + q * NPL, bv);
        dsum += p.x;
#pragma unroll
        for (int j = 0; j < NPL; ++j)
          h[j] = fmaf(ex2(p.x * a2[j]), h[j], p.y * bv[j]);
      }
#pragma unroll
      for (int j = 0; j < NPL; ++j)
        s_ab[g * NMAX + q * NPL + j] = make_float2(ex2(a2[j] * dsum), h[j]);
    }
    __syncthreads();
    // the chain from the left: bnd_c, then bnd_{c+1} = alpha_c bnd_c +
    // beta_c; a chunk's 8 channels of one state are one 32-byte run
    if (tid < kWarpCh * N) {
      const int n = tid / kWarpCh, cc = tid % kWarpCh, d = d0 + cc;
      float* dst = bnd + ((size_t)b * nc * N + n) * dim + d;
      for (int cw = lo; cw < hi; ++cw) {
        if (d < dim) dst[(size_t)cw * N * dim] = H;
        const float2 ab = s_ab_all[(cw - lo) * (P::kAbW / 2) + cc * NMAX + n];
        H = fmaf(ab.x, H, ab.y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Main pass
// ---------------------------------------------------------------------------

// Shared memory of a main-pass block, in floats, each array 16-byte
// aligned: B and C rows, (dt, dt u) per (t, c), the lanes' partial sums
template <int NMAX>
struct MainPlan {
  static constexpr int kB = 0;                            // [16][NMAX]
  static constexpr int kC = kB + kChunk * NMAX;           // [16][NMAX]
  static constexpr int kDd = kC + kChunk * NMAX;          // [16][32] float2
  static constexpr int kY = kDd + 2 * kChunk * kChannels; // [16][128]
  static constexpr int kBytes = (kY + kChunk * kThreads) * 4;  // <= 16 KB
};

// grid (ceil(dim / 32), ceil(n_chunks / kGroup), batch); 6 blocks of 128
// threads an SM at least (the kernel takes 64 registers: 8 fit)
template <typename T, int NMAX>
__global__ void __launch_bounds__(kThreads, 6)
scan_fwd_train_kernel(const T* __restrict__ u, const float* __restrict__ A,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ Dv, const T* __restrict__ z,
                      T* __restrict__ out, float* __restrict__ o,
                      const float* __restrict__ bnd, int L, int dim, int N) {
  using P = MainPlan<NMAX>;
  constexpr int NPL = NMAX / kLanes;  // states a lane
  static_assert(NPL >= 2, "plan");
  extern __shared__ __align__(16) float smem[];
  float* s_B = smem + P::kB;
  float* s_C = smem + P::kC;
  float2* s_dd = reinterpret_cast<float2*>(smem + P::kDd);
  float* s_y = smem + P::kY;

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kChannels, b = blockIdx.z;
  const int nc = (L + kChunk - 1) / kChunk;
  const int c_begin = blockIdx.y * kGroup;
  const int c_end = min(nc, c_begin + kGroup);
  // phases A and C: channel ca, timesteps tg * kSteps .. + kSteps
  const int ca = tid % kChannels, tg = tid / kChannels;
  const int da = d0 + ca;
  const bool active = da < dim;
  // phase B: channel cb, states kb * NPL .. + NPL
  const int cb = tid / kLanes, kb = tid % kLanes;
  const int db = d0 + cb;

  // the state entering the group's first chunk, from the state pass
  float a2[NPL], h[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = kb * NPL + j;
    const bool ok = db < dim && n < N;
    a2[j] = ok ? A[(size_t)db * N + n] * kLog2e : 0.f;
    h[j] = ok ? bnd[(((size_t)b * nc + c_begin) * N + n) * dim + db] : 0.f;
  }
  const float skip_w = (Dv != nullptr && active) ? Dv[da] : 0.f;
  const size_t row0 = (size_t)b * L;

  // every global load of the chunk at c0 into registers, all issued before
  // the first is stored (one memory latency a chunk)
  constexpr int NBC = kChunk * NMAX / kThreads;
  T r_b[NBC], r_c[NBC], r_u[kSteps], r_z[kSteps];
  float r_dt[kSteps];
  const T zero = from_f32<T>(0.f);
  auto load_chunk = [&](int c0) {
    const int n_t = min(kChunk, L - c0);
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
      r_dt[i] = ok ? o[base + tt * dim] : 0.f;  // dt, from the state pass
    }
  };

  for (int t0 = c_begin * kChunk; t0 < c_end * kChunk; t0 += kChunk) {
    const int nt = min(kChunk, L - t0);
    load_chunk(t0);
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int j = 0; j < NBC; ++j) {
      s_B[tid + j * kThreads] = to_f32(r_b[j]);
      s_C[tid + j * kThreads] = to_f32(r_c[j]);
    }
    // phase A: dt u into shared memory; the skip and the gate for phase C
    float skip[kSteps], gate[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int tt = tg * kSteps + i;
      const float uv = to_f32(r_u[i]);
      const float dt = tt < nt ? r_dt[i] : 0.f;  // past the end: it stays
      s_dd[tt * kChannels + ca] = make_float2(dt, dt * uv);
      skip[i] = uv * skip_w;
      gate[i] = z != nullptr ? silu(to_f32(r_z[i])) : 1.f;
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

    // phase C: o = the 4 partials + skip, y = o * gate, stored along d
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int tt = tg * kSteps + i;
      float part[kLanes];
      lds<kLanes>(s_y + tt * kThreads + ca * kLanes, part);
      const float s = (((part[0] + part[1]) + part[2]) + part[3]) + skip[i];
      if (active && tt < nt) {
        const size_t idx = (row0 + t0 + tt) * dim + da;
        o[idx] = s;
        out[idx] = from_f32<T>(s * gate[i]);
      }
    }
  }
}

// the shared-memory ceiling is set once per instantiation
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done || bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

template <typename T, int NMAX, int RMAX>
int launch(const void* const* p, int batch, int L, int dim, int N, int R,
           int use_softplus, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  using SP = StatePlan<NMAX, RMAX, kMma>;
  auto states_kernel = scan_fwd_train_states_kernel<T, NMAX, RMAX>;
  static bool states_set = false;
  cudaError_t err = allow_smem(states_kernel, SP::kBytes, states_set);
  if (err != cudaSuccess) return err;
  const int nc = (L + kChunk - 1) / kChunk;
  const T* u = static_cast<const T*>(p[0]);
  const float* A = static_cast<const float*>(p[3]);
  const T* Bm = static_cast<const T*>(p[4]);
  float* o = static_cast<float*>(const_cast<void*>(p[10]));
  float* bnd = static_cast<float*>(const_cast<void*>(p[11]));
  // rows copied as 16-byte vectors where every row segment is whole ones
  auto a16 = [](const void* v) {
    return reinterpret_cast<uintptr_t>(v) % 16 == 0;
  };
  bool vec = R == RMAX && N == NMAX && dim % (16 / (int)sizeof(T)) == 0;
  for (int i : {0, 1, 4, 10}) vec = vec && a16(p[i]);
  dim3 sgrid((dim + kWarpCh - 1) / kWarpCh, batch);
  states_kernel<<<sgrid, SP::kWarps * 32, SP::kBytes, stream>>>(
      u, static_cast<const T*>(p[1]), static_cast<const T*>(p[2]), A, Bm,
      static_cast<const float*>(p[8]), bnd, o, L, dim, N, R, use_softplus,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((dim + kChannels - 1) / kChannels, (nc + kGroup - 1) / kGroup,
            batch);
  scan_fwd_train_kernel<T, NMAX><<<grid, kThreads, MainPlan<NMAX>::kBytes,
                                   stream>>>(
      u, A, Bm, static_cast<const T*>(p[5]), static_cast<const float*>(p[6]),
      static_cast<const T*>(p[7]), static_cast<T*>(const_cast<void*>(p[9])),
      o, bnd, L, dim, N);
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

// dtype: 0 = float32, 1 = bfloat16.  D, z and bias may be null.  Launches
// the state pass (which writes bnd, and dt into o), then the main pass
// (which reads them and writes y and o), on `stream`.  Returns the CUDA
// error of the launches (0 on success), or cudaErrorInvalidValue for
// shapes the kernels do not take (1 <= N <= 32, 1 <= r <= 64).
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
  return dtype == 0 ? dispatch<float>(p, batch, L, dim, n_state, dt_rank,
                                      use_softplus, s)
                    : dispatch<__nv_bfloat16>(p, batch, L, dim, n_state,
                                              dt_rank, use_softplus, s);
}
