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
// tile of kBlockCh = 64 channels, (ceil(dim / 64), batch, L, N); dA as one
// partial per batch row and group of kGroup = 4 chunks, (batch,
// ceil(ceil(L / 16) / 4), dim, N).  The wrapper sums the partials (no float
// atomics: the gradients repeat bit for bit).  Inputs: u, dt_low (batch, L,
// r), dt_w (r, dim), B, C (batch, L, N) in T (float or bf16); A (dim, N),
// bias (dim,), go (batch, L, dim), bnd (batch, ceil(L / 16), N, dim) in
// fp32.  Workspace: w, the carry pass's output, batch x ceil(L / 16) x
// ceil(dim / 8) x N x 8 fp32 (a tile of 8 channels' N carries together).
//
// What bounds it on an H100 at the DiM-L/2 training mixer shapes (16 x 256
// or 4 x 1024 tokens, dim 1024, N 16, r 32, bf16): inputs read once (u 8.4
// MB, go and the states 16.8 MB each) and du, ddt written once (16.8 MB
// each), 76.7 MB or 22.9 us at 3.35 TB/s; 2r + 20N + 18 = 402 fp32 flop a
// (b, t, d), 1.69 GFLOP or 25.2 us at 67 TFLOP/s.  Operations bound it.
// The first design (one thread a channel walking all of L, 64-channel
// blocks, ~90 KB of shared memory) ran at 0.77 ms and 2.97 ms at 4 x 1024:
// L times the latency of one step of one thread's chain.
//
// Design: chunks in parallel along L, in two kernels.
//   Carry pass.  The reverse recurrence needs only dt', C and go, so the
//     carry entering chunk c from the right, w_c = a_{t+1} e_{t+1} at its
//     last step t, is an affine chain over chunks:
//       w_{c-1} = alpha_c w_c + beta_c,  w_{last} = 0,
//     alpha_c = exp2(A log2e sum_{t in c} dt'_t), beta_c the chunk's carry
//     out of its first step seeded with zero.  A block takes 8 channels of
//     a batch row and 4 chunks at once (8 at N 32), a warp a chunk, from
//     the last: the warp expands dt' for its 16 x 8 (t, d) (one m16n8k16
//     mma.sync per 16 of r for bf16, FMAs for fp32), walks its chunk
//     backwards (states over 4 lanes) and leaves (alpha, beta); the block
//     chains them from the right and writes w.  The next chunks' dt_low, C
//     and go rows come in by cp.async while these are walked.
//   Main pass.  A block takes 64 channels (8 warps of 8), one batch row
//     and a group of 4 chunks; each chunk is independent, seeded with bnd
//     for the replay and with w for the reverse walk.  Per chunk:
//      A  each warp expands dt' for its 16 x 8 (t, d), adds the bias and
//         takes softplus and sigmoid on the SFU (ex2 / lg2 / rcp); (dt',
//         dt' u) and go go to shared memory;
//      B  each channel's N states over 4 lanes: the replay keeps the
//         lane's 16 states in registers, the reverse walk computes a_t
//         again (keeping them too needs ~250 registers, one block an SM,
//         and timed slower).  dB and dC are summed over the warp's 8
//         channels with a reduce-scatter of xor shuffles (7 a step at N
//         16: each lane ends with one of the 32 sums), then over the
//         block's warps in shared memory; sum_n e B and sum_n da a A go
//         through shared memory to the lanes that write du and ddt.
// A ragged last chunk runs all 16 steps with dt' = 0 and go = 0 past the
// end (the state and the carry stay); a ragged dim masks its channels.
//
// Measured (PERF.md, H100 80GB HBM3, 700 W): 0.190 ms at 16 x 256 and at
// 4 x 1024 (carry pass ~0.05, main pass ~0.14), 7.5x the bound.  Without
// the dB/dC reduce-scatter (timing only) it takes 0.16; clock64 counters
// put a third of a main-pass warp's chunk in the reverse walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChunk = 16;                     // steps between saved states
constexpr int kLanes = 4;                      // lanes a channel
constexpr int kWarpCh = 32 / kLanes;           // channels a warp
constexpr int kWarps = 8;                      // warps a main-pass block
constexpr int kThreads = kWarps * 32;
constexpr int kBlockCh = kWarps * kWarpCh;     // channels a main-pass block
constexpr int kGroup = 4;                      // chunks a main-pass block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
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

// dt' = softplus(x) and sigmoid(x) from one exp2: with e = exp(-|x|),
// softplus = max(x, 0) + log1p(e) (lg2(1 + e) ln 2 for e >= 2^-6, its
// series below: no threshold, ~1e-6 relative) and sigmoid = (x >= 0 ? 1 :
// e) / (1 + e).  Without softplus dt' = x and the sigmoid is unused.
__device__ __forceinline__ void softplus_sigmoid(float x, int use_softplus,
                                                 float& dt, float& sig) {
  if (!use_softplus) {
    dt = x;
    sig = 1.f;
    return;
  }
  const float e = ex2(-fabsf(x) * kLog2e);
  const float series =
      e * fmaf(e, fmaf(e, fmaf(e, -0.25f, 1.f / 3.f), -0.5f), 1.f);
  const float tail = e < 0.015625f ? series : lg2(1.f + e) * kLn2;
  dt = fmaxf(x, 0.f) + tail;
  sig = (x >= 0.f ? 1.f : e) * rcp(1.f + e);
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

// One round of a reduce-scatter over the lanes xor o: of the M values, a
// lane keeps the lower half if its bit o is clear (hi false), the upper if
// set, and adds its partner's copy of them.  At M = 1 the round sums the
// one value on both lanes.
template <int M>
__device__ __forceinline__ void rs_round(float* v, int o, bool hi) {
  if constexpr (M >= 2) {
    constexpr int H = M / 2;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = hi ? v[i] : v[i + H];
      const float keep = hi ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  }
}

// Sums each of V values over the 8 lanes that share lane & 3 (the warp's
// 8 channels at the same states).  Afterwards the lane holds, in v[0 ..
// max(V / 8, 1)), the sums of the values from index rs_offset<V>(lane) on.
template <int V>
__device__ __forceinline__ void reduce_scatter8(float (&v)[V], int lane) {
  rs_round<V>(v, 16, (lane & 16) != 0);
  rs_round<(V >= 2 ? V / 2 : 1)>(v, 8, (lane & 8) != 0);
  rs_round<(V >= 4 ? V / 4 : 1)>(v, 4, (lane & 4) != 0);
}
template <int V>
__device__ __forceinline__ int rs_offset(int lane) {
  return ((lane & 16) ? V / 2 : 0) + ((lane & 8) ? V / 4 : 0) +
         ((lane & 4) ? V / 8 : 0);
}

// raw[e] = <dt_low row t0 + tt, dt_w column c> for the four (tt, c) of a
// thread in the m16n8 accumulator layout: e = 2 i + j -> tt = g + 8 i, c =
// 2 q + j.  bf16: one mma.sync per 16 of r, dt_low rows in shared memory
// (bf16, rows of RMAX + 8), dt_w's fragments in registers.  fp32: FMAs over
// rows of RMAX + 4 floats, w_rows the thread's channels 2q and 2q + 1.
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

// fp32 dt_w rows of channels d0 .. d0 + nch in shared memory, [c][RMAX + 4]
template <typename T, int RMAX>
__device__ __forceinline__ void load_w_rows(const T* dt_w, float* s_w, int d0,
                                            int nch, int dim, int R, int tid,
                                            int nthreads) {
  constexpr int LDF = RMAX + 4;
  for (int i = tid; i < nch * RMAX; i += nthreads) {
    const int k = i / nch, c = i % nch;
    s_w[c * LDF + k] =
        (k < R && d0 + c < dim) ? to_f32(dt_w[(size_t)k * dim + d0 + c]) : 0.f;
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

// ---------------------------------------------------------------------------
// Carry pass
// ---------------------------------------------------------------------------

// Shared memory of a carry block, in floats: dt_w rows (fp32 only), then per
// warp two stages of its chunk (dt_low rows as the mma reads them, C rows
// in T, go 16 x 8 in fp32), C in fp32, (dt', go) per (t, c) and (alpha,
// beta) per (c, n).  kWarps chunks at once, at least 8 N threads for the
// chain.
template <int NMAX, int RMAX, bool kMma>
struct CarryPlan {
  static constexpr int kWarps = NMAX / 4 > 4 ? NMAX / 4 : 4;
  static constexpr int kWSize = kMma ? 0 : kWarpCh * (RMAX + 4);
  static constexpr int kDtlW = kMma ? kChunk * (RMAX + 8) / 2
                                    : kChunk * (RMAX + 4);
  static constexpr int kCRawW = kChunk * NMAX / (kMma ? 2 : 1);
  static constexpr int kStageW = kDtlW + kCRawW + kChunk * kWarpCh;
  static constexpr int kCW = kChunk * NMAX;
  static constexpr int kStW = kChunk * kWarpCh * 2;
  static constexpr int kAbW = kWarpCh * NMAX * 2;
  static constexpr int kW = 0;
  static constexpr int kStage = kW + kWSize;
  static constexpr int kC = kStage + kWarps * 2 * kStageW;
  static constexpr int kSt = kC + kWarps * kCW;
  static constexpr int kAb = kSt + kWarps * kStW;
  static constexpr int kBytes = (kAb + kWarps * kAbW) * 4;
};

// grid (ceil(dim / 8), batch), CarryPlan::kWarps warps: the chunks from the
// last, kWarps at once, a warp a chunk; the next kWarps chunks' rows are
// copied in while these are walked.
template <typename T, int NMAX, int RMAX>
__global__ void __launch_bounds__(CarryPlan<NMAX, RMAX, true>::kWarps * 32)
scan_bwd_carry_kernel(const T* __restrict__ dt_low,
                      const T* __restrict__ dt_w, const float* __restrict__ A,
                      const T* __restrict__ Cm,
                      const float* __restrict__ bias,
                      const float* __restrict__ go, float* __restrict__ wcar,
                      int L, int dim, int N, int R, int use_softplus,
                      int vec) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  using P = CarryPlan<NMAX, RMAX, kMma>;
  constexpr int NPL = NMAX / kLanes;
  constexpr int nw = P::kWarps, kNT = nw * 32;
  constexpr int LDF = RMAX + 4, LDB = RMAX + 8, kPitch = kMma ? LDB : LDF;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int d0 = blockIdx.x * kWarpCh, b = blockIdx.y;
  const int nc = (L + kChunk - 1) / kChunk;
  const size_t row0 = (size_t)b * L;
  float* s_w = smem + P::kW;
  float* stage0 = smem + P::kStage + warp * 2 * P::kStageW;
  float* s_c = smem + P::kC + warp * P::kCW;
  float2* s_st = reinterpret_cast<float2*>(smem + P::kSt + warp * P::kStW);
  const float2* s_ab_all = reinterpret_cast<const float2*>(smem + P::kAb);
  float2* s_ab = reinterpret_cast<float2*>(smem + P::kAb + warp * P::kAbW);

  // chunk c's dt_low, C and go into the warp's stage buffer
  auto stage_chunk = [&](int c, float* buf) {
    const int t0 = c * kChunk, nt = min(kChunk, L - t0);
    T* dtl = reinterpret_cast<T*>(buf);
    T* craw = reinterpret_cast<T*>(buf + P::kDtlW);
    float* gob = buf + P::kDtlW + P::kCRawW;
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
          return tt < nt && n < N ? Cm + (row0 + t0 + tt) * N + n : nullptr;
        },
        [&](int i) { return craw + i; });
    stage<float, kChunk * kWarpCh, 32>(
        vec, lane,
        [&](int i) -> const float* {
          const int tt = i / kWarpCh, d = d0 + i % kWarpCh;
          return tt < nt && d < dim ? go + (row0 + t0 + tt) * dim + d
                                    : nullptr;
        },
        [&](int i) { return gob + i; });
  };

  uint32_t bfr[RMAX / 16][2];
  load_w_frags<T, RMAX>(dt_w, d0 + g, dim, R, q, bfr);
  if constexpr (!kMma)
    load_w_rows<T, RMAX>(dt_w, s_w, d0, kWarpCh, dim, R, tid, kNT);
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

  float W = 0.f;  // the chain's carry, for thread (n, c) = (tid / 8, tid % 8)
  if (vec) {
    const int c = max(0, nc - nw) + warp;
    if (c < nc) stage_chunk(c, stage0);
    cp_async_commit();
  }
  int it = 0;
  for (int hi = nc; hi > 0; hi -= nw, ++it) {
    const int lo = max(0, hi - nw);
    const int c = lo + warp;
    float* buf = stage0 + (it & 1) * P::kStageW;
    __syncthreads();  // the previous chain's reads are done; s_w is ready
    if (vec) {
      const int c_next = max(0, hi - 2 * nw) + warp;
      if (hi - nw > 0 && c_next < hi - nw)
        stage_chunk(c_next, stage0 + ((it + 1) & 1) * P::kStageW);
      cp_async_commit();
      cp_async_wait<1>();
    } else if (c < hi) {
      stage_chunk(c, buf);
    }
    __syncwarp();
    if (c < hi) {
      const int t0 = c * kChunk, nt = min(kChunk, L - t0);
      const T* craw = reinterpret_cast<const T*>(buf + P::kDtlW);
      const float* gob = buf + P::kDtlW + P::kCRawW;
#pragma unroll
      for (int m = 0; m < kChunk * NMAX / 32; ++m)
        s_c[lane + 32 * m] = to_f32(craw[lane + 32 * m]);
      float raw[4];
      expand_dt<kMma, RMAX>(buf, s_w + 2 * q * LDF, bfr, g, q, raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = g + 8 * (e >> 1), cc = 2 * q + (e & 1);
        float dt, sig;
        softplus_sigmoid(raw[e] + bias2[e & 1], use_softplus, dt, sig);
        if (tt >= nt || d0 + cc >= dim) dt = 0.f;
        s_st[tt * kWarpCh + cc] = make_float2(dt, gob[tt * kWarpCh + cc]);
      }
      __syncwarp();
      // the chunk's reverse walk from a zero carry (channel g, states
      // q * NPL ..): beta = the carry out of its first step
      float carry[NPL], dsum = 0.f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) carry[j] = 0.f;
#pragma unroll
      for (int tt = kChunk - 1; tt >= 0; --tt) {
        const float2 p = s_st[tt * kWarpCh + g];
        float cv[NPL];
        lds<NPL>(s_c + tt * NMAX + q * NPL, cv);
        dsum += p.x;
#pragma unroll
        for (int j = 0; j < NPL; ++j)
          carry[j] = ex2(p.x * a2[j]) * fmaf(cv[j], p.y, carry[j]);
      }
#pragma unroll
      for (int j = 0; j < NPL; ++j)
        s_ab[g * NMAX + q * NPL + j] = make_float2(ex2(a2[j] * dsum),
                                                   carry[j]);
    }
    __syncthreads();
    // the chain from the right: w_c, then w_{c-1} = alpha_c w_c + beta_c;
    // w is [b][chunk][channel tile of 8][n][8], so a chunk's N x 8 carries
    // of the block are one run
    if (tid < kWarpCh * N) {
      const int n = tid / kWarpCh, cc = tid % kWarpCh;
      float* wb = wcar + ((size_t)b * nc * gridDim.x + blockIdx.x) * N *
                             kWarpCh + tid;
      for (int cw = hi - 1; cw >= lo; --cw) {
        wb[(size_t)cw * gridDim.x * N * kWarpCh] = W;
        const float2 ab = s_ab_all[(cw - lo) * (P::kAbW / 2) + cc * NMAX + n];
        W = fmaf(ab.x, W, ab.y);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Main pass
// ---------------------------------------------------------------------------

// Shared memory of a main-pass block, in floats, each array 16-byte
// aligned: dt_w rows (fp32 only), the chunk's dt_low rows as the mma reads
// them, B and C in fp32; then per warp (dt', dt' u) and go per (t, c), the
// dB/dC sums of each step, and each lane's (sum_n e B, sum_n da a A) of
// each step.
template <int NMAX, int RMAX, bool kMma>
struct MainPlan {
  static constexpr int kW = 0;                                 // [64][r + 4]
  static constexpr int kWSize = kMma ? 0 : kBlockCh * (RMAX + 4);
  static constexpr int kDtl = kW + kWSize;                     // [16][r + ..]
  static constexpr int kDtlSize = kMma ? kChunk * (RMAX + 8) / 2
                                       : kChunk * (RMAX + 4);
  static constexpr int kB = kDtl + kDtlSize;                   // [16][NMAX]
  static constexpr int kC = kB + kChunk * NMAX;                // [16][NMAX]
  static constexpr int kDd = kC + kChunk * NMAX;  // [warp][16][8] float2
  static constexpr int kGo = kDd + kWarps * kChunk * kWarpCh * 2;
  static constexpr int kRed = kGo + kWarps * kChunk * kWarpCh;
  static constexpr int kE = kRed + kWarps * kChunk * 2 * NMAX;  // float2
  static constexpr int kBytes = (kE + kWarps * kChunk * 32 * 2) * 4;
};

// grid (ceil(dim / 64), ceil(n_chunks / kGroup), batch); two blocks an SM
template <typename T, int NMAX, int RMAX>
__global__ void __launch_bounds__(kThreads, 2)
scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt_low,
                const T* __restrict__ dt_w, const float* __restrict__ A,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ bias, const float* __restrict__ go,
                const float* __restrict__ bnd,
                const float* __restrict__ wcar, float* __restrict__ du,
                float* __restrict__ ddt, float* __restrict__ dB_part,
                float* __restrict__ dC_part, float* __restrict__ dA_part,
                int batch, int L, int dim, int N, int R, int use_softplus,
                int vec) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  using P = MainPlan<NMAX, RMAX, kMma>;
  constexpr int NPL = NMAX / kLanes;  // states a lane
  constexpr int LDF = RMAX + 4, LDB = RMAX + 8;
  static_assert(RMAX % 16 == 0 && NPL >= 2, "plan");
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem + P::kW;
  float* s_dtl = smem + P::kDtl;
  __nv_bfloat16* dtl_bf = reinterpret_cast<__nv_bfloat16*>(s_dtl);
  float* s_B = smem + P::kB;
  float* s_C = smem + P::kC;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // accumulator layout: steps g, g + 8 of channels 2q, 2q + 1; state
  // layout: channel g, states q * NPL .. q * NPL + NPL - 1
  const int g = lane >> 2, q = lane & 3;
  const int tile = blockIdx.x, grp = blockIdx.y, b = blockIdx.z;
  const int d0 = tile * kBlockCh, dw = d0 + warp * kWarpCh;
  const int nc = (L + kChunk - 1) / kChunk;
  const int c_begin = grp * kGroup, c_end = min(nc, c_begin + kGroup);
  const int n_tiles8 = (dim + kWarpCh - 1) / kWarpCh;  // w's channel tiles
  const size_t row0 = (size_t)b * L;
  float2* s_dd = reinterpret_cast<float2*>(smem + P::kDd) +
                 warp * kChunk * kWarpCh;                  // [16][8]
  float* s_go = smem + P::kGo + warp * kChunk * kWarpCh;   // [16][8]
  float* s_red = smem + P::kRed + warp * kChunk * 2 * NMAX;  // [16][2 NMAX]
  float2* s_e = reinterpret_cast<float2*>(smem + P::kE);     // [w][16][32]

  uint32_t bfr[RMAX / 16][2];
  load_w_frags<T, RMAX>(dt_w, dw + g, dim, R, q, bfr);
  if constexpr (!kMma)
    load_w_rows<T, RMAX>(dt_w, s_w, d0, kBlockCh, dim, R, tid, kThreads);
  float bias2[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = dw + 2 * q + j;
    bias2[j] = (bias != nullptr && d < dim) ? bias[d] : 0.f;
  }
  // where the lane's dB/dC sums go in a step's row of 2 NMAX (dB, then dC)
  constexpr int RM = 2 * NPL >= 8 ? 2 * NPL / 8 : 1;
  int red_at[RM];
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int idx = rs_offset<2 * NPL>(lane) + m;
    red_at[m] = idx / NPL * NMAX + q * NPL + idx % NPL;
  }
  const int ds = dw + g;  // the state layout's channel
  const bool s_live = ds < dim;
  float a2[NPL], dA[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = q * NPL + j;
    a2[j] = (s_live && n < N) ? A[(size_t)ds * N + n] * kLog2e : 0.f;
    dA[j] = 0.f;
  }

  // a chunk's global loads into registers, all issued before any is used
  constexpr int NDT = (kChunk * RMAX + kThreads - 1) / kThreads;
  constexpr int NBC = (kChunk * NMAX + kThreads - 1) / kThreads;
  T r_dt[NDT], r_b[NBC], r_c[NBC], r_u[4];
  float r_go[4], r_h0[NPL], r_w[NPL];
  auto load = [&](int c) {
    const int t0 = c * kChunk, nt = min(kChunk, L - t0);
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      const int i = tid + j * kThreads, tt = i / RMAX, k = i % RMAX;
      r_dt[j] = (i < kChunk * RMAX && tt < nt && k < R)
                    ? dt_low[(row0 + t0 + tt) * R + k] : zero_of<T>();
    }
#pragma unroll
    for (int j = 0; j < NBC; ++j) {
      const int i = tid + j * kThreads, tt = i / NMAX, n = i % NMAX;
      const bool ok = i < kChunk * NMAX && tt < nt && n < N;
      const size_t src = (row0 + t0 + tt) * N + n;
      r_b[j] = ok ? Bm[src] : zero_of<T>();
      r_c[j] = ok ? Cm[src] : zero_of<T>();
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tt = g + 8 * (e >> 1), d = dw + 2 * q + (e & 1);
      const bool ok = tt < nt && d < dim;
      const size_t idx = (row0 + t0 + tt) * dim + d;
      r_u[e] = ok ? u[idx] : zero_of<T>();
      r_go[e] = ok ? go[idx] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = q * NPL + j;
      const bool ok = s_live && n < N;
      const size_t o = (((size_t)b * nc + c) * N + n) * dim + ds;
      const size_t ow =
          (((size_t)b * nc + c) * n_tiles8 + (ds >> 3)) * N * kWarpCh +
          n * kWarpCh + (ds & 7);
      r_h0[j] = ok ? bnd[o] : 0.f;
      r_w[j] = ok ? wcar[ow] : 0.f;
    }
  };

  for (int c = c_begin; c < c_end; ++c) {
    const int t0 = c * kChunk, nt = min(kChunk, L - t0);
    load(c);          // in flight while the block gathers
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      const int i = tid + j * kThreads, tt = i / RMAX, k = i % RMAX;
      if (i < kChunk * RMAX) {
        if constexpr (kMma) {
          dtl_bf[tt * LDB + k] = r_dt[j];
        } else {
          s_dtl[tt * LDF + k] = r_dt[j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NBC; ++j) {
      const int i = tid + j * kThreads;
      if (i < kChunk * NMAX) {
        s_B[i] = to_f32(r_b[j]);
        s_C[i] = to_f32(r_c[j]);
      }
    }
    __syncthreads();

    // A: dt', sigmoid, dt' u for the warp's 16 x 8 (t, d)
    float raw[4], uf[4], dtr[4], sgr[4];
    expand_dt<kMma, RMAX>(s_dtl, s_w + (warp * kWarpCh + 2 * q) * LDF, bfr,
                          g, q, raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tt = g + 8 * (e >> 1), cc = 2 * q + (e & 1);
      uf[e] = to_f32(r_u[e]);
      softplus_sigmoid(raw[e] + bias2[e & 1], use_softplus, dtr[e], sgr[e]);
      if (tt >= nt || dw + cc >= dim) dtr[e] = 0.f;  // past the end: neutral
      s_dd[tt * kWarpCh + cc] = make_float2(dtr[e], dtr[e] * uf[e]);
      s_go[tt * kWarpCh + cc] = r_go[e];
    }
    __syncwarp();

    // B: the replay from the saved state; the states stay in registers, a_t
    // is computed again in the reverse walk (that keeps two blocks an SM)
    float hs[kChunk][NPL];
    {
      float h[NPL];
#pragma unroll
      for (int j = 0; j < NPL; ++j) h[j] = r_h0[j];
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt) {
        const float2 p = s_dd[tt * kWarpCh + g];
        float bv[NPL];
        lds<NPL>(s_B + tt * NMAX + q * NPL, bv);
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          h[j] = fmaf(ex2(p.x * a2[j]), h[j], p.y * bv[j]);
          hs[tt][j] = h[j];
        }
      }
    }
    // the reverse walk from the carry pass's w
    float carry[NPL];
#pragma unroll
    for (int j = 0; j < NPL; ++j) carry[j] = r_w[j];
#pragma unroll
    for (int tt = kChunk - 1; tt >= 0; --tt) {
      const float2 p = s_dd[tt * kWarpCh + g];
      const float gv = s_go[tt * kWarpCh + g];
      float bv[NPL], cv[NPL], v[2 * NPL];
      lds<NPL>(s_B + tt * NMAX + q * NPL, bv);
      lds<NPL>(s_C + tt * NMAX + q * NPL, cv);
      float eB = 0.f, daA = 0.f;
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        const float a = ex2(p.x * a2[j]);
        const float e = fmaf(cv[j], gv, carry[j]);
        const float hp = tt > 0 ? hs[tt > 0 ? tt - 1 : 0][j] : r_h0[j];
        const float cn = a * e;      // the carry into step tt - 1
        const float da_a = cn * hp;  // e h_{t-1} a
        eB = fmaf(e, bv[j], eB);
        daA = fmaf(da_a, a2[j], daA);  // sum da a A / ln 2
        dA[j] = fmaf(da_a, p.x, dA[j]);
        v[j] = e * p.y;               // dB term
        v[NPL + j] = gv * hs[tt][j];  // dC term
        carry[j] = cn;
      }
      s_e[(warp * kChunk + tt) * 32 + lane] = make_float2(eB, daA);
      reduce_scatter8<2 * NPL>(v, lane);
#pragma unroll
      for (int m = 0; m < RM; ++m) s_red[tt * 2 * NMAX + red_at[m]] = v[m];
    }
    __syncthreads();

    // C: the block's dB, dC partials; du and ddt (channel pairs 2q, 2q + 1)
    for (int i = tid; i < kChunk * 2 * NMAX; i += kThreads) {
      const int tt = i / (2 * NMAX), r = i % (2 * NMAX);
      const int type = r / NMAX, n = r % NMAX;
      if (tt < nt && n < N) {
        const float* pr = smem + P::kRed + tt * 2 * NMAX + r;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += pr[w * kChunk * 2 * NMAX];
        float* out = type ? dC_part : dB_part;
        out[(((size_t)tile * batch + b) * L + t0 + tt) * N + n] = s;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tt = g + 8 * i, d = dw + 2 * q;
      if (tt >= nt || d >= dim) continue;
      const float4* pe = reinterpret_cast<const float4*>(
          s_e + (warp * kChunk + tt) * 32 + 2 * q * kLanes);
      const float4 e0 = pe[0], e1 = pe[1], e2 = pe[2], e3 = pe[3];
      float out_du[2], out_ddt[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 x = j ? e2 : e0, y = j ? e3 : e1;
        const float eB = (x.x + x.z) + (y.x + y.z);
        const float daA = (x.y + x.w) + (y.y + y.w);
        const int e = 2 * i + j;
        out_du[j] = eB * dtr[e];
        const float gg = fmaf(eB, uf[e], daA * kLn2);
        out_ddt[j] = use_softplus ? gg * sgr[e] : gg;
      }
      const size_t idx = (row0 + t0 + tt) * dim + d;
      if (vec) {  // dim even: the pair is 8-byte aligned
        *reinterpret_cast<float2*>(du + idx) =
            make_float2(out_du[0], out_du[1]);
        *reinterpret_cast<float2*>(ddt + idx) =
            make_float2(out_ddt[0], out_ddt[1]);
      } else {
        du[idx] = out_du[0];
        ddt[idx] = out_ddt[0];
        if (d + 1 < dim) {
          du[idx + 1] = out_du[1];
          ddt[idx + 1] = out_ddt[1];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = q * NPL + j;
    if (s_live && n < N)
      dA_part[(((size_t)b * gridDim.y + grp) * dim + ds) * N + n] = dA[j];
  }
}

// the shared-memory ceilings are set once per instantiation
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
  using CP = CarryPlan<NMAX, RMAX, kMma>;
  using MP = MainPlan<NMAX, RMAX, kMma>;
  auto carry_kernel = scan_bwd_carry_kernel<T, NMAX, RMAX>;
  auto main_kernel = scan_bwd_kernel<T, NMAX, RMAX>;
  static bool carry_set = false, main_set = false;
  cudaError_t err = allow_smem(carry_kernel, CP::kBytes, carry_set);
  if (err == cudaSuccess) err = allow_smem(main_kernel, MP::kBytes, main_set);
  if (err != cudaSuccess) return err;
  const int nc = (L + kChunk - 1) / kChunk;
  const T* dt_low = static_cast<const T*>(p[1]);
  const T* dt_w = static_cast<const T*>(p[2]);
  const float* A = static_cast<const float*>(p[3]);
  const T* Cm = static_cast<const T*>(p[5]);
  const float* bias = static_cast<const float*>(p[6]);
  const float* go = static_cast<const float*>(p[7]);
  float* wcar = static_cast<float*>(const_cast<void*>(p[9]));
  // rows copied as 16-byte vectors where every row segment is whole ones
  auto a16 = [](const void* v) {
    return reinterpret_cast<uintptr_t>(v) % 16 == 0;
  };
  bool vec = R == RMAX && N == NMAX && dim % (16 / (int)sizeof(T)) == 0;
  for (int i : {0, 1, 4, 5, 7, 8, 9}) vec = vec && a16(p[i]);
  dim3 cgrid((dim + kWarpCh - 1) / kWarpCh, batch);
  carry_kernel<<<cgrid, CP::kWarps * 32, CP::kBytes, stream>>>(
      dt_low, dt_w, A, Cm, bias, go, wcar, L, dim, N, R, use_softplus, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((dim + kBlockCh - 1) / kBlockCh, (nc + kGroup - 1) / kGroup,
            batch);
  main_kernel<<<grid, kThreads, MP::kBytes, stream>>>(
      static_cast<const T*>(p[0]), dt_low, dt_w, A,
      static_cast<const T*>(p[4]), static_cast<const T*>(p[5]), bias, go,
      static_cast<const float*>(p[8]), wcar,
      static_cast<float*>(const_cast<void*>(p[10])),
      static_cast<float*>(const_cast<void*>(p[11])),
      static_cast<float*>(const_cast<void*>(p[12])),
      static_cast<float*>(const_cast<void*>(p[13])),
      static_cast<float*>(const_cast<void*>(p[14])), batch, L, dim, N, R,
      use_softplus, vec);
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
// states the training forward saved every kChunk steps; w is the carry
// pass's workspace, batch x ceil(L / 16) x ceil(dim / 8) x N x 8 fp32.
// Launches the carry pass, then the main pass, on `stream`.  Returns the CUDA error of the
// launches (0 on success), or cudaErrorInvalidValue for shapes the kernels
// do not take (1 <= N <= 32, 1 <= r <= 64).
extern "C" int dimsum_selective_scan_bwd(
    const void* u, const void* dt_low, const void* dt_w, const void* A,
    const void* B, const void* C, const void* bias, const void* go,
    const void* bnd, void* w, void* du, void* ddt, void* dB_part,
    void* dC_part, void* dA_part, int batch, int L, int dim, int n_state,
    int dt_rank, int dtype, int use_softplus, void* stream) {
  if (batch < 1 || L < 1 || dim < 1 || n_state < 1 || dt_rank < 1 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const void* p[15] = {u,  dt_low, dt_w, A,   B,       C,       bias,   go,
                       bnd, w,     du,   ddt, dB_part, dC_part, dA_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float>(p, batch, L, dim, n_state, dt_rank,
                                      use_softplus, s)
                    : dispatch<__nv_bfloat16>(p, batch, L, dim, n_state,
                                              dt_rank, use_softplus, s);
}
