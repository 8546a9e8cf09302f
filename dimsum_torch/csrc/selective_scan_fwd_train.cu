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
//                                                       (or h0: see below)
//
// Layouts: u, z, y (batch, L, dim) in T; o (batch, L, dim) fp32; bnd
// (batch, ceil(L / 16), N, dim) fp32; dt_low (batch, L, r), B, C (batch,
// L, N), dt_w (r, dim) in T; A (dim, N), D and bias (dim,) fp32.  T is
// float or bf16.
//
// The h0 entry (dimsum_selective_scan_fwd_train_h0) seeds the state before
// step 0 with h0 (batch, dim, N) fp32, as the JAX selective_scan_xla(...,
// h0=h0) does on the XLA route that the Pallas kernel has no case for: the
// state pass chains the chunk-start states from h0 instead of zero, so
// bnd_0 = h0, and the main pass, which starts every group from bnd, needs
// nothing else.  It is a compile-time switch (kH0), so the h0-free
// instantiations compile as before.
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
//
// Ranks: 1 <= r <= 256 through RMAX 16, 32, 64, 128, 256 (the Pallas kernel
// takes any; above 64, N <= 8 on the N-16 plan).  Above 64 the state pass
// keeps one stage a warp (no copy ahead: two stages of fp32 rows at RMAX
// 256, N 32 would need 340 KB), plans for fewer warps an SM
// (states_min_blocks: dt_w's RMAX / 8 bf16 fragments a thread), skips the
// k-tiles past r, copies dt_low rows as 16-byte vectors whenever r is a
// multiple of 16 bytes' elements, and stages them in runs of 32 loads a
// thread otherwise.  The main pass does not depend on r.
//
// Two compile-time switches, off in every instantiation above, serve the
// cases the Pallas kernel takes beyond these.  kDelta, the full-delta entry
// (dimsum_selective_scan_fwd_train_delta; the JAX _pallas_fwd runs this
// kernel on a full delta, selective_scan.py:756-768): the state pass stages
// the chunk's delta rows (batch, L, dim) in u's type where it staged dt_low,
// and skips dt_w and the expansion; the bias and softplus stay in fp32.
// kSplit, N from 33 (the delta entry: 17) to 256 (the reference kernel's
// largest): each state's recurrence is its own and o is a sum over n, so
// both passes take one tile of 32 states, n_off = 32 (grid index) .. + 31,
// through their plans at NMAX 32; the state pass's tile 0 alone writes dt;
// at one tile the main pass stores o and y as above, at more its tile's sum
// of C h (no skip) in a workspace part[tile], and a third kernel,
// scan_fwd_train_combine_kernel, adds the tiles in order: o = sum + D u, y =
// o silu(z).  h0 is read where given (a runtime check).  Entry:
// dimsum_selective_scan_fwd_train_split; the delta entry takes kSplit too.

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
                                          int g, int q, int R,
                                          float (&raw)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) raw[e] = 0.f;
  if constexpr (kMma) {
    constexpr int LDB = RMAX + 8;
    const __nv_bfloat16* dtl = reinterpret_cast<const __nv_bfloat16*>(s_dtl);
#pragma unroll
    for (int k0 = 0; k0 < RMAX; k0 += 16) {
      // above RMAX 64 the k-tiles past r hold zeros: skipped
      if constexpr (RMAX > 64) {
        if (k0 >= R) break;
      }
      const __nv_bfloat16* ap = dtl + g * LDB + k0 + 2 * q;
      const uint32_t a[4] = {ld32(ap), ld32(ap + 8 * LDB), ld32(ap + 8),
                             ld32(ap + 8 * LDB + 8)};
      mma_bf16(raw, a, bfr[k0 / 16][0], bfr[k0 / 16][1]);
    }
  } else {
    constexpr int LDF = RMAX + 4;
#pragma unroll
    for (int k = 0; k < RMAX; k += 4) {
      if constexpr (RMAX > 64) {
        if (k >= R) break;
      }
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
// aligned), else as plain loads, each run of up to 32 issued before its
// stores.
template <typename T, int COUNT, int NT, typename Src, typename Dst>
__device__ __forceinline__ void stage(bool vec, int tid, Src src_of,
                                      Dst dst_of) {
  constexpr int kPer = 16 / sizeof(T);
  if (vec) {
    for (int v = tid; v < COUNT / kPer; v += NT) {
      cp_async16(dst_of(v * kPer), src_of(v * kPer));
    }
  } else {
    // runs of K loads a thread (one run up to RMAX 64)
    constexpr int M = (COUNT + NT - 1) / NT, K = M < 32 ? M : 32;
    for (int m0 = 0; m0 < M; m0 += K) {
      T r[K];
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const int i = tid + (m0 + m) * NT;
        const T* src = i < COUNT ? src_of(i) : nullptr;
        r[m] = src != nullptr ? *src : zero_of<T>();
      }
#pragma unroll
      for (int m = 0; m < K; ++m)
        if (tid + (m0 + m) * NT < COUNT) *dst_of(tid + (m0 + m) * NT) = r[m];
    }
  }
}

// Shared memory of a state-pass block, in floats: dt_w rows (fp32 only),
// then per warp kStages stages of its chunk (dt_low rows as the mma reads
// them, B rows and u 16 x 8 in T), (dt, dt u) per (t, c) and (alpha, beta)
// per (c, n).  kWarps chunks at once, at least 8 N threads for the chain.
// Above RMAX 64 one stage a warp (the next chunks' rows are not copied in
// ahead): two would take 340 KB for fp32 at RMAX 256, N 32.
template <int NMAX, int RMAX, bool kMma>
struct StatePlan {
  static constexpr int kWarps = NMAX / 4 > 4 ? NMAX / 4 : 4;
  static constexpr int kStages = RMAX <= 64 ? 2 : 1;
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
  static constexpr int kSt = kStage + kWarps * kStages * kStageW;
  static constexpr int kAb = kSt + kWarps * kStW;
  static constexpr int kBytes = (kAb + kWarps * kAbW) * 4;
};

// Warps an SM the compiler plans registers for: 24 up to RMAX 64 (80
// registers a thread; without the bound the compiler takes ~150 and the
// pass runs ~20% slower); above it dt_w's RMAX / 8 fragments a thread
// need more, so 12 at 128 and 8 at 256 (at least one block).
constexpr int states_min_blocks(int warps, int rmax) {
  const int per_sm = rmax <= 64 ? 24 : rmax <= 128 ? 12 : 8;
  return per_sm / warps > 0 ? per_sm / warps : 1;
}

// grid (ceil(dim / 8), batch), StatePlan::kWarps warps: the chunks from
// the first, kWarps at once, a warp a chunk; up to RMAX 64 the next kWarps
// chunks' rows are copied in while these are walked.
// kSplit: the tile of NMAX states at NMAX blockIdx.z, h0 where not null,
// dt written by tile 0 alone; kDelta: dt_low is the full delta (batch, L,
// dim), dt_w unused.
template <typename T, int NMAX, int RMAX, bool kH0, bool kSplit = false,
          bool kDelta = false>
__global__ void __launch_bounds__(
    StatePlan<NMAX, RMAX, true>::kWarps * 32,
    states_min_blocks(StatePlan<NMAX, RMAX, true>::kWarps, RMAX))
scan_fwd_train_states_kernel(const T* __restrict__ u,
                             const T* __restrict__ dt_low,
                             const T* __restrict__ dt_w,
                             const float* __restrict__ A,
                             const T* __restrict__ Bm,
                             const float* __restrict__ bias,
                             float* __restrict__ bnd,
                             float* __restrict__ dt_out, int L, int dim,
                             int N, int R, int use_softplus, int vec,
                             const float* __restrict__ h0) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  using P = StatePlan<NMAX, RMAX, kMma>;
  constexpr int NPL = NMAX / kLanes;
  constexpr int nw = P::kWarps, kNT = nw * 32;
  constexpr bool kPipe = P::kStages == 2;  // next chunks copied in ahead
  constexpr int LDF = RMAX + 4, LDB = RMAX + 8, kPitch = kMma ? LDB : LDF;
  static_assert(RMAX % 16 == 0 && NPL >= 2, "plan");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int d0 = blockIdx.x * kWarpCh, b = blockIdx.y;
  const int nc = (L + kChunk - 1) / kChunk;
  const size_t row0 = (size_t)b * L;
  float* s_w = smem + P::kW;
  float* stage0 = smem + P::kStage + warp * P::kStages * P::kStageW;
  float2* s_st = reinterpret_cast<float2*>(smem + P::kSt + warp * P::kStW);
  const float2* s_ab_all = reinterpret_cast<const float2*>(smem + P::kAb);
  float2* s_ab = reinterpret_cast<float2*>(smem + P::kAb + warp * P::kAbW);
  // kSplit: the tile's first state and its count
  const int n_off = kSplit ? blockIdx.z * NMAX : 0;
  const int Nt = kSplit ? min(NMAX, N - n_off) : N;

  // chunk c's dt_low (kDelta: delta [16][8], as u), B and u into the warp's
  // stage buffer
  auto stage_chunk = [&](int c, float* buf) {
    const int t0 = c * kChunk, nt = min(kChunk, L - t0);
    T* dtl = reinterpret_cast<T*>(buf);
    T* braw = reinterpret_cast<T*>(buf + P::kDtlW);
    T* uraw = reinterpret_cast<T*>(buf + P::kDtlW + P::kBRawW);
    if constexpr (kDelta) {
      stage<T, kChunk * kWarpCh, 32>(
          vec, lane,
          [&](int i) -> const T* {
            const int tt = i / kWarpCh, d = d0 + i % kWarpCh;
            return tt < nt && d < dim ? dt_low + (row0 + t0 + tt) * dim + d
                                      : nullptr;
          },
          [&](int i) { return dtl + i; });
    } else {
      stage<T, kChunk * RMAX, 32>(
          vec, lane,
          [&](int i) -> const T* {
            const int tt = i / RMAX, k = i % RMAX;
            return tt < nt && k < R ? dt_low + (row0 + t0 + tt) * R + k
                                    : nullptr;
          },
          [&](int i) { return dtl + i / RMAX * kPitch + i % RMAX; });
    }
    stage<T, kChunk * NMAX, 32>(
        vec, lane,
        [&](int i) -> const T* {
          const int tt = i / NMAX, n = i % NMAX;
          return tt < nt && n < Nt ? Bm + (row0 + t0 + tt) * N + n_off + n
                                   : nullptr;
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
  if constexpr (!kDelta) load_w_frags<T, RMAX>(dt_w, d0 + g, dim, R, q, bfr);
  if constexpr (!kMma && !kDelta) {
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
    a2[j] = (d0 + g < dim && n < Nt)
                ? A[(size_t)(d0 + g) * N + n_off + n] * kLog2e
                : 0.f;
  }

  // the chain's state, for thread (n, c) = (tid / 8, tid % 8): zero, or
  // with kH0 the seed h0[b, d, n]
  float H = 0.f;
  if constexpr (kH0) {
    const int n = tid / kWarpCh, d = d0 + tid % kWarpCh;
    if (tid < kWarpCh * N && d < dim) H = h0[((size_t)b * dim + d) * N + n];
  } else if constexpr (kSplit) {
    const int n = tid / kWarpCh, d = d0 + tid % kWarpCh;
    if (h0 != nullptr && tid < kWarpCh * Nt && d < dim)
      H = h0[((size_t)b * dim + d) * N + n_off + n];
  }
  if (kPipe && vec) {
    if (warp < nc) stage_chunk(warp, stage0);
    cp_async_commit();
  }
  int it = 0;
  for (int lo = 0; lo < nc; lo += nw, ++it) {
    const int hi = min(nc, lo + nw);
    const int c = lo + warp;
    float* buf = stage0 + (kPipe ? (it & 1) * P::kStageW : 0);
    __syncthreads();  // the previous chain's reads are done; s_w is ready
    if (kPipe && vec) {
      if (hi + warp < nc)
        stage_chunk(hi + warp, stage0 + ((it + 1) & 1) * P::kStageW);
      cp_async_commit();
      cp_async_wait<1>();
    } else if (c < hi) {
      stage_chunk(c, buf);
      if (!kPipe && vec) {
        cp_async_commit();
        cp_async_wait<0>();
      }
    }
    __syncwarp();
    if (c < hi) {
      const int t0 = c * kChunk, nt = min(kChunk, L - t0);
      const T* braw = reinterpret_cast<const T*>(buf + P::kDtlW);
      const T* uraw = reinterpret_cast<const T*>(buf + P::kDtlW + P::kBRawW);
      float raw[4], dts[4];
      if constexpr (kDelta) {
        const T* draw = reinterpret_cast<const T*>(buf);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          raw[e] = to_f32(draw[(g + 8 * (e >> 1)) * kWarpCh + 2 * q + (e & 1)]);
      } else {
        expand_dt<kMma, RMAX>(buf, s_w + 2 * q * LDF, bfr, g, q, R, raw);
      }
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
      // dt for the main pass, in o's place (channel pairs 2q, 2q + 1);
      // kSplit: tile 0's
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int tt = g + 8 * i, d = d0 + 2 * q;
        if (tt >= nt || d >= dim || (kSplit && blockIdx.z != 0)) continue;
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
    if (tid < kWarpCh * Nt) {
      const int n = tid / kWarpCh, cc = tid % kWarpCh, d = d0 + cc;
      float* dst = bnd + ((size_t)b * nc * N + n_off + n) * dim + d;
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
// threads an SM at least (the kernel takes 64 registers: 8 fit).  kSplit:
// grid y ceil(n_chunks / kGroup) x tiles, the tile of NMAX states at NMAX
// (y / the groups), each (t, d)'s sum of the tile's C h into part_out[tile]
template <typename T, int NMAX, bool kSplit = false>
__global__ void __launch_bounds__(kThreads, 6)
scan_fwd_train_kernel(const T* __restrict__ u, const float* __restrict__ A,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ Dv, const T* __restrict__ z,
                      T* __restrict__ out, float* __restrict__ o,
                      const float* __restrict__ bnd, int L, int dim, int N,
                      float* __restrict__ part_out) {
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
  const int groups = (nc + kGroup - 1) / kGroup;
  const int tile = kSplit ? blockIdx.y / groups : 0;
  const int n_off = tile * NMAX, Nt = kSplit ? min(NMAX, N - n_off) : N;
  const int c_begin = (kSplit ? blockIdx.y % groups : blockIdx.y) * kGroup;
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
    const bool ok = db < dim && n < Nt;
    a2[j] = ok ? A[(size_t)db * N + n_off + n] * kLog2e : 0.f;
    h[j] = ok ? bnd[(((size_t)b * nc + c_begin) * N + n_off + n) * dim + db]
              : 0.f;
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
    const T* pb = Bm + (row0 + c0) * N + n_off;
    const T* pc = Cm + (row0 + c0) * N + n_off;
#pragma unroll
    for (int j = 0; j < NBC; ++j) {
      const int i = tid + j * kThreads, tt = i / NMAX, n = i % NMAX;
      const bool ok = tt < n_t && n < Nt;
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
      if constexpr (kSplit) {
        // one tile: o and y; more: the tile's sum, for the combine
        const float s = ((part[0] + part[1]) + part[2]) + part[3];
        if (active && tt < nt) {
          const size_t idx = (row0 + t0 + tt) * dim + da;
          if (gridDim.y == groups) {
            o[idx] = s + skip[i];
            out[idx] = from_f32<T>((s + skip[i]) * gate[i]);
          } else {
            part_out[(size_t)tile * gridDim.z * L * dim + idx] = s;
          }
        }
      } else {
        const float s =
            (((part[0] + part[1]) + part[2]) + part[3]) + skip[i];
        if (active && tt < nt) {
          const size_t idx = (row0 + t0 + tt) * dim + da;
          o[idx] = s;
          out[idx] = from_f32<T>(s * gate[i]);
        }
      }
    }
  }
}

// kSplit: o = the tiles' sums of C h (added in tile order) + D u, y = o
// silu(z), the arithmetic of phase C
template <typename T>
__global__ void __launch_bounds__(256)
scan_fwd_train_combine_kernel(const float* __restrict__ part, int tiles,
                    const T* __restrict__ u, const float* __restrict__ Dv,
                    const T* __restrict__ z, T* __restrict__ out,
                    float* __restrict__ o, size_t total, int dim) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    float s = part[i];
    for (int k = 1; k < tiles; ++k) s += part[k * total + i];
    s += to_f32(u[i]) * (Dv != nullptr ? Dv[i % dim] : 0.f);
    o[i] = s;
    out[i] = from_f32<T>(s * (z != nullptr ? silu(to_f32(z[i])) : 1.f));
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

// p: u, dt_low (kDelta: delta), dt_w, A, B, C, D, z, bias, out, o, bnd, h0,
// part (kSplit's workspace)
template <typename T, int NMAX, int RMAX, bool kH0, bool kSplit = false,
          bool kDelta = false>
int launch(const void* const* p, int batch, int L, int dim, int N, int R,
           int use_softplus, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  using SP = StatePlan<NMAX, RMAX, kMma>;
  auto states_kernel =
      scan_fwd_train_states_kernel<T, NMAX, RMAX, kH0, kSplit, kDelta>;
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
  constexpr int kPer = 16 / (int)sizeof(T);
  // above RMAX 64, dt_low rows of whole 16-byte runs copy as vectors too;
  // kDelta's rows are u's; kSplit's B rows are whole where N's are
  bool vec = (kDelta || R == RMAX || (RMAX > 64 && R % kPer == 0)) &&
             (kSplit ? N % kPer == 0 : N == NMAX) && dim % kPer == 0;
  for (int i : {0, 1, 4, 10}) vec = vec && a16(p[i]);
  const int tiles = kSplit ? (N + NMAX - 1) / NMAX : 1;
  dim3 sgrid((dim + kWarpCh - 1) / kWarpCh, batch, tiles);
  states_kernel<<<sgrid, SP::kWarps * 32, SP::kBytes, stream>>>(
      u, static_cast<const T*>(p[1]), static_cast<const T*>(p[2]), A, Bm,
      static_cast<const float*>(p[8]), bnd, o, L, dim, N, R, use_softplus,
      vec, static_cast<const float*>(p[12]));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((dim + kChannels - 1) / kChannels,
            (nc + kGroup - 1) / kGroup * tiles, batch);
  float* part = static_cast<float*>(const_cast<void*>(p[13]));
  T* y = static_cast<T*>(const_cast<void*>(p[9]));
  const float* Dv = static_cast<const float*>(p[6]);
  const T* z = static_cast<const T*>(p[7]);
  scan_fwd_train_kernel<T, NMAX, kSplit>
      <<<grid, kThreads, MainPlan<NMAX>::kBytes, stream>>>(
          u, A, Bm, static_cast<const T*>(p[5]), Dv, z, y, o, bnd, L, dim, N,
          part);
  err = cudaGetLastError();
  if (!kSplit || err != cudaSuccess || tiles == 1) return err;
  const size_t total = (size_t)batch * L * dim, blocks = (total + 255) / 256;
  const unsigned cgrid = blocks < 1056 ? (unsigned)blocks : 1056u;
  scan_fwd_train_combine_kernel<T><<<cgrid, 256, 0, stream>>>(
      part, tiles, u, Dv, z, y, o, total, dim);
  return cudaGetLastError();
}

template <typename T, int NMAX, bool kH0>
int dispatch_r(const void* const* p, int batch, int L, int dim, int N, int R,
               int sp, cudaStream_t s) {
  if (R <= 16) return launch<T, NMAX, 16, kH0>(p, batch, L, dim, N, R, sp, s);
  if (R <= 32) return launch<T, NMAX, 32, kH0>(p, batch, L, dim, N, R, sp, s);
  if (R <= 64) return launch<T, NMAX, 64, kH0>(p, batch, L, dim, N, R, sp, s);
  // above 64, N <= 8 runs on the N-16 plan (its padded states are zero)
  if constexpr (NMAX < 16) {
    return dispatch_r<T, 16, kH0>(p, batch, L, dim, N, R, sp, s);
  } else {
    if (R <= 128)
      return launch<T, NMAX, 128, kH0>(p, batch, L, dim, N, R, sp, s);
    if (R <= 256)
      return launch<T, NMAX, 256, kH0>(p, batch, L, dim, N, R, sp, s);
    return cudaErrorInvalidValue;
  }
}

template <typename T, bool kH0>
int dispatch(const void* const* p, int batch, int L, int dim, int N, int R,
             int sp, cudaStream_t s) {
  if (N <= 8) return dispatch_r<T, 8, kH0>(p, batch, L, dim, N, R, sp, s);
  if (N <= 16) return dispatch_r<T, 16, kH0>(p, batch, L, dim, N, R, sp, s);
  if (N <= 32) return dispatch_r<T, 32, kH0>(p, batch, L, dim, N, R, sp, s);
  return cudaErrorInvalidValue;
}

template <bool kH0>
int run(const void* const* p, int batch, int L, int dim, int n_state,
        int dt_rank, int dtype, int use_softplus, void* stream) {
  if (batch < 1 || L < 1 || dim < 1 || n_state < 1 || dt_rank < 1 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch<float, kH0>(p, batch, L, dim, n_state,
                                           dt_rank, use_softplus, s)
                    : dispatch<__nv_bfloat16, kH0>(p, batch, L, dim, n_state,
                                                   dt_rank, use_softplus, s);
}

// kSplit (N 33 to 256): 32-state tiles, RMAX 64 or 256 (the k-tiles past r
// are zero: RMAX 64 serves every r <= 64); h0 where not null
template <typename T>
int dispatch_split(const void* const* p, int batch, int L, int dim, int N,
                   int R, int sp, cudaStream_t s) {
  if (R <= 64)
    return launch<T, 32, 64, false, true>(p, batch, L, dim, N, R, sp, s);
  if (R <= 256)
    return launch<T, 32, 256, false, true>(p, batch, L, dim, N, R, sp, s);
  return cudaErrorInvalidValue;
}

// kDelta: the N-16 plan up to 16 states (N <= 8 on it too), the split one
// (32-state tiles, one at N <= 32) above
template <typename T>
int dispatch_delta(const void* const* p, int batch, int L, int dim, int N,
                   int sp, cudaStream_t s) {
  constexpr bool f = false, t = true;
  if (N <= 16) return launch<T, 16, 16, f, f, t>(p, batch, L, dim, N, 1, sp, s);
  return launch<T, 32, 16, f, t, t>(p, batch, L, dim, N, 1, sp, s);
}

bool shape_ok(int batch, int L, int dim, int N, int dtype) {
  return batch >= 1 && L >= 1 && dim >= 1 && N >= 1 && N <= 256 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D, z and bias may be null.  Launches
// the state pass (which writes bnd, and dt into o), then the main pass
// (which reads them and writes y and o), on `stream`.  Returns the CUDA
// error of the launches (0 on success), or cudaErrorInvalidValue for
// shapes the kernels do not take (1 <= N <= 32, 1 <= r <= 256).
extern "C" int dimsum_selective_scan_fwd_train(
    const void* u, const void* dt_low, const void* dt_w, const void* A,
    const void* B, const void* C, const void* D, const void* z,
    const void* bias, void* out, void* o, void* bnd, int batch, int L,
    int dim, int n_state, int dt_rank, int dtype, int use_softplus,
    void* stream) {
  const void* p[14] = {u,    dt_low, dt_w, A, B,   C,       D,
                       z,    bias,   out,  o, bnd, nullptr, nullptr};
  return run<false>(p, batch, L, dim, n_state, dt_rank, dtype, use_softplus,
                    stream);
}

// The h0 entry: dimsum_selective_scan_fwd_train's arguments and results,
// the state before step 0 seeded from h0 (batch, dim, N) fp32, which bnd's
// first chunk then holds.
extern "C" int dimsum_selective_scan_fwd_train_h0(
    const void* u, const void* dt_low, const void* dt_w, const void* A,
    const void* B, const void* C, const void* D, const void* z,
    const void* bias, void* out, void* o, void* bnd, const void* h0,
    int batch, int L, int dim, int n_state, int dt_rank, int dtype,
    int use_softplus, void* stream) {
  const void* p[14] = {u, dt_low, dt_w, A,   B,   C,  D,
                       z, bias,   out,  o,   bnd, h0, nullptr};
  return run<true>(p, batch, L, dim, n_state, dt_rank, dtype, use_softplus,
                   stream);
}

// N from 1 to 256 (the first entry's instantiations take N <= 32): the h0
// entry's arguments (h0 may be null) and part, a workspace of ceil(N / 32) x
// batch x L x dim fp32 (not used at one tile).
extern "C" int dimsum_selective_scan_fwd_train_split(
    const void* u, const void* dt_low, const void* dt_w, const void* A,
    const void* B, const void* C, const void* D, const void* z,
    const void* bias, void* out, void* o, void* bnd, const void* h0,
    void* part, int batch, int L, int dim, int n_state, int dt_rank,
    int dtype, int use_softplus, void* stream) {
  if (!shape_ok(batch, L, dim, n_state, dtype) || dt_rank < 1)
    return cudaErrorInvalidValue;
  const void* p[14] = {u, dt_low, dt_w, A, B, C, D, z, bias, out, o, bnd, h0,
                       part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? dispatch_split<float>(p, batch, L, dim, n_state, dt_rank,
                                     use_softplus, s)
             : dispatch_split<__nv_bfloat16>(p, batch, L, dim, n_state,
                                             dt_rank, use_softplus, s);
}

// The full-delta entry: delta (batch, L, dim) in u's type in place of
// dt_low and dt_w, 1 <= N <= 256, part as the split entry's.
extern "C" int dimsum_selective_scan_fwd_train_delta(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* D, const void* z, const void* bias, void* out,
    void* o, void* bnd, void* part, int batch, int L, int dim, int n_state,
    int dtype, int use_softplus, void* stream) {
  if (!shape_ok(batch, L, dim, n_state, dtype)) return cudaErrorInvalidValue;
  const void* p[14] = {u, delta, nullptr, A,   B,       C, D,
                       z, bias,  out,     o,   bnd,     nullptr, part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? dispatch_delta<float>(p, batch, L, dim, n_state,
                                            use_softplus, s)
                    : dispatch_delta<__nv_bfloat16>(p, batch, L, dim, n_state,
                                                    use_softplus, s);
}
