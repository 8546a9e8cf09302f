// Fused selective-scan (Mamba S6) forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dimsum_tpu/ops/selective_scan.py::_scan_body
// (launched from _selective_scan_pallas_fwd_impl) on its inference route:
// dt_rank > 0 (dt = dt_low . dt_w expanded in the kernel), delta bias,
// softplus, D skip, silu(z) gate, one B/C per timestep (no groups), forward
// time, zero initial state (entry dimsum_selective_scan_fwd).  The second
// entry, dimsum_selective_scan_fwd_state, replaces _scan_kernel_with_state
// (the same file) and _scan_body's has_h0 case, the two local passes of the
// sequence-parallel scan (selective_scan_sp.py): a full delta in place of
// dt_low . dt_w, the state seeded from h0, and the last state stored.  Per
// batch b, channel d and state n:
//
//   dt_t  = softplus(<dt_low_t, dt_w[:, d]> + bias_d)
//   h_t   = exp(dt_t * A_dn) * h_{t-1} + dt_t * u_t * B_tn
//   y_t   = (sum_n C_tn * h_tn + D_d * u_t) * silu(z_t)
//
// u, z, out: (batch, L, dim); dt_low: (batch, L, r); B, C: (batch, L, N);
// dt_w: (r, dim), all in one type T (float or bf16).  A: (dim, N), D and
// bias: (dim,), fp32.  All math, the dt expansion and the state are fp32;
// out is T.  The second entry reads a full delta (batch, L, dim) in T for
// dt_low . dt_w, and h0 and the last state (batch, dim, N) in fp32.
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
// variants the route refuses (grouped B/C, N > 32).
//
// Ranks.  The Pallas kernel takes any dt_rank (its (1, chunk, r) and (r,
// d_block) blocks, selective_scan.py:687-693); this kernel takes 1 <= r <=
// 256 (d_model up to 4096) through RMAX 16, 32, 64, 128 and 256, the
// smallest that holds r.  Up to 64 the instantiations are those measured in
// PERF.md; above it (DiM-XL/2's linear mixers r 72, mamba-790m 96,
// mamba-1.4b 128, mamba-2.8b 160) the same phases run, N <= 8 on the N-16
// plan, with the k-tiles past r skipped, fewer blocks an SM (fwd_min_blocks:
// the RMAX / 8 dt_low values a thread holds, and 64 KB of shared memory at
// 256), and at r 160 the expansion's 2r = 320 flop a (b, t, d) is as long on
// the FP32 pipe (fp32) as the N + 3 transcendentals on the SFU, so
// chip_smoke.py computes the bound of each rank from its own counts.
// RMAX 256 alone would serve every r above 64 (the break skips the same
// k-tiles), but at r 72-128 it takes 9-31% longer than RMAX 128 in this
// kernel and 4-60% in the training pair (fewer blocks an SM; PERF.md), so
// both stay.
//
// The reverse entry, dimsum_selective_scan_fwd_reverse, is _scan_body's
// reverse=True case (selective_scan.py:447, :499-503; the grid's L-chunks
// visited last to first): h_t = exp(dt_t A) h_{t+1} + dt_t u_t B_t, the
// state zero past L - 1, which is flip_L(scan(flip_L(u, dt_low, B, C, z)))
// with no flip made.  It is the first entry's kernel with a fourth
// compile-time switch, kRev: the block walks the same 16-step chunks from
// the last to the first, and phase B steps each chunk from t = 15 down to
// 0.  Phases A and C do the same per-(t, d) work at the same addresses.  A
// ragged L makes the last chunk ragged, and it is the first one walked: its
// steps past L run first, with dt = 0, so the state stays 0 until the step
// at L - 1.  Each step's arithmetic and each output's sum of the 4 lanes'
// partials are those of the first entry on the flipped inputs.  Its bound
// and bytes are the first entry's.  As in JAX (selective_scan.py:592-593),
// reverse takes no h0 and gives no last state.
//
// The state entry is the same kernel with three compile-time switches, so
// the first entry's instantiations compile as before.  kDelta: phase A
// loads the chunk's delta rows along d (as u) and skips the dt_w staging
// and the mma.sync expansion; the bias and softplus stay in fp32.  kH0:
// each lane seeds its NPL states of its channel from h0 in place of 0.
// kLast: after the chunk walk each lane stores its NPL states (padded
// states, n >= N, are not stored).  A ragged last chunk runs with dt = 0
// past L, so the state stored is the state at step L - 1.  Its bound is
// the first entry's (N + 3 transcendentals a (b, t, d), the SFU) with the
// delta, h0 and last state added to the bytes.
//
// States past 32 and grouped B/C (the reference's ngroups mode, _scan_body's
// grouped case, selective_scan.py:444, :478, :663-669) take a fifth
// compile-time switch, kSplit, off in every instantiation above.  The N axis
// is separable: each state's recurrence is its own, and y is a sum over n.
// So a block takes one tile of NMAX (32; 16 for a grouped N <= 16) states,
// n_off = NMAX blockIdx.z .. + NMAX - 1, and runs the phases above on it;
// at one tile it stores y as before, at more it stores the tile's fp32 sum
// of C h (no skip, no gate) in a workspace part[tile], and a second
// kernel, scan_fwd_combine_kernel, adds the tiles in order, the skip and the
// gate.  Each tile expands dt for itself (its share of the SFU work is 3 of
// N + 3).
// Grouped B and C are (batch, L, G, N), channel d reading group d / (dim /
// G); G = 1 is the ungrouped layout.  Where a block's 32 channels are in one
// group (dim / G a multiple of 32) the block stages that group's rows as
// above; else each lane of phase B reads its channel's group's B and C from
// global memory.  h0 and the last state are read and written where given
// (runtime checks).  Entries: dimsum_selective_scan_fwd_split (dt_low . dt_w,
// forward or reverse time) and dimsum_selective_scan_fwd_state_split (the
// state entry's arguments), each with G and part.

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
// <= 28 KB up to RMAX 64; 39 KB at 128 and 64 KB at 256 (N 16).
template <int NMAX, int RMAX>
struct Plan {
  static constexpr int kW = 0;                            // [RMAX][32]
  static constexpr int kDtl = kW + RMAX * kChannels;      // [16][RMAX]
  static constexpr int kB = kDtl + kChunk * RMAX;         // [16][NMAX]
  static constexpr int kC = kB + kChunk * NMAX;           // [16][NMAX]
  static constexpr int kDd = kC + kChunk * NMAX;          // [16][32] float2
  static constexpr int kY = kDd + 2 * kChunk * kChannels; // [16][128]
  static constexpr int kBytes = (kY + kChunk * kThreads) * 4;
};

// Blocks an SM the compiler plans registers for.  Up to RMAX 64, 6 blocks
// of 128 threads (80 registers a thread): the 768 blocks of the DiM-L/2
// mixer (24 x 1024 / 32) in one wave on 132 SMs.  RMAX 128 and 256 (the
// ranks above 64: mamba-790m to mamba-2.8b and d_model 4096) hold RMAX / 8
// dt_low values a thread in registers and more shared memory, so 4 and 3
// (5 and 3 fit in shared memory at N 16).
constexpr int fwd_min_blocks(int rmax) {
  return rmax <= 64 ? 6 : rmax <= 128 ? 4 : 3;
}

// kDelta: dt_low is the full delta (batch, L, dim) and dt_w is unused;
// kH0: h0 (batch, dim, N) seeds the state; kLast: last (batch, dim, N)
// takes the state after step L - 1.  h0 and last are unused without them.
// kRev: reverse time (chunks and steps last to first; the first entry's
// arguments only).  kSplit: the tile of NMAX states at NMAX blockIdx.z, B
// and C in G groups, h0 and last where not null, and with more than one
// tile the tile's sums into part (see the head of the file).
template <typename T, int NMAX, int RMAX, bool kDelta = false,
          bool kH0 = false, bool kLast = false, bool kRev = false,
          bool kSplit = false>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks(RMAX))
scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ dt_low,
                const T* __restrict__ dt_w, const float* __restrict__ A,
                const T* __restrict__ Bm, const T* __restrict__ Cm,
                const float* __restrict__ Dv, const T* __restrict__ z,
                const float* __restrict__ bias, T* __restrict__ out, int L,
                int dim, int N, int R, int use_softplus,
                const float* __restrict__ h0, float* __restrict__ last, int G,
                float* __restrict__ part_out) {
  using P = Plan<NMAX, RMAX>;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NPL = NMAX / kLanes;  // states a lane
  constexpr int LDB = RMAX + 8;       // bf16 operand rows
  static_assert(RMAX % 16 == 0 && NPL >= 2, "plan");
  static_assert(!(kRev && (kDelta || kH0 || kLast)), "reverse: first entry");
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
  // kSplit: the tile's first state and its count; gw channels a group, the
  // block's group grp, staged when all the block's channels are in it
  const int n_off = kSplit ? blockIdx.z * NMAX : 0;
  const int Nt = kSplit ? min(NMAX, N - n_off) : N;
  const int gw = kSplit ? dim / G : dim;
  const int grp = kSplit ? d0 / gw : 0;
  const bool staged = !kSplit || G == 1 || gw % kChannels == 0;

  if constexpr (!kDelta) {
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
  }
  // this lane's states of channel db in h0 and last
  const size_t state0 = ((size_t)b * dim + db) * N + n_off + kb * NPL;
  float a2[NPL], h[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int n = kb * NPL + j;
    const bool real = db < dim && n < Nt;
    a2[j] = real ? A[(size_t)db * N + n_off + n] * kLog2e : 0.f;
    if constexpr (kH0) {
      h[j] = real ? h0[state0 + j] : 0.f;
    } else if constexpr (kSplit) {
      h[j] = (real && h0 != nullptr) ? h0[state0 + j] : 0.f;
    } else {
      h[j] = 0.f;
    }
  }
  const float skip_w = (Dv != nullptr && active) ? Dv[da] : 0.f;
  const float dbias = (bias != nullptr && active) ? bias[da] : 0.f;
  const size_t row0 = (size_t)b * L;

  // every global load of the chunk at c0 into registers, all issued before
  // the first is stored (one memory latency a chunk)
  constexpr int NDT = kChunk * RMAX / kThreads;
  constexpr int NBC = kChunk * NMAX / kThreads;
  T r_dt[NDT], r_b[NBC], r_c[NBC], r_u[kSteps], r_z[kSteps];
  T r_d[kSteps];  // kDelta: the delta rows of channel da
  const T zero = from_f32<T>(0.f);
  auto load_chunk = [&](int c0) {
    const int n_t = min(kChunk, L - c0);
    if constexpr (!kDelta) {
      const T* pd = dt_low + (row0 + c0) * R;
#pragma unroll
      for (int j = 0; j < NDT; ++j) {
        const int i = tid + j * kThreads, tt = i / RMAX, k = i % RMAX;
        r_dt[j] = (tt < n_t && k < R) ? pd[tt * R + k] : zero;
      }
    }
    if constexpr (kSplit) {
      // the block's group's rows, G N apart, from state n_off (unstaged:
      // phase B reads its own)
      const size_t ld = (size_t)G * N, at = (row0 + c0) * ld + grp * N + n_off;
#pragma unroll
      for (int j = 0; j < NBC; ++j) {
        const int i = tid + j * kThreads, tt = i / NMAX, n = i % NMAX;
        const bool ok = staged && tt < n_t && n < Nt;
        r_b[j] = ok ? Bm[at + tt * ld + n] : zero;
        r_c[j] = ok ? Cm[at + tt * ld + n] : zero;
      }
    } else {
      const T* pb = Bm + (row0 + c0) * N;
      const T* pc = Cm + (row0 + c0) * N;
#pragma unroll
      for (int j = 0; j < NBC; ++j) {
        const int i = tid + j * kThreads, tt = i / NMAX, n = i % NMAX;
        const bool ok = tt < n_t && n < N;
        r_b[j] = ok ? pb[tt * N + n] : zero;
        r_c[j] = ok ? pc[tt * N + n] : zero;
      }
    }
    const size_t base = (row0 + c0) * dim + da;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int tt = tg * kSteps + i;
      const bool ok = active && tt < n_t;
      r_u[i] = ok ? u[base + tt * dim] : zero;
      r_z[i] = (ok && z != nullptr) ? z[base + tt * dim] : zero;
      if constexpr (kDelta) r_d[i] = ok ? dt_low[base + tt * dim] : zero;
    }
  };

  // forward: chunks first to last; kRev: last to first
  const int t_last = (L - 1) / kChunk * kChunk;
  for (int t0 = kRev ? t_last : 0; kRev ? t0 >= 0 : t0 < L;
       t0 += kRev ? -kChunk : kChunk) {
    const int nt = min(kChunk, L - t0);
    load_chunk(t0);
    // the chunk's shared rows in fp32 (bf16: the mma operand as it is)
    if constexpr (!kDelta) {
#pragma unroll
      for (int j = 0; j < NDT; ++j) {
        const int i = tid + j * kThreads, tt = i / RMAX, k = i % RMAX;
        if constexpr (kMma) {
          dtl_bf[tt * LDB + k] = r_dt[j];
        } else {
          s_dtl[i] = r_dt[j];
        }
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

    // phase A: dt_low . dt_w (or the delta as loaded) for the thread's
    // kSteps timesteps of channel ca
    float acc[kSteps];
    if constexpr (kDelta) {
#pragma unroll
      for (int i = 0; i < kSteps; ++i) acc[i] = to_f32(r_d[i]);
    } else if constexpr (kMma) {
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
        // above RMAX 64 the k-tiles past r hold zeros: skipped
        if constexpr (RMAX > 64) {
          if (k0 >= R) break;
        }
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
        if constexpr (RMAX > 64) {
          if (k >= R) break;
        }
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
    // step; the unrolled chunk lets later steps' exp2 run ahead.  kRev
    // steps from t = 15 down to 0 (past L first, with dt = 0)
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int tt = kRev ? kChunk - 1 - i : i;
      const float2 dd = s_dd[tt * kChannels + cb];
      float bv[NPL], cv[NPL];
      if (staged) {
        lds<NPL>(s_B + tt * NMAX + kb * NPL, bv);
        lds<NPL>(s_C + tt * NMAX + kb * NPL, cv);
      } else {
        // kSplit, the block's channels in several groups: channel db's own
        // group's rows (past L the last row: dt is 0 there)
        const size_t at =
            ((row0 + min(t0 + tt, L - 1)) * G + db / gw) * N + n_off +
            kb * NPL;
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          const bool ok = db < dim && kb * NPL + j < Nt;
          bv[j] = ok ? to_f32(Bm[at + j]) : 0.f;
          cv[j] = ok ? to_f32(Cm[at + j]) : 0.f;
        }
      }
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
      if constexpr (kSplit) {
        // one tile: y; more: the tile's sum of C h, for the combine
        const size_t idx = (row0 + t0 + tt) * dim + da;
        if (active && tt < nt) {
          if (gridDim.z == 1) {
            out[idx] = from_f32<T>((s + skip[i]) * gate[i]);
          } else {
            part_out[blockIdx.z * (size_t)gridDim.x * L * dim + idx] = s;
          }
        }
      } else {
        if (active && tt < nt)
          out[(row0 + t0) * dim + da + tt * dim] =
              from_f32<T>((s + skip[i]) * gate[i]);
      }
    }
  }
  if constexpr (kLast) {
#pragma unroll
    for (int j = 0; j < NPL; ++j)
      if (db < dim && kb * NPL + j < N) last[state0 + j] = h[j];
  } else if constexpr (kSplit) {
    if (last != nullptr) {
#pragma unroll
      for (int j = 0; j < NPL; ++j)
        if (db < dim && kb * NPL + j < Nt) last[state0 + j] = h[j];
    }
  }
}

// kSplit at more than one tile: out = (the tiles' sums of C h, added in
// tile order, + D u) silu(z), the arithmetic of phase C; with o (the
// training forward's) also o = the sum + D u
template <typename T>
__global__ void __launch_bounds__(256)
scan_fwd_combine_kernel(const float* __restrict__ part, int tiles,
                    const T* __restrict__ u, const float* __restrict__ Dv,
                    const T* __restrict__ z, T* __restrict__ out,
                    float* __restrict__ o, size_t total, int dim) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    float s = part[i];
    for (int k = 1; k < tiles; ++k) s += part[k * total + i];
    s += to_f32(u[i]) * (Dv != nullptr ? Dv[i % dim] : 0.f);
    if (o != nullptr) o[i] = s;
    out[i] = from_f32<T>(s * (z != nullptr ? silu(to_f32(z[i])) : 1.f));
  }
}

template <typename T>
cudaError_t combine(const float* part, int tiles, const void* u,
                    const void* D, const void* z, void* out, float* o,
                    size_t total, int dim, cudaStream_t stream) {
  const size_t blocks = (total + 255) / 256;
  const unsigned grid = blocks < 1056 ? (unsigned)blocks : 1056u;
  scan_fwd_combine_kernel<T><<<grid, 256, 0, stream>>>(
      part, tiles, static_cast<const T*>(u), static_cast<const float*>(D),
      static_cast<const T*>(z), static_cast<T*>(out), o, total, dim);
  return cudaGetLastError();
}

template <typename T, int NMAX, int RMAX, bool kDelta = false,
          bool kH0 = false, bool kLast = false, bool kRev = false,
          bool kSplit = false>
cudaError_t launch(const void* u, const void* dt_low, const void* dt_w,
                   const void* A, const void* B, const void* C, const void* D,
                   const void* z, const void* bias, void* out, int batch,
                   int L, int dim, int N, int R, int use_softplus,
                   cudaStream_t stream, const void* h0 = nullptr,
                   void* last = nullptr, int G = 1, void* part = nullptr) {
  constexpr int kBytes = Plan<NMAX, RMAX>::kBytes;
  if constexpr (kBytes > 48 * 1024) {  // RMAX 256: set once
    static bool done = false;
    if (!done) {
      const cudaError_t err = cudaFuncSetAttribute(
          scan_fwd_kernel<T, NMAX, RMAX, kDelta, kH0, kLast, kRev, kSplit>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
      if (err != cudaSuccess) return err;
      done = true;
    }
  }
  const int tiles = kSplit ? (N + NMAX - 1) / NMAX : 1;
  dim3 grid(batch, (dim + kChannels - 1) / kChannels, tiles);
  scan_fwd_kernel<T, NMAX, RMAX, kDelta, kH0, kLast, kRev, kSplit>
      <<<grid, kThreads, kBytes, stream>>>(
          static_cast<const T*>(u), static_cast<const T*>(dt_low),
          static_cast<const T*>(dt_w), static_cast<const float*>(A),
          static_cast<const T*>(B), static_cast<const T*>(C),
          static_cast<const float*>(D), static_cast<const T*>(z),
          static_cast<const float*>(bias), static_cast<T*>(out), L, dim, N,
          R, use_softplus, static_cast<const float*>(h0),
          static_cast<float*>(last), G, static_cast<float*>(part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  return combine<T>(static_cast<const float*>(part), tiles, u, D, z, out,
                    nullptr, (size_t)batch * L * dim, dim, stream);
}

#define SCAN_ARGS u, dt_low, dt_w, A, B, C, D, z, bias, out, batch, L, dim, \
                  N, R, use_softplus, s
#define SCAN_PARAMS const void *u, const void *dt_low, const void *dt_w,   \
    const void *A, const void *B, const void *C, const void *D,             \
    const void *z, const void *bias, void *out, int batch, int L, int dim,  \
    int N, int R, int use_softplus, cudaStream_t s

template <typename T, int NMAX, bool kRev>
cudaError_t dispatch_r(SCAN_PARAMS) {
  constexpr bool f = false;
  if (R <= 16) return launch<T, NMAX, 16, f, f, f, kRev>(SCAN_ARGS);
  if (R <= 32) return launch<T, NMAX, 32, f, f, f, kRev>(SCAN_ARGS);
  if (R <= 64) return launch<T, NMAX, 64, f, f, f, kRev>(SCAN_ARGS);
  // above 64, N <= 8 runs on the N-16 plan (its padded states are zero),
  // which halves the instantiations' build time for no model of the zoo
  if constexpr (NMAX < 16) {
    return dispatch_r<T, 16, kRev>(SCAN_ARGS);
  } else {
    if (R <= 128) return launch<T, NMAX, 128, f, f, f, kRev>(SCAN_ARGS);
    if (R <= 256) return launch<T, NMAX, 256, f, f, f, kRev>(SCAN_ARGS);
    return cudaErrorInvalidValue;
  }
}

template <typename T, bool kRev = false>
cudaError_t dispatch(SCAN_PARAMS) {
  if (N <= 8) return dispatch_r<T, 8, kRev>(SCAN_ARGS);
  if (N <= 16) return dispatch_r<T, 16, kRev>(SCAN_ARGS);
  if (N <= 32) return dispatch_r<T, 32, kRev>(SCAN_ARGS);
  return cudaErrorInvalidValue;
}

// the state entry: a full delta in dt_low's place, RMAX at its least (the
// dt_w and dt_low rows of shared memory go unused)
#define STATE_ARGS u, delta, nullptr, A, B, C, D, z, bias, out, batch, L, \
                   dim, N, 0, use_softplus, s, h0, last
#define STATE_PARAMS const void *u, const void *delta, const void *A,     \
    const void *B, const void *C, const void *D, const void *z,             \
    const void *bias, const void *h0, void *out, void *last, int batch,     \
    int L, int dim, int N, int use_softplus, cudaStream_t s

template <typename T, int NMAX>
cudaError_t dispatch_state_n(STATE_PARAMS) {
  if (h0 != nullptr && last != nullptr)
    return launch<T, NMAX, 16, true, true, true>(STATE_ARGS);
  if (h0 != nullptr) return launch<T, NMAX, 16, true, true, false>(STATE_ARGS);
  if (last != nullptr)
    return launch<T, NMAX, 16, true, false, true>(STATE_ARGS);
  return launch<T, NMAX, 16, true, false, false>(STATE_ARGS);
}

#define STATE_FWD u, delta, A, B, C, D, z, bias, h0, out, last, batch, L, \
                  dim, N, use_softplus, s

template <typename T>
cudaError_t dispatch_state(STATE_PARAMS) {
  if (N <= 8) return dispatch_state_n<T, 8>(STATE_FWD);
  if (N <= 16) return dispatch_state_n<T, 16>(STATE_FWD);
  if (N <= 32) return dispatch_state_n<T, 32>(STATE_FWD);
  return cudaErrorInvalidValue;
}

// kSplit: 32-state tiles (a grouped N <= 16 on one 16-state tile), RMAX 64
// or 256 (the k-tiles past r are zero: RMAX 64 serves every r <= 64)
template <typename T, bool kRev>
cudaError_t dispatch_split(SCAN_PARAMS, int G, void* part) {
  constexpr bool f = false;
  if (R <= 64)
    return launch<T, 32, 64, f, f, f, kRev, true>(SCAN_ARGS, nullptr, nullptr,
                                                  G, part);
  if (R <= 256)
    return launch<T, 32, 256, f, f, f, kRev, true>(SCAN_ARGS, nullptr,
                                                   nullptr, G, part);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_state_split(STATE_PARAMS, int G, void* part) {
  if (N <= 16 && G > 1)
    return launch<T, 16, 16, true, false, false, false, true>(STATE_ARGS, G,
                                                              part);
  return launch<T, 32, 16, true, false, false, false, true>(STATE_ARGS, G,
                                                            part);
}

// the split entries' shapes: 1 <= N <= 256, G >= 1 dividing dim
bool split_ok(int batch, int L, int dim, int N, int G, int dtype) {
  return batch >= 1 && L >= 1 && dim >= 1 && N >= 1 && N <= 256 && G >= 1 &&
         dim % G == 0 && (dtype == 0 || dtype == 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D, z and bias may be null.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// shapes the kernel does not take (1 <= N <= 32, 1 <= r <= 256).
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

// The reverse entry: dimsum_selective_scan_fwd's arguments and result, the
// recurrence run from t = L - 1 down to 0 (flip_L of the first entry on
// inputs flipped along L).
extern "C" int dimsum_selective_scan_fwd_reverse(
    const void* u, const void* dt_low, const void* dt_w, const void* A,
    const void* B, const void* C, const void* D, const void* z,
    const void* bias, void* out, int batch, int L, int dim, int n_state,
    int dt_rank, int dtype, int use_softplus, void* stream) {
  if (batch < 1 || L < 1 || dim < 1 || n_state < 1 || dt_rank < 1 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int N = n_state, R = dt_rank;
  return dtype == 0 ? dispatch<float, true>(SCAN_ARGS)
                    : dispatch<__nv_bfloat16, true>(SCAN_ARGS);
}

// The state entry: as dimsum_selective_scan_fwd, with delta (batch, L, dim)
// in the dtype of u in place of dt_low and dt_w; h0 (batch, dim, N) fp32
// seeds the state (null: zero) and last (batch, dim, N) fp32 takes the
// state after step L - 1 (null: not stored).  D, z and bias may be null.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// shapes the kernel does not take (1 <= N <= 32).
extern "C" int dimsum_selective_scan_fwd_state(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* D, const void* z, const void* bias,
    const void* h0, void* out, void* last, int batch, int L, int dim,
    int n_state, int dtype, int use_softplus, void* stream) {
  if (batch < 1 || L < 1 || dim < 1 || n_state < 1 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int N = n_state;
  return dtype == 0 ? dispatch_state<float>(STATE_FWD)
                    : dispatch_state<__nv_bfloat16>(STATE_FWD);
}

// States past 32 or grouped B/C: the first (reverse = 0) or reverse entry's
// arguments, with B and C (batch, L, G, N) (G = 1: (batch, L, N)), 1 <= N
// <= 256, and part, a workspace of ceil(N / 32) x batch x L x dim fp32 (not
// read or written at one tile).  Returns as the first entry.
extern "C" int dimsum_selective_scan_fwd_split(
    const void* u, const void* dt_low, const void* dt_w, const void* A,
    const void* B, const void* C, const void* D, const void* z,
    const void* bias, void* out, void* part, int batch, int L, int dim,
    int n_state, int dt_rank, int n_groups, int dtype, int use_softplus,
    int reverse, void* stream) {
  if (!split_ok(batch, L, dim, n_state, n_groups, dtype) || dt_rank < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int N = n_state, R = dt_rank, G = n_groups;
  if (dtype == 0)
    return reverse ? dispatch_split<float, true>(SCAN_ARGS, G, part)
                   : dispatch_split<float, false>(SCAN_ARGS, G, part);
  return reverse ? dispatch_split<__nv_bfloat16, true>(SCAN_ARGS, G, part)
                 : dispatch_split<__nv_bfloat16, false>(SCAN_ARGS, G, part);
}

// The state entry's arguments, with B and C (batch, L, G, N) (G = 1:
// (batch, L, N)), 1 <= N <= 256, and part, a workspace of ceil(N / 32) x
// batch x L x dim fp32 (not read or written at one tile).
extern "C" int dimsum_selective_scan_fwd_state_split(
    const void* u, const void* delta, const void* A, const void* B,
    const void* C, const void* D, const void* z, const void* bias,
    const void* h0, void* out, void* last, void* part, int batch, int L,
    int dim, int n_state, int n_groups, int dtype, int use_softplus,
    void* stream) {
  if (!split_ok(batch, L, dim, n_state, n_groups, dtype))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int N = n_state, G = n_groups;
  return dtype == 0
             ? dispatch_state_split<float>(STATE_FWD, G, part)
             : dispatch_state_split<__nv_bfloat16>(STATE_FWD, G, part);
}
