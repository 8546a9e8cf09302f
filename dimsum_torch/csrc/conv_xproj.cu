// Depthwise causal conv + bias + SiLU + x_proj product for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dimsum_tpu/ops/conv_xproj.py::_kernel
// (pallas_call in _conv_xproj_impl), which every Mamba mixer of DiM runs
// with the conv + x_proj switch:
//
//   x_conv[t, d] = silu(sum_k w[d, k] x[t - (W-1) + k, d] + bias[d])
//                  (anticausal when reversed: x[t + (W-1) - k]; zeros
//                  outside the sequence), fp32, stored in x's type
//   x_dbl[t, n]  = sum_d x_conv[t, d] w_xp[n, d]   (x_conv as stored, fp32
//                  sums)
//
// x is (B, L, D) with contiguous channels and free batch and row strides:
// DiM's x is the first half of in_proj's output (row stride 2 D), read
// where it lies.  w_xp is x_proj.weight, (R, D), in x's type; conv_w (D, W)
// and bias (D,) are fp32.
//
// What bounds it on an H100: device memory.  At the 512-px fused shape
// (24 x 1024 x 1024, W 4, R 64, bf16) it reads x and writes x_conv (50.3 MB
// each) and x_dbl (6.3 MB fp32): 107 MB, 0.032 ms at 3.35 TB/s; at the
// 256-px mixer shape (L 256) a quarter of that, 0.0080 ms.  The product is
// 3.2 GFLOP (0.8 at L 256), ~3 us on the tensor cores; the SiLU's exp2 and
// reciprocal ~13 us on the special-function units at L 1024.
//
// The TPU kernel walks channel blocks on a sequential grid axis and carries
// x_dbl across them in its output block.  The first design here (one block
// a 16-token tile, scalar loads, the conv recomputed per 80-column group,
// w_xp staged from L2 by every block, K split over warps) ran at 14x its
// bound at L 1024.  This one (bf16) gives each warp its own pipeline:
//
//  * A block an SM of 8 warps.  Warp pairs own contiguous runs of 16-token
//    units (one batch row each, so the balance is even at L 256 and L 1024);
//    the two warps of a pair take the first and second half of each unit's
//    64-channel chunks, and the first adds the second's sums to its own
//    through x_dbl after a barrier of the two: two operands, so the sum is
//    the same whichever lands first, and no float atomic: results repeat
//    bit for bit.
//  * x comes in through each warp's ring of 2 stages, loaded by TMA (lane 0
//    issues the copies through a 3-D tensor map over the strided x slice,
//    completion on an mbarrier a stage) 2 chunks ahead of the compute.  A
//    box is the unit's 16 rows plus the W - 1 halo rows; the tensor map
//    reads rows outside [0, L) as zeros, the conv's padding.  The halo is
//    read again by the neighbouring unit (L2 hits; W - 1 of 16 rows).
//  * The same stage brings the chunk's w_xp tile of the pass (R padded to a
//    multiple of 8, at most 72 rows, 128-byte swizzle), read from L2 once a
//    unit.  Keeping all of w_xp in shared memory instead (128 KB at D 1024)
//    timed the same at D 1024 and 17% slower at D 1152, L 1024, where it
//    pushed the taps out of shared memory.  The taps (as [k][D]) and the
//    bias are loaded once a block when they fit beside the rings (D (W + 1)
//    fp32: D <= 1664 at W 4, R 72); otherwise each lane reads its channels'
//    taps from conv_w (13% slower at L 1024).
//  * The conv runs in registers, one copy of the code a conv width: lane l
//    owns channels 8 (l % 8) .. + 7 (one 16-byte vector) of 4 rows and
//    slides a W + 3-row window over the box, summing as the plain version
//    sums (in k order from the first product, then the bias; __fmul_rn /
//    __fadd_rn keep nvcc from contracting them into FMAs), so bf16 x_conv
//    rounds as the plain version's does.  x_conv leaves in 16-byte stores,
//    and the rounded tile goes over the consumed box (XOR-swizzled) as the
//    product's A operand.
//  * The product: mma.sync m16n8k16 (bf16 in, fp32 sums), the warp's 16
//    rows by all of a pass's 72 columns, k steps outer and n tiles inner so
//    the 9 products in flight are independent; the sums stay in registers
//    over all of the warp's chunks, so x_dbl is written once a pass with no
//    reduction beyond the pair's.
//  * R above one pass (72 columns; the JAX gate allows 512) walks the unit
//    again for each further 72 columns, taking A from the x_conv the lane
//    stored in the first pass (L2 hits): the conv is never recomputed.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md section 6): 0.034 ms at
// the mixer shape (4.2x its bound) and 0.088 ms at L 1024 (2.7x), against
// 0.119 / 0.456 ms for the first design in the same run.  What holds it
// there is the conv's issue: without the conv arithmetic an earlier build
// of this design took 0.018 / 0.044 ms, and its warps never wait for TMA;
// each warp issues in order, and a chunk's FP, special-function and tensor
// work run one after another.
//
// The fp32 route (no sampling path takes it) keeps the first design: one
// block a 16-token tile, 64-channel chunks staged with scalar loads, the
// product on the CUDA cores, R in groups of 80 columns over grid z.
//
// D a multiple of 64, 1 <= W <= 8; bf16 x 16-byte aligned with batch and
// row strides multiples of 8 elements; anything else returns
// cudaErrorInvalidValue.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;      // fp32 route: 4 warps
constexpr int kRows = 16;          // fp32 route: tokens per block
constexpr int kChan = 64;          // channels per chunk
constexpr int kMaxW = 8;           // conv widths taken
constexpr int kNGroup = 80;        // fp32 route: x_dbl columns per block
constexpr int kLdF = kChan + 1;    // fp32 tile row

__device__ __forceinline__ float to_float(float v) { return v; }

// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- the bf16 route --------------------------------------------------------

constexpr int kUnit = 16;               // tokens a unit (one mma m tile)
constexpr int kRowBytes = kChan * 2;    // one bf16 chunk row, 128 bytes
constexpr int kPass = 72;               // x_dbl columns a pass (R 64, 68)
constexpr int kWarps = 8;
constexpr int kStages = 2;              // ring stages a warp
constexpr int kXBox = 3 * 1024;         // (kUnit + kMaxW - 1) rows, rounded
constexpr int kSmemMax = 232448;        // what a block may ask for

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase with this parity has completed: the n-th
// use of a ring stage (n = 0, 1, ...) waits with parity n & 1.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16-byte chunk j of row r of a 128-byte-row tile sits at chunk j ^ (r % 8):
// TMA's 128-byte swizzle (w_xp) and the A tile's own layout, so that the
// eight rows an ldmatrix reads fall in distinct banks.
__device__ __forceinline__ uint32_t swz(int r, int j) {
  return r * kRowBytes + ((j ^ (r & 7)) << 4);
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// silu(y) = y sigmoid(y) = y / (1 + 2^(-y log2 e)): the exp2 and the
// reciprocal on the special-function units, flushing denormals (a few fp32
// ulp from the plain version's, below half a bf16 step).  For y < -88 the
// divisor overflows to inf and the result is -0, where the exact value is
// below 1e-36.
__device__ __forceinline__ float silu(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return y * r;
}

struct Params {
  int L, D, W, R, reverse;
  int n_chunks;     // D / 64
  int n_passes;     // kPass-column passes over R rounded up to 8
  int np;           // rows of a w_xp tile: min(R rounded up to 8, kPass)
  int nu;           // 16-token units a batch row
  int units;        // B * nu
  int split;        // 2: a unit's chunks split over a warp pair; else 1
  int taps_whole;   // the taps of all D channels kept in shared memory
  int stage_bytes;  // the x box, then the chunk's w_xp tile of the pass
  int off_taps;     // the taps as [k][D], the bias as row W
  int off_bars;     // a full mbarrier a ring stage
};

// A warp's walk over its units, pass by pass, chunk by chunk: one step a
// chunk.  Lane 0 keeps a second walk kStages steps ahead for the loads.
struct Walk {
  int u, u_end, b, t0, rows, pass, c, c_lo, c_hi;
  // task `task` of n_tasks takes a contiguous run of the units, and of each
  // the chunks c_lo .. c_hi - 1
  __device__ Walk(const Params& p, int task, int n_tasks, int lo, int hi)
      : pass(0), c(lo), c_lo(lo), c_hi(hi) {
    u = static_cast<int>(static_cast<long long>(task) * p.units / n_tasks);
    u_end = static_cast<int>(static_cast<long long>(task + 1) * p.units /
                             n_tasks);
    if (u < u_end) start_unit(p);
  }
  __device__ void start_unit(const Params& p) {
    b = u / p.nu;
    t0 = (u - b * p.nu) * kUnit;
    rows = min(kUnit, p.L - t0);
  }
  __device__ bool done() const { return u >= u_end; }
  __device__ void advance(const Params& p) {
    if (++c < c_hi) return;
    c = c_lo;
    if (++pass < p.n_passes) return;
    pass = 0;
    if (++u < u_end) start_unit(p);
  }
};

// Lane 0 loads step w of its warp into ring stage `stage`: the chunk's x box
// (16 + W - 1 rows from t0 - (W - 1), or from t0 when reversed) on the
// first pass, and the chunk's w_xp tile of the pass.
__device__ __forceinline__ void issue(const Params& p, const Walk& w,
                                      uint32_t stage, uint32_t bar,
                                      const CUtensorMap* tx,
                                      const CUtensorMap* tw) {
  const bool load_x = w.pass == 0;
  mbar_expect_tx(bar, (load_x ? (kUnit + p.W - 1) * kRowBytes : 0) +
                          p.np * kRowBytes);
  if (load_x) {
    tma_load_3d(stage, tx, bar, w.c * kChan,
                p.reverse ? w.t0 : w.t0 - (p.W - 1), w.b);
  }
  tma_load_2d(stage + kXBox, tw, bar, w.c * kChan, w.pass * kPass);
}

// The conv of a lane's 4 rows x 8 channels for conv width kW.  xs: the
// lane's first window row in the box; tp: its channels' taps, tap k of
// channel i at tp[k D + i] in shared memory (taps_whole) or tp[i W + k] in
// conv_w.  The kW + 3 window rows are loaded first, in reverse order when
// reversed, so that output m takes tap k from window row m + k either way
// (row m causal, row 3 - m reversed); each output is summed in k order from
// its first product (0 + x w is x w, up to the sign of a zero), then the
// bias, SiLU and the rounding to bf16.
template <int kW>
__device__ __forceinline__ void conv_rows(const unsigned char* xs,
                                          const float* tp, const Params& p,
                                          const float* __restrict__ conv_b,
                                          int ch0, bool rev, uint4 (&out)[4]) {
  auto tap_row = [&](int k, float (&v)[8]) {
    if (p.taps_whole) {
      const float4 a = *reinterpret_cast<const float4*>(tp + k * p.D);
      const float4 b = *reinterpret_cast<const float4*>(tp + k * p.D + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __ldg(tp + i * kW + k);
    }
  };
  constexpr int kRows = kW + 3;
  uint4 raw[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    raw[q] = *reinterpret_cast<const uint4*>(
        xs + (rev ? kRows - 1 - q : q) * kRowBytes);
  }
  float taps[kW][8], bias[8];
#pragma unroll
  for (int k = 0; k < kW; ++k) tap_row(k, taps[k]);
  if (p.taps_whole) {
    tap_row(kW, bias);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      bias[i] = conv_b != nullptr ? __ldg(conv_b + ch0 + i) : 0.f;
    }
  }
  float xf[kRows][8];
#pragma unroll
  for (int q = 0; q < kRows; ++q) unpack8(raw[q], xf[q]);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float y = __fmul_rn(xf[m][i], taps[0][i]);
#pragma unroll
      for (int k = 1; k < kW; ++k) {
        y = __fadd_rn(y, __fmul_rn(xf[m + k][i], taps[k][i]));
      }
      v[i] = silu(__fadd_rn(y, bias[i]));
    }
    const uint4 o = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                               pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
    if (rev) {
      out[3 - m] = o;
    } else {
      out[m] = o;
    }
  }
}

// One block an SM (fewer when there are fewer units) of 8 warps; per step (a
// 64-channel chunk of its 16-token unit) a warp
//   1. waits for the stage's x box and w_xp tile (TMA, kStages steps ahead);
//   2. convolves (conv_rows), or on a later pass reloads the x_conv its
//      lanes stored in the first;
//   3. stores x_conv and writes the rounded tile over the consumed box;
//   4. multiplies it by the chunk's w_xp tile into its sums, and at a
//      pass's end writes x_dbl (the pair's second warp first, then the first
//      adds its own there);
//   5. hands the stage back to TMA for the step kStages ahead.
__global__ void __launch_bounds__(32 * kWarps, 1) conv_xproj_sm90_kernel(
    const __grid_constant__ CUtensorMap tx,
    const __grid_constant__ CUtensorMap tw, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, __nv_bfloat16* __restrict__ x_conv,
    float* __restrict__ x_dbl, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's period
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int W = p.W, D = p.D;
  const uint32_t full = base + p.off_bars + 8 * warp * kStages;
  const uint32_t ring = base + warp * kStages * p.stage_bytes;

  if (tid == 0) {
    for (int i = 0; i < kWarps * kStages; ++i) {
      mbar_init(base + p.off_bars + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // split 2: warps 2 i and 2 i + 1 take the first and second half of the
  // chunks of the same units
  const bool split = p.split == 2;
  const int half = split ? warp % 2 : 0, c_mid = p.n_chunks / 2;
  Walk w(p, split ? blockIdx.x * (kWarps / 2) + warp / 2
                  : blockIdx.x * kWarps + warp,
         gridDim.x * kWarps / p.split, half ? c_mid : 0,
         split && !half ? c_mid : p.n_chunks);
  Walk ahead = w;
  if (lane == 0) {
    for (int i = 0; i < kStages && !ahead.done(); ++i, ahead.advance(p)) {
      issue(p, ahead, ring + i * p.stage_bytes, full + 8 * i, &tx, &tw);
    }
  }
  if (p.taps_whole) {
    // the taps as [k][D] and the bias: each thread's loads all in flight,
    // then the stores
    float* t = reinterpret_cast<float*>(smem + p.off_taps);
    const int n_taps = D * W;
    for (int i0 = 0; i0 < n_taps + D; i0 += 16 * 32 * kWarps) {
      float v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int i = i0 + k * 32 * kWarps + tid;
        v[k] = i < n_taps                                  ? conv_w[i]
               : i < n_taps + D && conv_b != nullptr ? conv_b[i - n_taps]
                                                        : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int i = i0 + k * 32 * kWarps + tid;
        if (i < n_taps) {
          const int d = i / W;
          t[(i - d * W) * D + d] = v[k];
        } else if (i < n_taps + D) {
          t[W * D + i - n_taps] = v[k];
        }
      }
    }
  }
  __syncthreads();

  const int cg = lane % 8, g = lane / 4, q = lane % 4;
  const int r0 = 4 * (lane / 8);  // the lane's 4 rows of the unit
  const bool rev = p.reverse != 0;
  float acc[kPass / 8][4];
#pragma unroll
  for (int j = 0; j < kPass / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int step = 0; !w.done(); w.advance(p), ++step) {
    const int s = step % kStages;
    const uint32_t stage = ring + s * p.stage_bytes;
    unsigned char* st = smem + (stage - base);
    mbar_wait(full + 8 * s, (step / kStages) & 1);
    const int ch0 = w.c * kChan + cg * 8;
    __nv_bfloat16* xc =
        x_conv + (static_cast<long long>(w.b) * p.L + w.t0 + r0) * D + ch0;

    uint4 out[4];  // rows r0 + m
    if (w.pass == 0) {
      const float* tp = p.taps_whole
                            ? reinterpret_cast<const float*>(
                                  smem + p.off_taps) + ch0
                            : conv_w + static_cast<long long>(ch0) * W;
      const unsigned char* xs = st + r0 * kRowBytes + cg * 16;
      switch (W) {
        case 1: conv_rows<1>(xs, tp, p, conv_b, ch0, rev, out); break;
        case 2: conv_rows<2>(xs, tp, p, conv_b, ch0, rev, out); break;
        case 3: conv_rows<3>(xs, tp, p, conv_b, ch0, rev, out); break;
        case 4: conv_rows<4>(xs, tp, p, conv_b, ch0, rev, out); break;
        case 5: conv_rows<5>(xs, tp, p, conv_b, ch0, rev, out); break;
        case 6: conv_rows<6>(xs, tp, p, conv_b, ch0, rev, out); break;
        case 7: conv_rows<7>(xs, tp, p, conv_b, ch0, rev, out); break;
        default: conv_rows<8>(xs, tp, p, conv_b, ch0, rev, out); break;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (r0 + m < w.rows) {
          *reinterpret_cast<uint4*>(xc + static_cast<long long>(m) * D) =
              out[m];
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        out[m] = r0 + m < w.rows
                     ? *reinterpret_cast<const uint4*>(
                           xc + static_cast<long long>(m) * D)
                     : make_uint4(0, 0, 0, 0);
      }
    }
    __syncwarp();  // every lane has read the box: the A tile goes over it
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      *reinterpret_cast<uint4*>(st + swz(r0 + m, cg)) = out[m];
    }
    __syncwarp();

    // x_dbl[unit rows, pass columns] += A B over the chunk, 4 k steps of 16;
    // k steps outer and n tiles inner, so the products in flight together
    // are independent
    const int nt = min(kPass, ((p.R + 7) & ~7) - w.pass * kPass) / 8;
    const uint32_t w_tile = stage + kXBox;
    uint32_t af[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      ldsm_x4(af[ks], stage + swz(lane % 16, 2 * ks + lane / 16));
    }
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      uint32_t bf[kPass / 8][4];
#pragma unroll
      for (int j = 0; j < kPass / 8; ++j) {
        if (j < nt) {
          ldsm_x4(bf[j], w_tile + swz(j * 8 + lane % 8, 4 * kp + lane / 8));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < kPass / 8; ++j) {
          if (j < nt) {
            mma_bf16(acc[j], af[2 * kp + h], bf[j][2 * h], bf[j][2 * h + 1]);
          }
        }
      }
    }

    if (w.c == w.c_hi - 1) {
      // the pass is complete: rows g and g + 8, columns 2 q and 2 q + 1 of
      // each n tile
      auto each = [&](auto&& fn) {
#pragma unroll
        for (int j = 0; j < kPass / 8; ++j) {
          const int col = w.pass * kPass + j * 8 + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = g + 8 * h;
            if (j < nt && r < w.rows && col < p.R) {
              fn(x_dbl + (static_cast<long long>(w.b) * p.L + w.t0 + r) *
                             p.R + col,
                 acc[j][2 * h], acc[j][2 * h + 1], col + 1 < p.R);
            }
          }
        }
      };
      auto put = [&](float* o, float a0, float a1, bool both) {
        if (p.R % 2 == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(a0, a1);
        } else {
          o[0] = a0;
          if (both) o[1] = a1;
        }
      };
      if (split) {
        if (half) each(put);
        asm volatile("bar.sync %0, 64;\n" ::"r"(1 + warp / 2) : "memory");
        if (!half) {
          each([&](float* o, float a0, float a1, bool both) {
            put(o, o[0] + a0, both ? o[1] + a1 : 0.f, both);
          });
        }
      } else {
        each(put);
      }
#pragma unroll
      for (int j = 0; j < kPass / 8; ++j) {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
    }
    // the stage's plain writes and reads come before TMA refills it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0 && !ahead.done()) {
      issue(p, ahead, stage, full + 8 * s, &tx, &tw);
      ahead.advance(p);
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first) as a tensor map with the
// given box; elements outside the tensor read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, cuuint32_t rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t estrides[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, estrides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The current device's SM count; on a device's first call, also lets the
// kernel ask for kSmemMax bytes of shared memory.  Once a device, so that
// a launch adds no queries.
cudaError_t prepare_device(int* sms) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> known[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = known[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(conv_xproj_sm90_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemMax);
    }
    if (err != cudaSuccess) return err;
    known[dev].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return cudaSuccess;
}

cudaError_t launch_bf16(const void* x, const float* conv_w,
                        const float* conv_b, const void* w_xp, void* x_conv,
                        float* x_dbl, long long x_sb, long long x_sl, int B,
                        int L, int D, int W, int R, int reverse,
                        cudaStream_t stream) {
  if (x_sb % 8 != 0 || x_sl % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w_xp) % 16 != 0 ||
      static_cast<long long>(B) * ((L + kUnit - 1) / kUnit) > (1 << 30)) {
    return cudaErrorInvalidValue;
  }
  Params p;
  p.L = L;
  p.D = D;
  p.W = W;
  p.R = R;
  p.reverse = reverse;
  p.n_chunks = D / kChan;
  const int r_pad = (R + 7) & ~7;
  p.n_passes = (r_pad + kPass - 1) / kPass;
  p.np = r_pad < kPass ? r_pad : kPass;
  p.nu = (L + kUnit - 1) / kUnit;
  p.units = B * p.nu;
  p.split = p.n_chunks >= 2 ? 2 : 1;
  // the warps' rings (192 KB at R 65 .. 72), the taps of all of D when they
  // fit in what is left (D (W + 1) fp32; beside 72-row tiles D <= 1664 at
  // W 4, 896 at W 8), then the mbarriers, with 1024 bytes for the alignment
  p.stage_bytes = kXBox + p.np * kRowBytes;
  p.off_taps = kWarps * kStages * p.stage_bytes;
  const long long t_bytes = (static_cast<long long>(W + 1) * D * 4 + 1023) /
                            1024 * 1024;
  p.taps_whole = p.off_taps + t_bytes + 8 * kWarps * kStages + 1024 <=
                 kSmemMax;
  p.off_bars = p.off_taps + (p.taps_whole ? static_cast<int>(t_bytes) : 0);
  const int smem = p.off_bars + 8 * kWarps * kStages + 1024;

  CUtensorMap tx, tw;
  const cuuint64_t x_dims[3] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(L),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t x_strides[2] = {static_cast<cuuint64_t>(x_sl) * 2,
                                   static_cast<cuuint64_t>(x_sb) * 2};
  const cuuint32_t x_box[3] = {kChan, static_cast<cuuint32_t>(kUnit + W - 1),
                               1};
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(R)};
  const cuuint64_t w_strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t w_box[2] = {kChan, static_cast<cuuint32_t>(p.np)};
  if (!make_map(&tx, x, 3, x_dims, x_strides, x_box,
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&tw, w_xp, 2, w_dims, w_strides, w_box,
                CU_TENSOR_MAP_SWIZZLE_128B)) {
    return cudaErrorInvalidValue;
  }
  int sms = 0;
  const cudaError_t err = prepare_device(&sms);
  if (err != cudaSuccess) return err;
  const int grid = p.units < sms ? p.units : sms;
  conv_xproj_sm90_kernel<<<grid, 32 * kWarps, smem, stream>>>(
      tx, tw, conv_w, conv_b, static_cast<__nv_bfloat16*>(x_conv), x_dbl, p);
  return cudaGetLastError();
}

// ---- the fp32 route --------------------------------------------------------

// Rows of the chunk's input with the halo: row r of sX is token
// t0 - (W-1) + r (causal) or t0 + r (reversed); zero outside [0, L).
template <typename T>
__device__ __forceinline__ void stage_x(float (*sX)[kChan], const T* xb,
                                        long long x_sl, int t0, int L, int c0,
                                        int W, int reverse) {
  const int first = reverse ? t0 : t0 - (W - 1);
  for (int i = threadIdx.x; i < (kRows + W - 1) * kChan; i += kThreads) {
    const int r = i / kChan, ch = i % kChan, t = first + r;
    sX[r][ch] = (t >= 0 && t < L) ? to_float(xb[t * x_sl + c0 + ch]) : 0.f;
  }
}

// silu(conv + bias) of the block's row r, chunk channel ch, summed as the
// plain version sums it (from 0, in k order, then the bias).
__device__ __forceinline__ float conv_silu(float (*sX)[kChan],
                                           const float* w_d, float bias, int r,
                                           int ch, int W, int reverse) {
  float y = 0.f;
  for (int k = 0; k < W; ++k) {
    const int o = reverse ? W - 1 - k : k;
    y = __fadd_rn(y, __fmul_rn(sX[r + o][ch], w_d[k]));
  }
  y = __fadd_rn(y, bias);
  return __fmul_rn(y, 1.f / (1.f + expf(-y)));
}

__global__ void __launch_bounds__(kThreads) conv_xproj_f32_kernel(
    const float* __restrict__ x, long long x_sb, long long x_sl,
    const float* __restrict__ conv_w, const float* __restrict__ conv_b,
    const float* __restrict__ w_xp, float* __restrict__ x_conv,
    float* __restrict__ x_dbl, int L, int D, int W, int R, int reverse) {
  __shared__ float sX[kRows + kMaxW - 1][kChan];
  __shared__ float sA[kRows][kLdF];
  __shared__ float sW[kNGroup][kLdF];

  const int tid = threadIdx.x;
  const int r_own = tid % kRows, n_own = tid / kRows;  // columns n_own + 8 j
  const int t0 = blockIdx.x * kRows, b = blockIdx.y, n0 = blockIdx.z * kNGroup;
  const float* xb = x + b * x_sb;

  float acc[kNGroup / 8];
#pragma unroll
  for (int j = 0; j < kNGroup / 8; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < D; c0 += kChan) {
    stage_x(sX, xb, x_sl, t0, L, c0, W, reverse);
    for (int i = tid; i < kNGroup * kChan; i += kThreads) {
      const int n = i / kChan, k = i % kChan;
      sW[n][k] =
          n0 + n < R ? w_xp[static_cast<long long>(n0 + n) * D + c0 + k] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kRows * kChan; i += kThreads) {
      const int r = i / kChan, ch = i % kChan, d = c0 + ch, t = t0 + r;
      const float v = conv_silu(sX, conv_w + static_cast<long long>(d) * W,
                                conv_b != nullptr ? conv_b[d] : 0.f, r, ch, W,
                                reverse);
      sA[r][ch] = t < L ? v : 0.f;
      if (t < L && blockIdx.z == 0) {
        x_conv[(static_cast<long long>(b) * L + t) * D + d] = v;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChan; ++k) {
      const float a = sA[r_own][k];
#pragma unroll
      for (int j = 0; j < kNGroup / 8; ++j) {
        acc[j] = fmaf(a, sW[n_own + 8 * j][k], acc[j]);
      }
    }
    __syncthreads();
  }

  const int t = t0 + r_own;
#pragma unroll
  for (int j = 0; j < kNGroup / 8; ++j) {
    const int n = n0 + n_own + 8 * j;
    if (t < L && n < R) {
      x_dbl[(static_cast<long long>(b) * L + t) * R + n] = acc[j];
    }
  }
}

}  // namespace

// x: (B, L, D) with batch stride x_sb and row stride x_sl (elements),
// contiguous channels; conv_w (D, W) and conv_b (D,) float32 (conv_b may be
// null); w_xp (R, D) of x's type; x_conv (B, L, D) contiguous, of x's type;
// x_dbl (B, L, R) float32 contiguous.  dtype 0 float32, 1 bfloat16.
// Returns a cudaError_t (0 on success).
extern "C" int dimsum_conv_xproj(const void* x, const void* conv_w,
                                 const void* conv_b, const void* w_xp,
                                 void* x_conv, void* x_dbl, long long x_sb,
                                 long long x_sl, int B, int L, int D, int W,
                                 int R, int dtype, int reverse, void* stream) {
  if (B <= 0 || B > 65535 || L <= 0 || D <= 0 || D % kChan != 0 || W < 1 ||
      W > kMaxW || R <= 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return static_cast<int>(launch_bf16(
        x, static_cast<const float*>(conv_w),
        static_cast<const float*>(conv_b), w_xp, x_conv,
        static_cast<float*>(x_dbl), x_sb, x_sl, B, L, D, W, R, reverse, s));
  }
  const dim3 grid((L + kRows - 1) / kRows, B, (R + kNGroup - 1) / kNGroup);
  conv_xproj_f32_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), x_sb, x_sl,
      static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
      static_cast<const float*>(w_xp), static_cast<float*>(x_conv),
      static_cast<float*>(x_dbl), L, D, W, R, reverse);
  return static_cast<int>(cudaGetLastError());
}
