// Softmax attention over a whole sequence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dimsum_tpu/ops/full_attention.py::_attn_kernel
// (pallas_call in _build_call), the attention at L >= 1024, the first design:
// the route sends it Dh 80-128 in both dtypes, a head size no model of the
// zoo has.  Dh 64 (DiM-L/2) and 72 (DiT-XL/2, DiM-XL/2) go to the Hopper
// redesigns, csrc/full_attention_sm90.cu (bf16) and full_attention_f32.cu
// (fp32); this kernel still computes them, and chip_smoke.py times it there
// beside them.
//
// Per (batch, head), with q pre-scaled in q's type as the JAX wrapper does:
//
//   S = (q * scale) k^T                      fp32 sums
//   P = exp(S - rowmax(S))                   fp32
//   O = (P rounded to v's type) v / rowsum(P)  fp32 sums, cast to O's type
//
// Layout: q, k, v are (batch, L, heads, Dh) with each (heads, Dh) row packed
// and any batch and row strides (multiples of 8 elements, 16-byte aligned).
// The modules slice q, k and v out of one qkv projection, so those strides
// are 3 * heads * Dh: the kernel reads the slices where they lie and the
// wrapper makes no copy.  O is (batch, L, heads, Dh), contiguous.
//
// What bounds it on an H100 at the 512-px DiT shape (24 rows, 16 heads, L
// 1024, Dh 64, bf16): 4 L^2 Dh flop per head, 103 GFLOP, 0.104 ms at 989
// TFLOP/s on the tensor cores; q, k, v read once and o written once, 201 MB,
// 0.060 ms at 3.35 TB/s; 403 M exp, ~0.096 ms on the special-function units
// (16 per SM per clock).  So the tensor cores bound it.
//
// The TPU kernel keeps a head's whole (L, L) fp32 score tile in VMEM (4 MB
// at L 1024) and takes one exact softmax pass over it.  A Hopper block has
// 227 KB of shared memory, so the design is new (flash-attention 2 style):
//
//  * bf16: one block of 4 warps per (64-row query tile, batch * head), 6,144
//    blocks at the DiT shape.  Each warp keeps its 16 query rows as mma
//    fragments in registers.  Keys and values stream through shared memory
//    in 64-row tiles, double-buffered with cp.async.  S and P V run on the
//    tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate); S stays in
//    registers and becomes P V's A operand without a trip through shared
//    memory.  The softmax is online: a running row max and sum, the output
//    rescaled when the max grows.  So P is rounded to bf16 as exp(S - the
//    running max), where the TPU kernel rounds exp(S - the final max); the
//    two differ by a bf16 rounding step.  Dh that is not a multiple of 16
//    (72) is zero-padded in shared memory to the mma's k step.
//  * fp32: computed in fp32 on the CUDA cores, so that fp32 checks stay
//    tight: two threads per query row, each holding half of q and of the
//    output in registers, keys and values in 32-row shared-memory tiles,
//    the same online softmax.
//
// No wgmma, TMA or warp specialisation yet.  Dh is a compile-time size, a
// multiple of 8 from 64 to 128; L a multiple of 64.  Anything else returns
// cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // keys per shared-memory tile (bf16)
constexpr int kKeysF32 = 32;   // keys per shared-memory tile (fp32)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix m.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: a 16x16 (row), b 16x8 (col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DH>
struct Bf16Tile {
  static constexpr int kDp = (DH + 15) / 16 * 16;  // Dh padded to mma's k
  static constexpr int kLd = kDp + 8;  // row stride: ldmatrix conflict-free
  // the query tile, then two key and two value tiles
  static constexpr int kSmemBytes =
      (kRows + 4 * kKeys) * kLd * static_cast<int>(sizeof(__nv_bfloat16));
};

// Lane l of a warp holds, in the mma fragment layouts, rows g = l / 4 and
// g + 8 and column pairs 2 (l % 4) (+ 8) of each 16x16 or 16x8 tile.
template <int DH>
__global__ void __launch_bounds__(kThreads)
    attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, long long q_sb,
                     long long q_sl, long long k_sb, long long k_sl,
                     long long v_sb, long long v_sl, int L, int heads,
                     float scale) {
  constexpr int DP = Bf16Tile<DH>::kDp;
  constexpr int LD = Bf16Tile<DH>::kLd;
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kRows * LD;
  __nv_bfloat16* sV = sK + 2 * kKeys * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int row0 = blockIdx.x * kRows;
  const __nv_bfloat16* qb = q + b * q_sb + static_cast<long long>(h) * DH;
  const __nv_bfloat16* kb = k + b * k_sb + static_cast<long long>(h) * DH;
  const __nv_bfloat16* vb = v + b * v_sb + static_cast<long long>(h) * DH;

  auto load_kv = [&](int tile, int buf) {
    const long long key0 = static_cast<long long>(tile) * kKeys;
    __nv_bfloat16* dk = sK + buf * kKeys * LD;
    __nv_bfloat16* dv = sV + buf * kKeys * LD;
    for (int i = tid; i < kKeys * CH; i += kThreads) {
      const int r = i / CH, ch = i % CH;
      cp_async16(dk + r * LD + ch * 8, kb + (key0 + r) * k_sl + ch * 8);
      cp_async16(dv + r * LD + ch * 8, vb + (key0 + r) * v_sl + ch * 8);
    }
  };

  // zero the padded columns (Dh..DP) of all five tiles: loads never write
  // them, and zeros there add nothing to S
  if constexpr (DP > DH) {
    for (int i = tid; i < (kRows + 4 * kKeys) * (DP - DH); i += kThreads) {
      sQ[(i / (DP - DH)) * LD + DH + i % (DP - DH)] = __float2bfloat16(0.f);
    }
  }
  load_kv(0, 0);
  cp_async_commit();
  // the query tile, pre-scaled and rounded to bf16 as `q * scale` is
  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, ch = i % CH;
    uint4 raw = *reinterpret_cast<const uint4*>(
        qb + static_cast<long long>(row0 + r) * q_sl + ch * 8);
    __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(pr[e]);
      pr[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(sQ + r * LD + ch * 8) = raw;
  }
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16 columns of Dh
  uint32_t qf[DP / 16][4];
  const __nv_bfloat16* qw = sQ + warp * 16 * LD;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const int col = ks * 16 + 2 * c;
    qf[ks][0] = *reinterpret_cast<const uint32_t*>(qw + g * LD + col);
    qf[ks][1] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * LD + col);
    qf[ks][2] = *reinterpret_cast<const uint32_t*>(qw + g * LD + col + 8);
    qf[ks][3] =
        *reinterpret_cast<const uint32_t*>(qw + (g + 8) * LD + col + 8);
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  // running max and (per-thread partial) sum of rows g and g + 8
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F, l_lo = 0.f, l_hi = 0.f;
  const int lm = lane / 8, lr = lane % 8;  // ldmatrix: matrix, row

  const int n_tiles = L / kKeys;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tk = sK + (t & 1) * kKeys * LD;
    const __nv_bfloat16* tv = sV + (t & 1) * kKeys * LD;

    // S = q k^T for 16 rows x 64 keys: 8 tiles of 16x8
    float s[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    }
#pragma unroll
    for (int np = 0; np < kKeys / 16; ++np) {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        // matrices: keys +0..7 / +8..15 (m >> 1), Dh +0..7 / +8..15 (m & 1)
        uint32_t bk[4];
        ldmatrix_x4(bk, tk + (np * 16 + (lm >> 1) * 8 + lr) * LD + ks * 16 +
                            (lm & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[ks], bk[2], bk[3]);
      }
    }

    // online softmax: new running max, rescale of what came before
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    const float a_lo = exp2f((m_lo - mx_lo) * kLog2e);
    const float a_hi = exp2f((m_hi - mx_hi) * kLog2e);
    m_lo = mx_lo;
    m_hi = mx_hi;

    // P = exp(S - max) in fp32, summed unrounded; rounded to bf16 as the A
    // fragments of P V (the accumulator layout of two 16x8 tiles is the A
    // layout of one 16x16 tile)
    uint32_t pf[kKeys / 16][4];
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      const float p0 = exp2f((s[n][0] - m_lo) * kLog2e);
      const float p1 = exp2f((s[n][1] - m_lo) * kLog2e);
      const float p2 = exp2f((s[n][2] - m_hi) * kLog2e);
      const float p3 = exp2f((s[n][3] - m_hi) * kLog2e);
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      pf[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= a_lo;
      acc[n][1] *= a_lo;
      acc[n][2] *= a_hi;
      acc[n][3] *= a_hi;
    }

    // O += P V: V's fragments through the transposing ldmatrix
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        // matrices: keys +0..7 / +8..15 (m & 1), Dh +0..7 / +8..15 (m >> 1)
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, tv + (kk * 16 + (lm & 1) * 8 + lr) * LD +
                                  np * 16 + (lm >> 1) * 8);
        mma_bf16(acc[2 * np], pf[kk], bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], pf[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const long long o_sl = static_cast<long long>(heads) * DH;
  __nv_bfloat16* ob = o + static_cast<long long>(b) * L * o_sl +
                      static_cast<long long>(h) * DH;
  const long long r_lo = row0 + warp * 16 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * c;
    if (col < DH) {
      *reinterpret_cast<uint32_t*>(ob + r_lo * o_sl + col) =
          pack_bf16(acc[n][0] / l_lo, acc[n][1] / l_lo);
      *reinterpret_cast<uint32_t*>(ob + r_hi * o_sl + col) =
          pack_bf16(acc[n][2] / l_hi, acc[n][3] / l_hi);
    }
  }
}

// fp32: two threads per query row (lanes 2i, 2i + 1), each with half of Dh.
template <int DH>
__global__ void __launch_bounds__(kThreads)
    attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    long long q_sb, long long q_sl, long long k_sb,
                    long long k_sl, long long v_sb, long long v_sl, int L,
                    int heads, float scale) {
  constexpr int HALF = DH / 2;  // a multiple of 4
  __shared__ __align__(16) float sK[kKeysF32 * DH];
  __shared__ __align__(16) float sV[kKeysF32 * DH];

  const int tid = threadIdx.x, part = tid & 1;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + tid / 2;
  const float* kb = k + b * k_sb + static_cast<long long>(h) * DH;
  const float* vb = v + b * v_sb + static_cast<long long>(h) * DH;

  float qr[HALF], acc[HALF];
  const float* qrow =
      q + b * q_sb + row * q_sl + static_cast<long long>(h) * DH + part * HALF;
#pragma unroll
  for (int d = 0; d < HALF; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(qrow + d);
    qr[d] = x.x * scale;
    qr[d + 1] = x.y * scale;
    qr[d + 2] = x.z * scale;
    qr[d + 3] = x.w * scale;
  }
#pragma unroll
  for (int d = 0; d < HALF; ++d) acc[d] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  for (int key0 = 0; key0 < L; key0 += kKeysF32) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kKeysF32 * DH / 4; i += kThreads) {
      const int r = i / (DH / 4), c4 = i % (DH / 4);
      reinterpret_cast<float4*>(sK)[i] = *reinterpret_cast<const float4*>(
          kb + (key0 + r) * k_sl + c4 * 4);
      reinterpret_cast<float4*>(sV)[i] = *reinterpret_cast<const float4*>(
          vb + (key0 + r) * v_sl + c4 * 4);
    }
    __syncthreads();

    float s[kKeysF32];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kKeysF32; ++j) {
      const float* kr = sK + j * DH + part * HALF;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < HALF; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + d);
        dot = fmaf(qr[d], kv.x, dot);
        dot = fmaf(qr[d + 1], kv.y, dot);
        dot = fmaf(qr[d + 2], kv.z, dot);
        dot = fmaf(qr[d + 3], kv.w, dot);
      }
      s[j] = dot + __shfl_xor_sync(0xffffffffu, dot, 1);
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = exp2f((m - mx) * kLog2e);
    m = mx;
#pragma unroll
    for (int d = 0; d < HALF; ++d) acc[d] *= alpha;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysF32; ++j) {
      const float p = exp2f((s[j] - m) * kLog2e);
      sum += p;
      const float* vr = sV + j * DH + part * HALF;
#pragma unroll
      for (int d = 0; d < HALF; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + d);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    l = l * alpha + sum;
  }

  const long long o_sl = static_cast<long long>(heads) * DH;
  float* orow = o + static_cast<long long>(b) * L * o_sl + row * o_sl +
                static_cast<long long>(h) * DH + part * HALF;
#pragma unroll
  for (int d = 0; d < HALF; d += 4) {
    *reinterpret_cast<float4*>(orow + d) =
        make_float4(acc[d] / l, acc[d + 1] / l, acc[d + 2] / l,
                    acc[d + 3] / l);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long q_sb, long long q_sl, long long k_sb,
                   long long k_sl, long long v_sb, long long v_sl, int batch,
                   int L, int heads, int dtype, float scale,
                   cudaStream_t stream) {
  const dim3 grid(L / kRows, batch * heads);
  if (dtype == 1) {
    constexpr int smem = Bf16Tile<DH>::kSmemBytes;
    cudaError_t err = cudaFuncSetAttribute(
        attn_bf16_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    attn_bf16_kernel<DH><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, L,
        heads, scale);
  } else {
    attn_f32_kernel<DH><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), q_sb, q_sl,
        k_sb, k_sl, v_sb, v_sl, L, heads, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (batch, L, heads, dh) with the given batch and row strides (in
// elements); o: (batch, L, heads, dh) contiguous.  dtype 0 float32, 1
// bfloat16.  Returns a cudaError_t (0 on success).
extern "C" int dimsum_full_attention(const void* q, const void* k,
                                     const void* v, void* o, long long q_sb,
                                     long long q_sl, long long k_sb,
                                     long long k_sl, long long v_sb,
                                     long long v_sl, int batch, int L,
                                     int heads, int dh, int dtype, float scale,
                                     void* stream) {
  if (L <= 0 || L % kRows != 0 || L % kKeys != 0 || batch <= 0 ||
      heads <= 0 || batch * heads > 65535 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DIMSUM_ATTN_CASE(D)                                                  \
  case D:                                                                    \
    return static_cast<int>(launch<D>(q, k, v, o, q_sb, q_sl, k_sb, k_sl,    \
                                      v_sb, v_sl, batch, L, heads, dtype,    \
                                      scale, s));
  switch (dh) {
    DIMSUM_ATTN_CASE(64)
    DIMSUM_ATTN_CASE(72)
    DIMSUM_ATTN_CASE(80)
    DIMSUM_ATTN_CASE(88)
    DIMSUM_ATTN_CASE(96)
    DIMSUM_ATTN_CASE(104)
    DIMSUM_ATTN_CASE(112)
    DIMSUM_ATTN_CASE(120)
    DIMSUM_ATTN_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DIMSUM_ATTN_CASE
}
