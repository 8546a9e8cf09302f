// Softmax attention over a whole sequence, fp32 at head size 64 or 72, for
// Hopper (sm_90a).
//
// Replaces, for fp32 inputs with Dh 64 or 72, the Pallas TPU kernel
// dimsum_tpu/ops/full_attention.py::_attn_kernel (pallas_call in
// _build_call).  Dh 64: the attention of DiM-L/2 at 512 px in the default
// fp32 sampling path, the DiTBlock (16 heads, every 4th block) and
// CrossAttentionFusion (8 heads on each half, twice per combined block), 36
// calls a CFG forward.  Dh 72: DiT-XL/2 and DiM-XL/2 at 512 px (hidden
// 1152; 28 and 54 calls a forward).  bf16 at Dh 64 and 72 goes to
// csrc/full_attention_sm90.cu; fp32 and bf16 at Dh 80-128 stay with
// csrc/full_attention.cu.  Per (batch, head), as the plain version computes
// it:
//
//   S = (q * scale) k^T                        fp32, q * scale rounded first
//   P = exp(S - rowmax(S))                     fp32
//   O = P v / rowsum(P)                        fp32
//
// Layout: q, k, v are (batch, L, heads, Dh) with each (heads, Dh) row packed
// and any batch and row strides (multiples of 8 elements, 16-byte aligned):
// the modules slice them out of qkv projections, rows 3 * heads * Dh apart,
// and the kernel reads them there.  O is (batch, L, heads, Dh), contiguous.
//
// What bounds it on an H100: 4 L^2 Dh flop per (batch, head), 103 GFLOP at
// the DiT shape (24, 1024, 16, 64): 1.54 ms on the FP32 pipe (67 TFLOP/s),
// or 0.625 ms as three TF32 tensor-core passes (3 x 103 GFLOP at 495
// TFLOP/s); the bytes (403 MB, 0.120 ms) and the 403 M exponentials (0.096
// ms) are far below.  The cross shape (24, 1024, 8, 64) is half of each.
// DiT-XL/2's (8, 1024, 16, 72): 38.7 GFLOP, 0.234 ms as three TF32 passes.
//
// Why S stays on the FP32 pipe.  Split into a TF32 big and small part
// (three passes), q k^T differs from the plain version's fp32 product by
// ~7e-7 of each term, 10x fp32's own rounding.  Where logits are large (q
// and k 40x N(0, 1): logits ~1e3) and two keys of a row nearly tie, the
// softmax turns that into an output error of 2.7e-5 of the output's scale
// (emulated on the card test's inputs), over the 2e-5 tolerance; even an
// exactly rounded S misses it (3.3e-5).  So S is summed as the plain fp32
// product sums it, bit for bit: one FMA chain a (row, key) over d = 0 ...
// Dh - 1 from zero, the inner loop of the fp32 matrix product on the card
// (the same bits as torch.matmul there, at K 64 and at K 72), on q * scale
// rounded to fp32.  P V is
// insensitive (P is in [0, 1] and no softmax follows: ~1e-7 of scale
// emulated), so it runs on the tensor cores as three TF32 products,
// P_small V_big + P_big V_small + P_big V_big, small terms first.
//
// The design:
//
//  * A block owns 64 query rows of one (batch, head) and 4 warps; keys and
//    values stream through shared memory in tiles of 64 keys, loaded with
//    cp.async, one buffer each, a phase ahead: V of tile t while S of tile
//    t runs, K of tile t + 1 while P V of tile t runs.  69 KB of shared
//    memory and up to 255 registers a thread: an SM holds 2 blocks.
//  * S phase: thread (rg, jg) = (tid / 16, tid % 16) holds an 8 x 4
//    register tile of S, rows rg + 8 r and keys jg + 16 i: per 4 values of
//    d, 12 float4 loads feed 128 FMAs.  Q (pre-scaled) and K rows are Dh +
//    4 floats apart (68 or 76: an odd count of 16-byte groups), so the K
//    loads of 8 neighbouring lanes hit 8 different 16-byte bank groups, and
//    the Q loads are broadcasts.
//  * The online softmax: a running row max (a shuffle reduction over the 16
//    lanes of a row), P = exp2((S - max) log2 e), the running sums kept per
//    lane and reduced at the end.  P and each row's rescale go to shared
//    memory.
//  * P V phase: warp w owns rows 16 w ... 16 w + 15 of O on mma.sync
//    m16n8k8 TF32.  The A fragment's key order is free (a sum over keys),
//    so logical column c of an 8-key step reads key 2 c and column c + 4 key
//    2 c + 1: P comes in as one 8-byte load a row, and V's B fragments as
//    plain 4-byte loads, conflict-free at either stride.  Each value
//    is split in registers (integer rounding, no cvt).  Each tile's
//    products are summed apart, from zero, and added to O with the rescale
//    in one fp32 FMA: a chain of 24 tensor-core sums instead of 384.  Dh
//    72 takes 9 n8 tiles a warp where Dh 64 takes 8.
//
// Measured on an H100 (PERF.md): 2.45 ms at the DiT shape, against SDPA's
// 3.02 ms; alone, the S phase takes ~1.7 ms and the P V phase ~1.3 ms
// (155 GFLOP of mma.sync TF32, ~120 TFLOP/s), and they add.  Schedules
// that computed the same bits ran slower: P V on wgmma (V split and
// transposed into a swizzled V^T tile) in flight during the next tile's S,
// two warpgroups a block, one block an SM (3.2 ms); a producer warpgroup
// for S beside a consumer warpgroup for P V (2.7 ms); an 8 x 8 S tile over
// 128-row blocks (fewer loads an FMA, but spills at 255 registers).  The
// S phase holds the kernel: on half the warps (the producer) it ran slower
// than the overlap with P V could win back.
//
// Dh 64 or 72, L a multiple of 64 and batch * heads at most 65535; anything
// else returns cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // query rows a block
constexpr int kKeys = 64;      // keys a tile
constexpr float kLog2e = 1.4426950408889634f;

// The row stride of every shared tile, in floats.
template <int kDh>
constexpr int kRowStride = kDh + 4;

// Shared memory, in floats: Q (pre-scaled), K, V, P (rows x keys), then
// each row's rescale and, at the end, its sum.
template <int kDh>
struct Smem {
  static_assert(kDh == 64 || kDh == 72, "Dh 64 or 72");
  static constexpr int kTile = kRows * kRowStride<kDh>;  // also K's, V's
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kTile;
  static constexpr int kP = kV + kTile;
  static constexpr int kAlpha = kP + kTile;
  static constexpr int kSum = kAlpha + kRows;
  static constexpr int kBytes = (kSum + kRows) * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = big + small: big rounded to TF32 (10 mantissa bits, to nearest, ties
// away, as cvt.rna) by integer arithmetic, small = x - big exact in fp32
// and passed whole: mma.sync reads a TF32 operand's top 19 bits only, so
// small is truncated there (|error| < 2^-21 |x|).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// 2^x on the special-function unit (relative error ~2^-22; -inf gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a b: a 16 x 8 (row), b 8 x 8 (col), TF32 in, fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// max and sum over the 16 lanes that share a row in the S phase
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int s = 1; s < 16; s *= 2) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  }
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int s = 1; s < 16; s *= 2) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// acc = P V for one 64-key tile, three TF32 products an 8-key step, small
// terms first: rows r_lo and r_hi = r_lo + 8, columns 8 nt + 2 c (+1).
template <int kDh>
__device__ __forceinline__ void pv_tile(float (&acc)[kDh / 8][4],
                                        const float* sP, const float* sV,
                                        int r_lo, int r_hi, int g, int c) {
  constexpr int kLd = kRowStride<kDh>;
#pragma unroll
  for (int nt = 0; nt < kDh / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < kKeys / 8; ++ks) {
    const float2 p_lo =
        *reinterpret_cast<const float2*>(sP + r_lo * kLd + ks * 8 + 2 * c);
    const float2 p_hi =
        *reinterpret_cast<const float2*>(sP + r_hi * kLd + ks * 8 + 2 * c);
    // A: (g, c) (g + 8, c) (g, c + 4) (g + 8, c + 4); logical column c is
    // key 2 c, column c + 4 key 2 c + 1
    uint32_t pb[4], ps[4];
    split(p_lo.x, pb[0], ps[0]);
    split(p_hi.x, pb[1], ps[1]);
    split(p_lo.y, pb[2], ps[2]);
    split(p_hi.y, pb[3], ps[3]);
    const float* v0 = sV + (ks * 8 + 2 * c) * kLd + g;
#pragma unroll
    for (int nt = 0; nt < kDh / 8; ++nt) {
      // B: (key 2 c, column 8 nt + g), (key 2 c + 1, the same column)
      uint32_t vb0, vs0, vb1, vs1;
      split(v0[nt * 8], vb0, vs0);
      split(v0[kLd + nt * 8], vb1, vs1);
      mma_tf32(acc[nt], ps, vb0, vb1);
      mma_tf32(acc[nt], pb, vs0, vs1);
      mma_tf32(acc[nt], pb, vb0, vb1);
    }
  }
}

// Blocks: (L / 64, batch * heads), 128 threads; two blocks an SM.
template <int kDh>
__global__ void __launch_bounds__(kThreads, 2)
    attn_fp32_sm90_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          long long q_sb, long long q_sl, long long k_sb,
                          long long k_sl, long long v_sb, long long v_sl,
                          int L, int heads, float scale) {
  using S = Smem<kDh>;
  constexpr int kLd = kRowStride<kDh>;
  constexpr int kNt = kDh / 8;  // n8 tiles of P V a warp
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem + S::kQ;
  float* sK = smem + S::kK;
  float* sV = smem + S::kV;
  float* sP = smem + S::kP;
  float* sAlpha = smem + S::kAlpha;
  float* sSum = smem + S::kSum;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int row0 = blockIdx.x * kRows;
  const float* qb = q + b * q_sb + static_cast<long long>(h) * kDh;
  const float* kb = k + b * k_sb + static_cast<long long>(h) * kDh;
  const float* vb = v + b * v_sb + static_cast<long long>(h) * kDh;
  const int n_tiles = L / kKeys;

  // one 64-key tile of K or V: 1024 16-byte chunks, 8 a thread
  auto load_tile = [&](float* dst, const float* src, long long sl, int t) {
    const long long key0 = static_cast<long long>(t) * kKeys;
#pragma unroll
    for (int n = 0; n < kKeys * kDh / 4 / kThreads; ++n) {
      const int i = tid + n * kThreads, r = i / (kDh / 4), ch = i % (kDh / 4);
      cp_async16(dst + r * kLd + ch * 4, src + (key0 + r) * sl + ch * 4);
    }
    cp_async_commit();
  };

  load_tile(sK, kb, k_sl, 0);
  // the query tile, q * scale rounded to fp32 as the plain version
  // pre-scales q
#pragma unroll
  for (int n = 0; n < kRows * kDh / 4 / kThreads; ++n) {
    const int i = tid + n * kThreads, r = i / (kDh / 4), ch = i % (kDh / 4);
    float4 x = *reinterpret_cast<const float4*>(
        qb + static_cast<long long>(row0 + r) * q_sl + ch * 4);
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *reinterpret_cast<float4*>(sQ + r * kLd + ch * 4) = x;
  }

  // S phase: rows rg + 8 r, keys jg + 16 i of each tile
  const int rg = tid / 16, jg = tid % 16;
  // P V phase: rows 16 warp + g and + 8, columns 8 nt + 2 c (+1)
  const int g = lane / 4, c = lane % 4;
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;

  float m[8], l[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
  }
  float acc_o[kNt][4];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    acc_o[nt][0] = acc_o[nt][1] = acc_o[nt][2] = acc_o[nt][3] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    // K of tile t has landed; every warp is past the P V of tile t - 1, so
    // V's buffer, P and the rescales are free
    cp_async_wait_all();
    __syncthreads();
    load_tile(sV, vb, v_sl, t);

    // S = (q * scale) k^T: one FMA chain a (row, key) over d = 0 ... Dh - 1
    float s[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r) s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.f;
#pragma unroll
    for (int dc = 0; dc < kDh / 4; ++dc) {
      float4 kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = *reinterpret_cast<const float4*>(sK + (jg + 16 * i) * kLd +
                                                 dc * 4);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sQ + (rg + 8 * r) * kLd + dc * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[r][i] = fmaf(qv.x, kv[i].x, s[r][i]);
          s[r][i] = fmaf(qv.y, kv[i].y, s[r][i]);
          s[r][i] = fmaf(qv.z, kv[i].z, s[r][i]);
          s[r][i] = fmaf(qv.w, kv[i].w, s[r][i]);
        }
      }
    }

    // the online softmax; P and the rescale of each row into shared memory
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float mx = row_max(fmaxf(fmaxf(s[r][0], s[r][1]),
                                     fmaxf(s[r][2], s[r][3])));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = fast_exp2((m[r] - m_new) * kLog2e);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = fast_exp2((s[r][i] - m_new) * kLog2e);
        sum += p;
        sP[(rg + 8 * r) * kLd + jg + 16 * i] = p;
      }
      l[r] = l[r] * alpha + sum;
      if (jg == 0) sAlpha[rg + 8 * r] = alpha;
    }

    // V of tile t has landed, P and the rescales are written, and every
    // warp is past its S phase, so K's buffer is free
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < n_tiles) load_tile(sK, kb, k_sl, t + 1);

    // O = O * alpha + P V, the tile's products summed apart first (a chain
    // of 24 products: the tensor cores' sums, chained over all of L,
    // drifted to 1.6e-5 of scale at the DiT shape, against 1.7e-6 so)
    float acc_t[kNt][4];
    pv_tile<kDh>(acc_t, sP, sV, r_lo, r_hi, g, c);
    const float a_lo = sAlpha[r_lo], a_hi = sAlpha[r_hi];
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      acc_o[nt][0] = fmaf(acc_o[nt][0], a_lo, acc_t[nt][0]);
      acc_o[nt][1] = fmaf(acc_o[nt][1], a_lo, acc_t[nt][1]);
      acc_o[nt][2] = fmaf(acc_o[nt][2], a_hi, acc_t[nt][2]);
      acc_o[nt][3] = fmaf(acc_o[nt][3], a_hi, acc_t[nt][3]);
    }
  }

  // each row's sum, from the 16 lanes' partial sums
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float total = row_sum(l[r]);
    if (jg == 0) sSum[rg + 8 * r] = total;
  }
  __syncthreads();
  const float l_lo = sSum[r_lo], l_hi = sSum[r_hi];
  const long long o_sl = static_cast<long long>(heads) * kDh;
  float* ob = o + static_cast<long long>(b) * L * o_sl +
              static_cast<long long>(h) * kDh;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    const int col = nt * 8 + 2 * c;
    *reinterpret_cast<float2*>(ob + (row0 + r_lo) * o_sl + col) =
        make_float2(acc_o[nt][0] / l_lo, acc_o[nt][1] / l_lo);
    *reinterpret_cast<float2*>(ob + (row0 + r_hi) * o_sl + col) =
        make_float2(acc_o[nt][2] / l_hi, acc_o[nt][3] / l_hi);
  }
}

template <int kDh>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   long long q_sb, long long q_sl, long long k_sb,
                   long long k_sl, long long v_sb, long long v_sl, int batch,
                   int L, int heads, float scale, cudaStream_t stream) {
  // two blocks an SM: all of the SM's memory as shared memory
  cudaError_t err = cudaFuncSetAttribute(
      attn_fp32_sm90_kernel<kDh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<kDh>::kBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(attn_fp32_sm90_kernel<kDh>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid(L / kRows, batch * heads);
  attn_fp32_sm90_kernel<kDh><<<grid, kThreads, Smem<kDh>::kBytes, stream>>>(
      q, k, v, o, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, L, heads, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (batch, L, heads, head_dim) fp32 with the given batch and row
// strides (in elements); o: (batch, L, heads, head_dim) fp32, contiguous;
// head_dim 64 or 72.  Returns a cudaError_t (0 on success).
extern "C" int dimsum_full_attention_f32(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_sl, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, int batch, int L, int heads, int head_dim, float scale,
    void* stream) {
  if (L <= 0 || L % kRows != 0 || L % kKeys != 0 || batch <= 0 ||
      heads <= 0 || batch * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<64>(qf, kf, vf, of, q_sb, q_sl, k_sb,
                                         k_sl, v_sb, v_sl, batch, L, heads,
                                         scale, s));
    case 72:
      return static_cast<int>(launch<72>(qf, kf, vf, of, q_sb, q_sl, k_sb,
                                         k_sl, v_sb, v_sl, batch, L, heads,
                                         scale, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
