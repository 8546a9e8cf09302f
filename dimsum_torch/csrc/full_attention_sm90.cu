// Softmax attention over a whole sequence, bf16 at head size 64 or 72,
// written for Hopper's TMA and warpgroup matrix multiply (sm_90a).
//
// Replaces, for bf16 inputs with Dh 64 or 72, the Pallas TPU kernel
// dimsum_tpu/ops/full_attention.py::_attn_kernel (pallas_call in
// _build_call).  Dh 64: the attention of DiM-L/2 at 512 px, the DiTBlock (16
// heads, every 4th block) and CrossAttentionFusion (8 heads on each half,
// twice per combined block), 36 calls a CFG forward.  Dh 72: every
// 1152-wide model at 512 px, DiT-XL/2 (16 heads, 28 calls a forward) and
// DiM-XL/2 (16 DiT heads, 8 cross heads on a 576-wide half; 54 calls).
// fp32 inputs go to csrc/full_attention_f32.cu, bf16 at Dh 80-128 stays
// with csrc/full_attention.cu.  Per (batch, head), as the plain version
// computes it:
//
//   S = (q * scale) k^T                        fp32 sums
//   P = exp(S - rowmax(S))                     fp32
//   O = (P rounded to bf16) v / rowsum(P)      fp32 sums, rounded to bf16
//
// Layout: q, k, v are (batch, L, heads, Dh) with each (heads, Dh) row packed
// and any batch and row strides (multiples of 8 elements, 16-byte aligned):
// the modules slice them out of qkv projections, rows 3 * heads * Dh apart,
// and the kernel reads them there through 4-D tensor maps (Dh, heads, L,
// batch).  O is (batch, L, heads, Dh), contiguous.
//
// What bounds it on an H100: 4 L^2 Dh flop per (batch, head), 103 GFLOP at
// the DiT shape (24, 1024, 16, 64), 0.104 ms at 989 TFLOP/s on the tensor
// cores, and 51.5 GFLOP, 0.052 ms at the cross shape (24, 1024, 8, 64);
// q, k, v read once and o written once take 0.060 / 0.030 ms at 3.35 TB/s,
// the L^2 exp 0.096 / 0.048 ms on the special-function units.  So the
// tensor cores bound it, the exponentials close behind.  At DiT-XL/2's
// (8, 1024, 16, 72): 38.7 GFLOP, 0.039 ms, the exp 0.032 ms.  Measured, it
// runs at ~2.3x those bounds at Dh 64, and moving exponentials to the FMA
// pipe made it slower: the softmax's other instructions, not the
// exponential unit, hold it there (PERF.md).
//
// The TPU kernel keeps a head's whole (L, L) fp32 score tile in VMEM (4 MB at
// L 1024).  No SM holds that, so the softmax is online (a running row max and
// sum, the output rescaled when the max grows; P is rounded to bf16 against
// the running max, where the plain version uses the final one).  The design
// answers what held csrc/full_attention.cu (mma.sync, 64-row blocks) to 20%
// of its bound:
//
//  * A block owns 128 query rows, one consumer warpgroup (4 warps) per 64
//    rows.  The two warpgroups share each K/V tile in shared memory, so K
//    and V are read from L2 once per 128 rows.
//  * Both products are wgmma.mma_async (bf16 in, fp32 sums): S = Q K^T with
//    both operands read from shared memory (Q and K are both K-major), and
//    O += P V with P in registers (the S accumulator repacked to bf16 is the
//    register-A layout) and V read from shared memory as an MN-major B
//    operand (the trans-b bit).
//  * K and V tiles of 64 keys stream through a ring of 4 buffers in
//    swizzled shared memory, loaded by TMA (one thread issues the copies)
//    with completion on mbarriers; the warpgroups release a buffer through
//    a second mbarrier.  A 64-element bf16 row is 128 bytes, one 128-byte
//    swizzle atom: the layout TMA writes is the one wgmma's descriptors
//    read.  Q is loaded once the same way; O leaves through shared memory
//    and one TMA store per warpgroup.
//  * Dh 72: a 144-byte row is more than one 128-byte atom, and a 128-byte
//    swizzled TMA box is at most 128 bytes wide.  So each of Q, K, V and O
//    is two column pieces with their own tensor maps and descriptors: the
//    head, columns 0-63, 128-byte swizzled as at Dh 64, and the tail,
//    columns 64-79 in 32-byte rows, 32-byte swizzled, whose columns 72-79
//    TMA fills with zeros (the maps' inner extent is 72) and the O store
//    leaves out.  S takes four k-steps of 16 on the heads and one on the
//    tails (k 80: the padding adds 11% to S's tensor work); P V is an n64
//    product on V's head and an n8 product on the tail's columns 64-71 (n
//    72; n8 measured ~1% faster than n16 with the same bits, PERF.md).
//    The ring stays at 4 stages: 20 KB a stage, 101 KB a block, two
//    blocks an SM (120 registers a thread, no spill).
//  * The softmax scale: where it is a power of two (Dh 64 gives 2^-3), q *
//    scale is exact in bf16, so S = scale * (q k^T) exactly and the kernel
//    folds scale * log2(e) into the one FFMA of each exponent.  Any other
//    scale (Dh 72: 72^-1/2) is applied to Q in shared memory and rounded to
//    bf16 first, as the plain version does.
//  * Within a warpgroup the S product of tile t and the P V product of tile
//    t - 1 are in flight together, so the softmax of tile t runs while the
//    tensor cores finish P V (two P register sets alternate); across the
//    two warpgroups of a block and the two blocks an SM holds (~110
//    registers a thread), one warpgroup's softmax overlaps the others'
//    products without explicit scheduling.
//
// No warp specialisation: thread 0 of the block issues every TMA load
// between its own tiles.  Dh 64 or 72, L a multiple of 128, batch * heads
// at most 65535; anything else returns cudaErrorInvalidValue.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kHeadCols = 64;       // columns of the head piece
constexpr int kRowBytes = kHeadCols * 2;  // one 128-byte swizzle atom
constexpr int kTailCols = 16;       // columns of the tail piece (Dh 72)
constexpr int kTailRowBytes = kTailCols * 2;  // one 32-byte swizzle atom
constexpr int kWgRows = 64;         // query rows per consumer warpgroup
constexpr int kWarpgroups = 2;      // consumer warpgroups a block
constexpr int kRows = kWarpgroups * kWgRows;  // query rows a block
constexpr int kKeys = 64;           // keys a K/V tile
constexpr int kStages = 4;          // K/V tiles in the ring
constexpr int kSlices = kKeys / 16; // 16-key slices of P V a tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase with this parity has completed.  A barrier
// starts in phase 0; its n-th completion (n = 0, 1, ...) ends phase n, so
// the n-th use of a ring stage waits with parity n & 1: the bit flips each
// time the ring wraps.
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

// ---- TMA -------------------------------------------------------------------

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Issue one TMA store; `tma_store_wait` commits the issued stores and
// waits until they have read shared memory.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  // the shared memory must stay until the store has read it
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory (plain stores) made visible to the
// async proxy (wgmma operand reads, TMA stores) that reads them next.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One warpgroup's 128 threads; barrier 0 is __syncthreads'.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor for a swizzled tile: start address >> 4
// (bits 0-13), leading byte offset 16 >> 4 (bits 16-29), stride byte offset
// (bits 32-45: eight rows, one swizzle period), layout type (bits 62-63),
// base offset 0 (the tile starts on a swizzle period).
//
// sw128_desc: 128-byte rows, 128-byte swizzle (type 1), eight rows 1024
// bytes, tiles on 1024 bytes.  K-major operands (Q as A, K as B of S = Q
// K^T): rows are M or N, the 64 elements of a row are K.  The leading
// offset is unused under swizzling; the stride offset steps 8 rows.  A
// k-step of 16 elements moves the start address 32 bytes inside the
// swizzle atom (the hardware applies the XOR pattern to the full address,
// so the tile base must sit on 1024 bytes).
//
// MN-major operand (V as B of O += P V): rows are K (keys), the 64 elements
// of a row are N (Dh), contiguous.  Here the two offsets swap roles: the
// stride offset steps 8 K-rows (1024 bytes again), the leading offset would
// step to the next 64-wide N atom, which an N of 64 never takes.  A k-step
// of 16 keys moves the start address 16 rows, 2048 bytes, and the
// instruction's trans-b bit says B is MN-major.  So one descriptor formula
// serves both; only the k-step and the trans-b bit differ.
//
// sw32_desc: the Dh-72 tails, 32-byte rows, 32-byte swizzle (type 3; the
// 16-byte chunk of row r at chunk ^ ((r >> 2) & 1)), eight rows 256 bytes,
// tiles on 256 bytes.  As a K-major operand a row is one k-step of 16; as
// the MN-major V tail a row is N = 16 (one atom) and a k-step of 16 keys
// moves the start 512 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) |
         (static_cast<uint64_t>(3) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie each accumulator register to this point of the program: the compiler
// must not move a read of the registers above the wgmma wait, nor a write
// below the next wgmma's issue.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Read-only: a use of each register at this point, which defines none.
// It keeps a wgmma's register operand alive (unreused) until its wait.
__device__ __forceinline__ void use_regs(const uint32_t (&a)[kSlices][4]) {
#pragma unroll
  for (int n = 0; n < kSlices; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(a[n][i]) : "memory");
  }
}

#define DIMSUM_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define DIMSUM_D32_OPS(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d (64 x 64, fp32) = [d +] A B, A 64 x 16 and B 16 x 64 both K-major from
// shared memory.  Thread t of the warpgroup holds, in d[4 j + e], row
// 16 (t / 32) + (t % 32) / 4 + 8 (e / 2) and column 8 j + 2 (t % 4) + e % 2.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DIMSUM_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : DIMSUM_D32_OPS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A 64 x 16 in registers (bf16 pairs; per warp the layout of
// mma.sync m16n8k16's A), B 16 x 64 MN-major from shared memory (trans-b).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DIMSUM_D32
      ", {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : DIMSUM_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d += A B on V's tail: as wgmma_rs at n8, B 16 x 8 MN-major (columns
// 64-71) from the tail's 32-byte rows.  d holds the columns of the n64
// layout's first 8-column group.
__device__ __forceinline__ void wgmma_rs_tail(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// Two floats as one bf16x2 register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (relative error ~2^-22; -inf gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The rescale a tile's softmax asks of the running output and sum.
struct Rescale {
  float a_lo, a_hi, sum_lo, sum_hi;
  template <int N>
  __device__ __forceinline__ void scale(float (&o)[N]) const {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      o[4 * j] *= a_lo;
      o[4 * j + 1] *= a_lo;
      o[4 * j + 2] *= a_hi;
      o[4 * j + 3] *= a_hi;
    }
  }
  __device__ __forceinline__ void apply(float (&o)[32], float& l_lo,
                                        float& l_hi) const {
    l_lo = l_lo * a_lo + sum_lo;
    l_hi = l_hi * a_hi + sum_hi;
    scale(o);
  }
};

// The online softmax of one tile on rows g (entries e < 2 of each 4) and
// g + 8 (e >= 2): the new running max, and P = exp2(S * scale log2 e - max
// * scale log2 e), one FFMA and one exp2 per entry, summed unrounded and
// rounded to bf16 as P V's A operand (the accumulator's 8-column groups
// 2 kq and 2 kq + 1 are the A fragment of the 16-key slice kq).
__device__ __forceinline__ Rescale softmax_tile(const float (&sc)[32],
                                                uint32_t (&pf)[kSlices][4],
                                                float exp_scale, float& m_lo,
                                                float& m_hi) {
  float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx_lo = quad_max(mx_lo);
  mx_hi = quad_max(mx_hi);
  Rescale r;
  r.a_lo = fast_exp2((m_lo - mx_lo) * exp_scale);
  r.a_hi = fast_exp2((m_hi - mx_hi) * exp_scale);
  m_lo = mx_lo;
  m_hi = mx_hi;
  const float off_lo = m_lo * exp_scale, off_hi = m_hi * exp_scale;
  r.sum_lo = r.sum_hi = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float* e = &sc[4 * j];
    const float p0 = fast_exp2(fmaf(e[0], exp_scale, -off_lo));
    const float p1 = fast_exp2(fmaf(e[1], exp_scale, -off_lo));
    const float p2 = fast_exp2(fmaf(e[2], exp_scale, -off_hi));
    const float p3 = fast_exp2(fmaf(e[3], exp_scale, -off_hi));
    r.sum_lo += p0 + p1;
    r.sum_hi += p2 + p3;
    pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
    pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
  }
  return r;
}

// Shared memory: Q's head (128 rows), the K ring's and the V ring's heads;
// at Dh 72 the tails of Q, the K ring and the V ring; then the mbarriers
// full[kStages], empty[kStages] and q (8 bytes each); plus 1024 bytes to
// align the base.  Every head piece starts on 1024 bytes, every tail on 256.
template <int kDh>
struct Smem {
  static_assert(kDh == 64 || kDh == 72, "Dh 64 or 72");
  static constexpr bool kTail = kDh > kHeadCols;
  static constexpr int kTailRow = kTail ? kTailRowBytes : 0;
  static constexpr int kQBytes = kRows * kRowBytes;
  static constexpr int kTileBytes = kKeys * kRowBytes;  // one K or V head
  static constexpr int kQTailBytes = kRows * kTailRow;
  static constexpr int kTileTailBytes = kKeys * kTailRow;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kQT = kV + kStages * kTileBytes;
  static constexpr int kKT = kQT + kQTailBytes;
  static constexpr int kVT = kKT + kStages * kTileTailBytes;
  static constexpr int kBars = kVT + kStages * kTileTailBytes;
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
};

// The tensor maps of Q, K, V and O: the heads (columns 0-63), and at Dh 72
// the tails (columns 64-79, 72-79 outside the tensor).
struct Maps {
  CUtensorMap q, k, v, o;
};

// The S product, the P V product and the rescale of one warpgroup, at Dh
// 64 (the head alone) or 72 (head and tail).
template <int kDh>
struct Products {
  static constexpr bool kTail = Smem<kDh>::kTail;
  uint64_t dq, dq_tail;  // this warpgroup's Q rows: head and tail

  // S = q k^T for one tile of 64 keys, 4 k-steps over the head (a k-step
  // is 16 elements, 32 bytes) and one over the tail, committed as one
  // group.
  __device__ __forceinline__ void issue_s(float (&sc)[32], uint32_t k_head,
                                          uint32_t k_tail) const {
    const uint64_t dk = sw128_desc(k_head);
#pragma unroll
    for (int ks = 0; ks < kHeadCols / 16; ++ks) {
      wgmma_ss(sc, dq + 2 * ks, dk + 2 * ks, ks > 0);
    }
    if constexpr (kTail) wgmma_ss(sc, dq_tail, sw32_desc(k_tail), 1);
    wgmma_commit();
  }

  // O += P V over the tile's 16-key slices, committed as one group: V's
  // k-step is 16 rows, 2048 bytes of the head and 512 of the tail.
  __device__ __forceinline__ void issue_pv(float (&o)[32],
                                           float (&ot)[4],
                                           const uint32_t (&pf)[kSlices][4],
                                           uint32_t v_head,
                                           uint32_t v_tail) const {
    const uint64_t dv = sw128_desc(v_head);
#pragma unroll
    for (int kk = 0; kk < kSlices; ++kk) {
      wgmma_rs(o, pf[kk], dv + kk * (16 * kRowBytes >> 4));
    }
    if constexpr (kTail) {
      const uint64_t dvt = sw32_desc(v_tail);
#pragma unroll
      for (int kk = 0; kk < kSlices; ++kk) {
        wgmma_rs_tail(ot, pf[kk], dvt + kk * (16 * kTailRowBytes >> 4));
      }
    }
    wgmma_commit();
  }
};

// Blocks: (L / 128, batch * heads); 256 threads, warpgroup w owns query rows
// row0 + 64 w ... + 63.  Lane l of warp u of a warpgroup holds rows 16 u +
// l / 4 and that + 8, and columns 2 (l % 4) (+1) of every 8-column group,
// of S, P and O.  A thread needs ~110 registers (a second P in flight), so
// an SM holds two blocks.
template <int kDh>
__global__ void __launch_bounds__(kWarpgroups * 128, 2)
    attn_sm90_kernel(const __grid_constant__ Maps head,
                     const __grid_constant__ Maps tail, int L, int heads,
                     float exp_scale, float q_scale, int prescale) {
  using S = Smem<kDh>;
  constexpr bool kTail = S::kTail;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzling repeats every 1024 bytes: tiles start on that
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + S::kBars, empty0 = full0 + 8 * kStages;
  const uint32_t qbar = empty0 + 8 * kStages;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, g = lane / 4, c = lane % 4;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int row0 = blockIdx.x * kRows;
  const int n_tiles = L / kKeys;
  constexpr uint32_t kKvBytes = 2 * (S::kTileBytes + S::kTileTailBytes);

  auto load_kv = [&](int tile) {
    const int s = tile % kStages;
    mbar_expect_tx(full0 + 8 * s, kKvBytes);
    tma_load_4d(base + S::kK + s * S::kTileBytes, &head.k, full0 + 8 * s, 0,
                h, tile * kKeys, b);
    tma_load_4d(base + S::kV + s * S::kTileBytes, &head.v, full0 + 8 * s, 0,
                h, tile * kKeys, b);
    if constexpr (kTail) {
      tma_load_4d(base + S::kKT + s * S::kTileTailBytes, &tail.k,
                  full0 + 8 * s, kHeadCols, h, tile * kKeys, b);
      tma_load_4d(base + S::kVT + s * S::kTileTailBytes, &tail.v,
                  full0 + 8 * s, kHeadCols, h, tile * kKeys, b);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * kWarpgroups);  // one per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qbar, S::kQBytes + S::kQTailBytes);
    tma_load_4d(base, &head.q, qbar, 0, h, row0, b);
    if constexpr (kTail) {
      tma_load_4d(base + S::kQT, &tail.q, qbar, kHeadCols, h, row0, b);
    }
    for (int t = 0; t < kStages - 1 && t < n_tiles; ++t) load_kv(t);
  }
  __syncwarp();

  const uint32_t q_tile = base + wg * kWgRows * kRowBytes;
  const uint32_t q_tail = base + S::kQT + wg * kWgRows * kTailRowBytes;
  mbar_wait(qbar, 0);
  if (prescale) {
    // q * scale rounded to bf16, as the plain version pre-scales q.  The
    // swizzle only permutes 16-byte chunks, so each thread rescales whole
    // chunks wherever they lie (the tail's zero columns stay zero).  These
    // are generic-proxy writes that wgmma (the async proxy) reads next:
    // fence, then the warpgroup's barrier.
    auto rescale = [&](uint4* chunks, int n) {
      for (int i = tid % 128; i < n; i += 128) {
        uint4 raw16 = chunks[i];
        __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&raw16);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(pr[e]);
          pr[e] = __floats2bfloat162_rn(f.x * q_scale, f.y * q_scale);
        }
        chunks[i] = raw16;
      }
    };
    rescale(reinterpret_cast<uint4*>(smem + wg * kWgRows * kRowBytes),
            kWgRows * kRowBytes / 16);
    if constexpr (kTail) {
      rescale(reinterpret_cast<uint4*>(smem + S::kQT +
                                       wg * kWgRows * kTailRowBytes),
              kWgRows * kTailRowBytes / 16);
    }
    fence_proxy_async();
    warpgroup_sync(wg);
  }
  Products<kDh> mm;
  mm.dq = sw128_desc(q_tile);
  mm.dq_tail = sw32_desc(q_tail);
  auto k_tile = [&](int t) {
    return base + S::kK + (t % kStages) * S::kTileBytes;
  };
  auto v_tile = [&](int t) {
    return base + S::kV + (t % kStages) * S::kTileBytes;
  };
  auto k_tail = [&](int t) {
    return base + S::kKT + (t % kStages) * S::kTileTailBytes;
  };
  auto v_tail = [&](int t) {
    return base + S::kVT + (t % kStages) * S::kTileTailBytes;
  };
  // thread 0 loads tile `next` once every consumer warp has released the
  // tile that used its stage before (that stage's (next / kStages - 1)-th
  // release: the parity flips as the ring wraps)
  auto refill = [&](int next) {
    if (tid == 0 && next < n_tiles) {
      if (next >= kStages) {
        mbar_wait(empty0 + 8 * (next % kStages), ((next / kStages) - 1) & 1);
      }
      load_kv(next);
    }
    __syncwarp();  // wgmma is .aligned: warp 0 reconverges first
  };
  auto wait_tile = [&](int t) {
    mbar_wait(full0 + 8 * (t % kStages), (t / kStages) & 1);
  };
  // this warp has finished reading tile t's stage
  auto release = [&](int t) {
    if (lane == 0) mbar_arrive(empty0 + 8 * (t % kStages));
  };

  // the output: columns 0-63 in o, at Dh 72 columns 64-71 in ot
  float o[32], ot[4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) ot[i] = 0.f;
  // running max (in units of q k^T) and partial sum of rows g and g + 8
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F, l_lo = 0.f, l_hi = 0.f;
  float sc[32];
  uint32_t pf[kSlices][4];
  Rescale a;
  auto rescale_out = [&]() {
    a.apply(o, l_lo, l_hi);
    if constexpr (kTail) a.scale(ot);
  };
  auto fence_out = [&]() {
    fence_regs(o);
    if constexpr (kTail) fence_regs(ot);
  };
  // ot's rescale before the wgmma fence that precedes its next product:
  // left free, the compiler sank it between the head's and the tail's
  // P V products, and ptxas made the warpgroup wait there (C7519)
  auto pin_tail = [&]() {
    if constexpr (kTail) fence_regs(ot);
  };

  // S of tile t and P V of tile t - 1 in flight together: the softmax of
  // tile t runs while the tensor cores finish P V.  Tile t's stage is
  // released in iteration t + 1, so the refill runs one tile shorter.  P
  // alternates between two register sets, so that no ordinary instruction
  // writes a register of the P V product in flight (ptxas would serialise
  // the wgmma otherwise).
  uint32_t pn[kSlices][4];
  wait_tile(0);
  wgmma_fence();  // sc was last touched by ordinary instructions
  mm.issue_s(sc, k_tile(0), k_tail(0));
  wgmma_wait<0>();
  fence_regs(sc);
  a = softmax_tile(sc, pf, exp_scale, m_lo, m_hi);
  rescale_out();
  auto step = [&](int t, uint32_t (&cur)[kSlices][4],
                  uint32_t (&next)[kSlices][4]) {
    refill(t + kStages - 2);
    wait_tile(t);
    // cur and o were written by ordinary instructions: order them before
    // the asynchronous products
    pin_tail();
    wgmma_fence();
    mm.issue_s(sc, k_tile(t), k_tail(t));
    mm.issue_pv(o, ot, cur, v_tile(t - 1), v_tail(t - 1));
    wgmma_wait<1>();  // groups retire in order: S is done, P V may not be
    fence_regs(sc);
    a = softmax_tile(sc, next, exp_scale, m_lo, m_hi);
    wgmma_wait<0>();
    fence_out();
    use_regs(cur);  // the P V operand: not reused for `next` above
    release(t - 1);
    rescale_out();
  };
  int t = 1;
  for (; t + 1 < n_tiles; t += 2) {
    step(t, pf, pn);
    step(t + 1, pn, pf);
  }
  // the last tile's P V, from whichever set holds its P
  if (t < n_tiles) {
    step(t, pf, pn);
    pin_tail();
    wgmma_fence();
    mm.issue_pv(o, ot, pn, v_tile(n_tiles - 1), v_tail(n_tiles - 1));
  } else {
    pin_tail();
    wgmma_fence();
    mm.issue_pv(o, ot, pf, v_tile(n_tiles - 1), v_tail(n_tiles - 1));
  }
  wgmma_wait<0>();
  fence_out();

  // O / rowsum, rounded to bf16, into this warpgroup's Q rows (their last
  // reader, the final S product, has completed) in the swizzled layouts
  // the output's tensor maps store from: in the head, 16-byte chunk j of
  // row r at chunk j ^ (r % 8); in the tail, chunk 0 (columns 64-71; chunk
  // 1 would hold columns 72-79, which the store leaves out) at
  // (r >> 2) & 1.
  // The head's writes are conflict-free: the 8 rows of a warp's store fill
  // the 32 banks.
  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  unsigned char* q_rows = smem + wg * kWgRows * kRowBytes;
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int chunk = (j ^ g) * 16 + 4 * c;  // r % 8 == g for both rows
    *reinterpret_cast<uint32_t*>(q_rows + r_lo * kRowBytes + chunk) =
        pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
    *reinterpret_cast<uint32_t*>(q_rows + r_hi * kRowBytes + chunk) =
        pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
  }
  if constexpr (kTail) {
    unsigned char* t_rows = smem + S::kQT + wg * kWgRows * kTailRowBytes;
    const int chunk = ((g >> 2) & 1) * 16 + 4 * c;  // (r >> 2) & 1 == g >> 2
    *reinterpret_cast<uint32_t*>(t_rows + r_lo * kTailRowBytes + chunk) =
        pack_bf16(ot[0] * inv_lo, ot[1] * inv_lo);
    *reinterpret_cast<uint32_t*>(t_rows + r_hi * kTailRowBytes + chunk) =
        pack_bf16(ot[2] * inv_hi, ot[3] * inv_hi);
  }
  // generic-proxy writes that the TMA store (async proxy) reads
  fence_proxy_async();
  warpgroup_sync(wg);
  if (tid % 128 == 0) {
    tma_store_4d(&head.o, q_tile, 0, h, row0 + wg * kWgRows, b);
    if constexpr (kTail) {
      tma_store_4d(&tail.o, q_tail, kHeadCols, h, row0 + wg * kWgRows, b);
    }
    tma_store_wait();
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
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A (batch, L, heads, dh) bf16 tensor with the given batch and row strides
// (elements) as a 4-D map (dh, heads, L, batch), boxes of `rows` rows of one
// head and `cols` columns: 64, 128B-swizzled in shared memory (a head
// piece), or 16, 32B-swizzled (a tail piece).
bool make_map(CUtensorMap* map, const void* ptr, long long sb, long long sl,
              int batch, int L, int heads, int dh, int rows, int cols) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(sl) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estrides[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            cols == kHeadCols ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The four maps of one column piece (`cols` wide).
bool make_maps(Maps* m, const void* q, const void* k, const void* v, void* o,
               long long q_sb, long long q_sl, long long k_sb, long long k_sl,
               long long v_sb, long long v_sl, int batch, int L, int heads,
               int dh, int cols) {
  const long long o_sl = static_cast<long long>(heads) * dh;
  return make_map(&m->q, q, q_sb, q_sl, batch, L, heads, dh, kRows, cols) &&
         make_map(&m->k, k, k_sb, k_sl, batch, L, heads, dh, kKeys, cols) &&
         make_map(&m->v, v, v_sb, v_sl, batch, L, heads, dh, kKeys, cols) &&
         make_map(&m->o, o, L * o_sl, o_sl, batch, L, heads, dh, kWgRows,
                  cols);
}

template <int kDh>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long q_sb, long long q_sl, long long k_sb,
                   long long k_sl, long long v_sb, long long v_sl, int batch,
                   int L, int heads, float scale, cudaStream_t stream) {
  if (L % kRows != 0) return cudaErrorInvalidValue;
  Maps head, tail;
  if (!make_maps(&head, q, k, v, o, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl,
                 batch, L, heads, kDh, kHeadCols)) {
    return cudaErrorInvalidValue;
  }
  if (Smem<kDh>::kTail) {
    if (!make_maps(&tail, q, k, v, o, q_sb, q_sl, k_sb, k_sl, v_sb, v_sl,
                   batch, L, heads, kDh, kTailCols)) {
      return cudaErrorInvalidValue;
    }
  } else {
    tail = head;  // unread
  }
  // a power-of-two scale folds into the exponent exactly (q * scale is
  // exact in bf16); any other is applied to q in shared memory first
  int e;
  const bool pow2 = scale > 0.f && frexpf(scale, &e) == 0.5f;
  const float exp_scale = pow2 ? scale * kLog2e : kLog2e;
  cudaError_t err = cudaFuncSetAttribute(
      attn_sm90_kernel<kDh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<kDh>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(L / kRows, batch * heads);
  attn_sm90_kernel<kDh><<<grid, kWarpgroups * 128, Smem<kDh>::kBytes,
                          stream>>>(head, tail, L, heads, exp_scale, scale,
                                    pow2 ? 0 : 1);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: (batch, L, heads, head_dim) bf16 with the given batch and row
// strides (in elements); o: (batch, L, heads, head_dim) bf16, contiguous;
// head_dim 64 or 72.  Returns a cudaError_t (0 on success).
extern "C" int dimsum_full_attention_sm90(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_sl, long long k_sb, long long k_sl, long long v_sb,
    long long v_sl, int batch, int L, int heads, int head_dim, float scale,
    void* stream) {
  if (L <= 0 || batch <= 0 || heads <= 0 || batch * heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, o, q_sb, q_sl, k_sb, k_sl,
                                         v_sb, v_sl, batch, L, heads, scale,
                                         s));
    case 72:
      return static_cast<int>(launch<72>(q, k, v, o, q_sb, q_sl, k_sb, k_sl,
                                         v_sb, v_sl, batch, L, heads, scale,
                                         s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
