// (Gate-add +) residual add + RMS/LayerNorm + adaLN modulate for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel dimsum_tpu/ops/norms.py::_norm_mod_kernel
// (pallas_call in _norm_mod_pallas), which DiM runs with the fused-norm
// switches: the combined block's norm_2, the DiT block's two LayerNorms,
// the FinalLayer's, and the deferred top add + norm of the pending tail.
// Per row of D channels, with per-batch vectors read at row / L:
//
//   total = base (+ gate * branch) (+ res)    fp32, each op rounded once
//   total -> total's type; the norm reads that rounded value
//   out   = Norm(total) * w (+ b)             fp32, then out's type
//   out   = out * (1 + scale) + shift         in out's type, rounded after
//                                             each op, as PyTorch and JAX
//                                             evaluate it in bf16
//
// base, branch, gate, shift, scale and out share one type (fp32 or bf16);
// w and b are fp32; res and total are fp32 or base's type (a bf16 residual
// stream, residual_in_fp32=False: the residual's type is a compile-time
// switch, kResT).  A null pointer
// leaves its operand out.  The per-batch vectors come with their own row
// strides: DiM slices them out of one adaLN projection (row stride 3 D or
// 6 D), and the kernel reads them where they lie.
//
// What bounds it on an H100: device memory.  At DiM-L/2's 256-px rows
// (24 x 256 x 1024, bf16) the norm_2 site moves base, branch, out and total
// (50.3 MB, 15.0 us at 3.35 TB/s) and does ~10 flop a value; at 512 px
// (24 x 1024 x 1024) 201 MB, 60.1 us.  The first design (one warp a row,
// one row a warp, 4 warps a block) ran at 48% of that bound; this one
// answers its four faults:
//
// - Per-batch vectors reloaded on every row, after the reduction.  The
//   run's per-batch vectors (gate, shift and the rounded 1 + scale, the
//   value the modulation reads on every element) and the per-channel w
//   and b are staged once a block into shared memory as fp32, laid out so
//   that a lane reads its columns of a vector with conflict-free 16-byte
//   loads; all of a thread's staging loads are issued before its stores,
//   one round trip at D <= 1024.
// - One row a warp, then exit: no overlap of the next row's loads with
//   this row's reduction and stores.  Each block takes one run of rows
//   inside a batch: each batch's L rows are cut into k runs that differ by
//   at most one row, k = (blocks the card holds at once) / B, so the grid
//   is one wave and no run crosses a batch.  Warp w walks the run's rows
//   w, w + nw, ...: one lane asks for its next row of base, branch and res
//   by 1-D TMA bulk copies (cp.async.bulk, completing on the warp's
//   mbarrier) as soon as the warp has read the current row out of its
//   stage, so the next row is in flight while this one is reduced and
//   stored.
// - 8-byte bf16 accesses.  Every global load of a row is a bulk copy and
//   every store a 16-byte vector (8 bf16 or 4 fp32 a lane).  Lane l holds
//   columns 32 v c + v l .. + v - 1 (v values a 16-byte vector) of each
//   chunk c; where D % (32 v) != 0 (bf16 at D 128, 1152) the last chunk
//   spans half the lanes.
// - A warm L2 in back-to-back timing.  Measured both ways: 256-px norm_2
//   with 128 MB written between launches, and the 512-px rows, whose
//   inputs exceed the L2.
//
// Both moments are reduced with warp shuffles over registers; LayerNorm
// keeps its two passes (the mean, then the centred variance, as the TPU
// kernel takes them) over the registers, not over device memory.  A block
// has 8 warps where their stages and the vectors fit in 227 KB of shared
// memory (fewer at D 4096 with every operand).
//
// Device time (torch.profiler, `chip_smoke.py` kernel-norm, H100 80GB HBM3
// at 700.00 W): norm_2 0.0196 ms at 256 px (77% of the bound), 0.0221 with
// a cold L2 (68%), 0.0806 at 512 px (75%); the first design, timed beside
// the others below, 0.0318 / 0.0976; DiT h2 0.0198 / 0.0810 (76% / 74%);
// h1 / Final 0.0139 (81%), the deferred top 0.0324 (81%); fp32 80-83%.
// Designs timed against each other in turns (norm_mod_designs.py, in the
// commit that brought this design): a ring of 2 stages a warp, 0.0212 ms
// at 256-px norm_2; 3 stages 0.0234; 2 stages at one block an SM 0.0238;
// 4 warps a block 0.0215 (one stage) and 0.0222 (two), against 0.0198 for
// this design (8 warps, one stage); at 512 px all within 3%.  A deeper
// ring asks for more rows at once, and in a one-wave kernel that
// saturates device memory every warp's first row then lands later.
// PyTorch's add (two reads, one write) reaches 3.02 TB/s at the 512-px
// size (90%); this kernel 2.5 TB/s.
//
// The products and sums that PyTorch evaluates as separate ops use
// __fmul_rn / __fadd_rn, so nvcc does not contract them into FMAs and the
// fp32 total is the plain version's bit for bit.
//
// D is a multiple of 128 up to 4096 and base, branch, res, out and total
// are 16-byte aligned; anything else returns cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxWarps = 8;      // rows in flight a block, one a warp
constexpr int kSmemMax = 232448;  // what a block may ask for

struct Params {
  const void* base;
  const void* branch;
  const void* gate;
  const void* res;
  const float* w;
  const float* b;
  const void* shift;
  const void* scale;
  void* out;
  void* total;
  long long gate_sb, shift_sb, scale_sb;
  int L, D, k;  // k runs a batch
  int nw;
  int total_f32, is_rms;
  float eps;
  // shared memory: the staged vectors (dp floats each, at these float
  // offsets; -1 when absent), then each warp's row stage (base, branch,
  // res at byte offsets 0, off_branch, off_res), then its mbarrier
  int dp, off_w, off_b, off_g, off_sh, off_a;
  int stage_off, row_bytes, off_branch, off_res, bars_off;
};

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
// use of a stage (n = 0, 1, ...) waits with parity n & 1.  A wait that
// outlasts 2^30 polls (seconds) traps, so that a lost copy fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes as fp32 values
__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&v)[8]) {
  const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> fp32 is exact: the high half
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[4], const float*) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack(const float (&v)[8],
                                      const __nv_bfloat16*) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// 4 values from a 4-value aligned address (8 bytes of bf16, 16 of fp32)
__device__ __forceinline__ void load4(const float* q, float (&v)[4]) {
  unpack(*reinterpret_cast<const uint4*>(q), v);
}

__device__ __forceinline__ void load4(const __nv_bfloat16* q, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(q);
  v[0] = __uint_as_float(raw.x << 16);
  v[1] = __uint_as_float(raw.x & 0xffff0000u);
  v[2] = __uint_as_float(raw.y << 16);
  v[3] = __uint_as_float(raw.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* q, const float (&v)[4]) {
  *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
}

// x rounded to T and back to fp32
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Where column col of a staged vector lies: lane l's V values of chunk c
// are V / 4 float4s, each at a 512-byte row of the chunk's V / 4 rows, so
// that 32 lanes read 512 contiguous bytes a load.  (V 4, fp32: col itself.)
template <int V>
__device__ __forceinline__ int staged_pos(int col) {
  const int c = col / (32 * V), l = (col / V) % 32, e = col % V;
  return ((c * (V / 4) + e / 4) * 32 + l) * 4 + e % 4;
}

template <int V>
__device__ __forceinline__ void load_staged(const float* vec, int c, int lane,
                                            float (&v)[V]) {
#pragma unroll
  for (int h = 0; h < V / 4; ++h) {
    const float4 x = reinterpret_cast<const float4*>(vec)[(c * (V / 4) + h) *
                                                          32 + lane];
    v[4 * h] = x.x;
    v[4 * h + 1] = x.y;
    v[4 * h + 2] = x.z;
    v[4 * h + 3] = x.w;
  }
}

// NCH: the most chunks of 32 16-byte vectors a row spans (lane values
// NCH * V).  kResT: the residual is of type T (else fp32).
template <typename T, int NCH, bool kResT>
__global__ void __launch_bounds__(kMaxWarps * 32)
    norm_mod_kernel(const Params p) {
  constexpr int V = 16 / sizeof(T);
  const T* tag = nullptr;  // selects round_to's type
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int D = p.D, nw = p.nw;

  // this block's run: rows [start, start + len) of batch `batch`
  const int batch = blockIdx.x / p.k, part = blockIdx.x % p.k;
  const int q = p.L / p.k, rem = p.L % p.k;
  const long long start = static_cast<long long>(batch) * p.L +
                          static_cast<long long>(part) * q + min(part, rem);
  const int len = q + (part < rem ? 1 : 0);
  const int nrows = len > warp ? (len - warp + nw - 1) / nw : 0;

  float* vecs = reinterpret_cast<float*>(smem);
  unsigned char* stage = smem + p.stage_off + warp * p.row_bytes;
  const uint32_t bar = smem_addr(smem + p.bars_off) + 8 * warp;
  const T* base = static_cast<const T*>(p.base);
  const T* branch = static_cast<const T*>(p.branch);
  const uint32_t row_in = static_cast<uint32_t>(D) * sizeof(T);

  // lane 0: this warp's row j into its stage
  auto issue = [&](int j) {
    const long long off = (start + warp + static_cast<long long>(j) * nw) * D;
    const uint32_t dst = smem_addr(stage);
    mbar_expect_tx(bar, p.row_bytes);
    bulk_load(dst, base + off, row_in, bar);
    if (branch != nullptr) {
      bulk_load(dst + p.off_branch, branch + off, row_in, bar);
    }
    if (p.res != nullptr) {
      if constexpr (kResT) {
        bulk_load(dst + p.off_res, static_cast<const T*>(p.res) + off,
                  row_in, bar);
      } else {
        bulk_load(dst + p.off_res, static_cast<const float*>(p.res) + off,
                  4 * D, bar);
      }
    }
  };
  if (lane == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (nrows > 0) issue(0);
  }

  // the run's vectors, while the first rows are in flight: 4 columns a
  // thread and pass, all of a pass's loads issued before its stores (one
  // round trip a pass: one at D <= 128 nw)
  for (int c4 = 4 * tid; c4 < D; c4 += 128 * nw) {
    float wv[4], bv[4], g[4], sh[4], sc[4];
    if (p.off_w >= 0) load4(p.w + c4, wv);
    if (p.off_b >= 0) load4(p.b + c4, bv);
    if (p.off_g >= 0) {
      load4(static_cast<const T*>(p.gate) + batch * p.gate_sb + c4, g);
    }
    if (p.off_sh >= 0) {
      load4(static_cast<const T*>(p.shift) + batch * p.shift_sb + c4, sh);
      load4(static_cast<const T*>(p.scale) + batch * p.scale_sb + c4, sc);
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[e] = round_to(__fadd_rn(1.f, sc[e]), tag);
    }
    const int at = staged_pos<V>(c4);  // 4 columns, 4 adjacent floats
    if (p.off_w >= 0) store4(vecs + p.off_w + at, wv);
    if (p.off_b >= 0) store4(vecs + p.off_b + at, bv);
    if (p.off_g >= 0) store4(vecs + p.off_g + at, g);
    if (p.off_sh >= 0) {
      store4(vecs + p.off_sh + at, sh);
      store4(vecs + p.off_a + at, sc);
    }
  }
  __syncthreads();

  const int nc = (D + 32 * V - 1) / (32 * V);
  const float inv_d = 1.f / static_cast<float>(D);
  for (int j = 0; j < nrows; ++j) {
    mbar_wait(bar, j & 1);
    const long long off = (start + warp + static_cast<long long>(j) * nw) * D;

    // the total, from the stage
    float v[NCH][V];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = (c * 32 + lane) * V;
      if (c >= nc || col >= D) break;
      unpack(*reinterpret_cast<const uint4*>(stage + col * sizeof(T)), v[c]);
      if (branch != nullptr) {
        float br[V];
        unpack(*reinterpret_cast<const uint4*>(stage + p.off_branch +
                                               col * sizeof(T)),
               br);
        if (p.off_g >= 0) {
          float g[V];
          load_staged<V>(vecs + p.off_g, c, lane, g);
#pragma unroll
          for (int e = 0; e < V; ++e) br[e] = __fmul_rn(g[e], br[e]);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) v[c][e] = __fadd_rn(v[c][e], br[e]);
      }
      if (p.res != nullptr && kResT) {
        float r[V];
        unpack(*reinterpret_cast<const uint4*>(stage + p.off_res +
                                               col * sizeof(T)),
               r);
#pragma unroll
        for (int e = 0; e < V; ++e) v[c][e] = __fadd_rn(v[c][e], r[e]);
      } else if (p.res != nullptr) {
#pragma unroll
        for (int h = 0; h < V / 4; ++h) {
          float r[4];
          unpack(*reinterpret_cast<const uint4*>(stage + p.off_res +
                                                 4 * (col + 4 * h)),
                 r);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[c][4 * h + e] = __fadd_rn(v[c][4 * h + e], r[e]);
        }
      }
    }
    // every lane has read the stage (its values are in registers): refill
    // it with the next row, which is in flight while this one is reduced
    // and stored
    __syncwarp();
    if (lane == 0 && j + 1 < nrows) issue(j + 1);

    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = (c * 32 + lane) * V;
      if (c >= nc || col >= D) break;
      if (p.total_f32) {
        float* t = static_cast<float*>(p.total) + off + col;
#pragma unroll
        for (int h = 0; h < V / 4; ++h) {
          const float q4[4] = {v[c][4 * h], v[c][4 * h + 1],
                               v[c][4 * h + 2], v[c][4 * h + 3]};
          *reinterpret_cast<uint4*>(t + 4 * h) = pack(q4, t);
        }
      } else {
        *reinterpret_cast<uint4*>(static_cast<T*>(p.total) + off + col) =
            pack(v[c], tag);
#pragma unroll
        for (int e = 0; e < V; ++e) v[c][e] = round_to(v[c][e], tag);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        sum += p.is_rms ? v[c][e] * v[c][e] : v[c][e];
      }
    }

    float mean = 0.f, rstd;
    if (p.is_rms) {
      rstd = rsqrtf(warp_sum(sum) * inv_d + p.eps);
    } else {
      mean = warp_sum(sum) * inv_d;
      float sq = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        if (c >= nc || (c * 32 + lane) * V >= D) break;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float d = v[c][e] - mean;
          sq += d * d;
        }
      }
      rstd = rsqrtf(warp_sum(sq) * inv_d + p.eps);
    }

#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = (c * 32 + lane) * V;
      if (c >= nc || col >= D) break;
      float o[V], wv[V], bv[V];
      if (p.off_w >= 0) load_staged<V>(vecs + p.off_w, c, lane, wv);
      if (p.off_b >= 0) load_staged<V>(vecs + p.off_b, c, lane, bv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float n = __fmul_rn(v[c][e] - mean, rstd);
        if (p.off_w >= 0) n = __fmul_rn(n, wv[e]);
        if (p.off_b >= 0) n = __fadd_rn(n, bv[e]);
        o[e] = round_to(n, tag);
      }
      if (p.off_sh >= 0) {
        float sh[V], a[V];
        load_staged<V>(vecs + p.off_sh, c, lane, sh);
        load_staged<V>(vecs + p.off_a, c, lane, a);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float m = round_to(__fmul_rn(o[e], a[e]), tag);
          o[e] = round_to(__fadd_rn(m, sh[e]), tag);
        }
      }
      *reinterpret_cast<uint4*>(static_cast<T*>(p.out) + off + col) =
          pack(o, tag);
    }
  }
}

// The current device's SM count; on a device's first call, also lets the
// kernel ask for kSmemMax bytes of shared memory.  Once a device and
// instantiation, so that a launch adds no queries.
template <typename T, int NCH, bool kResT>
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
      err = cudaFuncSetAttribute(norm_mod_kernel<T, NCH, kResT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemMax);
    }
    if (err != cudaSuccess) return err;
    known[dev].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return cudaSuccess;
}

// Lay out shared memory for nw warps; the bytes, or -1 when they exceed
// kSmemMax.
template <typename T, bool kResT>
long long layout(Params& p, int nw) {
  constexpr int V = 16 / sizeof(T);
  const int D = p.D;
  p.dp = (D + 32 * V - 1) / (32 * V) * 32 * V;
  int n = 0;
  auto place = [&](bool present) { return present ? p.dp * n++ : -1; };
  p.off_w = place(p.w != nullptr);
  p.off_b = place(p.b != nullptr);
  p.off_g = place(p.gate != nullptr);
  p.off_sh = place(p.shift != nullptr);
  p.off_a = place(p.shift != nullptr);
  p.stage_off = 4 * p.dp * n;
  p.off_branch = D * static_cast<int>(sizeof(T));
  p.off_res = p.off_branch * (p.branch != nullptr ? 2 : 1);
  const int res_size = kResT ? static_cast<int>(sizeof(T)) : 4;
  p.row_bytes = p.off_res + (p.res != nullptr ? res_size * D : 0);
  p.nw = nw;
  p.bars_off = p.stage_off + nw * p.row_bytes;
  const long long bytes = p.bars_off + 8LL * nw;
  return bytes <= kSmemMax ? bytes : -1;
}

// Launch with the most warps a block of 8, 4, 2, 1 whose shared memory
// fits, and k runs a batch: as many blocks as the card holds at once (at
// least one a batch, at most one a row).
template <typename T, int NCH, bool kResT>
cudaError_t launch(Params p, int B, cudaStream_t stream) {
  long long smem = -1;
  for (int nw = kMaxWarps; nw >= 1 && smem < 0; nw /= 2) {
    smem = layout<T, kResT>(p, nw);
  }
  if (smem < 0) return cudaErrorInvalidValue;
  int sms = 0, fit = 0;
  cudaError_t err = prepare_device<T, NCH, kResT>(&sms);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit, norm_mod_kernel<T, NCH, kResT>, p.nw * 32,
      static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  long long k = static_cast<long long>(sms) * fit / B;
  k = k < 1 ? 1 : (k > p.L ? p.L : k);
  p.k = static_cast<int>(k);
  const long long grid = B * k;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  norm_mod_kernel<T, NCH, kResT><<<static_cast<unsigned>(grid), p.nw * 32,
                                   static_cast<size_t>(smem), stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kResT>
cudaError_t dispatch(const Params& p, int B, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int nc = (p.D + 32 * V - 1) / (32 * V);  // chunks a lane
  if (nc * V <= 32) return launch<T, 32 / V, kResT>(p, B, stream);
  if (nc * V <= 64) return launch<T, 64 / V, kResT>(p, B, stream);
  return launch<T, 128 / V, kResT>(p, B, stream);
}

}  // namespace

// base, branch, out: (rows, D); gate, shift, scale: (rows / L, D) with row
// strides gate_sb, shift_sb, scale_sb (elements); all of type dtype
// (0 float32, 1 bfloat16).  res: (rows, D), float32 when res_f32 else of
// type dtype; w, b: (D,) float32;
// total: (rows, D), float32 when total_f32 else of type dtype.  A null
// branch, gate, res, w, b or shift/scale pair leaves that operand out.
// Returns a cudaError_t (0 on success).
extern "C" int dimsum_norm_modulate(const void* base, const void* branch,
                                    const void* gate, const void* res,
                                    const void* w, const void* b,
                                    const void* shift, const void* scale,
                                    void* out, void* total, long long gate_sb,
                                    long long shift_sb, long long scale_sb,
                                    int rows, int L, int D, int dtype,
                                    int total_f32, int res_f32, int is_rms,
                                    float eps, void* stream) {
  auto misaligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 != 0;
  };
  if (rows <= 0 || L <= 0 || rows % L != 0 || D <= 0 || D % 128 != 0 ||
      D > 4096 || (shift == nullptr) != (scale == nullptr) ||
      (gate != nullptr && branch == nullptr) || (dtype != 0 && dtype != 1) ||
      misaligned(base) || misaligned(branch) || misaligned(res) ||
      misaligned(out) || misaligned(total)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.base = base;
  p.branch = branch;
  p.gate = gate;
  p.res = res;
  p.w = static_cast<const float*>(w);
  p.b = static_cast<const float*>(b);
  p.shift = shift;
  p.scale = scale;
  p.out = out;
  p.total = total;
  p.gate_sb = gate_sb;
  p.shift_sb = shift_sb;
  p.scale_sb = scale_sb;
  p.L = L;
  p.D = D;
  p.k = 1;
  p.total_f32 = dtype == 0 ? 1 : total_f32;
  p.is_rms = is_rms;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int B = rows / L;
  if (dtype == 0) return static_cast<int>(dispatch<float, false>(p, B, s));
  return static_cast<int>(res_f32 ? dispatch<__nv_bfloat16, false>(p, B, s)
                                  : dispatch<__nv_bfloat16, true>(p, B, s));
}
