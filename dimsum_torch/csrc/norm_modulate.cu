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
// res, w and b are fp32; total is fp32 or base's type.  A null pointer
// leaves its operand out.  The per-batch vectors come with their own row
// strides: DiM slices them out of one adaLN projection (row stride 3 D or
// 6 D), and the kernel reads them where they lie.
//
// What bounds it on an H100: device memory.  At DiM-L/2's 256-px rows
// (24 x 256 x 1024, bf16) the norm_2 site moves base, branch, out and total
// (50.3 MB, 15.0 us at 3.35 TB/s) and does ~10 flop a value; the FinalLayer
// site moves 37.7 MB (11.3 us).  So the design reads every value once and
// writes every output once: one warp per row, each lane holding its
// D / 32 values in registers (8- or 16-byte vector loads of 4 values), the
// moments reduced with shuffles.  LayerNorm's two passes (the mean, then the
// centred variance, as the TPU kernel takes them) run over the registers,
// not over device memory.  The products and sums that PyTorch evaluates as
// separate ops use __fmul_rn / __fadd_rn, so nvcc does not contract them
// into FMAs and the fp32 total is the plain version's bit for bit.
//
// D is a multiple of 128 up to 4096; anything else returns
// cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows per block

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  uint2 raw;
  *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = raw;
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

// Lane l holds columns 128 c + 4 l .. + 3 of the row for c < D / 128.
template <typename T, int MAXC>
__global__ void __launch_bounds__(kWarps * 32)
    norm_mod_kernel(const T* __restrict__ base, const T* __restrict__ branch,
                    const T* __restrict__ gate, const float* __restrict__ res,
                    const float* __restrict__ w, const float* __restrict__ b,
                    const T* __restrict__ shift, const T* __restrict__ scale,
                    T* __restrict__ out, void* __restrict__ total,
                    long long gate_sb, long long shift_sb, long long scale_sb,
                    int rows, int L, int D, int total_f32, int is_rms,
                    float eps) {
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int nc = D / 128;
  const long long off = row * D;
  const long long batch = row / L;  // the per-batch vectors' row
  const T* tag = nullptr;                 // selects round_to's type

  float v[MAXC][4];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c >= nc) break;
    const int col = c * 128 + lane * 4;
    load4(base + off + col, v[c]);
    if (branch != nullptr) {
      float br[4];
      load4(branch + off + col, br);
      if (gate != nullptr) {
        float g[4];
        load4(gate + batch * gate_sb + col, g);
#pragma unroll
        for (int e = 0; e < 4; ++e) br[e] = __fmul_rn(g[e], br[e]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) v[c][e] = __fadd_rn(v[c][e], br[e]);
    }
    if (res != nullptr) {
      float r[4];
      load4(res + off + col, r);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[c][e] = __fadd_rn(v[c][e], r[e]);
    }
    if (total_f32) {
      store4(static_cast<float*>(total) + off + col, v[c]);
    } else {
      store4(static_cast<T*>(total) + off + col, v[c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[c][e] = round_to(v[c][e], tag);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += is_rms ? v[c][e] * v[c][e] : v[c][e];
  }

  const float inv_d = 1.f / static_cast<float>(D);
  float mean = 0.f, rstd;
  if (is_rms) {
    rstd = rsqrtf(warp_sum(sum) * inv_d + eps);
  } else {
    mean = warp_sum(sum) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c >= nc) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = v[c][e] - mean;
        sq += d * d;
      }
    }
    rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
  }

#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c >= nc) break;
    const int col = c * 128 + lane * 4;
    float o[4], wv[4] = {1.f, 1.f, 1.f, 1.f}, bv[4] = {0.f, 0.f, 0.f, 0.f};
    if (w != nullptr) load4(w + col, wv);
    if (b != nullptr) load4(b + col, bv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float n = __fmul_rn(v[c][e] - mean, rstd);
      if (w != nullptr) n = __fmul_rn(n, wv[e]);
      if (b != nullptr) n = __fadd_rn(n, bv[e]);
      o[e] = round_to(n, tag);
    }
    if (shift != nullptr) {
      float sh[4], sc[4];
      load4(shift + batch * shift_sb + col, sh);
      load4(scale + batch * scale_sb + col, sc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = round_to(__fadd_rn(1.f, sc[e]), tag);
        const float m = round_to(__fmul_rn(o[e], a), tag);
        o[e] = round_to(__fadd_rn(m, sh[e]), tag);
      }
    }
    store4(out + off + col, o);
  }
}

template <typename T, int MAXC>
cudaError_t launch(const void* base, const void* branch, const void* gate,
                   const void* res, const void* w, const void* b,
                   const void* shift, const void* scale, void* out,
                   void* total, const long long (&sb)[3], int rows, int L,
                   int D, int total_f32, int is_rms, float eps,
                   cudaStream_t stream) {
  const int grid = (rows + kWarps - 1) / kWarps;
  norm_mod_kernel<T, MAXC><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(base), static_cast<const T*>(branch),
      static_cast<const T*>(gate), static_cast<const float*>(res),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const T*>(shift), static_cast<const T*>(scale),
      static_cast<T*>(out), total, sb[0], sb[1], sb[2], rows, L, D, total_f32,
      is_rms, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* base, const void* branch, const void* gate,
                     const void* res, const void* w, const void* b,
                     const void* shift, const void* scale, void* out,
                     void* total, const long long (&sb)[3], int rows, int L,
                     int D, int total_f32, int is_rms, float eps,
                     cudaStream_t stream) {
  const int nc = D / 128;
  if (nc <= 8)
    return launch<T, 8>(base, branch, gate, res, w, b, shift, scale, out,
                        total, sb, rows, L, D, total_f32, is_rms, eps,
                        stream);
  if (nc <= 16)
    return launch<T, 16>(base, branch, gate, res, w, b, shift, scale, out,
                         total, sb, rows, L, D, total_f32, is_rms, eps,
                         stream);
  return launch<T, 32>(base, branch, gate, res, w, b, shift, scale, out,
                       total, sb, rows, L, D, total_f32, is_rms, eps, stream);
}

}  // namespace

// base, branch, out: (rows, D); gate, shift, scale: (rows / L, D) with row
// strides gate_sb, shift_sb, scale_sb (elements); all of type dtype
// (0 float32, 1 bfloat16).  res: (rows, D) float32; w, b: (D,) float32;
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
                                    int total_f32, int is_rms, float eps,
                                    void* stream) {
  if (rows <= 0 || L <= 0 || rows % L != 0 || D <= 0 || D % 128 != 0 ||
      D > 4096 || (shift == nullptr) != (scale == nullptr) ||
      (gate != nullptr && branch == nullptr) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long sb[3] = {gate_sb, shift_sb, scale_sb};
  if (dtype == 0) {
    return static_cast<int>(dispatch<float>(base, branch, gate, res, w, b,
                                            shift, scale, out, total, sb,
                                            rows, L, D, 1, is_rms, eps, s));
  }
  return static_cast<int>(dispatch<__nv_bfloat16>(
      base, branch, gate, res, w, b, shift, scale, out, total, sb, rows, L,
      D, total_f32, is_rms, eps, s));
}
