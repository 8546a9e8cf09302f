// Residual add + RMS/LayerNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dimsum_tpu/ops/norms.py::_add_norm_kernel
// (pallas_call in _add_norm_pallas), which DiM runs with the add + norm
// switch at the top of every combined block that has a residual.  Per row
// of D channels:
//
//   total = x + res                 fp32 (x fp32 or bf16; res fp32 or x's)
//   out   = Norm(total) * w (+ b)   fp32, then x's type
//
// and it emits (out, total), total in fp32 or rounded once to x's type
// (the bf16 residual stream, residual_in_fp32=False: the JAX package's
// total.astype(x.dtype) of the fp32 total; the norm reads the fp32 total,
// as the TPU kernel's does).  The residual's and the total's types are
// compile-time switches of one kernel: a bf16 residual moves 8 bytes a
// value where an fp32 one moves 12.
//
// What bounds it on an H100: device memory.  At DiM-L/2's 256-px rows
// (24 x 256 x 1024) with x in bf16 it reads x and res and writes out and
// total, 75.5 MB, 22.5 us at 3.35 TB/s, for ~6 flop a value.  So the
// design reads every value once and writes every output once: one warp per
// row, each lane holding its D / 32 values in registers (8- or 16-byte
// vector loads of 4 values), the moments reduced with shuffles; LayerNorm's
// two passes (the mean, then the centred variance, as the TPU kernel takes
// them) run over the registers.  __fadd_rn / __fmul_rn keep nvcc from
// contracting the plain version's separate products and sums into FMAs.
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Lane l holds columns 128 c + 4 l .. + 3 of the row for c < D / 128.
// R: the residual's type, S: the total's (float or T).
template <typename T, typename R, typename S, int MAXC>
__global__ void __launch_bounds__(kWarps * 32)
    add_norm_kernel(const T* __restrict__ x, const R* __restrict__ res,
                    const float* __restrict__ w, const float* __restrict__ b,
                    T* __restrict__ out, S* __restrict__ total, int rows,
                    int D, int is_rms, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int nc = D / 128;
  const long long off = row * D;

  float v[MAXC][4];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c >= nc) break;
    const int col = c * 128 + lane * 4;
    float r[4];
    load4(x + off + col, v[c]);
    load4(res + off + col, r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[c][e] = __fadd_rn(v[c][e], r[e]);
      sum += is_rms ? v[c][e] * v[c][e] : v[c][e];
    }
    store4(total + off + col, v[c]);
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
    float wv[4], bv[4] = {0.f, 0.f, 0.f, 0.f}, o[4];
    load4(w + col, wv);
    if (b != nullptr) load4(b + col, bv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[e] = __fmul_rn(__fmul_rn(v[c][e] - mean, rstd), wv[e]);
      if (b != nullptr) o[e] = __fadd_rn(o[e], bv[e]);
    }
    store4(out + off + col, o);
  }
}

template <typename T, typename R, typename S, int MAXC>
cudaError_t launch(const void* x, const void* res, const void* w,
                   const void* b, void* out, void* total, int rows, int D,
                   int is_rms, float eps, cudaStream_t stream) {
  const int grid = (rows + kWarps - 1) / kWarps;
  add_norm_kernel<T, R, S, MAXC><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const R*>(res),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(out), static_cast<S*>(total), rows, D, is_rms, eps);
  return cudaGetLastError();
}

template <typename T, typename R, typename S>
cudaError_t dispatch(const void* x, const void* res, const void* w,
                     const void* b, void* out, void* total, int rows, int D,
                     int is_rms, float eps, cudaStream_t stream) {
  const int nc = D / 128;
  if (nc <= 8)
    return launch<T, R, S, 8>(x, res, w, b, out, total, rows, D, is_rms, eps,
                              stream);
  if (nc <= 16)
    return launch<T, R, S, 16>(x, res, w, b, out, total, rows, D, is_rms,
                               eps, stream);
  return launch<T, R, S, 32>(x, res, w, b, out, total, rows, D, is_rms, eps,
                             stream);
}

}  // namespace

// x, out: (rows, D) of type dtype (0 float32, 1 bfloat16); res: (rows, D)
// float32 when res_f32, else of type dtype; total: (rows, D) float32 when
// total_f32, else of type dtype; w, b: (D,) float32 (b may be null).
// Returns a cudaError_t (0 on success).
extern "C" int dimsum_add_norm(const void* x, const void* res, const void* w,
                               const void* b, void* out, void* total,
                               int rows, int D, int dtype, int is_rms,
                               int res_f32, int total_f32, float eps,
                               void* stream) {
  if (rows <= 0 || D <= 0 || D % 128 != 0 || D > 4096 || w == nullptr ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float, float, float>(x, res, w, b, out, total, rows, D,
                                        is_rms, eps, s);
  } else if (res_f32 && total_f32) {
    err = dispatch<bf16, float, float>(x, res, w, b, out, total, rows, D,
                                       is_rms, eps, s);
  } else if (res_f32) {
    err = dispatch<bf16, float, bf16>(x, res, w, b, out, total, rows, D,
                                      is_rms, eps, s);
  } else if (total_f32) {
    err = dispatch<bf16, bf16, float>(x, res, w, b, out, total, rows, D,
                                      is_rms, eps, s);
  } else {
    err = dispatch<bf16, bf16, bf16>(x, res, w, b, out, total, rows, D,
                                     is_rms, eps, s);
  }
  return static_cast<int>(err);
}
