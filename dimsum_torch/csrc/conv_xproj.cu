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
// What bounds it on an H100: device memory.  At the 256-px mixer shape
// (24 x 256 x 1024, W 4, R 64, bf16) it reads x and writes x_conv (12.6 MB
// each) and x_dbl (1.6 MB fp32): 26.7 MB, 8.0 us at 3.35 TB/s; the product
// is 0.81 GFLOP, under 1 us on the tensor cores.  In fp32 the product on
// the CUDA cores (67 TFLOP/s) takes ~12 us, about as long as its 52 MB.
//
// The TPU kernel walks channel blocks on a sequential grid axis and carries
// x_dbl across them in its output block.  Hopper blocks run in no order, so
// here one block owns 16 tokens of one batch row and every channel: it
// loops over 64-channel chunks, and for each
//   1. stages the 16 + W - 1 input rows (the halo) in shared memory as fp32,
//      zero outside the sequence;
//   2. computes conv, bias and SiLU in fp32, in the plain version's order
//      (__fmul_rn / __fadd_rn keep nvcc from contracting them into FMAs),
//      and stores x_conv in x's type;
//   3. keeps the rounded tile in shared memory as the product's A operand;
//   4. bf16: multiplies it by the chunk of w_xp on the tensor cores
//      (mma.sync m16n8k16, bf16 in, fp32 accumulate), each of the four
//      warps taking one 16-channel k step; fp32: on the CUDA cores, each
//      thread 10 outputs.
// The sums stay in registers across chunks and x_dbl is written once; the
// bf16 route adds its four warps' partials in a fixed order.  No cross-block
// sum and no float atomic: results repeat bit for bit.  R is covered in
// groups of 80 columns (10 n tiles, so DiM-XL/2's 68 is one group), one
// group per grid z; a block of a later group recomputes the conv and does
// not store x_conv.
//
// D a multiple of 64, 1 <= W <= 8; anything else returns
// cudaErrorInvalidValue.  Not yet fast: scalar loads, 16 tokens a block
// (384 blocks at the 256-px shape), w_xp re-read from L2 by every block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kRows = 16;          // tokens per block (one mma m tile)
constexpr int kChan = 64;          // channels per chunk (4 mma k steps)
constexpr int kMaxW = 8;           // conv widths the halo holds
constexpr int kNGroup = 80;        // x_dbl columns per block (10 n tiles)
constexpr int kLdB = kChan + 8;    // bf16 tile row: conflict-free fragments
constexpr int kLdF = kChan + 1;    // fp32 tile row

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

__global__ void __launch_bounds__(kThreads) conv_xproj_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, long long x_sb, long long x_sl,
    const float* __restrict__ conv_w, const float* __restrict__ conv_b,
    const __nv_bfloat16* __restrict__ w_xp, __nv_bfloat16* __restrict__ x_conv,
    float* __restrict__ x_dbl, int L, int D, int W, int R, int reverse) {
  __shared__ float sX[kRows + kMaxW - 1][kChan];
  __shared__ __align__(16) __nv_bfloat16 sA[kRows][kLdB];
  __shared__ __align__(16) __nv_bfloat16 sW[kNGroup][kLdB];
  __shared__ float sRed[kThreads / 32][kRows][kNGroup];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int t0 = blockIdx.x * kRows, b = blockIdx.y, n0 = blockIdx.z * kNGroup;
  const __nv_bfloat16* xb = x + b * x_sb;

  float acc[kNGroup / 8][4];
#pragma unroll
  for (int j = 0; j < kNGroup / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  for (int c0 = 0; c0 < D; c0 += kChan) {
    stage_x(sX, xb, x_sl, t0, L, c0, W, reverse);
    for (int i = tid; i < kNGroup * kChan; i += kThreads) {
      const int n = i / kChan, k = i % kChan;
      sW[n][k] = n0 + n < R
                     ? w_xp[static_cast<long long>(n0 + n) * D + c0 + k]
                     : __float2bfloat16(0.f);
    }
    __syncthreads();
    for (int i = tid; i < kRows * kChan; i += kThreads) {
      const int r = i / kChan, ch = i % kChan, d = c0 + ch, t = t0 + r;
      const __nv_bfloat16 v = __float2bfloat16(conv_silu(
          sX, conv_w + static_cast<long long>(d) * W,
          conv_b != nullptr ? conv_b[d] : 0.f, r, ch, W, reverse));
      sA[r][ch] = t < L ? v : __float2bfloat16(0.f);
      if (t < L && blockIdx.z == 0) {
        x_conv[(static_cast<long long>(b) * L + t) * D + d] = v;
      }
    }
    __syncthreads();

    // warp w multiplies the chunk's channels 16 w .. 16 w + 15
    const int kc = warp * 16 + 2 * c;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(&sA[g][kc]);
    a[1] = *reinterpret_cast<const uint32_t*>(&sA[g + 8][kc]);
    a[2] = *reinterpret_cast<const uint32_t*>(&sA[g][kc + 8]);
    a[3] = *reinterpret_cast<const uint32_t*>(&sA[g + 8][kc + 8]);
#pragma unroll
    for (int j = 0; j < kNGroup / 8; ++j) {
      mma_bf16(acc[j], a,
               *reinterpret_cast<const uint32_t*>(&sW[j * 8 + g][kc]),
               *reinterpret_cast<const uint32_t*>(&sW[j * 8 + g][kc + 8]));
    }
    __syncthreads();  // the next chunk refills sX, sW and sA
  }

  // the accumulator layout: rows g and g + 8, columns 2 c and 2 c + 1
#pragma unroll
  for (int j = 0; j < kNGroup / 8; ++j) {
    const int col = j * 8 + 2 * c;
    sRed[warp][g][col] = acc[j][0];
    sRed[warp][g][col + 1] = acc[j][1];
    sRed[warp][g + 8][col] = acc[j][2];
    sRed[warp][g + 8][col + 1] = acc[j][3];
  }
  __syncthreads();
  for (int i = tid; i < kRows * kNGroup; i += kThreads) {
    const int r = i / kNGroup, n = i % kNGroup, t = t0 + r;
    if (t < L && n0 + n < R) {
      x_dbl[(static_cast<long long>(b) * L + t) * R + n0 + n] =
          ((sRed[0][r][n] + sRed[1][r][n]) + sRed[2][r][n]) + sRed[3][r][n];
    }
  }
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
  const dim3 grid((L + kRows - 1) / kRows, B, (R + kNGroup - 1) / kNGroup);
  if (dtype == 1) {
    conv_xproj_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), x_sb, x_sl,
        static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
        static_cast<const __nv_bfloat16*>(w_xp),
        static_cast<__nv_bfloat16*>(x_conv), static_cast<float*>(x_dbl), L, D,
        W, R, reverse);
  } else {
    conv_xproj_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), x_sb, x_sl,
        static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
        static_cast<const float*>(w_xp), static_cast<float*>(x_conv),
        static_cast<float*>(x_dbl), L, D, W, R, reverse);
  }
  return static_cast<int>(cudaGetLastError());
}
