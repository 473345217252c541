// The LayerNorm row pass shared by the bf16 and int8 blocks, for sm_90a.
//
// ln_row holds one row of x (D <= 256 * NCH: at most NCH chunks of 8 per lane,
// NCH <= 4) in a warp's registers and leaves LN(x) in fp32 there, with the TPU kernels'
// statistics: the mean, then the mean of the centred squares, rsqrt(v + eps),
// and the affine as ((x - mean) * rstd) * scale + bias. Each step is rounded
// on its own (__fmul_rn / __fadd_rn): nvcc would otherwise contract the
// affine into one fused multiply-add, and the int8 quantizer that reads
// these values flips a code at a .5 boundary on a one-ulp change.
//
// ln_bf16_rows is the first launch of both bf16 blocks: bf16(LN(x)) [R, D],
// written once, the TPU kernels' rounding point before their products. It is
// bound by bytes (2 read + 2 written per element), one warp per row.
#pragma once

#include "gemm.cuh"

namespace leclip {

template <int NCH>
__device__ __forceinline__ void ln_row(const bf16* __restrict__ src, const bf16* __restrict__ ln_s,
                                       const bf16* __restrict__ ln_b, int d, float eps, int lane,
                                       float (&v)[NCH][8]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c < d) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + c);
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[i][j] = __bfloat162float(e[j]);
        s += v[i][j];
      }
    }
  }
  const float mean = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    if ((lane + 32 * i) * 8 < d) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[i][j] = v[i][j] - mean;
        q += v[i][j] * v[i][j];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / d + eps);
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c < d) {
      const uint4 su = *reinterpret_cast<const uint4*>(ln_s + c);
      const uint4 bu = *reinterpret_cast<const uint4*>(ln_b + c);
      const bf16* sv = reinterpret_cast<const bf16*>(&su);
      const bf16* bv = reinterpret_cast<const bf16*>(&bu);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[i][j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j], rstd), __bfloat162float(sv[j])),
                            __bfloat162float(bv[j]));
    }
  }
}

constexpr int LN_WARPS = 8;

__global__ void __launch_bounds__(LN_WARPS * 32)
ln_bf16_rows(const bf16* __restrict__ x, const bf16* __restrict__ ln_s,
             const bf16* __restrict__ ln_b, bf16* __restrict__ y, int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * LN_WARPS + threadIdx.x / 32;
  if (r >= rows) return;
  float v[4][8];
  ln_row(x + (size_t)r * d, ln_s, ln_b, d, eps, lane, v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = (lane + 32 * i) * 8;
    if (c < d) {
      alignas(16) bf16 o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16(v[i][j]);
      *reinterpret_cast<uint4*>(y + (size_t)r * d + c) = *reinterpret_cast<const uint4*>(o);
    }
  }
}

// d % 8 == 0, d <= 1024 (the wrappers ask for d % 128 == 0)
inline cudaError_t launch_ln_bf16(const bf16* x, const bf16* ln_s, const bf16* ln_b, bf16* y,
                                  int rows, int d, float eps, cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  ln_bf16_rows<<<(rows + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, stream>>>(x, ln_s, ln_b, y,
                                                                               rows, d, eps);
  return cudaGetLastError();
}

}  // namespace leclip
