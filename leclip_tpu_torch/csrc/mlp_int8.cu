// Pre-LN MLP sub-block with int8 products (W8A8), for sm_90a:
//   out = x + int8 proj(requantize(QuickGELU(int8 fc(LN(x)))))
//
// Replaces the TPU kernel leclip_tpu/ops/quant_kernels.py mlp_int8
// (_mlp_int8_kernel). Its first launch normalises and quantizes the rows
// (quant.cuh ln_quant_rows: xi int8 [R, D], xs fp32 [R]) into the first
// bytes of the output buffer, which only the last launch writes. The TPU
// kernel keeps the fp32 hidden of a group of sequences in VMEM, takes each hidden row's absmax over its whole width
// H = 4D and requantizes it; 3072 fp32 per row do not fit on chip beside a
// useful tile here. Instead the fc product runs twice (integer sums are
// exact, so both passes see bit-identical h):
//   0. ln_quant_rows: xi, xs = quantize(LN(x))
//   1. hopper_gemm_s8<IEPI_GELU_ABSMAX>: h = QuickGELU(acc * (xs * s_col) + b)
//      in fp32, reduced to row_absmax[r] = max_n |h| (a quad shuffle, then
//      one global atomicMax on the float bits per row and column tile;
//      row_absmax zeroed first)
//   2. hopper_gemm_s8<IEPI_GELU_QUANT>: the same h, written as int8 codes at
//      scale hs = max(row_absmax / 127, 1e-12) -> hi [R, H]
//   3. hopper_gemm_s8<IEPI_RESID>: bf16(x + (acc * (hs * s_col) + b))
// The hidden goes through HBM once, as int8 (1 byte per element written and
// read), never as bf16: rounding h to bf16 before the absmax would be
// another function.
//
// Bound on the H100: 4*R*D*H int8 operations over 4*R*D + 2*D*H bytes, far
// above the ridge, so tensor-core operations bound it; this design spends
// 6*R*D*H (the repeated fc). The products run on wgmma fed by TMA
// (gemm_int8.cuh: m64n256k32 .s8, one persistent warp-specialised block per
// SM). The two fc passes are also bound by their CUDA-core epilogue
// (rescale, QuickGELU with a full-precision expf and a correctly rounded
// reciprocal, the quantizer's exact code: ~25-40 instructions per hidden
// element, about as long on the CUDA cores as the element's 2*D = 1,536
// int8 operations take on the tensor cores at D = 768); each consumer
// warpgroup runs its own epilogue while the other issues products. A
// row-panel launch that keeps the A panel resident over both fc passes, and
// a one-pass fc with a cluster holding whole hidden rows, are later work.
#include "gemm_int8.cuh"

using leclip::bf16;

namespace leclip {

__device__ __forceinline__ uint64_t splitmix64(uint64_t z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// bad[0]: fp32 x in [1, 2^126] (every one, over the grid) where rcp_rn_1(x)
// differs from __frcp_rn(x). bad[1]: of n_pairs seeded (y, s), s =
// quant_scale(absmax) over 2^-60..2^40 (some clamped at 1e-12, some with an
// all-ones mantissa), where quant_code_rcp differs from quant_code: three in
// four pairs put y within a few ulps of (k + 0.5) * s, k in [-128, 127], the
// rest anywhere in [-128 s, 128 s].
__global__ void exact_forms_check(uint64_t seed, long long n_pairs,
                                  unsigned long long* __restrict__ bad) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long n_rcp = 0, n_code = 0;
  const uint32_t lo = 0x3F800000u, hi = 0x7E800000u;  // 1.0, 2^126
  for (long long i = i0; i <= (long long)(hi - lo); i += stride) {
    const float x = __uint_as_float(lo + (uint32_t)i);
    n_rcp += __float_as_uint(rcp_rn_1(x)) != __float_as_uint(__frcp_rn(x));
  }
  for (long long i = i0; i < n_pairs; i += stride) {
    const uint64_t r0 = splitmix64(seed ^ (uint64_t)i * 0xD1B54A32D192ED03ull);
    const uint64_t r1 = splitmix64(r0);
    uint32_t mant = (uint32_t)r0 & 0x7FFFFFu;
    if ((r0 >> 23) % 16 == 0) mant = 0x7FFFFFu;
    const int ex = (int)((r0 >> 27) % 101) - 60;  // absmax in 2^-60 .. 2^40
    const float s = quant_scale(__uint_as_float(((uint32_t)(ex + 127) << 23) | mant));
    float y;
    if ((r1 & 3) != 0) {
      const int k = (int)((r1 >> 2) % 256) - 128;
      const int d = (int)((r1 >> 10) % 9) - 4;  // ulps away from the boundary
      y = __uint_as_float(__float_as_uint(__fmul_rn((float)k + 0.5f, s)) + d);
    } else {
      const float u = __uint_as_float(0x3F800000u | ((uint32_t)(r1 >> 2) & 0x7FFFFFu));  // [1, 2)
      y = __fmul_rn(s, __fmul_rn(256.f, u - 1.5f));
    }
    n_code += (int8_t)(quant_code_rcp(y, s, __frcp_rn(s)) & 0xFF) != quant_code(y, s);
  }
  if (n_rcp) atomicAdd(bad, n_rcp);
  if (n_code) atomicAdd(bad + 1, n_code);
}

}  // namespace leclip

extern "C" {

// The exactness check of the division-free forms that the int8 epilogue and
// the ln_quant row pass use (quant.cuh): bad [2] uint64 on the card, zeroed
// here; one launch on `stream`. Both counts must come back 0.
int leclip_int8_exact_forms_check(unsigned long long seed, long long n_pairs, void* bad,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bad, 0, 2 * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  leclip::exact_forms_check<<<132 * 8, 256, 0, s>>>(seed, n_pairs,
                                                    static_cast<unsigned long long*>(bad));
  return (int)cudaGetLastError();
}

// x, out: [rows, d] bf16; ln_s / ln_b [d] bf16; fc_wt [hidden, d] and
// pj_wt [d, hidden] int8 (K contiguous); fc_s [hidden], pj_s [d] fp32; fc_b
// [hidden], pj_b [d] bf16; scratch row_absmax [rows] fp32 and hi [rows,
// hidden] int8; contiguous, on the card. d % 128 == 0, d <= 1024, hidden %
// 128 == 0. out doubles as the scratch of the LN rows' codes and scales
// (rows * (d + 4) bytes of its 2 * rows * d), read by the fc passes before
// the proj pass writes out. A memset and four launches on `stream`; returns
// the first cudaError_t that is not cudaSuccess.
int leclip_mlp_int8(const void* x, const void* ln_s, const void* ln_b, const void* fc_wt,
                    const void* fc_s, const void* fc_b, const void* pj_wt, const void* pj_s,
                    const void* pj_b, void* row_absmax, void* hi, void* out, int rows, int d,
                    int hidden, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* xi8 = static_cast<int8_t*>(out);
  float* xs32 = reinterpret_cast<float*>(xi8 + (size_t)rows * d);
  const int8_t* fc8 = static_cast<const int8_t*>(fc_wt);
  const float* fcs = static_cast<const float*>(fc_s);
  const bf16* fcb = static_cast<const bf16*>(fc_b);
  float* amax = static_cast<float*>(row_absmax);
  cudaError_t err = leclip::launch_ln_quant(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s), static_cast<const bf16*>(ln_b),
      xi8, xs32, rows, d, eps, s);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(amax, 0, sizeof(float) * (size_t)rows, s);
  if (err != cudaSuccess) return (int)err;
  err = leclip::launch_int8_gemm<leclip::IEPI_GELU_ABSMAX>(
      xi8, fc8, xs32, amax, fcs, fcb, nullptr, nullptr, rows, d, hidden, s);
  if (err != cudaSuccess) return (int)err;
  err = leclip::launch_int8_gemm<leclip::IEPI_GELU_QUANT>(
      xi8, fc8, xs32, amax, fcs, fcb, nullptr, hi, rows, d, hidden, s);
  if (err != cudaSuccess) return (int)err;
  return (int)leclip::launch_int8_gemm<leclip::IEPI_RESID>(
      static_cast<const int8_t*>(hi), static_cast<const int8_t*>(pj_wt), nullptr, amax,
      static_cast<const float*>(pj_s), static_cast<const bf16*>(pj_b),
      static_cast<const bf16*>(x), out, rows, hidden, d, s);
}

}  // extern "C"
