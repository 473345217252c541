// Pre-LN MLP sub-block with int8 products (W8A8), for sm_90a:
//   out = x + int8 proj(requantize(QuickGELU(int8 fc(LN(x)))))
//
// Replaces the TPU kernel leclip_tpu/ops/quant_kernels.py mlp_int8
// (_mlp_int8_kernel). The rows arrive already normalised and quantized
// (xi int8 [R, D], xs fp32 [R]: the ln_quant kernel, launched by the Python
// wrapper just before). The TPU kernel keeps the fp32 hidden of a group of
// sequences in VMEM, takes each hidden row's absmax over its whole width
// H = 4D and requantizes it; 3072 fp32 per row do not fit on chip beside a
// useful tile here. Instead the fc product runs twice (integer sums are
// exact, so both passes see bit-identical h):
//   1. int8_gemm<IEPI_GELU_ABSMAX>: h = QuickGELU(acc * (xs * s_col) + b) in
//      fp32, reduced to row_absmax[r] = max_n |h| (shared-memory then global
//      atomicMax on the float bits; row_absmax zeroed first)
//   2. int8_gemm<IEPI_GELU_QUANT>:  the same h, written as int8 codes at
//      scale hs = max(row_absmax / 127, 1e-12) -> hi [R, H]
//   3. int8_gemm<IEPI_RESID>:       bf16(x + (acc * (hs * s_col) + b))
// The hidden goes through HBM once, as int8 (1 byte per element written and
// read), never as bf16: rounding h to bf16 before the absmax would be
// another function.
//
// Bound on the H100: 4*R*D*H int8 operations over 4*R*D + 2*D*H bytes, far
// above the ridge, so tensor-core operations bound it; this design spends
// 6*R*D*H (the repeated fc). The products run on the int8 tensor cores
// (mma.sync m16n8k32, gemm_int8.cuh). Keeping a row panel's A tile resident
// over both fc passes, wgmma/TMA, and folding pass 1 into the quantizer of a
// row-panel kernel are later work.
#include "gemm_int8.cuh"

using leclip::bf16;

extern "C" {

// x, out: [rows, d] bf16; xi [rows, d] int8 and xs [rows] fp32 from
// ln_quant; fc_wt [hidden, d] and pj_wt [d, hidden] int8 (K contiguous);
// fc_s [hidden], pj_s [d] fp32; fc_b [hidden], pj_b [d] bf16; scratch
// row_absmax [rows] fp32 and hi [rows, hidden] int8; contiguous, on the card.
// d % 128 == 0, hidden % 128 == 0. A memset and three launches on `stream`;
// returns the first cudaError_t that is not cudaSuccess.
int leclip_mlp_int8(const void* x, const void* xi, const void* xs, const void* fc_wt,
                    const void* fc_s, const void* fc_b, const void* pj_wt, const void* pj_s,
                    const void* pj_b, void* row_absmax, void* hi, void* out, int rows, int d,
                    int hidden, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi8 = static_cast<const int8_t*>(xi);
  const int8_t* fc8 = static_cast<const int8_t*>(fc_wt);
  const float* xs32 = static_cast<const float*>(xs);
  const float* fcs = static_cast<const float*>(fc_s);
  const bf16* fcb = static_cast<const bf16*>(fc_b);
  float* amax = static_cast<float*>(row_absmax);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float) * (size_t)rows, s);
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
