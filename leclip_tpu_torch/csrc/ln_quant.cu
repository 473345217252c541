// LayerNorm + per-row int8 quantization, for sm_90a:
//   (xi int8 [R, D], s fp32 [R]) with LN(x) ~= xi * s
//
// Replaces the TPU kernel leclip_tpu/ops/quant_kernels.py ln_quant
// (_ln_quant_kernel). One launch (quant.cuh ln_quant_rows), one warp per row.
//
// Bound on the H100: 3 bytes per element (2 read, 1 written) plus 4 per row,
// a handful of flops per element — bytes bound it. The design reads each row
// once with 16-byte loads and keeps it in registers between the statistics,
// the absmax and the rounding, so nothing is read twice.
#include "quant.cuh"

using leclip::bf16;

extern "C" {

// x [rows, d] bf16, ln_s / ln_b [d] bf16, xi [rows, d] int8, xs [rows] fp32;
// contiguous, on the card. d % 8 == 0, d <= 1024. One launch on `stream`;
// returns the cudaError_t of the launch.
int leclip_ln_quant(const void* x, const void* ln_s, const void* ln_b, void* xi, void* xs,
                    int rows, int d, float eps, void* stream) {
  return (int)leclip::launch_ln_quant(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s),
      static_cast<const bf16*>(ln_b), static_cast<int8_t*>(xi), static_cast<float*>(xs), rows, d,
      eps, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
