// Pre-LN MLP sub-block, bf16, for sm_90a:
//   out = x + QuickGELU(LN(x) @ W_fc + b_fc) @ W_proj + b_proj
//
// Replaces the TPU kernel leclip_tpu/ops/block_kernels.py mlp_bf16
// (_mlp_bf16_kernel). Two launches of the tiled GEMM (gemm.cuh):
//   1. tiled_gemm<LN, EPI_BIAS_GELU>: h = bf16(QuickGELU(bf16(LN(x)) @ W_fc + b_fc))
//   2. tiled_gemm<-, RESID_PLUS_OUT>: out = bf16(x + (h @ W_proj + b_proj))
// Rounding points are the TPU kernel's: LN statistics, both accumulations
// and the GELU in fp32; LN(x) and the hidden rounded to bf16 before their
// products; the residual sum rounded once. Unlike the TPU kernel, the bf16
// [R, 4D] hidden goes through HBM (16 bytes per row element of x, written
// and read once; 1.5 GB per call at the ViT-B/16 TTA shape).
//
// Bound on the H100: 4*R*D*H flops over 4*R*D + 4*D*H bytes, far above the
// ridge, so tensor-core operations bound it. A one-launch version that
// folded 128-column hidden chunks into an fp32 [32, D] register accumulator
// was measured 2.2x slower (PERF.md, PR 1): a 32-row block re-reads every
// weight from L2, and the register accumulator caps the row tile.
#include "gemm.cuh"

using leclip::bf16;

extern "C" {

// x, out: [rows, d]; hidden scratch [rows, hidden]; fc_w [d, hidden],
// pj_w [hidden, d] in [in, out] layout; all bf16, contiguous, on the card.
// d % 128 == 0, d <= 1024, hidden % 128 == 0. Two launches on `stream`;
// returns the first cudaError_t that is not cudaSuccess.
int leclip_mlp_bf16(const void* x, const void* ln_s, const void* ln_b,
                    const void* fc_w, const void* fc_b, const void* pj_w,
                    const void* pj_b, void* out, void* hidden_buf, int rows, int d,
                    int hidden, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* hb = static_cast<bf16*>(hidden_buf);
  cudaError_t err = leclip::launch_tiled_gemm<true, leclip::EPI_BIAS_GELU>(
      xb, static_cast<const bf16*>(ln_s), static_cast<const bf16*>(ln_b),
      static_cast<const bf16*>(fc_w), static_cast<const bf16*>(fc_b), nullptr, hb, rows, d,
      hidden, eps, s);
  if (err != cudaSuccess) return (int)err;
  return (int)leclip::launch_tiled_gemm<false, leclip::EPI_RESID_PLUS_OUT>(
      hb, nullptr, nullptr, static_cast<const bf16*>(pj_w), static_cast<const bf16*>(pj_b), xb,
      static_cast<bf16*>(out), rows, hidden, d, 0.f, s);
}

}  // extern "C"
