// Pre-LN MLP sub-block, bf16, for sm_90a:
//   out = x + QuickGELU(LN(x) @ W_fc + b_fc) @ W_proj + b_proj
//
// Replaces the TPU kernel leclip_tpu/ops/block_kernels.py mlp_bf16
// (_mlp_bf16_kernel). Three launches:
//   1. ln_bf16_rows (layernorm.cuh):     bf16(LN(x)) [R, D], one warp per row
//   2. hopper_gemm<EPI_BIAS_GELU> (gemm_sm90.cuh): h = bf16(QuickGELU(LN(x) @ W_fc + b_fc))
//   3. hopper_gemm<EPI_RESID_PLUS_OUT>:  out = bf16(x + (h @ W_proj + b_proj))
// Rounding points are the TPU kernel's: LN statistics, both accumulations
// and the GELU in fp32; LN(x) and the hidden rounded to bf16 before their
// products; the residual sum rounded once. Unlike the TPU kernel, the bf16
// [R, 4D] hidden goes through HBM (16 bytes per row element of x, written
// and read once; 1.5 GB per call at the ViT-B/16 TTA shape).
//
// Bound on the H100: 4*R*D*H flops over 4*R*D + 4*D*H bytes, far above the
// ridge, so tensor-core operations bound it. Both products run on wgmma fed
// by TMA (one persistent warp-specialised block per SM, 128x256 tiles, the
// bias / GELU / residual applied in the accumulator registers); the LN is
// taken once per row by its own bytes-bound pass. A one-launch version that
// folded hidden chunks into a register accumulator was measured 2.2x slower
// on mma.sync (PERF.md): a 32-row block re-reads every weight from L2.
#include "gemm_sm90.cuh"
#include "layernorm.cuh"

using leclip::bf16;

extern "C" {

// x, out: [rows, d]; hidden scratch [rows, hidden]; fc_w [d, hidden],
// pj_w [hidden, d] in [in, out] layout; all bf16, contiguous, on the card.
// d % 128 == 0, d <= 1024, hidden % 128 == 0. Three launches on `stream`;
// returns the first cudaError_t that is not cudaSuccess.
int leclip_mlp_bf16(const void* x, const void* ln_s, const void* ln_b,
                    const void* fc_w, const void* fc_b, const void* pj_w,
                    const void* pj_b, void* out, void* hidden_buf, int rows, int d,
                    int hidden, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* ob = static_cast<bf16*>(out);
  bf16* hb = static_cast<bf16*>(hidden_buf);
  // bf16(LN(x)) goes into `out`, which only the last launch writes
  cudaError_t err = leclip::launch_ln_bf16(xb, static_cast<const bf16*>(ln_s),
                                           static_cast<const bf16*>(ln_b), ob, rows, d, eps, s);
  if (err != cudaSuccess) return (int)err;
  err = leclip::launch_hopper_gemm<leclip::EPI_BIAS_GELU>(
      ob, static_cast<const bf16*>(fc_w), static_cast<const bf16*>(fc_b), nullptr, hb, rows, d,
      hidden, s);
  if (err != cudaSuccess) return (int)err;
  return (int)leclip::launch_hopper_gemm<leclip::EPI_RESID_PLUS_OUT>(
      hb, static_cast<const bf16*>(pj_w), static_cast<const bf16*>(pj_b), xb, ob, rows, hidden, d,
      s);
}

}  // extern "C"
