// Pre-LN attention sub-block, bf16, for sm_90a:
//   out = x + OutProj(MHA(LN(x) @ W_qkv + b_qkv))
//
// Replaces the TPU kernel leclip_tpu/ops/block_kernels.py attn_block_bf16
// (_attn_block_bf16_kernel). Four launches:
//   1. ln_bf16_rows (layernorm.cuh):   bf16(LN(x)) [R, D], one warp per row
//   2. hopper_gemm<EPI_BIAS> (gemm_sm90.cuh): LN(x) @ W_qkv + b -> bf16 qkv [R, 3D]
//   3. attn_core (attn_core.cuh):      per (sequence, head) softmax attention -> bf16 [R, D]
//   4. hopper_gemm<EPI_RESID_PLUS_ACC>: bf16((x + att @ W_out) + b)
// The split is numerically the TPU kernel's: it rounds LN(x), qkv and each
// head's output to bf16 at exactly these points, so each launch reads what
// the TPU kernel would have held in VMEM, rounded where it rounds it.
//
// Bound on the H100: 8*R*D^2 + 4*B*D*pairs flops over ~4*R*D + 8*D^2 bytes,
// far above the 295 flop/byte ridge, so tensor-core operations bound it (the
// LN pass alone is bytes-bound: 4 bytes per element). The LN is taken once
// per row, not once per column tile of the QKV product; the two products
// run on wgmma fed by TMA, one persistent warp-specialised block per SM; the
// attention core keeps its scores in registers (mma.sync m16n8k16). What is
// left above the bound is the HBM round trip of LN(x), qkv [R, 3D] and att
// [R, D] (~12 bytes per row element of x), which a fused kernel removes.
#include "attn_core.cuh"
#include "gemm_sm90.cuh"
#include "layernorm.cuh"

using leclip::bf16;

extern "C" {

// Shared memory the attention-core launch needs at sequence length t and
// head width dh (the wrapper refuses shapes above the card's 227 KB).
size_t leclip_attn_core_smem(int t, int dh) {
  return leclip::attn_smem((t + 31) / 32 * 32, dh);
}

// x, out: [b*t, d]; qkv scratch [b*t, 3d]; att scratch [b*t, d]; weights
// [d, 3d] and [d, d] in [in, out] layout; all bf16, contiguous, on the card.
// d % 128 == 0, d <= 1024, d / n_heads in {32, 64, 128}. Four launches on
// `stream`; returns the first cudaError_t that is not cudaSuccess.
int leclip_attn_block_bf16(const void* x, const void* ln_s, const void* ln_b,
                           const void* qkv_w, const void* qkv_b,
                           const void* out_w, const void* out_b, void* qkv,
                           void* att, void* out, int b, int t, int d,
                           int n_heads, int kv_len, int causal, float eps,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = b * t;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* qkv_b16 = static_cast<bf16*>(qkv);
  bf16* att_b16 = static_cast<bf16*>(att);
  // bf16(LN(x)) goes into the att scratch, free until the core writes it
  cudaError_t err = leclip::launch_ln_bf16(xb, static_cast<const bf16*>(ln_s),
                                           static_cast<const bf16*>(ln_b), att_b16, rows, d, eps,
                                           s);
  if (err != cudaSuccess) return (int)err;
  err = leclip::launch_hopper_gemm<leclip::EPI_BIAS>(
      att_b16, static_cast<const bf16*>(qkv_w), static_cast<const bf16*>(qkv_b), nullptr, qkv_b16,
      rows, d, 3 * d, s);
  if (err != cudaSuccess) return (int)err;
  err = leclip::launch_attn_any(qkv_b16, att_b16, b, t, d, n_heads, kv_len, causal, s);
  if (err != cudaSuccess) return (int)err;
  return (int)leclip::launch_hopper_gemm<leclip::EPI_RESID_PLUS_ACC>(
      att_b16, static_cast<const bf16*>(out_w), static_cast<const bf16*>(out_b), xb,
      static_cast<bf16*>(out), rows, d, d, s);
}

}  // extern "C"
