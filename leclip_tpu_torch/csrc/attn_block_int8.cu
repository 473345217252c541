// Pre-LN attention sub-block with an int8 QKV projection (W8A8), for sm_90a:
//   out = x + OutProj(MHA(int8 QKV(LN(x))))
//
// Replaces the TPU kernel leclip_tpu/ops/quant_kernels.py attn_block_int8
// (_attn_block_kernel). Four launches:
//   0. ln_quant_rows (quant.cuh): xi int8 [R, D], xs fp32 [R] = quantize(LN(x)),
//      into the att buffer, which launch 2 overwrites once launch 1 has read them
//   1. hopper_gemm_s8<IEPI_BIAS> (gemm_int8.cuh): bf16(acc * (xs * s_col) + b) -> bf16 qkv [R, 3D]
//   2. attn_core (attn_core.cuh): per (sequence, head) softmax attention -> bf16 [R, D]
//   3. hopper_gemm<RESID_PLUS_ACC> (gemm_sm90.cuh): bf16((x + att @ W_out) + b)
// Launches 2 and 3 are the bf16 block's own: the TPU kernel keeps the
// attention core and the out-projection in bf16 too, with the same rounding
// points (bf16 qkv, bf16 unnormalised p, fp32 sum of p, bf16 head outputs).
// The TPU kernel holds a group of whole sequences in VMEM; here the int8
// rows, qkv and per-head outputs go through HBM between the launches.
//
// Bound on the H100: 6*R*D^2 int8 operations + (2*R*D^2 + 4*B*D*pairs) bf16
// flops over ~4*R*D + 5*D^2 bytes, far above the ridge, so tensor-core
// operations bound it. Both products run on wgmma fed by TMA, one
// persistent warp-specialised block per SM: the QKV product on the int8
// tensor cores (m64n256k32 .s8, both operands K-major as the int8 weights
// are kept, the fp32 rescale + bias in the accumulator registers), the bf16
// out-projection on gemm_sm90.cuh. What is left above the bound is the HBM
// round trip of qkv [R, 3D] and att [R, D], which a fused launch removes.
#include "attn_core.cuh"
#include "gemm_int8.cuh"
#include "gemm_sm90.cuh"

using leclip::bf16;

extern "C" {

// Shared memory the attention-core launch needs at sequence length t and
// head width dh (the wrapper refuses shapes above the card's 227 KB).
size_t leclip_attn_core_smem(int t, int dh) {
  return leclip::attn_smem((t + 31) / 32 * 32, dh);
}

// x, out: [b*t, d] bf16; ln_s / ln_b [d] bf16; qkv_wt: the int8 QKV weight
// as [3d, d] (K contiguous); qkv_s [3d] fp32; qkv_b [3d], out_w [d, d] ([in,
// out]), out_b [d] bf16; qkv scratch [b*t, 3d], att scratch [b*t, d] bf16
// (it also holds the LN rows' codes and scales, (d + 4) bytes a row, until
// the attention core overwrites it); contiguous, on the card. d % 128 == 0,
// d <= 1024, d / n_heads in {32, 64, 128}. Four launches on `stream`;
// returns the first cudaError_t that is not cudaSuccess.
int leclip_attn_block_int8(const void* x, const void* ln_s, const void* ln_b, const void* qkv_wt,
                           const void* qkv_s, const void* qkv_b, const void* out_w,
                           const void* out_b, void* qkv, void* att, void* out, int b, int t,
                           int d, int n_heads, int kv_len, int causal, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = b * t;
  bf16* qkv_b16 = static_cast<bf16*>(qkv);
  bf16* att_b16 = static_cast<bf16*>(att);
  int8_t* xi = static_cast<int8_t*>(att);
  float* xs = reinterpret_cast<float*>(xi + (size_t)rows * d);
  cudaError_t err = leclip::launch_ln_quant(
      static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s), static_cast<const bf16*>(ln_b),
      xi, xs, rows, d, eps, s);
  if (err != cudaSuccess) return (int)err;
  err = leclip::launch_int8_gemm<leclip::IEPI_BIAS>(
      xi, static_cast<const int8_t*>(qkv_wt), xs, nullptr, static_cast<const float*>(qkv_s),
      static_cast<const bf16*>(qkv_b), nullptr, qkv_b16, rows, d, 3 * d, s);
  if (err != cudaSuccess) return (int)err;
  err = leclip::launch_attn_any(qkv_b16, att_b16, b, t, d, n_heads, kv_len, causal, s);
  if (err != cudaSuccess) return (int)err;
  return (int)leclip::launch_hopper_gemm<leclip::EPI_RESID_PLUS_ACC>(
      att_b16, static_cast<const bf16*>(out_w), static_cast<const bf16*>(out_b),
      static_cast<const bf16*>(x), static_cast<bf16*>(out), rows, d, d, s);
}

}  // extern "C"
