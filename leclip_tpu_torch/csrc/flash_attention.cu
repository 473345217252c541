// Flash attention over [B, H, T, 64] with an optional additive fp32 mask, for
// sm_90a. Replaces the TPU kernel leclip_tpu/ops/flash_attention.py
// flash_attention (_flash_attention_padded: _flash_kernel_single and
// _flash_kernel). The mask is one [Tk] key vector or a [Tq, Tk] matrix,
// clamped at -1e30 as the TPU wrapper clamps it; keys past Tk (the TPU's zero
// pad, biased -1e30) are never visited, which leaves every row with a real
// key unchanged.
//
// Both rounding regimes of the TPU kernel (attn_simt.cuh, FLASH mode):
//   Tk <= block_k (one key block; every CLIP length <= 256): p normalised by
//     its fp32 sum, then rounded to the operand type, then p.V;
//   Tk > block_k: online softmax with the running max and the rescale of the
//     accumulator at the block_k boundaries, the sum over fp32 p, p.V over p
//     rounded unnormalised, acc / l at the end.
// q, k, v and the output take any element strides for (sequence, head, row)
// with contiguous head dims, so the [B, H, T, D] views of a packed qkv buffer
// go in without a transpose. Head width 64 only.
//
// Bound on the H100 at the ViT-B/16 image tower [610, 12, 200, 64] with a pad
// mask: 4*B*H*Tq*Tk*64 = 75 GFLOP, in fp32 on the CUDA cores 1.1 ms — the
// operations bound it; in bf16 the bytes (0.15 GB q/k/v/o) do. This first
// version computes on the CUDA cores in both types (bf16 widened to fp32 in
// shared memory); wgmma / TMA are later work.
#include "attn_simt.cuh"

extern "C" {

// mask: nullptr, [tk] (mask_rows 0) or [tq, tk] (mask_rows tq), fp32
// contiguous. Strides in elements. One launch on `stream`.
int leclip_flash_attention(const void* q, const void* k, const void* v, void* o,
                           const void* mask, int mask_rows, int b, int h, int tq, int tk,
                           int block_k, long long q_sb, long long q_sh, long long q_st,
                           long long kv_sb, long long kv_sh, long long kv_st, long long o_sb,
                           long long o_sh, long long o_st, int is_bf16, void* stream) {
  leclip::simt::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.mask = static_cast<const float*>(mask);
  p.mask_rows = mask_rows;
  p.n_heads = h;
  p.tq = tq;
  p.tk = tk;
  p.kend = tk;
  p.block_k = block_k;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_st = q_st;
  p.kv_sb = kv_sb;
  p.kv_sh = kv_sh;
  p.kv_st = kv_st;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_st = o_st;
  p.lds = (tk < block_k ? tk : block_k) | 1;
  p.scale = 0.125f;  // 64^-0.5
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)leclip::simt::launch_attn_simt<__nv_bfloat16, leclip::simt::FLASH>(p, b * h, s);
  return (int)leclip::simt::launch_attn_simt<float, leclip::simt::FLASH>(p, b * h, s);
}

}  // extern "C"
