// Flash attention over [B, H, T, 64] with an optional additive fp32 mask, for
// sm_90a. Replaces the TPU kernel leclip_tpu/ops/flash_attention.py
// flash_attention (_flash_attention_padded: _flash_kernel_single and
// _flash_kernel). The mask is one [Tk] key vector or a [Tq, Tk] matrix,
// clamped at -1e30 as the TPU wrapper clamps it. Keys past Tk (the TPU's zero
// pad, biased -1e30) are not visited: they add nothing to p.V, and to the sum
// only where every key of a row is masked, which the kernels add in closed form.
//
// Both rounding regimes of the TPU kernel:
//   Tk <= block_k (one key block; every CLIP length <= 256): p normalised by
//     its fp32 sum, then rounded to the operand type, then p.V;
//   Tk > block_k: online softmax with the running max and the rescale of the
//     accumulator at the block_k boundaries, the sum over fp32 p, p.V over p
//     rounded unnormalised, acc / l at the end.
// bf16 keeps both. In fp32 no rounding to the operand type sits between, so
// both regimes come to one softmax over all keys up to fp32 rounding, which
// the fp32 kernel takes wherever its scores fit shared memory.
// So a row whose every key is masked gets the TPU kernel's uniform p over Tk
// rounded up to the key block.
// q, k, v and the output take any element strides for (sequence, head, row)
// with contiguous head dims, so the [B, H, T, D] views of a packed qkv buffer
// go in without a transpose; every stride and base pointer must be 16-byte
// aligned (16-byte copies), which the wrapper checks. Head width 64 only.
//
// What bounds it on the H100 and what each type's design does about it, at
// the ViT-B/16 image tower [610, 12, 200, 64] with a pad mask (4*B*H*Tq*Tk*64
// = 75 GFLOP):
//   bf16 (flash_mma.cuh): the bytes (0.75 GB of q/k/v/o, 0.224 ms at 3.35
//     TB/s, against 0.075 ms of tensor-core flops): products on the tensor
//     cores by mma.sync, K/V by cp.async, scores in registers, recomputed in
//     each of two passes, the mask read only in the chunks where it is mixed;
//   fp32 (attn_simt.cuh): the operations, 1.1 ms of fp32 FMAs at 67 TFLOP/s
//     (no tensor core, so no TF32 rounding): register-tiled FMA loops with
//     both operands read from shared memory as float4, K/V double-buffered,
//     the query tile sized to T.
#include "flash_mma.cuh"
#include "attn_simt.cuh"

extern "C" {

// mask: nullptr, [tk] (mask_rows 0) or [tq, tk] (mask_rows tq), fp32
// contiguous. scratch: bf16 with a [tq, tk] mask, leclip_flash_scratch_bytes
// of device memory for its class map; else unused. Strides in elements.
// One launch on `stream` (two with a bf16 [tq, tk] mask).
size_t leclip_flash_scratch_bytes(int tq, int tk) {
  return (size_t)((tq + 15) / 16) * ((tk + 31) / 32);
}

int leclip_flash_attention(const void* q, const void* k, const void* v, void* o,
                           const void* mask, void* scratch, int mask_rows, int b, int h, int tq,
                           int tk, int block_k, long long q_sb, long long q_sh, long long q_st,
                           long long kv_sb, long long kv_sh, long long kv_st, long long o_sb,
                           long long o_sh, long long o_st, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = 0.125f;  // 64^-0.5
  if (is_bf16) {
    leclip::flash::Params f{};
    f.q = static_cast<const leclip::bf16*>(q);
    f.k = static_cast<const leclip::bf16*>(k);
    f.v = static_cast<const leclip::bf16*>(v);
    f.o = static_cast<leclip::bf16*>(o);
    f.mask = static_cast<const float*>(mask);
    f.cls = static_cast<unsigned char*>(scratch);
    f.n_heads = h;
    f.tq = tq;
    f.tk = tk;
    f.block_k = block_k;
    f.q_sb = q_sb;
    f.q_sh = q_sh;
    f.q_st = q_st;
    f.kv_sb = kv_sb;
    f.kv_sh = kv_sh;
    f.kv_st = kv_st;
    f.o_sb = o_sb;
    f.o_sh = o_sh;
    f.o_st = o_st;
    f.scale = scale;
    return (int)leclip::flash::launch(f, b * h, mask_rows, s);
  }
  leclip::simt::Params p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.mask = static_cast<const float*>(mask);
  p.mask_rows = mask_rows;
  p.n_heads = h;
  p.tq = tq;
  p.tk = tk;
  p.kend = tk;
  // one softmax block of all keys where its scores fit (attn_simt.cuh)
  const bool fits = leclip::simt::smem_bytes(tq, leclip::simt::score_lds(tk)) <= 232448;
  p.block_k = fits ? tk : block_k;
  p.npad = (tk + block_k - 1) / block_k * block_k - tk;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.q_st = q_st;
  p.kv_sb = kv_sb;
  p.kv_sh = kv_sh;
  p.kv_st = kv_st;
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_st = o_st;
  p.lds = leclip::simt::score_lds(tk < p.block_k ? tk : p.block_k);
  p.scale = scale;
  return (int)leclip::simt::launch_attn_simt<leclip::simt::FLASH>(p, b * h, s);
}

}  // extern "C"
