// Resident-head attention over packed heads, for sm_90a:
//   out[b, t, h*64:(h+1)*64] = softmax(q_h k_h^T * 64^-0.5, keys >= kv_len masked) v_h
// on the [B, T, 3W] qkv buffer that the QKV projection writes (q, k, v are
// its three thirds), output [B, T, W].
//
// Replaces the TPU kernel leclip_tpu/ops/flash_attention.py resident_attention
// (_resident_call / _resident_kernel). Its rounding points: s = (q.k) * scale
// in fp32, pad keys masked before the max, p = exp(s - max) rounded to the
// operand type unnormalised, out = (p.v) / (p.1) with both sums in fp32 over
// the rounded p (the ones-column), rounded once.
//   bf16: exactly the attention core of the bf16 / int8 attention blocks
//         (attn_core.cuh: mma.sync m16n8k16, scores in registers), which
//         rounds at those points; no mask but the pad keys.
//   fp32: the CUDA-core core of attn_simt.cuh (fp32 FMA; no tensor core, so
//         no TF32 rounding of the reference-parity path), RESIDENT mode, the
//         register-tiled loops it shares with fp32 flash_attention.
// Head width 64 only. Keys past kv_len are never visited (their p is 0).
//
// Bound on the H100 at the ViT-B/16 shape [610, 200, 768], kv_len 197:
// 4*B*H*T*kv_len*64 = 74 GFLOP over 4*B*T*W*s bytes (0.38 GB in fp32) — the
// operations bound both types (fp32 on the CUDA cores at 67 TFLOP/s: 1.1 ms;
// bf16 on the tensor cores: 0.075 ms against 0.11 ms of bytes, so bytes).
// The fp32 design keeps a query tile's scores in shared memory and streams
// K and V in double-buffered 64-key chunks; each thread holds an NI x 4
// register tile fed by float4 reads of both operands (attn_simt.cuh).
#include "attn_core.cuh"
#include "attn_simt.cuh"

extern "C" {

// Shared memory one launch needs at sequence length t, kv_len and operand
// type (1: bf16, 0: fp32); the wrapper refuses shapes above the card's 227 KB.
size_t leclip_resident_smem(int t, int kv_len, int is_bf16) {
  if (is_bf16) return leclip::attn_smem((t + 31) / 32 * 32, 64);
  return leclip::simt::smem_bytes(t, leclip::simt::score_lds(kv_len));
}

// qkv [b, t, 3w] contiguous (q, k, v its thirds), out [b, t, w]; w = 64 * n_heads;
// 1 <= kv_len <= t. One launch on `stream`; returns its cudaError_t.
int leclip_resident_attention(const void* qkv, void* out, int b, int t, int w, int n_heads,
                              int kv_len, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w != 64 * n_heads) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)leclip::launch_attn<64>(static_cast<const leclip::bf16*>(qkv),
                                        static_cast<leclip::bf16*>(out), b, t, w, n_heads,
                                        kv_len, 0, s);
  const float* base = static_cast<const float*>(qkv);
  leclip::simt::Params p{};
  p.q = base;
  p.k = base + w;
  p.v = base + 2 * w;
  p.o = static_cast<float*>(out);
  p.mask = nullptr;
  p.mask_rows = 0;
  p.n_heads = n_heads;
  p.tq = t;
  p.tk = t;
  p.kend = kv_len;
  p.block_k = kv_len;
  p.q_sb = p.kv_sb = (long long)t * 3 * w;
  p.q_sh = p.kv_sh = p.o_sh = 64;
  p.q_st = p.kv_st = 3 * w;
  p.o_sb = (long long)t * w;
  p.o_st = w;
  p.lds = leclip::simt::score_lds(kv_len);
  p.scale = 0.125f;  // 64^-0.5
  return (int)leclip::simt::launch_attn_simt<leclip::simt::RESIDENT>(p, b * n_heads, s);
}

}  // extern "C"
