// The attention core of both attention blocks (bf16 and int8 QKV) and of
// bf16 resident_attention, for sm_90a: per (sequence, head) softmax
// attention over packed bf16 qkv [R, 3D] -> bf16 [R, D], with the TPU
// kernels' rounding points (bf16 qkv, bf16 unnormalised p, fp32 sum of p,
// bf16 head outputs). It is the middle launch of what replaces
// leclip_tpu/ops/block_kernels.py _attn_block_bf16_kernel and
// quant_kernels.py _attn_block_kernel, and the bf16 half of
// flash_attention.py resident_attention.
//
// Bound on the H100: per (sequence, head) 4*T*kv_len*dh flops (QK^T and PV)
// against 2*4*T*dh bytes (q, k, v read, o written), 2*kv_len/4 flop/byte,
// under the 295 ridge at T ~ 200: the qkv read and the output write bound it
// (R*D*(3+1)*2 bytes / 3.35 TB/s; 0.22 ms at the ViT-B/16 TTA shape).
//
// Design: one block per (sequence, head), K and V of the head brought into
// shared memory row-major by 16-byte cp.async (zero past t), no transpose.
// The block has as many warps (<= 8) as spread its 16-query tiles evenly over
// the fewest rounds (13 tiles at T = 200: 7 warps, 2 rounds). Each warp walks
// the keys in chunks of 32 with mma.sync m16n8k16 (bf16 in, fp32
// accumulate), its K fragments read by ldmatrix and its V fragments by
// ldmatrix.trans, twice: pass 1 finds each row's max of the raw products
// (the scale is positive, so max(S)*c = max(S*c) exactly); pass 2 forms
// s*log2(e) = S*c - max*c in one fused multiply-add, rounds p =
// bf16(exp2(...)) — the TPU kernel's rounding point, which online-softmax
// rescaling would not keep — sums the bf16 p in fp32 for the denominator,
// and feeds p straight from the score registers into p @ V. Only key chunks
// that hold masked keys (past kv_len, or above the causal diagonal) pay for
// the mask; chunks masked for every row of a tile are skipped (their p is
// exactly 0 and they never hold a row's max).
#pragma once

#include "gemm.cuh"

namespace leclip {

constexpr int ATTN_MAX_WARPS = 8;

__device__ __forceinline__ void mma16816(float* c, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned ld32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
// the fp32 sum of the two bf16 halves of a packed pair
__device__ __forceinline__ float sum2(unsigned p) {
  return __uint_as_float(p << 16) + __uint_as_float(p & 0xffff0000u);
}

template <int DH>
__global__ void __launch_bounds__(ATTN_MAX_WARPS * 32, DH == 128 ? 1 : 2)
attn_core(const bf16* __restrict__ qkv, bf16* __restrict__ att, int t, int t32, int d,
          int n_heads, int kv_len, int causal, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = DH + 8;  // 16-byte aligned rows, conflict-free ldmatrix
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [t32][LD]
  bf16* vs = ks + (size_t)t32 * LD;           // [t32][LD]
  const int seq = blockIdx.x / n_heads, head = blockIdx.x % n_heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  const int g = lane >> 2, tq = lane & 3;
  const size_t rs = 3 * (size_t)d;
  const bf16* base = qkv + (size_t)seq * t * rs + head * DH;

  constexpr int C8 = DH / 8;
  for (int i = threadIdx.x; i < t32 * C8; i += blockDim.x) {
    const int r = i / C8, c = (i % C8) * 8;
    const bool ok = r < t;
    const bf16* src = base + (size_t)(ok ? r : 0) * rs + c;
    cp_async16(ks + r * LD + c, src + d, ok);
    cp_async16(vs + r * LD + c, src + 2 * d, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // ldmatrix row addresses of this lane: matrix i = lane / 8, row lane % 8
  const int mi = lane >> 3, mr = lane & 7;
  // K (B of S = Q K^T, "col" layout = K rows): matrices (dh 0-7, 8-15) of two k16 steps
  const bf16* k_lane = ks + mr * LD + (mi & 1) * 8 + (mi >> 1) * 16;
  // V (B of O = P V): keys 0-7 / 8-15 of a k16 step, two 8-wide dh tiles
  const bf16* v_lane = vs + ((mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;

  const int n_qt = (t + 15) / 16;
  for (int qt = warp; qt < n_qt; qt += n_warps) {
    const int q0 = qt * 16;
    const int r0 = q0 + g, r1 = q0 + g + 8;
    unsigned qa[DH / 16][4];
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e & 1) ? r1 : r0;
        const int col = kk * 16 + ((e & 2) ? 8 : 0) + 2 * tq;
        qa[kk][e] = row < t ? ld32(base + row * rs + col) : 0u;
      }
    }
    const int kend = causal ? min(kv_len, q0 + 16) : kv_len;
    const int n_chunks = (kend + 31) / 32;

    auto products = [&](int kc, float (&sc)[4][4]) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
        const bf16* kp = k_lane + (kc * 32 + nt * 8) * LD;
#pragma unroll
        for (int kk = 0; kk < DH / 16; kk += 2) {
          unsigned b[4];
          ldsm_x4(b, kp + kk * 16);
          mma16816(sc[nt], qa[kk], b[0], b[1]);
          mma16816(sc[nt], qa[kk + 1], b[2], b[3]);
        }
      }
    };
    // -inf where a key is masked for a row; only chunks that reach past
    // kv_len or the causal diagonal hold such keys
    auto mask = [&](int kc, float (&sc)[4][4]) {
      if (kc * 32 + 32 <= kv_len && !(causal && kc * 32 + 31 > q0)) return;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kc * 32 + nt * 8 + 2 * tq + (e & 1);
          const int row = e < 2 ? r0 : r1;
          if (col >= kv_len || (causal && col > row)) sc[nt][e] = -INFINITY;
        }
      }
    };

    float m0 = -INFINITY, m1 = -INFINITY;
    for (int kc = 0; kc < n_chunks; ++kc) {
      float sc[4][4];
      products(kc, sc);
      mask(kc, sc);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        m0 = fmaxf(m0, fmaxf(sc[nt][0], sc[nt][1]));
        m1 = fmaxf(m1, fmaxf(sc[nt][2], sc[nt][3]));
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
    }
    const float n0 = -m0 * scale_log2, n1 = -m1 * scale_log2;

    float l0 = 0.f, l1 = 0.f;
    float oacc[DH / 8][4];
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn) oacc[dn][0] = oacc[dn][1] = oacc[dn][2] = oacc[dn][3] = 0.f;
    for (int kc = 0; kc < n_chunks; ++kc) {
      float sc[4][4];
      products(kc, sc);
      mask(kc, sc);
      unsigned pa[2][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        // rows g: keys 2tq, 2tq+1; rows g+8 (masked keys: exp2(-inf) = 0)
        const unsigned p01 = pack2(fast_exp2(fmaf(sc[nt][0], scale_log2, n0)),
                                   fast_exp2(fmaf(sc[nt][1], scale_log2, n0)));
        const unsigned p23 = pack2(fast_exp2(fmaf(sc[nt][2], scale_log2, n1)),
                                   fast_exp2(fmaf(sc[nt][3], scale_log2, n1)));
        l0 += sum2(p01);
        l1 += sum2(p23);
        pa[nt / 2][(nt & 1) * 2 + 0] = p01;
        pa[nt / 2][(nt & 1) * 2 + 1] = p23;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bf16* vp = v_lane + (kc * 32 + j * 16) * LD;
#pragma unroll
        for (int dn = 0; dn < DH / 8; dn += 2) {
          unsigned b[4];
          ldsm_x4_t(b, vp + dn * 8);
          mma16816(oacc[dn], pa[j], b[0], b[1]);
          mma16816(oacc[dn + 1], pa[j], b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o);
    }
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn) {
      const int col = head * DH + dn * 8 + 2 * tq;
      if (r0 < t)
        *reinterpret_cast<__nv_bfloat162*>(att + ((size_t)seq * t + r0) * d + col) =
            __floats2bfloat162_rn(oacc[dn][0] / l0, oacc[dn][1] / l0);
      if (r1 < t)
        *reinterpret_cast<__nv_bfloat162*>(att + ((size_t)seq * t + r1) * d + col) =
            __floats2bfloat162_rn(oacc[dn][2] / l1, oacc[dn][3] / l1);
    }
  }
}

inline size_t attn_smem(int t32, int dh) { return 2 * (size_t)t32 * (dh + 8) * sizeof(bf16); }

template <int DH>
cudaError_t launch_attn(const bf16* qkv, bf16* att, int b, int t, int d, int n_heads,
                        int kv_len, int causal, cudaStream_t stream) {
  const int t32 = (t + 31) / 32 * 32;
  const size_t smem = attn_smem(t32, DH);
  cudaError_t err = cudaFuncSetAttribute(attn_core<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // the fewest rounds of 16-query tiles over <= 8 warps, then as few warps
  // as those rounds need
  const int n_qt = (t + 15) / 16;
  const int rounds = (n_qt + ATTN_MAX_WARPS - 1) / ATTN_MAX_WARPS;
  const int warps = (n_qt + rounds - 1) / rounds;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)DH);  // dh^-0.5 * log2(e)
  attn_core<DH><<<b * n_heads, warps * 32, smem, stream>>>(qkv, att, t, t32, d, n_heads, kv_len,
                                                           causal, scale_log2);
  return cudaGetLastError();
}

// The core at head width dh (32, 64 or 128); any other width is refused.
inline cudaError_t launch_attn_any(const bf16* qkv, bf16* att, int b, int t, int d, int n_heads,
                                   int kv_len, int causal, cudaStream_t stream) {
  switch (d / n_heads) {
    case 32: return launch_attn<32>(qkv, att, b, t, d, n_heads, kv_len, causal, stream);
    case 64: return launch_attn<64>(qkv, att, b, t, d, n_heads, kv_len, causal, stream);
    case 128: return launch_attn<128>(qkv, att, b, t, d, n_heads, kv_len, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace leclip
