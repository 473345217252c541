// The attention core of both attention blocks (bf16 and int8 QKV), for
// sm_90a: per (sequence, head) softmax attention over packed bf16 qkv
// [R, 3D] -> bf16 [R, D], with the TPU kernels' rounding points (bf16 qkv,
// bf16 unnormalised p, fp32 sum of p, bf16 head outputs).
#pragma once

#include "gemm.cuh"

namespace leclip {

constexpr int ATTN_WARPS = 4;

// One block (4 warps) per (sequence, head); K [t32, DH] and V^T [DH, t32]
// of the head in shared memory (zero past t). Each warp takes 16-query
// tiles and walks the keys in chunks of 32 with mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), twice: pass 1 finds each row's max of s = S*dh^-0.5 +
// bias; pass 2 recomputes s, rounds p = bf16(exp(s - max)) — the TPU
// kernel's rounding point, which online-softmax rescaling would not keep —
// sums the bf16 p in fp32 for the denominator, and feeds p straight from
// the score registers into p @ V. Key chunks that are masked for every row
// of a tile (past kv_len, or above the causal diagonal) are skipped: their
// p is exactly 0 and they never hold a row's max.

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

__device__ __forceinline__ unsigned pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

template <int DH>
__global__ void __launch_bounds__(ATTN_WARPS * 32)
attn_core(const bf16* __restrict__ qkv, bf16* __restrict__ att, int t, int t32,
          int d, int n_heads, int kv_len, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDK = DH + 8;  // padded rows: conflict-free fragment loads
  const int ldv = t32 + 8;
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [t32][LDK]
  bf16* vt = ks + (size_t)t32 * LDK;          // [DH][ldv]
  const int seq = blockIdx.x / n_heads, head = blockIdx.x % n_heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const size_t rs = 3 * (size_t)d;
  const bf16* base = qkv + (size_t)seq * t * rs + head * DH;

  constexpr int V8 = DH / 8;
  for (int i = threadIdx.x; i < t32 * V8; i += blockDim.x) {
    const int r = i / V8, c = (i % V8) * 8;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (r < t) {
      kv = *reinterpret_cast<const uint4*>(base + r * rs + d + c);
      vv = *reinterpret_cast<const uint4*>(base + r * rs + 2 * d + c);
    }
    *reinterpret_cast<uint4*>(ks + r * LDK + c) = kv;
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int j = 0; j < 8; ++j) vt[(c + j) * ldv + r] = ve[j];
  }
  __syncthreads();

  const int n_qt = (t + 15) / 16;
  for (int qt = warp; qt < n_qt; qt += ATTN_WARPS) {
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

    auto scores = [&](int kc, float (&sc)[4][4]) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
        const bf16* krow = ks + (kc * 32 + nt * 8 + g) * LDK + 2 * tq;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          mma16816(sc[nt], qa[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kc * 32 + nt * 8 + 2 * tq + (e & 1);
          const int row = e < 2 ? r0 : r1;
          const bool valid = col < kv_len && !(causal && col > row);
          sc[nt][e] = sc[nt][e] * scale + (valid ? 0.f : -1e30f);
        }
      }
    };

    float m0 = -INFINITY, m1 = -INFINITY;
    for (int kc = 0; kc < n_chunks; ++kc) {
      float sc[4][4];
      scores(kc, sc);
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

    float l0 = 0.f, l1 = 0.f;
    float oacc[DH / 8][4];
#pragma unroll
    for (int dn = 0; dn < DH / 8; ++dn) oacc[dn][0] = oacc[dn][1] = oacc[dn][2] = oacc[dn][3] = 0.f;
    for (int kc = 0; kc < n_chunks; ++kc) {
      float sc[4][4];
      scores(kc, sc);
      unsigned pa[2][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16 p0 = __float2bfloat16(expf(sc[nt][0] - m0));
        const bf16 p1 = __float2bfloat16(expf(sc[nt][1] - m0));
        const bf16 p2 = __float2bfloat16(expf(sc[nt][2] - m1));
        const bf16 p3 = __float2bfloat16(expf(sc[nt][3] - m1));
        l0 += __bfloat162float(p0) + __bfloat162float(p1);
        l1 += __bfloat162float(p2) + __bfloat162float(p3);
        pa[nt / 2][(nt & 1) * 2 + 0] = pack2(p0, p1);  // rows g:   keys 2tq, 2tq+1
        pa[nt / 2][(nt & 1) * 2 + 1] = pack2(p2, p3);  // rows g+8
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int dn = 0; dn < DH / 8; ++dn) {
          const bf16* vrow = vt + (dn * 8 + g) * ldv + kc * 32 + j * 16 + 2 * tq;
          mma16816(oacc[dn], pa[j], ld32(vrow), ld32(vrow + 8));
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

inline size_t attn_smem(int t32, int dh) {
  return ((size_t)t32 * (dh + 8) + (size_t)dh * (t32 + 8)) * sizeof(bf16);
}

template <int DH>
cudaError_t launch_attn(const bf16* qkv, bf16* att, int b, int t, int d, int n_heads,
                        int kv_len, int causal, cudaStream_t stream) {
  const int t32 = (t + 31) / 32 * 32;
  const size_t smem = attn_smem(t32, DH);
  cudaError_t err = cudaFuncSetAttribute(attn_core<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)DH);
  attn_core<DH><<<b * n_heads, ATTN_WARPS * 32, smem, stream>>>(
      qkv, att, t, t32, d, n_heads, kv_len, causal, scale);
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
