// Softmax attention on the CUDA cores (fp32 FMA), for sm_90a: the fp32 core
// of resident_attention and the core of flash_attention (fp32 and bf16
// operands). Every product is an fp32 FMA on values held in fp32 (bf16
// operands are widened on their way into shared memory, so their products
// are exact); no tensor core, hence no TF32 rounding in the fp32 path.
//
// One block of 256 threads per (sequence, head, 64-query tile). The Q tile
// sits transposed in shared memory for the whole block; K and V stream
// through one 64-key chunk buffer. Keys are walked in softmax blocks:
//   RESIDENT  one block of all kend keys: p = round(exp(s - max)) to the
//             operand type, unnormalised; out = (p.V) / sum(p), both sums over
//             the rounded p in fp32 (the TPU kernel's ones-column).
//   FLASH     kend <= block_k (one TPU key block): p normalised by its fp32
//             sum BEFORE the rounding, out = round(p).V;
//             kend > block_k: the TPU kernel's online softmax with its max
//             and rescale steps at the block_k boundaries; the running sum
//             takes the fp32 p, p.V the rounded one, out = acc / l at the end.
// Within a softmax block the scores of the 64 queries go to shared memory
// ([64][lds] fp32), so the block's max (and, for FLASH with one block, its
// sum) is known before any p is rounded: the rounding points are the TPU
// kernels', whatever the chunking. Scores are s = fl(fl(q.k * scale) + bias)
// with no FMA contraction, as the TPU kernel writes them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace leclip {
namespace simt {

constexpr int D = 64;         // head width: every CLIP preset's
constexpr int QT = 64;        // query rows per block
constexpr int KC = 64;        // keys per shared-memory chunk
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 register tile
constexpr int LDQ = QT + 4;   // Q^T rows [d][query]: 16-byte aligned float4 reads
constexpr int LDC = KC + 1;   // chunk rows: conflict-free transposed stores

enum Mode : int { RESIDENT = 0, FLASH = 1 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* mask;  // nullptr, one [tk] key vector (mask_rows == 0) or [tq, tk]
  int mask_rows;
  int n_heads, tq, tk;
  int kend;     // keys visited: [0, kend)
  int block_k;  // keys per softmax block (FLASH)
  long long q_sb, q_sh, q_st;  // element strides: sequence, head, row
  long long kv_sb, kv_sh, kv_st;
  long long o_sb, o_sh, o_st;
  int lds;  // row stride of the score buffer (odd: conflict-free row reads)
  float scale;
};

template <typename T>
__device__ __forceinline__ float widen(T x);
template <>
__device__ __forceinline__ float widen<float>(float x) { return x; }
template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as .to(bfloat16)
}

template <typename T>
__device__ __forceinline__ float round_to(float x) { return widen<T>(narrow<T>(x)); }

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

inline size_t smem_bytes(int lds) {
  return sizeof(float) * ((size_t)D * LDQ + (size_t)KC * LDC + (size_t)QT * lds + 3 * QT);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS) attn_simt(Params p) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                // [D][LDQ]   Q^T of the tile
  float* cs = qs + D * LDQ;      // [KC][LDC]  K^T chunk ([d][key]) or V chunk ([key][d])
  float* ss = cs + KC * LDC;     // [QT][lds]  scores, then p
  float* m_s = ss + QT * p.lds;  // [QT] running max (FLASH, several blocks)
  float* l_s = m_s + QT;         // [QT] running sum / denominator
  float* c_s = l_s + QT;         // [QT] rescale of the accumulator at this block

  const int qtiles = (p.tq + QT - 1) / QT;
  const int bh = blockIdx.x / qtiles, q0 = (blockIdx.x % qtiles) * QT;
  const int seq = bh / p.n_heads, head = bh % p.n_heads;
  const T* qg = static_cast<const T*>(p.q) + seq * p.q_sb + head * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + seq * p.kv_sb + head * p.kv_sh;
  const T* vg = static_cast<const T*>(p.v) + seq * p.kv_sb + head * p.kv_sh;
  T* og = static_cast<T*>(p.o) + seq * p.o_sb + head * p.o_sh;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < QT * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[d * LDQ + r] = q0 + r < p.tq ? widen<T>(qg[(q0 + r) * p.q_st + d]) : 0.f;
  }
  if (tid < QT) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
    c_s[tid] = 1.f;
  }

  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  const bool one_block = MODE == RESIDENT || p.kend <= p.block_k;
  const int sb = one_block ? p.kend : p.block_k;

  for (int kb0 = 0; kb0 < p.kend; kb0 += sb) {
    const int n = min(sb, p.kend - kb0);

    // ---- scores of this softmax block -> ss
    for (int c0 = 0; c0 < n; c0 += KC) {
      __syncthreads();  // the chunk buffer and ss are free
      for (int i = tid; i < KC * D; i += THREADS) {
        const int kk = i / D, d = i % D;
        cs[d * LDC + kk] = c0 + kk < n ? widen<T>(kg[(kb0 + c0 + kk) * p.kv_st + d]) : 0.f;
      }
      __syncthreads();
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + d * LDQ + ty * 4);
        const float* kr = cs + d * LDC + tx;
        const float k0 = kr[0], k1 = kr[16], k2 = kr[32], k3 = kr[48];
        acc[0][0] += qv.x * k0; acc[0][1] += qv.x * k1; acc[0][2] += qv.x * k2; acc[0][3] += qv.x * k3;
        acc[1][0] += qv.y * k0; acc[1][1] += qv.y * k1; acc[1][2] += qv.y * k2; acc[1][3] += qv.y * k3;
        acc[2][0] += qv.z * k0; acc[2][1] += qv.z * k1; acc[2][2] += qv.z * k2; acc[2][3] += qv.z * k3;
        acc[3][0] += qv.w * k0; acc[3][1] += qv.w * k1; acc[3][2] += qv.w * k2; acc[3][3] += qv.w * k3;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, row = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = c0 + tx + 16 * j;
          if (kk < n) {
            const int key = kb0 + kk;
            float bias = 0.f;
            if (p.mask != nullptr) {
              const float mv = p.mask_rows == 0 ? p.mask[key]
                               : row < p.tq    ? p.mask[(long long)row * p.tk + key]
                                               : 0.f;
              bias = fmaxf(mv, -1e30f);  // the TPU wrapper's clamp of -inf
            }
            ss[r * p.lds + kk] = __fadd_rn(__fmul_rn(acc[i][j], p.scale), bias);
          }
        }
      }
    }
    __syncthreads();

    // ---- softmax of each row: warp w takes rows 8w .. 8w+7
    for (int rr = 0; rr < QT / 8; ++rr) {
      const int r = warp * (QT / 8) + rr;
      float* srow = ss + r * p.lds;
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, srow[j]);
      mx = row_max(mx);
      float sum = 0.f;
      if (MODE == RESIDENT) {
        for (int j = lane; j < n; j += 32) {
          const float e = round_to<T>(expf(srow[j] - mx));
          srow[j] = e;
          sum += e;
        }
        sum = row_sum(sum);
        if (lane == 0) l_s[r] = sum;
      } else if (one_block) {
        for (int j = lane; j < n; j += 32) {
          const float e = expf(srow[j] - mx);
          srow[j] = e;
          sum += e;
        }
        sum = row_sum(sum);
        for (int j = lane; j < n; j += 32) srow[j] = round_to<T>(__fdiv_rn(srow[j], sum));
      } else {
        const float m_prev = m_s[r];
        const float m_cur = fmaxf(m_prev, mx);
        const float corr = expf(m_prev - m_cur);
        for (int j = lane; j < n; j += 32) {
          const float e = expf(srow[j] - m_cur);
          sum += e;
          srow[j] = round_to<T>(e);
        }
        sum = row_sum(sum);  // every lane has read m_s[r] before lane 0 writes it
        if (lane == 0) {
          l_s[r] = __fadd_rn(__fmul_rn(l_s[r], corr), sum);
          m_s[r] = m_cur;
          c_s[r] = corr;
        }
      }
    }
    __syncthreads();

    // ---- acc = acc * corr + p.V
    if (!one_block) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float corr = c_s[ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] *= corr;
      }
    }
    for (int c0 = 0; c0 < n; c0 += KC) {
      if (c0 > 0) __syncthreads();  // the previous V chunk is consumed
      for (int i = tid; i < KC * D; i += THREADS) {
        const int kk = i / D, d = i % D;
        cs[kk * LDC + d] = c0 + kk < n ? widen<T>(vg[(kb0 + c0 + kk) * p.kv_st + d]) : 0.f;
      }
      __syncthreads();
      const int nk = min(KC, n - c0);
      const float* pr = ss + ty * 4 * p.lds + c0;
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk) {
        const float p0 = pr[kk], p1 = pr[p.lds + kk], p2 = pr[2 * p.lds + kk],
                    p3 = pr[3 * p.lds + kk];
        const float* vr = cs + kk * LDC + tx;
        const float v0 = vr[0], v1 = vr[16], v2 = vr[32], v3 = vr[48];
        o[0][0] += p0 * v0; o[0][1] += p0 * v1; o[0][2] += p0 * v2; o[0][3] += p0 * v3;
        o[1][0] += p1 * v0; o[1][1] += p1 * v1; o[1][2] += p1 * v2; o[1][3] += p1 * v3;
        o[2][0] += p2 * v0; o[2][1] += p2 * v1; o[2][2] += p2 * v2; o[2][3] += p2 * v3;
        o[3][0] += p3 * v0; o[3][1] += p3 * v1; o[3][2] += p3 * v2; o[3][3] += p3 * v3;
      }
    }
  }

  // ---- out: RESIDENT acc / sum(p); FLASH one block acc; several blocks acc / l
  const bool divide = MODE == RESIDENT || !one_block;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.tq) continue;
    const float den = divide ? l_s[ty * 4 + i] : 1.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      og[row * p.o_st + tx + 16 * j] = narrow<T>(divide ? __fdiv_rn(o[i][j], den) : o[i][j]);
  }
}

// One launch over n_bh = sequences x heads; blocks are (bh, 64-query tile).
template <typename T, int MODE>
cudaError_t launch_attn_simt(const Params& p, int n_bh, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.lds);
  cudaError_t err = cudaFuncSetAttribute(attn_simt<T, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int qtiles = (p.tq + QT - 1) / QT;
  attn_simt<T, MODE><<<n_bh * qtiles, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace simt
}  // namespace leclip
