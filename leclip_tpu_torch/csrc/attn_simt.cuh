// fp32 softmax attention on the CUDA cores, for sm_90a: the fp32 core of
// resident_attention (RESIDENT) and of flash_attention (FLASH), which replace
// leclip_tpu/ops/flash_attention.py resident_attention and flash_attention
// in fp32. Every product is an fp32 FMA: no tensor core, hence no TF32
// rounding on the reference-parity path.
//
// Bound on the H100: the operations. At the ViT-B/16 image tower (610 x 12
// heads, 200 queries, 200 / 197 keys) that is 4*T*Tk*64 flops per head, 75
// GFLOP, 1.1 ms at 67 TFLOP/s, against 0.45 ms for the 1.5 GB of q/k/v/o.
// So the inner loops must keep the FMA pipes fed: each thread holds an
// NI x 4 register tile (NI query rows, 4 keys or 4 head dims) and reads both
// operands from shared memory as float4 (NI + 4 loads for 16*NI FMAs), rows
// XOR-swizzled so that a warp's float4 reads fall in distinct banks without
// padding (three blocks fit an SM at T = 200). K and V come in 64-key chunks
// by 16-byte cp.async, double-buffered, so the next chunk's copy runs under
// the current chunk's FMAs (the first V chunk's under the softmax); a short
// last chunk is multiplied only for the 16-key groups that hold keys. The
// query tile is 8*NI rows with NI in 5..8 picked for the least padding that
// fits (T = 200: 40 rows, none wasted; T = 77: 40, 3 wasted; T = 264: 40,
// 16 wasted). The softmax runs eight lanes to a row, so that four rows'
// reductions overlap in a warp.
//
// One block of 128 threads (8 x 16) per (sequence, head, query tile). Keys
// are walked in softmax blocks:
//   RESIDENT  one block of all kend keys: p = exp(s - max) unnormalised,
//             out = (p.V) / sum(p), both sums in fp32 (the TPU kernel's
//             ones-column);
//   FLASH     the same, over one block of all keys wherever its scores
//             fit shared memory (up to 1,180 keys). The TPU kernel
//             normalises p before p.V with one key block, and rescales at
//             its 256-key block boundaries with several, but in fp32 no
//             rounding to the operand type sits between: both come to this
//             up to fp32 rounding. Past that size, softmax blocks of block_k
//             keys with the online max and rescale steps, out = acc / l.
// Within a softmax block the scores of the tile go to shared memory
// ([8*NI][lds] fp32), so the block's max is known before any p is formed:
// the TPU kernels' rounding points, whatever the chunking. Scores are s = fl(fl(q.k * scale) + bias)
// with no FMA contraction, as the TPU kernel writes them; the bias is added
// in the softmax's first walk over a row, where a warp reads the mask row
// coalesced. FLASH counts the TPU's zero pad keys past tk (bias -1e30) in
// the sum, which changes only a row whose every key is masked. With a
// [tq, tk] mask, a key chunk masked for every row of the tile is not
// multiplied: its products are taken as 0, and fl(0 + -1e30) = -1e30 is what
// they would give (|q.k * scale| is far below half an ulp of 1e30); where
// every row of the tile then has a score above -1e29, its p are exactly 0
// and its p.V is skipped too (causal tiles skip the keys past their
// diagonal).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "gemm.cuh"

namespace leclip {
namespace simt {

constexpr int D = 64;         // head width: every CLIP preset's
constexpr int KC = 64;        // keys per shared-memory chunk
constexpr int THREADS = 128;  // 8 (ty) x 16 (tx)
constexpr float NEG = -1e30f;

// Q and K/V chunk rows of 64 floats, unpadded; the 16 float4 of row r are
// stored XOR-swizzled by r % 8, so that the float4 reads of a quarter warp
// (8 rows at one column, or 8 columns of one row) fall in distinct banks
__device__ __forceinline__ int sw(int r, int c4) { return r * (D / 4) + (c4 ^ (r & 7)); }

enum Mode : int { RESIDENT = 0, FLASH = 1 };

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  const float* mask;  // nullptr, one [tk] key vector (mask_rows == 0) or [tq, tk]
  int mask_rows;
  int n_heads, tq, tk;
  int kend;     // keys visited: [0, kend)
  int block_k;  // keys per softmax block (FLASH)
  int npad;     // FLASH: the TPU's zero pad keys past tk, counted in the sum
  long long q_sb, q_sh, q_st;  // element strides: sequence, head, row
  long long kv_sb, kv_sh, kv_st;
  long long o_sb, o_sh, o_st;
  int lds;  // row stride of the score buffer: score_lds(keys of one softmax block)
  float scale;
};

// the score rows: float4-aligned (a quarter warp reads one row at a time)
inline int score_lds(int n) { return (n + 3) / 4 * 4; }

inline size_t smem_at(int ni, int lds) {
  const size_t qt = 8 * ni;
  return sizeof(float) * (qt * D + 2 * (size_t)KC * D + qt * lds + 3 * qt);
}

// query rows per thread for tq queries: of the NI whose shared memory fits a
// block (232,448 bytes on the H100), the one that pads tq least to a multiple
// of 8*NI, the smaller NI on a tie (less shared memory, more blocks on an
// SM); 5 where none fits (the wrapper refuses)
inline int pick_ni(int tq, int lds) {
  int best = 5, waste = 0;
  for (int ni = 5; ni <= 8; ++ni) {
    const int w = (tq + 8 * ni - 1) / (8 * ni) * (8 * ni);
    if (smem_at(ni, lds) <= 232448 && (waste == 0 || w < waste)) best = ni, waste = w;
  }
  return best;
}

inline size_t smem_bytes(int tq, int lds) { return smem_at(pick_ni(tq, lds), lds); }

// max / sum over the eight lanes of a row
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void fma4(float (&a)[4], float x, const float4& y) {
  a[0] = fmaf(x, y.x, a[0]);
  a[1] = fmaf(x, y.y, a[1]);
  a[2] = fmaf(x, y.z, a[2]);
  a[3] = fmaf(x, y.w, a[3]);
}

// acc[i][j] = q(row ty + 8i) . k(key tx + 16j) for the first JN key groups
template <int NI, int JN>
__device__ __forceinline__ void score_tile(const float4* qs, const float4* ks, int ty, int tx,
                                           float (&acc)[NI][4]) {
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    float4 kv[JN];
#pragma unroll
    for (int j = 0; j < JN; ++j) kv[j] = ks[sw(tx + 16 * j, d4)];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float4 qv = qs[sw(ty + 8 * i, d4)];
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        acc[i][j] = fmaf(qv.x, kv[j].x, acc[i][j]);
        acc[i][j] = fmaf(qv.y, kv[j].y, acc[i][j]);
        acc[i][j] = fmaf(qv.z, kv[j].z, acc[i][j]);
        acc[i][j] = fmaf(qv.w, kv[j].w, acc[i][j]);
      }
    }
  }
}

template <int MODE, int NI>
__global__ void __launch_bounds__(THREADS) attn_simt(Params p) {
  constexpr int QT = 8 * NI;
  extern __shared__ __align__(16) float sm[];
  float4* qs = reinterpret_cast<float4*>(sm);  // [QT][16] Q tile, swizzled
  float4* cb = qs + QT * (D / 4);  // 2 x [KC][16] K or V chunks, double-buffered, swizzled
  float* ss = reinterpret_cast<float*>(cb + 2 * KC * (D / 4));  // [QT][lds] scores, then p
  float* m_s = ss + QT * p.lds;  // [QT] running max (FLASH, several blocks)
  float* l_s = m_s + QT;         // [QT] running sum / denominator
  float* c_s = l_s + QT;         // [QT] rescale of the accumulator at this block

  const int qtiles = (p.tq + QT - 1) / QT;
  const int bh = blockIdx.x / qtiles, q0 = (blockIdx.x % qtiles) * QT;
  const int seq = bh / p.n_heads, head = bh % p.n_heads;
  const float* qg = p.q + seq * p.q_sb + head * p.q_sh;
  const float* kg = p.k + seq * p.kv_sb + head * p.kv_sh;
  const float* vg = p.v + seq * p.kv_sb + head * p.kv_sh;
  float* og = p.o + seq * p.o_sb + head * p.o_sh;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;

  const bool one_block = MODE == RESIDENT || p.kend <= p.block_k;
  const int sb = one_block ? p.kend : p.block_k;
  // the TPU's zero pad keys (FLASH): all in the last key block
  const float npad = (float)p.npad;

  // the chunk stream, in the order it is consumed: per softmax block its K
  // chunks, then its V chunks. `fetch` copies the next one into `dst`.
  int n_kb0 = 0, n_v = 0, n_c = 0;
  auto fetch = [&](float4* dst) {
    if (n_kb0 < p.kend) {
      const int n = min(sb, p.kend - n_kb0);
      const int key0 = n_kb0 + n_c * KC, nk = min(KC, n - n_c * KC);
      const float* src = n_v ? vg : kg;
      for (int i = tid; i < KC * 16; i += THREADS) {
        const int r = i / 16, c = (i % 16) * 4;
        const bool ok = r < nk;
        cp_async16(dst + sw(r, c / 4), src + (long long)(key0 + (ok ? r : 0)) * p.kv_st + c, ok);
      }
      if (++n_c == (n + KC - 1) / KC) {
        n_c = 0;
        if (n_v) n_kb0 += sb;
        n_v ^= 1;
      }
    }
    cp_async_commit();
  };

  for (int i = tid; i < QT * 16; i += THREADS) {
    const int r = i / 16, c = (i % 16) * 4;
    const bool ok = q0 + r < p.tq;
    cp_async16(qs + sw(r, c / 4), qg + (long long)(ok ? q0 + r : 0) * p.q_st + c, ok);
  }
  fetch(cb);  // one group: the Q tile and the first K chunk
  if (tid < QT) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
    c_s[tid] = 1.f;
  }

  float o[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  int step = 0;  // chunks consumed; chunk `step` sits in buffer step & 1

  for (int kb0 = 0; kb0 < p.kend; kb0 += sb) {
    const int n = min(sb, p.kend - kb0);
    const int nc = (n + KC - 1) / KC;

    // ---- scores of this softmax block -> ss
    unsigned skipped = 0;  // chunks masked for every row of the tile
    for (int c = 0; c < nc; ++c, ++step) {
      fetch(cb + ((step + 1) & 1) * KC * (D / 4));
      cp_async_wait<1>();
      __syncthreads();
      const float4* ks = cb + (step & 1) * KC * (D / 4);
      const int nk = min(KC, n - c * KC);
      // a [tq, tk] mask that masks the whole chunk for every row of the tile:
      // no products; its scores are fl(0 + -1e30), what they would be
      bool skip = false;
      if (MODE == FLASH && p.mask_rows) {
        bool masked = true;
        for (int i = tid; i < QT * KC; i += THREADS) {
          const int r = i / KC, kk = i % KC;
          if (kk < nk && q0 + r < p.tq)
            masked &= p.mask[(long long)(q0 + r) * p.tk + kb0 + c * KC + kk] <= NEG;
        }
        skip = __syncthreads_and(masked);
        skipped |= (unsigned)skip << c;
      }
      float acc[NI][4];
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      if (!skip) {
        // only the 16-key column groups that hold keys: a short last chunk
        // (ViT-B/16's 197 = 3 x 64 + 5) costs a quarter of a full one
        switch ((nk + 15) / 16) {
          case 1: score_tile<NI, 1>(qs, ks, ty, tx, acc); break;
          case 2: score_tile<NI, 2>(qs, ks, ty, tx, acc); break;
          case 3: score_tile<NI, 3>(qs, ks, ty, tx, acc); break;
          default: score_tile<NI, 4>(qs, ks, ty, tx, acc); break;
        }
      }
      // fl(q.k * scale); the mask's bias is added row by row in the softmax
      const bool edge = c * KC + KC > n;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = c * KC + tx + 16 * j;
          if (!edge || kk < n) ss[(ty + 8 * i) * p.lds + kk] = __fmul_rn(acc[i][j], p.scale);
        }
      }
      __syncthreads();  // the chunk is consumed; for the last, ss is complete
    }

    // ---- softmax of each row: eight lanes to a row, a warp takes four rows
    // at a time (their reductions overlap); p past n is 0
    bool live = true;  // every real row has a score above -1e29
    const int sub = lane % 8;
    for (int r0 = 0; r0 < QT; r0 += THREADS / 8) {
      const int r = r0 + warp * 4 + lane / 8;
      const bool on = r < QT;
      float* srow = ss + r * p.lds;
      float mx = NEG;
      if (on) {
        if (MODE == FLASH && p.mask != nullptr) {
          // s = fl(fl(q.k * scale) + bias), the bias the mask clamped at -1e30
          const int row = q0 + r;
          const float* mrow = p.mask_rows == 0 ? p.mask + kb0
                              : row < p.tq     ? p.mask + (long long)row * p.tk + kb0
                                               : nullptr;
          for (int j = sub; j < n; j += 8) {
            const float sj = mrow ? __fadd_rn(srow[j], fmaxf(mrow[j], NEG)) : srow[j];
            srow[j] = sj;
            mx = fmaxf(mx, sj);
          }
        } else {
          for (int j = sub; j < n; j += 8) mx = fmaxf(mx, srow[j]);
        }
      }
      mx = group_max(mx);
      const float m_prev = one_block || !on ? NEG : m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
      if (on)
        for (int j = sub; j < n; j += 8) {
          const float e = expf(srow[j] - m_cur);
          srow[j] = e;
          sum += e;
        }
      sum = group_sum(sum);  // every lane has read m_s[r] before the first writes it
      if (kb0 + sb >= p.kend) sum += npad * expf(NEG - m_cur);
      live &= !on || q0 + r >= p.tq || m_cur > -1e29f;
      if (on && sub == 0) {
        if (one_block) {
          l_s[r] = sum;
        } else {
          const float corr = expf(m_prev - m_cur);
          l_s[r] = __fadd_rn(__fmul_rn(l_s[r], corr), sum);
          m_s[r] = m_cur;
          c_s[r] = corr;
        }
      }
      if (on && sub < (4 - n % 4) % 4) srow[n + sub] = 0.f;
    }
    // a skipped chunk's p are exactly 0 where every row is live: no p.V
    const unsigned no_pv = __syncthreads_and(live) ? skipped : 0u;

    // ---- o = o * corr + p.V
    if (!one_block) {
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float corr = c_s[ty + 8 * i];
        o[i][0] *= corr; o[i][1] *= corr; o[i][2] *= corr; o[i][3] *= corr;
      }
    }
    for (int c = 0; c < nc; ++c, ++step) {
      fetch(cb + ((step + 1) & 1) * KC * (D / 4));
      cp_async_wait<1>();
      __syncthreads();
      const float4* vs = cb + (step & 1) * KC * (D / 4);
      const float* ps = ss + ty * p.lds + c * KC;
      const int nk4 = (no_pv >> c) & 1 ? 0 : (min(KC, n - c * KC) + 3) / 4;
#pragma unroll 2
      for (int k4 = 0; k4 < nk4; ++k4) {
        float4 vv[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) vv[kk] = vs[sw(k4 * 4 + kk, tx)];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const float4 pp = *reinterpret_cast<const float4*>(ps + 8 * i * p.lds + k4 * 4);
          fma4(o[i], pp.x, vv[0]);
          fma4(o[i], pp.y, vv[1]);
          fma4(o[i], pp.z, vv[2]);
          fma4(o[i], pp.w, vv[3]);
        }
      }
      __syncthreads();
    }
  }

  // ---- out = o / l
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = ty + 8 * i, row = q0 + r;
    if (row >= p.tq) continue;
    const float den = l_s[r];
    float4 v;
    v.x = __fdiv_rn(o[i][0], den);
    v.y = __fdiv_rn(o[i][1], den);
    v.z = __fdiv_rn(o[i][2], den);
    v.w = __fdiv_rn(o[i][3], den);
    *reinterpret_cast<float4*>(og + row * p.o_st + tx * 4) = v;
  }
}

template <int MODE, int NI>
cudaError_t launch_ni(const Params& p, int n_bh, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.tq, p.lds);
  cudaError_t err = cudaFuncSetAttribute(attn_simt<MODE, NI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int qtiles = (p.tq + 8 * NI - 1) / (8 * NI);
  attn_simt<MODE, NI><<<n_bh * qtiles, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// One launch over n_bh = sequences x heads; blocks are (bh, query tile).
template <int MODE>
cudaError_t launch_attn_simt(const Params& p, int n_bh, cudaStream_t stream) {
  switch (pick_ni(p.tq, p.lds)) {
    case 5: return launch_ni<MODE, 5>(p, n_bh, stream);
    case 6: return launch_ni<MODE, 6>(p, n_bh, stream);
    case 7: return launch_ni<MODE, 7>(p, n_bh, stream);
    default: return launch_ni<MODE, 8>(p, n_bh, stream);
  }
}

}  // namespace simt
}  // namespace leclip
