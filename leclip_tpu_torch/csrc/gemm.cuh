// Tiled bf16 GEMM with a fused LayerNorm prologue and fused epilogues, the
// building block of both block kernels:
//
//   C[M, N] = epilogue( A'[M, K] @ W[K, N] )      (bf16 in, fp32 accumulate)
//   A' = bf16(LN(A)) (fp32 row statistics)  when LN, else A
//
// Tiles of 128x128x64 per block of 8 warps (each warp 64x32 = 4x2 wmma
// 16x16 fragments). A and W tiles are staged through shared memory by
// cp.async, three stages deep. With LN, every block first reads its 128 rows
// once for the fp32 row statistics, and each thread normalises the A chunks
// it copied in place (the bf16 rounding point of the TPU kernels) while the
// other warps run the products of the previous stage.
// K % 64 == 0 (K <= 1024 with LN), N % 128 == 0, any M.
//
// Built by nvcc for sm_90a into shared libraries with a plain C interface
// (leclip_tpu_torch/ops/_build.py); the Python wrappers pass raw device
// pointers and PyTorch's current stream, and check the returned cudaError_t.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace leclip {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

enum Epilogue : int {
  EPI_BIAS = 0,             // bf16(acc + b)
  EPI_BIAS_GELU = 1,        // h = acc + b; bf16(h * sigmoid(1.702 h))
  EPI_RESID_PLUS_ACC = 2,   // bf16((r + acc) + b)   (attention out-proj)
  EPI_RESID_PLUS_OUT = 3,   // bf16(r + (acc + b))   (MLP proj)
};

constexpr int TG_BM = 128, TG_BN = 128, TG_BK = 64;
constexpr int TG_STAGES = 3;
constexpr int TG_WARPS = 8;
constexpr int TG_THREADS = TG_WARPS * 32;
constexpr int TG_LDA = TG_BK + 8;    // 144-byte rows: 16-byte aligned, fewer bank conflicts
constexpr int TG_LDB = TG_BN + 8;    // 272-byte rows
constexpr int TG_LN_MAX_K = 1024;    // LN rows are held in registers: K <= 1024

struct GemmSmem {
  bf16 a[TG_STAGES][TG_BM * TG_LDA];
  bf16 b[TG_STAGES][TG_BK * TG_LDB];
  float mean[TG_BM];
  float rstd[TG_BM];
  bf16 ln_s[TG_LN_MAX_K];
  bf16 ln_b[TG_LN_MAX_K];
};  // 110 KB: two blocks per SM

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  const int bytes = valid ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gptr), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <bool LN, int EPI>
__global__ void __launch_bounds__(TG_THREADS)
tiled_gemm(const bf16* __restrict__ a, const bf16* __restrict__ ln_s,
           const bf16* __restrict__ ln_b, const bf16* __restrict__ w,
           const bf16* __restrict__ bias, const bf16* __restrict__ resid,
           bf16* __restrict__ out, int m, int k_dim, int n_dim, float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  GemmSmem& sm = *reinterpret_cast<GemmSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.y * TG_BM, col0 = blockIdx.x * TG_BN;
  const int wm = warp / 4, wn = warp % 4;  // warp tile: rows wm*64.., cols wn*32..
  const int n_k = k_dim / TG_BK;

  // 128x64 A tile and 64x128 W tile: 1024 16-byte chunks each, 4 per thread
  auto load_stage = [&](int buf, int kt) {
    const int k0 = kt * TG_BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * TG_THREADS;
      const int r = idx / 8, c = (idx % 8) * 8;
      const int gr = row0 + r;
      const bool ok = gr < m;
      cp_async16(&sm.a[buf][r * TG_LDA + c], a + (size_t)(ok ? gr : 0) * k_dim + k0 + c, ok);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + i * TG_THREADS;
      const int r = idx / 16, c = (idx % 16) * 8;
      cp_async16(&sm.b[buf][r * TG_LDB + c], w + (size_t)(k0 + r) * n_dim + col0 + c, true);
    }
  };

  // start the first stages, then (LN only) the row statistics while they land
#pragma unroll
  for (int st = 0; st < TG_STAGES - 1; ++st) {
    if (st < n_k) load_stage(st, st);
    cp_async_commit();
  }
  if (LN) {
    for (int c = tid; c < k_dim; c += TG_THREADS) {
      sm.ln_s[c] = ln_s[c];
      sm.ln_b[c] = ln_b[c];
    }
    // fp32 statistics as the TPU kernel takes them: mean, then the mean of
    // the centred squares; each lane holds its <= 4 chunks in registers
    for (int r = warp; r < TG_BM; r += TG_WARPS) {
      const int gr = row0 + r;
      float mean = 0.f, rstd = 0.f;
      if (gr < m) {
        const bf16* src = a + (size_t)gr * k_dim;
        float v[4][8];
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = (lane + 32 * i) * 8;
          if (c < k_dim) {
            uint4 u = *reinterpret_cast<const uint4*>(src + c);
            const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              v[i][j] = __bfloat162float(e[j]);
              s += v[i][j];
            }
          }
        }
        mean = warp_sum(s) / k_dim;
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if ((lane + 32 * i) * 8 < k_dim) {
#pragma unroll
            for (int j = 0; j < 8; ++j) q += (v[i][j] - mean) * (v[i][j] - mean);
          }
        }
        rstd = rsqrtf(warp_sum(q) / k_dim + eps);
      }
      if (lane == 0) {
        sm.mean[r] = mean;
        sm.rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  // normalise, in place, the A chunks of stage kt that this thread copied;
  // its 4 chunks share one 8-column slice, so the LN affine is read once
  auto normalise = [&](int kt) {
    const int buf = kt % TG_STAGES, c = (tid % 8) * 8, k0 = kt * TG_BK + c;
    const uint4 su = *reinterpret_cast<const uint4*>(&sm.ln_s[k0]);
    const uint4 bu = *reinterpret_cast<const uint4*>(&sm.ln_b[k0]);
    const bf16* sv = reinterpret_cast<const bf16*>(&su);
    const bf16* bv = reinterpret_cast<const bf16*>(&bu);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid + i * TG_THREADS) / 8;
      if (row0 + r < m) {
        uint4* p = reinterpret_cast<uint4*>(&sm.a[buf][r * TG_LDA + c]);
        uint4 u = *p;
        bf16* e = reinterpret_cast<bf16*>(&u);
        const float mean = sm.mean[r], rstd = sm.rstd[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float y = (__bfloat162float(e[j]) - mean) * rstd;
          e[j] = __float2bfloat16(y * __bfloat162float(sv[j]) + __bfloat162float(bv[j]));
        }
        *p = u;
      }
    }
  };

  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // the copies of stage 0 land (LN: and are normalised) before the loop;
  // inside, each thread normalises stage kt+1 while the other warps still
  // run the products of stage kt
  cp_async_wait<TG_STAGES - 2>();
  if (LN) normalise(0);
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt % TG_STAGES;
    __syncthreads();  // stage kt complete for all threads; stage kt-1's buffer is free
    const int nxt = kt + TG_STAGES - 1;
    if (nxt < n_k) load_stage(nxt % TG_STAGES, nxt);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < TG_BK; kk += 16) {
      FragA af[4];
      FragB bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], &sm.a[buf][(wm * 64 + i * 16) * TG_LDA + kk], TG_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], &sm.b[buf][kk * TG_LDB + wn * 32 + j * 16], TG_LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    cp_async_wait<TG_STAGES - 2>();  // this thread's copies of stage kt+1 have landed
    if (LN && kt + 1 < n_k) normalise(kt + 1);
  }
  cp_async_wait<0>();
  __syncthreads();  // the A stages become the epilogue's staging tiles

  // epilogue, one 16x16 fragment at a time through a per-warp staging tile;
  // each lane writes 8 consecutive columns of one row (one 16-byte store)
  float* st = reinterpret_cast<float*>(&sm.a[0][0]) + warp * 256;
  const int er = lane / 2, ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = row0 + wm * 64 + i * 16 + er;
      const int gc = col0 + wn * 32 + j * 16 + ec;
      if (gr < m) {
        alignas(16) bf16 o[8];
        uint4 rv = make_uint4(0, 0, 0, 0);
        if (EPI == EPI_RESID_PLUS_ACC || EPI == EPI_RESID_PLUS_OUT)
          rv = *reinterpret_cast<const uint4*>(resid + (size_t)gr * n_dim + gc);
        const bf16* rr = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float acc_v = st[er * 16 + ec + e];
          const float bv = __bfloat162float(bias[gc + e]);
          float v;
          if (EPI == EPI_BIAS) {
            v = acc_v + bv;
          } else if (EPI == EPI_BIAS_GELU) {
            const float h = acc_v + bv;
            v = h * (1.f / (1.f + expf(-1.702f * h)));
          } else if (EPI == EPI_RESID_PLUS_ACC) {
            v = (__bfloat162float(rr[e]) + acc_v) + bv;
          } else {
            v = __bfloat162float(rr[e]) + (acc_v + bv);
          }
          o[e] = __float2bfloat16(v);
        }
        *reinterpret_cast<uint4*>(out + (size_t)gr * n_dim + gc) = *reinterpret_cast<uint4*>(o);
      }
      __syncwarp();
    }
  }
}

template <bool LN, int EPI>
cudaError_t launch_tiled_gemm(const bf16* a, const bf16* ln_s, const bf16* ln_b,
                              const bf16* w, const bf16* bias, const bf16* resid,
                              bf16* out, int m, int k_dim, int n_dim, float eps,
                              cudaStream_t stream) {
  const int smem = (int)sizeof(GemmSmem);
  cudaError_t err = cudaFuncSetAttribute(tiled_gemm<LN, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_dim / TG_BN, (m + TG_BM - 1) / TG_BM);
  tiled_gemm<LN, EPI><<<grid, TG_THREADS, smem, stream>>>(a, ln_s, ln_b, w, bias, resid, out,
                                                          m, k_dim, n_dim, eps);
  return cudaGetLastError();
}

}  // namespace leclip
