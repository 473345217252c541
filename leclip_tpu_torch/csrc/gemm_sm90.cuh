// The bf16 GEMM of the block kernels, for sm_90a (Hopper), with the fused
// epilogues of the TPU kernels:
//
//   C[M, N] = epilogue( A[M, K] @ W[K, N] )      (bf16 in, fp32 accumulate)
//
// It carries the four products of attn_block_bf16 and mlp_bf16 (QKV,
// out-proj, fc, proj: leclip_tpu/ops/block_kernels.py _attn_block_bf16_kernel
// and _mlp_bf16_kernel) and the out-proj of attn_block_int8. At the ViT-B/16
// shape (M = 122,000, K and N 768..3072) each product does 144-576 GFLOP on
// 2-3 bytes per flop-row, far above the H100's 295 flop/byte ridge: the
// tensor cores bound it, and only wgmma reaches their rate.
//
// Design: one persistent block per SM walks 128x256 output tiles (row-major
// tile order; W, at most 4.7 MB, stays in L2). Three warpgroups:
//   - a producer warp (warpgroup 2, one thread) streams 128x64 A tiles and
//     64x256 W tiles into a ring of three shared-memory stages by TMA
//     (cp.async.bulk.tensor, 128-byte swizzle), each stage guarded by a
//     "full" mbarrier (TMA bytes landed) and an "empty" one (both consumers
//     done reading); it runs ahead across tile boundaries, so the next tile's
//     loads overlap this tile's epilogue;
//   - two consumer warpgroups, 64 rows each, issue wgmma.mma_async
//     m64n256k16 (fp32 accumulators: 128 registers a thread) straight from
//     the swizzled stages. A is K-major; W keeps the port's [in, out] layout
//     (N contiguous), an MN-major B operand read with the transpose-B flag,
//     so no weight is ever transposed.
//   - each consumer group runs its own epilogue in the accumulator registers
//     (bias, QuickGELU, residual, in the fp32 order of the TPU kernels),
//     writes bf16 into its 64 rows of a swizzled 128x256 shared tile (whose
//     residual it prefetched there by cp.async during the main loop) and
//     leaves by TMA store, which clips the ragged last row tile. The groups
//     share no barrier but the stage ring, so one's epilogue overlaps the
//     other's first products of the next tile.
// K % 64 == 0, N % 128 == 0 (a last 128-wide column tile is masked), any M;
// every pointer 16-byte aligned.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_runtime.h>

#include <cstdint>

#include "gemm.cuh"

namespace leclip {

enum Epilogue : int {
  EPI_BIAS = 0,             // bf16(acc + b)
  EPI_BIAS_GELU = 1,        // h = acc + b; bf16(h * sigmoid(1.702 h))
  EPI_RESID_PLUS_ACC = 2,   // bf16((r + acc) + b)   (attention out-proj)
  EPI_RESID_PLUS_OUT = 3,   // bf16(r + (acc + b))   (MLP proj)
};

constexpr int HG_BM = 128, HG_BN = 256, HG_BK = 64;
constexpr int HG_STAGES = 3;
constexpr int HG_CONSUMERS = 2;                      // warpgroups of 64 rows
constexpr int HG_THREADS = (HG_CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int HG_CHUNKS = HG_BN / 64;                // 128-byte column chunks of a W / C tile
constexpr uint32_t HG_A_BYTES = HG_BM * HG_BK * 2;   // 16 KB
constexpr uint32_t HG_W_CHUNK = HG_BK * 64 * 2;      // 8 KB: [64 k][64 n]

// every array starts on a 1024-byte boundary (the 128-byte swizzle's period)
struct HopperGemmSmem {
  bf16 a[HG_STAGES][HG_BM * HG_BK];               // [128 rows][64 k], swizzled
  bf16 w[HG_STAGES][HG_CHUNKS][HG_BK * 64];       // per 64 columns: [64 k][64 n], swizzled
  bf16 c[HG_CHUNKS][HG_BM * 64];                  // per 64 columns: [128 rows][64 n], swizzled
  uint64_t full[HG_STAGES];
  uint64_t empty[HG_STAGES];
};
constexpr int HG_SMEM = (int)sizeof(HopperGemmSmem) + 1024;  // + alignment slack: 214,064 B

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// returns once the phase of parity `parity` has completed; a wait of more
// than ~2^34 cycles (seconds) is a broken pipeline and traps, so the launch
// fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// ---- TMA
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait_read() {  // smem sources may be reused
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void tma_store_wait() {  // the stores are complete
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_shared() {  // generic smem writes -> TMA
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void warpgroup_sync(int wg) {  // the 128 threads of one warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// ---- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across a
// wgmma fence / wait (the asynchronous product writes them behind its back)
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define LECLIP_F8(i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64, 256] (+)= A[64, 16] (K-major) @ B[16, 256] (MN-major: transpose-B = 1)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : LECLIP_F8(0), LECLIP_F8(8), LECLIP_F8(16), LECLIP_F8(24), LECLIP_F8(32), LECLIP_F8(40),
        LECLIP_F8(48), LECLIP_F8(56), LECLIP_F8(64), LECLIP_F8(72), LECLIP_F8(80), LECLIP_F8(88),
        LECLIP_F8(96), LECLIP_F8(104), LECLIP_F8(112), LECLIP_F8(120)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
#undef LECLIP_F8

// the epilogue of one element, fp32, in the TPU kernels' order
template <int EPI>
__device__ __forceinline__ float epilogue(float acc, float b, float r) {
  if (EPI == EPI_BIAS) return acc + b;
  if (EPI == EPI_BIAS_GELU) {  // h * sigmoid(1.702 h) by the fast exp and divide:
    const float h = acc + b;     // ~1e-6 relative, far below the bf16 rounding that follows
    return __fdividef(h, 1.f + __expf(-1.702f * h));
  }
  if (EPI == EPI_RESID_PLUS_ACC) return (r + acc) + b;
  return r + (acc + b);
}

template <int EPI>
__global__ void __launch_bounds__(HG_THREADS, 1)
hopper_gemm(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
            const __grid_constant__ CUtensorMap tm_c, const bf16* __restrict__ bias,
            const bf16* __restrict__ resid, int m, int n, int k) {
  constexpr bool RESID = EPI == EPI_RESID_PLUS_ACC || EPI == EPI_RESID_PLUS_OUT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  HopperGemmSmem& sm =
      *reinterpret_cast<HopperGemmSmem*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));
  const int n_n = (n + HG_BN - 1) / HG_BN;
  const int tiles = (m + HG_BM - 1) / HG_BM * n_n;
  const int n_k = k / HG_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < HG_STAGES; ++s) {
      mbar_init(&sm.full[s], 1);                     // the producer's expect_tx
      mbar_init(&sm.empty[s], HG_CONSUMERS * 4);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == HG_CONSUMERS) {
    // ---------------- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile / n_n * HG_BM, col0 = tile % n_n * HG_BN;
        const int chunks = min(HG_CHUNKS, (n - col0) / 64);
        for (int kt = 0; kt < n_k; ++kt) {
          mbar_wait(&sm.empty[stage], phase ^ 1);
          mbar_expect_tx(&sm.full[stage], HG_A_BYTES + chunks * HG_W_CHUNK);
          tma_load(sm.a[stage], &tm_a, &sm.full[stage], kt * HG_BK, row0);
          for (int c = 0; c < chunks; ++c)
            tma_load(sm.w[stage][c], &tm_w, &sm.full[stage], col0 + 64 * c, kt * HG_BK);
          if (++stage == HG_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---------------- consumers: wgmma on the stages, then the epilogue
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = threadIdx.x % 128;  // thread of this consumer warpgroup
    const int warp = ct / 32, lane = ct % 32;
    const int wr0 = wg * 64;  // this warpgroup's 64 rows of every tile
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = tile / n_n * HG_BM, col0 = tile % n_n * HG_BN;
      // this group's previous TMA store has read its rows of the C tile: they
      // may be refilled (each group owns its rows, so the two never wait on
      // each other here and one's epilogue overlaps the other's products)
      if (ct == 0) tma_store_wait_read();
      warpgroup_sync(wg);
      if (RESID) {  // prefetch this tile's residual into the C tile, behind the main loop
#pragma unroll 4
        for (int i = 0; i < 64 * HG_BN / 8 / 128; ++i) {
          const int q = ct + i * 128;
          const int r = wr0 + q / (HG_BN / 8), p = q % (HG_BN / 8);
          const int gr = row0 + r, gc = col0 + p * 8;
          const bool ok = gr < m && gc < n;
          cp_async16(sm.c[p / 8] + r * 64 + ((p % 8) ^ (r % 8)) * 8,
                     resid + (ok ? (size_t)gr * n + gc : 0), ok);
        }
        cp_async_commit();
      }

      const uint32_t a_base = smem_u32(sm.a[0]) + wr0 * HG_BK * 2;
      const uint32_t w_base = smem_u32(sm.w[0][0]);
      int prev = 0;
      fence_acc(acc);
      for (int kt = 0; kt < n_k; ++kt) {
        mbar_wait(&sm.full[stage], phase);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HG_BK / 16; ++kk) {
          // A: 128-byte rows, 8-row groups 1024 B apart; a k16 step is 32 B along the row
          const uint64_t da = wgmma_desc(a_base + stage * HG_A_BYTES + kk * 32, 16, 1024);
          // W: 64-column chunks 8 KB apart (LBO), 8-row k groups 1024 B apart (SBO);
          // a k16 step is 16 rows of 128 B
          const uint64_t dw = wgmma_desc(w_base + stage * HG_CHUNKS * HG_W_CHUNK + kk * 2048,
                                         HG_W_CHUNK, 1024);
          wgmma_m64n256k16(acc, da, dw, (kt | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-tile's products are done with their stage
        if (kt > 0 && lane == 0) mbar_arrive(&sm.empty[prev]);
        prev = stage;
        if (++stage == HG_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&sm.empty[prev]);

      if (RESID) {
        cp_async_wait<0>();
        warpgroup_sync(wg);  // every thread's residual copies have landed
      }
      // accumulator layout: warp w of the group holds rows 16w.., lane (g, tq)
      // holds rows g and g+8, columns 8j + 2tq, +1 of every 8-column group j
      const int g = lane / 4, tq = lane % 4;
      const int r_lo = wr0 + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < HG_BN / 8; ++j) {
        const int gc = col0 + 8 * j + 2 * tq;
        float2 bv = make_float2(0.f, 0.f);
        if (gc < n) bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + gc));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r_lo + 8 * h;
          __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
              sm.c[j / 8] + r * 64 + ((j % 8) ^ (r % 8)) * 8 + 2 * tq);
          float2 rv = make_float2(0.f, 0.f);
          if (RESID) rv = __bfloat1622float2(*p);
          *p = __floats2bfloat162_rn(epilogue<EPI>(acc[4 * j + 2 * h], bv.x, rv.x),
                                     epilogue<EPI>(acc[4 * j + 2 * h + 1], bv.y, rv.y));
        }
      }
      fence_async_shared();
      warpgroup_sync(wg);
      if (ct == 0 && row0 + wr0 < m) {
        const int chunks = min(HG_CHUNKS, (n - col0) / 64);
        for (int c = 0; c < chunks; ++c)
          tma_store(&tm_c, sm.c[c] + wr0 * 64, col0 + 64 * c, row0 + wr0);
        tma_store_commit();
      }
    }
    if (ct == 0) tma_store_wait();
  }
}

// ---- host side
using TensorMapEncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                          const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                          const cuuint32_t*, CUtensorMapInterleave,
                                          CUtensorMapSwizzle, CUtensorMapL2promotion,
                                          CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; the runtime hands out its entry
// point, so nothing links against libcuda itself
inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncodeTiled>(p);
  }
  return fn;
}

// a row-major bf16 [outer, inner] matrix, boxes of [box_outer, box_inner]
// (box_inner * 2 = 128 bytes), 128-byte swizzle, zeros out of bounds
inline bool bf16_tensor_map(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t outer,
                            uint32_t box_inner, uint32_t box_outer) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * sizeof(bf16)};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// out[m, n] = EPI(a[m, k] @ w[k, n]); bias [n]; resid [m, n] for the
// residual epilogues (else unused). One launch on `stream`.
template <int EPI>
cudaError_t launch_hopper_gemm(const bf16* a, const bf16* w, const bf16* bias, const bf16* resid,
                               bf16* out, int m, int k, int n, cudaStream_t stream) {
  if (m == 0) return cudaSuccess;
  if (k % HG_BK || n % 128) return cudaErrorInvalidValue;
  CUtensorMap ta, tw, tc;
  if (!bf16_tensor_map(&ta, a, k, m, 64, HG_BM) || !bf16_tensor_map(&tw, w, n, k, 64, HG_BK) ||
      !bf16_tensor_map(&tc, out, n, m, 64, 64))
    return cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(hopper_gemm<EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, HG_SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = (m + HG_BM - 1) / HG_BM * ((n + HG_BN - 1) / HG_BN);
  hopper_gemm<EPI><<<tiles < sms ? tiles : sms, HG_THREADS, HG_SMEM, stream>>>(
      ta, tw, tc, bias, resid, m, n, k);
  return cudaGetLastError();
}

}  // namespace leclip
