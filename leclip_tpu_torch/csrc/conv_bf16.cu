// NHWC bf16 convolution for sm_90a (Hopper) whose every output element is
// summed in one order fixed by K alone, so that an image's output does not
// depend on the batch it is computed in:
//
//   out[b, oh, ow, n] = bf16( sum_k A[m, k] * W[n, k] )     (fp32 accumulate)
//
// an implicit GEMM with M = B*Ho*Wo output positions, N = Cout and
// K = kh*kw*Cin walked as (kh, kw, cin), the order of the port's stored
// weight [out, kh, kw, in] (models/resnet.conv_layout), which is a K-major B
// operand as it stands. A[m, k] is the input pixel under tap (kh, kw) of
// output position m, zero in the "SAME" padding (pads given by the caller,
// as lax.conv_general_dilated computes them, the stem's (0, 1) included).
//
// Replaces no Pallas kernel: the JAX package leaves its convolutions to XLA
// (leclip_tpu/models/resnet.py conv2d), which gives an image the same values
// at every batch size. cuDNN's bf16 kernels, chosen by shape, do not: this
// is the port's repair of that fault (ops/conv_kernels.py).
//
// Independence by construction: one output tile is summed by one block, over
// every K tile in order, with one wgmma shape (m64nBNk16) whose tile width BN
// is chosen from Cout alone; no split-K, no atomics, nothing chosen by M. The
// fp32 sum is rounded to bf16 once, JAX's single rounding point. Channels
// are a multiple of 8 (the wrapper zero-fills the stem's 3); K tiles past K
// and weight rows past Cout are zeros, and adding +0 leaves an fp32 sum as
// it was.
//
// Bound on the H100: at RN50's 224² crops the trunk's 55 convolutions do
// 10.7 GFLOP a crop and move 45.7 MB of bf16 activations a crop (each input
// read and each output written once; the 47 MB of weights once a call),
// about 235 flop a byte, near the 295 flop/byte ridge: at 610 crops 34 of
// them are bound by bytes and 21 by tensor-core operations.
// Design: one persistent block per SM walks 128 x BN output tiles (BN = 256
// where Cout >= 256, 128, or 64 where Cout <= 64), row-major, so
// neighbouring blocks share their A rows in L2. Three warpgroups, the
// registers split 56 / 224 between producer and consumers (setmaxnreg):
//   - a producer warpgroup fills a ring of 128-byte-swizzled stages (four,
//     three at BN = 256) with the 128 x 64 A tile of each K step, gathered by
//     cp.async from L2 (8 threads a row, 16 bytes each, zero-filled out of
//     the image or past K; through L1 the 3x3 convolutions ran slower), and
//     one of its threads loads the BN x 64 weight tile by TMA into the same
//     stage. Each thread fences its copies into the async proxy and arrives
//     on the stage's "full" barrier STAGES - 2 steps later, with that many
//     steps of gathers in flight behind it. (A halo of input rows loaded once
//     a tile into shared memory, to read each pixel once instead of once a
//     tap, gave the same bits no faster on RN50's 3x3 convolutions: PERF.md.)
//   - two consumer warpgroups, 64 rows each, run wgmma straight from the
//     stages (both operands K-major) into fp32 registers, release each stage
//     by its "empty" barrier, round to bf16 once into a staged tile in shared
//     memory and store it as coalesced 16-byte row chunks, while the producer
//     already fills the next tile. The epilogue can fuse the trunk's chain
//     after a convolution, with PyTorch's bf16 rounding at every step (each
//     step in fp32 of the bf16 values, rounded to nearest even):
//       y = bf16(acc); y = bf16(y * scale); y = bf16(y + offset)   batch norm
//       [y = bf16(y + residual)]  [y = max(y, 0)]
//     which equals models/resnet's unfused chain bit for bit.
// Cin % 8 == 0, Cout % 8 == 0, 16-byte-aligned pointers; any batch.
#include "gemm_sm90.cuh"

namespace leclip {

constexpr int CV_BM = 128, CV_BK = 64;
constexpr int CV_CONSUMERS = 2;                    // warpgroups of 64 rows
constexpr int CV_THREADS = (CV_CONSUMERS + 1) * 128;
constexpr uint32_t CV_A_BYTES = CV_BM * CV_BK * 2;  // 16 KB

// stages of the ring (three at BN = 256, to fit shared memory), and the
// gathers a producer thread leaves in flight before it marks a stage full: a
// consumer frees a stage one K step late, so at most STAGES - 2
template <int BN>
struct ConvTile {
  static constexpr int STAGES = BN == 256 ? 3 : 4;
  static constexpr int LAG = STAGES - 2;
};

template <int BN>
struct ConvSmem {  // every array starts on a 1024-byte boundary (the swizzle's period)
  static constexpr int S = ConvTile<BN>::STAGES;
  bf16 a[S][CV_BM * CV_BK];  // [128 rows][64 k], swizzled
  bf16 w[S][BN * CV_BK];     // [BN rows][64 k], swizzled
  // each consumer group's 64 output rows, padded by 16 bytes a row (the
  // accumulator's row-pair writes and the 16-byte row reads hit distinct banks)
  bf16 c[CV_CONSUMERS][64 * (BN + 8)];
  uint64_t full[S];
  uint64_t empty[S];
};

struct ConvArgs {
  const bf16* x;         // [b, h, w, cin]
  bf16* out;             // [b, ho, wo, cout]
  const bf16* scale;     // [cout] batch norm's multiply, or null: no epilogue chain
  const bf16* offset;    // [cout] its add
  const bf16* residual;  // [b, ho, wo, cout] added after the batch norm, or null
  int relu;
  int h, w, cin, ho, wo, cout, kw, stride, pad_top, pad_left, k, m;
};

#define LECLIP_CV8(i)                                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D[64, BN] (+)= A[64, 16] @ B[16, BN], both K-major (no transpose)
template <int BN>
__device__ __forceinline__ void wgmma_kmajor(float (&d)[BN / 2], uint64_t da, uint64_t db,
                                             int scale_d);

template <>
__device__ __forceinline__ void wgmma_kmajor<64>(float (&d)[32], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : LECLIP_CV8(0), LECLIP_CV8(8), LECLIP_CV8(16), LECLIP_CV8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_kmajor<128>(float (&d)[64], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : LECLIP_CV8(0), LECLIP_CV8(8), LECLIP_CV8(16), LECLIP_CV8(24), LECLIP_CV8(32),
        LECLIP_CV8(40), LECLIP_CV8(48), LECLIP_CV8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_kmajor<256>(float (&d)[128], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : LECLIP_CV8(0), LECLIP_CV8(8), LECLIP_CV8(16), LECLIP_CV8(24), LECLIP_CV8(32),
        LECLIP_CV8(40), LECLIP_CV8(48), LECLIP_CV8(56), LECLIP_CV8(64), LECLIP_CV8(72),
        LECLIP_CV8(80), LECLIP_CV8(88), LECLIP_CV8(96), LECLIP_CV8(104), LECLIP_CV8(112),
        LECLIP_CV8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}
#undef LECLIP_CV8

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ __nv_bfloat162 bf2_mul(__nv_bfloat162 y, __nv_bfloat162 s) {
  const float2 yf = __bfloat1622float2(y), sf = __bfloat1622float2(s);
  return __floats2bfloat162_rn(yf.x * sf.x, yf.y * sf.y);
}
__device__ __forceinline__ __nv_bfloat162 bf2_add(__nv_bfloat162 y, __nv_bfloat162 o) {
  const float2 yf = __bfloat1622float2(y), of = __bfloat1622float2(o);
  return __floats2bfloat162_rn(yf.x + of.x, yf.y + of.y);
}
__device__ __forceinline__ __nv_bfloat162 bf2_relu(__nv_bfloat162 y) {
  const float2 yf = __bfloat1622float2(y);
  const bf16 zero = __float2bfloat16_rn(0.f);
  return __halves2bfloat162(yf.x > 0.f ? y.x : zero, yf.y > 0.f ? y.y : zero);
}

template <int BN>
__global__ void __launch_bounds__(CV_THREADS, 1)
conv_bf16_kernel(const __grid_constant__ CUtensorMap tm_w, const ConvArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  ConvSmem<BN>& sm =
      *reinterpret_cast<ConvSmem<BN>*>(smem_raw + (((raw + 1023u) & ~1023u) - raw));
  const int n_n = (a.cout + BN - 1) / BN;
  const int tiles = (a.m + CV_BM - 1) / CV_BM * n_n;
  const int n_k = (a.k + CV_BK - 1) / CV_BK;
  const int wg = threadIdx.x / 128;
  constexpr int STAGES = ConvTile<BN>::STAGES, LAG = ConvTile<BN>::LAG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 128 + 1);             // every producer thread + the TMA's expect_tx
      mbar_init(&sm.empty[s], CV_CONSUMERS * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CV_CONSUMERS) {
    // ---------------- producer: A by the gather, W by TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int pt = threadIdx.x % 128;
    const int q = pt % 8;      // this thread's 16-byte chunk of every 64-k row
    const int rsub = pt / 8;   // its rows: rsub + 16 p
    const int hw_out = a.ho * a.wo;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = tile / n_n * CV_BM, col0 = tile % n_n * BN;
      int ih0[8], iw0[8], pix0[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int m = row0 + rsub + 16 * p;
        if (m < a.m) {
          const int bi = m / hw_out, rem = m - bi * hw_out;
          const int oh = rem / a.wo, ow = rem - oh * a.wo;
          ih0[p] = oh * a.stride - a.pad_top;
          iw0[p] = ow * a.stride - a.pad_left;
          pix0[p] = bi * a.h * a.w;
        } else {  // past the last output row: every tap reads as padding
          ih0[p] = -(1 << 28);
          iw0[p] = 0;
          pix0[p] = 0;
        }
      }
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int stage = it % STAGES;
        mbar_wait(&sm.empty[stage], ((it / STAGES) & 1) ^ 1);
        if (pt == 0) {
          mbar_expect_tx(&sm.full[stage], BN * CV_BK * 2);
          tma_load(sm.w[stage], &tm_w, &sm.full[stage], kt * CV_BK, col0);
        }
        const int kg = kt * CV_BK + q * 8;
        const bool k_in = kg < a.k;
        const int tap = k_in ? kg / a.cin : 0;
        const int c = kg - tap * a.cin;
        const int ti = tap / a.kw, tj = tap - ti * a.kw;
        bf16* dst = sm.a[stage];
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int r = rsub + 16 * p;
          const int ih = ih0[p] + ti, iw = iw0[p] + tj;
          const bool ok = k_in && (unsigned)ih < (unsigned)a.h && (unsigned)iw < (unsigned)a.w;
          const bf16* src = ok ? a.x + ((size_t)(pix0[p] + ih * a.w + iw) * a.cin + c) : a.x;
          cp_async16(dst + r * CV_BK + ((q ^ (r & 7)) * 8), src, ok);
        }
        cp_async_commit();
        if (it >= LAG) {  // the gather of step it - LAG has landed: its stage is full
          cp_async_wait<LAG>();
          fence_async_shared();
          mbar_arrive(&sm.full[(it - LAG) % STAGES]);
        }
      }
    }
    cp_async_wait<0>();
    fence_async_shared();
    for (int s = it < LAG ? 0 : it - LAG; s < it; ++s) mbar_arrive(&sm.full[s % STAGES]);
  } else {
    // ---------------- consumers: wgmma on the stages, then bf16 rows out
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
    const int ct = threadIdx.x % 128;
    const int warp = ct / 32, lane = ct % 32;
    const int wr0 = wg * 64;  // this warpgroup's 64 rows of every tile
    const uint32_t a_base = smem_u32(sm.a[0]) + wr0 * CV_BK * 2;
    const uint32_t w_base = smem_u32(sm.w[0]);
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int col0 = tile % n_n * BN;
      const int row0 = tile / n_n * CV_BM, rows = min(CV_BM, a.m - row0);
      int prev = 0;
      fence_regs(acc);
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int stage = it % STAGES;
        mbar_wait(&sm.full[stage], (it / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CV_BK / 16; ++kk) {
          // 128-byte rows, 8-row groups 1024 B apart; a k16 step is 32 B along the row
          const uint64_t da = wgmma_desc(a_base + stage * CV_A_BYTES + kk * 32, 16, 1024);
          const uint64_t dw = wgmma_desc(w_base + stage * (BN * CV_BK * 2) + kk * 32, 16, 1024);
          wgmma_kmajor<BN>(acc, da, dw, (kt | kk) != 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products are done with their stage
        if (kt > 0 && lane == 0) mbar_arrive(&sm.empty[prev]);
        prev = stage;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&sm.empty[prev]);

      // accumulator layout: warp w of the group holds rows 16w.., lane (g, tq)
      // rows g and g+8, columns 8j + 2tq, +1 of every 8-column group j. The
      // group rounds its 64 x BN tile (and applies the batch norm) into shared
      // memory, then stores it as 16-byte row chunks (whole 32-byte sectors,
      // coalesced), adding the residual and the ReLU on the way.
      constexpr int CS = BN + 8;  // the staged tile's row stride, in elements
      bf16* ct_tile = sm.c[wg];
      warpgroup_sync(wg);  // the previous tile's stores have read the stage
      const int g = lane / 4, tq = lane % 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = col0 + 8 * j + 2 * tq;
        __nv_bfloat162 s2, o2;
        if (a.scale != nullptr && col < a.cout) {
          s2 = *reinterpret_cast<const __nv_bfloat162*>(a.scale + col);
          o2 = *reinterpret_cast<const __nv_bfloat162*>(a.offset + col);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162 y = __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          if (a.scale != nullptr && col < a.cout) y = bf2_add(bf2_mul(y, s2), o2);
          *reinterpret_cast<__nv_bfloat162*>(ct_tile + (warp * 16 + g + 8 * h) * CS + 8 * j +
                                             2 * tq) = y;
        }
      }
      warpgroup_sync(wg);
      const int r_base = row0 + wr0, r_end = rows - wr0;
#pragma unroll 4
      for (int q = ct; q < 64 * BN / 8; q += 128) {
        const int r = q / (BN / 8), cc = (q % (BN / 8)) * 8;
        if (r < r_end && col0 + cc < a.cout) {
          const size_t o = (size_t)(r_base + r) * a.cout + col0 + cc;
          uint4 v = *reinterpret_cast<const uint4*>(ct_tile + r * CS + cc);
          if (a.residual != nullptr || a.relu) {
            __nv_bfloat162* y = reinterpret_cast<__nv_bfloat162*>(&v);
            if (a.residual != nullptr) {
              uint4 rv = *reinterpret_cast<const uint4*>(a.residual + o);
              const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv);
#pragma unroll
              for (int e = 0; e < 4; ++e) y[e] = bf2_add(y[e], r2[e]);
            }
            if (a.relu) {
#pragma unroll
              for (int e = 0; e < 4; ++e) y[e] = bf2_relu(y[e]);
            }
          }
          *reinterpret_cast<uint4*>(a.out + o) = v;
        }
      }
    }
  }
}

template <int BN>
cudaError_t launch_conv_bf16(const CUtensorMap& tw, const ConvArgs& a, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = sizeof(ConvSmem<BN>) + 1024;  // + the 1024-byte alignment
  cudaError_t err = cudaFuncSetAttribute(conv_bf16_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.m + CV_BM - 1) / CV_BM * ((a.cout + BN - 1) / BN);
  conv_bf16_kernel<BN><<<tiles < sms ? tiles : sms, CV_THREADS, smem, stream>>>(tw, a);
  return cudaGetLastError();
}

}  // namespace leclip

extern "C" {

// x [b, h, w, cin] and out [b, ho, wo, cout] NHWC, w [cout, kh, kw, cin];
// all bf16, contiguous, on the card. cin % 8 == 0, cout % 8 == 0; the
// output grid and the top / left pads as "SAME" gives them. scale / offset
// ([cout]) fuse the batch norm, residual ([b, ho, wo, cout]) the add after
// it, relu the ReLU (null / 0: off; residual and relu need the batch norm).
// One launch on `stream`; returns a cudaError_t.
int leclip_conv_bf16(const void* x, const void* w, void* out, const void* scale,
                     const void* offset, const void* residual, int relu, int b, int h, int wd,
                     int cin, int ho, int wo, int cout, int kh, int kw, int stride, int pad_top,
                     int pad_left, void* stream) {
  using namespace leclip;
  if (cin % 8 || cout % 8 || cin <= 0 || cout <= 0 || kh <= 0 || kw <= 0 || stride <= 0)
    return (int)cudaErrorInvalidValue;
  if ((scale == nullptr) != (offset == nullptr) ||
      (scale == nullptr && (residual != nullptr || relu)))
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)b * ho * wo;
  if (m == 0) return (int)cudaSuccess;
  if (m > 0x7fffffffLL || (long long)b * h * wd > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ConvArgs a{static_cast<const bf16*>(x), static_cast<bf16*>(out),
             static_cast<const bf16*>(scale), static_cast<const bf16*>(offset),
             static_cast<const bf16*>(residual), relu ? 1 : 0, h, wd, cin, ho, wo, cout,
             kw, stride, pad_top, pad_left, kh * kw * cin, (int)m};
  const int bn = cout >= 256 ? 256 : cout > 64 ? 128 : 64;  // from Cout alone
  CUtensorMap tw;
  if (!bf16_tensor_map(&tw, w, (uint64_t)a.k, (uint64_t)cout, 64, bn))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 256) return (int)launch_conv_bf16<256>(tw, a, s);
  return (int)(bn == 128 ? launch_conv_bf16<128>(tw, a, s) : launch_conv_bf16<64>(tw, a, s));
}

}  // extern "C"
