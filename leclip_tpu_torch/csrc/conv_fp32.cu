// NHWC fp32 convolution for sm_90a (Hopper) on the CUDA cores, whose every
// output element is one FMA chain in an order fixed by K alone, so that an
// image's output does not depend on the batch it is computed in, with the
// trunk's chain after it in the epilogue:
//
//   acc = 0.0f;  for k in (kh, kw, cin) order:  acc = fmaf(A[m, k], W[n, k], acc)
//   y = acc * scale[n] + offset[n]  (+ residual[m, n])  (ReLU)      -> out[m, n]
//
// an implicit GEMM with M = B*Ho*Wo output positions, N = Cout and
// K = kh*kw*Cin walked as (kh, kw, cin), the order of the port's stored
// weight [out, kh, kw, in] (models/resnet.conv_layout). A[m, k] is the input
// pixel under tap (kh, kw) of output position m, zero in the "SAME" padding
// (pads given by the caller, as lax.conv_general_dilated computes them, the
// stem's (0, 1) included). No TF32: full fp32 products, fp32 output.
//
// Replaces no Pallas kernel: the JAX package leaves its convolutions to XLA
// (leclip_tpu/models/resnet.py conv2d, batch norm at :40-44, residual and
// ReLU at :58-67), which gives an image the same values at every batch size.
// cuDNN's fp32 kernels are chosen by shape (implicit GEMM, Winograd or FFT,
// with or without a split of K), so an image's fp32 output moves with the
// batch's size: this kernel is the port's repair of that fault
// (ops/conv_kernels.py conv_fp32).
//
// Independence by construction: every output element is summed by one
// thread, in one register, over K in order; there is no split-K, no atomic
// and no reduction across threads. Under this rule an element's value depends
// on K alone, so the tile may follow M, Cout and K (conv_fp32_tile): any two
// tiles give the same bits. Zero-filled taps and the K tail add
// fmaf(0, w, acc), which leaves acc's value as it was.
//
// Epilogue, in fp32 and rounded where PyTorch's fp32 elementwise ops round
// (ops/conv_kernels.bn_chain: a multiply, an add, + residual, the ReLU), so
// that the fused call equals the unfused chain over the bare output bit for
// bit: y = __fadd_rn(__fmul_rn(acc, scale), offset), then __fadd_rn(y,
// residual), then y > 0 ? y : 0. The explicit _rn intrinsics keep nvcc from
// contracting a*b+c into an FMA. Each step is optional (off: the value
// passes unchanged; an offset alone is the head's bias add, acc + bias).
//
// Bound on the H100: at RN50's 224² crops the trunk's 55 convolutions do
// 10.7 GFLOP a crop, 6.55 TFLOP at 610 crops: 97.7 ms at the 67 TFLOP/s of
// the fp32 CUDA cores, far above the bytes' time (fp32 activations once,
// ~27 ms); the fused chain adds only bytes (the residual read once).
//
// Design: a register-tiled SIMT GEMM, each thread an 8 x TN micro-tile of
// accumulators (ConvF32Config): 128 x 128 block tiles of 8 x 16 (128
// threads, K steps of 32 through a ring of 3 shared-memory stages) where
// Cout > 64 and M gives 2 waves of the SMs, 256 x 64 of 8 x 16 for Cout 64,
// 128 x 32 of 8 x 8 for Cout <= 32, and 64 x 64 of 8 x 8 (K steps of 16, 4
// stages) where M is small (conv_fp32_tile). The 8 x 16 micro-tile needs
// 24 16-byte shared loads for 512 FMAs where 8 x 8 needs 32: shared memory,
// not the FMA pipe, is what an 8 x 8 tile runs into on this card. cp.async
// fills each stage (the im2col gather of A as 16-byte chunks of 4 channels,
// zero-filled where a tap falls in the padding or past K; W as 16-byte
// chunks), with no register staging. Both operands are K-contiguous in
// shared memory ([m][k], [n][k]) in rows of BK + 4 floats, so the 8 rows a
// quarter-warp reads fall in 8 different bank groups; the inner loop reads
// 4 consecutive k of a row as one float4 and applies them to every
// accumulator in k order; an 8 x 16 tile's stage loops over pairs of these
// 4-k groups (fully unrolled, its 4,096 FMAs are 64 KB of code and ran 8%
// slower). Each thread's gather chunk walks its (tap, channel) pair forward
// by BK a step, with no division in the loop; a table of the tile's output
// rows (input pixel of tap (0, 0) and its coordinates) is built once a
// block. The ring is rotated so that the last K step lands
// in the last stage: the other stages then hold the output tile, into which
// the residual is copied by cp.async before the last step's FMAs, and
// through which the epilogue stores 16-byte rows.
// Cin % 4 == 0 (the wrapper zero-fills the stem's 3), Cout % 4 == 0,
// 16-byte-aligned pointers; any batch.
#include "gemm.cuh"

namespace leclip {

// a tile shape is taken where it gives 2 waves of the H100's 132 SMs
constexpr int CF_MIN_TILES = 2 * 132;

struct ConvF32Args {
  const float* x;         // [b, h, w, cin]
  const float* w;         // [cout, kh, kw, cin] = [cout, k]
  float* out;             // [b, ho, wo, cout]
  const float* scale;     // [cout] or null
  const float* offset;    // [cout] or null
  const float* residual;  // [b, ho, wo, cout] or null
  int relu;
  int h, w_in, cin, ho, wo, cout, kw, stride, pad_top, pad_left, k, m;
};

// a block tile's configuration: a thread's micro-tile is 8 x TN, a pipeline
// stage holds BK k, the ring STAGES stages, and MIN_BLOCKS blocks share an SM
// (the register cap: 65,536 / (MIN_BLOCKS x threads))
template <int BM, int BN>
struct ConvF32Config;
template <>
struct ConvF32Config<128, 128> {
  static constexpr int TN = 16, BK = 32, STAGES = 3, MIN_BLOCKS = 2;
};
template <>
struct ConvF32Config<256, 64> {
  static constexpr int TN = 16, BK = 16, STAGES = 4, MIN_BLOCKS = 2;
};
template <>
struct ConvF32Config<128, 64> {
  static constexpr int TN = 8, BK = 16, STAGES = 4, MIN_BLOCKS = 3;
};
template <>
struct ConvF32Config<128, 32> {
  static constexpr int TN = 8, BK = 16, STAGES = 4, MIN_BLOCKS = 4;
};
template <>
struct ConvF32Config<64, 64> {
  static constexpr int TN = 8, BK = 16, STAGES = 4, MIN_BLOCKS = 5;
};

template <int BM, int BN>
struct ConvF32Tile : ConvF32Config<BM, BN> {
  using C = ConvF32Config<BM, BN>;
  static constexpr int TN = C::TN, BK = C::BK, STAGES = C::STAGES;
  static constexpr int THREADS = BM * BN / (8 * TN);
  static constexpr int TX = BN / TN;  // threads along N
  static constexpr int TY = BM / 8;   // threads along M
  static constexpr int LD = BK + 4;   // a staged row of A or W, in floats: 8 rows, 8 bank groups
  static constexpr int KQ = BK / 4;   // 16-byte chunks of a row
  static constexpr int STAGE = (BM + BN) * LD;  // floats: A [BM][LD], then W [BN][LD]
  static constexpr int CS = BN + TX;  // the output tile's row stride: a warp's rows in other banks
  static constexpr int ROWS = THREADS / KQ;   // rows a pass of the block's copies covers
  static constexpr int A_CHUNKS = BM / ROWS;  // 16-byte chunks a thread copies a stage
  static constexpr int B_CHUNKS = BN / ROWS;
  static constexpr int SMEM = STAGES * STAGE * 4 + BM * 16;  // the ring, then the row table
  static_assert(TX * TY == THREADS && A_CHUNKS * ROWS == BM && B_CHUNKS * ROWS == BN,
                "8 x TN micro-tiles, whole chunks a thread");
  static_assert(BM * CS <= (STAGES - 1) * STAGE, "the output tile fits beside the last stage");
  static_assert(C::MIN_BLOCKS * (SMEM + 1024) <= 233472,
                "MIN_BLOCKS blocks fit an SM's shared memory");
};

template <int BM, int BN>
__global__ void __launch_bounds__(ConvF32Tile<BM, BN>::THREADS,
                                  ConvF32Config<BM, BN>::MIN_BLOCKS)
conv_fp32_kernel(const ConvF32Args a) {
  using T = ConvF32Tile<BM, BN>;
  extern __shared__ float4 smem_f4[];
  float* ring = reinterpret_cast<float*>(smem_f4);
  int4* rows = reinterpret_cast<int4*>(ring + T::STAGES * T::STAGE);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_k = (a.k + T::BK - 1) / T::BK;

  // the row table: for each output row of the tile, the input pixel under tap
  // (0, 0) (x: its index, maybe outside the image; y, z: its row and column)
  const int hw_out = a.ho * a.wo;
  for (int r = tid; r < BM; r += T::THREADS) {
    const int m = m0 + r;
    int4 e = make_int4(0, -(1 << 28), 0, 0);  // past the last row: every tap is padding
    if (m < a.m) {
      const int bi = m / hw_out, rem = m - bi * hw_out;
      const int oh = rem / a.wo, ow = rem - oh * a.wo;
      e.y = oh * a.stride - a.pad_top;
      e.z = ow * a.stride - a.pad_left;
      e.x = (bi * a.h + e.y) * a.w_in + e.z;
    }
    rows[r] = e;
  }
  __syncthreads();

  // copies: thread tid moves the 4-k chunk kq of rows tid / KQ + ROWS r; its chunk's
  // k index kg = tap * cin + c, tap = ti * kw + tj, walks forward by BK a step
  const int kq = tid % T::KQ, lrow = tid / T::KQ;
  int kg = 4 * kq;
  const float* wsrc = a.w + ((size_t)(n0 + lrow) * a.k + kg);  // W chunk 0's source, by BK a step
  int ti, tj, c;
  {
    const int tap = kg / a.cin;
    c = kg - tap * a.cin;
    ti = tap / a.kw;
    tj = tap - ti * a.kw;
  }
  auto load_tile = [&](int stage) {
    float* as = ring + stage * T::STAGE + lrow * T::LD + 4 * kq;
    float* bs = as + BM * T::LD;
    const bool k_in = kg < a.k;
    const int tap_pix = ti * a.w_in + tj;
#pragma unroll
    for (int r = 0; r < T::A_CHUNKS; ++r) {
      const int4 e = rows[lrow + r * T::ROWS];
      const int ih = e.y + ti, iw = e.z + tj;
      const bool ok = k_in && (unsigned)ih < (unsigned)a.h && (unsigned)iw < (unsigned)a.w_in;
      const float* src = ok ? a.x + ((size_t)(e.x + tap_pix) * a.cin + c) : a.x;
      cp_async16(as + r * T::ROWS * T::LD, src, ok);
    }
#pragma unroll
    for (int r = 0; r < T::B_CHUNKS; ++r) {
      const bool ok = k_in && n0 + lrow + r * T::ROWS < a.cout;
      cp_async16(bs + r * T::ROWS * T::LD, ok ? wsrc + (size_t)r * T::ROWS * a.k : a.w, ok);
    }
    wsrc += T::BK;
    kg += T::BK;
    c += T::BK;
    while (c >= a.cin) {
      c -= a.cin;
      if (++tj == a.kw) {
        tj = 0;
        ++ti;
      }
    }
  };

  // the output tile [BM][CS] over the first stages, clear of the last K step's stage
  float* ct = ring;
  auto load_residual = [&]() {
    for (int q = tid; q < BM * BN / 4; q += T::THREADS) {
      const int r = q / (BN / 4), c4 = q % (BN / 4), m = m0 + r, n = n0 + 4 * c4;
      const bool ok = m < a.m && n < a.cout;
      cp_async16(ct + r * T::CS + 4 * c4, ok ? a.residual + ((size_t)m * a.cout + n) : a.residual,
                 ok);
    }
  };

  // compute: thread (ty, tx) owns rows ty + TY i and columns tx + TX j (i < 8, j < TN)
  const int ty = tid / T::TX, tx = tid % T::TX;
  float acc[8][T::TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;
  auto compute = [&](int stage) {
    const float* as = ring + stage * T::STAGE + ty * T::LD;
    const float* bs = ring + stage * T::STAGE + (BM + tx) * T::LD;
#pragma unroll(T::TN == 16 ? 2 : T::KQ)  // an 8 x 16 stage unrolled whole is 64 KB of code
    for (int g = 0; g < T::KQ; ++g) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + i * T::TY * T::LD + 4 * g);
#pragma unroll
      for (int j = 0; j < T::TN; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(bs + j * T::TX * T::LD + 4 * g);
#pragma unroll
        for (int i = 0; i < 8; ++i) {  // k in order: one FMA chain per output element
          acc[i][j] = fmaf(av[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, b.w, acc[i][j]);
        }
      }
    }
  };

  // the ring: tile t in stage (t + shift) % STAGES, the last tile in stage STAGES - 1
  const int shift = (T::STAGES - n_k % T::STAGES) % T::STAGES;
  int ld_stage = shift, rd_stage = shift;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < n_k) load_tile(ld_stage);
    cp_async_commit();
    ld_stage = ld_stage + 1 == T::STAGES ? 0 : ld_stage + 1;
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<T::STAGES - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();                 // everyone's have; tile kt - 1's stage is free
    if (kt + T::STAGES - 1 < n_k) load_tile(ld_stage);
    if (kt == n_k - 1 && a.residual != nullptr) load_residual();  // in flight under the last FMAs
    cp_async_commit();
    ld_stage = ld_stage + 1 == T::STAGES ? 0 : ld_stage + 1;
    compute(rd_stage);
    rd_stage = rd_stage + 1 == T::STAGES ? 0 : rd_stage + 1;
  }

  // epilogue: the chain in registers, each step rounded as PyTorch's fp32 op,
  // into the output tile (over the residual where there is one), then 16-byte
  // rows out
  if (a.residual != nullptr) {
    cp_async_wait<0>();
    __syncthreads();
  }
  float sc[T::TN], of[T::TN];
#pragma unroll
  for (int j = 0; j < T::TN; ++j) {
    const int n = n0 + tx + T::TX * j;
    sc[j] = a.scale != nullptr && n < a.cout ? a.scale[n] : 1.f;
    of[j] = a.offset != nullptr && n < a.cout ? a.offset[n] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* crow = ct + (ty + T::TY * i) * T::CS + tx;
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      float y = acc[i][j];
      if (a.scale != nullptr) y = __fmul_rn(y, sc[j]);
      if (a.offset != nullptr) y = __fadd_rn(y, of[j]);
      if (a.residual != nullptr) y = __fadd_rn(y, crow[T::TX * j]);
      if (a.relu) y = y > 0.f ? y : 0.f;
      crow[T::TX * j] = y;
    }
  }
  __syncthreads();
  for (int q = tid; q < BM * BN / 4; q += T::THREADS) {
    const int r = q / (BN / 4), c4 = q % (BN / 4), m = m0 + r, n = n0 + 4 * c4;
    if (m < a.m && n < a.cout)
      *reinterpret_cast<float4*>(a.out + ((size_t)m * a.cout + n)) =
          *reinterpret_cast<const float4*>(ct + r * T::CS + 4 * c4);
  }
}

template <int BM, int BN>
cudaError_t launch_conv_fp32(const ConvF32Args& a, cudaStream_t stream) {
  using T = ConvF32Tile<BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(conv_fp32_kernel<BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.m + BM - 1) / BM, (a.cout + BN - 1) / BN);
  conv_fp32_kernel<BM, BN><<<grid, T::THREADS, T::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// the block tile for M output rows and Cout columns, as BM << 16 | BN: the
// widest of Cout's tiles that still gives CF_MIN_TILES blocks, else 64 x 64
// (128 x 32 for Cout <= 32, whatever M)
inline int conv_fp32_tile(long long m, int cout) {
  auto tiles = [&](int bm, int bn) { return (m + bm - 1) / bm * ((cout + bn - 1) / bn); };
  if (cout <= 32) return 128 << 16 | 32;
  if (cout > 64 && tiles(128, 128) >= CF_MIN_TILES) return 128 << 16 | 128;
  if (cout <= 64 && tiles(256, 64) >= CF_MIN_TILES) return 256 << 16 | 64;
  if (tiles(128, 64) >= CF_MIN_TILES) return 128 << 16 | 64;
  return 64 << 16 | 64;
}

}  // namespace leclip

extern "C" {

// The tile (BM << 16 | BN) that leclip_conv_fp32 takes for m = b*ho*wo rows
// and cout columns.
int leclip_conv_fp32_tile(long long m, int cout) { return leclip::conv_fp32_tile(m, cout); }

// x [b, h, w, cin] and out [b, ho, wo, cout] NHWC, w [cout, kh, kw, cin];
// all fp32, contiguous, on the card. cin % 4 == 0, cout % 4 == 0; the
// output grid and the top / left pads as "SAME" gives them. scale, offset
// [cout] and residual (out's shape), each null or fp32: the epilogue's
// multiply, add and residual add; relu the ReLU. residual and relu need
// scale, and scale needs offset; an offset alone is a bias add. One launch
// on `stream`; returns a cudaError_t.
int leclip_conv_fp32(const void* x, const void* w, void* out, const void* scale,
                     const void* offset, const void* residual, int relu, int b, int h, int wd,
                     int cin, int ho, int wo, int cout, int kh, int kw, int stride, int pad_top,
                     int pad_left, void* stream) {
  using namespace leclip;
  if (cin % 4 || cout % 4 || cin <= 0 || cout <= 0 || kh <= 0 || kw <= 0 || stride <= 0 ||
      (scale == nullptr && (residual != nullptr || relu)) ||
      (scale != nullptr && offset == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)b * ho * wo;
  if (m == 0) return (int)cudaSuccess;
  if (m > 0x7fffffffLL || (long long)b * h * wd > 0x7fffffffLL ||
      (long long)kh * kw * cin > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  ConvF32Args a{static_cast<const float*>(x),      static_cast<const float*>(w),
                static_cast<float*>(out),          static_cast<const float*>(scale),
                static_cast<const float*>(offset), static_cast<const float*>(residual),
                relu,
                h, wd, cin, ho, wo, cout, kw, stride, pad_top, pad_left, kh * kw * cin, (int)m};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (conv_fp32_tile(m, cout)) {
    case 128 << 16 | 128: return (int)launch_conv_fp32<128, 128>(a, s);
    case 256 << 16 | 64: return (int)launch_conv_fp32<256, 64>(a, s);
    case 128 << 16 | 64: return (int)launch_conv_fp32<128, 64>(a, s);
    case 128 << 16 | 32: return (int)launch_conv_fp32<128, 32>(a, s);
    default: return (int)launch_conv_fp32<64, 64>(a, s);
  }
}

}  // extern "C"
