// NHWC fp32 convolution for sm_90a (Hopper) on the CUDA cores, whose every
// output element is one FMA chain in an order fixed by K alone, so that an
// image's output does not depend on the batch it is computed in:
//
//   acc = 0.0f;  for k in (kh, kw, cin) order:  acc = fmaf(A[m, k], W[n, k], acc)
//   out[b, oh, ow, n] = acc
//
// an implicit GEMM with M = B*Ho*Wo output positions, N = Cout and
// K = kh*kw*Cin walked as (kh, kw, cin), the order of the port's stored
// weight [out, kh, kw, in] (models/resnet.conv_layout). A[m, k] is the input
// pixel under tap (kh, kw) of output position m, zero in the "SAME" padding
// (pads given by the caller, as lax.conv_general_dilated computes them, the
// stem's (0, 1) included). No TF32: full fp32 products, fp32 output.
//
// Replaces no Pallas kernel: the JAX package leaves its convolutions to XLA
// (leclip_tpu/models/resnet.py conv2d), which gives an image the same values
// at every batch size. cuDNN's fp32 kernels are chosen by shape (implicit
// GEMM, Winograd or FFT, with or without a split of K), so an image's fp32
// output moves with the batch's size: this kernel is the port's repair of
// that fault (ops/conv_kernels.py conv_fp32).
//
// Independence by construction: every output element is summed by one
// thread, in one register, over K in order; there is no split-K, no atomic
// and no reduction across threads. Under this rule an element's value depends
// on K alone, so the tile shape may be chosen by any dimension (here by Cout;
// it could be by M). Zero-filled taps and the K tail add fmaf(0, w, acc),
// which leaves acc as it was.
//
// Bound on the H100: at RN50's 224² crops the trunk's 55 convolutions do
// 10.7 GFLOP a crop, 6.55 TFLOP at 610 crops: 97.7 ms at the 67 TFLOP/s of
// the fp32 CUDA cores, far above the bytes' time (fp32 activations once,
// ~27 ms). Design: a register-tiled SIMT GEMM, as the repo's fp32 attention
// loops (attn_simt.cuh): 256 threads, each an 8 x 8 micro-tile of a BM x BN
// block tile (128 x 128 where Cout >= 128, 256 x 64 where Cout >= 64, else
// 512 x 32), K steps of 16 through two shared-memory buffers. Each thread
// loads its share of the next K step (the im2col gather of A as 16-byte
// chunks of 4 channels, and W) into registers while the block computes on
// the current buffer, then stores it transposed ([k][m], [k][n]) into the
// other buffer, so the inner loop reads 16-byte rows of both.
// Cin % 4 == 0 (the wrapper zero-fills the stem's 3), Cout % 4 == 0,
// 16-byte-aligned pointers; any batch.
#include "gemm.cuh"

namespace leclip {

constexpr int CF_BK = 16;
constexpr int CF_THREADS = 256;

struct ConvF32Args {
  const float* x;  // [b, h, w, cin]
  const float* w;  // [cout, kh, kw, cin] = [cout, k]
  float* out;      // [b, ho, wo, cout]
  int h, w_in, cin, ho, wo, cout, kw, stride, pad_top, pad_left, k, m;
};

template <int BM, int BN>
struct ConvF32Tile {
  static constexpr int TX = BN / 8;  // threads along N
  static constexpr int TY = BM / 8;  // threads along M: TX * TY == 256
  static constexpr int AS = BM + 4;  // a row of the [k][m] buffer, in floats (16-byte rows)
  static constexpr int BS = BN + 4;
  static constexpr int A_ROWS = BM / 64;                                  // A chunks a thread loads
  static constexpr int B_ROWS = (BN * CF_BK / 4 + CF_THREADS - 1) / CF_THREADS;  // W chunks
  static constexpr int SMEM = 2 * CF_BK * (AS + BS) * 4;
  static_assert(TX * TY == CF_THREADS, "256 threads of 8 x 8");
};

template <int BM, int BN>
__global__ void __launch_bounds__(CF_THREADS, BM == 128 ? 2 : 1)
conv_fp32_kernel(const ConvF32Args a) {
  using T = ConvF32Tile<BM, BN>;
  extern __shared__ float4 smem_f4[];
  float* as = reinterpret_cast<float*>(smem_f4);  // [2][16][AS]
  float* bs = as + 2 * CF_BK * T::AS;             // [2][16][BS]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int n_k = (a.k + CF_BK - 1) / CF_BK;

  // loads: thread tid moves the 4-k chunk kq of rows tid / 4 + 64 r
  const int kq = tid % 4, lrow = tid / 4;
  const int hw_out = a.ho * a.wo;
  int ih0[T::A_ROWS], iw0[T::A_ROWS], pix0[T::A_ROWS];
#pragma unroll
  for (int r = 0; r < T::A_ROWS; ++r) {
    const int m = m0 + lrow + 64 * r;
    if (m < a.m) {
      const int bi = m / hw_out, rem = m - bi * hw_out;
      const int oh = rem / a.wo, ow = rem - oh * a.wo;
      ih0[r] = oh * a.stride - a.pad_top;
      iw0[r] = ow * a.stride - a.pad_left;
      pix0[r] = bi * a.h * a.w_in;
    } else {  // past the last output row: every tap reads as padding
      ih0[r] = -(1 << 28);
      iw0[r] = 0;
      pix0[r] = 0;
    }
  }
  float4 ra[T::A_ROWS], rb[T::B_ROWS];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  auto load = [&](int kt) {
    const int kg = kt * CF_BK + kq * 4;
    const bool k_in = kg < a.k;
    const int tap = k_in ? kg / a.cin : 0;
    const int c = kg - tap * a.cin;
    const int ti = tap / a.kw, tj = tap - ti * a.kw;
#pragma unroll
    for (int r = 0; r < T::A_ROWS; ++r) {
      const int ih = ih0[r] + ti, iw = iw0[r] + tj;
      const bool ok = k_in && (unsigned)ih < (unsigned)a.h && (unsigned)iw < (unsigned)a.w_in;
      ra[r] = ok ? __ldg(reinterpret_cast<const float4*>(
                       a.x + ((size_t)(pix0[r] + ih * a.w_in + iw) * a.cin + c)))
                 : zero;
    }
#pragma unroll
    for (int r = 0; r < T::B_ROWS; ++r) {
      const int row = lrow + 64 * r, n = n0 + row;
      const bool ok = k_in && row < BN && n < a.cout;
      rb[r] = ok ? __ldg(reinterpret_cast<const float4*>(a.w + (size_t)n * a.k + kg)) : zero;
    }
  };
  auto store = [&](int buf) {
    float* ad = as + buf * CF_BK * T::AS + kq * 4 * T::AS;
#pragma unroll
    for (int r = 0; r < T::A_ROWS; ++r) {
      const int row = lrow + 64 * r;
      ad[row] = ra[r].x;
      ad[T::AS + row] = ra[r].y;
      ad[2 * T::AS + row] = ra[r].z;
      ad[3 * T::AS + row] = ra[r].w;
    }
    float* bd = bs + buf * CF_BK * T::BS + kq * 4 * T::BS;
#pragma unroll
    for (int r = 0; r < T::B_ROWS; ++r) {
      const int row = lrow + 64 * r;
      if (row < BN) {
        bd[row] = rb[r].x;
        bd[T::BS + row] = rb[r].y;
        bd[2 * T::BS + row] = rb[r].z;
        bd[3 * T::BS + row] = rb[r].w;
      }
    }
  };

  // compute: thread (ty, tx) owns rows ty*4 + i and BM/2 + ty*4 + i, columns
  // tx*4 + j and BN/2 + tx*4 + j (i, j < 4)
  const int ty = tid / T::TX, tx = tid % T::TX;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_k) load(kt + 1);
    const float* ab = as + buf * CF_BK * T::AS;
    const float* bb = bs + buf * CF_BK * T::BS;
#pragma unroll
    for (int k = 0; k < CF_BK; ++k) {  // k in order: one FMA chain per output element
      const float4 a0 = *reinterpret_cast<const float4*>(ab + k * T::AS + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(ab + k * T::AS + BM / 2 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bb + k * T::BS + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bb + k * T::BS + BN / 2 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < n_k) store(buf ^ 1);  // buf ^ 1 was last read before the previous barrier
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (m >= a.m) continue;
    float* orow = a.out + (size_t)m * a.cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * (BN / 2) + tx * 4;
      if (n < a.cout)
        *reinterpret_cast<float4*>(orow + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

template <int BM, int BN>
cudaError_t launch_conv_fp32(const ConvF32Args& a, cudaStream_t stream) {
  constexpr int smem = ConvF32Tile<BM, BN>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(conv_fp32_kernel<BM, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.m + BM - 1) / BM, (a.cout + BN - 1) / BN);
  conv_fp32_kernel<BM, BN><<<grid, CF_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace leclip

extern "C" {

// x [b, h, w, cin] and out [b, ho, wo, cout] NHWC, w [cout, kh, kw, cin];
// all fp32, contiguous, on the card. cin % 4 == 0, cout % 4 == 0; the
// output grid and the top / left pads as "SAME" gives them. One launch on
// `stream`; returns a cudaError_t.
int leclip_conv_fp32(const void* x, const void* w, void* out, int b, int h, int wd, int cin,
                     int ho, int wo, int cout, int kh, int kw, int stride, int pad_top,
                     int pad_left, void* stream) {
  using namespace leclip;
  if (cin % 4 || cout % 4 || cin <= 0 || cout <= 0 || kh <= 0 || kw <= 0 || stride <= 0)
    return (int)cudaErrorInvalidValue;
  const long long m = (long long)b * ho * wo;
  if (m == 0) return (int)cudaSuccess;
  if (m > 0x7fffffffLL || (long long)b * h * wd > 0x7fffffffLL ||
      (long long)kh * kw * cin > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  ConvF32Args a{static_cast<const float*>(x), static_cast<const float*>(w),
                static_cast<float*>(out), h, wd, cin, ho, wo, cout, kw, stride, pad_top,
                pad_left, kh * kw * cin, (int)m};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout >= 128) return (int)launch_conv_fp32<128, 128>(a, s);  // the tile from Cout alone
  if (cout >= 64) return (int)launch_conv_fp32<256, 64>(a, s);
  return (int)launch_conv_fp32<512, 32>(a, s);
}

}  // extern "C"
