// Crop + bicubic resize of every crop of a batch of bucket-padded uint8
// images, over each output's band of taps, for sm_90a (Hopper), with the
// scale to [0, 1] before it and CLIP's normalisation after it:
//
//   v[y, x, c]    = dt(u8[b, y, x, c] * (1/255))
//   t[o, x, c]    = dt(sum over y in band_y(o) of  Ry[o, y] * v[y, x, c])     rows pass
//   out[o, p, c]  = dt(sum over x in band_x(p) of  Rx[p, x] * t[o, x, c])     columns pass
//   out[o, p, c]  = dt(dt(out[o, p, c] - mean[c]) / std[c])                  (normalize)
//
// for crop n of image b, with dt the rounding to the output dtype (bf16 or
// fp32) and every sum in fp32. Ry and Rx are the rows of
// ops/resize_matmul.axis_resize_matrix (Keys cubic a = -0.5, the support
// widened by the shrink factor under antialias, one reflection at the
// content's edge, zero past it, each row normalised in fp32 and rounded to
// the dtype), computed here in the same fp32 operations as PyTorch's ops
// compute them on the card (a division by a Python number is a product by
// its fp32 reciprocal there), each op rounded on its own (__fmul_rn and
// friends: no FMA contraction). The rounding points are those of the plain
// version (ops/resize_kernels.resize_band_plain): the products of the scale
// and of clip_normalize are PyTorch's on the card, so the fused call gives
// the unfused chain's values.
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA
// (leclip_tpu/ops/resize_matmul.py), which the port first ran as two dense
// fp32 products over the whole bucket a crop (cuBLAS): a bicubic row has
// 4 * max(1, side / out) non-zero taps of the bucket's 512-1280, so the dense
// products multiplied exact zeros ~400 times over. This kernel computes a
// row's candidate taps only (the hull of the cubic's support and of its two
// reflections, which holds every non-zero weight of the dense row, see
// resize_kernels.tap_band), trims the zeros at both ends, and sums the rest
// in index order. An output's value then depends on its crop's geometry
// alone: not on the batch, the crop's place in it, or whether the boxes are
// shared (box_stride 0) or the image's own.
//
// Bound on the H100: the crops it writes. At the scoring cells' 8 images x
// 305 crops x 224 x 224 x 3 the output is 734 MB in bf16, 0.22 ms at 3.35
// TB/s; the bucket's uint8 images (<= 14 MB a batch) are read from L2. The
// taps' products (~0.35 G fp32 multiply-adds an image) are ~0.1 ms of the
// CUDA cores' fp32 rate.
//
// Design: a block a (image, crop, 56 output rows); 256 threads. The block
// first computes the crop's x weights (every output column) and its rows' y
// weights into shared memory, one output position a thread. Then, 8 output
// rows at a time: the rows pass over the crop's column window (4 bytes of
// the image row a thread, one 32-bit load a tap, fp32 sums rounded to the
// dtype) into shared memory, never to device memory; then the columns pass,
// 8 output pixels (24 values) a thread, rounded, normalised and written as
// 16-byte stores. The columns' weights and bands are laid out so that a
// warp's lanes, 8 positions apart, read different banks, and the block
// holds 64 registers (4 blocks an SM; shared memory allows 3 at a 768-wide
// bucket): on the H100 these took 2.55 to 2.25 ms at the scoring cells'
// batch, where batching a thread's loads over 4 taps (109 registers) took
// 2.92. A crop whose geometry is invalid (content outside the bucket) or
// whose band outgrows `taps` is written as NaN, loudly.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace leclip {

constexpr int RB_THREADS = 256;
constexpr int RB_ROWS = 56;   // output rows a block
constexpr int RB_BAND = 8;    // output rows a rows pass keeps in shared memory
constexpr int RB_GROUP = 8;   // output pixels a thread of the columns pass

// shared memory, in 4-byte words: each column's weights (position p's at
// p * ts + p / 8: a columns-pass thread takes 8 neighbouring positions, so
// its lanes read 8 ts + 1 words apart, in different banks) and each row's;
// each column's first pixel and taps (at p + p / 8, likewise), each row's;
// the window and the fault; then the rows pass's RB_BAND rows of the dtype
__host__ __device__ inline int rb_cols(int o) { return o + o / 8 + 1; }
__host__ __device__ inline int rb_words(int o, int ts) {
  return o * ts + rb_cols(o) + RB_ROWS * ts + 2 * rb_cols(o) + 2 * RB_ROWS + 3;
}

struct ResizeArgs {
  const uint8_t* img;    // [b, h, w, 3]
  const float* boxes;    // (y0, x0, y1, x1) [n, 4] shared, or [b, n, 4]
  const int* content;    // [b, 2]: each image's (h, w) inside the bucket
  void* out;             // [b, n, o, o, 3]
  long long box_stride;  // floats from one image's boxes to the next: 0 or n * 4
  int h, w, n, o, taps, ts, tmp_stride;
  int antialias, normalize;
  float mean[3], std[3];
};

template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// resize_matmul.cubic_kernel, a = -0.5, each op as its PyTorch op rounds
__device__ __forceinline__ float cubic(float x) {
  const float ax = fabsf(x);
  const float ax2 = __fmul_rn(ax, ax);
  const float ax3 = __fmul_rn(ax2, ax);
  const float inner = __fadd_rn(__fsub_rn(__fmul_rn(1.5f, ax3), __fmul_rn(2.5f, ax2)), 1.0f);
  const float outer = __fsub_rn(
      __fadd_rn(__fsub_rn(__fmul_rn(-0.5f, ax3), __fmul_rn(-2.5f, ax2)), __fmul_rn(-4.0f, ax)),
      -2.0f);
  return ax <= 1.0f ? inner : (ax < 2.0f ? outer : 0.0f);
}

__device__ __forceinline__ int floor_i(float v) {
  return (int)floorf(fminf(fmaxf(v, -1e6f), 1e6f));
}
__device__ __forceinline__ int ceil_i(float v) {
  return (int)ceilf(fminf(fmaxf(v, -1e6f), 1e6f));
}

// The weights of output position `o` along one axis of a crop from `lo`
// spanning `span` pixels (shrink factor `ss`) over `content` pixels: their
// non-zero run into w[0, count), its first pixel into *first. Returns the
// count, or -1 where the candidates are more than `taps`.
template <typename T>
__device__ int axis_taps(float lo, float span, float ss, int content, int o, float inv_out,
                         int taps, float* w, int* first) {
  const float c = __fsub_rn(__fadd_rn(lo, __fmul_rn(__fmul_rn((float)o + 0.5f, span), inv_out)),
                            0.5f);
  const float r = 2.0f * ss;
  const float kt = 2.0f * ((float)content - 1.0f);
  // candidates: the hull of the supports |i - c| < r, |(kt - i) - c| < r
  // (i <= content - 2) and |-i - c| < r (i >= 1), inside [0, content)
  int a = INT_MAX, z = INT_MIN;
  const float centre[3] = {c, __fsub_rn(kt, c), -c};
  const int lo_i[3] = {0, 0, 1}, hi_i[3] = {content - 1, content - 2, content - 1};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int s = max(lo_i[k], floor_i(__fsub_rn(centre[k], r)));
    const int e = min(hi_i[k], ceil_i(__fadd_rn(centre[k], r)));
    if (s <= e) {
      a = min(a, s);
      z = max(z, e);
    }
  }
  *first = 0;
  if (a > z) return 0;
  if (z - a + 1 > taps) return -1;
  float sum = 0.0f;
  for (int i = a; i <= z; ++i) {
    const float fi = (float)i;
    float v = cubic(__fdiv_rn(__fsub_rn(fi, c), ss));
    // a reflected term at least r + 1 from its centre is exactly 0: skipped
    if (i <= content - 2) {
      const float d = __fsub_rn(__fsub_rn(kt, fi), c);
      if (fabsf(d) < r + 1.0f) v = __fadd_rn(v, cubic(__fdiv_rn(d, ss)));
    }
    if (i >= 1) {
      const float d = __fsub_rn(-fi, c);
      if (fabsf(d) < r + 1.0f) v = __fadd_rn(v, cubic(__fdiv_rn(d, ss)));
    }
    w[i - a] = v;
    sum = __fadd_rn(sum, v);
  }
  const float s = fmaxf(sum, 1e-8f);
  int f = -1, l = -1;
  for (int t = 0; t <= z - a; ++t) {
    const float v = rnd<T>(__fdiv_rn(w[t], s));
    w[t] = v;
    if (v != 0.0f) {
      if (f < 0) f = t;
      l = t;
    }
  }
  if (f < 0) return 0;
  for (int t = 0; t <= l - f; ++t) w[t] = w[f + t];
  *first = a + f;
  return l - f + 1;
}

__device__ __forceinline__ uint32_t load4(const uint8_t* p, const uint8_t* end, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t v = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (p + k < end) v |= (uint32_t)__ldg(p + k) << (8 * k);
  return v;
}

template <typename T>
__device__ __forceinline__ void store_group(T* dst, const float (&v)[RB_GROUP * 3], int count,
                                            bool vec);

template <>
__device__ __forceinline__ void store_group<__nv_bfloat16>(__nv_bfloat16* dst,
                                                           const float (&v)[RB_GROUP * 3],
                                                           int count, bool vec) {
  if (vec) {
    uint32_t packed[RB_GROUP * 3 / 2];
#pragma unroll
    for (int k = 0; k < RB_GROUP * 3 / 2; ++k) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      packed[k] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int k = 0; k < RB_GROUP * 3 / 8; ++k)
      d[k] = make_uint4(packed[4 * k], packed[4 * k + 1], packed[4 * k + 2], packed[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < RB_GROUP * 3; ++k)
      if (k < count) dst[k] = __float2bfloat16_rn(v[k]);
  }
}

template <>
__device__ __forceinline__ void store_group<float>(float* dst, const float (&v)[RB_GROUP * 3],
                                                   int count, bool vec) {
  if (vec) {
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int k = 0; k < RB_GROUP * 3 / 4; ++k)
      d[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < RB_GROUP * 3; ++k)
      if (k < count) dst[k] = v[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(RB_THREADS, 4) resize_band_kernel(const ResizeArgs a) {
  extern __shared__ float4 smem_f4[];
  float* wx = reinterpret_cast<float*>(smem_f4);  // column p's weights at p * ts + p / 8
  float* wy = wx + a.o * a.ts + rb_cols(a.o);     // [RB_ROWS][ts]: each row's
  int* xf = reinterpret_cast<int*>(wy + RB_ROWS * a.ts);  // column p's first pixel at p + p / 8
  int* xn = xf + rb_cols(a.o);                            // ... its taps
  int* yf = xn + rb_cols(a.o);                            // [RB_ROWS]
  int* yn = yf + RB_ROWS;                                 // [RB_ROWS]
  int* misc = yn + RB_ROWS;                               // window lo, hi; fault
  T* tmp = reinterpret_cast<T*>(smem_f4 + (rb_words(a.o, a.ts) + 3) / 4);

  const int b = blockIdx.z, n = blockIdx.y, r0 = blockIdx.x * RB_ROWS;
  const int rows = min(RB_ROWS, a.o - r0);
  const float* box = a.boxes + b * a.box_stride + n * 4;
  const float y0 = box[0], x0 = box[1], y1 = box[2], x1 = box[3];
  const int ch = a.content[2 * b], cw = a.content[2 * b + 1];
  const float inv_out = 1.0f / (float)a.o;
  const float sy = __fsub_rn(y1, y0), sx = __fsub_rn(x1, x0);
  const float ssy = a.antialias ? fmaxf(__fmul_rn(sy, inv_out), 1.0f) : 1.0f;
  const float ssx = a.antialias ? fmaxf(__fmul_rn(sx, inv_out), 1.0f) : 1.0f;
  const bool geometry_ok = ch >= 1 && cw >= 1 && ch <= a.h && cw <= a.w;

  if (threadIdx.x == 0) {
    misc[0] = INT_MAX;
    misc[1] = INT_MIN;
    misc[2] = geometry_ok ? 0 : 1;
  }
  __syncthreads();
  if (geometry_ok) {
    for (int j = threadIdx.x; j < a.o + rows; j += blockDim.x) {
      int f;
      if (j < a.o) {
        const int k =
            axis_taps<T>(x0, sx, ssx, cw, j, inv_out, a.taps, wx + j * a.ts + j / 8, &f);
        if (k < 0) atomicOr(&misc[2], 1);
        xf[j + j / 8] = f;
        xn[j + j / 8] = max(k, 0);
        if (k > 0) {
          atomicMin(&misc[0], f);
          atomicMax(&misc[1], f + k);
        }
      } else {
        const int r = j - a.o;
        const int k = axis_taps<T>(y0, sy, ssy, ch, r0 + r, inv_out, a.taps, wy + r * a.ts, &f);
        if (k < 0) atomicOr(&misc[2], 1);
        yf[r] = f;
        yn[r] = max(k, 0);
      }
    }
  }
  __syncthreads();
  const bool bad = misc[2] != 0;
  // the window's first pixel a multiple of 4 (12 bytes): its 32-bit loads stay aligned
  const int win0 = misc[0] <= misc[1] ? (misc[0] & ~3) : 0;
  const int words = misc[0] <= misc[1] ? (3 * (misc[1] - win0) + 3) / 4 : 0;
  const size_t row_bytes = (size_t)a.w * 3;
  const bool vec_in = (row_bytes % 4) == 0;
  const uint8_t* img = a.img + (size_t)b * a.h * row_bytes;
  const uint8_t* img_end = img + (size_t)a.h * row_bytes;
  const int groups = (a.o + RB_GROUP - 1) / RB_GROUP;
  const bool vec_out = ((size_t)a.o * 3 * sizeof(T)) % 16 == 0;
  T* out = reinterpret_cast<T*>(a.out) + ((size_t)(b * a.n + n) * a.o + r0) * a.o * 3;
  constexpr float kInv255 = 1.0f / 255.0f;

  for (int band = 0; band < rows; band += RB_BAND) {
    const int nb = min(RB_BAND, rows - band);
    if (!bad) {
      // rows pass: 4 consecutive bytes (values) of the window a thread
      for (int it = threadIdx.x; it < nb * words; it += blockDim.x) {
        const int r = it / words, k = it - r * words;
        const float* wr = wy + (band + r) * a.ts;
        const int cnt = yn[band + r];
        const uint8_t* src = img + (size_t)yf[band + r] * row_bytes + win0 * 3 + 4 * k;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int t = 0; t < cnt; ++t, src += row_bytes) {
          const uint32_t v = load4(src, img_end, vec_in);
          const float wt = wr[t];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float px = rnd<T>(__fmul_rn((float)((v >> (8 * q)) & 0xffu), kInv255));
            acc[q] = fmaf(wt, px, acc[q]);
          }
        }
        T* dst = tmp + r * a.tmp_stride + 4 * k;
#pragma unroll
        for (int q = 0; q < 4; ++q) dst[q] = narrow<T>(acc[q]);
      }
    }
    __syncthreads();
    // columns pass: 8 output pixels of a row a thread
    for (int it = threadIdx.x; it < nb * groups; it += blockDim.x) {
      const int r = it / groups, g = it - r * groups;
      const int p0 = g * RB_GROUP, np = min(RB_GROUP, a.o - p0);
      float v[RB_GROUP * 3];
#pragma unroll
      for (int j = 0; j < RB_GROUP; ++j) {
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
        if (j < np && !bad) {
          const int p = p0 + j;
          const float* wp = wx + p * a.ts + g;
          const T* tp = tmp + r * a.tmp_stride + 3 * (xf[p + g] - win0);
          const int cnt = xn[p + g];
          for (int t = 0; t < cnt; ++t, tp += 3) {
            const float wt = wp[t];
            s0 = fmaf(wt, widen(tp[0]), s0);
            s1 = fmaf(wt, widen(tp[1]), s1);
            s2 = fmaf(wt, widen(tp[2]), s2);
          }
        }
        const float s[3] = {s0, s1, s2};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float y = rnd<T>(s[c]);
          if (a.normalize) y = rnd<T>(__fdiv_rn(rnd<T>(__fsub_rn(y, a.mean[c])), a.std[c]));
          v[3 * j + c] = bad ? __int_as_float(0x7fc00000) : y;
        }
      }
      store_group<T>(out + ((size_t)(band + r) * a.o + p0) * 3, v, 3 * np,
                     vec_out && np == RB_GROUP);
    }
    __syncthreads();
  }
}

// dynamic shared memory of a launch (rb_words, then the rows pass's rows)
inline size_t resize_band_smem(int o, int ts, int tmp_stride, size_t elem) {
  return (size_t)(rb_words(o, ts) + 3) / 4 * 16 + (size_t)RB_BAND * tmp_stride * elem;
}

template <typename T>
cudaError_t launch_resize_band(const ResizeArgs& a, int b, cudaStream_t stream) {
  const size_t smem = resize_band_smem(a.o, a.ts, a.tmp_stride, sizeof(T));
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(resize_band_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.o + RB_ROWS - 1) / RB_ROWS, a.n, b);
  resize_band_kernel<T><<<grid, RB_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace leclip

extern "C" {

// images [b, h, w, 3] uint8, boxes fp32 (y0, x0, y1, x1) with box_stride
// floats between images (0: one [n, 4] set for the batch), content int32
// [b, 2], out [b, n, o, o, 3] bf16 (bf16 = 1) or fp32; all contiguous, on
// the card. `taps` bounds a row's candidate taps (resize_kernels.max_taps);
// mean and std (3 each) are clip_normalize's, in the output dtype, used where
// `normalize`. One launch on `stream`; returns a cudaError_t.
int leclip_resize_band(const void* images, const void* boxes, const void* content, void* out,
                       int b, int h, int w, int n, long long box_stride, int o, int taps,
                       int antialias, int bf16, int normalize, const float* mean,
                       const float* std, void* stream) {
  using namespace leclip;
  if (b < 0 || h <= 0 || w <= 0 || n < 0 || o <= 0 || taps <= 0 || box_stride < 0 ||
      (long long)h * w * 3 > 0x7fffffffLL || b > 65535 || n > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || n == 0) return (int)cudaSuccess;
  ResizeArgs a{static_cast<const uint8_t*>(images), static_cast<const float*>(boxes),
               static_cast<const int*>(content), out, box_stride, h, w, n, o, taps,
               taps | 1, ((3 * w + 12) + 7) / 8 * 8, antialias, normalize};
  for (int c = 0; c < 3; ++c) {
    a.mean[c] = mean[c];
    a.std[c] = std[c];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_resize_band<__nv_bfloat16>(a, b, s)
                    : launch_resize_band<float>(a, b, s));
}

}  // extern "C"
