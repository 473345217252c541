// Average pool of an NHWC map over k x k windows at stride k, no padding,
// floor mode (F.avg_pool2d(x, k) on the NCHW view), for sm_90a (Hopper):
//
//   out[b, oh, ow, c] = dt(fdiv(sum over i < k, j < k of x[b, k oh + i, k ow + j, c], k * k))
//
// with the sum in fp32 from 0, window rows top to bottom and each row's
// columns left to right, fdiv the IEEE fp32 division and dt the one rounding
// to the element type (bf16 or fp32). These are the operations of PyTorch's
// avg_pool2d_out_cuda_frame_nhwc in that order, so the output is the
// library's bit for bit, at k = 3 too (a product by the reciprocal 1/9 is
// not). Rows and columns past the last whole window are not read.
//
// Replaces no Pallas kernel: the JAX package's pool is XLA's reduce_window
// (leclip_tpu/models/resnet.py avg_pool). The port ran PyTorch's avg_pool2d
// on the NHWC view; in a traced rn50.score window its kernel took 0.263 s of
// 6 batches, 43.8 ms a batch, second only to the convolutions: one thread
// an output element, each with 2-byte loads and a chain of 64-bit index
// divisions, ~12% of the card's bandwidth.
//
// Bound on the H100: bytes. A 2 x 2 average does no arithmetic to speak of;
// RN50's seven pools at the scoring cells' batch (8 images x 305 crops) read
// 14.20 GB and write 3.55 GB, 5.30 ms at 3.35 TB/s.
//
// Design: one thread an output pixel and 16-byte channel vector (8 bf16 or
// 4 fp32 lanes), consecutive threads on consecutive vectors of a pixel, so
// a warp's loads of one window position cover whole 32-byte sectors. The
// index math is 32-bit over vectors (one divmod by the vectors a pixel, then
// by the output width and height), 64-bit only for the byte offsets. At the
// trunk's k = 2 a thread starts its four loads together (another window is
// read row by row), as independent 16-byte read-only loads that do not
// allocate in L1 (each byte is read once), then sums them in order; the
// output goes out as one 16-byte streaming store. At full occupancy an
// SM holds 2048 threads, 128 KB of loads in flight at k = 2, several times
// what the bandwidth-latency product asks.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace leclip {

constexpr int AP_THREADS = 256;

__device__ __forceinline__ uint4 ld_once(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void st_stream(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// a 16-byte vector as fp32 lanes, and back, for each element type
template <typename T>
struct Vec16;

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int lanes = 8;
  __device__ static void add(float* acc, uint4 v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = __fadd_rn(acc[2 * i], __uint_as_float(w[i] << 16));
      acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], __uint_as_float(w[i] & 0xffff0000u));
    }
  }
  __device__ static uint4 pack(const float* r) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(r[2 * i]))) |
             (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(r[2 * i + 1]))) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec16<float> {
  static constexpr int lanes = 4;
  __device__ static void add(float* acc, uint4 v) {
    acc[0] = __fadd_rn(acc[0], __uint_as_float(v.x));
    acc[1] = __fadd_rn(acc[1], __uint_as_float(v.y));
    acc[2] = __fadd_rn(acc[2], __uint_as_float(v.z));
    acc[3] = __fadd_rn(acc[3], __uint_as_float(v.w));
  }
  __device__ static uint4 pack(const float* r) {
    return make_uint4(__float_as_uint(r[0]), __float_as_uint(r[1]), __float_as_uint(r[2]),
                      __float_as_uint(r[3]));
  }
};

struct PoolArgs {
  const char* x;    // [b, h, w, c] of T
  char* out;        // [b, ho, wo, c] of T
  uint32_t n;       // output vectors: b * ho * wo * vecs
  uint32_t vecs;    // 16-byte vectors a pixel: c * sizeof(T) / 16
  uint32_t ho, wo;  // output height and width
  uint32_t h;       // input height
  uint64_t row;     // bytes of an input row: w * c * sizeof(T)
  int k;            // window and stride
};

// K == 2: the trunk's window, its 4 loads started together; K == 0: any
// window, read row by row
template <typename T, int K>
__global__ void __launch_bounds__(AP_THREADS) avg_pool_nhwc_kernel(PoolArgs a) {
  using V = Vec16<T>;
  const uint32_t idx = blockIdx.x * AP_THREADS + threadIdx.x;
  if (idx >= a.n) return;
  const uint32_t v = idx % a.vecs;
  const uint32_t pix = idx / a.vecs;
  const uint32_t ow = pix % a.wo;
  const uint32_t t = pix / a.wo;
  const uint32_t oh = t % a.ho;
  const uint32_t b = t / a.ho;
  const int k = K > 0 ? K : a.k;
  const uint64_t pixel = uint64_t(a.vecs) * 16;
  const char* src = a.x + (uint64_t(b) * a.h + uint64_t(oh) * k) * a.row +
                    uint64_t(ow) * k * pixel + uint64_t(v) * 16;
  float acc[V::lanes];
#pragma unroll
  for (int l = 0; l < V::lanes; ++l) acc[l] = 0.0f;
  if constexpr (K > 0) {
    uint4 in[K * K];
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) in[i * K + j] = ld_once(src + i * a.row + j * pixel);
#pragma unroll
    for (int i = 0; i < K * K; ++i) V::add(acc, in[i]);
  } else {
    for (int i = 0; i < k; ++i)
      for (int j = 0; j < k; ++j) V::add(acc, ld_once(src + i * a.row + j * pixel));
  }
  const float div = float(k * k);
#pragma unroll
  for (int l = 0; l < V::lanes; ++l) acc[l] = __fdiv_rn(acc[l], div);
  st_stream(a.out + uint64_t(idx) * 16, V::pack(acc));
}

template <typename T>
cudaError_t launch(const PoolArgs& a, cudaStream_t stream) {
  const dim3 grid((a.n + AP_THREADS - 1) / AP_THREADS);
  if (a.k == 2)
    avg_pool_nhwc_kernel<T, 2><<<grid, AP_THREADS, 0, stream>>>(a);
  else
    avg_pool_nhwc_kernel<T, 0><<<grid, AP_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace leclip

// x [b, h, w, c] contiguous NHWC, bf16 (bf16 = 1) or fp32, 16-byte aligned,
// c * sizeof(T) % 16 == 0; out [b, h / k, w / k, c]. Returns a cudaError_t.
extern "C" int leclip_avg_pool_nhwc(const void* x, void* out, int b, int h, int w, int c, int k,
                                    int bf16, void* stream) {
  using namespace leclip;
  const int elem = bf16 ? 2 : 4;
  if (b < 0 || h < 0 || w < 0 || c <= 0 || k <= 0 || (c * elem) % 16 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16)
    return cudaErrorInvalidValue;
  PoolArgs a;
  a.x = static_cast<const char*>(x);
  a.out = static_cast<char*>(out);
  a.vecs = uint32_t(c * elem / 16);
  a.ho = uint32_t(h / k);
  a.wo = uint32_t(w / k);
  a.h = uint32_t(h);
  a.row = uint64_t(w) * uint64_t(c) * elem;
  a.k = k;
  const uint64_t n = uint64_t(b) * a.ho * a.wo * a.vecs;
  if (n >= (1ull << 31)) return cudaErrorInvalidValue;
  a.n = uint32_t(n);
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}
