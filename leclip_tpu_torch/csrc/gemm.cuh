// Helpers shared by the port's kernels: the bf16 type, a warp sum, shared
// memory addresses and the 16-byte cp.async copies (gemm_sm90.cuh,
// gemm_int8.cuh, layernorm.cuh, quant.cuh, attn_core.cuh).
//
// Built by nvcc for sm_90a into shared libraries with a plain C interface
// (leclip_tpu_torch/ops/_build.py); the Python wrappers pass raw device
// pointers and PyTorch's current stream, and check the returned cudaError_t.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace leclip {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the shared-state-space address of a pointer into shared memory
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gptr, bool valid) {
  const int bytes = valid ? 16 : 0;  // 0 source bytes: the 16 destination bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem_ptr)),
               "l"(gptr), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

}  // namespace leclip
