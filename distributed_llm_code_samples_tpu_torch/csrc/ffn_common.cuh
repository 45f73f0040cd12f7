// Small f32 pieces for Hopper (sm_90a) that predate the GEMM core of
// gemm_core.cuh, kept for the flash-attention kernels (through
// flash_common.cuh): bf16 rounding, op, the 4-byte cp.async copies and
// set_smem. The FFN kernels and both fused-head kernels run on
// gemm_core.cuh.
//
// With kBf16 (the Pallas kernels' `mxu_bf16`) an operand is rounded to
// bf16 (round to nearest even); the product of two bf16 values is exact
// in f32, and sums stay f32, which is what `preferred_element_type=f32`
// computes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace ffn {

constexpr size_t kMaxSmem = 232448;  // 227 KB a block may use on sm_90

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16>
__device__ __forceinline__ float op(float v) {
  return kBf16 ? bf16_round(v) : v;
}

// 4 bytes from device to shared memory, no registers held; zero-filled
// when !ok (src then only a valid base).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

inline cudaError_t set_smem(const void* kern, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace ffn
