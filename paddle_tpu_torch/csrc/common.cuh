// Shared helpers for the port's hand-written Hopper kernels: dtype codes
// (the Python wrappers pass them as plain ints), float conversions through
// the CUDA intrinsics, and the per-dtype dispatch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// A source that paddle_tpu_torch/ops/_build.py builds in parts (PARTS) is
// compiled once per part with -DPTT_PART=p, each part instantiating its
// share of the kernels, and the parts are linked into one library; built
// whole, PTT_PART is -1.
#ifndef PTT_PART
#define PTT_PART -1
#endif

namespace ptt {

// dtype codes; keep in step with _DTYPE_CODES in paddle_tpu_torch/ops/_build.py
enum DType : int { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Large dynamic shared memory (above 48 KB) has to be opted into per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ptt

// Runs BODY with `scalar_t` bound to the C++ type of dtype code CODE;
// an unknown code returns cudaErrorInvalidValue from the enclosing function.
#define PTT_DISPATCH_DTYPE(CODE, ...)                      \
  switch (CODE) {                                          \
    case ptt::kF32: {                                      \
      using scalar_t = float;                              \
      __VA_ARGS__;                                         \
      break;                                               \
    }                                                      \
    case ptt::kF16: {                                      \
      using scalar_t = __half;                             \
      __VA_ARGS__;                                         \
      break;                                               \
    }                                                      \
    case ptt::kBF16: {                                     \
      using scalar_t = __nv_bfloat16;                      \
      __VA_ARGS__;                                         \
      break;                                               \
    }                                                      \
    default:                                               \
      return static_cast<int>(cudaErrorInvalidValue);      \
  }
