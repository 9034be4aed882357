// Shared helpers of the hand-written Hopper kernels (sm_90a).
//
// Every kernel is exported through a plain C function that launches it
// on the caller's stream and returns cudaGetLastError() (0 on success),
// so the Python wrapper raises on a launch that CUDA refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

constexpr unsigned kFull = 0xffffffffu;

}  // namespace rt
