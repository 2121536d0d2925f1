// Shared helpers of the hand-written kernels: the dtype code the Python
// wrappers pass (0 = float32, 1 = bfloat16) and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace trk {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace trk
