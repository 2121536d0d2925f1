// Shared helpers of the hand-written kernels: the dtype code the Python
// wrappers pass (0 = float32, 1 = bfloat16), warp reductions, cp.async
// (16-byte copies into shared memory, their commit groups and waits), and
// the split of an fp32 value into the two TF32 parts of a 3xTF32 product.
#pragma once

#include <stdint.h>

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 mantissa bits; to nearest, ties away from zero:
// cvt.rna.tf32.f32's rounding), as the fp32 bit pattern the tensor cores
// read: half a TF32 ulp added to the magnitude's bits, then the 13 low bits
// cleared (a carry moves into the exponent). Two integer operations for
// finite x: the split runs on every staged element, and this form made
// both tf32 kernels faster on the H100 than the cvt instruction did.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo + e, hi = tf32(x), lo = tf32(x - hi) (x - hi is exact), |e|
// <= 2^-22 |x|. A 3xTF32 product takes hi.hi + hi.lo + lo.hi with fp32
// accumulation; the dropped lo.lo is about 2^-22 of the product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

}  // namespace trk
