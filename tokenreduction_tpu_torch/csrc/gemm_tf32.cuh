// What the two fp32 GEMMs on the tensor cores (3xTF32) share: the
// forward layout's (gemm_tf32_sm90.cu) and the backward's two layouts
// (gemm_tf32_bwd_sm90.cu). Both compute 128 x 128 output tiles with two
// consumer warpgroups of 64 rows, K steps of BK = 32 (one 128-byte row of
// fp32: the swizzle span), each operand's hi and lo parts stored K-major
// with the 128-byte swizzle, lo 32 KB after hi. Here: the m64n128k8 TF32
// wgmma, one K step's products, and the host's tensor maps of fp32 tensors.
#pragma once

#include <stdint.h>

#include "sm90.cuh"

namespace trk {

constexpr int TF32_ACC = 64;  // fp32 accumulators per consumer thread of a 64 x 128 tile

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
__device__ __forceinline__ void fence_acc_tf32(float* d) {
#pragma unroll
  for (int i = 0; i < TF32_ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] = A[64 x 8] . B[8 x 128] (+ d unless scale_d is 0), TF32
// from shared memory, both K-major (tf32 wgmma reads no other layout).
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One K step of a consumer warpgroup's 64 x 128 tile into p from zero: the
// small products first (each k8 slice's A_lo.B_hi, A_hi.B_lo), then the
// four hi.hi, so the step's partial sum is truncated at its full size four
// times, not twelve; the caller adds p to its sum in fp32 (round to
// nearest). sa: the warpgroup's 64 rows of A's hi part, sb: B's hi part,
// each part's lo `lo` bytes further; returns once the products retired.
__device__ __forceinline__ void k_step_3xtf32(float* p, uint32_t sa, uint32_t sb, uint32_t lo) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t a_hi = smem_desc(sa + kk * 32, 16, 1024);
    const uint64_t b_hi = smem_desc(sb + kk * 32, 16, 1024);
    wgmma_tf32(p, smem_desc(sa + lo + kk * 32, 16, 1024), b_hi, kk);
    wgmma_tf32(p, a_hi, smem_desc(sb + lo + kk * 32, 16, 1024), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_tf32(p, smem_desc(sa + kk * 32, 16, 1024), smem_desc(sb + kk * 32, 16, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc_tf32(p);
}

// The map of a row-major fp32 tensor [rows][cols], cut into boxes of
// box_rows x box_cols; reads past an edge are zeros. With the 128-byte
// swizzle a box row is 32 columns (128 bytes).
inline cudaError_t tensor_map_f32(CUtensorMap* map, const void* ptr, int rows, int cols,
                                  int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace trk
