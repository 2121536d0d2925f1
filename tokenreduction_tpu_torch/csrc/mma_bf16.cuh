// The bf16 tensor-core building blocks of the kernel tools' attention
// prototypes (proto_attn.cu, proto_attn_bwd.cu, through attn_tile.cuh):
// mma.sync m16n8k16 with fp32 accumulators and ldmatrix loads of its
// fragments from shared memory.
//
// Fragments (lane = 4 g + t): A, 16 x 16 row-major, a0 (row g, k 2t..2t+1),
// a1 (row g + 8), a2 (row g, k 8 + 2t), a3 (row g + 8, k 8 + 2t); B, 16 x 8
// stored n-major (k contiguous), b0 (k 2t..2t+1, n g), b1 (k 8 + 2t, n g);
// C, 16 x 8, c0 c1 (row g, n 2t..2t+1), c2 c3 (row g + 8).
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>

namespace trk {

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 matrices of 16-bit elements; lane l gives the row address of
// matrix l / 8 (16-byte aligned); register j gets matrix j's fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same, each matrix transposed as it is loaded.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Two fp32 values rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of a 16 x 16 tile of a row-major bf16 array in shared
// memory (row stride ld elements) at (r0, k0).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s, int ld, int r0,
                                       int k0, int lane) {
  ldmatrix_x4(a, s + (r0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
}

// The B fragments of two neighbouring 8-wide n tiles (n0, n0 + 8) at k0
// of an n-major bf16 array [n][k] (row stride ld): b[0], b[1] for n0,
// b[2], b[3] for n0 + 8.
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const __nv_bfloat16* s, int ld, int n0,
                                        int k0, int lane) {
  ldmatrix_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + (((lane >> 3) & 1) << 3));
}

// The same from a k-major array [k][n] (row stride ld), transposed by
// ldmatrix: the value operand of P . V.
__device__ __forceinline__ void load_b2_trans(uint32_t (&b)[4], const __nv_bfloat16* s, int ld,
                                              int n0, int k0, int lane) {
  ldmatrix_x4_trans(b, s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 +
                           ((lane >> 4) << 3));
}

}  // namespace trk
