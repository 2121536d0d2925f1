// What the GEMM translation units share: the launch arguments, the
// gathered row of a residual, eight-element loads and stores, and the
// exact-erf GELU and its derivative.
// ln_gemm.cu keeps the C entry points; gemm_sm90.cu holds the bf16 GEMM
// (TMA, mbarrier, wgmma) that the entry points call for bf16 operands,
// gemm_tf32_sm90.cu the fp32 GEMM of the forward layout (the same, in
// 3xTF32) and gemm_tf32_bwd_sm90.cu the fp32 GEMM of the backward's two
// layouts (dY . W, the weight gradient; 3xTF32 with the MN-major operands
// transposed in shared memory).
#pragma once

#include <stddef.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace trk {

struct GemmArgs {
  const void* x;      // A: [M, K], or [K, M] (wgrad: dY)
  int M;
  int K;
  const void* w;      // B: [n_out, K], or [K, n_out]
  const void* bias;   // [n_out], or null
  int n_out;
  int gelu;
  float* gelu_grad;   // [M, n_out]: GELU'(pre-activation), or null
  const float* mul;   // [M, n_out] factor after the activation, or null
  const void* res;    // [*, n_out] residual, or null; fp32 when res_f32
  int res_f32;
  const int* idx;     // [M] residual row ids within an image, or null
  int rows_out;       // rows of Y per image (gathered residual)
  int rows_in;        // rows of res per image (gathered residual)
  void* y;            // [M, n_out], fp32 when y_f32; [splits][M, n_out] with k_split
  int y_f32;
  float* col_sums;    // [ceil(M / 128)][n_out]: fp32 column sums per 128-row tile, or null
  int k_split;        // K rows per split (a whole number of K steps), or 0 for all of K
  float* a_sums;      // A stored [K, M]: [splits][M] row sums of A over the split, or null
  const float* row_scale;  // [M / scale_rows] fp32 factor of row m's result before the
                           // residual (the forward layout of the bf16 GEMM only), or null
  int scale_rows;          // rows a factor: row m takes row_scale[m / scale_rows]
};

// Row b * rows_in + idx[m] of a gathered tensor for output row m; an id
// outside the image's rows faults the launch, as torch.gather's
// device-side check does, instead of reading another image's rows.
__device__ __forceinline__ int gathered_row(const int* idx, int m, int rows_out, int rows_in) {
  const int i = idx[m];
  if (static_cast<unsigned>(i) >= static_cast<unsigned>(rows_in)) __trap();
  return (m / rows_out) * rows_in + i;
}

// Eight neighbouring elements (16-byte aligned) to and from fp32.
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ size_t res_row(const GemmArgs& a, int row) {
  return a.idx != nullptr ? gathered_row(a.idx, row, a.rows_out, a.rows_in) : row;
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// d gelu / dv = Phi(v) + v phi(v), the exact derivative of the erf form.
__device__ __forceinline__ float gelu_grad(float v) {
  return 0.5f * (1.0f + erff(v * 0.7071067811865476f)) +
         v * 0.3989422804014327f * expf(-0.5f * v * v);
}

// The bf16 GEMM of gemm_sm90.cu. a_mn: A stored [K][M] (the weight
// gradient's dY, K split into `splits` slices of a.k_split rows); b_mn:
// B stored [K][n_out]. Returns a cudaError_t.
int launch_gemm_sm90(const GemmArgs& a, bool a_mn, bool b_mn, int splits, cudaStream_t stream);

// The fp32 GEMM of gemm_tf32_sm90.cu: the forward layout (W [n_out, K]),
// bias, GELU (and GELU' out) and an fp32 residual (rows gathered through
// idx), Y fp32; no factor, column sums or split. Returns a cudaError_t.
int launch_gemm_tf32_sm90(const GemmArgs& a, cudaStream_t stream);

// The fp32 GEMM of gemm_tf32_bwd_sm90.cu. wgrad: the weight gradient (A
// stored [K][M], K split into `splits` slices of a.k_split rows, a
// multiple of 32; row sums of A into a_sums), else dY . W (B stored [K][n_out];
// bias, GELU, the fp32 factor, an fp32 residual and column sums). Y fp32.
// Returns a cudaError_t.
int launch_gemm_tf32_bwd_sm90(const GemmArgs& a, bool wgrad, int splits, cudaStream_t stream);

}  // namespace trk
