// The MLP half with the hidden tensor kept on chip: the counterpart of the
// TPU kernel tools/tune_kernels.py mlp_chunked (its pallas_call at :282,
// _mlp_chunk_kernel), for Hopper (sm_90a), in bf16:
//
//   out = x + fc2(gelu(fc1(LN2 x))),   x, out [M, 384]; W1 [H4, 384] and
//   W2 [384, H4] in nn.Linear's [out, in] layout; H4 a multiple of 32.
//
// Numerics as the TPU kernel's: LayerNorm in fp32 (two-pass statistics),
// its output rounded to bf16; fc1 accumulated in fp32, plus b1, the exact
// GELU in fp32 (erff, where the TPU kernel has a rational erf within
// 1.5e-7), the hidden rounded to bf16; fc2 accumulated in fp32 over all
// hidden units; x + acc + b2 in fp32, rounded once.
//
// Design. A block takes BM = 64 rows and keeps them to the end: LN2 of its
// rows into shared memory once, then the hidden width in slices of HC = 32
// units: fc1's [64, 32] slice on the tensor cores (mma.sync m16n8k16), its
// bias and GELU, rounded into shared memory, and at once fc2's products of
// that slice added to the block's fp32 accumulator [64, 384], which lives
// in registers (96 a thread over 8 warps) for the whole run. The hidden
// tensor [M, H4] never reaches device memory: that is what the three
// launches of ops/fused_mlp.py write and read back (2 x 310 MB at B = 256,
// N = 197). The two weight slices of the next HC units are copied
// (cp.async) while this slice's products run.
//
// What bounds it. Operations: 16 M D^2 = 119 GFLOP at M = 50,432, 0.121 ms
// at the bf16 rate. The design's tension on this card: the accumulator of
// a 64-row tile is the most the registers hold, so each of the M / 64
// blocks reads both weight matrices whole (2.36 MB of bf16) from L2: 1.86
// GB at M = 50,432, more than the 0.62 GB of the hidden round trip it
// saves, though from L2 and not from device memory. mma.sync reaches only
// part of the tensor cores' rate (wgmma is the only way to all of it), and
// each slice's two products wait on each other through shared memory.
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace trk {
namespace {

constexpr int MD = 384;              // the model width the kernel is compiled for
constexpr int MBM = 64;              // rows a block
constexpr int HC = 32;               // hidden units a slice
constexpr int MTHREADS = 256;        // 8 warps
constexpr int LDX = MD + 8;          // row stride (elements) of LN and W1 slices: 784 bytes
constexpr int LDH = HC + 8;          // row stride of W2 slices and the hidden slice: 80 bytes
constexpr int LN_ELEMS = MBM * LDX;
constexpr int W1_ELEMS = HC * LDX;
constexpr int W2_ELEMS = MD * LDH;
constexpr int STAGE_ELEMS = W1_ELEMS + W2_ELEMS;
constexpr int H_ELEMS = MBM * LDH;
constexpr int MLP_SMEM = 2 * (LN_ELEMS + 2 * STAGE_ELEMS + H_ELEMS);
static_assert(MLP_SMEM <= 232448, "over the H100's 227 KB of shared memory a block");

// The two weight slices of hidden units [c * HC, (c + 1) * HC): W1's HC
// rows of 384 and W2's 384 rows of HC, 16 bytes a copy.
__device__ __forceinline__ void load_slice(__nv_bfloat16* stage, const __nv_bfloat16* w1,
                                           const __nv_bfloat16* w2, int H4, int c) {
  __nv_bfloat16* s1 = stage;
  __nv_bfloat16* s2 = stage + W1_ELEMS;
  constexpr int V1 = MD / 8, V2 = HC / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < HC * V1; i += MTHREADS) {
    const int r = i / V1, v = i % V1;
    cp_async16(s1 + r * LDX + 8 * v, w1 + static_cast<size_t>(c * HC + r) * MD + 8 * v, true);
  }
  for (int i = threadIdx.x; i < MD * V2; i += MTHREADS) {
    const int r = i / V2, v = i % V2;
    cp_async16(s2 + r * LDH + 8 * v, w2 + static_cast<size_t>(r) * H4 + c * HC + 8 * v, true);
  }
}

__device__ __forceinline__ void unpack4_bf16(uint2 r, float* f) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

__global__ void __launch_bounds__(MTHREADS, 1)
    mlp_chunked_kernel(const __nv_bfloat16* __restrict__ x, int M,
                       const __nv_bfloat16* __restrict__ ls, const __nv_bfloat16* __restrict__ lb,
                       const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
                       const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ b2,
                       int H4, float eps, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) __nv_bfloat16 msmem[];
  __nv_bfloat16* s_ln = msmem;
  __nv_bfloat16* s_stage = s_ln + LN_ELEMS;  // two stages
  __nv_bfloat16* s_h = s_stage + 2 * STAGE_ELEMS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * MBM;
  const int slices = H4 / HC;

  load_slice(s_stage, w1, w2, H4, 0);
  cp_async_commit();

  // LN2 of the block's rows, a warp a row at a time, 12 elements a lane
  for (int r = warp; r < MBM; r += MTHREADS / 32) {
    const int row = m0 + r;
    float f[3][4];
    if (row < M) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        unpack4_bf16(*reinterpret_cast<const uint2*>(x + static_cast<size_t>(row) * MD +
                                                     4 * (lane + 32 * c)),
                     f[c]);
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) f[c][0] = f[c][1] = f[c][2] = f[c][3] = 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) s += (f[c][0] + f[c][1]) + (f[c][2] + f[c][3]);
    const float mu = warp_sum(s) / MD;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) q += (f[c][i] - mu) * (f[c][i] - mu);
    const float rs = 1.0f / sqrtf(warp_sum(q) / MD + eps);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int col = 4 * (lane + 32 * c);
      float gm[4], bt[4], y[4];
      unpack4_bf16(*reinterpret_cast<const uint2*>(ls + col), gm);
      unpack4_bf16(*reinterpret_cast<const uint2*>(lb + col), bt);
#pragma unroll
      for (int i = 0; i < 4; ++i) y[i] = (f[c][i] - mu) * rs * gm[i] + bt[i];
      uint2 packed;
      packed.x = pack_bf16(y[0], y[1]);
      packed.y = pack_bf16(y[2], y[3]);
      *reinterpret_cast<uint2*>(s_ln + r * LDX + col) = packed;
    }
  }

  // fc1 of a slice: warp (wm1, wn1) takes rows 16 wm1 .. + 15 and hidden
  // units 16 wn1 .. + 15 of the slice; fc2: warp (wm2, wn2) takes rows
  // 32 wm2 .. + 31 and output columns 96 wn2 .. + 95 (2 x 12 tiles)
  const int wm1 = warp & 3, wn1 = warp >> 2;
  const int wm2 = warp & 1, wn2 = warp >> 1;
  float acc[2][12][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int c = 0; c < slices; ++c) {
    if (c + 1 < slices) {
      load_slice(s_stage + ((c + 1) & 1) * STAGE_ELEMS, w1, w2, H4, c + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice c's weights (and, at c = 0, LN) are in
    const __nv_bfloat16* s_w1 = s_stage + (c & 1) * STAGE_ELEMS;
    const __nv_bfloat16* s_w2 = s_w1 + W1_ELEMS;

    float h[2][4] = {};
#pragma unroll 4
    for (int k = 0; k < MD; k += 16) {
      uint32_t a[4], b[4];
      load_a(a, s_ln, LDX, 16 * wm1, k, lane);
      load_b2(b, s_w1, LDX, 16 * wn1, k, lane);
      mma_bf16(h[0], a, b[0], b[1]);
      mma_bf16(h[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 16 * wn1 + 8 * j + 2 * t;
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b1 + c * HC + col));
      const int r = 16 * wm1 + g;
      *reinterpret_cast<uint32_t*>(s_h + r * LDH + col) =
          pack_bf16(gelu_erf(h[j][0] + bb.x), gelu_erf(h[j][1] + bb.y));
      *reinterpret_cast<uint32_t*>(s_h + (r + 8) * LDH + col) =
          pack_bf16(gelu_erf(h[j][2] + bb.x), gelu_erf(h[j][3] + bb.y));
    }
    __syncthreads();  // the hidden slice is in

#pragma unroll
    for (int k = 0; k < HC; k += 16) {
      uint32_t a[2][4];
      load_a(a[0], s_h, LDH, 32 * wm2, k, lane);
      load_a(a[1], s_h, LDH, 32 * wm2 + 16, k, lane);
#pragma unroll
      for (int p = 0; p < 6; ++p) {
        uint32_t b[4];
        load_b2(b, s_w2, LDH, 96 * wn2 + 16 * p, k, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * p], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the stage and the hidden slice may be written again
  }

  // out = x + acc + b2, rounded once
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int col = 96 * wn2 + 8 * j + 2 * t;
      const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + col));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 32 * wm2 + 16 * i + g + 8 * e;
        if (row >= M) continue;
        const size_t at = static_cast<size_t>(row) * MD + col;
        const float2 xx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + at));
        *reinterpret_cast<uint32_t*>(out + at) =
            pack_bf16((xx.x + acc[i][j][2 * e]) + bb.x, (xx.y + acc[i][j][2 * e + 1]) + bb.y);
      }
    }
}

}  // namespace
}  // namespace trk

// out [M, 384] = x + fc2(gelu(fc1(LN x))) in bf16 (see above): x, out
// [M, 384]; ls, lb, b2 [384]; w1 [H4, 384]; b1 [H4]; w2 [384, H4]; all
// bf16, contiguous, 16-byte aligned (the caller checks). K must be 384 and
// H4 a multiple of 32. Returns the cudaError_t of the launch.
extern "C" int tr_mlp_chunked(const void* x, int M, int K, const void* ls, const void* lb,
                              const void* w1, const void* b1, const void* w2, const void* b2,
                              int H4, float eps, void* out, void* stream) {
  using namespace trk;
  if (M == 0) return 0;
  if (K != MD || H4 < HC || H4 % HC != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(mlp_chunked_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MLP_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  using B = __nv_bfloat16;
  const int blocks = (M + MBM - 1) / MBM;
  mlp_chunked_kernel<<<blocks, MTHREADS, MLP_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const B*>(x), M, static_cast<const B*>(ls), static_cast<const B*>(lb),
      static_cast<const B*>(w1), static_cast<const B*>(b1), static_cast<const B*>(w2),
      static_cast<const B*>(b2), H4, eps, static_cast<B*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's rows a block, hidden units a slice and dynamic shared
// memory a block, for the host: out[3].
extern "C" int tr_mlp_chunked_config(int* out) {
  out[0] = trk::MBM, out[1] = trk::HC, out[2] = trk::MLP_SMEM;
  return 0;
}
