// The per-head attention tile of the kernel tools' attention prototypes
// (proto_attn.cu, proto_attn_bwd.cu), on mma.sync m16n8k16 (mma_bf16.cuh):
// a head's rows staged into shared memory, a 16-row query tile's logits
// against all KP = 64 KT keys held in registers, their exact softmax, and
// the value product from the rounded probabilities.
//
// A head's rows in shared memory are [KP][ALD] bf16 (64 columns, 144-byte
// rows, so ldmatrix's 8 row addresses fall in distinct banks); rows past N
// are zeros. The logits are scaled, and the probabilities made, through
// __fmul_rn / __fsub_rn / __fdiv_rn, so that a pass that recomputes a chunk
// of them from the saved row statistics gets the same bits as the pass that
// made the statistics (no contraction into an FMA in one and not the other).
// The joint qkv + attention kernel tool (attn_joint.cu) runs the main
// path's wgmma steps instead (attention_sm90.cuh); the two prototypes
// here are the next to move onto them.
#pragma once

#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace trk {

constexpr int AHD = 64;           // head dim
constexpr int ALD = AHD + 8;      // row stride of a staged head, in elements
constexpr int ATHREADS = 256;     // 8 warps a block
constexpr int AWARPS = ATHREADS / 32;

// Rows 0 .. KP - 1 of the 64 columns at col0 of image b's rows (a [B, N,
// stride] bf16 tensor) into s [KP][ALD] by cp.async; rows past N zeros. The
// caller commits and waits.
__device__ __forceinline__ void stage_head(__nv_bfloat16* s, const __nv_bfloat16* src, int b,
                                           int N, int stride, int col0, int KP) {
  for (int i = threadIdx.x; i < KP * (AHD / 8); i += blockDim.x) {
    const int r = i >> 3, c = i & 7;
    const bool in = r < N;
    cp_async16(s + r * ALD + 8 * c,
               src + (static_cast<size_t>(b) * N + (in ? r : 0)) * stride + col0 + 8 * c, in);
  }
}

// The A fragments of the 16-row tile at row r0 of the 64 columns at col0
// of image b's rows, read from global memory (rows past N zeros).
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4][4], const __nv_bfloat16* src, int b,
                                            int N, int stride, int col0, int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int row = r0 + g + 8 * e;
    const bool in = row < N;
    const __nv_bfloat16* p =
        src + (static_cast<size_t>(b) * N + (in ? row : 0)) * stride + col0 + 2 * t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][e] = in ? *reinterpret_cast<const uint32_t*>(p + 16 * kk) : 0u;
      a[kk][2 + e] = in ? *reinterpret_cast<const uint32_t*>(p + 16 * kk + 8) : 0u;
    }
  }
}

// c[2][4]: the raw logits of a 16-row query tile (A fragments qa) against
// keys 16 pr .. 16 pr + 15 of the staged keys s_k.
__device__ __forceinline__ void logits_chunk(float (&c)[2][4], const uint32_t (&qa)[4][4],
                                             const __nv_bfloat16* s_k, int pr, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t bb[4];
    load_b2(bb, s_k, ALD, 16 * pr, 16 * kk, lane);
    mma_bf16(c[0], qa[kk], bb[0], bb[1]);
    mma_bf16(c[1], qa[kk], bb[2], bb[3]);
  }
}

// s[NT][4]: the raw logits of a 16-row query tile against all 8 NT keys.
template <int NT>
__device__ __forceinline__ void tile_logits(float (&s)[NT][4], const uint32_t (&qa)[4][4],
                                            const __nv_bfloat16* s_k, int lane) {
#pragma unroll
  for (int pr = 0; pr < NT / 2; ++pr) {
    float c[2][4];
    logits_chunk(c, qa, s_k, pr, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[2 * pr][e] = c[0][e];
      s[2 * pr + 1][e] = c[1][e];
    }
  }
}

// The probability of a raw logit from its row's max and sum.
__device__ __forceinline__ float prob(float raw, float scale, float mx, float sum) {
  return __fdiv_rn(expf(__fsub_rn(__fmul_rn(raw, scale), mx)), sum);
}

// s: the raw logits of a tile -> p = e / sum(e) over the keys < N, with
// e = exp(s * scale - the exact row max); keys past N get 0. mx and sum:
// the row max and sum of rows g (0) and g + 8 (1) of the tile.
template <int NT>
__device__ __forceinline__ void tile_softmax(float (&s)[NT][4], int N, float scale, int t,
                                             float (&mx)[2], float (&sum)[2]) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = 8 * j + 2 * t + (c & 1);
      if (key < N) mx[c >> 1] = fmaxf(mx[c >> 1], __fmul_rn(s[j][c], scale));
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = 8 * j + 2 * t + (c & 1);
      s[j][c] = key < N ? expf(__fsub_rn(__fmul_rn(s[j][c], scale), mx[c >> 1])) : 0.f;
      sum[c >> 1] += s[j][c];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = __fdiv_rn(s[j][c], sum[c >> 1]);
}

// The A fragment (16 rows x 16 k) of two neighbouring 8-column C tiles,
// rounded to bf16: the C layout of a product is the A layout of the next.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// o[8][4] += round(p) . V over the 8 NT keys (p in the C layout of
// tile_logits, V staged k-major [key][64]).
template <int NT>
__device__ __forceinline__ void tile_pv(float (&o)[8][4], const float (&p)[NT][4],
                                        const __nv_bfloat16* s_v, int lane) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t pa[4];
    pack_a(pa, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bb[4];
      load_b2_trans(bb, s_v, ALD, 16 * np, 16 * kk, lane);
      mma_bf16(o[2 * np], pa, bb[0], bb[1]);
      mma_bf16(o[2 * np + 1], pa, bb[2], bb[3]);
    }
  }
}

// Rows r0 .. r0 + 15 (those < N) of a 16 x 8 T tile group o, rounded to
// bf16, into the columns col0 .. col0 + 8 T - 1 of image b's rows of dst
// [B, N, stride].
template <int T>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&o)[T][4], int b,
                                           int N, int stride, int col0, int r0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < T; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = r0 + g + 8 * e;
      if (row < N)
        *reinterpret_cast<uint32_t*>(dst + (static_cast<size_t>(b) * N + row) * stride + col0 +
                                     8 * j + 2 * t) = pack_bf16(o[j][2 * e], o[j][2 * e + 1]);
    }
}

template <int T>
__device__ __forceinline__ void zero(float (&o)[T][4]) {
#pragma unroll
  for (int j = 0; j < T; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
}

}  // namespace trk
