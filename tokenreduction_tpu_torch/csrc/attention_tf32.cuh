// What the fp32 attention kernels on the tensor cores share
// (short_attention.cu: the forwards; short_attention_bwd.cu: the
// backward): the [B, H, N, 64] operands read through their strides, the
// block's shape (8 warps, rows of 64 floats padded to 68 in shared memory,
// keys in chunks of 32), and the 3xTF32 products on mma.sync m16n8k8: each
// operand split in registers into TF32 hi and lo, lo.hi + hi.lo + hi.hi.
#pragma once

#include <float.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace trk {
namespace {

constexpr int HD = 64;
constexpr int MAXN = 256;

// One [B, H, N, HD] operand with the head dim contiguous: element
// (b, h, n, d) at p[b * sb + h * sh + n * sn + d].
template <typename T>
struct Heads {
  T* p;
  long long sb, sh, sn;
  __device__ __forceinline__ T* row(int b, int h, int n) const {
    return p + b * sb + h * sh + n * sn;
  }
};

// Heads of the operands from strides[3 * i .. 3 * i + 2] (batch, head, row).
template <typename T, typename P>
Heads<T> heads(P ptr, const long long* strides, int i) {
  return Heads<T>{static_cast<T*>(ptr), strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

constexpr int TC_LD = HD + 4;  // a row's stride in shared memory: fragment loads hit 32 banks
constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_KEYS = 32;  // the keys of a chunk: N <= TC_KEYS * KC

constexpr int tf32_chunks(int n) { return (n + TC_KEYS - 1) / TC_KEYS; }

// d += a . b, m16n8k8, TF32 operands as fp32 bit patterns, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The two small products of a 3xTF32 product, d += a_lo . b_hi + a_hi .
// b_lo, a split already, b = {b0, b1} split here. T: the transposed
// product's order, d += a_hi . b_lo + a_lo . b_hi, so that B A^T adds the
// same two products in the same order as A B^T does (the backward's
// second phase recomputes S^T and dP^T so).
template <bool T = false>
__device__ __forceinline__ void mma_small(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh[2], bl[2];
  split_tf32(b0, bh[0], bl[0]);
  split_tf32(b1, bh[1], bl[1]);
  if constexpr (T) {
    mma_tf32(d, ah, bl);
    mma_tf32(d, al, bh);
  } else {
    mma_tf32(d, al, bh);
    mma_tf32(d, ah, bl);
  }
}

// Its large product, d += a_hi . b_hi.
__device__ __forceinline__ void mma_big(float (&d)[4], const uint32_t (&ah)[4], float b0,
                                        float b1) {
  const uint32_t bh[2] = {tf32_rna(b0), tf32_rna(b1)};
  mma_tf32(d, ah, bh);
}

// The A fragment of 16 rows x 8 columns at p (row stride TC_LD): a thread's
// rows g and g + 8, columns t and t + 4, split.
__device__ __forceinline__ void a_fragment(const float* p, uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float a[4] = {p[0], p[8 * TC_LD], p[4], p[8 * TC_LD + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
}

// s[j] = the 16 x 8 tile j of A B^T over the head dim: A's 16 rows at a,
// B's 8 NH rows at b (row stride TC_LD; each pointer at this thread's row
// g and column t). The small products of every slice of 8 first, then the
// large ones: a logit is truncated at its full size 8 times, not 24 (see
// the note). T: the transposed product's order (mma_small).
template <int NH, bool T = false>
__device__ __forceinline__ void head_dim_products(float (&s)[NH][4], const float* a,
                                                  const float* b) {
#pragma unroll
  for (int j = 0; j < NH; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int big = 0; big < 2; ++big)
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      uint32_t ah[4], al[4];
      a_fragment(a + 8 * kk, ah, al);
      const float* br = b + 8 * kk;
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        if (big)
          mma_big(s[j], ah, br[8 * j * TC_LD], br[8 * j * TC_LD + 4]);
        else
          mma_small<T>(s[j], ah, al, br[8 * j * TC_LD], br[8 * j * TC_LD + 4]);
      }
    }
}

// The backward's groups: BW_GROUP warps share a tile of 16 query rows
// (phase 1) or keys (phase 2), each a 1 / BW_GROUP part of the keys or
// queries.
constexpr int BW_GROUP = 4;
constexpr int BW_GROUPS = TC_WARPS / BW_GROUP;
constexpr int BW_STATS = BW_GROUP * 3 * 16;  // a group's exchanges: [warp][max, sum, delta][16 rows]

// The backward's shared memory: the resident pair of operands, each
// group's two 16-row tiles and its warps' 16 x 64 partial sums, the
// per-row statistics (max, 1/sum, delta) and per-token vectors (caps,
// bias, drow0, dcs), the groups' exchanges.
constexpr size_t bwd_tf32_smem_bytes(int n) {
  return sizeof(float) * (2 * static_cast<size_t>(tf32_chunks(n)) * TC_KEYS * TC_LD +
                          BW_GROUPS * (2 + BW_GROUP) * 16 * TC_LD + 7 * MAXN +
                          BW_GROUPS * BW_STATS);
}
static_assert(bwd_tf32_smem_bytes(MAXN) <= 232448,
              "backward: over the H100's 227 KB of shared memory a block");

}  // namespace
}  // namespace trk
