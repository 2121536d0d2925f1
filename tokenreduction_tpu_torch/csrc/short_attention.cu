// Softmax attention for short sequences (N <= 256) at head dim 64. Each of
// q, k, v and the output is a [B, H, N, 64] operand with the head dim
// contiguous and its own batch, head and row strides, so one kernel reads
// the packed qkv projection [B, N, 3D] in timm's (3, H, hd) column order
// and writes merged heads [B, N, D] (the eval blocks), or reads and writes
// q, k, v [B, H, N, hd] views of any layout (the training attention core).
// An optional fp32 per-key bias [B, N] is added after the scale:
// logits = q.k * scale + bias[key] (ToMe's log-size bias). Optional
// by-products, both fp32 [B, H, N]:
//   row0[b, h, :]   = the CLS query row of the probabilities;
//   colsum[b, h, :] = the column mass, sum over queries of the probabilities.
// Its backward: from q, k, v, the output's gradient dO, the fp32
// cotangents of row0 and colsum and the bias, the gradients dq, dk, dv
// (same layouts) and the per-head bias gradient dbias [B, H, N] fp32.
// And head_mean_keys: the head mean of the keys of a packed qkv, [B, N, hd]
// (ToMe's merge metric).
//
// One thread block per (image, head): that head's q, k and v live in
// shared memory and each warp owns query rows. The softmax is fp32 with
// the exact row max. The eval forward rounds the unnormalised
// probabilities to the operand type before the product with V and applies
// the 1/sum scale to the [hd] output (the eval TPU kernels' recipe, also
// the forward of the TPU's training attention core); with norm_p the
// normalised probabilities are rounded instead (the training TPU kernel of
// the whole attention branch, ops/fused_block_train.py). colsum is reduced
// inside the block in a fixed order: no atomics, deterministic.
//
// bf16: the products on the tensor cores (mma.sync m16n8k16, ldmatrix). A
// warp owns 16 query rows and walks the keys in chunks of 64 three times
// (row max, row sum, then probabilities, PV and the by-products), so its
// registers do not grow with N. fp32 (the parity dtype): FMAs on the CUDA
// cores, a lane per key.
//
// The backward recomputes the probabilities with the exact row max (no
// statistics are saved by the forward) and runs in two phases per (image,
// head). Phase 1, a warp per 16 query rows: the row statistics, then
// delta_i = sum_j P_ij dP_ij with dP = dO V^T plus the row0 cotangent on
// query row 0 and the colsum cotangent on every row (so delta carries
// them, which the shortcut rowsum(dO * O) would miss), then
// dS = P (dP - delta) * scale and dQ = dS K. Phase 2, a warp per 16 keys,
// reads the statistics phase 1 left in shared memory and walks the
// queries: dV = P^T dO, dK = dS^T Q, and dbias_j = sum_i P_ij (dP_ij -
// delta_i), the unscaled dS summed over the key's column. Each sum stays
// inside one warp, so there are no atomics. The rounding points are the
// TPU kernels': P before dV, dS, and dq, dk, dv; dS is rounded after the
// scale, which at head dim 64 (scale 2^-3) is the same number as JAX's
// round(dS) K scale.
//
// The bias, the colsum cotangent and dbias are compiled into their own
// variants (EXT), so the kernels without them keep their code.
//
// A first version. At N <= 197 the forward is bound by reading q, k, v and
// by the exponentials, not by tensor-core operations; the backward
// recomputes QK^T four times per query tile; keeping qkv on chip between
// the projection and the attention is later work.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace trk {
namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;
constexpr int MAXN = 256;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

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

// ---------------------------------------------------------------- bf16
constexpr int QLD = HD + 8;  // 144-byte rows: 16-byte aligned, ldmatrix conflict-free
constexpr int CHUNK = 64;    // keys per pass step: 8 mma n-tiles

// Query rows (and V rows) are padded to whole mma tiles of 16, key rows
// to whole chunks of 64; the padding is zero.
__host__ __device__ int q_rows(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ int k_rows(int n) { return (n + CHUNK - 1) / CHUNK * CHUNK; }

size_t mma_smem_bytes(int n) {
  return sizeof(bf16) * static_cast<size_t>(2 * q_rows(n) + k_rows(n)) * QLD +
         sizeof(float) * (WARPS + 1) * MAXN;
}

// dst[n][d] = the rows of one (image, head) of src for n < N, zero for
// N <= n < rows, in 16-byte chunks (row strides are multiples of 8).
__device__ __forceinline__ void load_rows(bf16* dst, const Heads<const bf16>& src, int b, int h,
                                          int N, int rows) {
  for (int c = threadIdx.x; c < rows * (HD / 8); c += THREADS) {
    const int n = c / (HD / 8), d = (c % (HD / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (n < N) v = *reinterpret_cast<const uint4*>(src.row(b, h, n) + d);
    *reinterpret_cast<uint4*>(dst + n * QLD + d) = v;
  }
}

// dst[j] = the fp32 row src[j] for j < N (null: zero), zero up to MAXN.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int N) {
  for (int j = threadIdx.x; j < MAXN; j += THREADS)
    dst[j] = src != nullptr && j < N ? src[j] : 0.f;
}

// The warp's 16 rows (fragments af over HD) against rows[j0 .. j0+63]:
// s = A . rows^T in mma C layout, s[nt][0..1] row g, s[nt][2..3] row g+8,
// columns j0 + nt*8 + 2t (+1).
__device__ __forceinline__ void rows_product(const uint32_t (*af)[4], const bf16* rows, int j0,
                                             int lane, float (*s)[4]) {
#pragma unroll
  for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
    for (int pr = 0; pr < CHUNK / 16; ++pr) {
      uint32_t r[4];
      ldmatrix_x4(r, rows + (j0 + pr * 16 + (lane & 7) + ((lane >> 4) << 3)) * QLD + ks * 16 +
                         ((lane >> 3) & 1) * 8,
                  false);
      mma_16x8x16(s[2 * pr], af[ks], r[0], r[1]);
      mma_16x8x16(s[2 * pr + 1], af[ks], r[2], r[3]);
    }
}

// Logits of the warp's 16 rows against columns j0..j0+63 (see
// rows_product): the product times scale, plus the column's bias
// sbias[j] with BIAS; columns >= n are -inf.
template <bool BIAS>
__device__ __forceinline__ void qk_chunk(const uint32_t (*qf)[4], const bf16* sK,
                                         const float* sbias, int j0, int n, float scale, int lane,
                                         float (*s)[4]) {
  rows_product(qf, sK, j0, lane, s);
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + nt * 8 + 2 * t + (i & 1);
      float x = s[nt][i] * scale;
      if constexpr (BIAS) x += sbias[j];
      s[nt][i] = j < n ? x : -INFINITY;
    }
}

// acc (16 x HD, C layout) += P . rows[j0 .. j0+63], with P the 16 x 64
// chunk p in C layout, rounded to bf16.
__device__ __forceinline__ void chunk_times_rows(const float (*p)[4], const bf16* rows, int j0,
                                                 int lane, float (*acc)[4]) {
#pragma unroll
  for (int kk = 0; kk < CHUNK / 16; ++kk) {
    const uint32_t pf[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t r[4];
      ldmatrix_x4(r, rows + (j0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * QLD + dp * 16 +
                         (lane >> 4) * 8,
                  true);
      mma_16x8x16(acc[2 * dp], pf, r[0], r[1]);
      mma_16x8x16(acc[2 * dp + 1], pf, r[2], r[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Exact row max and 1/row sum of the warp's 16 rows (rows g and g+8);
// rows >= n get 1/sum = 0, so their probabilities are 0.
template <bool BIAS>
__device__ __forceinline__ void row_stats(const uint32_t (*qf)[4], const bf16* sK,
                                          const float* sbias, int i0, int n, float scale,
                                          int lane, float& m0, float& m1, float& r0, float& r1) {
  const int g = lane >> 2, nq = q_rows(n);
  float s[CHUNK / 8][4];
  m0 = -INFINITY, m1 = -INFINITY;
  for (int j0 = 0; j0 < nq; j0 += CHUNK) {
    qk_chunk<BIAS>(qf, sK, sbias, j0, n, scale, lane, s);
#pragma unroll
    for (int nt = 0; nt < CHUNK / 8; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float l0 = 0.f, l1 = 0.f;
  for (int j0 = 0; j0 < nq; j0 += CHUNK) {
    qk_chunk<BIAS>(qf, sK, sbias, j0, n, scale, lane, s);
#pragma unroll
    for (int nt = 0; nt < CHUNK / 8; ++nt) {
      l0 += expf(s[nt][0] - m0) + expf(s[nt][1] - m0);
      l1 += expf(s[nt][2] - m1) + expf(s[nt][3] - m1);
    }
  }
  l0 = quad_sum(l0);  // every lane shuffles
  l1 = quad_sum(l1);
  r0 = i0 + g < n ? 1.0f / l0 : 0.f;
  r1 = i0 + g + 8 < n ? 1.0f / l1 : 0.f;
}

// NORM_P: round the normalised probabilities before PV (training branch).
// BIAS: add the per-key bias.
template <bool NORM_P, bool BIAS>
__global__ void __launch_bounds__(THREADS)
    short_attention_mma_kernel(Heads<const bf16> q, Heads<const bf16> k, Heads<const bf16> v,
                               Heads<bf16> out, const float* __restrict__ bias,
                               float* __restrict__ row0, float* __restrict__ colsum, int N, int H,
                               float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nq = q_rows(N), nk = k_rows(N);
  bf16* sQ = reinterpret_cast<bf16*>(smem);                // [nq][QLD]
  bf16* sK = sQ + nq * QLD;                                // [nk][QLD]
  bf16* sV = sK + nk * QLD;                                // [nq][QLD]
  float* csbuf = reinterpret_cast<float*>(sV + nq * QLD);  // [WARPS][MAXN]
  float* sbias = csbuf + WARPS * MAXN;                     // [MAXN]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  load_rows(sQ, q, b, h, N, nq);
  load_rows(sK, k, b, h, N, nk);
  load_rows(sV, v, b, h, N, nq);
  if constexpr (BIAS) load_vec(sbias, bias + static_cast<size_t>(b) * N, N);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  if (colsum != nullptr)
    for (int j = lane; j < MAXN; j += 32) csbuf[warp * MAXN + j] = 0.f;
  __syncthreads();

  for (int i0 = warp * 16; i0 < nq; i0 += WARPS * 16) {
    uint32_t qf[HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      ldmatrix_x4(qf[ks], sQ + (i0 + (lane & 15)) * QLD + ks * 16 + (lane >> 4) * 8, false);

    // passes 1 and 2: exact row max and row sum
    float m0, m1, r0, r1;
    row_stats<BIAS>(qf, sK, sbias, i0, N, scale, lane, m0, m1, r0, r1);
    // the 1/sum scale goes on the exponentials before PV (NORM_P) or on
    // the output after it
    const float o0 = NORM_P ? 1.f : r0, o1 = NORM_P ? 1.f : r1;
    // pass 3: probabilities, PV, row0 and colsum
    float s[CHUNK / 8][4];
    float o[HD / 8][4] = {};
    for (int j0 = 0; j0 < nq; j0 += CHUNK) {
      qk_chunk<BIAS>(qf, sK, sbias, j0, N, scale, lane, s);
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) {
        s[nt][0] = expf(s[nt][0] - m0);
        s[nt][1] = expf(s[nt][1] - m0);
        s[nt][2] = expf(s[nt][2] - m1);
        s[nt][3] = expf(s[nt][3] - m1);
        if constexpr (NORM_P) {
          s[nt][0] *= r0;
          s[nt][1] *= r0;
          s[nt][2] *= r1;
          s[nt][3] *= r1;
        }
      }
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk) {
        const int jb = j0 + kk * 16;
        if (jb >= nq) break;
        const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t r[4];
          ldmatrix_x4(r, sV + (jb + (lane & 7) + ((lane >> 3) & 1) * 8) * QLD + dp * 16 +
                             (lane >> 4) * 8,
                      true);
          mma_16x8x16(o[2 * dp], pf, r[0], r[1]);
          mma_16x8x16(o[2 * dp + 1], pf, r[2], r[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + nt * 8 + 2 * t + e;
          if (row0 != nullptr && i0 == 0 && g == 0 && j < N)
            row0[static_cast<size_t>(bh) * N + j] = s[nt][e] * o0;
          if (colsum != nullptr) {
            float c = s[nt][e] * o0 + s[nt][2 + e] * o1;
            c += __shfl_xor_sync(0xffffffffu, c, 4);
            c += __shfl_xor_sync(0xffffffffu, c, 8);
            c += __shfl_xor_sync(0xffffffffu, c, 16);
            if (g == 0 && j < N) csbuf[warp * MAXN + j] += c;
          }
        }
    }
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const int d = dt * 8 + 2 * t;
      const int ia = i0 + g, ib = i0 + g + 8;
      if (ia < N)
        *reinterpret_cast<__nv_bfloat162*>(out.row(b, h, ia) + d) =
            __floats2bfloat162_rn(o[dt][0] * o0, o[dt][1] * o0);
      if (ib < N)
        *reinterpret_cast<__nv_bfloat162*>(out.row(b, h, ib) + d) =
            __floats2bfloat162_rn(o[dt][2] * o1, o[dt][3] * o1);
    }
  }

  if (colsum != nullptr) {
    __syncthreads();
    for (int j = threadIdx.x; j < N; j += THREADS) {
      float acc = 0.f;
      for (int w = 0; w < WARPS; ++w) acc += csbuf[w * MAXN + j];
      colsum[static_cast<size_t>(bh) * N + j] = acc;
    }
  }
}

size_t bwd_mma_smem_bytes(int n) {
  return sizeof(bf16) * 4 * static_cast<size_t>(k_rows(n)) * QLD + sizeof(float) * 6 * MAXN;
}

// EXT: the per-key bias, the colsum cotangent dcs and the bias gradient
// dbias (each pointer may still be null: zero, or not written).
template <bool EXT>
__global__ void __launch_bounds__(THREADS)
    short_attention_bwd_mma_kernel(Heads<const bf16> q, Heads<const bf16> k, Heads<const bf16> v,
                                   Heads<const bf16> dout, Heads<bf16> dq, Heads<bf16> dk,
                                   Heads<bf16> dv, const float* __restrict__ bias,
                                   const float* __restrict__ drow0,
                                   const float* __restrict__ dcs, float* __restrict__ dbias,
                                   int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nq = q_rows(N), nk = k_rows(N);
  // q, k, v and dO, each [nk][QLD], zero past N: both phases walk whole
  // chunks of 64 over queries or keys
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + nk * QLD;
  bf16* sV = sK + nk * QLD;
  bf16* sO = sV + nk * QLD;
  float* sM = reinterpret_cast<float*>(sO + nk * QLD);  // [MAXN] row max
  float* sR = sM + MAXN;                                // [MAXN] 1/row sum, 0 past N
  float* sD = sR + MAXN;                                // [MAXN] delta
  float* sW = sD + MAXN;                                // [MAXN] row0 cotangent, 0 past N
  float* sB = sW + MAXN;                                // [MAXN] bias, 0 past N (EXT)
  float* sC = sB + MAXN;                                // [MAXN] colsum cotangent (EXT)

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  load_rows(sQ, q, b, h, N, nk);
  load_rows(sK, k, b, h, N, nk);
  load_rows(sV, v, b, h, N, nk);
  load_rows(sO, dout, b, h, N, nk);
  for (int j = threadIdx.x; j < MAXN; j += THREADS) sM[j] = 0.f, sR[j] = 0.f, sD[j] = 0.f;
  load_vec(sW, drow0 == nullptr ? nullptr : drow0 + static_cast<size_t>(bh) * N, N);
  if constexpr (EXT) {
    load_vec(sB, bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * N, N);
    load_vec(sC, dcs == nullptr ? nullptr : dcs + static_cast<size_t>(bh) * N, N);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto store_rows = [&](const float (*acc)[4], const Heads<bf16>& dst, int r0) {
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const int d = dt * 8 + 2 * t;
      if (r0 + g < N)
        *reinterpret_cast<__nv_bfloat162*>(dst.row(b, h, r0 + g) + d) =
            __floats2bfloat162_rn(acc[dt][0], acc[dt][1]);
      if (r0 + g + 8 < N)
        *reinterpret_cast<__nv_bfloat162*>(dst.row(b, h, r0 + g + 8) + d) =
            __floats2bfloat162_rn(acc[dt][2], acc[dt][3]);
    }
  };

  // phase 1: a warp per 16 query rows
  for (int i0 = warp * 16; i0 < nq; i0 += WARPS * 16) {
    uint32_t qf[HD / 16][4], of[HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      ldmatrix_x4(qf[ks], sQ + (i0 + (lane & 15)) * QLD + ks * 16 + (lane >> 4) * 8, false);
      ldmatrix_x4(of[ks], sO + (i0 + (lane & 15)) * QLD + ks * 16 + (lane >> 4) * 8, false);
    }
    float m0, m1, r0, r1;
    row_stats<EXT>(qf, sK, sB, i0, N, scale, lane, m0, m1, r0, r1);
    float s[CHUNK / 8][4], dp[CHUNK / 8][4];
    // P and dP of the chunk at j0: the row0 cotangent added on query row
    // 0, then the colsum cotangent on every row
    auto probs = [&](int j0) {
      qk_chunk<EXT>(qf, sK, sB, j0, N, scale, lane, s);
      rows_product(of, sV, j0, lane, dp);
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) {
        const int j = j0 + nt * 8 + 2 * t;
        s[nt][0] = expf(s[nt][0] - m0) * r0;
        s[nt][1] = expf(s[nt][1] - m0) * r0;
        s[nt][2] = expf(s[nt][2] - m1) * r1;
        s[nt][3] = expf(s[nt][3] - m1) * r1;
        if (i0 == 0 && g == 0) {
          dp[nt][0] += sW[j];
          dp[nt][1] += sW[j + 1];
        }
        if constexpr (EXT) {
          dp[nt][0] += sC[j];
          dp[nt][1] += sC[j + 1];
          dp[nt][2] += sC[j];
          dp[nt][3] += sC[j + 1];
        }
      }
    };
    float d0 = 0.f, d1 = 0.f;
    for (int j0 = 0; j0 < nq; j0 += CHUNK) {
      probs(j0);
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) {
        d0 += s[nt][0] * dp[nt][0] + s[nt][1] * dp[nt][1];
        d1 += s[nt][2] * dp[nt][2] + s[nt][3] * dp[nt][3];
      }
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    if (t == 0) {
      sM[i0 + g] = m0, sR[i0 + g] = r0, sD[i0 + g] = d0;
      sM[i0 + g + 8] = m1, sR[i0 + g + 8] = r1, sD[i0 + g + 8] = d1;
    }
    float acc[HD / 8][4] = {};
    for (int j0 = 0; j0 < nq; j0 += CHUNK) {
      probs(j0);
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) {
        s[nt][0] *= (dp[nt][0] - d0) * scale;
        s[nt][1] *= (dp[nt][1] - d0) * scale;
        s[nt][2] *= (dp[nt][2] - d1) * scale;
        s[nt][3] *= (dp[nt][3] - d1) * scale;
      }
      chunk_times_rows(s, sK, j0, lane, acc);
    }
    store_rows(acc, dq, i0);
  }
  __syncthreads();  // every row's statistics and delta are in shared memory

  // phase 2: a warp per 16 keys, over the queries in chunks of 64
  for (int j0 = warp * 16; j0 < nq; j0 += WARPS * 16) {
    uint32_t kf[HD / 16][4], vf[HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      ldmatrix_x4(kf[ks], sK + (j0 + (lane & 15)) * QLD + ks * 16 + (lane >> 4) * 8, false);
      ldmatrix_x4(vf[ks], sV + (j0 + (lane & 15)) * QLD + ks * 16 + (lane >> 4) * 8, false);
    }
    const bool live0 = j0 + g < N, live1 = j0 + g + 8 < N;
    const float w0 = sW[j0 + g], w1 = sW[j0 + g + 8];
    // the warp's keys' bias and colsum cotangent (zero without EXT)
    const float b0 = EXT ? sB[j0 + g] : 0.f, b1 = EXT ? sB[j0 + g + 8] : 0.f;
    const float c0 = EXT ? sC[j0 + g] : 0.f, c1 = EXT ? sC[j0 + g + 8] : 0.f;
    float s[CHUNK / 8][4], dp[CHUNK / 8][4];
    float dka[HD / 8][4] = {}, dva[HD / 8][4] = {};
    float db0 = 0.f, db1 = 0.f;
    for (int q0 = 0; q0 < nq; q0 += CHUNK) {
      qk_chunk<false>(kf, sQ, nullptr, q0, N, scale, lane, s);  // S^T; queries >= N are -inf
      rows_product(vf, sO, q0, lane, dp);                       // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = q0 + nt * 8 + 2 * t + e;
          const float mi = sM[i], ri = sR[i], di = sD[i];
          float l0 = s[nt][e], l1 = s[nt][2 + e];
          float dp0 = dp[nt][e] + (i == 0 ? w0 : 0.f);
          float dp1 = dp[nt][2 + e] + (i == 0 ? w1 : 0.f);
          if constexpr (EXT) l0 += b0, l1 += b1, dp0 += c0, dp1 += c1;
          const float p0 = live0 ? expf(l0 - mi) * ri : 0.f;
          const float p1 = live1 ? expf(l1 - mi) * ri : 0.f;
          const float u0 = p0 * (dp0 - di), u1 = p1 * (dp1 - di);  // unscaled dS
          if constexpr (EXT) db0 += u0, db1 += u1;
          s[nt][e] = p0;
          s[nt][2 + e] = p1;
          dp[nt][e] = u0 * scale;
          dp[nt][2 + e] = u1 * scale;
        }
      chunk_times_rows(s, sO, q0, lane, dva);   // dV += P^T dO
      chunk_times_rows(dp, sQ, q0, lane, dka);  // dK += dS^T Q
    }
    store_rows(dka, dk, j0);
    store_rows(dva, dv, j0);
    if constexpr (EXT) {
      db0 = quad_sum(db0);
      db1 = quad_sum(db1);
      if (dbias != nullptr && t == 0) {
        if (live0) dbias[static_cast<size_t>(bh) * N + j0 + g] = db0;
        if (live1) dbias[static_cast<size_t>(bh) * N + j0 + g + 8] = db1;
      }
    }
  }
}

// ---------------------------------------------------------------- fp32
constexpr int KLD = HD + 1;  // odd word stride: lanes reading different keys hit different banks
constexpr int KEYS_PER_LANE = MAXN / 32;

size_t fma_smem_bytes(int n) {
  return sizeof(float) * (WARPS * HD + 2 * WARPS * MAXN + static_cast<size_t>(n) * (HD + KLD));
}

__global__ void __launch_bounds__(THREADS)
    short_attention_fma_kernel(Heads<const float> q, Heads<const float> k, Heads<const float> v,
                               Heads<float> out, const float* __restrict__ bias,
                               float* __restrict__ row0, float* __restrict__ colsum, int N,
                               int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qbuf = reinterpret_cast<float*>(smem);  // [WARPS][HD]
  float* pbuf = qbuf + WARPS * HD;               // [WARPS][MAXN]
  float* csbuf = pbuf + WARPS * MAXN;            // [WARPS][MAXN]
  float* Vs = csbuf + WARPS * MAXN;              // [N][HD]
  float* Ks = Vs + N * HD;                       // [N][KLD]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * N;
  for (int e = threadIdx.x; e < N * HD; e += THREADS) {
    const int n = e / HD, d = e % HD;
    Ks[n * KLD + d] = k.row(b, h, n)[d];
    Vs[n * HD + d] = v.row(b, h, n)[d];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qv = qbuf + warp * HD;
  float* p = pbuf + warp * MAXN;
  float cs[KEYS_PER_LANE];
#pragma unroll
  for (int t = 0; t < KEYS_PER_LANE; ++t) cs[t] = 0.f;

  for (int i = warp; i < N; i += WARPS) {
    const float* qrow = q.row(b, h, i);
    qv[lane] = qrow[lane];
    qv[lane + 32] = qrow[lane + 32];
    __syncwarp();

    float s[KEYS_PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      const int j = lane + 32 * t;
      float acc = -INFINITY;
      if (j < N) {
        acc = 0.f;
        const float* kr = Ks + j * KLD;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) acc = fmaf(qv[d], kr[d], acc);
        acc *= scale;
        if (brow != nullptr) acc += brow[j];
      }
      s[t] = acc;
      mx = fmaxf(mx, acc);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      const int j = lane + 32 * t;
      s[t] = j < N ? expf(s[t] - mx) : 0.f;
      sum += s[t];
    }
    const float rinv = 1.0f / warp_sum(sum);
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      const int j = lane + 32 * t;
      if (j < N) {
        p[j] = s[t];
        const float pr = s[t] * rinv;
        cs[t] += pr;
        if (row0 != nullptr && i == 0) row0[static_cast<size_t>(bh) * N + j] = pr;
      }
    }
    __syncwarp();

    float o0 = 0.f, o1 = 0.f;
    const float2* v2 = reinterpret_cast<const float2*>(Vs);
    for (int j = 0; j < N; ++j) {
      const float2 vv = v2[j * (HD / 2) + lane];
      o0 = fmaf(p[j], vv.x, o0);
      o1 = fmaf(p[j], vv.y, o1);
    }
    float* orow = out.row(b, h, i);
    orow[2 * lane] = o0 * rinv;
    orow[2 * lane + 1] = o1 * rinv;
    __syncwarp();
  }

  if (colsum != nullptr) {
    float* c = csbuf + warp * MAXN;
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      const int j = lane + 32 * t;
      if (j < N) c[j] = cs[t];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < N; j += THREADS) {
      float acc = 0.f;
      for (int w = 0; w < WARPS; ++w) acc += csbuf[w * MAXN + j];
      colsum[static_cast<size_t>(bh) * N + j] = acc;
    }
  }
}

size_t bwd_fma_smem_bytes(int n) {
  return sizeof(float) *
         (2 * static_cast<size_t>(n) * KLD + 2 * WARPS * HD + 2 * WARPS * MAXN + 4 * MAXN);
}

// fp32 backward on the CUDA cores, the same two phases as the bf16 kernel
// with a warp per query row (phase 1) and per key (phase 2); shared memory
// holds K and V in phase 1, then Q and dO in phase 2. bias, dcs and dbias
// may be null.
__global__ void __launch_bounds__(THREADS)
    short_attention_bwd_fma_kernel(Heads<const float> q, Heads<const float> k,
                                   Heads<const float> v, Heads<const float> dout, Heads<float> dq,
                                   Heads<float> dk, Heads<float> dv,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ drow0,
                                   const float* __restrict__ dcs, float* __restrict__ dbias,
                                   int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sA = reinterpret_cast<float*>(smem);  // [N][KLD]: K, then Q
  float* sB = sA + N * KLD;                    // [N][KLD]: V, then dO
  float* vec = sB + N * KLD;                   // [WARPS][2][HD]: the warp's own two rows
  float* pb = vec + 2 * WARPS * HD;            // [WARPS][MAXN] probabilities
  float* db = pb + WARPS * MAXN;               // [WARPS][MAXN] dS
  float* sM = db + WARPS * MAXN;               // [MAXN] row max
  float* sR = sM + MAXN;                       // [MAXN] 1/row sum
  float* sD = sR + MAXN;                       // [MAXN] delta
  float* sW = sD + MAXN;                       // [MAXN] row0 cotangent

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * N;
  const float* crow = dcs == nullptr ? nullptr : dcs + static_cast<size_t>(bh) * N;
  auto fill = [&](const Heads<const float>& a, const Heads<const float>& c) {
    for (int e = threadIdx.x; e < N * HD; e += THREADS) {
      const int n = e / HD, d = e % HD;
      sA[n * KLD + d] = a.row(b, h, n)[d];
      sB[n * KLD + d] = c.row(b, h, n)[d];
    }
  };
  fill(k, v);
  for (int j = threadIdx.x; j < MAXN; j += THREADS)
    sW[j] = drow0 != nullptr && j < N ? drow0[static_cast<size_t>(bh) * N + j] : 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* u = vec + warp * 2 * HD;  // q (phase 1) or k (phase 2)
  float* w = u + HD;               // dO (phase 1) or v (phase 2)
  float* p = pb + warp * MAXN;
  float* ds = db + warp * MAXN;
  auto dot = [&](const float* a, const float* row) {
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) acc = fmaf(a[d], row[d], acc);
    return acc;
  };

  // phase 1: a warp per query row i
  for (int i = warp; i < N; i += WARPS) {
    const float* qrow = q.row(b, h, i);
    const float* orow = dout.row(b, h, i);
    u[lane] = qrow[lane], u[lane + 32] = qrow[lane + 32];
    w[lane] = orow[lane], w[lane + 32] = orow[lane + 32];
    __syncwarp();
    float s[KEYS_PER_LANE], dp[KEYS_PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY, dp[t] = 0.f;
      if (j < N) {
        s[t] = dot(u, sA + j * KLD) * scale;
        if (brow != nullptr) s[t] += brow[j];
        dp[t] = dot(w, sB + j * KLD) + (i == 0 ? sW[j] : 0.f);
        if (crow != nullptr) dp[t] += crow[j];
      }
      mx = fmaxf(mx, s[t]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      s[t] = lane + 32 * t < N ? expf(s[t] - mx) : 0.f;
      sum += s[t];
    }
    const float rinv = 1.0f / warp_sum(sum);
    float dl = 0.f;
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      s[t] *= rinv;
      dl += s[t] * dp[t];
    }
    dl = warp_sum(dl);
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      const int j = lane + 32 * t;
      if (j < N) ds[j] = s[t] * (dp[t] - dl) * scale;
    }
    if (lane == 0) sM[i] = mx, sR[i] = rinv, sD[i] = dl;
    __syncwarp();
    float q0 = 0.f, q1 = 0.f;
    for (int j = 0; j < N; ++j) {
      q0 = fmaf(ds[j], sA[j * KLD + lane], q0);
      q1 = fmaf(ds[j], sA[j * KLD + lane + 32], q1);
    }
    float* dqrow = dq.row(b, h, i);
    dqrow[lane] = q0, dqrow[lane + 32] = q1;
    __syncwarp();
  }
  __syncthreads();
  fill(q, dout);
  __syncthreads();

  // phase 2: a warp per key j
  for (int j = warp; j < N; j += WARPS) {
    const float* krow = k.row(b, h, j);
    const float* vrow = v.row(b, h, j);
    u[lane] = krow[lane], u[lane + 32] = krow[lane + 32];
    w[lane] = vrow[lane], w[lane + 32] = vrow[lane + 32];
    const float bj = brow != nullptr ? brow[j] : 0.f;
    const float cj = crow != nullptr ? crow[j] : 0.f;
    __syncwarp();
    float dsum = 0.f;
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      const int i = lane + 32 * t;
      if (i >= N) continue;
      float l = dot(u, sA + i * KLD) * scale;
      if (brow != nullptr) l += bj;
      float dpv = dot(w, sB + i * KLD) + (i == 0 ? sW[j] : 0.f);
      if (crow != nullptr) dpv += cj;
      const float pr = expf(l - sM[i]) * sR[i];
      const float du = pr * (dpv - sD[i]);  // unscaled dS
      p[i] = pr;
      ds[i] = du * scale;
      dsum += du;
    }
    __syncwarp();
    float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
    for (int i = 0; i < N; ++i) {
      v0 = fmaf(p[i], sB[i * KLD + lane], v0);
      v1 = fmaf(p[i], sB[i * KLD + lane + 32], v1);
      k0 = fmaf(ds[i], sA[i * KLD + lane], k0);
      k1 = fmaf(ds[i], sA[i * KLD + lane + 32], k1);
    }
    float* dkrow = dk.row(b, h, j);
    float* dvrow = dv.row(b, h, j);
    dkrow[lane] = k0, dkrow[lane + 32] = k1;
    dvrow[lane] = v0, dvrow[lane + 32] = v1;
    dsum = warp_sum(dsum);
    if (dbias != nullptr && lane == 0) dbias[static_cast<size_t>(bh) * N + j] = dsum;
    __syncwarp();
  }
}

// ---------------------------------------------------------------- keys
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// keys[m, d] = (sum over heads h, in order, of the fp32 key k[m, h, d]) / H,
// rounded to T, off a packed qkv [M, 3 * H * hd]: a thread per element.
template <typename T>
__global__ void head_mean_keys_kernel(const T* __restrict__ qkv, T* __restrict__ keys, int M,
                                      int H, int hd) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long long>(M) * hd) return;
  const int m = static_cast<int>(e / hd), d = static_cast<int>(e % hd);
  const int D = H * hd;
  const T* kr = qkv + static_cast<size_t>(m) * 3 * D + D + d;
  float acc = to_f32(kr[0]);
  for (int h = 1; h < H; ++h) acc += to_f32(kr[h * hd]);
  store_f32(keys + e, acc / static_cast<float>(H));
}

// Heads of the operands from strides[3 * i .. 3 * i + 2] (batch, head, row).
template <typename T, typename P>
Heads<T> heads(P ptr, const long long* strides, int i) {
  return Heads<T>{static_cast<T*>(ptr), strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

}  // namespace
}  // namespace trk

// Returns the cudaError_t of the launch (0 on success). q, k, v and out
// are [B, H, N, 64] operands with the head dim contiguous; strides holds
// the (batch, head, row) strides of q, k, v and out, in elements. bias
// (fp32 [B, N]), row0 and colsum may be null; norm_p rounds the normalised
// probabilities before PV (bf16; in fp32 the rounding is a no-op). The
// caller checks shapes, dtypes and strides (bf16: multiples of 8, 16-byte
// aligned).
extern "C" int tr_short_attention(int dtype, const void* q, const void* k, const void* v,
                                  void* out, const long long* strides, const void* bias,
                                  void* row0, void* colsum, int B, int N, int H, float scale,
                                  int norm_p, void* stream) {
  using namespace trk;
  if (N < 1 || N > MAXN) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  float* r0 = static_cast<float*>(row0);
  float* cs = static_cast<float*>(colsum);
  cudaError_t err;
  if (dtype == kBFloat16) {
    if (norm_p && bias != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = norm_p ? short_attention_mma_kernel<true, false>
                         : (bias != nullptr ? short_attention_mma_kernel<false, true>
                                            : short_attention_mma_kernel<false, false>);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(mma_smem_bytes(MAXN)));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<B * H, THREADS, mma_smem_bytes(N), s>>>(
        heads<const bf16>(q, strides, 0), heads<const bf16>(k, strides, 1),
        heads<const bf16>(v, strides, 2), heads<bf16>(out, strides, 3), bp, r0, cs, N, H, scale);
  } else if (dtype == kFloat32) {
    err = cudaFuncSetAttribute(short_attention_fma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(fma_smem_bytes(MAXN)));
    if (err != cudaSuccess) return static_cast<int>(err);
    short_attention_fma_kernel<<<B * H, THREADS, fma_smem_bytes(N), s>>>(
        heads<const float>(q, strides, 0), heads<const float>(k, strides, 1),
        heads<const float>(v, strides, 2), heads<float>(out, strides, 3), bp, r0, cs, N, H,
        scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Returns the cudaError_t of the launch (0 on success): dq, dk, dv from q,
// k, v and dout, all [B, H, N, 64] operands in `dtype` with the head dim
// contiguous (strides: the (batch, head, row) strides of q, k, v, dout, dq,
// dk and dv, in elements), the fp32 bias [B, N], the fp32 cotangents drow0
// and dcs [B, H, N], and the fp32 per-head bias gradient dbias [B, H, N];
// each of the last four may be null (zero, or not written). The caller
// checks shapes, dtypes and strides.
extern "C" int tr_short_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                      const void* dout, void* dq, void* dk, void* dv,
                                      const long long* strides, const void* bias,
                                      const void* drow0, const void* dcs, void* dbias, int B,
                                      int N, int H, float scale, void* stream) {
  using namespace trk;
  if (N < 1 || N > MAXN) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  const float* w = static_cast<const float*>(drow0);
  const float* c = static_cast<const float*>(dcs);
  float* db = static_cast<float*>(dbias);
  cudaError_t err;
  if (dtype == kBFloat16) {
    const bool ext = bias != nullptr || dcs != nullptr || dbias != nullptr;
    auto kernel = ext ? short_attention_bwd_mma_kernel<true> : short_attention_bwd_mma_kernel<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bwd_mma_smem_bytes(MAXN)));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<B * H, THREADS, bwd_mma_smem_bytes(N), s>>>(
        heads<const bf16>(q, strides, 0), heads<const bf16>(k, strides, 1),
        heads<const bf16>(v, strides, 2), heads<const bf16>(dout, strides, 3),
        heads<bf16>(dq, strides, 4), heads<bf16>(dk, strides, 5), heads<bf16>(dv, strides, 6), bp,
        w, c, db, N, H, scale);
  } else if (dtype == kFloat32) {
    err = cudaFuncSetAttribute(short_attention_bwd_fma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bwd_fma_smem_bytes(MAXN)));
    if (err != cudaSuccess) return static_cast<int>(err);
    short_attention_bwd_fma_kernel<<<B * H, THREADS, bwd_fma_smem_bytes(N), s>>>(
        heads<const float>(q, strides, 0), heads<const float>(k, strides, 1),
        heads<const float>(v, strides, 2), heads<const float>(dout, strides, 3),
        heads<float>(dq, strides, 4), heads<float>(dk, strides, 5), heads<float>(dv, strides, 6),
        bp, w, c, db, N, H, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Returns the cudaError_t of the launch (0 on success): keys [M, hd], the
// head mean of the keys of the packed qkv [M, 3 * H * hd], both in `dtype`
// and contiguous.
extern "C" int tr_head_mean_keys(int dtype, const void* qkv, void* keys, int M, int H, int hd,
                                 void* stream) {
  using namespace trk;
  if (M == 0) return 0;
  if (H < 1 || hd < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(M) * hd;
  const int blocks = static_cast<int>((n + 255) / 256);
  if (dtype == kBFloat16)
    head_mean_keys_kernel<bf16><<<blocks, 256, 0, s>>>(static_cast<const bf16*>(qkv),
                                                       static_cast<bf16*>(keys), M, H, hd);
  else if (dtype == kFloat32)
    head_mean_keys_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(qkv),
                                                        static_cast<float*>(keys), M, H, hd);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
