// Softmax attention for short sequences (N <= 256) at head dim 64, read
// straight off the packed qkv projection [B, N, 3D] in timm's (3, H, hd)
// column order, written as merged heads [B, N, D]. Optional by-products,
// both fp32 [B, H, N]:
//   row0[b, h, :]   = the CLS query row of the probabilities;
//   colsum[b, h, :] = the column mass, sum over queries of the probabilities.
// And its backward: from qkv, the merged heads' gradient dO [B, N, D] and
// the fp32 cotangent of row0, the packed gradient dqkv [B, N, 3D].
//
// One thread block per (image, head): that head's q, k and v live in
// shared memory and each warp owns query rows. The softmax is fp32 with
// the exact row max. The eval forward rounds the unnormalised
// probabilities to the operand type before the product with V and applies
// the 1/sum scale to the [hd] output (the eval TPU kernels' recipe); with
// norm_p the normalised probabilities are rounded instead (the training
// TPU kernel's, ops/fused_block_train.py). colsum is reduced inside the
// block in a fixed order: no atomics, deterministic.
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
// query row 0 (so delta_0 carries sum_j drow0_j P_0j, which the shortcut
// rowsum(dO * O) would miss), then dS = P (dP - delta) * scale and
// dQ = dS K. Phase 2, a warp per 16 keys, reads the statistics phase 1
// left in shared memory and walks the queries: dV = P^T dO, dK = dS^T Q.
// Each sum stays inside one warp, so there are no atomics. The rounding
// points are the TPU kernel's: P before dV, dS, and dq, dk, dv.
//
// A first version. At N <= 197 the forward is bound by reading qkv and by
// the exponentials, not by tensor-core operations; the backward recomputes
// QK^T four times per query tile; keeping qkv on chip between the
// projection and the attention is later work.
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

// ---------------------------------------------------------------- bf16
constexpr int QLD = HD + 8;  // 144-byte rows: 16-byte aligned, ldmatrix conflict-free
constexpr int CHUNK = 64;    // keys per pass step: 8 mma n-tiles

// Query rows (and V rows) are padded to whole mma tiles of 16, key rows
// to whole chunks of 64; the padding is zero.
__host__ __device__ int q_rows(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ int k_rows(int n) { return (n + CHUNK - 1) / CHUNK * CHUNK; }

size_t mma_smem_bytes(int n) {
  return sizeof(bf16) * static_cast<size_t>(2 * q_rows(n) + k_rows(n)) * QLD +
         sizeof(float) * WARPS * MAXN;
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

// Scaled logits of the warp's 16 rows against keys j0..j0+63 (see
// rows_product); keys >= n are -inf.
__device__ __forceinline__ void qk_chunk(const uint32_t (*qf)[4], const bf16* sK, int j0, int n,
                                         float scale, int lane, float (*s)[4]) {
  rows_product(qf, sK, j0, lane, s);
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + nt * 8 + 2 * t + (i & 1);
      s[nt][i] = j < n ? s[nt][i] * scale : -INFINITY;
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
__device__ __forceinline__ void row_stats(const uint32_t (*qf)[4], const bf16* sK, int i0, int n,
                                          float scale, int lane, float& m0, float& m1, float& r0,
                                          float& r1) {
  const int g = lane >> 2, nq = q_rows(n);
  float s[CHUNK / 8][4];
  m0 = -INFINITY, m1 = -INFINITY;
  for (int j0 = 0; j0 < nq; j0 += CHUNK) {
    qk_chunk(qf, sK, j0, n, scale, lane, s);
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
    qk_chunk(qf, sK, j0, n, scale, lane, s);
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

// NORM_P: round the normalised probabilities before PV (training).
template <bool NORM_P>
__global__ void __launch_bounds__(THREADS)
    short_attention_mma_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                               float* __restrict__ row0, float* __restrict__ colsum, int N, int H,
                               float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nq = q_rows(N), nk = k_rows(N);
  bf16* sQ = reinterpret_cast<bf16*>(smem);                // [nq][QLD]
  bf16* sK = sQ + nq * QLD;                                // [nk][QLD]
  bf16* sV = sK + nk * QLD;                                // [nq][QLD]
  float* csbuf = reinterpret_cast<float*>(sV + nq * QLD);  // [WARPS][MAXN]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int D = H * HD, D3 = 3 * D;
  const bf16* base = qkv + static_cast<size_t>(b) * N * D3 + h * HD;
  // q, k, v rows in 16-byte chunks; rows >= N are zero
  auto load = [&](bf16* dst, int rows, int col0) {
    for (int c = threadIdx.x; c < rows * (HD / 8); c += THREADS) {
      const int n = c / (HD / 8), d = (c % (HD / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n < N)
        v = *reinterpret_cast<const uint4*>(base + static_cast<size_t>(n) * D3 + col0 + d);
      *reinterpret_cast<uint4*>(dst + n * QLD + d) = v;
    }
  };
  load(sQ, nq, 0);
  load(sK, nk, D);
  load(sV, nq, 2 * D);
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
    row_stats(qf, sK, i0, N, scale, lane, m0, m1, r0, r1);
    // the 1/sum scale goes on the exponentials before PV (NORM_P) or on
    // the output after it
    const float o0 = NORM_P ? 1.f : r0, o1 = NORM_P ? 1.f : r1;
    // pass 3: probabilities, PV, row0 and colsum
    float s[CHUNK / 8][4];
    float o[HD / 8][4] = {};
    for (int j0 = 0; j0 < nq; j0 += CHUNK) {
      qk_chunk(qf, sK, j0, N, scale, lane, s);
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
      const int d = h * HD + dt * 8 + 2 * t;
      const int ia = i0 + g, ib = i0 + g + 8;
      if (ia < N)
        *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<size_t>(b) * N + ia) * D + d) =
            __floats2bfloat162_rn(o[dt][0] * o0, o[dt][1] * o0);
      if (ib < N)
        *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<size_t>(b) * N + ib) * D + d) =
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
  return sizeof(bf16) * 4 * static_cast<size_t>(k_rows(n)) * QLD + sizeof(float) * 4 * MAXN;
}

__global__ void __launch_bounds__(THREADS)
    short_attention_bwd_mma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                                   const float* __restrict__ drow0, bf16* __restrict__ dqkv,
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

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int D = H * HD, D3 = 3 * D;
  const bf16* base = qkv + static_cast<size_t>(b) * N * D3 + h * HD;
  bf16* dbase = dqkv + static_cast<size_t>(b) * N * D3 + h * HD;
  auto load = [&](bf16* dst, const bf16* src, int ld) {
    for (int c = threadIdx.x; c < nk * (HD / 8); c += THREADS) {
      const int n = c / (HD / 8), d = (c % (HD / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (n < N) v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(n) * ld + d);
      *reinterpret_cast<uint4*>(dst + n * QLD + d) = v;
    }
  };
  load(sQ, base, D3);
  load(sK, base + D, D3);
  load(sV, base + 2 * D, D3);
  load(sO, dout + static_cast<size_t>(b) * N * D + h * HD, D);
  for (int j = threadIdx.x; j < MAXN; j += THREADS) {
    sM[j] = 0.f;
    sR[j] = 0.f;
    sD[j] = 0.f;
    sW[j] = drow0 != nullptr && j < N ? drow0[static_cast<size_t>(bh) * N + j] : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto store_rows = [&](const float (*acc)[4], int r0, int col0) {
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const int d = col0 + dt * 8 + 2 * t;
      if (r0 + g < N)
        *reinterpret_cast<__nv_bfloat162*>(dbase + static_cast<size_t>(r0 + g) * D3 + d) =
            __floats2bfloat162_rn(acc[dt][0], acc[dt][1]);
      if (r0 + g + 8 < N)
        *reinterpret_cast<__nv_bfloat162*>(dbase + static_cast<size_t>(r0 + g + 8) * D3 + d) =
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
    row_stats(qf, sK, i0, N, scale, lane, m0, m1, r0, r1);
    float s[CHUNK / 8][4], dp[CHUNK / 8][4];
    // P and dP of the chunk at j0, the row0 cotangent added on query row 0
    auto probs = [&](int j0) {
      qk_chunk(qf, sK, j0, N, scale, lane, s);
      rows_product(of, sV, j0, lane, dp);
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) {
        s[nt][0] = expf(s[nt][0] - m0) * r0;
        s[nt][1] = expf(s[nt][1] - m0) * r0;
        s[nt][2] = expf(s[nt][2] - m1) * r1;
        s[nt][3] = expf(s[nt][3] - m1) * r1;
        if (i0 == 0 && g == 0) {
          dp[nt][0] += sW[j0 + nt * 8 + 2 * t];
          dp[nt][1] += sW[j0 + nt * 8 + 2 * t + 1];
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
    float dq[HD / 8][4] = {};
    for (int j0 = 0; j0 < nq; j0 += CHUNK) {
      probs(j0);
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) {
        s[nt][0] *= (dp[nt][0] - d0) * scale;
        s[nt][1] *= (dp[nt][1] - d0) * scale;
        s[nt][2] *= (dp[nt][2] - d1) * scale;
        s[nt][3] *= (dp[nt][3] - d1) * scale;
      }
      chunk_times_rows(s, sK, j0, lane, dq);
    }
    store_rows(dq, i0, 0);
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
    float s[CHUNK / 8][4], dp[CHUNK / 8][4];
    float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
    for (int c0 = 0; c0 < nq; c0 += CHUNK) {
      qk_chunk(kf, sQ, c0, N, scale, lane, s);  // S^T; queries >= N are -inf
      rows_product(vf, sO, c0, lane, dp);       // dP^T = V dO^T
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = c0 + nt * 8 + 2 * t + e;
          const float mi = sM[i], ri = sR[i], di = sD[i];
          const float p0 = live0 ? expf(s[nt][e] - mi) * ri : 0.f;
          const float p1 = live1 ? expf(s[nt][2 + e] - mi) * ri : 0.f;
          const float dp0 = dp[nt][e] + (i == 0 ? w0 : 0.f);
          const float dp1 = dp[nt][2 + e] + (i == 0 ? w1 : 0.f);
          s[nt][e] = p0;
          s[nt][2 + e] = p1;
          dp[nt][e] = p0 * (dp0 - di) * scale;
          dp[nt][2 + e] = p1 * (dp1 - di) * scale;
        }
      chunk_times_rows(s, sO, c0, lane, dv);   // dV += P^T dO
      chunk_times_rows(dp, sQ, c0, lane, dk);  // dK += dS^T Q
    }
    store_rows(dk, j0, D);
    store_rows(dv, j0, 2 * D);
  }
}

// ---------------------------------------------------------------- fp32
constexpr int KLD = HD + 1;  // odd word stride: lanes reading different keys hit different banks
constexpr int KEYS_PER_LANE = MAXN / 32;

size_t fma_smem_bytes(int n) {
  return sizeof(float) * (WARPS * HD + 2 * WARPS * MAXN + static_cast<size_t>(n) * (HD + KLD));
}

__global__ void __launch_bounds__(THREADS)
    short_attention_fma_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                               float* __restrict__ row0, float* __restrict__ colsum, int N,
                               int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qbuf = reinterpret_cast<float*>(smem);  // [WARPS][HD]
  float* pbuf = qbuf + WARPS * HD;               // [WARPS][MAXN]
  float* csbuf = pbuf + WARPS * MAXN;            // [WARPS][MAXN]
  float* Vs = csbuf + WARPS * MAXN;              // [N][HD]
  float* Ks = Vs + N * HD;                       // [N][KLD]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int D = H * HD, D3 = 3 * D;
  const float* base = qkv + static_cast<size_t>(b) * N * D3 + h * HD;
  for (int e = threadIdx.x; e < N * HD; e += THREADS) {
    const int n = e / HD, d = e % HD;
    const float* p = base + static_cast<size_t>(n) * D3 + d;
    Ks[n * KLD + d] = p[D];
    Vs[n * HD + d] = p[2 * D];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q = qbuf + warp * HD;
  float* p = pbuf + warp * MAXN;
  float cs[KEYS_PER_LANE];
#pragma unroll
  for (int t = 0; t < KEYS_PER_LANE; ++t) cs[t] = 0.f;

  for (int i = warp; i < N; i += WARPS) {
    const float* qrow = base + static_cast<size_t>(i) * D3;
    q[lane] = qrow[lane];
    q[lane + 32] = qrow[lane + 32];
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
        for (int d = 0; d < HD; ++d) acc = fmaf(q[d], kr[d], acc);
        acc *= scale;
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
    float* orow = out + (static_cast<size_t>(b) * N + i) * D + h * HD;
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
// holds K and V in phase 1, then Q and dO in phase 2.
__global__ void __launch_bounds__(THREADS)
    short_attention_bwd_fma_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                                   const float* __restrict__ drow0, float* __restrict__ dqkv,
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
  const int D = H * HD, D3 = 3 * D;
  const float* base = qkv + static_cast<size_t>(b) * N * D3 + h * HD;
  const float* obase = dout + static_cast<size_t>(b) * N * D + h * HD;
  float* dbase = dqkv + static_cast<size_t>(b) * N * D3 + h * HD;
  auto fill = [&](const float* a, int lda, const float* c, int ldc) {
    for (int e = threadIdx.x; e < N * HD; e += THREADS) {
      const int n = e / HD, d = e % HD;
      sA[n * KLD + d] = a[static_cast<size_t>(n) * lda + d];
      sB[n * KLD + d] = c[static_cast<size_t>(n) * ldc + d];
    }
  };
  fill(base + D, D3, base + 2 * D, D3);
  for (int j = threadIdx.x; j < MAXN; j += THREADS)
    sW[j] = drow0 != nullptr && j < N ? drow0[static_cast<size_t>(bh) * N + j] : 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* u = vec + warp * 2 * HD;  // q (phase 1) or k (phase 2)
  float* v = u + HD;               // dO (phase 1) or v (phase 2)
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
    const float* qrow = base + static_cast<size_t>(i) * D3;
    const float* orow = obase + static_cast<size_t>(i) * D;
    u[lane] = qrow[lane], u[lane + 32] = qrow[lane + 32];
    v[lane] = orow[lane], v[lane + 32] = orow[lane + 32];
    __syncwarp();
    float s[KEYS_PER_LANE], dp[KEYS_PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      const int j = lane + 32 * t;
      s[t] = j < N ? dot(u, sA + j * KLD) * scale : -INFINITY;
      dp[t] = j < N ? dot(v, sB + j * KLD) + (i == 0 ? sW[j] : 0.f) : 0.f;
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
    dbase[static_cast<size_t>(i) * D3 + lane] = q0;
    dbase[static_cast<size_t>(i) * D3 + lane + 32] = q1;
    __syncwarp();
  }
  __syncthreads();
  fill(base, D3, obase, D);
  __syncthreads();

  // phase 2: a warp per key j
  for (int j = warp; j < N; j += WARPS) {
    const float* row = base + static_cast<size_t>(j) * D3;
    u[lane] = row[D + lane], u[lane + 32] = row[D + lane + 32];
    v[lane] = row[2 * D + lane], v[lane + 32] = row[2 * D + lane + 32];
    __syncwarp();
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      const int i = lane + 32 * t;
      if (i >= N) continue;
      const float pr = expf(dot(u, sA + i * KLD) * scale - sM[i]) * sR[i];
      const float dpv = dot(v, sB + i * KLD) + (i == 0 ? sW[j] : 0.f);
      p[i] = pr;
      ds[i] = pr * (dpv - sD[i]) * scale;
    }
    __syncwarp();
    float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
    for (int i = 0; i < N; ++i) {
      v0 = fmaf(p[i], sB[i * KLD + lane], v0);
      v1 = fmaf(p[i], sB[i * KLD + lane + 32], v1);
      k0 = fmaf(ds[i], sA[i * KLD + lane], k0);
      k1 = fmaf(ds[i], sA[i * KLD + lane + 32], k1);
    }
    float* drow = dbase + static_cast<size_t>(j) * D3;
    drow[D + lane] = k0, drow[D + lane + 32] = k1;
    drow[2 * D + lane] = v0, drow[2 * D + lane + 32] = v1;
    __syncwarp();
  }
}

}  // namespace
}  // namespace trk

// Returns the cudaError_t of the launch (0 on success). row0 and colsum
// may be null; norm_p rounds the normalised probabilities before PV (bf16;
// in fp32 the rounding is a no-op). The caller checks shapes, dtypes and
// contiguity.
extern "C" int tr_short_attention(int dtype, const void* qkv, void* out, void* row0,
                                  void* colsum, int B, int N, int H, float scale, int norm_p,
                                  void* stream) {
  using namespace trk;
  if (N < 1 || N > MAXN) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kBFloat16) {
    auto kernel = norm_p ? short_attention_mma_kernel<true> : short_attention_mma_kernel<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(mma_smem_bytes(MAXN)));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<B * H, THREADS, mma_smem_bytes(N), s>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), static_cast<float*>(row0),
        static_cast<float*>(colsum), N, H, scale);
  } else if (dtype == kFloat32) {
    err = cudaFuncSetAttribute(short_attention_fma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(fma_smem_bytes(MAXN)));
    if (err != cudaSuccess) return static_cast<int>(err);
    short_attention_fma_kernel<<<B * H, THREADS, fma_smem_bytes(N), s>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), static_cast<float*>(row0),
        static_cast<float*>(colsum), N, H, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Returns the cudaError_t of the launch (0 on success): dqkv [B, N, 3D]
// from qkv [B, N, 3D], dout [B, N, D] (both in `dtype`) and the fp32 row0
// cotangent drow0 [B, H, N] (or null for zero). The caller checks shapes,
// dtypes and contiguity.
extern "C" int tr_short_attention_bwd(int dtype, const void* qkv, const void* dout,
                                      const void* drow0, void* dqkv, int B, int N, int H,
                                      float scale, void* stream) {
  using namespace trk;
  if (N < 1 || N > MAXN) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(drow0);
  cudaError_t err;
  if (dtype == kBFloat16) {
    err = cudaFuncSetAttribute(short_attention_bwd_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bwd_mma_smem_bytes(MAXN)));
    if (err != cudaSuccess) return static_cast<int>(err);
    short_attention_bwd_mma_kernel<<<B * H, THREADS, bwd_mma_smem_bytes(N), s>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout), w,
        static_cast<bf16*>(dqkv), N, H, scale);
  } else if (dtype == kFloat32) {
    err = cudaFuncSetAttribute(short_attention_bwd_fma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bwd_fma_smem_bytes(MAXN)));
    if (err != cudaSuccess) return static_cast<int>(err);
    short_attention_bwd_fma_kernel<<<B * H, THREADS, bwd_fma_smem_bytes(N), s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout), w,
        static_cast<float*>(dqkv), N, H, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
