// Softmax attention for short sequences (N <= 256) at head dim 64, read
// straight off the packed qkv projection [B, N, 3D] in timm's (3, H, hd)
// column order, written as merged heads [B, N, D]. Optional by-products,
// both fp32 [B, H, N]:
//   row0[b, h, :]   = the CLS query row of the probabilities;
//   colsum[b, h, :] = the column mass, sum over queries of the probabilities.
//
// One thread block per (image, head): that head's q, k and v live in
// shared memory and each warp owns query rows. The softmax is fp32 with
// the exact row max; the unnormalised probabilities are rounded to the
// operand type before the product with V and the 1/sum scale is applied
// to the [hd] output (the TPU kernel's recipe). colsum is reduced inside
// the block in a fixed order: no atomics, deterministic.
//
// bf16: QK^T and PV on the tensor cores (mma.sync m16n8k16, ldmatrix). A
// warp owns 16 query rows and walks the keys in chunks of 64 three times
// (row max, row sum, then probabilities, PV and the by-products), so its
// registers do not grow with N. fp32 (the parity dtype): FMAs on the CUDA
// cores, a lane per key.
//
// A first version. At N <= 197 the kernel is bound by reading qkv and by
// the exponentials, not by tensor-core operations; keeping qkv on chip
// between the projection and the attention is later work.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace trk {
namespace {

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
  return sizeof(__nv_bfloat16) * static_cast<size_t>(2 * q_rows(n) + k_rows(n)) * QLD +
         sizeof(float) * WARPS * MAXN;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p, bool trans) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void mma_16x8x16(float* d, const uint32_t* a, uint32_t b0,
                                            uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Scaled logits of the warp's 16 query rows against keys j0..j0+63, in
// mma C layout: s[nt][0..1] row g, s[nt][2..3] row g+8, keys
// j0 + nt*8 + 2t (+1); keys >= n are -inf.
__device__ __forceinline__ void qk_chunk(const uint32_t (*qf)[4], const __nv_bfloat16* sK,
                                         int j0, int n, float scale, int lane,
                                         float (*s)[4]) {
#pragma unroll
  for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
    for (int pr = 0; pr < CHUNK / 16; ++pr) {
      uint32_t r[4];
      ldmatrix_x4(r, sK + (j0 + pr * 16 + (lane & 7) + ((lane >> 4) << 3)) * QLD + ks * 16 +
                         ((lane >> 3) & 1) * 8,
                  false);
      mma_16x8x16(s[2 * pr], qf[ks], r[0], r[1]);
      mma_16x8x16(s[2 * pr + 1], qf[ks], r[2], r[3]);
    }
  const int t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < CHUNK / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = j0 + nt * 8 + 2 * t + (i & 1);
      s[nt][i] = j < n ? s[nt][i] * scale : -INFINITY;
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

__global__ void __launch_bounds__(THREADS)
    short_attention_mma_kernel(const __nv_bfloat16* __restrict__ qkv,
                               __nv_bfloat16* __restrict__ out, float* __restrict__ row0,
                               float* __restrict__ colsum, int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nq = q_rows(N), nk = k_rows(N);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [nq][QLD]
  __nv_bfloat16* sK = sQ + nq * QLD;                           // [nk][QLD]
  __nv_bfloat16* sV = sK + nk * QLD;                           // [nq][QLD]
  float* csbuf = reinterpret_cast<float*>(sV + nq * QLD);      // [WARPS][MAXN]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int D = H * HD, D3 = 3 * D;
  const __nv_bfloat16* base = qkv + static_cast<size_t>(b) * N * D3 + h * HD;
  // q, k, v rows in 16-byte chunks; rows >= N are zero
  auto load = [&](__nv_bfloat16* dst, int rows, int col0) {
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

    float s[CHUNK / 8][4];
    // pass 1: exact row max (rows g and g+8)
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int j0 = 0; j0 < nq; j0 += CHUNK) {
      qk_chunk(qf, sK, j0, N, scale, lane, s);
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) {
        m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
        m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    // pass 2: row sums of exp(s - max)
    float l0 = 0.f, l1 = 0.f;
    for (int j0 = 0; j0 < nq; j0 += CHUNK) {
      qk_chunk(qf, sK, j0, N, scale, lane, s);
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) {
        l0 += expf(s[nt][0] - m0) + expf(s[nt][1] - m0);
        l1 += expf(s[nt][2] - m1) + expf(s[nt][3] - m1);
      }
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    // rows >= N: zero weight in the by-products
    const float r0 = i0 + g < N ? 1.0f / l0 : 0.f;
    const float r1 = i0 + g + 8 < N ? 1.0f / l1 : 0.f;
    // pass 3: probabilities, PV, row0 and colsum
    float o[HD / 8][4] = {};
    for (int j0 = 0; j0 < nq; j0 += CHUNK) {
      qk_chunk(qf, sK, j0, N, scale, lane, s);
#pragma unroll
      for (int nt = 0; nt < CHUNK / 8; ++nt) {
        s[nt][0] = expf(s[nt][0] - m0);
        s[nt][1] = expf(s[nt][1] - m0);
        s[nt][2] = expf(s[nt][2] - m1);
        s[nt][3] = expf(s[nt][3] - m1);
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
            row0[static_cast<size_t>(bh) * N + j] = s[nt][e] * r0;
          if (colsum != nullptr) {
            float c = s[nt][e] * r0 + s[nt][2 + e] * r1;
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
            __floats2bfloat162_rn(o[dt][0] * r0, o[dt][1] * r0);
      if (ib < N)
        *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<size_t>(b) * N + ib) * D + d) =
            __floats2bfloat162_rn(o[dt][2] * r1, o[dt][3] * r1);
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

}  // namespace
}  // namespace trk

// Returns the cudaError_t of the launch (0 on success). row0 and colsum
// may be null. The caller checks shapes, dtypes and contiguity.
extern "C" int tr_short_attention(int dtype, const void* qkv, void* out, void* row0,
                                  void* colsum, int B, int N, int H, float scale,
                                  void* stream) {
  using namespace trk;
  if (N < 1 || N > MAXN) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kBFloat16) {
    err = cudaFuncSetAttribute(short_attention_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(mma_smem_bytes(MAXN)));
    if (err != cudaSuccess) return static_cast<int>(err);
    short_attention_mma_kernel<<<B * H, THREADS, mma_smem_bytes(N), s>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(row0), static_cast<float*>(colsum), N, H, scale);
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
