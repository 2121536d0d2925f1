// The qkv product fused into the short attention: the counterpart of the
// attention core of the TPU kernel tools/tune_kernels.py attn_joint (its
// pallas_call at :160, _attn_joint_kernel), for Hopper (sm_90a), in bf16.
// One block per (image b, head h):
//
//   q, k, v = round(LN[b] . Wqkv_h^T + bqkv_h)     [N, 64] each, on chip
//   p = softmax(q k^T * scale)                     fp32, the exact row max
//   merged[b, :, 64 h ..] = round(round(p) . v)    [N, 64]
//   row0[b, h] = p[0, :],  colsum[b, h] = sum over the query rows of p
//
// where LN [B * N, D] holds LayerNorm's rounded rows (the layer_norm launch
// before it) and Wqkv_h the 3 x 64 rows of Wqkv [3 D, D] (nn.Linear's
// layout, timm's (3, H, 64) order) that make head h's q, k and v. The out
// projection, its bias and the residual stay a launch of the bf16 GEMM
// (ops/_build.py gemm) after it. Numerics as the TPU kernel's: qkv
// accumulated in fp32 and rounded with its bias added; the logits in fp32,
// scaled after the product; p = e / sum(e), a true division; the
// probabilities rounded before the value product, its fp32 sum rounded.
//
// Design. The qkv product of head h: the block's 8 warps take 16 rows
// each, 128 rows a pass, all 192 columns of the head (96 fp32 accumulators
// a thread), over D in chunks of 64 staged in shared memory by cp.async,
// with the next chunk in flight while this one's products run (stages =
// 2) or not (stages = 1: the kernel's tunable). q, k and v stay in shared
// memory as bf16 ([N rounded up to 64 KT keys][64] each; rows past N are
// zeros). The attention: a warp takes 16 query rows at a time and holds
// the whole row of logits in registers (KT x 64 keys, mma.sync m16n8k16),
// so the row max is exact; the rounded probabilities go from the logits'
// registers straight into the A fragments of the value product. colsum:
// each warp sums its query rows' probabilities into its own row of shared
// memory, and the 8 rows are added in warp order at the end, so two
// launches give the same bits.
//
// What bounds it. At B = 256, N = 197, D = 384 the block computes 2 N D
// 192 + 4 N^2 64 operations from 151 KB of LN rows (read again by each of
// the 6 heads, from L2) and 147 KB of weights; device memory sees the LN
// rows once, the weights and the merged heads: bytes bound its
// function (0.03 ms) below its operations (0.05 ms at the bf16 rate). The
// qkv tensor [B, N, 3 D] that ops/flash_attention.py writes and reads
// back (232 MB) is gone. mma.sync reaches part of the tensor cores' rate;
// each block's products wait on its staged chunks and on one another
// through shared memory, and a block takes up to 198 KB of shared memory,
// so one block an SM runs.
#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace trk {
namespace {

constexpr int JHD = 64;             // head dim
constexpr int JTHREADS = 256;       // 8 warps
constexpr int JWARPS = JTHREADS / 32;
constexpr int JROWS = 16 * JWARPS;  // rows a qkv pass
constexpr int JBK = 64;             // D a staged chunk
constexpr int LDQ = JHD + 8;        // row stride of q, k, v and the staged chunks: 144 bytes
constexpr int STAGE_A = JROWS * LDQ;
constexpr int STAGE_W = 3 * JHD * LDQ;
constexpr int JSTAGE = STAGE_A + STAGE_W;

constexpr int joint_smem(int kt, int stages) {
  return 2 * (3 * 64 * kt * LDQ + stages * JSTAGE);
}
static_assert(joint_smem(4, 2) <= 232448, "over the H100's 227 KB of shared memory a block");
static_assert(4 * JWARPS * 64 * 4 <= 2 * JSTAGE, "colsum rows overflow the staging");

// Chunk kc of pass p: LN rows 128 p .. of image b (zeros past N) and head
// h's 192 rows of Wqkv, columns 64 kc .. + 63.
__device__ __forceinline__ void load_chunk(__nv_bfloat16* stage, const __nv_bfloat16* ln,
                                           const __nv_bfloat16* wqkv, int b, int h, int N, int D,
                                           int p, int kc) {
  __nv_bfloat16* sa = stage;
  __nv_bfloat16* sw = stage + STAGE_A;
  for (int i = threadIdx.x; i < JROWS * 8; i += JTHREADS) {
    const int r = i >> 3, v = i & 7, row = JROWS * p + r;
    const bool in = row < N;
    const __nv_bfloat16* src =
        ln + (static_cast<size_t>(b) * N + (in ? row : 0)) * D + JBK * kc + 8 * v;
    cp_async16(sa + r * LDQ + 8 * v, src, in);
  }
  for (int i = threadIdx.x; i < 3 * JHD * 8; i += JTHREADS) {
    const int r = i >> 3, v = i & 7;
    const int wrow = (r / JHD) * D + h * JHD + (r % JHD);
    cp_async16(sw + r * LDQ + 8 * v, wqkv + static_cast<size_t>(wrow) * D + JBK * kc + 8 * v,
               true);
  }
}

// KT: keys padded to 64 KT (N <= 64 KT).
template <int KT>
__global__ void __launch_bounds__(JTHREADS, 1)
    attn_joint_kernel(const __nv_bfloat16* __restrict__ ln, const __nv_bfloat16* __restrict__ wqkv,
                      const __nv_bfloat16* __restrict__ bqkv, int N, int D, int H, float scale,
                      int stages, __nv_bfloat16* __restrict__ merged, float* __restrict__ row0,
                      float* __restrict__ colsum) {
  constexpr int KP = 64 * KT, NT = KP / 8;
  extern __shared__ __align__(16) __nv_bfloat16 jsmem[];
  __nv_bfloat16* s_q = jsmem;
  __nv_bfloat16* s_k = s_q + KP * LDQ;
  __nv_bfloat16* s_v = s_k + KP * LDQ;
  __nv_bfloat16* s_stage = s_v + KP * LDQ;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (N + 15) / 16;  // 16-row tiles of queries (and of keys)
  const int passes = (tiles + JWARPS - 1) / JWARPS;
  const int kchunks = D / JBK;
  const int steps = passes * kchunks;

  // the padded rows past the last tile: zeros
  for (int i = threadIdx.x; i < (KP - 16 * tiles) * (JHD / 8); i += JTHREADS) {
    const int r = 16 * tiles + i / (JHD / 8), v = i % (JHD / 8);
    const uint4 z = make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(s_q + r * LDQ + 8 * v) = z;
    *reinterpret_cast<uint4*>(s_k + r * LDQ + 8 * v) = z;
    *reinterpret_cast<uint4*>(s_v + r * LDQ + 8 * v) = z;
  }

  // ---- q, k, v of head h
  float acc[24][4];
#pragma unroll
  for (int j = 0; j < 24; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  if (stages == 2) {
    load_chunk(s_stage, ln, wqkv, b, h, N, D, 0, 0);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    const int p = i / kchunks, kc = i % kchunks;
    int buf = 0;
    if (stages == 2) {
      if (i + 1 < steps) {
        load_chunk(s_stage + ((i + 1) & 1) * JSTAGE, ln, wqkv, b, h, N, D, (i + 1) / kchunks,
                   (i + 1) % kchunks);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      buf = i & 1;
    } else {
      load_chunk(s_stage, ln, wqkv, b, h, N, D, p, kc);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk i is in
    const int tile = JWARPS * p + warp;
    if (tile < tiles) {
      const __nv_bfloat16* sa = s_stage + buf * JSTAGE;
      const __nv_bfloat16* sw = sa + STAGE_A;
#pragma unroll
      for (int k = 0; k < JBK; k += 16) {
        uint32_t a[4];
        load_a(a, sa, LDQ, 16 * warp, k, lane);
#pragma unroll
        for (int pr = 0; pr < 12; ++pr) {
          uint32_t bb[4];
          load_b2(bb, sw, LDQ, 16 * pr, k, lane);
          mma_bf16(acc[2 * pr], a, bb[0], bb[1]);
          mma_bf16(acc[2 * pr + 1], a, bb[2], bb[3]);
        }
      }
      if (kc == kchunks - 1) {  // the pass's rows: + bias, rounded; zeros past N
#pragma unroll
        for (int j = 0; j < 24; ++j) {
          const int part = j / 8, col = 8 * (j % 8) + 2 * t;
          __nv_bfloat16* dst = part == 0 ? s_q : part == 1 ? s_k : s_v;
          const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              bqkv + part * D + h * JHD + col));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = 16 * tile + g + 8 * e;
            const bool in = row < N;
            *reinterpret_cast<uint32_t*>(dst + row * LDQ + col) =
                pack_bf16(in ? acc[j][2 * e] + bb.x : 0.f, in ? acc[j][2 * e + 1] + bb.y : 0.f);
            acc[j][2 * e] = acc[j][2 * e + 1] = 0.f;
          }
        }
      }
    }
    __syncthreads();  // the stage may be written again
  }

  // ---- the attention; each warp's colsum row in the staging area
  float* red = reinterpret_cast<float*>(s_stage);
  for (int i = threadIdx.x; i < JWARPS * KP; i += JTHREADS) red[i] = 0.f;
  __syncthreads();
  const size_t bh = static_cast<size_t>(b) * H + h;
  for (int qt = warp; qt < tiles; qt += JWARPS) {
    uint32_t qa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) load_a(qa[kk], s_q, LDQ, 16 * qt, 16 * kk, lane);
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int pr = 0; pr < NT / 2; ++pr)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bb[4];
        load_b2(bb, s_k, LDQ, 16 * pr, 16 * kk, lane);
        mma_bf16(s[2 * pr], qa[kk], bb[0], bb[1]);
        mma_bf16(s[2 * pr + 1], qa[kk], bb[2], bb[3]);
      }
    // scale, keys past N out, the exact row max (rows g and g + 8)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = 8 * j + 2 * t + (c & 1);
        s[j][c] = key < N ? s[j][c] * scale : -INFINITY;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[j][c] = expf(s[j][c] - mx[c >> 1]);
        sum[c >> 1] += s[j][c];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
    const bool in0 = 16 * qt + g < N, in1 = 16 * qt + g + 8 < N;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = __fdiv_rn(s[j][c], sum[c >> 1]);
      const int key = 8 * j + 2 * t;
      if (row0 != nullptr && qt == 0 && g == 0) {
        if (key < N) row0[bh * N + key] = s[j][0];
        if (key + 1 < N) row0[bh * N + key + 1] = s[j][1];
      }
      if (colsum != nullptr) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = (in0 ? s[j][e] : 0.f) + (in1 ? s[j][2 + e] : 0.f);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) red[warp * KP + key + e] += v;
        }
      }
    }
    // the value product from the rounded probabilities
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        load_b2_trans(bb, s_v, LDQ, 16 * np, 16 * kk, lane);
        mma_bf16(o[2 * np], pa, bb[0], bb[1]);
        mma_bf16(o[2 * np + 1], pa, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = h * JHD + 8 * j + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 16 * qt + g + 8 * e;
        if (row < N)
          *reinterpret_cast<uint32_t*>(merged + (static_cast<size_t>(b) * N + row) * D + col) =
              pack_bf16(o[j][2 * e], o[j][2 * e + 1]);
      }
    }
  }
  if (colsum != nullptr) {
    __syncthreads();
    for (int key = threadIdx.x; key < N; key += JTHREADS) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < JWARPS; ++w) v += red[w * KP + key];
      colsum[bh * N + key] = v;
    }
  }
}

template <int KT>
int launch_joint(const void* ln, const void* wqkv, const void* bqkv, int B, int N, int D, int H,
                 float scale, int stages, void* merged, float* row0, float* colsum,
                 cudaStream_t stream) {
  const auto kernel = attn_joint_kernel<KT>;
  const int smem = joint_smem(KT, stages);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         joint_smem(KT, 2));
  if (err != cudaSuccess) return static_cast<int>(err);
  using T = __nv_bfloat16;
  kernel<<<B * H, JTHREADS, smem, stream>>>(
      static_cast<const T*>(ln), static_cast<const T*>(wqkv), static_cast<const T*>(bqkv), N, D,
      H, scale, stages, static_cast<T*>(merged), row0, colsum);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace trk

// merged [B * N, D] (bf16; head h's columns 64 h ..) and, where not null,
// row0 and colsum [B, H, N] fp32 of the attention of each (image, head)
// over q, k, v = LN rows . Wqkv^T + bqkv (see above): ln [B * N, D], wqkv
// [3 D, D], bqkv [3 D], bf16, contiguous and 16-byte aligned (the caller
// checks). D = 64 H, 1 <= N <= 256, stages 1 or 2. Returns the cudaError_t
// of the launch.
extern "C" int tr_attn_joint(const void* ln, const void* wqkv, const void* bqkv, int B, int N,
                             int D, int H, float scale, int stages, void* merged, void* row0,
                             void* colsum, void* stream) {
  using namespace trk;
  if (B == 0) return 0;
  if (N < 1 || N > 256 || D != JHD * H || (stages != 1 && stages != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r0 = static_cast<float*>(row0);
  float* cs = static_cast<float*>(colsum);
  switch ((N + 63) / 64) {
    case 1: return launch_joint<1>(ln, wqkv, bqkv, B, N, D, H, scale, stages, merged, r0, cs, s);
    case 2: return launch_joint<2>(ln, wqkv, bqkv, B, N, D, H, scale, stages, merged, r0, cs, s);
    case 3: return launch_joint<3>(ln, wqkv, bqkv, B, N, D, H, scale, stages, merged, r0, cs, s);
    default: return launch_joint<4>(ln, wqkv, bqkv, B, N, D, H, scale, stages, merged, r0, cs, s);
  }
}

// The dynamic shared memory a block takes at N keys and `stages`.
extern "C" int tr_attn_joint_smem(int N, int stages) {
  return trk::joint_smem((N + 63) / 64, stages);
}
