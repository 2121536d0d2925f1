// The attention core of the kernel tool tools/proto_attn.py (its
// pallas_call at :137, in build; the kernel make_kernel), for Hopper
// (sm_90a), in bf16, in the tool's three arrangements. The tool computes
//
//   out = round(x + proj(attn(round(x . Wqkv))))
//
// with no LayerNorm and no biases: per (image, head) p = e / sum(e), e =
// exp(q k^T * scale - the exact row max) in fp32, the probabilities rounded
// before the value product, each head's merged output rounded, and x + proj
// summed in fp32 and rounded once. Here, per (image, head):
//
//   merged[b, :, 64 h ..] = round(round(p) . v)
//
// from the packed qkv [B, N, 3 D] (timm's (3, H, 64) column order). The
// arrangements compute the same function:
//
// - loop: a block per (image, head), one head's logits at a time: a warp
//   holds a 16-row query tile's whole row of logits in registers, takes
//   its softmax there and feeds the rounded probabilities straight into
//   the A fragments of the value product (attn_tile.cuh).
// - avpair: a block per (image, head pair); each pair's value product is a
//   single product [P_h | P_h+1] . blockdiag(V_h, V_h+1) into one 16 x 128
//   accumulator, the zero blocks really multiplied (mma.sync with zero B
//   fragments): the question the tool asks, whether a 128-wide product of
//   two heads beats two 64-wide ones once the zeros are paid for.
// - stacked: a block per (image, 16-row query tile); the logits of all H
//   heads go into one fp32 buffer [H x 16, N] in shared memory, one softmax
//   pass runs over its H x 16 rows (a warp a row), and the value products
//   read the rounded probabilities back from it.
//
// Where it splits into launches, and why. The TPU kernel makes qkv and the
// projection inside its body; here the qkv product and the projection with
// the residual are launches of the bf16 GEMM (ops/_build.py gemm; its
// epilogue adds x in fp32 before the one rounding), around this kernel.
// The stacked arrangement cannot make q, k and v on chip: one image's keys
// and values of all heads take 2 N D x 2 bytes = 303 KB at N = 197, D =
// 384, over a block's 227 KB, and the stacked logits need every head's keys
// for the same query rows. So that the three differ only in their
// arrangement, all three read q, k and v from the qkv GEMM's output (the
// kernel tool attn_joint.cu measures the qkv product made on chip). K and V are staged
// by cp.async (zero rows past N); the query tiles' A fragments are read
// from global memory (L2).
//
// What bounds it. The function (both products, the attention, x in and out)
// at B = 256, N = 197, D = 384: 8 B N D^2 + 4 B N^2 D operations, 7.48e10,
// 0.0756 ms at the bf16 rate, against about 79 MB, 0.024 ms at 3.35 TB/s:
// operations. This launch alone does 4 B N^2 D of them (avpair's zero
// blocks double its value products) from the 58 MB qkv tensor. mma.sync
// reaches part of the tensor cores' rate; a row of logits in registers
// (loop, avpair) holds a warp at up to 255 registers, one block an SM.
#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tile.cuh"

namespace trk {
namespace {

enum ProtoVariant : int { kLoop = 0, kAvpair = 1, kStacked = 2 };

constexpr int kSmemMax = 232448;  // the H100's 227 KB a block

// fp32 row stride of the stacked logits: 16-byte aligned rows that start
// in different banks, whose first half holds the row's bf16 probabilities
__host__ __device__ constexpr int stacked_ld(int kp) { return kp + 4; }

constexpr int proto_smem(int kt, int H, int variant) {
  return variant == kLoop     ? 2 * (2 * 64 * kt * ALD)
         : variant == kAvpair ? 2 * (4 * 64 * kt * ALD)
                              : 4 * (16 * H * stacked_ld(64 * kt)) + 2 * (2 * 64 * kt * ALD);
}

using Bf = __nv_bfloat16;

template <int KT>
__global__ void __launch_bounds__(ATHREADS, 1)
    proto_loop_kernel(const Bf* __restrict__ qkv, int N, int H, float scale,
                      Bf* __restrict__ merged) {
  constexpr int KP = 64 * KT, NT = KP / 8;
  extern __shared__ __align__(16) Bf lsmem[];
  Bf* s_k = lsmem;
  Bf* s_v = s_k + KP * ALD;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int D = AHD * H, stride = 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_head(s_k, qkv, b, N, stride, D + AHD * h, KP);
  stage_head(s_v, qkv, b, N, stride, 2 * D + AHD * h, KP);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int tiles = (N + 15) / 16;
  for (int qt = warp; qt < tiles; qt += AWARPS) {
    uint32_t qa[4][4];
    load_a_rows(qa, qkv, b, N, stride, AHD * h, 16 * qt, lane);
    float s[NT][4];
    tile_logits<NT>(s, qa, s_k, lane);
    float mx[2], sum[2];
    tile_softmax<NT>(s, N, scale, lane & 3, mx, sum);
    float o[8][4];
    zero(o);
    tile_pv<NT>(o, s, s_v, lane);
    store_rows(merged, o, b, N, D, AHD * h, 16 * qt, lane);
  }
}

template <int KT>
__global__ void __launch_bounds__(ATHREADS, 1)
    proto_avpair_kernel(const Bf* __restrict__ qkv, int N, int H, float scale,
                        Bf* __restrict__ merged) {
  constexpr int KP = 64 * KT, NT = KP / 8;
  extern __shared__ __align__(16) Bf asmem[];
  Bf* s_k[2] = {asmem, asmem + KP * ALD};
  Bf* s_v[2] = {asmem + 2 * KP * ALD, asmem + 3 * KP * ALD};
  const int pairs = H / 2;
  const int b = blockIdx.x / pairs, h0 = 2 * (blockIdx.x % pairs);
  const int D = AHD * H, stride = 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    stage_head(s_k[hh], qkv, b, N, stride, D + AHD * (h0 + hh), KP);
    stage_head(s_v[hh], qkv, b, N, stride, 2 * D + AHD * (h0 + hh), KP);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int tiles = (N + 15) / 16;
  for (int qt = warp; qt < tiles; qt += AWARPS) {
    float o[16][4];  // [O_h | O_h+1], 16 x 128
    zero(o);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint32_t qa[4][4];
      load_a_rows(qa, qkv, b, N, stride, AHD * (h0 + hh), 16 * qt, lane);
      float s[NT][4];
      tile_logits<NT>(s, qa, s_k[hh], lane);
      float mx[2], sum[2];
      tile_softmax<NT>(s, N, scale, lane & 3, mx, sum);
      // P_hh's rows of blockdiag(V_h, V_h+1): V_hh in its 64 columns, zeros
      // in the other head's, multiplied all the same
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t pa[4];
        pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          uint32_t bb[4] = {0u, 0u, 0u, 0u};
          if ((np >> 2) == hh) load_b2_trans(bb, s_v[hh], ALD, 16 * (np & 3), 16 * kk, lane);
          mma_bf16(o[2 * np], pa, bb[0], bb[1]);
          mma_bf16(o[2 * np + 1], pa, bb[2], bb[3]);
        }
      }
    }
    store_rows(merged, o, b, N, D, AHD * h0, 16 * qt, lane);
  }
}

template <int KT>
__global__ void __launch_bounds__(ATHREADS, 1)
    proto_stacked_kernel(const Bf* __restrict__ qkv, int N, int H, float scale,
                         Bf* __restrict__ merged) {
  constexpr int KP = 64 * KT, SLD = stacked_ld(KP), PLD = 2 * SLD, CHUNKS = KP / 16;
  extern __shared__ __align__(16) float ssmem[];
  float* S = ssmem;                                 // [H * 16][SLD] stacked logits
  Bf* stage = reinterpret_cast<Bf*>(S + 16 * H * SLD);  // [2][KP][ALD]: two heads' K or V
  const Bf* P = reinterpret_cast<const Bf*>(S);     // row r's probabilities: P + r * PLD
  const int tiles = (N + 15) / 16;
  const int b = blockIdx.x / tiles, qt = blockIdx.x % tiles;
  const int D = AHD * H, stride = 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // the logits of every head, two heads' keys a stage; a warp a (head,
  // 16-key chunk)
  for (int h0 = 0; h0 < H; h0 += 2) {
    const int nh = min(2, H - h0);
    __syncthreads();  // the stage is free
    for (int hh = 0; hh < nh; ++hh)
      stage_head(stage + hh * KP * ALD, qkv, b, N, stride, D + AHD * (h0 + hh), KP);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int u = warp; u < nh * CHUNKS; u += AWARPS) {
      const int hh = u / CHUNKS, pr = u % CHUNKS;
      uint32_t qa[4][4];
      load_a_rows(qa, qkv, b, N, stride, AHD * (h0 + hh), 16 * qt, lane);
      float c[2][4];
      logits_chunk(c, qa, stage + hh * KP * ALD, pr, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * pr + 8 * j + 2 * t + (e & 1);
          const int row = 16 * (h0 + hh) + g + 8 * (e >> 1);
          S[row * SLD + key] = key < N ? __fmul_rn(c[j][e], scale) : -INFINITY;
        }
    }
  }
  __syncthreads();

  // one softmax pass over the H x 16 rows, a warp a row; each row's
  // probabilities, rounded, written over its first half
  for (int r = warp; r < 16 * H; r += AWARPS) {
    float v[KP / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < KP / 32; ++i) {
      v[i] = S[r * SLD + lane + 32 * i];
      mx = fmaxf(mx, v[i]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < KP / 32; ++i) {
      v[i] = expf(__fsub_rn(v[i], mx));
      sum += v[i];
    }
    sum = warp_sum(sum);
    __syncwarp();  // the row is read before it is written over
    Bf* pr = reinterpret_cast<Bf*>(S + r * SLD);
#pragma unroll
    for (int i = 0; i < KP / 32; ++i) pr[lane + 32 * i] = __float2bfloat16_rn(__fdiv_rn(v[i], sum));
  }

  // the value products, two heads' values a stage; a warp a (head, 16
  // columns)
  for (int h0 = 0; h0 < H; h0 += 2) {
    const int nh = min(2, H - h0);
    __syncthreads();  // the probabilities are in; the stage is free
    for (int hh = 0; hh < nh; ++hh)
      stage_head(stage + hh * KP * ALD, qkv, b, N, stride, 2 * D + AHD * (h0 + hh), KP);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int hh = warp >> 2, cg = warp & 3;
    if (hh < nh) {
      float o[2][4];
      zero(o);
#pragma unroll
      for (int kk = 0; kk < CHUNKS; ++kk) {
        uint32_t pa[4], bb[4];
        load_a(pa, P, PLD, 16 * (h0 + hh), 16 * kk, lane);
        load_b2_trans(bb, stage + hh * KP * ALD, ALD, 16 * cg, 16 * kk, lane);
        mma_bf16(o[0], pa, bb[0], bb[1]);
        mma_bf16(o[1], pa, bb[2], bb[3]);
      }
      store_rows(merged, o, b, N, D, AHD * (h0 + hh) + 16 * cg, 16 * qt, lane);
    }
  }
}

using ProtoKernel = void (*)(const Bf*, int, int, float, Bf*);

template <int KT>
int launch_proto(const void* qkv, int B, int N, int H, float scale, int variant, void* merged,
                 cudaStream_t stream) {
  const int smem = proto_smem(KT, H, variant);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const ProtoKernel kernel = variant == kLoop     ? proto_loop_kernel<KT>
                             : variant == kAvpair ? proto_avpair_kernel<KT>
                                                  : proto_stacked_kernel<KT>;
  const int blocks = variant == kLoop     ? B * H
                     : variant == kAvpair ? B * (H / 2)
                                          : B * ((N + 15) / 16);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, ATHREADS, smem, stream>>>(static_cast<const Bf*>(qkv), N, H, scale,
                                              static_cast<Bf*>(merged));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace trk

// merged [B, N, 64 H] (bf16) = each (image, head)'s attention over the
// packed qkv [B, N, 3 x 64 H] (bf16; contiguous, 16-byte aligned: the
// caller checks), in arrangement `variant` (0 loop, 1 avpair: H even, 2
// stacked). 1 <= N <= 256. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue where the arrangement's shared memory at N and H
// exceeds a block's).
extern "C" int tr_proto_attn(const void* qkv, int B, int N, int H, float scale, int variant,
                             void* merged, void* stream) {
  using namespace trk;
  if (B == 0) return 0;
  if (N < 1 || N > 256 || H < 1 || variant < kLoop || variant > kStacked ||
      (variant == kAvpair && H % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((N + 63) / 64) {
    case 1: return launch_proto<1>(qkv, B, N, H, scale, variant, merged, s);
    case 2: return launch_proto<2>(qkv, B, N, H, scale, variant, merged, s);
    case 3: return launch_proto<3>(qkv, B, N, H, scale, variant, merged, s);
    default: return launch_proto<4>(qkv, B, N, H, scale, variant, merged, s);
  }
}

// The dynamic shared memory a block of arrangement `variant` takes at N
// keys and H heads.
extern "C" int tr_proto_attn_smem(int N, int H, int variant) {
  return trk::proto_smem((N + 63) / 64, H, variant);
}
