// The attention backward of the kernel tool tools/proto_attn_bwd.py (its
// pallas_call at :190, in build; the kernel make_bwd_kernel), for Hopper
// (sm_90a), in bf16, in the tool's two arrangements. The tool recomputes
// the training attention branch from x alone (LN -> qkv + bias -> p ->
// merged) and takes its backward with a row0 cotangent; this kernel is its
// attention part, per (image b, head h), from the packed qkv [B, N, 3 D]
// and the merged heads' cotangent do [B, N, D] (dy . Wproj, rounded):
//
//   s = q k^T * scale, p = e / sum(e) (fp32, the exact row max)
//   merged = round(round(p) v)
//   dp = do v^T, with drow0[b, h] added to row 0
//   ds = round(p (dp - sum over keys of dp p) * scale)
//   dq = round(ds k), dk = round(ds^T q), dv = round(round(p)^T do)
//
// writing merged [B, N, D] and the packed dqkv [B, N, 3 D]. The products
// that contract over N are the four the tool arranges:
//
// - loop: each at width 64, as the tool's production structure:
//   round(p) v and ds k, then ds^T q and round(p)^T do.
// - pack2: two at width 128, [ds; p] . [k | v] (dq and merged; ds v and
//   p k are multiplied and dropped) and [ds | p]^T . [q | do] (dk and dv;
//   ds^T do and p^T q dropped), as the tool's (:145-157): each B fragment
//   is loaded once and feeds both A operands. It runs at every N <= 256
//   (the TPU's build took only multiples of 8).
//
// Design. A block per (image, head), 8 warps; q, k, v and do of the head
// stay in shared memory ([N rounded up to 64 KT][64] each, zeros past N,
// 147 KB at N > 192). Pass 1, a warp a 16-row query tile: the whole row of
// logits in registers gives the exact row max and sum, and with dp taken
// in 16-key chunks, delta = sum of dp p; the statistics go to shared
// memory. Then chunk by chunk of 16 keys, p is recomputed from the
// statistics and dp again, ds is formed, and the key-contracting products
// (merged, dq) run from the chunk's A fragments. Pass 2, a warp a 16-key
// tile: over the query tiles, s^T = k q^T and dp^T = v do^T recompute p^T
// and ds^T in the A layout of the query-contracting products (dk, dv), so
// no [N, N] matrix reaches memory and no two warps sum into one output.
// Outputs are rounded once from their fp32 sums: two launches give the
// same bits.
//
// Where it splits into launches, and why: the branch's LayerNorm, its qkv
// product, do = dy . Wproj, the two weight gradients (fp32) and dln =
// dqkv . Wqkv and the LayerNorm backward are launches of the port's
// kernels around this one (tools/proto_attn_bwd.py): the TPU kernel keeps
// the weights and its fp32 weight-gradient accumulators in VMEM across a
// sequential grid, which Hopper's blocks, in no order and with 227 KB of
// shared memory, cannot.
//
// What bounds it. The function at B = 256, N = 197, D = 384: the qkv
// recompute, do, six attention products a head, the two weight gradients
// and dln, 2.09e11 operations, 0.2117 ms at the bf16 rate, against about
// 117 MB of bytes (0.035 ms): operations. This kernel's share is the six
// attention products (pack2's dropped quadrants double four of them) plus
// the recomputed s, dp chunks and s^T, dp^T of pass 2, on mma.sync.
#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tile.cuh"

namespace trk {
namespace {

using Bf = __nv_bfloat16;

constexpr int bwd_smem(int kt) { return 2 * (4 * 64 * kt * ALD) + 4 * (3 * 64 * kt); }

__device__ __forceinline__ float ds_of(float p, float dp, float delta, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, delta)), scale);
}

template <int KT, bool PACK2>
__global__ void __launch_bounds__(ATHREADS, 1)
    proto_attn_bwd_kernel(const Bf* __restrict__ qkv, const Bf* __restrict__ dout,
                          const float* __restrict__ drow0, int N, int H, float scale,
                          Bf* __restrict__ merged, Bf* __restrict__ dqkv) {
  constexpr int KP = 64 * KT, NT = KP / 8;
  extern __shared__ __align__(16) Bf bsmem[];
  Bf* s_q = bsmem;
  Bf* s_k = s_q + KP * ALD;
  Bf* s_v = s_k + KP * ALD;
  Bf* s_do = s_v + KP * ALD;
  float* st_max = reinterpret_cast<float*>(s_do + KP * ALD);  // [KP] each
  float* st_sum = st_max + KP;
  float* st_delta = st_sum + KP;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int D = AHD * H, stride = 3 * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  stage_head(s_q, qkv, b, N, stride, AHD * h, KP);
  stage_head(s_k, qkv, b, N, stride, D + AHD * h, KP);
  stage_head(s_v, qkv, b, N, stride, 2 * D + AHD * h, KP);
  stage_head(s_do, dout, b, N, D, AHD * h, KP);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float* dr0 = drow0 + (static_cast<size_t>(b) * H + h) * N;
  const int tiles = (N + 15) / 16;

  // ---- pass 1: a warp a 16-row query tile
  for (int qt = warp; qt < tiles; qt += AWARPS) {
    uint32_t qa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      load_a(qa[kk], s_q, ALD, 16 * qt, 16 * kk, lane);
      load_a(da[kk], s_do, ALD, 16 * qt, 16 * kk, lane);
    }
    // the row statistics and delta = sum of dp p
    float mx[2], sum[2], delta[2] = {0.f, 0.f};
    {
      float s[NT][4];
      tile_logits<NT>(s, qa, s_k, lane);
      tile_softmax<NT>(s, N, scale, t, mx, sum);
#pragma unroll
      for (int pr = 0; pr < NT / 2; ++pr) {
        float dp[2][4];  // do v^T, as the logits are q k^T
        logits_chunk(dp, da, s_v, pr, lane);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 16 * pr + 8 * j + 2 * t + (e & 1);
            if (qt == 0 && g == 0 && e < 2 && key < N) dp[j][e] = __fadd_rn(dp[j][e], dr0[key]);
            delta[e >> 1] += s[2 * pr + j][e] * dp[j][e];
          }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    }
    if (t == 0)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 16 * qt + g + 8 * e;
        st_max[row] = mx[e];
        st_sum[row] = sum[e];
        st_delta[row] = delta[e];
      }
    // merged and dq, 16 keys a chunk: p and dp recomputed, then ds
    float o[8][4], dq[8][4], drop[8][4];
    zero(o);
    zero(dq);
    if (PACK2) zero(drop);
#pragma unroll 1
    for (int pr = 0; pr < NT / 2; ++pr) {
      float c[2][4], dp[2][4];
      logits_chunk(c, qa, s_k, pr, lane);
      logits_chunk(dp, da, s_v, pr, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * pr + 8 * j + 2 * t + (e & 1);
          if (qt == 0 && g == 0 && e < 2 && key < N) dp[j][e] = __fadd_rn(dp[j][e], dr0[key]);
          const float p = key < N ? prob(c[j][e], scale, mx[e >> 1], sum[e >> 1]) : 0.f;
          c[j][e] = p;
          dp[j][e] = ds_of(p, dp[j][e], delta[e >> 1], scale);
        }
      uint32_t ap[4], as[4];
      pack_a(ap, c[0], c[1]);
      pack_a(as, dp[0], dp[1]);
      if (!PACK2) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          load_b2_trans(bb, s_v, ALD, 16 * np, 16 * pr, lane);
          mma_bf16(o[2 * np], ap, bb[0], bb[1]);
          mma_bf16(o[2 * np + 1], ap, bb[2], bb[3]);
          load_b2_trans(bb, s_k, ALD, 16 * np, 16 * pr, lane);
          mma_bf16(dq[2 * np], as, bb[0], bb[1]);
          mma_bf16(dq[2 * np + 1], as, bb[2], bb[3]);
        }
      } else {  // [ds; p] . [k | v]
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          uint32_t bb[4];
          load_b2_trans(bb, np < 4 ? s_k : s_v, ALD, 16 * (np & 3), 16 * pr, lane);
          const int n = 2 * (np & 3);
          if (np < 4) {
            mma_bf16(dq[n], as, bb[0], bb[1]);
            mma_bf16(dq[n + 1], as, bb[2], bb[3]);
            mma_bf16(drop[n], ap, bb[0], bb[1]);  // p k
            mma_bf16(drop[n + 1], ap, bb[2], bb[3]);
          } else {
            mma_bf16(drop[n], as, bb[0], bb[1]);  // ds v
            mma_bf16(drop[n + 1], as, bb[2], bb[3]);
            mma_bf16(o[n], ap, bb[0], bb[1]);
            mma_bf16(o[n + 1], ap, bb[2], bb[3]);
          }
        }
      }
    }
    store_rows(merged, o, b, N, D, AHD * h, 16 * qt, lane);
    store_rows(dqkv, dq, b, N, stride, AHD * h, 16 * qt, lane);
  }
  __syncthreads();  // every row's statistics are in

  // ---- pass 2: a warp a 16-key tile, over the query tiles
  for (int kt = warp; kt < tiles; kt += AWARPS) {
    uint32_t ka[4][4], va[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      load_a(ka[kk], s_k, ALD, 16 * kt, 16 * kk, lane);
      load_a(va[kk], s_v, ALD, 16 * kt, 16 * kk, lane);
    }
    float dk[8][4], dv[8][4], drop[8][4];
    zero(dk);
    zero(dv);
    if (PACK2) zero(drop);
#pragma unroll 1
    for (int qt = 0; qt < tiles; ++qt) {
      float c[2][4], dp[2][4];  // s^T and dp^T: rows keys, columns query rows
      logits_chunk(c, ka, s_q, qt, lane);
      logits_chunk(dp, va, s_do, qt, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 16 * kt + g + 8 * (e >> 1);
          const int row = 16 * qt + 8 * j + 2 * t + (e & 1);
          float p = 0.f, ds = 0.f;
          if (key < N && row < N) {
            p = prob(c[j][e], scale, st_max[row], st_sum[row]);
            const float dpv = row == 0 ? __fadd_rn(dp[j][e], dr0[key]) : dp[j][e];
            ds = ds_of(p, dpv, st_delta[row], scale);
          }
          c[j][e] = p;
          dp[j][e] = ds;
        }
      uint32_t ap[4], as[4];
      pack_a(ap, c[0], c[1]);
      pack_a(as, dp[0], dp[1]);
      if (!PACK2) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          load_b2_trans(bb, s_do, ALD, 16 * np, 16 * qt, lane);
          mma_bf16(dv[2 * np], ap, bb[0], bb[1]);
          mma_bf16(dv[2 * np + 1], ap, bb[2], bb[3]);
          load_b2_trans(bb, s_q, ALD, 16 * np, 16 * qt, lane);
          mma_bf16(dk[2 * np], as, bb[0], bb[1]);
          mma_bf16(dk[2 * np + 1], as, bb[2], bb[3]);
        }
      } else {  // [ds | p]^T . [q | do]
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          uint32_t bb[4];
          load_b2_trans(bb, np < 4 ? s_q : s_do, ALD, 16 * (np & 3), 16 * qt, lane);
          const int n = 2 * (np & 3);
          if (np < 4) {
            mma_bf16(dk[n], as, bb[0], bb[1]);
            mma_bf16(dk[n + 1], as, bb[2], bb[3]);
            mma_bf16(drop[n], ap, bb[0], bb[1]);  // p^T q
            mma_bf16(drop[n + 1], ap, bb[2], bb[3]);
          } else {
            mma_bf16(drop[n], as, bb[0], bb[1]);  // ds^T do
            mma_bf16(drop[n + 1], as, bb[2], bb[3]);
            mma_bf16(dv[n], ap, bb[0], bb[1]);
            mma_bf16(dv[n + 1], ap, bb[2], bb[3]);
          }
        }
      }
    }
    store_rows(dqkv, dk, b, N, stride, D + AHD * h, 16 * kt, lane);
    store_rows(dqkv, dv, b, N, stride, 2 * D + AHD * h, 16 * kt, lane);
  }
}

template <int KT>
int launch_bwd(const void* qkv, const void* dout, const void* drow0, int B, int N, int H,
               float scale, int pack2, void* merged, void* dqkv, cudaStream_t stream) {
  const auto kernel = pack2 ? proto_attn_bwd_kernel<KT, true> : proto_attn_bwd_kernel<KT, false>;
  const int smem = bwd_smem(KT);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, ATHREADS, smem, stream>>>(
      static_cast<const Bf*>(qkv), static_cast<const Bf*>(dout), static_cast<const float*>(drow0),
      N, H, scale, static_cast<Bf*>(merged), static_cast<Bf*>(dqkv));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace trk

// merged [B, N, 64 H] and dqkv [B, N, 3 x 64 H] (bf16) from the packed qkv
// [B, N, 3 x 64 H], the merged heads' cotangent dout [B, N, 64 H] (bf16)
// and the row0 cotangent drow0 [B, H, N] (fp32), all contiguous and
// 16-byte aligned (the caller checks); pack2 0 (loop) or 1 (pack2).
// 1 <= N <= 256. Returns the cudaError_t of the launch.
extern "C" int tr_proto_attn_bwd(const void* qkv, const void* dout, const void* drow0, int B,
                                 int N, int H, float scale, int pack2, void* merged, void* dqkv,
                                 void* stream) {
  using namespace trk;
  if (B == 0) return 0;
  if (N < 1 || N > 256 || H < 1 || (pack2 != 0 && pack2 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((N + 63) / 64) {
    case 1: return launch_bwd<1>(qkv, dout, drow0, B, N, H, scale, pack2, merged, dqkv, s);
    case 2: return launch_bwd<2>(qkv, dout, drow0, B, N, H, scale, pack2, merged, dqkv, s);
    case 3: return launch_bwd<3>(qkv, dout, drow0, B, N, H, scale, pack2, merged, dqkv, s);
    default: return launch_bwd<4>(qkv, dout, drow0, B, N, H, scale, pack2, merged, dqkv, s);
  }
}

// The dynamic shared memory a block takes at N keys.
extern "C" int tr_proto_attn_bwd_smem(int N) { return trk::bwd_smem((N + 63) / 64); }
