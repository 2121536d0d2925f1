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
// writing merged [B, N, D] and the packed dqkv [B, N, 3 D], with the main
// path's recipe (attention_sm90.cuh): logits in base-2 units (q.k * scale
// * log2 e), ex2 less the exact row max, p = e * (1 / sum). The products
// that contract over N are the four the tool arranges:
//
// - loop: each at width 64, as the tool's production structure:
//   round(p) v and ds k, then ds^T q and round(p)^T do.
// - pack2: two at width 128, [ds; p] . [k | v] (dq and merged) and
//   [ds | p]^T . [q | do] (dk and dv), as the tool's (:145-157): each as
//   two m64n128 wgmmas (ds and p as A) on one B operand, a pair of the
//   head's 64-column tiles read once (desc_pair); the unwanted quadrants
//   (ds v and p k, ds^T do and p^T q) are computed and summed into one
//   discarded accumulator that lives only across each key tile's (or query
//   tile's) products, so that the doubled accumulators take 96 registers a
//   thread there and 64 between them (dq and merged, or dk and dv). Even
//   so they do not fit 255 registers beside the recomputed S and dP: ptxas
//   spills and serialises the wgmma pipeline (its C7511 note). The split
//   taken: the pairs of 128-wide products run a key tile at a time in the
//   first pass (dq and merged) and a query tile at a time in the walk (dk
//   and dv), not as the tool's two products over all of N. It runs at
//   every N <= 256 (the TPU's build took only multiples of 8).
//
// Design: the main path's attention backward (attention_sm90.cu
// attention_bwd_sm90) with a first pass of its own in place of the saved
// statistics. One block of two warpgroups per (image, head); thread 0
// loads the head's q and k tiles, then its v and do tiles, by TMA on 4-D
// maps [B][N][H][64] (a box past N reads zeros, never the next image's
// rows) under two mbarriers, 64-row tiles with the 128-byte swizzle (221 KB
// of shared memory at N > 192: one block an SM). First pass, each
// warpgroup a query tile in turn: S = Q K^T on wgmma m64n64k16 with the
// whole row of at most 256 keys in registers gives the exact base-2 row max
// and 1/sum (row_exp, the forward's steps) and P; dP = dO V^T, a key tile
// at a time, gives delta = sum_j P_ij dP_ij in full (fp32 P, drow0 at row
// 0), summed per thread in key order, then over the lane quad; the
// statistics and delta go to shared memory. loop then takes merged =
// round(P) V on wgmma (P the register A operand, V MN-major); pack2 walks
// the key tiles once more, S and dP recomputed a tile at a time, and forms
// P and dS there as the A operands of its two products into dq and merged
// (dq summed over the key tiles in order in its accumulator). Each output
// tile leaves through a staging tile by a TMA store. Then the route's walk
// over the key tiles (attention_bwd_keys): S^T = K Q^T and dP^T = V dO^T
// recompute P^T and dS^T in registers, dV and dK on wgmma with A from
// registers (pack2: its second pair), and, for loop, dQ from dS^T staged
// in shared memory, summed in fp32 in the route's fixed order. No [N, N]
// matrix reaches memory, no atomics: two launches give the same bits.
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
// and dln, 2.09e11 operations, against about 117 MB of bytes: operations.
// This kernel's share is the attention's products on 64-row tiles padded
// from 197 to 256: loop 8 products a (query tile, key tile) pair (S, dP,
// P V; S^T, dP^T, dV, dK, dQ), pack2 the recomputed S and dP and four
// 128-wide products besides (14 64-wide equivalents); the serial chain of
// product, softmax and product within a block, one block an SM, sets its
// pace beside them.
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_sm90.cuh"

namespace trk {
namespace {

using bf16 = __nv_bfloat16;

// q, k, v, dO tiles; two staging tiles; the fp32 dQ [nt * 64][64] (loop;
// pack2 stages its second output tile there); bias2, caps, the row max,
// 1/sum, delta, the colsum cotangent (0), the row0 cotangent [MAXN]; 2
// barriers; 1 KB to align the tiles to the swizzle's 1024
size_t bwd_smem(int nt) {
  return 1024 + static_cast<size_t>(4 * nt + 2) * TILE + static_cast<size_t>(nt) * ROWS * HD * 4 +
         7 * MAXN * 4 + 2 * 8;
}

// A 64 x 64 fp32 accumulator of warpgroup wg (rows lr and lr + 8), rounded,
// into the staging tile at stg once its previous store has read it, then
// out by a TMA store at rows row0 .. (rows past N dropped).
__device__ __forceinline__ void stage_out(const float* o, uint32_t stg, const CUtensorMap* map,
                                          bool hf, int row0, int h, int b, int wg, int wt, int lr,
                                          int t) {
  extern __shared__ uint8_t smem_raw[];
  if (wt == 0) tma_store_wait();
  wg_sync(wg);
  uint8_t* dst = smem_raw + (stg - smem_addr(smem_raw));
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(dst + pair_offset(lr, j, t)) = pack_bf16(o[4 * j], o[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(dst + pair_offset(lr + 8, j, t)) =
        pack_bf16(o[4 * j + 2], o[4 * j + 3]);
  }
  fence_async_smem();
  wg_sync(wg);
  if (wt == 0) store_tile(map, hf, stg, row0, h, b);
}

template <bool PACK2>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    proto_attn_bwd_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_m,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_dq,
                          const __grid_constant__ CUtensorMap map_dk,
                          const __grid_constant__ CUtensorMap map_dv, int h_first,
                          const float* __restrict__ drow0, int N, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);
  const int nt = tiles_of(N);
  const uint32_t sq = base, sk = sq + nt * TILE, sv = sk + nt * TILE, sdo = sv + nt * TILE;
  const uint32_t sds0 = sdo + nt * TILE;  // a staging tile per warpgroup
  float* dq32 = reinterpret_cast<float*>(tiles + (4 * nt + 2) * TILE);  // [nt * 64][64]
  const uint32_t sds1 = smem_addr(dq32);  // pack2: a second staging tile per warpgroup
  float* bias2 = dq32 + nt * ROWS * HD;
  float* cap = bias2 + MAXN;
  float* sm2 = cap + MAXN;  // the row max in base-2 units; +inf past N
  float* sr = sm2 + MAXN;   // 1/sum; 0 past N
  float* sd = sr + MAXN;    // delta; 0 past N
  float* sc = sd + MAXN;    // the colsum cotangent: none
  float* sw = sc + MAXN;    // the row0 cotangent, 0 past N
  const uint32_t bars = smem_addr(sw + MAXN);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3, lr = warp * 16 + g;
  const size_t vec = static_cast<size_t>(bh) * N;

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    // bars: q and k; + 8: v and dO
    mbar_expect_tx(bars, 2 * nt * TILE);
    for (int i = 0; i < nt; ++i) {
      load_tile(sq + i * TILE, &map_q, h_first & 1, bars, i * ROWS, h, b);
      load_tile(sk + i * TILE, &map_k, h_first & 2, bars, i * ROWS, h, b);
    }
    mbar_expect_tx(bars + 8, 2 * nt * TILE);
    for (int i = 0; i < nt; ++i) {
      load_tile(sv + i * TILE, &map_v, h_first & 4, bars + 8, i * ROWS, h, b);
      load_tile(sdo + i * TILE, &map_do, h_first & 16, bars + 8, i * ROWS, h, b);
    }
  }
  for (int j = tid; j < MAXN; j += BWD_THREADS) {
    bias2[j] = j < N ? 0.f : -INFINITY;
    cap[j] = INFINITY;
    sm2[j] = INFINITY;
    sr[j] = 0.f;
    sd[j] = 0.f;
    sc[j] = 0.f;
    sw[j] = j < N ? drow0[vec + j] : 0.f;
  }
  __syncthreads();
  mbar_wait(bars, 0);

  // ---- first pass: warpgroup wg takes query tiles wg, wg + 2, ...
  const float c2 = scale * LOG2E;
  for (int it = wg; it < nt; it += 2) {
    float s[MAXT][32];
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < MAXT; ++kt)
      if (kt < nt)
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<0, 0>(s[kt], desc_k(sq + it * TILE, kk), desc_k(sk + kt * TILE, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int kt = 0; kt < MAXT; ++kt) fence32(s[kt]);
    const int r0 = it * ROWS + lr, r1 = r0 + 8;
    const bool live = it * ROWS + warp * 16 < N;  // the warp has a query row
    float mx0 = INFINITY, mx1 = INFINITY, rr0 = 0.f, rr1 = 0.f;
    if (live) {
      float sum0, sum1;
      row_exp<false, MAXT>(s, bias2, cap, INFINITY, INFINITY, N, nt, t, c2, mx0, mx1, sum0, sum1);
      rr0 = 1.f / sum0;
      rr1 = 1.f / sum1;
#pragma unroll
      for (int kt = 0; kt < MAXT; ++kt)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[kt][4 * j] *= rr0;
          s[kt][4 * j + 1] *= rr0;
          s[kt][4 * j + 2] *= rr1;
          s[kt][4 * j + 3] *= rr1;
        }
    } else {
#pragma unroll
      for (int kt = 0; kt < MAXT; ++kt) zero32(s[kt]);
    }
    if (it == wg) mbar_wait(bars + 8, 0);  // v and dO have landed
    // delta = sum over the keys of P dP, dP = dO V^T a key tile at a time
    // (the row0 cotangent on query row 0)
    float dl0 = 0.f, dl1 = 0.f;
#pragma unroll
    for (int kt = 0; kt < MAXT; ++kt) {
      if (kt < nt) {
        float dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<0, 0>(dp, desc_k(sdo + it * TILE, kk), desc_k(sv + kt * TILE, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence32(dp);
        if (live) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (kt * ROWS + 8 * j < N) {
              const int c = kt * ROWS + 8 * j + 2 * t;
              if (r0 == 0) dp[4 * j] += sw[c], dp[4 * j + 1] += sw[c + 1];
              dl0 += s[kt][4 * j] * dp[4 * j] + s[kt][4 * j + 1] * dp[4 * j + 1];
              dl1 += s[kt][4 * j + 2] * dp[4 * j + 2] + s[kt][4 * j + 3] * dp[4 * j + 3];
            }
        }
      }
    }
    dl0 = quad_sum(dl0);
    dl1 = quad_sum(dl1);
    if (t == 0) {  // rows past N keep +inf, 0 and 0: they take no part
      if (r0 < N) sm2[r0] = mx0, sr[r0] = rr0, sd[r0] = dl0;
      if (r1 < N) sm2[r1] = mx1, sr[r1] = rr1, sd[r1] = dl1;
    }
    if constexpr (!PACK2) {
      // merged = round(P) V: P rounded in registers as the A operand, 16
      // keys a step up to the last step with a key < N
      uint32_t pa[MAXT][16];
#pragma unroll
      for (int kt = 0; kt < MAXT; ++kt)
#pragma unroll
        for (int i = 0; i < 16; ++i) pa[kt][i] = pack_bf16(s[kt][2 * i], s[kt][2 * i + 1]);
#pragma unroll
      for (int kt = 0; kt < MAXT; ++kt) fence16(pa[kt]);
      float o[32];
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < MAXT; ++kt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kt < nt && kt * ROWS + 16 * kk < N)
            wgmma_rs<1>(o, pa[kt] + 4 * kk, desc_mn(sv + kt * TILE, kk), kt + kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence32(o);
      stage_out(o, sds0 + wg * TILE, &map_m, h_first & 8, it * ROWS, h, b, wg, wt, lr, t);
    } else {
      // [dq | ds v] += dS [K | V] and [p k | merged] += P [K | V], a key
      // tile at a time, S and dP recomputed there (the same products, the
      // same P), P and dS formed in registers as the A operands
      float dq[32], mg[32];
#pragma unroll
      for (int kt = 0; kt < MAXT; ++kt) {
        if (kt < nt) {
          float sp[32], dp[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            wgmma_ss<0, 0>(sp, desc_k(sq + it * TILE, kk), desc_k(sk + kt * TILE, kk), kk);
            wgmma_ss<0, 0>(dp, desc_k(sdo + it * TILE, kk), desc_k(sv + kt * TILE, kk), kk);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence32(sp);
          fence32(dp);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float* x = sp + 4 * j;
            float* d = dp + 4 * j;
            if (live && kt * ROWS + 8 * j < N) {
              const int c = kt * ROWS + 8 * j + 2 * t;
              const float2 bb = *reinterpret_cast<const float2*>(bias2 + c);
              x[0] = ex2(fmaf(x[0], c2, bb.x) - mx0) * rr0;
              x[1] = ex2(fmaf(x[1], c2, bb.y) - mx0) * rr0;
              x[2] = ex2(fmaf(x[2], c2, bb.x) - mx1) * rr1;
              x[3] = ex2(fmaf(x[3], c2, bb.y) - mx1) * rr1;
              if (r0 == 0) d[0] += sw[c], d[1] += sw[c + 1];
              d[0] = x[0] * (d[0] - dl0) * scale;
              d[1] = x[1] * (d[1] - dl0) * scale;
              d[2] = x[2] * (d[2] - dl1) * scale;
              d[3] = x[3] * (d[3] - dl1) * scale;
            } else {
              x[0] = x[1] = x[2] = x[3] = 0.f;
              d[0] = d[1] = d[2] = d[3] = 0.f;
            }
          }
          uint32_t pa[16], da[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            pa[i] = pack_bf16(sp[2 * i], sp[2 * i + 1]);
            da[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
          }
          fence16(pa);
          fence16(da);
          float drop[32];  // the discarded quadrants, live only across the products
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kt * ROWS + 16 * kk < N) {
              const uint64_t kv = desc_pair(sk + kt * TILE, sv + kt * TILE, kk);
              wgmma_rs128<1>(dq, drop, da + 4 * kk, kv, kt + kk);
              wgmma_rs128<1>(drop, mg, pa + 4 * kk, kv, kt + kk);
            }
          wgmma_commit();
          wgmma_wait<0>();
          fence32(dq);
          fence32(mg);
          fence32(drop);
        }
      }
      stage_out(dq, sds0 + wg * TILE, &map_dq, h_first & 32, it * ROWS, h, b, wg, wt, lr, t);
      stage_out(mg, sds1 + wg * TILE, &map_m, h_first & 8, it * ROWS, h, b, wg, wt, lr, t);
    }
  }
  // every row's statistics and delta are in; the first pass's stores have
  // read the staging tiles (loop stages dS^T there next)
  if (wt == 0) tma_store_wait();
  __syncthreads();
  mbar_wait(bars + 8, 0);  // (a warpgroup with no query tile has not waited)

  // ---- the route's walk over the key tiles
  attention_bwd_keys<false, false, PACK2>(sq, sk, sv, sdo, sds0, dq32, bias2, cap, sm2, sr, sd, sc,
                                          sw, &map_dq, &map_dk, &map_dv, h_first, nullptr, vec, N,
                                          nt, h, b, tid, wg, wt, warp, g, t, scale);
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
  if (N < 1 || N > MAXN || H < 1 || (pack2 != 0 && pack2 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = pack2 ? proto_attn_bwd_kernel<true> : proto_attn_bwd_kernel<false>;
  // first: the context the tensor maps need (sm90.cuh encoder)
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bwd_smem(MAXT)));
  if (err != cudaSuccess) return static_cast<int>(err);
  // q, k, v, merged, dout, dq, dk, dv as [B, H, N, 64] maps of the packed
  // layouts
  const int D = HD * H;
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* dx = static_cast<bf16*>(dqkv);
  const void* ptrs[8] = {x, x + D, x + 2 * D, merged, dout, dx, dx + D, dx + 2 * D};
  const long long pk = static_cast<long long>(N) * 3 * D, pl = static_cast<long long>(N) * D;
  const long long strides[24] = {pk, HD, 3 * D, pk, HD, 3 * D, pk, HD, 3 * D, pl, HD, D,
                                 pl, HD, D,     pk, HD, 3 * D, pk, HD, 3 * D, pk, HD, 3 * D};
  CUtensorMap maps[8];
  int h_first;
  err = heads_maps(maps, ptrs, strides, 8, B, H, N, &h_first);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, BWD_THREADS, bwd_smem(tiles_of(N)), static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7], h_first,
      static_cast<const float*>(drow0), N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block takes at N keys.
extern "C" int tr_proto_attn_bwd_smem(int N) {
  return static_cast<int>(trk::bwd_smem(trk::tiles_of(N)));
}
