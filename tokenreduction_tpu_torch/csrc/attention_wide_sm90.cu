// Softmax attention at any width (up to WIDE_MAXN = 2048 tokens) at head
// dim 64 on Hopper (sm_90a): the bf16 forward (square and rectangular) and
// backward for N (or M) above 256, where attention_sm90.cu's kernels, which
// hold a whole head's operands in shared memory and a whole row of S in
// registers, stop. The host launches these only above 256 tokens: every
// launch at N <= 256 stays attention_sm90.cu's.
//
// It replaces, in bf16 above 256 tokens, the attention of the TPU kernels
// tokenreduction_tpu/ops/flash_attention.py fused_attention (:183, also the
// forward of ops/flash_attention_train.py attention_core_train),
// fused_attention_qkv (:313), fused_block_attention (:660),
// fused_rect_attention (:817) and fused_rect_block (:925), the attention of
// ops/fused_block_train.py attend_branch_train (fwd :246, bwd :296), and
// the backward _bwd_kernel of ops/flash_attention_train.py (:38-99). The
// TPU kernels pad N to a multiple of 16 and keep whole rows of the logits
// in VMEM, so they take any width.
//
// Arithmetic: attention_sm90.cu's, point for point (operands [B, H, N, 64]
// through their strides and 4-D tensor maps; logits in base-2 units with
// the bias and the -FLT_MAX caps; P = ex2(x - the exact row max); the eval
// recipe rounds the unnormalised exponentials before PV and scales the
// output by 1/sum, NORM_P rounds the normalised P; row0, colsum and the
// row statistics [B, H, N, 2]; the backward's P from those statistics,
// delta in the shortcut or the EXACT form, dS rounded after the scale).
// What differs is the walk over the keys, which no longer fit a block (and,
// in the square forward, the row max that the eval recipe's P is taken
// against: see walk 1).
//
// Forward (square: every variant but RECT). One block per (image, head,
// 128 query rows): a producer warpgroup (setmaxnreg 24), of which one
// thread issues every TMA load, and two consumer warpgroups (setmaxnreg
// 240), each holding 64 query rows. The producer loads the block's two
// query tiles once, then streams the 64-key tiles of K and V through a
// ring of WS_STAGES stages (a full barrier each, completed by the loads'
// bytes, and an empty barrier each, completed when all 8 consumer warps
// have retired the products that read the stage). Each consumer walks the
// keys once:
//   walk 1: S = Q K^T on wgmma m64n64k16; the tile's row max, the running
//     max m (base 2) and the sum of ex2(x - m) rescaled by ex2(m_old -
//     m_new) whenever the max grows (a fully masked row, -FLT_MAX caps,
//     stays uniform; the first tile scales a zero sum by ex2(-inf) = 0);
//     the eval recipe rounds P = ex2(x - the running max) to bf16 in
//     registers and adds P V (register-A wgmma, V read MN-major) to O,
//     which is rescaled by the same factor first. The next tile's S is
//     issued before this tile's softmax, and this tile's P V is waited on
//     only when the tile after needs O (wgmma_wait<1>), so a warpgroup's
//     exponentials run under its own products, and the two warpgroups'
//     under each other's. The row max and 1/sum are the statistics the
//     training forward writes. O x 1/sum leaves through the query tile's
//     shared memory by a TMA store. row0 without colsum: the warp that
//     holds query row 0 keeps that row's capped base-2 logits in shared
//     memory during the walk and writes ex2(x - m) / sum at its end, JAX's
//     exact-max row0 with no second walk.
//   walk 2 (colsum, NORM_P): S again (the same bits), P = ex2(x - the
//     final max) / sum, the normalised probabilities of a kernel that held
//     the whole row: NORM_P rounds them and sums O = P V over the key tiles
//     (walk 1 then only takes the statistics); row0 reads them; colsum sums
//     each warp's 16 rows (attention_sm90.cuh's butterfly) into its row of
//     shared memory, then the block's 8 warps are added in order into a
//     partial per 128 query rows (fp32 [B, H, N / 128, N], the caller's
//     scratch), which a second launch (colsum_reduce) adds in query-block
//     order. This route, rather than a launch per key tile that recomputes
//     S^T from saved statistics, was chosen because NORM_P needs a second
//     walk over the keys in the query block anyway (its O is a sum of
//     rounded normalised probabilities), and colsum then costs that
//     walk's butterflies alone. No atomics: two launches give the same
//     bits.
// What changed in the arithmetic from the two-pass walk (still RECT's,
// below): the eval output rounds ex2(x - the running max) before PV, not
// ex2(x - the final max); the same function rounded at other points.
// RECT (ATS's gathered query rows) keeps the two-pass walk of one block per
// (image, head) over its query tiles: at ATS@0.7's 405 x 577 it is level
// with gathering the rows and running SDPA (PERF.md).
//
// Backward: two launches, neither with atomics.
//   attention_wide_bwd_dq: one block per (image, head, query tile) with its
//     Q and dO tiles; K and V stream through the ring. delta in the shortcut
//     form rowsum(dO * O) + [i = 0] row0 . drow0 (the O tile loaded too), or
//     EXACT (with a colsum cotangent or dbias): a first pass of S and dP =
//     dO V^T summing P dP along each row. Then dS = P (dP - delta) * scale
//     (zero at a masked pair), rounded, and dQ = dS K on wgmma (A = dS from
//     registers, K read MN-major), summed over the key tiles in order. It
//     writes delta [B, H, N] for the second launch.
//   attention_wide_bwd_dkv: one block per (image, head, key tile) with its
//     K and V tiles; Q and dO stream through the ring. S^T = K Q^T and dP^T
//     = V dO^T on wgmma, P^T and dS^T in registers (attention_sm90.cuh's
//     probs_t and the same dS), dV += P^T dO and dK += dS^T Q on wgmma with
//     A from registers, dbias (the unscaled dS summed over the queries) in
//     registers, all in query-tile order.
//
// What bounds them at B = 256, H = 6, N = 577 on the H100: the forward's
// products 130.9 GFLOP (0.132 ms at 989 TFLOP/s) against q, k, v and the
// output, 454 MB (0.135 ms at 3.35 TB/s), and its 511 M exponentials
// (about 0.13 ms at 16 a clock an SM); the backward's five products, 327 GFLOP
// (0.331 ms). The square forward computes S once (twice with colsum or
// NORM_P) and overlaps its products with its exponentials; the RECT
// forward computes S twice and the backward three times (EXACT), each
// running a block's loads, products and exponentials one after another
// (overlap comes from the other blocks on the SM).
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>

#include "attention_sm90.cuh"

namespace trk {
namespace {

using bf16 = __nv_bfloat16;

constexpr int WIDE_MAXN = 2048;
constexpr int RING = 2;  // stages of the streamed tiles

__host__ __device__ int keys_of(int n) { return tiles_of(n) * ROWS; }

// rectangular forward: the query tile, the output tile, RING stages of a
// K and a V tile; bias2 and cap [keys]; the query caps [64]; RING
// barriers; 1 KB to align the tiles
size_t wide_rect_smem(int n) {
  return 1024 + static_cast<size_t>(2 + 2 * RING) * TILE +
         (2 * static_cast<size_t>(keys_of(n)) + ROWS) * 4 + RING * 8;
}

// dQ: the Q, dO and O tiles, RING stages of a K and a V tile; bias2, cap,
// the row0 and colsum cotangents [keys]; delta [64]; 1 + RING barriers
size_t wide_dq_smem(int n) {
  return 1024 + static_cast<size_t>(3 + 2 * RING) * TILE +
         (4 * static_cast<size_t>(keys_of(n)) + ROWS) * 4 + (1 + RING) * 8;
}

// dK, dV: the K and V tiles, RING stages of a Q and a dO tile; the base-2
// row max, 1/sum, delta and cap [keys]; 1 + RING barriers
size_t wide_dkv_smem(int n) {
  return 1024 + static_cast<size_t>(2 + 2 * RING) * TILE +
         4 * static_cast<size_t>(keys_of(n)) * 4 + (1 + RING) * 8;
}

// The rectangular variant's query rows: row m of the q operand's (image b,
// head h) is q + b sb + h sh + ids[b M + m] sn (elements).
struct RowIds {
  const bf16* q;
  long long sb, sh, sn;
  const int* ids;  // [B, M]
};

// Query rows m0 .. m0 + 63 of the rectangular variant into the tile at
// `tile` by cp.async, in the TMA box's 128-byte swizzle (chunk c of tile row
// r at c ^ (r % 8)), rows past M zeros; qcap[r] = +inf for a valid gathered
// token, -FLT_MAX for an invalid one or past M. Thread (r, c) = (tid / 8,
// tid % 8) copies chunk c of tile rows r + 16 j. An id outside 0..N-1 traps.
__device__ __forceinline__ void gather_tile(uint8_t* tile, float* qcap, const RowIds& ga,
                                            const unsigned char* mask, int b, int h, int N, int M,
                                            int m0) {
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
  const int* ids = ga.ids + static_cast<size_t>(b) * M;
#pragma unroll
  for (int j = 0; j < ROWS / 16; ++j) {
    const int lr = r + 16 * j, m = m0 + lr;
    const bool in = m < M;
    const int id = in ? ids[m] : 0;
    if (in && static_cast<unsigned>(id) >= static_cast<unsigned>(N)) __trap();
    cp_async16(tile + lr * 128 + ((c ^ (lr & 7)) << 4),
               in ? ga.q + b * ga.sb + h * ga.sh + id * ga.sn + c * 8 : ga.q, in);
    if (c == 0) qcap[lr] = in && mask[static_cast<size_t>(b) * N + id] ? INFINITY : -FLT_MAX;
  }
  cp_async_commit();
}

// The base-2 logits of a 64 x 64 tile of S in place: s holds the raw q.k of
// this thread's rows (qc0, qc1: their caps) against key columns k0 + 8 j +
// 2 t (+1) (the accumulator layout); x = s c2 + bias2[key], with MASK
// capped at the key's and the row's cap. Keys past N come out -inf with no
// branch: bias2 is -inf and cap -FLT_MAX there, and K's rows past N are
// zeros. (A register of a product written on a path that not every thread
// takes would make ptxas serialise the square forward's overlapped
// products, C7520.)
template <bool MASK>
__device__ __forceinline__ void tile_logits(float* s, const float* bias2, const float* cap,
                                            float qc0, float qc1, int k0, int t, float c2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* x = s + 4 * j;
    const int c = k0 + 8 * j + 2 * t;
    const float2 bb = *reinterpret_cast<const float2*>(bias2 + c);
    x[0] = fmaf(x[0], c2, bb.x);
    x[1] = fmaf(x[1], c2, bb.y);
    x[2] = fmaf(x[2], c2, bb.x);
    x[3] = fmaf(x[3], c2, bb.y);
    if constexpr (MASK) {
      const float2 kc = *reinterpret_cast<const float2*>(cap + c);
      x[0] = fminf(fminf(x[0], kc.x), qc0);
      x[1] = fminf(fminf(x[1], kc.y), qc0);
      x[2] = fminf(fminf(x[2], kc.x), qc1);
      x[3] = fminf(fminf(x[3], kc.y), qc1);
    }
  }
}

// ------------------------------------------- rectangular forward
// ATS's rectangular attention: the M query rows gathered through ga over
// all N keys, out [B, H, M, 64], with the validity mask (the JAX pair
// mask), the eval recipe, no bias and no by-products. One block of one
// warpgroup per (image, head) walks its query tiles, and for each the key
// tiles twice (pass 1 the row statistics online, pass 2 P from the final
// max, P V on wgmma).
__global__ void __launch_bounds__(THREADS, 2)
    attention_wide_rect(const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_o, int h_first,
                        const unsigned char* __restrict__ mask, const RowIds ga, int N, int M,
                        int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);
  const int nt = tiles_of(N), keys = nt * ROWS, ntq = tiles_of(M);
  // the query tile, the output tile, then stage i's K tile at sring + 2 i
  // TILE and its V tile after it
  const uint32_t so = base + TILE, sring = so + TILE;
  float* bias2 = reinterpret_cast<float*>(tiles + (2 + 2 * RING) * TILE);
  float* cap = bias2 + keys;
  float* qcap = cap + keys;  // [ROWS]
  const uint32_t rbar = smem_addr(qcap + ROWS);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool hk = h_first & 2, hv = h_first & 4, ho = h_first & 8;
  const float c2 = scale * LOG2E;
  // the ring's items: for each query tile, pass 1's key tiles (K), then
  // pass 2's (K and V)
  const int total = ntq * 2 * nt;
  const auto issue = [&](int i) {  // item i into stage i % RING (thread 0)
    if (i >= total) return;
    const int r = i % (2 * nt), kt = r % nt;
    const bool pv = r >= nt;
    const uint32_t dst = sring + (i % RING) * 2 * TILE, bar = rbar + 8 * (i % RING);
    mbar_expect_tx(bar, (pv ? 2 : 1) * TILE);
    load_tile(dst, &map_k, hk, bar, kt * ROWS, h, b);
    if (pv) load_tile(dst + TILE, &map_v, hv, bar, kt * ROWS, h, b);
  };

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) mbar_init(rbar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < RING; ++i) issue(i);
  for (int j = tid; j < keys; j += THREADS) {
    bias2[j] = j < N ? 0.f : -INFINITY;
    cap[j] = j < N && mask[static_cast<size_t>(b) * N + j] ? INFINITY : -FLT_MAX;
  }

  const int lr = warp * 16 + g;
  int item = 0;  // the ring's next item
  for (int qi = 0; qi < ntq; ++qi) {
    // the query tile (its shared memory read by no product since the last
    // item's barrier)
    gather_tile(tiles, qcap, ga, mask, b, h, N, M, qi * ROWS);
    cp_async_wait<0>();  // landed: into the async proxy
    fence_async_smem();
    if (tid == 0) tma_store_wait();  // the last output tile has left so
    __syncthreads();
    const int r0 = qi * ROWS + lr, r1 = r0 + 8;
    const bool rows = qi * ROWS + warp * 16 < M;  // the warp has a query row
    const float qc0 = qcap[lr], qc1 = qcap[lr + 8];
    float mx0 = -INFINITY, mx1 = -INFINITY, sum0 = 0.f, sum1 = 0.f, rr0 = 0.f, rr1 = 0.f;
    float o[32];
    for (int pass = 0; pass < 2; ++pass) {
      for (int kt = 0; kt < nt; ++kt, ++item) {
        const uint32_t sk = sring + (item % RING) * 2 * TILE;
        mbar_wait(rbar + 8 * (item % RING), (item / RING) & 1);
        float s[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<0, 0>(s, desc_k(base, kk), desc_k(sk, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence32(s);
        if (rows) {
          tile_logits<true>(s, bias2, cap, qc0, qc1, kt * ROWS, t, c2);
          if (pass == 0) {
            // the running statistics: the tile's row max, then the sum
            // rescaled to the new max (every tile has a key < N, so the
            // new max is finite)
            float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              t0 = fmaxf(t0, fmaxf(s[4 * j], s[4 * j + 1]));
              t1 = fmaxf(t1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
            }
            const float n0 = fmaxf(mx0, quad_max(t0)), n1 = fmaxf(mx1, quad_max(t1));
            float l0 = 0.f, l1 = 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              l0 += ex2(s[4 * j] - n0) + ex2(s[4 * j + 1] - n0);
              l1 += ex2(s[4 * j + 2] - n1) + ex2(s[4 * j + 3] - n1);
            }
            sum0 = sum0 * ex2(mx0 - n0) + quad_sum(l0);
            sum1 = sum1 * ex2(mx1 - n1) + quad_sum(l1);
            mx0 = n0;
            mx1 = n1;
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              float* x = s + 4 * j;
              x[0] = ex2(x[0] - mx0);
              x[1] = ex2(x[1] - mx0);
              x[2] = ex2(x[2] - mx1);
              x[3] = ex2(x[3] - mx1);
            }
          }
        } else {
          zero32(s);
        }
        if (pass == 1) {
          // O += P V: P rounded to bf16 in place, 16 keys a step, up to the
          // last step with a key < N (V's rows past N are zeros, P there 0)
          uint32_t pa[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
          fence16(pa);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (kt * ROWS + 16 * kk < N)
              wgmma_rs<1>(o, pa + 4 * kk, desc_mn(sk + TILE, kk), kt + kk);
          wgmma_commit();
          wgmma_wait<0>();
          fence32(o);
        }
        __syncthreads();  // every product of this stage is done
        if (tid == 0) issue(item + RING);
      }
      if (pass == 0 && rows) {
        rr0 = r0 < M ? 1.f / sum0 : 0.f;  // rows past the last take no part
        rr1 = r1 < M ? 1.f / sum1 : 0.f;
      }
    }

    // the output tile, rounded, into so, then one TMA store (rows past M
    // dropped)
    uint8_t* otile = tiles + TILE;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(otile + pair_offset(lr, j, t)) =
          pack_bf16(o[4 * j] * rr0, o[4 * j + 1] * rr0);
      *reinterpret_cast<uint32_t*>(otile + pair_offset(lr + 8, j, t)) =
          pack_bf16(o[4 * j + 2] * rr1, o[4 * j + 3] * rr1);
    }
    fence_async_smem();
    __syncthreads();
    if (tid == 0) store_tile(&map_o, ho, so, qi * ROWS, h, b);
  }
  if (tid == 0) tma_store_wait();
}

// ---------------------------------------- forward, warp-specialised
constexpr int WS_STAGES = 4;                                // stages of the K, V ring
constexpr int WS_CONSUMERS = 2;                             // warpgroups of 64 query rows
constexpr int WS_THREADS = (1 + WS_CONSUMERS) * THREADS;    // the producer warpgroup first
constexpr int WS_ROWS = WS_CONSUMERS * ROWS;                // query rows of a block

__host__ __device__ int ws_blocks(int n) { return (n + WS_ROWS - 1) / WS_ROWS; }
__host__ __device__ int ws_len(int n) { return ws_blocks(n) * WS_ROWS; }

// the two query tiles (later the output tiles), WS_STAGES stages of a K and
// a V tile; bias2, cap, row 0's logits and the 8 consumer warps' column
// sums [ws_len]; 1 + 2 WS_STAGES barriers; 1 KB to align the tiles
size_t wide_ws_smem(int n) {
  return 1024 + static_cast<size_t>(2 + 2 * WS_STAGES) * TILE +
         11 * static_cast<size_t>(ws_len(n)) * 4 + (1 + 2 * WS_STAGES) * 8;
}

// The pair (a, b) into shared memory at addr when p: a predicated store,
// no branch (see tile_logits).
__device__ __forceinline__ void st_pair_if(uint32_t addr, float a, float b, bool p) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %3, 0;\n @q st.shared.v2.f32 [%0], {%1, %2};\n}\n" ::"r"(
          addr),
      "f"(a), "f"(b), "r"(static_cast<int>(p))
      : "memory");
}

// A consumer row pair's running statistics: the base-2 row max and the sum
// of ex2(x - max), of this thread's rows r0 and r1.
struct RowStats {
  float m0, m1, l0, l1;
};

// A consumer warpgroup's walk over the ring (see the header): its query
// tile, the ring, the per-key vectors and this thread's rows' caps.
struct WsWalk {
  uint32_t sq, sring, full0, empty0;
  const float* bias2;
  const float* cap;
  int N, t, lane;
  float qc0, qc1, c2;

  __device__ __forceinline__ uint32_t stage(int i) const {
    return sring + (i % WS_STAGES) * 2 * TILE;
  }
  // this warp has retired every product that read item i's stage
  __device__ __forceinline__ void release(int i) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (i % WS_STAGES));
  }
  // S = Q K^T of item i into s: issued and committed, not waited on
  __device__ __forceinline__ void issue_s(float* s, int i) const {
    mbar_wait(full0 + 8 * (i % WS_STAGES), (i / WS_STAGES) & 1);
    const uint32_t sk = stage(i);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss<0, 0>(s, desc_k(sq, kk), desc_k(sk, kk), kk);
    wgmma_commit();
  }
  // o (+)= P V over item i's V tile, key tile kt, P = p rounded to bf16 in
  // pa (V's rows past N are zeros, P there 0); the first step of kt = 0
  // starts o afresh
  __device__ __forceinline__ void issue_pv(float* o, const float* p, uint32_t* pa, int i,
                                           int kt) const {
#pragma unroll
    for (int x = 0; x < 16; ++x) pa[x] = pack_bf16(p[2 * x], p[2 * x + 1]);
    fence16(pa);
    const uint32_t sv = stage(i) + TILE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(o, pa + 4 * kk, desc_mn(sv, kk), kt + kk);
    wgmma_commit();
  }
  // this thread's 16 values of row 0 at key tile kt into srow0 (at the
  // shared address row0s) when keep, else nothing
  __device__ __forceinline__ void keep_row0(uint32_t row0s, const float* x, bool keep,
                                            int kt) const {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st_pair_if(row0s + 4 * (kt * ROWS + 8 * j + 2 * t), x[4 * j], x[4 * j + 1], keep);
  }

  // Walk 1 at key tile kt (item i), its S in cur (landed). MORE: tile kt +
  // 1's S is issued into nxt first, and has landed on return. NORM_P takes
  // the statistics alone; else P V joins O (rescaled first). keep: this
  // thread's logits of query row 0 go to srow0 (at row0s).
  template <bool MORE, bool NORM_P, bool MASK>
  __device__ __forceinline__ void walk1(float* cur, float* nxt, float* o, uint32_t* pa,
                                        uint32_t row0s, bool keep, RowStats& st, int kt,
                                        int i) const {
    if constexpr (MORE) issue_s(nxt, i + 1);
    tile_logits<MASK>(cur, bias2, cap, qc0, qc1, kt * ROWS, t, c2);
    keep_row0(row0s, cur, keep, kt);
    // the new row max (every tile has a key < N: finite), the tile's
    // exponentials against it and their sums
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      t0 = fmaxf(t0, fmaxf(cur[4 * j], cur[4 * j + 1]));
      t1 = fmaxf(t1, fmaxf(cur[4 * j + 2], cur[4 * j + 3]));
    }
    const float n0 = fmaxf(st.m0, quad_max(t0)), n1 = fmaxf(st.m1, quad_max(t1));
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* x = cur + 4 * j;
      x[0] = ex2(x[0] - n0);
      x[1] = ex2(x[1] - n0);
      x[2] = ex2(x[2] - n1);
      x[3] = ex2(x[3] - n1);
      l0 += x[0] + x[1];
      l1 += x[2] + x[3];
    }
    const float a0 = ex2(st.m0 - n0), a1 = ex2(st.m1 - n1);
    st.l0 = st.l0 * a0 + quad_sum(l0);
    st.l1 = st.l1 * a1 + quad_sum(l1);
    st.m0 = n0;
    st.m1 = n1;
    if constexpr (NORM_P) {
      release(i);  // its K was read by S alone, which has landed
    } else {
      // the last tile's P V has landed (with MORE the next S is the
      // younger group; at kt = 0 nothing is older), then O, rescaled to the
      // new max (at kt = 0 a0 = 0 and O is 0), takes this tile's P V
      if constexpr (MORE)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence32(o);
      if (kt > 0) release(i - 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
      issue_pv(o, cur, pa, i, kt);
    }
    if constexpr (MORE) {
      if constexpr (NORM_P)
        wgmma_wait<0>();
      else
        wgmma_wait<1>();  // the next S, not this P V
      fence32(nxt);
    }
  }

  // Walk 2 at key tile kt (item i), its S in cur (landed), MORE as in
  // walk 1: P = ex2(x - m) * r, the normalised probabilities (r0, r1 the
  // rows' 1/sum, 0 past N). keep: query row 0's go to srow0 (at row0s);
  // with COLSUM the warp's column sums of its 16 rows go to csw (its row
  // of the block's); NORM_P sums O = round(P) V.
  template <bool MORE, bool NORM_P, bool MASK, bool COLSUM>
  __device__ __forceinline__ void walk2(float* cur, float* nxt, float* o, uint32_t* pa,
                                        uint32_t row0s, bool keep, float* csw,
                                        const RowStats& st, float r0, float r1, int kt,
                                        int i) const {
    if constexpr (MORE) issue_s(nxt, i + 1);
    tile_logits<MASK>(cur, bias2, cap, qc0, qc1, kt * ROWS, t, c2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* x = cur + 4 * j;
      x[0] = ex2(x[0] - st.m0) * r0;
      x[1] = ex2(x[1] - st.m0) * r0;
      x[2] = ex2(x[2] - st.m1) * r1;
      x[3] = ex2(x[3] - st.m1) * r1;
    }
    keep_row0(row0s, cur, keep, kt);
    if constexpr (COLSUM) {
      float v[16], sums[2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[2 * j] = cur[4 * j] + cur[4 * j + 2];
        v[2 * j + 1] = cur[4 * j + 1] + cur[4 * j + 3];
      }
      column_butterfly(v, lane, sums);
      float* at = csw + kt * ROWS + butterfly_col(lane);
      at[0] = sums[0];
      at[1] = sums[1];
    }
    if constexpr (NORM_P) {
      if constexpr (MORE)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence32(o);
      if (kt > 0) release(i - 1);
      issue_pv(o, cur, pa, i, kt);
    } else {
      release(i);
    }
    if constexpr (MORE) {
      if constexpr (NORM_P)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      fence32(nxt);
    }
  }
};

// NORM_P: round the normalised probabilities before PV (the training
// branch and the packed-qkv attention), else the eval recipe. MASK: the
// validity mask (one byte per token). COLSUM: colsum's partial sums into
// part ([B, H, ws_blocks(N), N]) for colsum_reduce. bias, row0 and stats
// may be null.
template <bool NORM_P, bool MASK, bool COLSUM>
__global__ void __launch_bounds__(WS_THREADS, 1)
    attention_wide_fwd_ws(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_o, int h_first,
                          const float* __restrict__ bias, const unsigned char* __restrict__ mask,
                          float* __restrict__ row0, float* __restrict__ part,
                          float2* __restrict__ stats, int N, int H, float scale) {
  constexpr bool WALK2 = NORM_P || COLSUM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);
  const int nt = tiles_of(N), L = ws_len(N);
  const uint32_t sq = base, sring = sq + WS_CONSUMERS * TILE;
  float* bias2 = reinterpret_cast<float*>(tiles + (WS_CONSUMERS + 2 * WS_STAGES) * TILE);
  float* cap = bias2 + L;
  float* srow0 = cap + L;
  float* csw = srow0 + L;  // [8][L]
  const uint32_t qbar = smem_addr(csw + 8 * L), full0 = qbar + 8,
                 empty0 = full0 + 8 * WS_STAGES;
  const int bh = blockIdx.x, qb = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, wg = tid >> 7;
  // the consumers with a query row < N: the last block's second may have
  // none, and then takes no part
  const int active = min(WS_CONSUMERS, nt - qb * WS_CONSUMERS);
  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < WS_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * active);  // one arrival per active consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = tid; j < L; j += WS_THREADS) {
    bias2[j] = j < N ? (bias != nullptr ? bias[static_cast<size_t>(b) * N + j] * LOG2E : 0.f)
                     : -INFINITY;
    if (MASK) cap[j] = j < N && mask[static_cast<size_t>(b) * N + j] ? INFINITY : -FLT_MAX;
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid != 0) return;
    mbar_expect_tx(qbar, active * TILE);
    for (int c = 0; c < active; ++c)
      load_tile(sq + c * TILE, &map_q, h_first & 1, qbar, qb * WS_ROWS + c * ROWS, h, b);
    // walk 1's key tiles, then walk 2's; V where P V reads it
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < (WALK2 ? 2 : 1) * nt; ++i) {
      const bool pv = i < nt ? !NORM_P : NORM_P;
      const uint32_t full = full0 + 8 * stage, dst = sring + stage * 2 * TILE;
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      mbar_expect_tx(full, (pv ? 2 : 1) * TILE);
      load_tile(dst, &map_k, h_first & 2, full, (i % nt) * ROWS, h, b);
      if (pv) load_tile(dst + TILE, &map_v, h_first & 4, full, (i % nt) * ROWS, h, b);
      if (++stage == WS_STAGES) stage = 0, phase ^= 1;
    }
    return;
  }

  // consumers: warpgroup cw holds query rows qb * 128 + cw * 64 .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1, ct = tid - THREADS * wg, warp = ct >> 5, lane = tid & 31;
  if (cw >= active) return;
  const int g = lane >> 2, t = lane & 3, lr = warp * 16 + g;
  const int r0 = qb * WS_ROWS + cw * ROWS + lr, r1 = r0 + 8;  // < L
  WsWalk w{sq + cw * TILE, sring, full0, empty0, bias2, cap, N, t, lane,
           MASK ? cap[r0] : INFINITY, MASK ? cap[r1] : INFINITY, scale * LOG2E};
  // the threads of query row 0 (a quad: g == 0) keep its logits (one
  // walk) or probabilities (walk 2) in srow0
  const bool keep = row0 != nullptr && r0 == 0;
  const uint32_t row0s = smem_addr(srow0);
  const size_t vec = static_cast<size_t>(bh) * N;
  mbar_wait(qbar, 0);

  float o[32], sa[32], sb[32];
  uint32_t pa[16];
  zero32(o);
  RowStats st{-INFINITY, -INFINITY, 0.f, 0.f};
  int i = 0;  // the ring's next item
  {
    const bool keep1 = !WALK2 && keep;
    w.issue_s(sa, i);
    wgmma_wait<0>();
    fence32(sa);
    int kt = 0;
    for (; kt + 2 < nt; kt += 2, i += 2) {
      w.walk1<true, NORM_P, MASK>(sa, sb, o, pa, row0s, keep1, st, kt, i);
      w.walk1<true, NORM_P, MASK>(sb, sa, o, pa, row0s, keep1, st, kt + 1, i + 1);
    }
    if (kt + 1 < nt) {
      w.walk1<true, NORM_P, MASK>(sa, sb, o, pa, row0s, keep1, st, kt, i);
      w.walk1<false, NORM_P, MASK>(sb, sa, o, pa, row0s, keep1, st, kt + 1, i + 1);
      i += 2;
    } else {
      w.walk1<false, NORM_P, MASK>(sa, sb, o, pa, row0s, keep1, st, kt, i);
      i += 1;
    }
    if constexpr (!NORM_P) {
      wgmma_wait<0>();
      fence32(o);
      w.release(i - 1);
    }
  }
  const float rr0 = r0 < N ? 1.f / st.l0 : 0.f;  // rows past N take no part
  const float rr1 = r1 < N ? 1.f / st.l1 : 0.f;
  if (stats != nullptr && t == 0) {
    // the row max in the logits' own units (-FLT_MAX stays itself)
    if (r0 < N) stats[vec + r0] = make_float2(st.m0 == -FLT_MAX ? st.m0 : st.m0 * LN2, rr0);
    if (r1 < N) stats[vec + r1] = make_float2(st.m1 == -FLT_MAX ? st.m1 : st.m1 * LN2, rr1);
  }
  if constexpr (WALK2) {
    float* cs = csw + (cw * 4 + warp) * L;
    w.issue_s(sa, i);
    wgmma_wait<0>();
    fence32(sa);
    int kt = 0;
    for (; kt + 2 < nt; kt += 2, i += 2) {
      w.walk2<true, NORM_P, MASK, COLSUM>(sa, sb, o, pa, row0s, keep, cs, st, rr0, rr1, kt, i);
      w.walk2<true, NORM_P, MASK, COLSUM>(sb, sa, o, pa, row0s, keep, cs, st, rr0, rr1, kt + 1, i + 1);
    }
    if (kt + 1 < nt) {
      w.walk2<true, NORM_P, MASK, COLSUM>(sa, sb, o, pa, row0s, keep, cs, st, rr0, rr1, kt, i);
      w.walk2<false, NORM_P, MASK, COLSUM>(sb, sa, o, pa, row0s, keep, cs, st, rr0, rr1, kt + 1, i + 1);
      i += 2;
    } else {
      w.walk2<false, NORM_P, MASK, COLSUM>(sa, sb, o, pa, row0s, keep, cs, st, rr0, rr1, kt, i);
      i += 1;
    }
    if constexpr (NORM_P) {
      wgmma_wait<0>();
      fence32(o);
      w.release(i - 1);
    }
  }

  if (row0 != nullptr && qb == 0 && cw == 0 && warp == 0) {
    // row 0 from srow0: walk 2's probabilities, or the kept logits against
    // the final statistics (lane 0's)
    __syncwarp();
    const float m = __shfl_sync(0xffffffffu, st.m0, 0);
    const float r = __shfl_sync(0xffffffffu, rr0, 0);
    for (int c = lane; c < N; c += 32)
      row0[vec + c] = WALK2 ? srow0[c] : ex2(srow0[c] - m) * r;
  }

  // the output tile, rounded, into the warpgroup's query tile (read by no
  // product any more), then one TMA store (rows past N dropped)
  wg_sync(cw);
  uint8_t* otile = tiles + cw * TILE;
  const float f0 = NORM_P ? 1.f : rr0, f1 = NORM_P ? 1.f : rr1;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(otile + pair_offset(lr, j, t)) =
        pack_bf16(o[4 * j] * f0, o[4 * j + 1] * f0);
    *reinterpret_cast<uint32_t*>(otile + pair_offset(lr + 8, j, t)) =
        pack_bf16(o[4 * j + 2] * f1, o[4 * j + 3] * f1);
  }
  fence_async_smem();
  wg_sync(cw);
  if (ct == 0) store_tile(&map_o, h_first & 8, w.sq, qb * WS_ROWS + cw * ROWS, h, b);
  if constexpr (COLSUM) {
    // the block's partial: its active warps' column sums added in order
    asm volatile("bar.sync 3, %0;\n" ::"r"(active * THREADS) : "memory");
    float* dst = part + (vec * gridDim.y) + static_cast<size_t>(qb) * N;
    for (int c = tid - THREADS; c < N; c += active * THREADS) {
      float sum = csw[c];
      for (int x = 1; x < 4 * active; ++x) sum += csw[x * L + c];
      dst[c] = sum;
    }
  }
  if (ct == 0) tma_store_wait();
}

// colsum[b, h, c] = the query blocks' partials part[b, h, 0 .., c] added
// in order: a thread a column.
__global__ void colsum_reduce(const float* __restrict__ part, float* __restrict__ colsum, int N,
                              int blocks, int total) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= total) return;
  const int bh = x / N, c = x % N;
  const float* p = part + static_cast<size_t>(bh) * blocks * N + c;
  float sum = p[0];
  for (int q = 1; q < blocks; ++q) sum += p[static_cast<size_t>(q) * N];
  colsum[x] = sum;
}

// ------------------------------------------------------------ backward
// The base-2 row max of row r from the forward's statistics (-FLT_MAX
// stays itself; +inf past N, so that P is 0 there) and its 1/sum (0 past N).
__device__ __forceinline__ float stats_m2(const float2* stats, size_t vec, int r, int N) {
  if (r >= N) return INFINITY;
  const float m = stats[vec + r].x;
  return m == -FLT_MAX ? m : m * LOG2E;
}
__device__ __forceinline__ float stats_r(const float2* stats, size_t vec, int r, int N) {
  return r < N ? stats[vec + r].y : 0.f;
}

// dQ of one query tile and the tile's delta. MASK: the validity mask's caps
// and dS zeroed at every masked pair. EXACT: delta in full from a first
// pass over the keys (with dcs or dbias); else the shortcut form from O
// and row0. bias, drow0 and dcs may be null (zero); row0 is read with
// drow0 in the shortcut form. delta (fp32 [B, H, N]) is written for
// attention_wide_bwd_dkv.
template <bool MASK, bool EXACT>
__global__ void __launch_bounds__(THREADS, 2)
    attention_wide_bwd_dq(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_o,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_dq, int h_first,
                          const float2* __restrict__ stats, const float* __restrict__ row0,
                          const float* __restrict__ bias, const unsigned char* __restrict__ mask,
                          const float* __restrict__ drow0, const float* __restrict__ dcs,
                          float* __restrict__ delta, int N, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);
  const int nt = tiles_of(N), keys = nt * ROWS;
  const uint32_t sq = base, sdo = sq + TILE, so = sdo + TILE, sring = so + TILE;
  float* bias2 = reinterpret_cast<float*>(tiles + (3 + 2 * RING) * TILE);
  float* cap = bias2 + keys;
  float* sw = cap + keys;   // the row0 cotangent of each key, 0 past N
  float* sc = sw + keys;    // the colsum cotangent of each key, 0 past N
  float* sdel = sc + keys;  // [ROWS] the tile's delta (shortcut form)
  const uint32_t bar = smem_addr(sdel + ROWS), rbar = bar + 8;
  const int bh = blockIdx.x, qi = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t vec = static_cast<size_t>(bh) * N;
  const float c2 = scale * LOG2E;
  const int total = (EXACT ? 2 : 1) * nt;  // the ring's items: K and V of key tile i % nt
  const auto issue = [&](int i) {
    if (i >= total) return;
    const uint32_t dst = sring + (i % RING) * 2 * TILE, rb = rbar + 8 * (i % RING);
    mbar_expect_tx(rb, 2 * TILE);
    load_tile(dst, &map_k, h_first & 2, rb, (i % nt) * ROWS, h, b);
    load_tile(dst + TILE, &map_v, h_first & 4, rb, (i % nt) * ROWS, h, b);
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + RING; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, (EXACT ? 2 : 3) * TILE);
    load_tile(sq, &map_q, h_first & 1, bar, qi * ROWS, h, b);
    load_tile(sdo, &map_do, h_first & 16, bar, qi * ROWS, h, b);
    if (!EXACT) load_tile(so, &map_o, h_first & 8, bar, qi * ROWS, h, b);
    for (int i = 0; i < RING; ++i) issue(i);
  }
  for (int j = tid; j < keys; j += THREADS) {
    bias2[j] = j < N ? (bias != nullptr ? bias[static_cast<size_t>(b) * N + j] * LOG2E : 0.f)
                     : -INFINITY;
    if (MASK) cap[j] = j < N && mask[static_cast<size_t>(b) * N + j] ? INFINITY : -FLT_MAX;
    sw[j] = drow0 != nullptr && j < N ? drow0[vec + j] : 0.f;
    sc[j] = dcs != nullptr && j < N ? dcs[vec + j] : 0.f;
  }
  const int lr = warp * 16 + g, r0 = qi * ROWS + lr, r1 = r0 + 8;
  const float m0 = stats_m2(stats, vec, r0, N), m1 = stats_m2(stats, vec, r1, N);
  const float i0 = stats_r(stats, vec, r0, N), i1 = stats_r(stats, vec, r1, N);
  float r0dot = 0.f;  // row0 . drow0, the row0 cotangent's part of delta_0
  if (!EXACT && qi == 0 && warp == 0 && drow0 != nullptr) {
    for (int j = lane; j < N; j += 32) r0dot += row0[vec + j] * drow0[vec + j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) r0dot += __shfl_xor_sync(0xffffffffu, r0dot, off);
  }
  mbar_wait(bar, 0);
  if constexpr (!EXACT) {
    // delta_i = rowsum(dO_i * O_i) (+ row0 . drow0 on row 0): 8 lanes a
    // row, 16 bytes a lane, from the swizzled tiles (rows past N are zeros)
    for (int i = tid >> 3; i < ROWS; i += THREADS / 8) {
      const int c = tid & 7;
      const uint32_t at = i * 128 + ((c ^ (i & 7)) << 4);
      const uint4 ov = *reinterpret_cast<const uint4*>(tiles + 2 * TILE + at);
      const uint4 dv = *reinterpret_cast<const uint4*>(tiles + TILE + at);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
        acc = fmaf(of.x, df.x, acc);
        acc = fmaf(of.y, df.y, acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      acc += __shfl_xor_sync(0xffffffffu, acc, 4);
      if (c == 0) sdel[i] = acc + (qi * ROWS + i == 0 ? r0dot : 0.f);
    }
  }
  __syncthreads();
  const float qc0 = MASK ? cap[r0] : INFINITY, qc1 = MASK ? cap[r1] : INFINITY;

  // P and dP (with both cotangents) of the tile in the ring's stage at sk:
  // S = Q K^T and dP = dO V^T on wgmma, then p = ex2(x - row max) / sum
  const auto probs = [&](uint32_t sk, int k0, float* p, float* dp) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wgmma_ss<0, 0>(p, desc_k(sq, kk), desc_k(sk, kk), kk);
      wgmma_ss<0, 0>(dp, desc_k(sdo, kk), desc_k(sk + TILE, kk), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence32(p);
    fence32(dp);
    tile_logits<MASK>(p, bias2, cap, qc0, qc1, k0, t, c2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = k0 + 8 * j + 2 * t;
      float* x = p + 4 * j;
      x[0] = ex2(x[0] - m0) * i0;
      x[1] = ex2(x[1] - m0) * i0;
      x[2] = ex2(x[2] - m1) * i1;
      x[3] = ex2(x[3] - m1) * i1;
      if (k0 + 8 * j < N) {
        const float2 w = *reinterpret_cast<const float2*>(sw + c);
        const float2 dc = *reinterpret_cast<const float2*>(sc + c);
        float* d = dp + 4 * j;
        if (r0 == 0) d[0] += w.x, d[1] += w.y;  // the row0 cotangent, query 0
        if (r0 < N) d[0] += dc.x, d[1] += dc.y;  // the colsum one, valid rows
        if (r1 < N) d[2] += dc.x, d[3] += dc.y;
      }
    }
  };

  int item = 0;
  float d0, d1;
  if constexpr (EXACT) {
    // delta_i = sum_j P_ij dP_ij, over the key tiles in order
    float a0 = 0.f, a1 = 0.f;
    for (int kt = 0; kt < nt; ++kt, ++item) {
      const uint32_t sk = sring + (item % RING) * 2 * TILE;
      mbar_wait(rbar + 8 * (item % RING), (item / RING) & 1);
      float p[32], dp[32];
      probs(sk, kt * ROWS, p, dp);
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        l0 += p[4 * j] * dp[4 * j] + p[4 * j + 1] * dp[4 * j + 1];
        l1 += p[4 * j + 2] * dp[4 * j + 2] + p[4 * j + 3] * dp[4 * j + 3];
      }
      a0 += quad_sum(l0);
      a1 += quad_sum(l1);
      __syncthreads();
      if (tid == 0) issue(item + RING);
    }
    d0 = a0;
    d1 = a1;
  } else {
    d0 = sdel[lr];
    d1 = sdel[lr + 8];
  }
  if (t == 0) {
    if (r0 < N) delta[vec + r0] = d0;
    if (r1 < N) delta[vec + r1] = d1;
  }

  // dQ = round(dS) K over the key tiles, dS = P (dP - delta) * scale
  float dq[32];
  for (int kt = 0; kt < nt; ++kt, ++item) {
    const uint32_t sk = sring + (item % RING) * 2 * TILE;
    mbar_wait(rbar + 8 * (item % RING), (item / RING) & 1);
    float p[32], dp[32];
    probs(sk, kt * ROWS, p, dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float u = p[4 * j + e] * (dp[4 * j + e] - (e < 2 ? d0 : d1));
        if constexpr (MASK) {  // dS is zero at a masked pair
          const int c = kt * ROWS + 8 * j + 2 * t + (e & 1);
          if (!(cap[c] > 0.f && (e < 2 ? qc0 : qc1) > 0.f)) u = 0.f;
        }
        dp[4 * j + e] = u * scale;
      }
    }
    uint32_t da[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) da[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    fence16(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // (keys past N: dS and K are 0)
      wgmma_rs<1>(dq, da + 4 * kk, desc_mn(sk, kk), kt + kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence32(dq);
    __syncthreads();
    if (tid == 0) issue(item + RING);
  }
  // dQ, rounded, into the query tile (read by no product any more), then
  // a TMA store (rows past N dropped)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<uint32_t*>(tiles + pair_offset(lr, j, t)) = pack_bf16(dq[4 * j], dq[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(tiles + pair_offset(lr + 8, j, t)) =
        pack_bf16(dq[4 * j + 2], dq[4 * j + 3]);
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    store_tile(&map_dq, h_first & 32, sq, qi * ROWS, h, b);
    tma_store_wait();
  }
}

// dK, dV and dbias of one key tile from the delta of attention_wide_bwd_dq:
// the query tiles' Q and dO stream through the ring. MASK as there; bias,
// drow0, dcs (zero) and dbias (not written) may be null.
template <bool MASK>
__global__ void __launch_bounds__(THREADS, 2)
    attention_wide_bwd_dkv(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const __grid_constant__ CUtensorMap map_dk,
                           const __grid_constant__ CUtensorMap map_dv, int h_first,
                           const float2* __restrict__ stats, const float* __restrict__ bias,
                           const unsigned char* __restrict__ mask,
                           const float* __restrict__ drow0, const float* __restrict__ dcs,
                           const float* __restrict__ delta, float* __restrict__ dbias, int N,
                           int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);
  const int nt = tiles_of(N), keys = nt * ROWS;
  // the key tile's K and V, then stage i's Q tile at sring + 2 i TILE and
  // its dO tile after it
  const uint32_t sk = base, sv = sk + TILE, sring = sv + TILE;
  float* sm2 = reinterpret_cast<float*>(tiles + (2 + 2 * RING) * TILE);  // +inf past N
  float* sr = sm2 + keys;   // 1/sum, 0 past N
  float* sd = sr + keys;    // delta
  float* cap = sd + keys;   // the tokens' caps (MASK)
  const uint32_t bar = smem_addr(cap + keys), rbar = bar + 8;
  const int bh = blockIdx.x, jt = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t vec = static_cast<size_t>(bh) * N;
  const float c2 = scale * LOG2E;
  const auto issue = [&](int i) {  // the Q and dO tiles of query tile i
    if (i >= nt) return;
    const uint32_t dst = sring + (i % RING) * 2 * TILE, rb = rbar + 8 * (i % RING);
    mbar_expect_tx(rb, 2 * TILE);
    load_tile(dst, &map_q, h_first & 1, rb, i * ROWS, h, b);
    load_tile(dst + TILE, &map_do, h_first & 8, rb, i * ROWS, h, b);
  };

  if (tid == 0) {
    for (int i = 0; i < 1 + RING; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * TILE);
    load_tile(sk, &map_k, h_first & 2, bar, jt * ROWS, h, b);
    load_tile(sv, &map_v, h_first & 4, bar, jt * ROWS, h, b);
    for (int i = 0; i < RING; ++i) issue(i);
  }
  for (int j = tid; j < keys; j += THREADS) {
    sm2[j] = stats_m2(stats, vec, j, N);
    sr[j] = stats_r(stats, vec, j, N);
    sd[j] = j < N ? delta[vec + j] : 0.f;
    if (MASK) cap[j] = j < N && mask[static_cast<size_t>(b) * N + j] ? INFINITY : -FLT_MAX;
  }
  // this thread's keys j0 = jt * 64 + g and j1 = j0 + 8 of its warp's 16
  const int lr = warp * 16 + g, j0 = jt * ROWS + lr, j1 = j0 + 8;
  const auto key_bias = [&](int j) {
    return j < N ? (bias != nullptr ? bias[static_cast<size_t>(b) * N + j] * LOG2E : 0.f)
                 : -INFINITY;
  };
  const auto key_vec = [&](const float* x, int j) { return x != nullptr && j < N ? x[vec + j] : 0.f; };
  const float kb0 = key_bias(j0), kb1 = key_bias(j1);
  const float w0 = key_vec(drow0, j0), w1 = key_vec(drow0, j1);
  const float dc0 = key_vec(dcs, j0), dc1 = key_vec(dcs, j1);
  __syncthreads();
  const float kc0 = MASK ? cap[j0] : INFINITY, kc1 = MASK ? cap[j1] : INFINITY;
  mbar_wait(bar, 0);

  float dk[32], dv[32], db0 = 0.f, db1 = 0.f;
  for (int it = 0; it < nt; ++it) {
    const uint32_t sq = sring + (it % RING) * 2 * TILE, sdo = sq + TILE;
    mbar_wait(rbar + 8 * (it % RING), (it / RING) & 1);
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {  // S^T = K Q^T, dP^T = V dO^T
      wgmma_ss<0, 0>(st, desc_k(sk, kk), desc_k(sq, kk), kk);
      wgmma_ss<0, 0>(dpt, desc_k(sv, kk), desc_k(sdo, kk), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence32(st);
    fence32(dpt);
    probs_t<MASK>(st, it * ROWS, N, c2, kb0, kb1, kc0, kc1, sm2, sr, cap, t);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (it * ROWS + 8 * jj < N) {
        const int c = it * ROWS + 8 * jj + 2 * t;
        const float2 d = *reinterpret_cast<const float2*>(sd + c);
        float dp[4] = {dpt[4 * jj], dpt[4 * jj + 1], dpt[4 * jj + 2], dpt[4 * jj + 3]};
        if (c == 0) dp[0] += w0, dp[2] += w1;  // the row0 cotangent, query 0
        if (c < N) dp[0] += dc0, dp[2] += dc1;  // the colsum one, valid rows
        if (c + 1 < N) dp[1] += dc0, dp[3] += dc1;
        float u[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) u[e] = st[4 * jj + e] * (dp[e] - ((e & 1) ? d.y : d.x));
        if constexpr (MASK) {  // dS is zero at a masked pair
          const float2 qc = *reinterpret_cast<const float2*>(cap + c);
          if (!(kc0 > 0.f && qc.x > 0.f)) u[0] = 0.f;
          if (!(kc0 > 0.f && qc.y > 0.f)) u[1] = 0.f;
          if (!(kc1 > 0.f && qc.x > 0.f)) u[2] = 0.f;
          if (!(kc1 > 0.f && qc.y > 0.f)) u[3] = 0.f;
        }
        db0 += u[0] + u[1];
        db1 += u[2] + u[3];
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[4 * jj + e] = u[e] * scale;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dpt[4 * jj + e] = 0.f;
      }
    }
    // dV += round(P)^T dO and dK += round(dS)^T Q, A from registers (rows
    // past N: P, dS, Q and dO are 0)
    uint32_t pa[16], da[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      pa[i] = pack_bf16(st[2 * i], st[2 * i + 1]);
      da[i] = pack_bf16(dpt[2 * i], dpt[2 * i + 1]);
    }
    fence16(pa);
    fence16(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int acc = it > 0 || kk > 0;
      wgmma_rs<1>(dv, pa + 4 * kk, desc_mn(sdo, kk), acc);
      wgmma_rs<1>(dk, da + 4 * kk, desc_mn(sq, kk), acc);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence32(dv);
    fence32(dk);
    __syncthreads();
    if (tid == 0) issue(it + RING);
  }
  if (dbias != nullptr) {
    db0 = quad_sum(db0);
    db1 = quad_sum(db1);
    if (t == 0) {
      if (j0 < N) dbias[vec + j0] = db0;
      if (j1 < N) dbias[vec + j1] = db1;
    }
  }
  // dK and dV, rounded, into the K and V tiles (read by no product any
  // more), then TMA stores (rows past N dropped)
  uint8_t* ktile = tiles;
  uint8_t* vtile = tiles + TILE;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    *reinterpret_cast<uint32_t*>(ktile + pair_offset(lr, jj, t)) = pack_bf16(dk[4 * jj], dk[4 * jj + 1]);
    *reinterpret_cast<uint32_t*>(ktile + pair_offset(lr + 8, jj, t)) =
        pack_bf16(dk[4 * jj + 2], dk[4 * jj + 3]);
    *reinterpret_cast<uint32_t*>(vtile + pair_offset(lr, jj, t)) = pack_bf16(dv[4 * jj], dv[4 * jj + 1]);
    *reinterpret_cast<uint32_t*>(vtile + pair_offset(lr + 8, jj, t)) =
        pack_bf16(dv[4 * jj + 2], dv[4 * jj + 3]);
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    store_tile(&map_dk, h_first & 16, sk, jt * ROWS, h, b);
    store_tile(&map_dv, h_first & 32, sv, jt * ROWS, h, b);
    tma_store_wait();
  }
}

}  // namespace
}  // namespace trk

// Returns the cudaError_t of the launches (0 on success). The contract of
// attention_sm90.cu's tr_attention_sm90 (q, k, v [B, H, N, 64], out
// [B, H, M, 64], strides, bias, mask, ids, row0, colsum, stats, norm_p),
// for N and M up to 2048, with `part` (fp32 [B, H, ceil(N / 128), N],
// contiguous) the scratch of colsum's partial sums: needed with colsum
// (then two launches: the forward and colsum_reduce), else null.
extern "C" int tr_attention_wide_sm90(const void* q, const void* k, const void* v, void* out,
                                      const long long* strides, const void* bias, const void* mask,
                                      const void* ids, void* row0, void* colsum, void* stats,
                                      void* part, int B, int N, int M, int H, float scale,
                                      int norm_p, void* stream) {
  using namespace trk;
  const bool rect = ids != nullptr;
  if (N < 1 || N > WIDE_MAXN || M < 1 || M > WIDE_MAXN || H < 1 || B < 0 ||
      (!rect && (M != N || (colsum != nullptr) != (part != nullptr))) ||
      (rect && (mask == nullptr || bias != nullptr || row0 != nullptr || colsum != nullptr ||
                stats != nullptr || part != nullptr || norm_p)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const auto rect_kernel = attention_wide_rect;
  using WsKernel = decltype(&attention_wide_fwd_ws<false, false, false>);
  const WsKernel variants[2][2][2] = {
      {{attention_wide_fwd_ws<false, false, false>, attention_wide_fwd_ws<false, false, true>},
       {attention_wide_fwd_ws<false, true, false>, attention_wide_fwd_ws<false, true, true>}},
      {{attention_wide_fwd_ws<true, false, false>, attention_wide_fwd_ws<true, false, true>},
       {attention_wide_fwd_ws<true, true, false>, attention_wide_fwd_ws<true, true, true>}}};
  const WsKernel kernel = variants[norm_p != 0][mask != nullptr][colsum != nullptr];
  // first: the context the tensor maps need (sm90.cuh encoder)
  cudaError_t err =
      rect ? cudaFuncSetAttribute(rect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(wide_rect_smem(WIDE_MAXN)))
           : cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(wide_ws_smem(WIDE_MAXN)));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[4];
  const void* ptrs[3] = {q, k, v};
  int h_first;
  err = heads_maps(maps, ptrs, strides, 3, B, H, N, &h_first);
  if (err != cudaSuccess) return static_cast<int>(err);
  bool ho;
  err = heads_map(&maps[3], out, strides + 9, B, H, M, &ho);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hf = (h_first & 7) | static_cast<int>(ho) << 3;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rect) {
    const RowIds ga{static_cast<const bf16*>(q), strides[0], strides[1], strides[2],
                    static_cast<const int*>(ids)};
    rect_kernel<<<B * H, THREADS, wide_rect_smem(N), s>>>(
        maps[1], maps[2], maps[3], hf, static_cast<const unsigned char*>(mask), ga, N, M, H,
        scale);
    return static_cast<int>(cudaGetLastError());
  }
  kernel<<<dim3(B * H, ws_blocks(N)), WS_THREADS, wide_ws_smem(N), s>>>(
      maps[0], maps[1], maps[2], maps[3], hf, static_cast<const float*>(bias),
      static_cast<const unsigned char*>(mask), static_cast<float*>(row0),
      static_cast<float*>(part), static_cast<float2*>(stats), N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || colsum == nullptr) return static_cast<int>(err);
  const int total = B * H * N;
  colsum_reduce<<<(total + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part),
                                                     static_cast<float*>(colsum), N,
                                                     ws_blocks(N), total);
  return static_cast<int>(cudaGetLastError());
}

// Returns the cudaError_t of the launches (0 on success). The contract of
// attention_sm90.cu's tr_attention_bwd_sm90 for N up to 2048, with delta
// (fp32 [B, H, N], contiguous) the scratch that the dQ launch writes and
// the dK, dV launch reads.
extern "C" int tr_attention_wide_bwd_sm90(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, void* dq, void* dk,
                                          void* dv, const long long* strides, const void* stats,
                                          const void* row0, const void* bias, const void* mask,
                                          const void* drow0, const void* dcs, void* dbias,
                                          void* delta, int B, int N, int H, float scale,
                                          void* stream) {
  using namespace trk;
  const bool exact = dcs != nullptr || dbias != nullptr;
  if (N < 1 || N > WIDE_MAXN || H < 1 || B < 0 || stats == nullptr || delta == nullptr ||
      out == nullptr || (!exact && drow0 != nullptr && row0 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  using DqKernel = decltype(&attention_wide_bwd_dq<false, false>);
  const DqKernel dq_variants[2][2] = {
      {attention_wide_bwd_dq<false, false>, attention_wide_bwd_dq<false, true>},
      {attention_wide_bwd_dq<true, false>, attention_wide_bwd_dq<true, true>}};
  const DqKernel dq_kernel = dq_variants[mask != nullptr][exact];
  const auto dkv_kernel =
      mask != nullptr ? attention_wide_bwd_dkv<true> : attention_wide_bwd_dkv<false>;
  // first: the context the tensor maps need (sm90.cuh encoder)
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(wide_dq_smem(WIDE_MAXN)));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(wide_dkv_smem(WIDE_MAXN)));
  if (err != cudaSuccess) return static_cast<int>(err);
  // q, k, v, out, dout, dq, dk, dv
  CUtensorMap maps[8];
  const void* ptrs[8] = {q, k, v, out, dout, dq, dk, dv};
  int h_first;
  err = heads_maps(maps, ptrs, strides, 8, B, H, N, &h_first);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H, tiles_of(N));
  dq_kernel<<<grid, THREADS, wide_dq_smem(N), s>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      h_first & 63, static_cast<const float2*>(stats),
      static_cast<const float*>(row0), static_cast<const float*>(bias),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(drow0),
      static_cast<const float*>(dcs), static_cast<float*>(delta), N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the dK, dV launch's maps: q, k, v, dout, dk, dv as bits 0-5
  const int hf = (h_first & 7) | ((h_first >> 4) & 1) << 3 | ((h_first >> 6) & 3) << 4;
  dkv_kernel<<<grid, THREADS, wide_dkv_smem(N), s>>>(
      maps[0], maps[1], maps[2], maps[4], maps[6], maps[7], hf,
      static_cast<const float2*>(stats), static_cast<const float*>(bias),
      static_cast<const unsigned char*>(mask), static_cast<const float*>(drow0),
      static_cast<const float*>(dcs), static_cast<const float*>(delta),
      static_cast<float*>(dbias), N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block of each wide kernel takes at n keys,
// for the host: out[4] = {square forward (384 threads), rectangular forward,
// dQ, dK and dV (128 threads)}.
extern "C" int tr_attention_wide_smem(int n, int* out) {
  if (n < 1 || n > trk::WIDE_MAXN) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = static_cast<int>(trk::wide_ws_smem(n));
  out[1] = static_cast<int>(trk::wide_rect_smem(n));
  out[2] = static_cast<int>(trk::wide_dq_smem(n));
  out[3] = static_cast<int>(trk::wide_dkv_smem(n));
  return 0;
}
