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
// from the packed qkv [B, N, 3 D] (timm's (3, H, 64) column order), with
// the main path's recipe (attention_sm90.cuh): logits in base-2 units
// (q.k * scale * log2 e, -inf past N), ex2 less the exact row max, p = e *
// (1 / sum) rounded to bf16. Every product is a wgmma; every q, k and v
// tile comes by TMA on a 4-D map [B][N][H][64] of the packed qkv (a box
// past N reads zeros, never the next image's rows) under mbarriers, with
// the 128-byte swizzle the descriptors read; each output tile leaves by a
// TMA store on such a map of merged. The arrangements compute the same
// function:
//
// - loop: a block of one warpgroup per (image, head), the main path's
//   forward steps (attention_fwd_tiles, NORM_P, no bias, mask or
//   by-product) as their own instance: S = Q K^T on wgmma m64n64k16 with
//   the whole row of at most 256 keys in registers, the exact softmax
//   there (row_exp), P as the register A operand of O = P V (V read
//   MN-major). Two blocks an SM.
// - avpair: a block per (image, head pair); each pair's value product is
//   [P_h | P_h+1] . blockdiag(V_h, V_h+1) into one 64 x 128 fp32
//   accumulator on wgmma m64n128k16, the zero blocks really multiplied: the
//   question the tool asks, whether a 128-wide product of two heads beats
//   two 64-wide ones once the zeros are paid for. It runs as its two K
//   halves into the one accumulator, P_h . [V_h | 0] then P_h+1 .
//   [0 | V_h+1] (the same sum): each head's S in registers in turn, its
//   rounded P kept as A fragments, then the pair's 2 x 16 products on one
//   accumulator. Each B operand is a value tile and one zero tile of the
//   block's shared memory, read by one descriptor (desc_pair: the second
//   64 columns at its leading byte offset). Two heads' q, k and v tiles and
//   the zero tile take 200 KB at N > 192: one block an SM, of two
//   warpgroups that take the query tiles in turn, so that one's softmax
//   runs beside the other's products.
// - stacked: a block per (image, 16 query rows); the logits of all H heads
//   for those rows go into one fp32 buffer [16 H][KP + 16] in shared
//   memory (KP = N rounded up to 64), one softmax pass runs over its 16 H
//   rows (a warp two rows of a head, 8 keys a lane), and the value
//   products read the rounded probabilities back. Layout: at 64 query rows
//   the buffer would take 6 x 64 x 272 x 4 B = 418 KB, over a block's 227
//   KB, so a block keeps 16 rows (102 KB) and runs both products
//   transposed, with the keys or the head dim as wgmma's 64 rows and the
//   queries as its n: S_h^T = K_h Q_h^T (m64n16k16, a key tile a product,
//   the key tiles shared between two warpgroups) and O_h^T = V_h^T P_h^T
//   (m64n8k16, a warpgroup 8 of the 16 queries; V read MN-major as A; B =
//   P_h^T, the softmax pass's bf16 rows written K-major in 16 x 64 boxes
//   with the 128-byte swizzle, over head h's logits once the pass has read
//   them: a head's rows take a multiple of 1024 bytes). The query rows come
//   in 16-row TMA boxes per head, the keys and then the values of the
//   heads one head at a time through a ring of three slots (the next two
//   heads' tiles load while this head's products run; two slots at N = 65
//   .. 128, where 99 KB let two blocks share an SM), and each head's output
//   leaves through its query box by a 16-row TMA store. One block an SM at
//   N > 128 (211 KB at N > 192, H = 6).
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
// kernel tool attn_joint.cu measures the qkv product made on chip).
//
// What bounds it. The function (both products, the attention, x in and out)
// at B = 256, N = 197, D = 384: 8 B N D^2 + 4 B N^2 D operations, 7.48e10,
// against about 79 MB of bytes: operations. This launch alone does 4 B N^2
// D of them (avpair's zero blocks double its value products) from the 58 MB
// qkv tensor, on 64-row tiles padded from 197 to 256; at 64 query rows a
// block (loop, avpair) the exponentials and the serial chain of S, softmax,
// P V in a warpgroup set its pace, two blocks an SM (loop) hiding each
// other's chain. avpair holds a head's row of S, or both heads' P, beside
// its wide products: at 255 registers ptxas spills and serialises them.
// Stacked reads every head's keys and values once per 16 query rows, 13
// times an image at N = 197 (1.3 GB from L2), and its n = 16 and n = 8
// products run the tensor cores at a fraction of their width.
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_sm90.cuh"

namespace trk {
namespace {

enum ProtoVariant : int { kLoop = 0, kAvpair = 1, kStacked = 2 };

constexpr int kSmemMax = 232448;        // the H100's 227 KB a block
constexpr int QROWS = 16;               // stacked: the query rows of a block
constexpr int QBOX = QROWS * HD * 2;    // 16 rows of one head, 2 KB

constexpr int RING = 3;                 // stacked: slots of one head's keys or values

// stacked's ring: two slots at two key tiles (N = 65 .. 128), where that
// lets two blocks share an SM, else three
__host__ __device__ constexpr int ring_slots(int nt) { return nt == 2 ? 2 : RING; }

// fp32 row stride of the stacked logits: a head's 16 rows take a multiple
// of 1024 bytes, so that its P^T boxes (128-byte swizzle) can be written
// over them, from their start, once the softmax pass has read them
__host__ __device__ constexpr int stacked_ld(int kp) { return kp + 16; }

// loop: q, k, v tiles; bias2, caps [MAXN]; 3 barriers. avpair: two heads'
// q and k tiles, the first head's v tiles, a zero tile, the second head's
// v tiles; bias2, caps; 3 barriers. stacked: ring_slots(nt) slots of nt
// tiles; the query rows, H boxes; the logits [16 H][ld], each head's rows
// then its P^T boxes; RING + 1 barriers. Each with 1 KB to align the tiles
// to the swizzle's 1024.
__host__ __device__ int proto_smem(int nt, int H, int variant) {
  return variant == kLoop     ? 1024 + 3 * nt * TILE + 2 * MAXN * 4 + 3 * 8
         : variant == kAvpair ? 1024 + (6 * nt + 1) * TILE + 2 * MAXN * 4 + 3 * 8
                              : 1024 + ring_slots(nt) * nt * TILE + H * QBOX +
                                    QROWS * H * stacked_ld(ROWS * nt) * 4 + (RING + 1) * 8;
}

using bf16 = __nv_bfloat16;

// Thread 0: head h's tiles by TMA, query tile 0 and the keys on bars, the
// values on bars + 8, the other query tiles on bars + 16, as
// attention_fwd_tiles waits for them; each barrier takes one arrival a head.
__device__ __forceinline__ void load_head(uint32_t sq, uint32_t sk, uint32_t sv, uint32_t bars,
                                          const CUtensorMap* mq, const CUtensorMap* mk,
                                          const CUtensorMap* mv, int h_first, int h, int b,
                                          int nt) {
  mbar_expect_tx(bars, (1 + nt) * TILE);
  load_tile(sq, mq, h_first & 1, bars, 0, h, b);
  for (int i = 0; i < nt; ++i) load_tile(sk + i * TILE, mk, h_first & 2, bars, i * ROWS, h, b);
  mbar_expect_tx(bars + 8, nt * TILE);
  for (int i = 0; i < nt; ++i) load_tile(sv + i * TILE, mv, h_first & 4, bars + 8, i * ROWS, h, b);
  mbar_expect_tx(bars + 16, (nt - 1) * TILE);
  for (int i = 1; i < nt; ++i) load_tile(sq + i * TILE, mq, h_first & 1, bars + 16, i * ROWS, h, b);
}

// Thread 0: n barriers from bars on, `count` arrivals each; then the block
// waits for them.
__device__ __forceinline__ void init_bars(uint32_t bars, int n, int count) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(bars + 8 * i, count);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// -------------------------------------------------------------------- loop
__global__ void __launch_bounds__(THREADS, 2)
    proto_loop_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_o, int h_first, int N, int H,
                      float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);
  const int nt = tiles_of(N);
  const uint32_t sq = base, sk = sq + nt * TILE, sv = sk + nt * TILE;
  float* bias2 = reinterpret_cast<float*>(tiles + 3 * nt * TILE);
  float* cap = bias2 + MAXN;
  const uint32_t bars = smem_addr(cap + MAXN);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  init_bars(bars, 3, 1);
  if (tid == 0) load_head(sq, sk, sv, bars, &map_q, &map_k, &map_v, h_first, h, b, nt);
  key_vectors(bias2, cap, nullptr, nullptr, b, N);
  __syncthreads();
  mbar_wait(bars, 0);
  // (no colsum: the column sums' buffer is not touched)
  attention_fwd_tiles<true, false, false, MAXT>(sq, sk, sv, bars, bias2, cap, cap, cap, &map_o,
                                                h_first & 8, nullptr, nullptr, nullptr, N, N, nt,
                                                nt, bh, h, b, tid, warp, lane, g, t, scale);
}

// ------------------------------------------------------------------ avpair
constexpr int PAIR_THREADS = 2 * THREADS;  // two warpgroups, a query tile each

__global__ void __launch_bounds__(PAIR_THREADS, 1)
    proto_avpair_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_o, int h_first, int N, int H,
                        float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);
  const int nt = tiles_of(N);
  // each B operand [V_h | 0] or [0 | V_h+1] reads its second half at a
  // positive offset from its first: V_h's tiles, the zero tile, V_h+1's
  const uint32_t sq0 = base, sk0 = sq0 + nt * TILE, sq1 = sk0 + nt * TILE, sk1 = sq1 + nt * TILE;
  const uint32_t sv0 = sk1 + nt * TILE, sz = sv0 + nt * TILE, sv1 = sz + TILE;
  float* bias2 = reinterpret_cast<float*>(tiles + (6 * nt + 1) * TILE);
  float* cap = bias2 + MAXN;
  const uint32_t bars = smem_addr(cap + MAXN);
  const int pairs = H / 2, b = blockIdx.x / pairs, h0 = 2 * (blockIdx.x % pairs);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3, lr = warp * 16 + g;

  init_bars(bars, 3, 2);
  if (tid == 0) {
    load_head(sq0, sk0, sv0, bars, &map_q, &map_k, &map_v, h_first, h0, b, nt);
    load_head(sq1, sk1, sv1, bars, &map_q, &map_k, &map_v, h_first, h0 + 1, b, nt);
  }
  for (int i = tid; i < TILE / 16; i += PAIR_THREADS)
    reinterpret_cast<uint4*>(tiles + (sz - base))[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_async_smem();  // the zero tile into the async proxy, for the wgmmas
  if (wg == 0) key_vectors(bias2, cap, nullptr, nullptr, b, N);
  __syncthreads();
  mbar_wait(bars, 0);
  const float c2 = scale * LOG2E;
  // warpgroup wg takes query tiles wg, wg + 2, ...: the two hide each
  // other's softmax behind their products
  for (int qi = wg; qi < nt; qi += 2) {
    if (qi > 0) mbar_wait(bars + 16, 0);
    const bool live = qi * ROWS + warp * 16 < N;  // the warp has a query row
    // both heads' P first, rounded into the A fragments (64 registers a
    // head), then the pair's value products into one accumulator: the
    // accumulator is not held beside the second head's row of S
    uint32_t pa[2][MAXT][16];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t sq = hh ? sq1 : sq0, sk = hh ? sk1 : sk0;
      float s[MAXT][32];
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < MAXT; ++kt)
        if (kt < nt)
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss<0, 0>(s[kt], desc_k(sq + qi * TILE, kk), desc_k(sk + kt * TILE, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kt = 0; kt < MAXT; ++kt) fence32(s[kt]);
      if (live) {
        float mx0, mx1, sum0, sum1;
        row_exp<false, MAXT>(s, bias2, cap, INFINITY, INFINITY, N, nt, t, c2, mx0, mx1, sum0,
                             sum1);
        const float rr0 = 1.f / sum0, rr1 = 1.f / sum1;
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
#pragma unroll
      for (int kt = 0; kt < MAXT; ++kt)
#pragma unroll
        for (int i = 0; i < 16; ++i) pa[hh][kt][i] = pack_bf16(s[kt][2 * i], s[kt][2 * i + 1]);
#pragma unroll
      for (int kt = 0; kt < MAXT; ++kt) fence16(pa[hh][kt]);
    }
    if (qi == wg) mbar_wait(bars + 8, 0);  // the values have landed
    // [O_h0 | O_h0+1] = P_h0 . [V_h0 | 0] + P_h0+1 . [0 | V_h0+1], 16 keys a
    // step up to the last step with a key < N
    float o[64];
    wgmma_fence();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int kt = 0; kt < MAXT; ++kt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kt < nt && kt * ROWS + 16 * kk < N)
            wgmma_rs128<1>(o, o + 32, pa[hh][kt] + 4 * kk,
                           hh == 0 ? desc_pair(sv0 + kt * TILE, sz, kk)
                                   : desc_pair(sz, sv1 + kt * TILE, kk),
                           hh + kt + kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence32(o);
    fence32(o + 32);
    // the two heads' output tiles, rounded, into their query tiles' shared
    // memory (read by no product any more), then TMA stores (rows past N
    // dropped)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint8_t* otile = tiles + ((hh ? sq1 : sq0) - base) + qi * TILE;
      const float* d = o + 32 * hh;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        *reinterpret_cast<uint32_t*>(otile + pair_offset(lr, j, t)) =
            pack_bf16(d[4 * j], d[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(otile + pair_offset(lr + 8, j, t)) =
            pack_bf16(d[4 * j + 2], d[4 * j + 3]);
      }
    }
    fence_async_smem();
    wg_sync(wg);
    if (wt == 0) {
      store_tile(&map_o, h_first & 8, sq0 + qi * TILE, qi * ROWS, h0, b);
      store_tile(&map_o, h_first & 8, sq1 + qi * TILE, qi * ROWS, h0 + 1, b);
    }
  }
  if (wt == 0) tma_store_wait();
}

// ----------------------------------------------------------------- stacked
#define TRK_ACC8                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7])

// d[64 x 16] = A[64 x 16] . B[16 x 16] (+ d when acc is non-zero), both from
// shared memory (TA: A MN-major); the accumulator layout of wgmma_ss with
// two 8-column groups.
template <int TA>
__device__ __forceinline__ void wgmma_ss16(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %11, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %10, 0;\n"
      "}\n"
      : TRK_ACC8
      : "l"(da), "l"(db), "n"(TA), "r"(acc));
}

// The same 8 columns wide: d[4], a thread's rows g and g + 8 of its warp's
// 16, columns 2 t and 2 t + 1.
template <int TA>
__device__ __forceinline__ void wgmma_ss8(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %7, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %6, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "n"(TA), "r"(acc));
}

template <int K>
__device__ __forceinline__ void fence_n(float* d) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
#undef TRK_ACC8

// Item i of the ring of `slots` slots (thread 0): head i's key tiles (i <
// H), else head i - H's value tiles, into slot i % slots on its full
// barrier (bars + 8 + 8 slot).
__device__ __forceinline__ void load_item(int i, int slots, uint32_t ring, uint32_t bars,
                                          const CUtensorMap* mk, const CUtensorMap* mv,
                                          int h_first, int H, int b, int nt) {
  const int slot = i % slots;
  const uint32_t full = bars + 8 + 8 * slot;
  const bool keys = i < H;
  mbar_expect_tx(full, nt * TILE);
  for (int kt = 0; kt < nt; ++kt)
    load_tile(ring + (slot * nt + kt) * TILE, keys ? mk : mv, h_first & (keys ? 2 : 4), full,
              kt * ROWS, keys ? i : i - H, b);
}

constexpr int STACK_THREADS = 2 * THREADS;  // two warpgroups

// SLOTS: the ring's slots, ring_slots(nt)
template <int SLOTS>
__global__ void __launch_bounds__(STACK_THREADS, 1)
    proto_stacked_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_o, int h_first, int N, int H,
                         float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);
  const int nt = tiles_of(N), kp = nt * ROWS, ld = stacked_ld(kp);
  const int qtiles = (N + QROWS - 1) / QROWS;
  const int b = blockIdx.x / qtiles, q0 = QROWS * (blockIdx.x % qtiles);
  constexpr int slots = SLOTS;
  const uint32_t ring = base;                     // the slots of nt tiles
  const uint32_t sqr = ring + slots * nt * TILE;  // head h's query rows, then its output
  const uint32_t slg = sqr + H * QBOX;           // the logits; P_h^T over head h's rows
  float* logits = reinterpret_cast<float*>(tiles + (slg - base));  // [16 H][ld]
  const uint32_t hreg = QROWS * ld * 4;          // a head's rows, bytes (1024 | hreg)
  const uint32_t bars = slg + H * hreg;
  const int tid = threadIdx.x, wg = tid >> 7, w8 = tid >> 5;
  const int warp = w8 & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float c2 = scale * LOG2E;
  const int items = 2 * H;  // every head's keys, then every head's values

  // bars: the query rows; + 8 ..: the ring's slots
  init_bars(bars, 1 + slots, 1);
  if (tid == 0) {
    mbar_expect_tx(bars, H * QBOX);
    for (int h = 0; h < H; ++h) load_tile(sqr + h * QBOX, &map_q, h_first & 1, bars, q0, h, b);
    for (int i = 0; i < slots && i < items; ++i)
      load_item(i, slots, ring, bars, &map_k, &map_v, h_first, H, b, nt);
  }
  mbar_wait(bars, 0);
  for (int i = 0; i < items; ++i) {
    const int slot = i % slots, h = i < H ? i : i - H;
    const uint32_t st = ring + slot * nt * TILE;
    mbar_wait(bars + 8 + 8 * slot, (i / slots) & 1);
    if (i < H) {
      // S_h^T = K_h Q_h^T, a key tile a product, warpgroup wg the key tiles
      // wg, wg + 2: rows keys, columns the 16 query rows
      float acc[MAXT / 2][8];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < MAXT / 2; ++j)
        if (2 * j + wg < nt)
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            wgmma_ss16<0>(acc[j], desc_k(st + (2 * j + wg) * TILE, kk),
                          desc_k(sqr + h * QBOX, kk), kk);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < MAXT / 2; ++j) fence_n<8>(acc[j]);
      // into the stacked buffer in base-2 units (-inf past N): row 16 h +
      // query, column key
#pragma unroll
      for (int j = 0; j < MAXT / 2; ++j)
        if (2 * j + wg < nt)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int key = (2 * j + wg) * ROWS + warp * 16 + g + 8 * ((e >> 1) & 1);
            const int q = 8 * (e >> 2) + 2 * t + (e & 1);
            logits[(QROWS * h + q) * ld + key] = key < N ? acc[j][e] * c2 : -INFINITY;
          }
    } else {
      // O_h^T = V_h^T P_h^T: rows the head dim, columns query rows 8 wg ..
      // 8 wg + 7 (warpgroup wg); V read MN-major, P_h^T from its boxes, 16
      // keys a step up to the last step with a key < N
      float o[4];
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < MAXT; ++kt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kt < nt && kt * ROWS + 16 * kk < N)
            wgmma_ss8<1>(o, desc_mn(st + kt * TILE, kk),
                         desc_k(slg + h * hreg + kt * QBOX + wg * 1024, kk), kt + kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_n<4>(o);
      // rounded, into head h's query-row box (read by no product any
      // more) as rows of the output: row query, column the head dim
      uint8_t* box = tiles + (sqr - base) + h * QBOX;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = warp * 16 + g + 8 * (e >> 1), q = 8 * wg + 2 * t + (e & 1);
        *reinterpret_cast<bf16*>(box + q * 128 + (((d >> 3) ^ (q & 7)) << 4) + 2 * (d & 7)) =
            __float2bfloat16_rn(o[e]);
      }
      fence_async_smem();
    }
    __syncthreads();  // the slot is read; the logits or the output box written
    if (i == H - 1) {
      // one softmax pass over the 16 H rows, a head at a time, a warp 2 of
      // its rows, keys 8 lane .. 8 lane + 7 a lane: p = ex2(x - max) *
      // (1 / sum), rounded, written once the head's rows are all read into
      // P_h^T's boxes over them (query row q of box kt, 16-byte chunk c at
      // c ^ (q % 8))
      constexpr int RW = QROWS / (STACK_THREADS / 32);  // rows a warp
      const bool in = 8 * lane < kp;
      for (int hr = 0; hr < H; ++hr) {
        uint4 p4[RW];
#pragma unroll
        for (int j = 0; j < RW; ++j) {
          const float* row = logits + (QROWS * hr + w8 + 8 * j) * ld + 8 * lane;
          float v[8];
          if (in) {
            const float4 lo = *reinterpret_cast<const float4*>(row);
            const float4 hi = *reinterpret_cast<const float4*>(row + 4);
            v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
            v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = -INFINITY;
          }
          float mx = v[0];
#pragma unroll
          for (int e = 1; e < 8; ++e) mx = fmaxf(mx, v[e]);
          mx = warp_max(mx);
          float sum = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            v[e] = ex2(v[e] - mx);
            sum += v[e];
          }
          const float rr = 1.f / warp_sum(sum);
          p4[j] = make_uint4(pack_bf16(v[0] * rr, v[1] * rr), pack_bf16(v[2] * rr, v[3] * rr),
                             pack_bf16(v[4] * rr, v[5] * rr), pack_bf16(v[6] * rr, v[7] * rr));
        }
        __syncthreads();  // every row of head hr is read
        if (in) {
          const int kt = lane >> 3, c = lane & 7;
#pragma unroll
          for (int j = 0; j < RW; ++j) {
            const int q = w8 + 8 * j;
            *reinterpret_cast<uint4*>(tiles + (slg - base) + hr * hreg + kt * QBOX + q * 128 +
                                      ((c ^ (q & 7)) << 4)) = p4[j];
          }
        }
      }
      fence_async_smem();  // P^T into the async proxy, for the wgmmas
      __syncthreads();
    }
    if (tid == 0) {
      if (i + slots < items)
        load_item(i + slots, slots, ring, bars, &map_k, &map_v, h_first, H, b, nt);
      if (i >= H) store_tile(&map_o, h_first & 8, sqr + h * QBOX, q0, h, b);
    }
  }
  if (tid == 0) tma_store_wait();
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
  if (N < 1 || N > MAXN || H < 1 || variant < kLoop || variant > kStacked ||
      (variant == kAvpair && H % 2 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = proto_smem(tiles_of(N), H, variant);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  using Kernel = decltype(&proto_loop_kernel);
  const Kernel stacked = ring_slots(tiles_of(N)) == 2 ? proto_stacked_kernel<2>
                                                      : proto_stacked_kernel<RING>;
  const Kernel kernel = variant == kLoop     ? proto_loop_kernel
                        : variant == kAvpair ? proto_avpair_kernel
                                             : stacked;
  // first: the context the tensor maps need (sm90.cuh encoder)
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // q, k and v of the packed qkv and the merged heads as [B, H, N, 64]
  // maps; stacked reads its query rows and writes its output in 16-row boxes
  const int D = HD * H, rows = variant == kStacked ? QROWS : ROWS;
  const long long st_qkv[3] = {static_cast<long long>(N) * 3 * D, HD, 3 * D};
  const long long st_o[3] = {static_cast<long long>(N) * D, HD, D};
  const bf16* q = static_cast<const bf16*>(qkv);
  CUtensorMap maps[4];
  bool hf[4];
  err = heads_map(&maps[0], q, st_qkv, B, H, N, &hf[0], rows);
  if (err == cudaSuccess) err = heads_map(&maps[1], q + D, st_qkv, B, H, N, &hf[1]);
  if (err == cudaSuccess) err = heads_map(&maps[2], q + 2 * D, st_qkv, B, H, N, &hf[2]);
  if (err == cudaSuccess) err = heads_map(&maps[3], merged, st_o, B, H, N, &hf[3], rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int h_first = hf[0] | hf[1] << 1 | hf[2] << 2 | hf[3] << 3;
  const int blocks = variant == kLoop     ? B * H
                     : variant == kAvpair ? B * (H / 2)
                                          : B * ((N + QROWS - 1) / QROWS);
  const int threads = variant == kLoop     ? THREADS
                      : variant == kAvpair ? PAIR_THREADS
                                           : STACK_THREADS;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], h_first, N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block of arrangement `variant` takes at N
// keys and H heads.
extern "C" int tr_proto_attn_smem(int N, int H, int variant) {
  return trk::proto_smem(trk::tiles_of(N), H, variant);
}
