// Softmax attention for short sequences (N <= 256) at head dim 64 on Hopper
// (sm_90a): the bf16 forward and backward of the square attention, with
// TMA loads into shared memory and wgmma products. Above 256 tokens (or
// kept rows) the host launches attention_wide_sm90.cu's kernels instead,
// which stream the keys in 64-key tiles through this header's steps.
//
// It replaces, in bf16, the attention of the TPU kernels
// tokenreduction_tpu/ops/flash_attention.py fused_attention (:183, also the
// forward of ops/flash_attention_train.py attention_core_train),
// fused_attention_qkv (:313), fused_block_attention (:660) and
// ops/fused_full_block.py fused_full_block (:118), the attention of
// ops/fused_block_train.py attend_branch_train (fwd :246, bwd :296), the
// backward _bwd_kernel of ops/flash_attention_train.py (:38-99), and the
// rectangular attention _rect_kernel (:772) of fused_rect_attention (:817)
// and fused_rect_block (:925). short_attention.cu keeps the fp32 kernels
// (the parity dtype) and head_mean_keys.
//
// Operands. q, k, v, the output and every gradient are [B, H, N, 64] with
// the head dim contiguous and their own batch, head and row strides
// (multiples of 8), so the packed qkv [B, N, 3D] and merged heads [B, N, D]
// of the eval blocks and the [B, H, N, hd] views of the training core are
// one kernel. Each is a 4-D tensor map; a TMA box is one 64-row tile of one
// (image, head), 8 KB, written with the 128-byte swizzle that the wgmma
// descriptors read. Rows past N are zeros on load and are not written on
// store, per image: the padding never reads the next image's rows.
//
// Forward (what the TPU kernel computes, flash_attention.py:133-181):
// logits = q.k * scale + bias[key], capped at -FLT_MAX where the query or
// the key token is invalid (the mask), -inf past N; fp32 softmax with the
// exact row max. Eval recipe: the unnormalised exponentials rounded to bf16
// before PV, the [64] output scaled by 1/sum; NORM_P (the training branch):
// the normalised P rounded instead. By-products, fp32 [B, H, N]: row0 (the
// CLS query row of P) and colsum (the column mass over valid query rows);
// the training forwards also write the row statistics, fp32 [B, H, N, 2]:
// the row max of the logits and 1/sum, which the backward reads.
//
// The forward's walk over the query tiles, the backward's walk over the
// key tiles and the wgmma and swizzle helpers live in attention_sm90.cuh,
// which the kernel tools' joint attention (attn_joint.cu) and attention
// prototypes (proto_attn.cu, proto_attn_bwd.cu) include too.
//
// Design. One block of one warpgroup per (image, head): thread 0 issues
// TMA loads of the head's q, k and v tiles (N <= 256: at most 4 tiles
// each) at the start, and two blocks fit on an SM (about 104 KB of shared
// memory and at most 255 registers a thread), so one block's loads run
// behind the other's products. The warpgroup walks the query tiles of 64
// rows; for each, S = Q K^T runs on wgmma m64n64k16 (A and B from shared
// memory) into up to four 64-key accumulators: the whole row of at most 256
// keys stays in registers, so the row max and sum take one read of S and
// the exponentials run once (ex2 of logits in base-2 units: logits * log2 e,
// with the -FLT_MAX caps applied in that domain, so a fully masked row is
// still uniform). P is rounded to bf16 in place and O = P V runs on wgmma
// with A from registers and V read MN-major (the transpose bit). Key
// columns past N are skipped 8 at a time (warp-uniform); warps whose 16
// query rows all lie past N skip the softmax. colsum is reduced over a
// warp's 16 rows by a butterfly of shuffles that leaves each lane 2 whole
// columns per key tile (56 shuffles a query tile, not 3 per element), kept
// in registers across the query tiles, then over the 4 warps through
// shared memory in a fixed order: no atomics, two launches give the same
// bits. The output tile goes through the query tile's shared memory (no
// longer read) and leaves by a TMA store.
//
// The rectangular variant (RECT): the M query rows ids[b, m] of q over all
// N keys and values under the validity mask, the query cap being the mask
// at the gathered token; the eval recipe; no by-products; out [B, H, M,
// 64]. A TMA box cannot gather rows, but only Q is gathered: K and V are
// loaded by TMA as above. Each thread copies 16-byte chunks of the gathered
// rows by cp.async into the 128-byte-swizzled layout that the TMA box writes
// and the wgmma descriptors read (chunk c of tile row r at c ^ (r % 8)),
// rows past M zero; after the copies complete, each thread fences them
// into the async proxy before the block's barrier and the first wgmma.
// The output tile leaves by a TMA store on an [B, H, M, 64] map: no row
// past M is written. An id outside 0..N-1 traps. What bounds it at B = 256,
// (M, N) = (138, 197): reading q's kept rows, k, v and writing the output,
// about 0.039 ms at 3.35 TB/s; the kernel runs the square forward's single
// pass over the keys, on ceil(M / 64) query tiles. At N <= 64 (ATS@0.25's
// last blocks) an instance that holds one key tile of S (KT = 1) takes 79
// registers, not 255, so four blocks share an SM instead of two: there a
// block's fixed latency, not its work, sets the time. A launch takes at
// most as many query tiles as key tiles; more kept rows than keys (no
// model's) go in launches of that many rows each.
//
// Backward (_bwd_kernel's arithmetic and rounding points): P from the
// forward's statistics (no recomputed row max or sum); dP = dO V^T plus the
// row0 cotangent on query row 0 and the colsum cotangent on every valid
// query row; dS = P (dP - delta) * scale, zero at every masked pair (a
// fully masked row's uniform P still feeds dV); dV = round(P)^T dO,
// dK = round(dS)^T Q, dQ = round(dS) K; dbias = the unscaled dS summed over
// each key's column. delta_i = sum_j P_ij dP_ij takes one of two forms.
// Where the launch has no colsum cotangent and writes no dbias (the
// training branch, heuristic's masked core), the shortcut form
// rowsum(dO * O) + [i = 0] row0 . drow0, from the forward's bf16 output O
// and row0, so QK^T and dO V^T run once per (key tile, query tile) pair.
// With dcs or dbias (the EXACT variant), JAX's form in full, from a first
// pass of QK^T and dO V^T: the shortcut's rounding of O moves dbias, an
// unrounded fp32 sum, past the 1e-4 of its max that it is held to.
// One block of two warpgroups per (image, head) holds q, k, v and dO (at
// most 128 KB); in turn each warpgroup takes a key tile and walks the
// query tiles:
// S^T = K Q^T and dP^T = V dO^T on wgmma (keys as rows), P^T and dS^T in
// registers, dV += P^T dO and dK += dS^T Q on wgmma with A from registers.
// dS^T is staged as bf16 in shared memory, and dQ's part of this key tile,
// dS K, runs on wgmma (A read transposed) and is added to an fp32 dQ in
// shared memory in a fixed order (the warpgroups step in lockstep, each on
// another query tile): no atomics. dK and dV leave by TMA stores from the
// key tile's shared memory, dQ from the query tiles' at the end. Its loads
// are not hidden behind another head's work at N > 192 (one block an SM:
// 229,384 bytes of shared memory at N = 197); the two warpgroups hide each
// other's waits.
//
// What bounds them at B = 256, N = 197 on the H100: reading q, k, v (and
// dO) and writing the outputs, about 0.046 ms forward and 0.081 ms backward
// at 3.35 TB/s; the products (on 64-row tiles padded from 197 to 256) and
// the exponentials each take a part of that.
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>

#include "attention_sm90.cuh"

namespace trk {
namespace {

using bf16 = __nv_bfloat16;

// forward: the q tiles of m query rows (m = n but in the rectangular
// variant), the k and v tiles of n keys; bias and caps [MAXN]; per-warp
// column sums [4][MAXN] (the rectangular variant's query caps [MAXN]); 3
// barriers; 1 KB to align the tiles to the swizzle's 1024
size_t fwd_smem_bytes(int n, int m) {
  return 1024 + static_cast<size_t>(tiles_of(m) + 2 * tiles_of(n)) * TILE + 6 * MAXN * 4 + 3 * 8;
}

// backward: q, k, v, dO tiles; two staged dS^T tiles; O's tiles, then the
// fp32 dQ [tiles * 64][64]; bias, caps, row max, 1/sum, delta, dcs, drow0
// [MAXN]; per-warp column sums [8][MAXN]; a barrier
size_t bwd_smem_bytes(int n) {
  const size_t t = tiles_of(n);
  return 1024 + 4 * t * TILE + 2 * TILE + t * ROWS * HD * 4 + 15 * MAXN * 4 + 8;
}


// The rectangular variant's gathered query rows: row m of the q operand's
// (image b, head h) is q + b sb + h sh + ids[b ld + m] sn (elements).
struct Gather {
  const bf16* q;
  long long sb, sh, sn;
  const int* ids;  // [B, ld], the launch's M columns from the first
  int ld;
};

// The rectangular variant's query tiles at `tiles`, by cp.async, and its
// query caps: thread (r, c) = (tid / 8, tid % 8) copies chunk c (16 bytes)
// of slots m = r + 16 j (j < 16: tile j / 4, tile row m % 64) from q row
// ids[b, m] to position c ^ (m % 8) of the tile row, as the TMA box's
// 128-byte swizzle writes it; the tiles' slots past M are zeros. The
// thread's ids are loaded together first, then every copy is issued: tile
// 0's copies are one commit group, the other tiles' (maybe none) a
// second. qcap[m] = +inf for a valid gathered token, -FLT_MAX for an
// invalid one or past M. An id outside 0..N-1 traps.
__device__ __forceinline__ void gather_q(uint8_t* tiles, float* qcap, const Gather& ga,
                                         const unsigned char* mask, int b, int h, int N, int M) {
  constexpr int SLOTS = MAXN / 16;  // a thread's slots
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7, rows = tiles_of(M) * ROWS;
  const int* ids = ga.ids + static_cast<size_t>(b) * ga.ld;
  int id[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) id[j] = r + 16 * j < M ? ids[r + 16 * j] : 0;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int m = r + 16 * j;
    const bool in = m < M;
    if (in && static_cast<unsigned>(id[j]) >= static_cast<unsigned>(N)) __trap();
    if (m < rows)  // the query tiles' rows only
      cp_async16(tiles + (m >> 6) * TILE + (m & 63) * 128 + ((c ^ (m & 7)) << 4),
                 in ? ga.q + b * ga.sb + h * ga.sh + id[j] * ga.sn + c * 8 : ga.q, in);
    if (j == 3) cp_async_commit();
  }
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < SLOTS; ++j)
    if ((j & 7) == c) {
      const int m = r + 16 * j;
      qcap[m] = m < M && mask[static_cast<size_t>(b) * N + id[j]] ? INFINITY : -FLT_MAX;
    }
}

// ------------------------------------------------------------- forward
// NORM_P: round the normalised probabilities before PV (training branch,
// and the packed-qkv eval attention), else the eval recipe. MASK: the
// validity mask (one byte per token). RECT: the rectangular variant (with
// MASK, not NORM_P): the M query rows gathered through ga, out [B, H, M,
// 64]; bias, row0, colsum and stats null. Otherwise M = N, bias, row0,
// colsum and stats may be null, and ga is not read. KT: the key tiles a
// row of S holds in registers (MAXT, or 1 for N <= 64).
template <bool NORM_P, bool MASK, bool RECT, int KT>
__global__ void __launch_bounds__(THREADS, KT == MAXT ? 2 : 4)
    attention_fwd_sm90(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_o, int h_first,
                       const float* __restrict__ bias, const unsigned char* __restrict__ mask,
                       float* __restrict__ row0, float* __restrict__ colsum,
                       float2* __restrict__ stats, const Gather ga, int N, int M, int H,
                       float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);
  const int nt = tiles_of(N);
  const int nq = RECT ? M : N, ntq = tiles_of(nq);  // query rows and tiles (ntq <= nt)
  const uint32_t sq = base, sk = sq + ntq * TILE, sv = sk + nt * TILE;
  float* bias2 = reinterpret_cast<float*>(tiles + (ntq + 2 * nt) * TILE);
  float* cap = bias2 + MAXN;
  float* csw = cap + MAXN;  // [4][MAXN]
  float* qcap = csw;        // RECT: the query rows' caps [MAXN]
  const uint32_t bars = smem_addr(csw + 4 * MAXN);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool hq = h_first & 1, hk = h_first & 2, hv = h_first & 4, ho = h_first & 8;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    // bars: query tile 0 (not RECT) and the keys; + 8: the values; + 16:
    // the other query tiles (not RECT)
    mbar_expect_tx(bars, (RECT ? nt : 1 + nt) * TILE);
    if (!RECT) load_tile(sq, &map_q, hq, bars, 0, h, b);
    for (int i = 0; i < nt; ++i) load_tile(sk + i * TILE, &map_k, hk, bars, i * ROWS, h, b);
    mbar_expect_tx(bars + 8, nt * TILE);
    for (int i = 0; i < nt; ++i) load_tile(sv + i * TILE, &map_v, hv, bars + 8, i * ROWS, h, b);
    if (!RECT && nt > 1) {
      mbar_expect_tx(bars + 16, (nt - 1) * TILE);
      for (int i = 1; i < nt; ++i) load_tile(sq + i * TILE, &map_q, hq, bars + 16, i * ROWS, h, b);
    }
  }
  if constexpr (RECT) gather_q(tiles, qcap, ga, mask, b, h, N, M);
  key_vectors(bias2, cap, bias, MASK ? mask : nullptr, b, N);
  if constexpr (RECT) {
    cp_async_wait<0>();  // the query tiles have landed: into the async proxy
    fence_async_smem();
  }
  __syncthreads();
  mbar_wait(bars, 0);
  attention_fwd_tiles<NORM_P, MASK, RECT, KT>(sq, sk, sv, bars, bias2, cap, csw, qcap,
                                              &map_o, ho, row0, colsum, stats, N, nq, nt, ntq, bh,
                                              h, b, tid, warp, lane, g, t, scale);
}

// ------------------------------------------------------------ backward
// MASK: the validity mask's caps on the logits and dS zeroed at every
// masked pair. EXACT: delta in full, sum_j P_ij dP_ij, from a first pass
// of S^T and dP^T (the variant that takes the colsum cotangent dcs or
// writes dbias); else delta's shortcut form from O (its tiles read by TMA)
// and row0. bias, drow0, dcs and dbias may be null; row0 is needed with
// drow0 (shortcut form).
//
// Two warpgroups share the head's tiles. In round r warpgroup w takes key
// tile 2 r + w and walks the query tiles from tile w on (rotated), step by
// step in lockstep with the other (a block barrier each step), so at each
// step the two add their parts of dQ into different query tiles, and the
// additions into each tile come in one fixed order.
template <bool MASK, bool EXACT>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    attention_bwd_sm90(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_o,
                       const __grid_constant__ CUtensorMap map_do,
                       const __grid_constant__ CUtensorMap map_dq,
                       const __grid_constant__ CUtensorMap map_dk,
                       const __grid_constant__ CUtensorMap map_dv, int h_first,
                       const float2* __restrict__ stats, const float* __restrict__ row0,
                       const float* __restrict__ bias, const unsigned char* __restrict__ mask,
                       const float* __restrict__ drow0, const float* __restrict__ dcs,
                       float* __restrict__ dbias, int N, int H, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);
  const int nt = tiles_of(N);
  const uint32_t sq = base, sk = sq + nt * TILE, sv = sk + nt * TILE, sdo = sv + nt * TILE;
  const uint32_t sds0 = sdo + nt * TILE;  // a staged dS^T tile per warpgroup
  const uint32_t so = sds0 + 2 * TILE;    // O's tiles, then the fp32 dQ
  float* dq32 = reinterpret_cast<float*>(tiles + 4 * nt * TILE + 2 * TILE);  // [nt * 64][64]
  float* bias2 = dq32 + nt * ROWS * HD;
  float* cap = bias2 + MAXN;
  float* sm2 = cap + MAXN;  // the row max in base-2 units; +inf past N
  float* sr = sm2 + MAXN;   // 1/sum; 0 past N
  float* sd = sr + MAXN;    // delta
  float* sc = sd + MAXN;    // the colsum cotangent, 0 past N
  float* sw = sc + MAXN;    // the row0 cotangent, 0 past N
  float* csw = sw + MAXN;   // [8 warps][MAXN]
  const uint32_t bar = smem_addr(csw + 8 * MAXN);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t vec = static_cast<size_t>(bh) * N;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, (EXACT ? 4 : 5) * nt * TILE);
    for (int i = 0; i < nt; ++i) {
      load_tile(sq + i * TILE, &map_q, h_first & 1, bar, i * ROWS, h, b);
      load_tile(sk + i * TILE, &map_k, h_first & 2, bar, i * ROWS, h, b);
      load_tile(sv + i * TILE, &map_v, h_first & 4, bar, i * ROWS, h, b);
      if (!EXACT) load_tile(so + i * TILE, &map_o, h_first & 8, bar, i * ROWS, h, b);
      load_tile(sdo + i * TILE, &map_do, h_first & 16, bar, i * ROWS, h, b);
    }
  }
  for (int j = tid; j < MAXN; j += BWD_THREADS) {
    bias2[j] = j < N ? (bias != nullptr ? bias[static_cast<size_t>(b) * N + j] * LOG2E : 0.f)
                     : -INFINITY;
    if (MASK) cap[j] = j < N && mask[static_cast<size_t>(b) * N + j] ? INFINITY : -FLT_MAX;
    const float2 st = j < N ? stats[vec + j] : make_float2(0.f, 0.f);
    sm2[j] = j < N ? (st.x == -FLT_MAX ? st.x : st.x * LOG2E) : INFINITY;
    sr[j] = st.y;
    sc[j] = dcs != nullptr && j < N ? dcs[vec + j] : 0.f;
    sw[j] = drow0 != nullptr && j < N ? drow0[vec + j] : 0.f;
  }
  float r0dot = 0.f;  // row0 . drow0, the row0 cotangent's part of delta_0
  if (!EXACT && tid < 32 && drow0 != nullptr) {
    for (int j = lane; j < N; j += 32) r0dot += row0[vec + j] * drow0[vec + j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) r0dot += __shfl_xor_sync(0xffffffffu, r0dot, o);
  }
  mbar_wait(bar, 0);
  // the shortcut form: delta_i = rowsum(dO_i * O_i) (+ row0 . drow0 on
  // row 0): 8 lanes a row, 16 bytes a lane, from the swizzled tiles (rows
  // past N are zeros)
  for (int i = tid >> 3; !EXACT && i < nt * ROWS; i += BWD_THREADS / 8) {
    const int c = tid & 7;
    const uint32_t at = (i >> 6) * TILE + (i & 63) * 128 + ((c ^ (i & 7)) << 4);
    const uint4 ov = *reinterpret_cast<const uint4*>(tiles + (so - base) + at);
    const uint4 dv = *reinterpret_cast<const uint4*>(tiles + (sdo - base) + at);
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
    if (c == 0) sd[i] = acc + (i == 0 ? r0dot : 0.f);
  }
  __syncthreads();

  const float c2 = scale * LOG2E;
  if constexpr (EXACT) {
    // delta_i = sum_j P_ij dP_ij (dP with both cotangents, as the main loop
    // takes it): a first pass of S^T and dP^T over the key tiles of each
    // warpgroup, the column sums over the keys kept per lane (see
    // column_butterfly), then over the 8 warps in order
    float cs[MAXT][2] = {};
    for (int jt = wg; jt < nt; jt += 2) {
      const int j0 = jt * ROWS + warp * 16 + g, j1 = j0 + 8;
      const bool live = jt * ROWS + warp * 16 < N;
#pragma unroll
      for (int it = 0; it < MAXT; ++it) {
        if (it >= nt) break;
        float st[32], dpt[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          wgmma_ss<0, 0>(st, desc_k(sk + jt * TILE, kk), desc_k(sq + it * TILE, kk), kk);
          wgmma_ss<0, 0>(dpt, desc_k(sv + jt * TILE, kk), desc_k(sdo + it * TILE, kk), kk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence32(st);
        fence32(dpt);
        if (live) {
          probs_t<MASK>(st, it * ROWS, N, c2, bias2[j0], bias2[j1], MASK ? cap[j0] : INFINITY,
                        MASK ? cap[j1] : INFINITY, sm2, sr, cap, t);
          float v[16], sums[2];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = it * ROWS + 8 * jj + 2 * t + e;
              float dp0 = dpt[4 * jj + e], dp1 = dpt[4 * jj + 2 + e];
              if (c == 0) dp0 += sw[j0], dp1 += sw[j1];
              if (c < N) dp0 += sc[j0], dp1 += sc[j1];
              v[2 * jj + e] = st[4 * jj + e] * dp0 + st[4 * jj + 2 + e] * dp1;
            }
          column_butterfly(v, lane, sums);
          cs[it][0] += sums[0];
          cs[it][1] += sums[1];
        }
      }
    }
    const int c0 = butterfly_col(lane), w8 = tid >> 5;
#pragma unroll
    for (int it = 0; it < MAXT; ++it)
      if (it < nt) {
        csw[w8 * MAXN + it * ROWS + c0] = cs[it][0];
        csw[w8 * MAXN + it * ROWS + c0 + 1] = cs[it][1];
      }
    __syncthreads();
    for (int i = tid; i < nt * ROWS; i += BWD_THREADS) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) acc += csw[w * MAXN + i];
      sd[i] = acc;
    }
  }
  attention_bwd_keys<MASK, EXACT, false>(sq, sk, sv, sdo, sds0, dq32, bias2, cap, sm2, sr, sd, sc,
                                         sw, &map_dq, &map_dk, &map_dv, h_first, dbias, vec, N,
                                         nt, h, b, tid, wg, wt, warp, g, t, scale);
}


}  // namespace
}  // namespace trk

// Returns the cudaError_t of the launch (0 on success). The bf16 forward:
// q, k, v [B, H, N, 64] and out [B, H, M, 64] with the head dim
// contiguous; strides holds their (batch, head, row) strides in elements
// (multiples of 8, starts 16-byte aligned). Without ids, the square
// attention (M = N): bias (fp32 [B, N]), mask ([B, N], one byte per token,
// non-zero = valid), row0, colsum (fp32 [B, H, N]) and stats (fp32
// [B, H, N, 2]: the row max of the logits and 1/sum) may be null; norm_p
// rounds the normalised probabilities before PV. With ids (int32 [B, M]),
// the rectangular attention: out row m is q row ids[b, m] over all N keys,
// with a mask and no bias, by-products, stats or norm_p.
extern "C" int tr_attention_sm90(const void* q, const void* k, const void* v, void* out,
                                 const long long* strides, const void* bias, const void* mask,
                                 const void* ids, void* row0, void* colsum, void* stats, int B,
                                 int N, int M, int H, float scale, int norm_p, void* stream) {
  using namespace trk;
  const bool rect = ids != nullptr;
  if (N < 1 || N > MAXN || M < 1 || M > MAXN || H < 1 || B < 0 || (!rect && M != N) ||
      (rect && (mask == nullptr || bias != nullptr || row0 != nullptr || colsum != nullptr ||
                stats != nullptr || norm_p)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  using Kernel = decltype(&attention_fwd_sm90<false, false, false, MAXT>);
  const Kernel variants[2][2] = {
      {attention_fwd_sm90<false, false, false, MAXT>, attention_fwd_sm90<false, true, false, MAXT>},
      {attention_fwd_sm90<true, false, false, MAXT>, attention_fwd_sm90<true, true, false, MAXT>}};
  // the rectangular variant over one key tile holds one tile of S: more
  // blocks an SM
  const Kernel rect_kernel = N <= ROWS ? attention_fwd_sm90<false, true, true, 1>
                                       : attention_fwd_sm90<false, true, true, MAXT>;
  const Kernel kernel = rect ? rect_kernel : variants[norm_p != 0][mask != nullptr];
  // first: the context the tensor maps need (sm90.cuh encoder)
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(fwd_smem_bytes(MAXN, MAXN)));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[4];
  const void* ptrs[3] = {q, k, v};
  int h_first;
  err = heads_maps(maps, ptrs, strides, 3, B, H, N, &h_first);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a launch takes at most as many query tiles as there are key tiles: more
  // kept rows than keys (no model's) go in launches of that many rows
  const int step = rect ? tiles_of(N) * ROWS : M;
  for (int m0 = 0; m0 < M; m0 += step) {
    const int rows = M - m0 < step ? M - m0 : step;
    bool ho;  // the map of this launch's output rows
    err = heads_map(&maps[3], static_cast<bf16*>(out) + m0 * strides[11], strides + 9, B, H, rows,
                    &ho);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int hf = (h_first & 7) | static_cast<int>(ho) << 3;
    const Gather ga{static_cast<const bf16*>(q), strides[0], strides[1], strides[2],
                    static_cast<const int*>(ids) + m0, M};
    kernel<<<B * H, THREADS, fwd_smem_bytes(N, rows), static_cast<cudaStream_t>(stream)>>>(
        maps[0], maps[1], maps[2], maps[3], hf, static_cast<const float*>(bias),
        static_cast<const unsigned char*>(mask), static_cast<float*>(row0),
        static_cast<float*>(colsum), static_cast<float2*>(stats), ga, N, rows, H, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Returns the cudaError_t of the launch (0 on success): the bf16 dq, dk, dv
// from q, k, v, the forward's output out, the output's gradient dout (all
// [B, H, N, 64] as above; strides: q, k, v, out, dout, dq, dk, dv), the
// forward's stats (fp32 [B, H, N, 2]) and row0 (fp32 [B, H, N]; read with
// drow0), the fp32 bias [B, N], the validity mask ([B, N], one byte per
// token), the fp32 cotangents drow0 and dcs [B, H, N], and the fp32
// per-head bias gradient dbias [B, H, N]; each of the last five may be null
// (zero, none, or not written).
extern "C" int tr_attention_bwd_sm90(const void* q, const void* k, const void* v, const void* out,
                                     const void* dout, void* dq, void* dk, void* dv,
                                     const long long* strides, const void* stats,
                                     const void* row0, const void* bias, const void* mask,
                                     const void* drow0, const void* dcs, void* dbias, int B, int N,
                                     int H, float scale, void* stream) {
  using namespace trk;
  const bool exact = dcs != nullptr || dbias != nullptr;
  if (N < 1 || N > MAXN || H < 1 || B < 0 || stats == nullptr ||
      (!exact && (out == nullptr || (drow0 != nullptr && row0 == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  using Kernel = decltype(&attention_bwd_sm90<false, false>);
  const Kernel variants[2][2] = {
      {attention_bwd_sm90<false, false>, attention_bwd_sm90<false, true>},
      {attention_bwd_sm90<true, false>, attention_bwd_sm90<true, true>}};
  const Kernel kernel = variants[mask != nullptr][dcs != nullptr || dbias != nullptr];
  // first: the context the tensor maps need (sm90.cuh encoder)
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bwd_smem_bytes(MAXN)));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap maps[8];
  const void* ptrs[8] = {q, k, v, out, dout, dq, dk, dv};
  int h_first;
  err = heads_maps(maps, ptrs, strides, 8, B, H, N, &h_first);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, BWD_THREADS, bwd_smem_bytes(N), static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7], h_first,
      static_cast<const float2*>(stats), static_cast<const float*>(row0),
      static_cast<const float*>(bias), static_cast<const unsigned char*>(mask),
      static_cast<const float*>(drow0), static_cast<const float*>(dcs),
      static_cast<float*>(dbias), N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block of each kernel takes at n keys, for
// the host: out[3] = {forward, backward, the rectangular forward of m
// query rows}.
extern "C" int tr_attention_sm90_smem(int n, int m, int* out) {
  if (n < 1 || n > trk::MAXN || m < 1 || m > trk::MAXN)
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = static_cast<int>(trk::fwd_smem_bytes(n, n));
  out[1] = static_cast<int>(trk::bwd_smem_bytes(n));
  out[2] = static_cast<int>(trk::fwd_smem_bytes(n, m));
  return 0;
}
