// Softmax attention for short sequences (N <= 256) at head dim 64 on Hopper
// (sm_90a): the bf16 forward and backward of the square attention, with
// TMA loads into shared memory and wgmma products.
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

#include "common.cuh"
#include "sm90.cuh"

namespace trk {
namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;
constexpr int MAXN = 256;
constexpr int ROWS = 64;                 // rows of a tile (query or key)
constexpr int MAXT = MAXN / ROWS;        // tiles of a head
constexpr int TILE = ROWS * HD * 2;      // bytes of a tile, 8 KB
constexpr int THREADS = 128;             // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ int tiles_of(int n) { return (n + ROWS - 1) / ROWS; }

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

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
__device__ __forceinline__ void fence32(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence16(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void zero32(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

#define TRK_ACC32                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),  \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),            \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] = A[64 x 16] . B[16 x 64] (+ d when acc is non-zero), both
// from shared memory; TA, TB: the operand is MN-major (read transposed)
// rather than K-major. (Accumulating from the first product on, rather
// than zeroing d first, keeps other instructions from writing d inside a
// run of products, which would make ptxas serialise them.)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %34, %35;\n"
      "}\n"
      : TRK_ACC32
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(acc));
}

// The same with A from registers: a[4], the bf16 fragment of a 64 x 16 tile
// (a thread's rows g and g + 8 of its warp's 16, columns 2t, 2t + 1 and
// 2t + 8, 2t + 9: the accumulator layout of two 8-column groups).
template <int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : TRK_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB), "r"(acc));
}
#undef TRK_ACC32

// Descriptors of a swizzled 64-row tile at `tile`: its k16 slice kk read
// K-major (rows of 64 along K: the slice starts 32 bytes further) or
// MN-major (rows along K: the slice starts 16 rows, 2048 bytes, further).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 2048, TILE, 1024);
}

// The byte offset in a swizzled tile of row r, columns 8 j + 2 t (+1) of a
// bf16 pair: 16-byte chunk j stored at j ^ (r % 8).
__device__ __forceinline__ uint32_t pair_offset(int r, int j, int t) {
  return r * 128 + ((j ^ (r & 7)) << 4) + 4 * t;
}

// One tile of rows row0 .. row0 + 63 of (image b, head h) of a map whose
// head and row dims come in the order `h_first` says.
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, bool h_first,
                                          uint32_t bar, int row0, int h, int b) {
  if (h_first)
    tma_load_4d(dst, map, bar, 0, h, row0, b);
  else
    tma_load_4d(dst, map, bar, 0, row0, h, b);
}

__device__ __forceinline__ void store_tile(const CUtensorMap* map, bool h_first, uint32_t src,
                                           int row0, int h, int b) {
  if (h_first)
    tma_store_4d(map, src, 0, h, row0, b);
  else
    tma_store_4d(map, src, 0, row0, h, b);
}

// A thread holds, for the 64 columns of a tile, v[2 j + e] = its value at
// column 8 j + 2 t + e summed over its two rows. Summed over the warp's 8
// lanes of the same t (lane bits 2-4) by a butterfly: each step sends half
// the values to the partner and keeps the other half, so a lane ends with
// the whole-warp sums of 2 columns, 8 jo + 2 t + e with jo = 4 g0 + 2 g1 +
// g2 (g = lane / 4 = g0 + 2 g1 + 4 g2). The order of the additions is fixed.
__device__ __forceinline__ void column_butterfly(const float* v, int lane, float* out) {
  const bool b0 = lane & 4, b1 = lane & 8, b2 = lane & 16;
  float w8[8], w4[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float send = b0 ? v[i] : v[8 + i];
    const float keep = b0 ? v[8 + i] : v[i];
    w8[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b1 ? w8[i] : w8[4 + i];
    const float keep = b1 ? w8[4 + i] : w8[i];
    w4[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b2 ? w4[i] : w4[2 + i];
    const float keep = b2 ? w4[2 + i] : w4[i];
    out[i] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
}

// The tile column of a lane's butterfly sums (see column_butterfly), e = 0.
__device__ __forceinline__ int butterfly_col(int lane) {
  const int g = lane >> 2;
  return 8 * (4 * (g & 1) + 2 * ((g >> 1) & 1) + ((g >> 2) & 1)) + 2 * (lane & 3);
}

// The per-key vectors of the image: bias2[j] = bias[j] * log2 e (0 without
// a bias), -inf for j >= N; cap[j] = +inf for a valid token, -FLT_MAX for an
// invalid one or j >= N (with the mask).
__device__ __forceinline__ void key_vectors(float* bias2, float* cap, const float* bias,
                                           const unsigned char* mask, int b, int N) {
  for (int j = threadIdx.x; j < MAXN; j += THREADS) {
    bias2[j] = j < N ? (bias != nullptr ? bias[static_cast<size_t>(b) * N + j] * LOG2E : 0.f)
                     : -INFINITY;
    if (mask != nullptr)
      cap[j] = j < N && mask[static_cast<size_t>(b) * N + j] ? INFINITY : -FLT_MAX;
  }
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

  const float c2 = scale * LOG2E;
  float cs[KT][2] = {};  // the lane's column sums, over the query tiles so far
  // (The loop runs to the key tiles' count and stops at the query tiles':
  // with any other bound, the query tiles' count or the larger of the two,
  // ptxas spilled several times as many of the rectangular variant's
  // registers and it ran slower, in bring-up runs. The host launches at
  // most as many query tiles as key tiles.)
  for (int qi = 0; qi < nt; ++qi) {
    if (RECT && qi >= ntq) break;
    if (!RECT && qi == 1) mbar_wait(bars + 16, 0);
    float s[KT][32];
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      if (kt < nt) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss<0, 0>(s[kt], desc_k(sq + qi * TILE, kk), desc_k(sk + kt * TILE, kk), kk);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) fence32(s[kt]);

    const int r0 = qi * ROWS + warp * 16 + g, r1 = r0 + 8;
    float rr0 = 0.f, rr1 = 0.f;
    if (qi * ROWS + warp * 16 < nq) {  // the warp has a query row
      const float* qc = RECT ? qcap : cap;
      const float qc0 = MASK ? qc[r0] : INFINITY, qc1 = MASK ? qc[r1] : INFINITY;
      // the row max and sum in two running values each (shorter chains)
      float m0[2] = {-INFINITY, -INFINITY}, m1[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (kt < nt && kt * ROWS + 8 * j < N) {
            const int c = kt * ROWS + 8 * j + 2 * t;
            const float2 bb = *reinterpret_cast<const float2*>(bias2 + c);
            float* x = s[kt] + 4 * j;
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
            m0[j & 1] = fmaxf(m0[j & 1], fmaxf(x[0], x[1]));
            m1[j & 1] = fmaxf(m1[j & 1], fmaxf(x[2], x[3]));
          }
        }
      }
      const float mx0 = quad_max(fmaxf(m0[0], m0[1])), mx1 = quad_max(fmaxf(m1[0], m1[1]));
      float l0[2] = {0.f, 0.f}, l1[2] = {0.f, 0.f};
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* x = s[kt] + 4 * j;
          if (kt < nt && kt * ROWS + 8 * j < N) {
            x[0] = ex2(x[0] - mx0);
            x[1] = ex2(x[1] - mx0);
            x[2] = ex2(x[2] - mx1);
            x[3] = ex2(x[3] - mx1);
            l0[j & 1] += x[0] + x[1];
            l1[j & 1] += x[2] + x[3];
          } else {
            x[0] = x[1] = x[2] = x[3] = 0.f;
          }
        }
      }
      const float sum0 = quad_sum(l0[0] + l0[1]), sum1 = quad_sum(l1[0] + l1[1]);
      rr0 = r0 < nq ? 1.f / sum0 : 0.f;  // rows past the last take no part
      rr1 = r1 < nq ? 1.f / sum1 : 0.f;
      if constexpr (NORM_P) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[kt][4 * j] *= rr0;
            s[kt][4 * j + 1] *= rr0;
            s[kt][4 * j + 2] *= rr1;
            s[kt][4 * j + 3] *= rr1;
          }
      }
      // the normalised probabilities: s itself (NORM_P), or s times 1/sum
      const float n0 = NORM_P ? 1.f : rr0, n1 = NORM_P ? 1.f : rr1;
      if (!RECT && stats != nullptr && t == 0) {
        // the row max in the logits' own units (-FLT_MAX stays itself)
        if (r0 < N)
          stats[static_cast<size_t>(bh) * N + r0] =
              make_float2(mx0 == -FLT_MAX ? mx0 : mx0 * LN2, rr0);
        if (r1 < N)
          stats[static_cast<size_t>(bh) * N + r1] =
              make_float2(mx1 == -FLT_MAX ? mx1 : mx1 * LN2, rr1);
      }
      if (!RECT && row0 != nullptr && r0 == 0) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = kt * ROWS + 8 * j + 2 * t + e;
              if (c < N) row0[static_cast<size_t>(bh) * N + c] = s[kt][4 * j + e] * n0;
            }
      }
      if (!RECT && colsum != nullptr) {
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          if (kt < nt) {
            float v[16], sums[2];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              v[2 * j] = s[kt][4 * j] * n0 + s[kt][4 * j + 2] * n1;
              v[2 * j + 1] = s[kt][4 * j + 1] * n0 + s[kt][4 * j + 3] * n1;
            }
            column_butterfly(v, lane, sums);
            cs[kt][0] += sums[0];
            cs[kt][1] += sums[1];
          }
        }
      }
    } else {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) zero32(s[kt]);
    }

    // O = P V: P rounded to bf16 in place, 16 keys a step, up to the last
    // step with a key < N (V's rows past N are zeros, P there is 0)
    uint32_t pa[KT][16];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int i = 0; i < 16; ++i) pa[kt][i] = pack_bf16(s[kt][2 * i], s[kt][2 * i + 1]);
    float o[32];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) fence16(pa[kt]);
    if (qi == 0) mbar_wait(bars + 8, 0);  // the values have landed
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (kt < nt && kt * ROWS + 16 * kk < N)
          wgmma_rs<1>(o, pa[kt] + 4 * kk, desc_mn(sv + kt * TILE, kk), kt + kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence32(o);

    // the output tile, rounded, into this query tile's shared memory (read
    // by no product any more), then one TMA store (rows past N, or with
    // RECT past M, dropped)
    uint8_t* otile = tiles + qi * TILE;
    const float f0 = NORM_P ? 1.f : rr0, f1 = NORM_P ? 1.f : rr1;
    const int lr = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(otile + pair_offset(lr, j, t)) =
          pack_bf16(o[4 * j] * f0, o[4 * j + 1] * f0);
      *reinterpret_cast<uint32_t*>(otile + pair_offset(lr + 8, j, t)) =
          pack_bf16(o[4 * j + 2] * f1, o[4 * j + 3] * f1);
    }
    fence_async_smem();
    __syncthreads();
    if (tid == 0) store_tile(&map_o, ho, sq + qi * TILE, qi * ROWS, h, b);
  }

  if (!RECT && colsum != nullptr) {
    const int c0 = butterfly_col(lane);
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
      if (kt < nt) {
        csw[warp * MAXN + kt * ROWS + c0] = cs[kt][0];
        csw[warp * MAXN + kt * ROWS + c0 + 1] = cs[kt][1];
      }
    __syncthreads();
    for (int c = tid; c < N; c += THREADS)
      colsum[static_cast<size_t>(bh) * N + c] =
          ((csw[c] + csw[MAXN + c]) + csw[2 * MAXN + c]) + csw[3 * MAXN + c];
  }
  if (tid == 0) tma_store_wait();
}

// ------------------------------------------------------------ backward
// P^T of key rows (this thread's j0 = g and j1 = g + 8 of its warp's 16)
// against the query columns q0 + 8 jj + 2 t (+1), in place of the raw
// S^T = K Q^T: exp2 of the base-2 logits (kb: the key's bias2, kc: its cap)
// less the column's base-2 row max m2, times its 1/sum r. Query columns in
// a group of 8 at or past N are 0.
template <bool MASK>
__device__ __forceinline__ void probs_t(float* st, int q0, int N, float c2, float kb0, float kb1,
                                        float kc0, float kc1, const float* m2, const float* r,
                                        const float* cap, int t) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    float* x = st + 4 * jj;
    if (q0 + 8 * jj < N) {
      const int c = q0 + 8 * jj + 2 * t;
      const float2 m = *reinterpret_cast<const float2*>(m2 + c);
      const float2 rr = *reinterpret_cast<const float2*>(r + c);
      float x0 = fmaf(x[0], c2, kb0), x1 = fmaf(x[1], c2, kb0);
      float x2 = fmaf(x[2], c2, kb1), x3 = fmaf(x[3], c2, kb1);
      if constexpr (MASK) {
        const float2 qc = *reinterpret_cast<const float2*>(cap + c);
        x0 = fminf(fminf(x0, kc0), qc.x);
        x1 = fminf(fminf(x1, kc0), qc.y);
        x2 = fminf(fminf(x2, kc1), qc.x);
        x3 = fminf(fminf(x3, kc1), qc.y);
      }
      x[0] = ex2(x0 - m.x) * rr.x;
      x[1] = ex2(x1 - m.y) * rr.y;
      x[2] = ex2(x2 - m.x) * rr.x;
      x[3] = ex2(x3 - m.y) * rr.y;
    } else {
      x[0] = x[1] = x[2] = x[3] = 0.f;
    }
  }
}

constexpr int BWD_THREADS = 2 * THREADS;  // two warpgroups

// A named barrier of the 128 threads of warpgroup wg (barrier 0 is
// __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

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
  // the fp32 dQ starts at zero (O's tiles are read)
  for (int i = tid; i < nt * ROWS * HD / 4; i += BWD_THREADS)
    reinterpret_cast<float4*>(dq32)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const uint32_t sds = sds0 + wg * TILE;
  uint8_t* ds_tile = tiles + (sds - base);
  const int lr = warp * 16 + g;
  for (int round = 0; 2 * round < nt; ++round) {
    const int jt = 2 * round + wg;
    const bool active = jt < nt;
    const int j0 = jt * ROWS + lr, j1 = j0 + 8;
    const bool live = active && jt * ROWS + warp * 16 < N;  // the warp has a key < N
    const float kb0 = active ? bias2[j0] : 0.f, kb1 = active ? bias2[j1] : 0.f;
    const float kc0 = MASK && active ? cap[j0] : INFINITY, kc1 = MASK && active ? cap[j1] : INFINITY;
    const float w0 = active ? sw[j0] : 0.f, w1 = active ? sw[j1] : 0.f;
    const float dc0 = active ? sc[j0] : 0.f, dc1 = active ? sc[j1] : 0.f;
    float dk[32], dv[32], db0 = 0.f, db1 = 0.f;
    for (int step = 0; step < nt; ++step) {
      const int it = step + wg < nt ? step + wg : step + wg - nt;
      if (active) {
        float st[32], dpt[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {  // S^T = K Q^T, dP^T = V dO^T
          wgmma_ss<0, 0>(st, desc_k(sk + jt * TILE, kk), desc_k(sq + it * TILE, kk), kk);
          wgmma_ss<0, 0>(dpt, desc_k(sv + jt * TILE, kk), desc_k(sdo + it * TILE, kk), kk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence32(st);
        fence32(dpt);
        if (live) {
          probs_t<MASK>(st, it * ROWS, N, c2, kb0, kb1, kc0, kc1, sm2, sr, cap, t);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            if (it * ROWS + 8 * jj < N) {
              const int c = it * ROWS + 8 * jj + 2 * t;
              const float2 d = *reinterpret_cast<const float2*>(sd + c);
              float dp[4] = {dpt[4 * jj], dpt[4 * jj + 1], dpt[4 * jj + 2], dpt[4 * jj + 3]};
              if (c == 0) dp[0] += w0, dp[2] += w1;  // the row0 cotangent, query 0
              if constexpr (EXACT) {  // the colsum cotangent on valid query rows
                if (c < N) dp[0] += dc0, dp[2] += dc1;
                if (c + 1 < N) dp[1] += dc0, dp[3] += dc1;
              }
              float u[4];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                u[e] = st[4 * jj + e] * (dp[e] - ((e & 1) ? d.y : d.x));
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
        } else {
          zero32(st);
          zero32(dpt);
        }
        // dV += round(P)^T dO and dK += round(dS)^T Q, A from registers
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
        for (int kk = 0; kk < 4; ++kk) {  // (rows past N: P, dS and dO are 0)
          const int acc = step > 0 || kk > 0;
          wgmma_rs<1>(dv, pa + 4 * kk, desc_mn(sdo + it * TILE, kk), acc);
          wgmma_rs<1>(dk, da + 4 * kk, desc_mn(sq + it * TILE, kk), acc);
        }
        wgmma_commit();
        // dS^T into this warpgroup's staging tile: rows keys, columns queries
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          *reinterpret_cast<uint32_t*>(ds_tile + pair_offset(lr, jj, t)) = da[2 * jj];
          *reinterpret_cast<uint32_t*>(ds_tile + pair_offset(lr + 8, jj, t)) = da[2 * jj + 1];
        }
        fence_async_smem();
        wg_sync(wg);
        // this key tile's part of dQ = dS K: A = dS^T read transposed, B = K
        // read MN-major
        float dq[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // (keys past N: dS and K are 0)
          wgmma_ss<1, 1>(dq, desc_mn(sds, kk), desc_mn(sk + jt * TILE, kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence32(dv);
        fence32(dk);
        fence32(dq);
        // added to the fp32 dQ; a thread owns its elements
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = it * ROWS + lr + 8 * half;
            float2* at = reinterpret_cast<float2*>(dq32 + row * HD + ((8 * jj) ^ (g << 3)) + 2 * t);
            const float2 was = *at;
            *at = make_float2(was.x + dq[4 * jj + 2 * half], was.y + dq[4 * jj + 2 * half + 1]);
          }
      }
      __syncthreads();  // the step's additions into dQ are done
    }
    if (!active) continue;
    if (dbias != nullptr) {
      db0 = quad_sum(db0);
      db1 = quad_sum(db1);
      if (t == 0) {
        if (j0 < N) dbias[vec + j0] = db0;
        if (j1 < N) dbias[vec + j1] = db1;
      }
    }
    // dK and dV of this key tile, rounded, into its K and V tiles (read by
    // no product any more), then TMA stores (rows past N dropped)
    uint8_t* ktile = tiles + (nt + jt) * TILE;
    uint8_t* vtile = tiles + (2 * nt + jt) * TILE;
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
    wg_sync(wg);
    if (wt == 0) {
      store_tile(&map_dk, h_first & 64, sk + jt * TILE, jt * ROWS, h, b);
      store_tile(&map_dv, h_first & 128, sv + jt * TILE, jt * ROWS, h, b);
    }
  }

  // dQ, rounded, into the query tiles (read by no product any more): 8
  // threads a row, 8 columns a thread; then TMA stores
  __syncthreads();
  for (int i = tid >> 3; i < nt * ROWS; i += BWD_THREADS / 8) {
    const int c = tid & 7;
    const float* src = dq32 + i * HD + ((8 * c) ^ ((i & 7) << 3));
    const float4 lo = *reinterpret_cast<const float4*>(src);
    const float4 hi = *reinterpret_cast<const float4*>(src + 4);
    const uint4 packed = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                                    pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
    *reinterpret_cast<uint4*>(tiles + (i >> 6) * TILE + (i & 63) * 128 + ((c ^ (i & 7)) << 4)) =
        packed;
  }
  fence_async_smem();
  __syncthreads();
  if (tid == 0)
    for (int it = 0; it < nt; ++it) store_tile(&map_dq, h_first & 32, sq + it * TILE, it * ROWS, h, b);
  if (wt == 0) tma_store_wait();
}

// ---------------------------------------------------------------- host
// The map of one [B, H, N, 64] bf16 operand with element strides
// st = (batch, head, row), in boxes of one 64-row tile of one (image,
// head) with the 128-byte swizzle; rows past N read as zeros and are not
// written. The head and row dims go in the order of their strides (so the
// strides grow, as cuTensorMapEncodeTiled expects); *h_first tells which
// came first. A stride of a dim of size 1 is not read: it is set to keep
// that order.
cudaError_t heads_map(CUtensorMap* map, const void* ptr, const long long* st, int B, int H, int N,
                      bool* h_first) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  long long sb = st[0], sh = st[1], sn = st[2];
  if (N == 1) sn = H == 1 ? HD : sh * H;
  if (H == 1) sh = sn * N;
  if (B == 1) sb = sh * H > sn * N ? sh * H : sn * N;
  const bool hf = sh < sn;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(hf ? H : N),
                              static_cast<cuuint64_t>(hf ? N : H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hf ? sh : sn) * 2,
                                 static_cast<cuuint64_t>(hf ? sn : sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {HD, hf ? 1u : static_cast<cuuint32_t>(ROWS),
                             hf ? static_cast<cuuint32_t>(ROWS) : 1u, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  *h_first = hf;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Maps of `count` operands (strides[3 i ..]); bit i of *h_first for each.
cudaError_t heads_maps(CUtensorMap* maps, const void* const* ptrs, const long long* strides,
                       int count, int B, int H, int N, int* h_first) {
  *h_first = 0;
  for (int i = 0; i < count; ++i) {
    bool hf;
    const cudaError_t err = heads_map(&maps[i], ptrs[i], strides + 3 * i, B, H, N, &hf);
    if (err != cudaSuccess) return err;
    *h_first |= static_cast<int>(hf) << i;
  }
  return cudaSuccess;
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
