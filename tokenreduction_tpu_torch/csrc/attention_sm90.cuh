// The sm_90a attention's shared steps: the forward's walk over the query
// tiles of one (image, head) (S = Q K^T on wgmma m64, the whole row of at
// most 256 keys in registers, the exact softmax (row_exp), P rounded in
// registers as the A operand of O = P V on wgmma, V read MN-major through
// the transpose bit, the output tile out by a TMA store, row0 and colsum),
// the backward's walk over the key tiles (attention_bwd_keys: P^T and dS^T
// in registers, dV and dK on wgmma with A from registers, dQ summed in
// shared memory in a fixed order), their wgmma and swizzle helpers, and the
// host's [B, H, N, 64] tensor maps. attention_sm90.cu includes it (every
// bf16 attention of the main path at N <= 256, which loads q, k and v by
// TMA), attention_wide_sm90.cu (above 256 tokens: its wgmma and swizzle
// helpers, probs_t and the tensor maps), and so do the kernel tools'
// attn_joint.cu (the joint attention, which makes q, k
// and v on chip from LayerNorm'd rows first), proto_attn.cu and
// proto_attn_bwd.cu (the attention-core arrangements and the recomputing
// branch backward). What each step computes, and why it is laid out so, is
// set out at the top of attention_sm90.cu.
#pragma once

#include <float.h>
#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>

#include "common.cuh"
#include "sm90.cuh"

// In an unnamed namespace, so that the forward's steps name the including
// kernel's own dynamic shared memory (smem_raw) and form its tile
// addresses as that kernel does.
namespace trk {
namespace {

constexpr int HD = 64;
constexpr int MAXN = 256;
constexpr int ROWS = 64;                 // rows of a tile (query or key)
constexpr int MAXT = MAXN / ROWS;        // tiles of a head
constexpr int TILE = ROWS * HD * 2;      // bytes of a tile, 8 KB
constexpr int THREADS = 128;             // one warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ int tiles_of(int n) { return (n + ROWS - 1) / ROWS; }

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

// The same 128 columns wide, [lo | hi] = A[64 x 16] . B[16 x 128] (+ [lo |
// hi] when acc is non-zero): lo takes columns 0 .. 63, hi 64 .. 127 (each
// in the 64-column accumulator layout). B is two 64-column tiles, the
// second the descriptor's leading byte offset after the first (desc_pair):
// the kernel tools' products of two heads' or two operands' tiles at once.
template <int TB>
__device__ __forceinline__ void wgmma_rs128(float* lo, float* hi, const uint32_t* a, uint64_t db,
                                            int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %69;\n"
      "}\n"
      : "+f"(lo[0]), "+f"(lo[1]), "+f"(lo[2]), "+f"(lo[3]), "+f"(lo[4]), "+f"(lo[5]),
        "+f"(lo[6]), "+f"(lo[7]), "+f"(lo[8]), "+f"(lo[9]), "+f"(lo[10]), "+f"(lo[11]),
        "+f"(lo[12]), "+f"(lo[13]), "+f"(lo[14]), "+f"(lo[15]), "+f"(lo[16]), "+f"(lo[17]),
        "+f"(lo[18]), "+f"(lo[19]), "+f"(lo[20]), "+f"(lo[21]), "+f"(lo[22]), "+f"(lo[23]),
        "+f"(lo[24]), "+f"(lo[25]), "+f"(lo[26]), "+f"(lo[27]), "+f"(lo[28]), "+f"(lo[29]),
        "+f"(lo[30]), "+f"(lo[31]), "+f"(hi[0]), "+f"(hi[1]), "+f"(hi[2]), "+f"(hi[3]),
        "+f"(hi[4]), "+f"(hi[5]), "+f"(hi[6]), "+f"(hi[7]), "+f"(hi[8]), "+f"(hi[9]),
        "+f"(hi[10]), "+f"(hi[11]), "+f"(hi[12]), "+f"(hi[13]), "+f"(hi[14]), "+f"(hi[15]),
        "+f"(hi[16]), "+f"(hi[17]), "+f"(hi[18]), "+f"(hi[19]), "+f"(hi[20]), "+f"(hi[21]),
        "+f"(hi[22]), "+f"(hi[23]), "+f"(hi[24]), "+f"(hi[25]), "+f"(hi[26]), "+f"(hi[27]),
        "+f"(hi[28]), "+f"(hi[29]), "+f"(hi[30]), "+f"(hi[31])
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
// The MN-major slice kk of two tiles read as one 128-column operand:
// columns 0 .. 63 from tile `first`, 64 .. 127 from tile `second`, which
// lies after it (the leading byte offset, under 256 KB).
__device__ __forceinline__ uint64_t desc_pair(uint32_t first, uint32_t second, int kk) {
  return smem_desc(first + kk * 2048, second - first, 1024);
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

// The exact softmax's exponentials of a 64-row tile's logits, the whole
// row in registers: s[kt] holds the raw q.k of a thread's rows r0 = g and
// r1 = g + 8 of its warp's 16 against key columns 64 kt + 8 j + 2 t (+1)
// (the accumulator layout of S = Q K^T). In base-2 units, x = s * c2 +
// bias2[key] (with MASK capped at the key's cap and the row's qc0, qc1);
// mx0, mx1: the rows' max over keys < N, in two running values each
// (shorter chains), then over the lane quad; s becomes ex2(x - max), 0 in
// the groups of 8 key columns at or past N; sum0, sum1: the rows' sums, in
// the same order.
template <bool MASK, int KT>
__device__ __forceinline__ void row_exp(float (&s)[KT][32], const float* bias2, const float* cap,
                                        float qc0, float qc1, int N, int nt, int t, float c2,
                                        float& mx0, float& mx1, float& sum0, float& sum1) {
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
  mx0 = quad_max(fmaxf(m0[0], m0[1]));
  mx1 = quad_max(fmaxf(m1[0], m1[1]));
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
  sum0 = quad_sum(l0[0] + l0[1]);
  sum1 = quad_sum(l1[0] + l1[1]);
}

// The forward's walk over the query tiles (see attention_sm90.cu): q's
// tiles at sq, the first 1024-aligned byte of the dynamic shared memory,
// k's at sk and v's at sv,
// each a 64-row tile of 8 KB with the 128-byte swizzle, rows past N zeros
// (past nq for the queries). Barrier bars has completed (query tile 0 and
// the keys); bars + 8 (the values) and bars + 16 (the other query tiles,
// not RECT) complete on their own. bias2, cap: key_vectors'; csw [4][MAXN]
// the per-warp column sums; qcap the rectangular variant's query caps (it
// may alias csw). Each output tile goes through its query tile's shared
// memory and out by a TMA store on map_o (ho: its head dim first). row0,
// colsum and stats as attention_fwd_sm90 takes them; nq: the query rows
// (N but in the rectangular variant), nt and ntq: the key and query tiles;
// bh = b H + h; tid = threadIdx.x, warp, lane, g = lane / 4 and t = lane % 4.
template <bool NORM_P, bool MASK, bool RECT, int KT>
__device__ __forceinline__ void attention_fwd_tiles(
    uint32_t sq, uint32_t sk, uint32_t sv, uint32_t bars, const float* bias2,
    const float* cap, float* csw, const float* qcap, const CUtensorMap* map_o, bool ho,
    float* row0, float* colsum, float2* stats, int N, int nq, int nt, int ntq, int bh, int h,
    int b, int tid, int warp, int lane, int g, int t, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);  // sq, generic
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
      float mx0, mx1, sum0, sum1;
      row_exp<MASK, KT>(s, bias2, cap, qc0, qc1, N, nt, t, c2, mx0, mx1, sum0, sum1);
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
    if (tid == 0) store_tile(map_o, ho, sq + qi * TILE, qi * ROWS, h, b);
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

// The backward's walk over the key tiles (see attention_sm90.cu), from the
// head's q, k, v and dO tiles at sq, sk, sv and sdo, in that order from the
// first 1024-aligned byte of the dynamic shared memory (each nt 64-row
// tiles of 8 KB with the 128-byte swizzle, rows past N zeros), and the per-row
// vectors [MAXN]: bias2 and cap (key_vectors'), the base-2 row max sm2
// (+inf past N), 1/sum sr (0 past N), delta sd, the colsum cotangent sc and
// the row0 cotangent sw (0 past N). In round r warpgroup w takes key tile
// 2 r + w and walks the query tiles from tile w on (rotated): S^T = K Q^T
// and dP^T = V dO^T on wgmma, P^T (probs_t) and dS^T = P^T (dP^T - delta)
// * scale in registers (EXACT: the colsum cotangent added to dP on every
// valid query row; MASK: dS zero at every masked pair), then
// - not PACK2 (every attention backward of the main path): dV += P^T dO
//   and dK += dS^T Q on wgmma with A from registers; dS^T staged as bf16
//   in the warpgroup's tile at sds0 + wg TILE, and this key tile's part of
//   dQ, dS K, run on wgmma (A read transposed) and added to the fp32 dQ at
//   dq32 [nt * 64][64] in a fixed order: the warpgroups step in lockstep
//   (a block barrier a step), each on another query tile, so the additions
//   into each tile come in one order, with no atomics. At the end dQ,
//   rounded, leaves by TMA stores from the query tiles on map_dq.
// - PACK2 (the kernel tool proto_attn_bwd.cu's pack2): [dS | P]^T . [Q |
//   dO] as two m64n128 products, dS^T [Q | dO] and P^T [Q | dO], both from
//   one 128-column B operand (a query tile and its dO tile); dK and dV are
//   the wanted quadrants, the other two are summed into one discarded
//   accumulator, live only across the products. dQ is not made here (the
//   caller's pass over the query tiles makes it), so dq32 and the staging
//   tiles are not touched.
// dbias (may be null) gets each key's unscaled dS summed over the query
// rows. dK and dV of each key tile leave, rounded, by TMA stores from its
// K and V tiles on map_dk and map_dv. h_first: bit 5 dQ's map head dim
// first, bit 6 dK's, bit 7 dV's; vec = (b H + h) N.
template <bool MASK, bool EXACT, bool PACK2>
__device__ __forceinline__ void attention_bwd_keys(
    uint32_t sq, uint32_t sk, uint32_t sv, uint32_t sdo, uint32_t sds0, float* dq32,
    const float* bias2, const float* cap, const float* sm2, const float* sr, const float* sd,
    const float* sc, const float* sw, const CUtensorMap* map_dq, const CUtensorMap* map_dk,
    const CUtensorMap* map_dv, int h_first, float* dbias, size_t vec, int N, int nt, int h,
    int b, int tid, int wg, int wt, int warp, int g, int t, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);
  const float c2 = scale * LOG2E;
  if constexpr (!PACK2) {
    // the fp32 dQ starts at zero (O's tiles are read)
    for (int i = tid; i < nt * ROWS * HD / 4; i += BWD_THREADS)
      reinterpret_cast<float4*>(dq32)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }

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
        if constexpr (PACK2) {
          // [dK | dS^T dO] and [P^T Q | dV] from one B = [Q | dO] (rows past
          // N: P, dS, Q and dO are 0); the discarded quadrants summed into
          // drop, live only across these products
          float drop[32];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int acc = step > 0 || kk > 0;
            const uint64_t qdo = desc_pair(sq + it * TILE, sdo + it * TILE, kk);
            wgmma_rs128<1>(dk, drop, da + 4 * kk, qdo, acc);
            wgmma_rs128<1>(drop, dv, pa + 4 * kk, qdo, acc);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence32(dv);
          fence32(dk);
          fence32(drop);
        } else {
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
      }
      if constexpr (!PACK2) __syncthreads();  // the step's additions into dQ are done
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
      store_tile(map_dk, h_first & 64, sk + jt * TILE, jt * ROWS, h, b);
      store_tile(map_dv, h_first & 128, sv + jt * TILE, jt * ROWS, h, b);
    }
  }

  if constexpr (!PACK2) {
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
      for (int it = 0; it < nt; ++it) store_tile(map_dq, h_first & 32, sq + it * TILE, it * ROWS, h, b);
  }
  if (wt == 0) tma_store_wait();
}

// ---------------------------------------------------------------- host
// The map of one [B, H, N, 64] bf16 operand with element strides
// st = (batch, head, row), in boxes of one 64-row tile of one (image,
// head) with the 128-byte swizzle (box_rows rows: 16 for the stacked
// prototype's query rows); rows past N read as zeros and are not
// written. The head and row dims go in the order of their strides (so the
// strides grow, as cuTensorMapEncodeTiled expects); *h_first tells which
// came first. A stride of a dim of size 1 is not read: it is set to keep
// that order.
cudaError_t heads_map(CUtensorMap* map, const void* ptr, const long long* st, int B, int H, int N,
                      bool* h_first, int box_rows = ROWS) {
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
  const cuuint32_t box[4] = {HD, hf ? 1u : static_cast<cuuint32_t>(box_rows),
                             hf ? static_cast<cuuint32_t>(box_rows) : 1u, 1};
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
