// Softmax attention for short sequences (N <= 256) at head dim 64. Each of
// q, k, v and the output is a [B, H, N, 64] operand with the head dim
// contiguous and its own batch, head and row strides, so one kernel reads
// the packed qkv projection [B, N, 3D] in timm's (3, H, hd) column order
// and writes merged heads [B, N, D] (the eval blocks), or reads and writes
// q, k, v [B, H, N, hd] views of any layout (the training attention core).
// An optional fp32 per-key bias [B, N] is added after the scale:
// logits = q.k * scale + bias[key] (ToMe's log-size bias). Optional
// by-products, both fp32 [B, H, N]:
//   row0[b, h, :]   = the CLS query row of the probabilities;
//   colsum[b, h, :] = the column mass, sum over queries of the probabilities.
// An optional validity mask [B, N] (ATS's pad slots; the counterpart of the
// mask of tokenreduction_tpu/ops/flash_attention.py fused_attention and
// fused_block_attention): a logit whose query or key token is invalid is
// replaced by -FLT_MAX after the scale and the bias, so a fully masked
// query row is uniform over its N keys and adds to row0 and colsum like
// any other row (padding columns past N stay -inf, below -FLT_MAX). The
// rectangular variant (fused_rect_attention and fused_rect_block there)
// takes M query rows ids[b, m] of q over all N keys and values, the query
// validity being the mask at that row, and writes out [B, H, M, 64] and
// no by-products (an id outside 0..N-1 traps).
// Its backward: from q, k, v, the output's gradient dO, the fp32
// cotangents of row0 and colsum, the bias and the validity mask, the
// gradients dq, dk, dv (same layouts) and the per-head bias gradient
// dbias [B, H, N] fp32 (the counterpart of _bwd_kernel in
// tokenreduction_tpu/ops/flash_attention_train.py). With the mask it
// recomputes the forward's capped logits, so a fully masked query row is
// uniform again, and zeroes dS at every masked pair: dq, dk and dbias take
// nothing from such a pair, while dV = P^T dO keeps the uniform rows' P.
// And head_mean_keys: the head mean of the keys of a packed qkv, [B, N, hd]
// (ToMe's merge metric).
//
// Every bf16 attention, square and rectangular, and the bf16 backward are
// attention_sm90.cu's (TMA, cp.async, wgmma); this file keeps the fp32
// kernels and head_mean_keys. One thread block per (image, head): that
// head's k and v live in shared memory and each warp owns query rows, with
// the exact row max in an fp32 softmax.
//
// fp32, the square forward with every option: 3xTF32 on the tensor cores,
// mma.sync (short_attention_tf32_kernel, see its note). The rectangular
// forward (ATS in fp32) and the backward (fp32 training only): FMAs on the
// CUDA cores, a lane per key. The backward recomputes the
// probabilities with the exact row max and runs in two phases per (image,
// head). Phase 1, a warp per query row: the row statistics, delta_i =
// sum_j P_ij dP_ij with dP = dO V^T plus the row0 cotangent on query row 0
// and the colsum cotangent on every row, dS = P (dP - delta) * scale (zero
// at a masked pair) and dQ = dS K. Phase 2, a warp per key: dV = P^T dO,
// dK = dS^T Q and dbias_j = the unscaled dS summed over the key's column.
// Each sum stays inside one warp: no atomics. colsum is reduced inside the
// block in a fixed order.
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace trk {
namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;
constexpr int MAXN = 256;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;

// One [B, H, N, HD] operand with the head dim contiguous: element
// (b, h, n, d) at p[b * sb + h * sh + n * sn + d].
template <typename T>
struct Heads {
  T* p;
  long long sb, sh, sn;
  __device__ __forceinline__ T* row(int b, int h, int n) const {
    return p + b * sb + h * sh + n * sn;
  }
};

// The caps of the square attention's tokens (MASK variants of the
// backward): cap[j] = +inf for a valid token j < N, else -FLT_MAX. A
// token is a query row and a key at once, so one row serves both sides of
// the pair: its logit is min(x, cap[i], cap[j]), as in the forward.
__device__ __forceinline__ void load_caps(float* cap, const unsigned char* mrow, int N) {
  for (int j = threadIdx.x; j < MAXN; j += THREADS)
    cap[j] = j < N && mrow[j] ? INFINITY : -FLT_MAX;
}

// ---------------------------------------------------------------- fp32
constexpr int KLD = HD + 1;  // odd word stride: lanes reading different keys hit different banks
constexpr int KEYS_PER_LANE = MAXN / 32;

size_t fma_smem_bytes(int n) {
  return sizeof(float) * (WARPS * HD + WARPS * MAXN + static_cast<size_t>(n) * (HD + KLD));
}

// The rectangular forward (ATS in fp32): out row m is query row ids[b, m]
// over all N keys, with the validity mask and no bias or by-products; a
// warp per query row, a lane per key. The square variants run
// short_attention_tf32_kernel.
__global__ void __launch_bounds__(THREADS)
    short_attention_rect_fma_kernel(Heads<const float> q, Heads<const float> k,
                                    Heads<const float> v, Heads<float> out,
                                    const unsigned char* __restrict__ mask,
                                    const int* __restrict__ ids, int N, int M, int H,
                                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qbuf = reinterpret_cast<float*>(smem);  // [WARPS][HD]
  float* pbuf = qbuf + WARPS * HD;               // [WARPS][MAXN]
  float* Vs = pbuf + WARPS * MAXN;               // [N][HD]
  float* Ks = Vs + N * HD;                       // [N][KLD]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const unsigned char* mrow = mask + static_cast<size_t>(b) * N;
  for (int e = threadIdx.x; e < N * HD; e += THREADS) {
    const int n = e / HD, d = e % HD;
    Ks[n * KLD + d] = k.row(b, h, n)[d];
    Vs[n * HD + d] = v.row(b, h, n)[d];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* qv = qbuf + warp * HD;
  float* p = pbuf + warp * MAXN;
  for (int i = warp; i < M; i += WARPS) {
    const int qi = ids[static_cast<size_t>(b) * M + i];
    if (static_cast<unsigned>(qi) >= static_cast<unsigned>(N)) __trap();
    const bool q_ok = mrow[qi];
    const float* qrow = q.row(b, h, qi);
    qv[lane] = qrow[lane];
    qv[lane + 32] = qrow[lane + 32];
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
        for (int d = 0; d < HD; ++d) acc = fmaf(qv[d], kr[d], acc);
        acc *= scale;
        if (!(q_ok && mrow[j])) acc = -FLT_MAX;  // the JAX pair mask
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
      if (j < N) p[j] = s[t];
    }
    __syncwarp();

    float o0 = 0.f, o1 = 0.f;
    const float2* v2 = reinterpret_cast<const float2*>(Vs);
    for (int j = 0; j < N; ++j) {
      const float2 vv = v2[j * (HD / 2) + lane];
      o0 = fmaf(p[j], vv.x, o0);
      o1 = fmaf(p[j], vv.y, o1);
    }
    float* orow = out.row(b, h, i);
    orow[2 * lane] = o0 * rinv;
    orow[2 * lane + 1] = o1 * rinv;
    __syncwarp();
  }
}

// ---------------------------------------------------------------- fp32 on the tensor cores
// The square fp32 forward with every option (bias, mask, row0, colsum) in
// 3xTF32 on the tensor cores: the counterpart of the fp32 attention of the
// TPU kernels tokenreduction_tpu/ops/fused_full_block.py fused_full_block,
// ops/flash_attention.py fused_block_attention, fused_attention and
// fused_attention_qkv, and the forward of ops/flash_attention_train.py
// attention_core_train, whose fp32 dots run on the MXU in the multi-pass
// form at the kernels' pinned DEFAULT precision.
//
// What bounds it: at B = 256, H = 6, N = 197 the products take 15.3 GFLOP,
// 45.8 in 3xTF32 (three TF32 products each), 0.093 ms at the H100's 494.7
// TFLOP/s of dense TF32; q, k, v in and the output out are 310 MB, 0.093
// ms at 3.35 TB/s. On the CUDA cores (FMA, 67 TFLOP/s) the products alone
// take 0.228 ms.
//
// Design. One block per (image, head), 8 warps in 4 pairs: the head's Q, K
// and V in shared memory, fp32, copied by cp.async all at once, rows padded
// with zeros to KC * 32, a row stride of 68 floats, so every fragment load
// below hits 32 banks. A pair of warps takes 16 query rows at a time, each
// warp half of the keys, with mma.sync.m16n8k8.tf32 tiles:
//   - S = Q K^T over the warp's keys: the fragments split in registers as
//     they are read (no hi/lo copies in shared memory: Q, K and V alone
//     are 182 KB at N = 197), the warp's half of the row of S (KC * 16
//     keys, 8 KC registers a thread) kept in registers. KC is a template
//     constant (N <= 32 KC): every loop over the keys is unrolled with no
//     test of N inside it, so the products of neighbouring key tiles
//     overlap (a test a tile made each its own basic block, and a build
//     that had one ran slower on the H100). A warp that held whole rows of
//     S spilled at 255 registers; pairs of 12 or 16 warps, with fewer
//     registers a thread, spilled more and ran slower than 4 pairs;
//   - the logits in the FMA kernel's order: scale, bias, caps (-FLT_MAX at
//     a masked pair, -inf past N); the exact row max and the sum over the
//     four lanes that share a row, then over the pair through shared
//     memory (the max of the two halves; their sums added half 0 first);
//   - O = P V over the warp's keys with the unnormalised P split after the
//     softmax, the two halves' partial O added (half 0 first) through the
//     tile's own rows of Q in shared memory, no longer read, each warp
//     scaling and storing 32 of the 64 columns by 1/sum. The accumulator
//     layout of S (a thread's two neighbouring keys 2t, 2t+1 of a tile of
//     8) is not mma's A layout (keys t, t+4), so the product reads keys in
//     the order 2t -> k index t, 2t+1 -> t+4 on both sides: P's registers
//     are A's fragment as they stand, and V's rows are read in that order
//     (the sum over keys is the same);
//   - each product is lo.hi + hi.lo + hi.hi a slice, into one fp32
//     accumulator: about 2^-22 of a product is dropped (lo.lo). The tensor
//     cores add a product to their accumulator with truncation, so each
//     addition at the sum's full size pulls it toward zero by up to an
//     ulp: the small products of every slice go in first, then the large
//     ones, 8 additions at full size for a logit (the head dim's slices)
//     and one a key tile for O, where the products in slice order made 24
//     and three a tile (a build that added them so had several times the
//     FMA kernel's error in a block's output);
//   - row0 from the pair that holds query row 0; colsum of the normalised
//     probabilities: a warp's 16 rows by a shuffle butterfly, added in its
//     pair's row of shared memory (each key is one warp's) tile after tile,
//     then the pairs' rows in order: no atomics, the same bits from run to
//     run.
constexpr int TC_LD = HD + 4;
constexpr int TC_WARPS = 8;
constexpr int TC_PAIRS = TC_WARPS / 2;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_KEYS = 32;  // the keys of a chunk: N <= TC_KEYS * KC
constexpr int TC_STATS = 64;  // a pair's row statistics: [half][max, sum][16 rows]

constexpr int tf32_chunks(int n) { return (n + TC_KEYS - 1) / TC_KEYS; }

// Q, K, V, the pairs' colsum rows, their statistics
constexpr size_t tf32_smem_bytes(int n) {
  return sizeof(float) * (static_cast<size_t>(tf32_chunks(n)) * TC_KEYS * (3 * TC_LD + TC_PAIRS) +
                          TC_PAIRS * TC_STATS);
}
// the widest variant's block within the H100's 227 KB (smaller n take less)
static_assert(tf32_smem_bytes(MAXN) <= 232448, "over the H100's 227 KB of shared memory a block");

// d += a . b, m16n8k8, TF32 operands as fp32 bit patterns, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The two small products of a 3xTF32 product, d += a_lo . b_hi + a_hi .
// b_lo, a split already, b = {b0, b1} split here.
__device__ __forceinline__ void mma_small(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh[2], bl[2];
  split_tf32(b0, bh[0], bl[0]);
  split_tf32(b1, bh[1], bl[1]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
}

// Its large product, d += a_hi . b_hi.
__device__ __forceinline__ void mma_big(float (&d)[4], const uint32_t (&ah)[4], float b0,
                                        float b1) {
  const uint32_t bh[2] = {tf32_rna(b0), tf32_rna(b1)};
  mma_tf32(d, ah, bh);
}

// The A fragment of 16 rows x 8 columns at p (row stride TC_LD): a thread's
// rows g and g + 8, columns t and t + 4, split.
__device__ __forceinline__ void a_fragment(const float* p, uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float a[4] = {p[0], p[8 * TC_LD], p[4], p[8 * TC_LD + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
}

template <bool MASK, int KC>
__global__ void __launch_bounds__(TC_THREADS, 1)
    short_attention_tf32_kernel(Heads<const float> q, Heads<const float> k, Heads<const float> v,
                                Heads<float> out, const float* __restrict__ bias,
                                const unsigned char* __restrict__ mask,
                                float* __restrict__ row0, float* __restrict__ colsum, int N,
                                int H, float scale) {
  constexpr int ROWS = KC * TC_KEYS, NH = ROWS / 16;  // a warp's key tiles of 8
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [ROWS][TC_LD]
  float* Ks = Qs + ROWS * TC_LD;               // [ROWS][TC_LD]
  float* Vs = Ks + ROWS * TC_LD;               // [ROWS][TC_LD]
  float* csw = Vs + ROWS * TC_LD;              // [TC_PAIRS][ROWS]
  float* stw = csw + TC_PAIRS * ROWS;          // [TC_PAIRS][TC_STATS]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * N;
  const unsigned char* mrow = MASK ? mask + static_cast<size_t>(b) * N : nullptr;
  for (int e = threadIdx.x; e < ROWS * (HD / 4); e += TC_THREADS) {
    const int n = e / (HD / 4), c = (e % (HD / 4)) * 4;
    const bool in = n < N;  // rows past N are zero-filled
    const int src = in ? n : 0;
    cp_async16(Qs + n * TC_LD + c, q.row(b, h, src) + c, in);
    cp_async16(Ks + n * TC_LD + c, k.row(b, h, src) + c, in);
    cp_async16(Vs + n * TC_LD + c, v.row(b, h, src) + c, in);
  }
  cp_async_commit();
  for (int e = threadIdx.x; e < TC_PAIRS * ROWS; e += TC_THREADS) csw[e] = 0.f;
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pair = warp >> 1, half = warp & 1;
  const int key0 = half * (ROWS / 2);  // this warp's keys: key0 + 0 .. ROWS / 2 - 1
  float* cs = csw + pair * ROWS;
  float* st = stw + pair * TC_STATS;  // st[32 half + 16 (sum) + row]
  const auto pair_sync = [pair]() {
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
  };
  for (int r0 = pair * 16; r0 < N; r0 += TC_PAIRS * 16) {
    // this thread's rows: ra = r0 + g and rb = r0 + g + 8 (rows past N are
    // zeros and are never written)
    const int ra = r0 + g, rb = ra + 8;
    float s[NH][4];
#pragma unroll
    for (int j = 0; j < NH; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // the small products of every slice, then the large ones: a logit is
    // truncated at its full size 8 times, not 24 (see the note)
#pragma unroll
    for (int big = 0; big < 2; ++big)
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        uint32_t ah[4], al[4];
        a_fragment(Qs + ra * TC_LD + 8 * kk + t, ah, al);
        const float* kr = Ks + (key0 + g) * TC_LD + 8 * kk + t;
#pragma unroll
        for (int j = 0; j < NH; ++j) {
          if (big)
            mma_big(s[j], ah, kr[8 * j * TC_LD], kr[8 * j * TC_LD + 4]);
          else
            mma_small(s[j], ah, al, kr[8 * j * TC_LD], kr[8 * j * TC_LD + 4]);
        }
      }

    // the logits (scale, bias, caps) and the exact row max: s[j][e] is row
    // ra and s[j][2 + e] row rb, at key key0 + 8 j + 2 t + e
    const bool oka = !MASK || (ra < N && mrow[ra]);
    const bool okb = !MASK || (rb < N && mrow[rb]);
    float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + 2 * t + e;
        const bool in = key < N;
        float xa = s[j][e] * scale, xb = s[j][2 + e] * scale;
        if (brow != nullptr) {
          const float bk = in ? brow[key] : 0.f;
          xa += bk, xb += bk;
        }
        if constexpr (MASK) {
          const bool kok = in && mrow[key];
          if (!(oka && kok)) xa = -FLT_MAX;  // the JAX pair mask
          if (!(okb && kok)) xb = -FLT_MAX;
        }
        s[j][e] = in ? xa : -INFINITY;
        s[j][2 + e] = in ? xb : -INFINITY;
        mxa = fmaxf(mxa, s[j][e]);
        mxb = fmaxf(mxb, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, o));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, o));
    }
    if (t == 0) st[32 * half + g] = mxa, st[32 * half + 8 + g] = mxb;
    pair_sync();  // also: both warps are done reading the tile's rows of Q
    mxa = fmaxf(st[g], st[32 + g]);
    mxb = fmaxf(st[8 + g], st[40 + g]);
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = key0 + 8 * j + 2 * t + e < N;
        s[j][e] = in ? expf(s[j][e] - mxa) : 0.f;
        s[j][2 + e] = in ? expf(s[j][2 + e] - mxb) : 0.f;
        suma += s[j][e];
        sumb += s[j][2 + e];
      }
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      suma += __shfl_xor_sync(0xffffffffu, suma, o);
      sumb += __shfl_xor_sync(0xffffffffu, sumb, o);
    }
    if (t == 0) st[32 * half + 16 + g] = suma, st[32 * half + 24 + g] = sumb;
    pair_sync();
    const float ria = 1.0f / (st[16 + g] + st[48 + g]);
    const float rib = 1.0f / (st[24 + g] + st[56 + g]);

    if (row0 != nullptr && r0 == 0 && g == 0) {
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + 8 * j + 2 * t + e;
          if (key < N) row0[static_cast<size_t>(bh) * N + key] = s[j][e] * ria;
        }
    }
    if (colsum != nullptr) {
      const float wa = ra < N ? ria : 0.f, wb = rb < N ? rib : 0.f;
#pragma unroll
      for (int j = 0; j < NH; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float c = s[j][e] * wa + s[j][2 + e] * wb;
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
          if (g == 0) cs[key0 + 8 * j + 2 * t + e] += c;  // keys past N stay 0
        }
    }

    // O = P V over the warp's keys: A = P's registers (k index t <- key
    // 2t, t + 4 <- key 2t + 1)
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
    for (int big = 0; big < 2; ++big)
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const float p[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(p[i], ph[i], pl[i]);
        const float* vr = Vs + (key0 + 8 * j + 2 * t) * TC_LD + g;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          if (big)
            mma_big(o[n], ph, vr[8 * n], vr[TC_LD + 8 * n]);
          else
            mma_small(o[n], ph, pl, vr[8 * n], vr[TC_LD + 8 * n]);
        }
      }
    // the two halves' O: each warp hands over the 32 columns the other
    // stores, through the tile's rows of Q
    float* xo = Qs + r0 * TC_LD;
    constexpr int OWN = HD / 16;  // a warp's column tiles of 8
    // (o indexed by constants only, the halves chosen by selects: an index
    // that depends on the warp would put o in local memory)
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const int col = 8 * ((1 - half) * OWN + i) + 2 * t;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = half ? o[i][e] : o[OWN + i][e];
      *reinterpret_cast<float2*>(xo + g * TC_LD + col) = make_float2(x[0], x[1]);
      *reinterpret_cast<float2*>(xo + (g + 8) * TC_LD + col) = make_float2(x[2], x[3]);
    }
    pair_sync();
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const int col = 8 * (half * OWN + i) + 2 * t;
      const float2 xa = *reinterpret_cast<const float2*>(xo + g * TC_LD + col);
      const float2 xb = *reinterpret_cast<const float2*>(xo + (g + 8) * TC_LD + col);
      const float x[4] = {xa.x, xa.y, xb.x, xb.y};
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // half 0's partial first
        const float mine = half ? o[OWN + i][e] : o[i][e];
        y[e] = half ? x[e] + mine : mine + x[e];
      }
      if (ra < N) *reinterpret_cast<float2*>(out.row(b, h, ra) + col) = make_float2(y[0] * ria, y[1] * ria);
      if (rb < N) *reinterpret_cast<float2*>(out.row(b, h, rb) + col) = make_float2(y[2] * rib, y[3] * rib);
    }
  }

  if (colsum != nullptr) {
    __syncthreads();
    for (int j = threadIdx.x; j < N; j += TC_THREADS) {
      float acc = 0.f;
      for (int p = 0; p < TC_PAIRS; ++p) acc += csw[p * ROWS + j];
      colsum[static_cast<size_t>(bh) * N + j] = acc;
    }
  }
}

template <bool MASK, int KC>
int launch_attention_tf32_kc(const Heads<const float>& q, const Heads<const float>& k,
                             const Heads<const float>& v, const Heads<float>& out,
                             const float* bias, const unsigned char* mask, float* row0,
                             float* colsum, int B, int N, int H, float scale, cudaStream_t s) {
  const auto kernel = short_attention_tf32_kernel<MASK, KC>;
  const size_t bytes = tf32_smem_bytes(N);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, TC_THREADS, bytes, s>>>(q, k, v, out, bias, mask, row0, colsum, N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

// The variant whose row of S holds N keys: KC = ceil(N / 32), 1 .. 8.
template <bool MASK>
int launch_attention_tf32(const Heads<const float>& q, const Heads<const float>& k,
                          const Heads<const float>& v, const Heads<float>& out, const float* bias,
                          const unsigned char* mask, float* row0, float* colsum, int B, int N,
                          int H, float scale, cudaStream_t s) {
#define TR_TF32_KC(KC)                                                                      \
  case KC:                                                                                  \
    return launch_attention_tf32_kc<MASK, KC>(q, k, v, out, bias, mask, row0, colsum, B, N, \
                                              H, scale, s);
  switch (tf32_chunks(N)) {
    TR_TF32_KC(1)
    TR_TF32_KC(2)
    TR_TF32_KC(3)
    TR_TF32_KC(4)
    TR_TF32_KC(5)
    TR_TF32_KC(6)
    TR_TF32_KC(7)
    TR_TF32_KC(8)
  }
#undef TR_TF32_KC
  return static_cast<int>(cudaErrorInvalidValue);
}

size_t bwd_fma_smem_bytes(int n, bool masked) {
  return sizeof(float) * (2 * static_cast<size_t>(n) * KLD + 2 * WARPS * HD + 2 * WARPS * MAXN +
                          (masked ? 5 : 4) * MAXN);
}

// fp32 backward on the CUDA cores, in two phases: a warp per query row
// (phase 1) and per key (phase 2); shared memory holds K and V in phase 1,
// then Q and dO in phase 2. bias, dcs and dbias may be null. MASK: the
// validity mask.
template <bool MASK>
__global__ void __launch_bounds__(THREADS)
    short_attention_bwd_fma_kernel(Heads<const float> q, Heads<const float> k,
                                   Heads<const float> v, Heads<const float> dout, Heads<float> dq,
                                   Heads<float> dk, Heads<float> dv,
                                   const float* __restrict__ bias,
                                   const unsigned char* __restrict__ mask,
                                   const float* __restrict__ drow0,
                                   const float* __restrict__ dcs, float* __restrict__ dbias,
                                   int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sA = reinterpret_cast<float*>(smem);  // [N][KLD]: K, then Q
  float* sB = sA + N * KLD;                    // [N][KLD]: V, then dO
  float* vec = sB + N * KLD;                   // [WARPS][2][HD]: the warp's own two rows
  float* pb = vec + 2 * WARPS * HD;            // [WARPS][MAXN] probabilities
  float* db = pb + WARPS * MAXN;               // [WARPS][MAXN] dS
  float* sM = db + WARPS * MAXN;               // [MAXN] row max
  float* sR = sM + MAXN;                       // [MAXN] 1/row sum
  float* sD = sR + MAXN;                       // [MAXN] delta
  float* sW = sD + MAXN;                       // [MAXN] row0 cotangent
  float* sCap = sW + MAXN;                     // [MAXN] caps (MASK)

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const float* brow = bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * N;
  const float* crow = dcs == nullptr ? nullptr : dcs + static_cast<size_t>(bh) * N;
  auto fill = [&](const Heads<const float>& a, const Heads<const float>& c) {
    for (int e = threadIdx.x; e < N * HD; e += THREADS) {
      const int n = e / HD, d = e % HD;
      sA[n * KLD + d] = a.row(b, h, n)[d];
      sB[n * KLD + d] = c.row(b, h, n)[d];
    }
  };
  fill(k, v);
  for (int j = threadIdx.x; j < MAXN; j += THREADS)
    sW[j] = drow0 != nullptr && j < N ? drow0[static_cast<size_t>(bh) * N + j] : 0.f;
  if constexpr (MASK) load_caps(sCap, mask + static_cast<size_t>(b) * N, N);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* u = vec + warp * 2 * HD;  // q (phase 1) or k (phase 2)
  float* w = u + HD;               // dO (phase 1) or v (phase 2)
  float* p = pb + warp * MAXN;
  float* ds = db + warp * MAXN;
  auto dot = [&](const float* a, const float* row) {
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) acc = fmaf(a[d], row[d], acc);
    return acc;
  };

  // phase 1: a warp per query row i
  for (int i = warp; i < N; i += WARPS) {
    const float* qrow = q.row(b, h, i);
    const float* orow = dout.row(b, h, i);
    u[lane] = qrow[lane], u[lane + 32] = qrow[lane + 32];
    w[lane] = orow[lane], w[lane + 32] = orow[lane + 32];
    __syncwarp();
    float s[KEYS_PER_LANE], dp[KEYS_PER_LANE];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      const int j = lane + 32 * t;
      s[t] = -INFINITY, dp[t] = 0.f;
      if (j < N) {
        s[t] = dot(u, sA + j * KLD) * scale;
        if (brow != nullptr) s[t] += brow[j];
        if constexpr (MASK) s[t] = fminf(fminf(s[t], sCap[j]), sCap[i]);
        dp[t] = dot(w, sB + j * KLD) + (i == 0 ? sW[j] : 0.f);
        if (crow != nullptr) dp[t] += crow[j];
      }
      mx = fmaxf(mx, s[t]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      s[t] = lane + 32 * t < N ? expf(s[t] - mx) : 0.f;
      sum += s[t];
    }
    const float rinv = 1.0f / warp_sum(sum);
    float dl = 0.f;
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      s[t] *= rinv;
      dl += s[t] * dp[t];
    }
    dl = warp_sum(dl);
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      const int j = lane + 32 * t;
      if (j < N) ds[j] = s[t] * (dp[t] - dl) * scale;
      if constexpr (MASK)  // dS is zero at a masked pair
        if (j < N && !(sCap[i] > 0.f && sCap[j] > 0.f)) ds[j] = 0.f;
    }
    if (lane == 0) sM[i] = mx, sR[i] = rinv, sD[i] = dl;
    __syncwarp();
    float q0 = 0.f, q1 = 0.f;
    for (int j = 0; j < N; ++j) {
      q0 = fmaf(ds[j], sA[j * KLD + lane], q0);
      q1 = fmaf(ds[j], sA[j * KLD + lane + 32], q1);
    }
    float* dqrow = dq.row(b, h, i);
    dqrow[lane] = q0, dqrow[lane + 32] = q1;
    __syncwarp();
  }
  __syncthreads();
  fill(q, dout);
  __syncthreads();

  // phase 2: a warp per key j
  for (int j = warp; j < N; j += WARPS) {
    const float* krow = k.row(b, h, j);
    const float* vrow = v.row(b, h, j);
    u[lane] = krow[lane], u[lane + 32] = krow[lane + 32];
    w[lane] = vrow[lane], w[lane + 32] = vrow[lane + 32];
    const float bj = brow != nullptr ? brow[j] : 0.f;
    const float cj = crow != nullptr ? crow[j] : 0.f;
    __syncwarp();
    float dsum = 0.f;
#pragma unroll
    for (int t = 0; t < KEYS_PER_LANE; ++t) {
      const int i = lane + 32 * t;
      if (i >= N) continue;
      float l = dot(u, sA + i * KLD) * scale;
      if (brow != nullptr) l += bj;
      if constexpr (MASK) l = fminf(fminf(l, sCap[j]), sCap[i]);
      float dpv = dot(w, sB + i * KLD) + (i == 0 ? sW[j] : 0.f);
      if (crow != nullptr) dpv += cj;
      const float pr = expf(l - sM[i]) * sR[i];
      float du = pr * (dpv - sD[i]);  // unscaled dS
      if constexpr (MASK)             // zero at a masked pair (dV keeps P)
        if (!(sCap[i] > 0.f && sCap[j] > 0.f)) du = 0.f;
      p[i] = pr;
      ds[i] = du * scale;
      dsum += du;
    }
    __syncwarp();
    float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
    for (int i = 0; i < N; ++i) {
      v0 = fmaf(p[i], sB[i * KLD + lane], v0);
      v1 = fmaf(p[i], sB[i * KLD + lane + 32], v1);
      k0 = fmaf(ds[i], sA[i * KLD + lane], k0);
      k1 = fmaf(ds[i], sA[i * KLD + lane + 32], k1);
    }
    float* dkrow = dk.row(b, h, j);
    float* dvrow = dv.row(b, h, j);
    dkrow[lane] = k0, dkrow[lane + 32] = k1;
    dvrow[lane] = v0, dvrow[lane + 32] = v1;
    dsum = warp_sum(dsum);
    if (dbias != nullptr && lane == 0) dbias[static_cast<size_t>(bh) * N + j] = dsum;
    __syncwarp();
  }
}

// ---------------------------------------------------------------- keys
// 16 bytes of T as fp32 lanes.
template <typename T> struct Lanes;
template <> struct Lanes<float> {
  static constexpr int V = 4;
  __device__ static void unpack(const uint4& raw, float* f) {
    f[0] = __uint_as_float(raw.x), f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z), f[3] = __uint_as_float(raw.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Lanes<bf16> {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& raw, float* f) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h2[i]);
      f[2 * i] = v.x, f[2 * i + 1] = v.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return raw;
  }
};

constexpr int KEYS_THREADS = 256;

// keys[m, d] = (sum over heads h, in order, of the fp32 key k[m, h, d]) / H,
// rounded once to T, off a packed qkv [M, 3 * H * hd]: the counterpart of
// the ksum by-product of _block_attn_kernel
// (tokenreduction_tpu/ops/flash_attention.py). Bound by bytes: the keys
// read once, their mean written once. A thread per 16 bytes of a row's
// mean (8 bf16 or 4 fp32 lanes): each head's slice is one 16-byte load, so
// a warp reads whole 128-byte lines, and with H a template constant
// (DeiT-Ti's 3, -S's 6, -B's 12 heads) all H loads are in registers before
// the first add.
template <typename T, int H>
__global__ void __launch_bounds__(KEYS_THREADS)
    head_mean_keys_kernel(const T* __restrict__ qkv, T* __restrict__ keys, int M, int hd) {
  constexpr int V = Lanes<T>::V;
  const int groups = hd / V;  // also one head's slice, in 16-byte vectors
  const long long e = static_cast<long long>(blockIdx.x) * KEYS_THREADS + threadIdx.x;
  if (e >= static_cast<long long>(M) * groups) return;
  const int m = static_cast<int>(e / groups), g = static_cast<int>(e % groups);
  const int D = H * hd;
  const uint4* kr =
      reinterpret_cast<const uint4*>(qkv + static_cast<size_t>(m) * 3 * D + D + g * V);
  uint4 raw[H];
#pragma unroll
  for (int h = 0; h < H; ++h) raw[h] = __ldg(kr + h * groups);
  float acc[V], f[V];
  Lanes<T>::unpack(raw[0], acc);
#pragma unroll
  for (int h = 1; h < H; ++h) {
    Lanes<T>::unpack(raw[h], f);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += f[i];
  }
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = acc[i] / static_cast<float>(H);
  // keys [M, hd] is contiguous: this thread's lanes start at e * V
  reinterpret_cast<uint4*>(keys)[e] = Lanes<T>::pack(acc);
}

// The head counts of DeiT-Ti, -S and -B; any other H, an hd that is no
// multiple of the vector or a pointer that is not 16-byte aligned is
// refused (cudaErrorInvalidValue).
template <typename T>
int launch_head_mean_keys(const void* qkv, void* keys, int M, int H, int hd, cudaStream_t s) {
  constexpr int V = Lanes<T>::V;
  if (hd % V != 0 || reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(keys) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = H == 3    ? head_mean_keys_kernel<T, 3>
                      : H == 6  ? head_mean_keys_kernel<T, 6>
                      : H == 12 ? head_mean_keys_kernel<T, 12>
                                : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(M) * (hd / V);
  const int blocks = static_cast<int>((n + KEYS_THREADS - 1) / KEYS_THREADS);
  kernel<<<blocks, KEYS_THREADS, 0, s>>>(static_cast<const T*>(qkv), static_cast<T*>(keys), M,
                                         hd);
  return static_cast<int>(cudaGetLastError());
}

// Heads of the operands from strides[3 * i .. 3 * i + 2] (batch, head, row).
template <typename T, typename P>
Heads<T> heads(P ptr, const long long* strides, int i) {
  return Heads<T>{static_cast<T*>(ptr), strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

}  // namespace
}  // namespace trk

// Returns the cudaError_t of the launch (0 on success). q, k, v are
// [B, H, N, 64] operands with the head dim contiguous and out is
// [B, H, M, 64]; strides holds the (batch, head, row) strides of q, k, v
// and out, in elements. bias (fp32 [B, N]), mask ([B, N], one byte per
// token, non-zero = valid), row0 and colsum may be null; norm_p (rounding
// the normalised probabilities before PV) is a no-op in fp32. ids (int32 [B, M], with a mask and no bias, norm_p or
// by-products) selects the rectangular variant: out row m is query row
// ids[b, m] over all N keys. Without ids, M must equal N. The caller
// checks shapes, dtypes and strides. fp32 only: bf16 is
// attention_sm90.cu's tr_attention_sm90.
extern "C" int tr_short_attention(int dtype, const void* q, const void* k, const void* v,
                                  void* out, const long long* strides, const void* bias,
                                  const void* mask, const void* ids, void* row0, void* colsum,
                                  int B, int N, int M, int H, float scale, int norm_p,
                                  void* stream) {
  using namespace trk;
  if (dtype != kFloat32 || N < 1 || N > MAXN || M < 1 || M > MAXN)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool rect = ids != nullptr, masked = mask != nullptr;
  if (!rect && M != N) return static_cast<int>(cudaErrorInvalidValue);
  if (rect && (!masked || norm_p || bias != nullptr || row0 != nullptr || colsum != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  const unsigned char* mp = static_cast<const unsigned char*>(mask);
  const int* ip = static_cast<const int*>(ids);
  float* r0 = static_cast<float*>(row0);
  float* cs = static_cast<float*>(colsum);
  const auto qh = heads<const float>(q, strides, 0), kh = heads<const float>(k, strides, 1);
  const auto vh = heads<const float>(v, strides, 2);
  const auto oh = heads<float>(out, strides, 3);
  // the square variants on the tensor cores; the rectangular one (ATS in
  // fp32) stays on the FMA kernel
  if (!rect)
    return masked ? launch_attention_tf32<true>(qh, kh, vh, oh, bp, mp, r0, cs, B, N, H, scale, s)
                  : launch_attention_tf32<false>(qh, kh, vh, oh, bp, mp, r0, cs, B, N, H, scale,
                                                 s);
  const cudaError_t err =
      cudaFuncSetAttribute(short_attention_rect_fma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(fma_smem_bytes(MAXN)));
  if (err != cudaSuccess) return static_cast<int>(err);
  short_attention_rect_fma_kernel<<<B * H, THREADS, fma_smem_bytes(N), s>>>(qh, kh, vh, oh, mp, ip,
                                                                            N, M, H, scale);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core forward's plan at n keys, for the host: out[3] = {dynamic
// shared memory a block in bytes, threads a block, 32-key chunks of the row
// of S held in registers (the kernel variant)}.
extern "C" int tr_attention_tf32_plan(int n, int* out) {
  using namespace trk;
  if (n < 1 || n > MAXN) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = static_cast<int>(tf32_smem_bytes(n));
  out[1] = TC_THREADS;
  out[2] = tf32_chunks(n);
  return 0;
}

// Returns the cudaError_t of the launch (0 on success): dq, dk, dv from q,
// k, v and dout, all [B, H, N, 64] operands in `dtype` with the head dim
// contiguous (strides: the (batch, head, row) strides of q, k, v, dout, dq,
// dk and dv, in elements), the fp32 bias [B, N], the validity mask
// ([B, N], one byte per token, non-zero = valid), the fp32 cotangents
// drow0 and dcs [B, H, N], and the fp32 per-head bias gradient dbias
// [B, H, N]; each of the last five may be null (zero, none, or not
// written). The caller checks shapes, dtypes and strides. fp32 only.
extern "C" int tr_short_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                      const void* dout, void* dq, void* dk, void* dv,
                                      const long long* strides, const void* bias,
                                      const void* mask, const void* drow0, const void* dcs,
                                      void* dbias, int B, int N, int H, float scale,
                                      void* stream) {
  using namespace trk;
  if (N < 1 || N > MAXN) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  const unsigned char* mp = static_cast<const unsigned char*>(mask);
  const float* w = static_cast<const float*>(drow0);
  const float* c = static_cast<const float*>(dcs);
  float* db = static_cast<float*>(dbias);
  const bool masked = mask != nullptr;
  cudaError_t err;
  if (dtype == kFloat32) {
    const auto kernel =
        masked ? short_attention_bwd_fma_kernel<true> : short_attention_bwd_fma_kernel<false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bwd_fma_smem_bytes(MAXN, masked)));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<B * H, THREADS, bwd_fma_smem_bytes(N, masked), s>>>(
        heads<const float>(q, strides, 0), heads<const float>(k, strides, 1),
        heads<const float>(v, strides, 2), heads<const float>(dout, strides, 3),
        heads<float>(dq, strides, 4), heads<float>(dk, strides, 5), heads<float>(dv, strides, 6),
        bp, mp, w, c, db, N, H, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Returns the cudaError_t of the launch (0 on success): keys [M, hd], the
// head mean of the keys of the packed qkv [M, 3 * H * hd], both in `dtype`,
// contiguous and 16-byte aligned, H = 3, 6 or 12, hd a multiple of 8 (bf16)
// or 4 (fp32).
extern "C" int tr_head_mean_keys(int dtype, const void* qkv, void* keys, int M, int H, int hd,
                                 void* stream) {
  using namespace trk;
  if (M == 0) return 0;
  if (hd < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) return launch_head_mean_keys<bf16>(qkv, keys, M, H, hd, s);
  if (dtype == kFloat32) return launch_head_mean_keys<float>(qkv, keys, M, H, hd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
