// The backward of the fp32 softmax attention of short_attention.cu, 3xTF32
// on the tensor cores: from q, k, v, the output's gradient dO (each a
// [B, H, N, 64] operand through its strides), the fp32 cotangents of the
// forward's row0 and colsum, the per-key bias and the validity mask, the
// gradients dq, dk, dv (same layouts) and the per-head bias gradient
// dbias [B, H, N] fp32 (the unscaled dS summed over the queries). The
// counterpart of the fp32 _bwd_kernel of
// tokenreduction_tpu/ops/flash_attention_train.py (attention_core_train)
// and of the attention part of the backward of ops/fused_block_train.py
// attend_branch_train. With the mask it recomputes the forward's capped
// logits, so a fully masked query row is uniform again, and zeroes dS at
// every masked pair: dq, dk and dbias take nothing from such a pair, while
// dV = P^T dO keeps the uniform rows' P.
//
// What bounds it: at B = 256, H = 6, N = 197 five products are essential
// (S, dP, dQ, dK, dV: 38.2 GFLOP, 0.231 ms as 3xTF32 at 494.7 TFLOP/s of
// dense TF32); q, k, v, dO in and dq, dk, dv out are 542 MB, 0.162 ms at
// 3.35 TB/s. This kernel does seven (it recomputes S and dP in its second
// phase).
//
// Design. One block per (image, head), 8 warps in 2 groups of 4, the same
// mma.sync m16n8k8 tiles, splits in registers and product orders as the
// forward (attention_tf32.cuh). Q, K, V and dO together take 278 KB at
// N = 256, over the 227 KB a block has, so the block runs two phases, each
// with two of them resident in shared memory (rows padded with zeros to
// KC * 32) and the other two copied in 16 rows at a time into each
// group's own tiles:
//   - phase 1, K and V resident, a group per 16 query rows (Q and dO rows
//     copied in), each warp a quarter of the keys: S = Q K^T and dP = dO
//     V^T, the logits as the forward's (scale, bias, -FLT_MAX at a masked
//     pair, -inf past N), the exact row max and 1/sum and P = e / sum,
//     then dP plus the row0 cotangent (query row 0) and the colsum
//     cotangent (every row), delta = sum over keys of P dP, dS = P (dP -
//     delta) (zero at a masked pair), dQ = dS K * scale; the row max, 1/sum
//     and delta go to shared memory for phase 2 (1/sum 0 past N);
//   - phase 2, Q and dO resident, a group per 16 keys (K and V rows copied
//     in), each warp a quarter of the queries: S^T = K Q^T (the transposed
//     product's order, see mma_small, so the logits are phase 1's), P^T
//     from phase 1's statistics, dV = P^T dO; dP^T = V dO^T plus the
//     cotangents, dS^T = P^T (dP^T - delta), dK = dS^T Q * scale and dbias =
//     the unscaled dS^T summed over the queries (the thread's columns, the
//     4 lanes of a row, then the group's warps in order). dV before dP^T
//     keeps at most two of S^T, dP^T and the outputs in registers;
//   - a group of 4 warps, each holding a quarter of a row of S and of dP
//     (4 KC registers each), where the forward's pairs hold halves: the
//     pair-of-warps build of this kernel used 255 registers with spills
//     from KC = 4 up and ran 1.7x SDPA's fp32 backward (PERF.md);
//   - dQ, dK and dV sum over up to 256 keys or queries: in partials of 4
//     tiles of 8 (32 terms), each from zero with its small products first
//     (the tensor cores truncate as they add), added to the fp32 sum with
//     rounding to nearest; then the group's 4 partials through shared
//     memory, in warp order, each warp storing 16 of the 64 columns;
//   - the row statistics are the exact ones (the forward writes none), and
//     delta the sum of P dP (dcs enters every dP, so the shortcut rowsum(dO
//     O) does not hold).
// Every sum is in a fixed order: no atomics, the same bits from run to run.
#include "attention_tf32.cuh"

namespace trk {
namespace {

constexpr int BW_COLS = HD / BW_GROUP;  // the output columns a warp stores

// o = the 16 x 64 product of A (registers a: the accumulator layout of a
// 16 x 8 NH tile, each of its tiles read as an A fragment: k index t <-
// column 2t, t + 4 <- 2t + 1) and B's 8 NH rows (col: B at this thread's
// row 2t of A's first column, column g), in partials of 4 tiles of 8.
template <int NH>
__device__ __forceinline__ void tile_products(float (&o)[HD / 8][4], const float (&a)[NH][4],
                                              const float* col) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int j0 = 0; j0 < NH; j0 += 4) {
    float part[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
    for (int big = 0; big < 2; ++big)
#pragma unroll
      for (int j = j0; j < (j0 + 4 < NH ? j0 + 4 : NH); ++j) {
        const float x[4] = {a[j][0], a[j][2], a[j][1], a[j][3]};
        uint32_t xh[4], xl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(x[i], xh[i], xl[i]);
        const float* br = col + 8 * j * TC_LD;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          if (big)
            mma_big(part[n], xh, br[8 * n], br[TC_LD + 8 * n]);
          else
            mma_small(part[n], xh, xl, br[8 * n], br[TC_LD + 8 * n]);
        }
      }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] += part[n][e];
  }
}

// The group's partial sums of a 16 x 64 tile, o (each warp's, over its
// part of the inner dimension), added in warp order through xo ([BW_GROUP]
// [16][TC_LD]): each warp stores its BW_COLS columns of rows g (at outa)
// and g + 8 (at outb), times f; a null row is not stored.
template <typename Sync>
__device__ __forceinline__ void group_store(const float (&o)[HD / 8][4], float* xo, int gw,
                                            int g, int t, const Sync& group_sync, float* outa,
                                            float* outb, float f) {
  float* mine = xo + gw * 16 * TC_LD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    *reinterpret_cast<float2*>(mine + g * TC_LD + 8 * n + 2 * t) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(mine + (g + 8) * TC_LD + 8 * n + 2 * t) =
        make_float2(o[n][2], o[n][3]);
  }
  group_sync();
#pragma unroll
  for (int i = 0; i < BW_COLS / 8; ++i) {
    const int col = gw * BW_COLS + 8 * i + 2 * t;
    float2 ya = *reinterpret_cast<const float2*>(xo + g * TC_LD + col);
    float2 yb = *reinterpret_cast<const float2*>(xo + (g + 8) * TC_LD + col);
#pragma unroll
    for (int w = 1; w < BW_GROUP; ++w) {
      const float2 xa = *reinterpret_cast<const float2*>(xo + (w * 16 + g) * TC_LD + col);
      const float2 xb = *reinterpret_cast<const float2*>(xo + (w * 16 + g + 8) * TC_LD + col);
      ya.x += xa.x, ya.y += xa.y, yb.x += xb.x, yb.y += xb.y;
    }
    if (outa != nullptr) *reinterpret_cast<float2*>(outa + col) = make_float2(ya.x * f, ya.y * f);
    if (outb != nullptr) *reinterpret_cast<float2*>(outb + col) = make_float2(yb.x * f, yb.y * f);
  }
}

template <bool MASK, int KC>
__global__ void __launch_bounds__(TC_THREADS, 1)
    short_attention_bwd_tf32_kernel(Heads<const float> q, Heads<const float> k,
                                    Heads<const float> v, Heads<const float> dout,
                                    Heads<float> dq, Heads<float> dk, Heads<float> dv,
                                    const float* __restrict__ bias,
                                    const unsigned char* __restrict__ mask,
                                    const float* __restrict__ drow0,
                                    const float* __restrict__ dcs, float* __restrict__ dbias,
                                    int N, int H, float scale) {
  constexpr int ROWS = KC * TC_KEYS;
  constexpr int NH = ROWS / BW_GROUP / 8;  // a warp's tiles of 8 keys or queries
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [ROWS][TC_LD]: K, then Q
  float* Bs = As + ROWS * TC_LD;               // [ROWS][TC_LD]: V, then dO
  float* gbuf = Bs + ROWS * TC_LD;             // [BW_GROUPS][2 + BW_GROUP][16][TC_LD]
  float* sM = gbuf + BW_GROUPS * (2 + BW_GROUP) * 16 * TC_LD;  // [MAXN] row max
  float* sR = sM + MAXN;                       // [MAXN] 1 / row sum, 0 past N
  float* sD = sR + MAXN;                       // [MAXN] delta
  float* sCap = sD + MAXN;                     // [MAXN] +inf valid, -FLT_MAX not
  float* sBias = sCap + MAXN;                  // [MAXN] the bias (0 without)
  float* sW = sBias + MAXN;                    // [MAXN] drow0 (0 without)
  float* sC = sW + MAXN;                       // [MAXN] dcs (0 without)
  float* stw = sC + MAXN;                      // [BW_GROUPS][BW_STATS]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp / BW_GROUP, gw = warp % BW_GROUP;
  const int w0 = gw * (ROWS / BW_GROUP);  // this warp's keys (phase 1) or queries (phase 2)
  float* t0 = gbuf + group * (2 + BW_GROUP) * 16 * TC_LD;  // the group's tiles: Q or K rows,
  float* t1 = t0 + 16 * TC_LD;                             // dO or V rows,
  float* xo = t1 + 16 * TC_LD;                             // and its warps' partials
  float* st = stw + group * BW_STATS;                      // st[48 gw + 16 stat + row]
  const auto group_sync = [group]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(32 * BW_GROUP) : "memory");
  };
  // the group's max (stat 0) or sum (else) of this thread's two rows'
  // values over its warps, in warp order
  const auto group_reduce = [&](int stat, float& a, float& c) {
    if (t == 0) st[48 * gw + 16 * stat + g] = a, st[48 * gw + 16 * stat + 8 + g] = c;
    group_sync();
    a = st[16 * stat + g], c = st[16 * stat + 8 + g];
#pragma unroll
    for (int w = 1; w < BW_GROUP; ++w) {
      const float x = st[48 * w + 16 * stat + g], y = st[48 * w + 16 * stat + 8 + g];
      a = stat == 0 ? fmaxf(a, x) : a + x;
      c = stat == 0 ? fmaxf(c, y) : c + y;
    }
  };
  // both operands' rows past N are zero-filled
  const auto load_rows = [&](const Heads<const float>& x, const Heads<const float>& y) {
    for (int e = threadIdx.x; e < ROWS * (HD / 4); e += TC_THREADS) {
      const int n = e / (HD / 4), c = (e % (HD / 4)) * 4;
      const bool in = n < N;
      cp_async16(As + n * TC_LD + c, x.row(b, h, in ? n : 0) + c, in);
      cp_async16(Bs + n * TC_LD + c, y.row(b, h, in ? n : 0) + c, in);
    }
    cp_async_commit();
  };
  // the group's 16 rows from r0 of x and y into t0 and t1
  const auto load_tile = [&](const Heads<const float>& x, const Heads<const float>& y, int r0) {
    group_sync();  // every warp of the group is done with the tiles
    for (int e = threadIdx.x % (32 * BW_GROUP); e < 16 * (HD / 4); e += 32 * BW_GROUP) {
      const int n = e / (HD / 4), c = (e % (HD / 4)) * 4;
      const bool in = r0 + n < N;
      cp_async16(t0 + n * TC_LD + c, x.row(b, h, in ? r0 + n : 0) + c, in);
      cp_async16(t1 + n * TC_LD + c, y.row(b, h, in ? r0 + n : 0) + c, in);
    }
    cp_async_commit();
    cp_async_wait<0>();
    group_sync();
  };

  load_rows(k, v);
  const unsigned char* mrow = MASK ? mask + static_cast<size_t>(b) * N : nullptr;
  for (int j = threadIdx.x; j < MAXN; j += TC_THREADS) {
    const bool in = j < N;
    sM[j] = sR[j] = sD[j] = 0.f;
    sCap[j] = in && (!MASK || mrow[j]) ? INFINITY : -FLT_MAX;
    sBias[j] = in && bias != nullptr ? bias[static_cast<size_t>(b) * N + j] : 0.f;
    sW[j] = in && drow0 != nullptr ? drow0[static_cast<size_t>(bh) * N + j] : 0.f;
    sC[j] = in && dcs != nullptr ? dcs[static_cast<size_t>(bh) * N + j] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  // phase 1: a group per 16 query rows r0 .. r0 + 15; this thread's rows
  // ra = r0 + g and rb = ra + 8, its keys key(j, e) = w0 + 8 j + 2 t + e
  // (s[j][e] row ra, s[j][2 + e] row rb)
  for (int r0 = group * 16; r0 < N; r0 += BW_GROUPS * 16) {
    load_tile(q, dout, r0);
    const int ra = r0 + g, rb = ra + 8;
    float s[NH][4], dp[NH][4];
    head_dim_products(s, t0 + g * TC_LD + t, As + (w0 + g) * TC_LD + t);
    head_dim_products(dp, t1 + g * TC_LD + t, Bs + (w0 + g) * TC_LD + t);
    const bool oka = sCap[ra] > 0.f, okb = sCap[rb] > 0.f;
    float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = w0 + 8 * j + 2 * t + e;
        const bool in = key < N;
        float xa = s[j][e] * scale + sBias[key], xb = s[j][2 + e] * scale + sBias[key];
        if constexpr (MASK) {
          const bool kok = sCap[key] > 0.f;
          if (!(oka && kok)) xa = -FLT_MAX;  // the JAX pair mask
          if (!(okb && kok)) xb = -FLT_MAX;
        }
        s[j][e] = in ? xa : -INFINITY;
        s[j][2 + e] = in ? xb : -INFINITY;
        mxa = fmaxf(mxa, s[j][e]);
        mxb = fmaxf(mxb, s[j][2 + e]);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, o));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, o));
    }
    group_reduce(0, mxa, mxb);  // also: every warp is done reading the tiles
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = w0 + 8 * j + 2 * t + e < N;
        s[j][e] = in ? expf(s[j][e] - mxa) : 0.f;
        s[j][2 + e] = in ? expf(s[j][2 + e] - mxb) : 0.f;
        suma += s[j][e];
        sumb += s[j][2 + e];
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      suma += __shfl_xor_sync(0xffffffffu, suma, o);
      sumb += __shfl_xor_sync(0xffffffffu, sumb, o);
    }
    group_reduce(1, suma, sumb);
    const float ria = 1.0f / suma, rib = 1.0f / sumb;
    // P, dP with its cotangents, and delta
    float dla = 0.f, dlb = 0.f;
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = w0 + 8 * j + 2 * t + e;
        s[j][e] *= ria;
        s[j][2 + e] *= rib;
        dp[j][e] = (dp[j][e] + (ra == 0 ? sW[key] : 0.f)) + sC[key];
        dp[j][2 + e] = dp[j][2 + e] + sC[key];  // rb >= 8
        dla += s[j][e] * dp[j][e];
        dlb += s[j][2 + e] * dp[j][2 + e];
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      dla += __shfl_xor_sync(0xffffffffu, dla, o);
      dlb += __shfl_xor_sync(0xffffffffu, dlb, o);
    }
    group_reduce(2, dla, dlb);
    // dS (unscaled) in place of P
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] *= dp[j][e] - dla;
        s[j][2 + e] *= dp[j][2 + e] - dlb;
        if constexpr (MASK) {  // dS is zero at a masked pair
          const bool kok = sCap[w0 + 8 * j + 2 * t + e] > 0.f;
          if (!(oka && kok)) s[j][e] = 0.f;
          if (!(okb && kok)) s[j][2 + e] = 0.f;
        }
      }
    if (gw == 0 && t == 0) {
      sM[ra] = mxa, sR[ra] = ra < N ? ria : 0.f, sD[ra] = dla;
      sM[rb] = mxb, sR[rb] = rb < N ? rib : 0.f, sD[rb] = dlb;
    }
    // dQ = dS K * scale over the warp's keys, the group's partials in order
    float o[HD / 8][4];
    tile_products(o, s, As + (w0 + 2 * t) * TC_LD + g);
    group_store(o, xo, gw, g, t, group_sync, ra < N ? dq.row(b, h, ra) : nullptr,
                rb < N ? dq.row(b, h, rb) : nullptr, scale);
  }
  __syncthreads();  // every warp is done with K and V, and the statistics are in
  load_rows(q, dout);
  cp_async_wait<0>();
  __syncthreads();

  // phase 2: a group per 16 keys c0 .. c0 + 15; this thread's keys ja =
  // c0 + g and jb = ja + 8, its queries qi(j, e) = w0 + 8 j + 2 t + e
  // (s[j][e] key ja, s[j][2 + e] key jb)
  for (int c0 = group * 16; c0 < N; c0 += BW_GROUPS * 16) {
    load_tile(k, v, c0);
    const int ja = c0 + g, jb = ja + 8;
    const bool oka = sCap[ja] > 0.f, okb = sCap[jb] > 0.f;
    float s[NH][4];
    head_dim_products<NH, true>(s, t0 + g * TC_LD + t, As + (w0 + g) * TC_LD + t);
    // P^T from phase 1's statistics
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = w0 + 8 * j + 2 * t + e;
        float xa = s[j][e] * scale + sBias[ja], xb = s[j][2 + e] * scale + sBias[jb];
        if constexpr (MASK) {
          const bool qok = sCap[qi] > 0.f;
          if (!(oka && qok)) xa = -FLT_MAX;
          if (!(okb && qok)) xb = -FLT_MAX;
        }
        const bool in = qi < N;
        s[j][e] = in ? expf(xa - sM[qi]) * sR[qi] : 0.f;
        s[j][2 + e] = in ? expf(xb - sM[qi]) * sR[qi] : 0.f;
      }
    // dV = P^T dO over the warp's queries
    float o[HD / 8][4];
    tile_products(o, s, Bs + (w0 + 2 * t) * TC_LD + g);
    group_store(o, xo, gw, g, t, group_sync, ja < N ? dv.row(b, h, ja) : nullptr,
                jb < N ? dv.row(b, h, jb) : nullptr, 1.f);
    // dP^T with the cotangents, dS^T (unscaled) in place of P^T, and its
    // sums over the thread's queries
    float dp[NH][4];
    head_dim_products<NH, true>(dp, t1 + g * TC_LD + t, Bs + (w0 + g) * TC_LD + t);
    float dba = 0.f, dbb = 0.f;
#pragma unroll
    for (int j = 0; j < NH; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = w0 + 8 * j + 2 * t + e;
        const float pa = (dp[j][e] + (qi == 0 ? sW[ja] : 0.f)) + sC[ja];
        const float pb = (dp[j][2 + e] + (qi == 0 ? sW[jb] : 0.f)) + sC[jb];
        s[j][e] *= pa - sD[qi];
        s[j][2 + e] *= pb - sD[qi];
        if constexpr (MASK) {  // dS is zero at a masked pair
          const bool qok = sCap[qi] > 0.f;
          if (!(oka && qok)) s[j][e] = 0.f;
          if (!(okb && qok)) s[j][2 + e] = 0.f;
        }
        dba += s[j][e];
        dbb += s[j][2 + e];
      }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      dba += __shfl_xor_sync(0xffffffffu, dba, o2);
      dbb += __shfl_xor_sync(0xffffffffu, dbb, o2);
    }
    // dK = dS^T Q * scale over the warp's queries
    tile_products(o, s, As + (w0 + 2 * t) * TC_LD + g);
    group_reduce(2, dba, dbb);  // also: every warp is done reading xo
    if (dbias != nullptr && gw == 0 && t == 0) {
      if (ja < N) dbias[static_cast<size_t>(bh) * N + ja] = dba;
      if (jb < N) dbias[static_cast<size_t>(bh) * N + jb] = dbb;
    }
    group_store(o, xo, gw, g, t, group_sync, ja < N ? dk.row(b, h, ja) : nullptr,
                jb < N ? dk.row(b, h, jb) : nullptr, scale);
  }
}

template <bool MASK, int KC>
int launch_attention_bwd_tf32_kc(const Heads<const float>* x, const Heads<float>* d,
                                 const float* bias, const unsigned char* mask, const float* drow0,
                                 const float* dcs, float* dbias, int B, int N, int H, float scale,
                                 cudaStream_t s) {
  const auto kernel = short_attention_bwd_tf32_kernel<MASK, KC>;
  const size_t bytes = bwd_tf32_smem_bytes(N);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, TC_THREADS, bytes, s>>>(x[0], x[1], x[2], x[3], d[0], d[1], d[2], bias, mask,
                                          drow0, dcs, dbias, N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

// The variant whose rows of S hold N keys: KC = ceil(N / 32), 1 .. 8.
template <bool MASK>
int launch_attention_bwd_tf32(const Heads<const float>* x, const Heads<float>* d,
                              const float* bias, const unsigned char* mask, const float* drow0,
                              const float* dcs, float* dbias, int B, int N, int H, float scale,
                              cudaStream_t s) {
#define TR_BWD_KC(KC)                                                                        \
  case KC:                                                                                   \
    return launch_attention_bwd_tf32_kc<MASK, KC>(x, d, bias, mask, drow0, dcs, dbias, B, N, \
                                                  H, scale, s);
  switch (tf32_chunks(N)) {
    TR_BWD_KC(1)
    TR_BWD_KC(2)
    TR_BWD_KC(3)
    TR_BWD_KC(4)
    TR_BWD_KC(5)
    TR_BWD_KC(6)
    TR_BWD_KC(7)
    TR_BWD_KC(8)
  }
#undef TR_BWD_KC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace trk

// Returns the cudaError_t of the launch (0 on success): dq, dk, dv from q,
// k, v and dout, all [B, H, N, 64] operands in `dtype` with the head dim
// contiguous (strides: the (batch, head, row) strides of q, k, v, dout, dq,
// dk and dv, in elements), the fp32 bias [B, N], the validity mask
// ([B, N], one byte per token, non-zero = valid), the fp32 cotangents
// drow0 and dcs [B, H, N], and the fp32 per-head bias gradient dbias
// [B, H, N]; each of the last five may be null (zero, none, or not
// written). The caller checks shapes, dtypes and strides. fp32 only
// (short_attention_bwd_tf32_kernel): bf16 is attention_sm90.cu's
// tr_attention_bwd_sm90.
extern "C" int tr_short_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                      const void* dout, void* dq, void* dk, void* dv,
                                      const long long* strides, const void* bias,
                                      const void* mask, const void* drow0, const void* dcs,
                                      void* dbias, int B, int N, int H, float scale,
                                      void* stream) {
  using namespace trk;
  if (dtype != kFloat32 || N < 1 || N > MAXN) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Heads<const float> x[4] = {
      heads<const float>(q, strides, 0), heads<const float>(k, strides, 1),
      heads<const float>(v, strides, 2), heads<const float>(dout, strides, 3)};
  const Heads<float> d[3] = {heads<float>(dq, strides, 4), heads<float>(dk, strides, 5),
                             heads<float>(dv, strides, 6)};
  const float* bp = static_cast<const float*>(bias);
  const unsigned char* mp = static_cast<const unsigned char*>(mask);
  const float* w = static_cast<const float*>(drow0);
  const float* c = static_cast<const float*>(dcs);
  float* db = static_cast<float*>(dbias);
  return mask != nullptr
             ? launch_attention_bwd_tf32<true>(x, d, bp, mp, w, c, db, B, N, H, scale, s)
             : launch_attention_bwd_tf32<false>(x, d, bp, mp, w, c, db, B, N, H, scale, s);
}
