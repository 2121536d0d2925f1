// The backward of the fp32 softmax attention above 256 tokens (up to
// WIDE_MAXN = 2048) at head dim 64, 3xTF32 on the tensor cores (mma.sync
// m16n8k8, attention_tf32.cuh): the contract of short_attention_bwd.cu's
// tr_short_attention_bwd (q, k, v, the output's gradient dO, each a
// [B, H, N, 64] operand through its strides; the fp32 cotangents of row0
// and colsum; the per-key bias; the validity mask; dq, dk, dv; the per-head
// bias gradient dbias [B, H, N] fp32), with the row statistics that
// attention_wide_tf32.cu's forward writes (the row max of the logits and
// 1/sum, [B, H, N, 2]). The host launches it only above 256 tokens: every
// fp32 backward at N <= 256 stays short_attention_bwd.cu's, which holds a
// head's operands in shared memory.
//
// It replaces, in fp32 above 256 tokens (the JAX train CLI's default
// dtype, DeiT's 384-px finetune at N = 577), the backward _bwd_kernel of
// tokenreduction_tpu/ops/flash_attention_train.py (:38-99, the backward of
// attention_core_train) and the attention part of the backward of
// ops/fused_block_train.py attend_branch_train (:95-205). The TPU kernels
// pad N and keep whole rows of the logits in VMEM, so they take any width.
//
// Arithmetic: short_attention_bwd.cu's, point for point: the logits as the
// forward's (q.k * scale + bias, -FLT_MAX at a masked pair, -inf past N);
// P = exp(x - the row max) * 1/sum from the forward's statistics; dP = dO
// V^T plus the row0 cotangent on query row 0 and the colsum cotangent on
// every row; delta = sum over the keys of P dP (the exact form, as JAX's
// _bwd_kernel: dcs enters every dP, so rowsum(dO O) does not hold); dS = P
// (dP - delta), zero at a masked pair (and on pad rows, where P is 0);
// dQ = dS K * scale, dK = dS^T Q * scale, dV = P^T dO (a fully masked
// query row keeps its uniform P there), dbias = the unscaled dS summed over
// the queries; each product lo.hi + hi.lo + hi.hi on split operands, the
// small products of a slice first; S^T and dP^T in the transposed
// product's order (mma_small<true>), so that they are the first launch's
// S and dP. Every sum over keys or queries is built from partials of 32
// terms (4 tiles of 8; the tensor cores truncate as they add), each from
// zero, added to the running fp32 sum in order.
//
// Design: two launches, no atomics, mirroring attention_wide_sm90.cu's
// bf16 backward.
//   attention_wide_tf32_bwd_dq: one block of 4 warps per (image, head,
//     query tile of 64 rows), a warp 16 rows; the tile's Q and dO rows
//     copied in by cp.async, the 64-key tiles of K and V streamed through
//     a ring of two stages (rows padded to 68 floats, as the fragment loads
//     read them), twice: pass 1 S, dP, P and delta (per 32 keys, added in
//     key order); pass 2 the same S and dP, dS and dQ (per 32 keys, added
//     in key order). It writes delta [B, H, N] for the second launch.
//   attention_wide_tf32_bwd_dkv: one block per (image, head, key tile), a
//     warp 16 keys, the tile's K and V rows resident; the query tiles' Q and
//     dO stream through the ring: S^T = K Q^T, P^T from the statistics, dV
//     += P^T dO; dP^T = V dO^T plus the cotangents, dS^T, dbias (per 32
//     queries, added in query order) and dK += dS^T Q, all in query-tile
//     order.
// Every sum is in a fixed order: the same bits from run to run.
//
// What bounds it at B = 256, H = 6, N = 577 on the H100: five products (S,
// dP, dV, dK, dQ), 327 GFLOP, 982 in 3xTF32, 1.985 ms at 494.7 TFLOP/s of
// dense TF32; q, k, v, dO in and dq, dk, dv out, 1.6 GB, 0.475 ms at
// 3.35 TB/s. This design computes S and dP three times (twice in the first
// launch, once in the second) on mma.sync, which reaches a part of the TF32
// rate: a simple form that is right, for later work to make fast.
#include "attention_tf32.cuh"

namespace trk {
namespace {

constexpr int WIDE_MAXN = 2048;
constexpr int WB_ROWS = 64;                 // rows of a query tile, keys of a key tile
constexpr int WB_THREADS = 128;             // 4 warps, 16 rows (or keys) each
constexpr int WB_TILE = WB_ROWS * TC_LD;    // floats of a tile in shared memory
constexpr int WB_RING = 2;

__host__ __device__ constexpr int wb_keys(int n) { return (n + WB_ROWS - 1) / WB_ROWS * WB_ROWS; }

// Either launch: two resident tiles, WB_RING stages of two streamed tiles,
// four per-token vectors [keys] (dQ: the bias, the keys' validity, drow0
// and dcs; dK, dV: the row max, 1/sum, delta and the queries' validity).
constexpr size_t wide_bwd_tf32_smem(int n) {
  return sizeof(float) * ((2 + 2 * WB_RING) * static_cast<size_t>(WB_TILE) +
                          4 * static_cast<size_t>(wb_keys(n)));
}
static_assert(wide_bwd_tf32_smem(WIDE_MAXN) <= 232448,
              "over the H100's 227 KB of shared memory a block");

__device__ __forceinline__ float quad_sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// o += the 16 x 64 product of A (registers a: the accumulator layout of 8
// tiles of 16 x 8, each read as an A fragment: k index t <- column 2t, t + 4
// <- 2t + 1) and B's 64 rows (col: B at this thread's row 2t of A's first
// column, column g), in two partials of 4 tiles of 8 (32 terms), each from
// zero with its small products first, added to o in order.
__device__ __forceinline__ void tile_products_acc(float (&o)[HD / 8][4], const float (&a)[8][4],
                                                  const float* col) {
#pragma unroll
  for (int j0 = 0; j0 < 8; j0 += 4) {
    float part[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.f;
#pragma unroll
    for (int big = 0; big < 2; ++big)
#pragma unroll
      for (int j = j0; j < j0 + 4; ++j) {
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

// 64 rows from r0 of x (and of y into the tile after it) into tile by
// cp.async, rows past N zero-filled; no commit.
__device__ __forceinline__ void copy_rows(float* tile, const Heads<const float>& x,
                                          const Heads<const float>& y, int b, int h, int r0,
                                          int N) {
  for (int e = threadIdx.x; e < WB_ROWS * (HD / 4); e += WB_THREADS) {
    const int n = e / (HD / 4), c = (e % (HD / 4)) * 4, r = r0 + n;
    const bool in = r < N;
    cp_async16(tile + n * TC_LD + c, x.row(b, h, in ? r : 0) + c, in);
    cp_async16(tile + WB_TILE + n * TC_LD + c, y.row(b, h, in ? r : 0) + c, in);
  }
}

// dQ and delta of one query tile. MASK: the validity mask (the JAX pair
// mask; dS zero at every masked pair). bias, drow0, dcs may be null (zero).
template <bool MASK>
__global__ void __launch_bounds__(WB_THREADS)
    attention_wide_tf32_bwd_dq(Heads<const float> q, Heads<const float> k, Heads<const float> v,
                               Heads<const float> dout, Heads<float> dq,
                               const float2* __restrict__ stats, const float* __restrict__ bias,
                               const unsigned char* __restrict__ mask,
                               const float* __restrict__ drow0, const float* __restrict__ dcs,
                               float* __restrict__ delta, int N, int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = wb_keys(N) / WB_ROWS, keys = nt * WB_ROWS;
  float* Qs = reinterpret_cast<float*>(smem);  // [64][TC_LD], then dO's tile
  float* Ds = Qs + WB_TILE;
  float* ring = Ds + WB_TILE;              // stage i: K at ring + 2 i WB_TILE, V after it
  float* bs = ring + 2 * WB_RING * WB_TILE;  // the bias of each key, 0 without one or past N
  float* kok = bs + keys;                  // 1 for a valid key < N, else 0
  float* sw = kok + keys;                  // the row0 cotangent of each key, 0 past N
  float* sc = sw + keys;                   // the colsum cotangent of each key, 0 past N
  const int bh = blockIdx.x, qt = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t vec = static_cast<size_t>(bh) * N;
  // the ring's items: pass 1's key tiles, then pass 2's (K and V of key
  // tile i % nt); every thread copies its share and commits a group
  const int total = 2 * nt;
  const auto issue = [&](int i) {
    if (i < total) copy_rows(ring + (i % WB_RING) * 2 * WB_TILE, k, v, b, h, (i % nt) * WB_ROWS, N);
    cp_async_commit();
  };

  copy_rows(Qs, q, dout, b, h, qt * WB_ROWS, N);  // in item 0's group
  issue(0);
  for (int j = tid; j < keys; j += WB_THREADS) {
    const bool in = j < N;
    bs[j] = in && bias != nullptr ? bias[static_cast<size_t>(b) * N + j] : 0.f;
    kok[j] = in && (!MASK || mask[static_cast<size_t>(b) * N + j]) ? 1.f : 0.f;
    sw[j] = in && drow0 != nullptr ? drow0[vec + j] : 0.f;
    sc[j] = in && dcs != nullptr ? dcs[vec + j] : 0.f;
  }
  const int la = warp * 16 + g;
  const int ra = qt * WB_ROWS + la, rb = ra + 8;  // this thread's rows
  // the rows' statistics: the row max (+inf past N, so that P is 0 there)
  // and 1/sum (0 past N)
  const float2 sa = ra < N ? stats[vec + ra] : make_float2(INFINITY, 0.f);
  const float2 sb = rb < N ? stats[vec + rb] : make_float2(INFINITY, 0.f);
  const bool oka = ra < N && (!MASK || mask[static_cast<size_t>(b) * N + ra]);
  const bool okb = rb < N && (!MASK || mask[static_cast<size_t>(b) * N + rb]);

  // P (in s) and dP with both cotangents (in dp) of the key tile at Ks: s[j][e]
  // row ra and s[j][2 + e] row rb, at key k0 + 8 j + 2 t + e
  const auto probs = [&](const float* Ks, int k0, float (&s)[8][4], float (&dp)[8][4]) {
    head_dim_products<8>(s, Qs + la * TC_LD + t, Ks + g * TC_LD + t);
    head_dim_products<8>(dp, Ds + la * TC_LD + t, Ks + WB_TILE + g * TC_LD + t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * t + e;
        float xa = s[j][e] * scale + bs[key], xb = s[j][2 + e] * scale + bs[key];
        if constexpr (MASK) {
          const bool kv = kok[key] > 0.f;
          if (!(oka && kv)) xa = -FLT_MAX;  // the JAX pair mask
          if (!(okb && kv)) xb = -FLT_MAX;
        }
        const bool in = key < N;
        s[j][e] = in ? expf(xa - sa.x) * sa.y : 0.f;
        s[j][2 + e] = in ? expf(xb - sb.x) * sb.y : 0.f;
        dp[j][e] = (dp[j][e] + (ra == 0 ? sw[key] : 0.f)) + sc[key];
        dp[j][2 + e] = dp[j][2 + e] + sc[key];  // rb >= 8
      }
  };

  // pass 1: delta = sum of P dP over the keys, 32 at a time, in order
  int item = 0;
  float da = 0.f, db = 0.f;
  for (int kt = 0; kt < nt; ++kt, ++item) {
    issue(item + 1);
    cp_async_wait<1>();  // this item's tiles (and Q, dO) have landed
    __syncthreads();
    float s[8][4], dp[8][4];
    probs(ring + (item % WB_RING) * 2 * WB_TILE, kt * WB_ROWS, s, dp);
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += 4) {
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int j = j0; j < j0 + 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pa += s[j][e] * dp[j][e];
          pb += s[j][2 + e] * dp[j][2 + e];
        }
      da += quad_sum4(pa);
      db += quad_sum4(pb);
    }
    __syncthreads();  // the stage is read by no thread any more
  }
  if (t == 0) {
    if (ra < N) delta[vec + ra] = da;
    if (rb < N) delta[vec + rb] = db;
  }

  // pass 2: dQ = dS K * scale, dS = P (dP - delta)
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int kt = 0; kt < nt; ++kt, ++item) {
    issue(item + 1);
    cp_async_wait<1>();
    __syncthreads();
    const float* Ks = ring + (item % WB_RING) * 2 * WB_TILE;
    float s[8][4], dp[8][4];
    probs(Ks, kt * WB_ROWS, s, dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] *= dp[j][e] - da;
        s[j][2 + e] *= dp[j][2 + e] - db;
        if constexpr (MASK) {  // dS is zero at a masked pair
          const bool kv = kok[kt * WB_ROWS + 8 * j + 2 * t + e] > 0.f;
          if (!(oka && kv)) s[j][e] = 0.f;
          if (!(okb && kv)) s[j][2 + e] = 0.f;
        }
      }
    tile_products_acc(o, s, Ks + 2 * t * TC_LD + g);
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (ra < N)
      *reinterpret_cast<float2*>(dq.row(b, h, ra) + col) =
          make_float2(o[n][0] * scale, o[n][1] * scale);
    if (rb < N)
      *reinterpret_cast<float2*>(dq.row(b, h, rb) + col) =
          make_float2(o[n][2] * scale, o[n][3] * scale);
  }
}

// dK, dV and dbias of one key tile from the first launch's delta. MASK as
// there; bias, drow0, dcs (zero) and dbias (not written) may be null.
template <bool MASK>
__global__ void __launch_bounds__(WB_THREADS)
    attention_wide_tf32_bwd_dkv(Heads<const float> q, Heads<const float> k, Heads<const float> v,
                                Heads<const float> dout, Heads<float> dk, Heads<float> dv,
                                const float2* __restrict__ stats, const float* __restrict__ bias,
                                const unsigned char* __restrict__ mask,
                                const float* __restrict__ drow0, const float* __restrict__ dcs,
                                const float* __restrict__ delta, float* __restrict__ dbias, int N,
                                int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = wb_keys(N) / WB_ROWS, keys = nt * WB_ROWS;
  float* Ks = reinterpret_cast<float*>(smem);  // [64][TC_LD], then V's tile
  float* Vs = Ks + WB_TILE;
  float* ring = Vs + WB_TILE;               // stage i: Q at ring + 2 i WB_TILE, dO after it
  float* sm = ring + 2 * WB_RING * WB_TILE;  // the row max, +inf past N
  float* sr = sm + keys;                    // 1/sum, 0 past N
  float* sd = sr + keys;                    // delta, 0 past N
  float* qok = sd + keys;                   // 1 for a valid query row < N, else 0
  const int bh = blockIdx.x, jt = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t vec = static_cast<size_t>(bh) * N;
  const auto issue = [&](int i) {  // the Q and dO tiles of query tile i
    if (i < nt) copy_rows(ring + (i % WB_RING) * 2 * WB_TILE, q, dout, b, h, i * WB_ROWS, N);
    cp_async_commit();
  };

  copy_rows(Ks, k, v, b, h, jt * WB_ROWS, N);  // in item 0's group
  issue(0);
  for (int j = tid; j < keys; j += WB_THREADS) {
    const bool in = j < N;
    const float2 st = in ? stats[vec + j] : make_float2(INFINITY, 0.f);
    sm[j] = st.x;
    sr[j] = st.y;
    sd[j] = in ? delta[vec + j] : 0.f;
    qok[j] = in && (!MASK || mask[static_cast<size_t>(b) * N + j]) ? 1.f : 0.f;
  }
  // this thread's keys ja and jb = ja + 8 of its warp's 16
  const int la = warp * 16 + g;
  const int ja = jt * WB_ROWS + la, jb = ja + 8;
  const bool ina = ja < N, inb = jb < N;
  const auto key_vec = [&](const float* x, bool in, int j) { return x != nullptr && in ? x[vec + j] : 0.f; };
  const float kba = ina && bias != nullptr ? bias[static_cast<size_t>(b) * N + ja] : 0.f;
  const float kbb = inb && bias != nullptr ? bias[static_cast<size_t>(b) * N + jb] : 0.f;
  const bool koka = ina && (!MASK || mask[static_cast<size_t>(b) * N + ja]);
  const bool kokb = inb && (!MASK || mask[static_cast<size_t>(b) * N + jb]);
  const float wa = key_vec(drow0, ina, ja), wb = key_vec(drow0, inb, jb);
  const float ca = key_vec(dcs, ina, ja), cb = key_vec(dcs, inb, jb);

  float dkk[HD / 8][4], dvv[HD / 8][4], dba = 0.f, dbb = 0.f;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkk[n][e] = dvv[n][e] = 0.f;
  for (int it = 0; it < nt; ++it) {
    issue(it + 1);
    cp_async_wait<1>();  // this item's tiles (and K, V, the vectors) are in
    __syncthreads();
    const float* Qs = ring + (it % WB_RING) * 2 * WB_TILE;
    const float* Ds = Qs + WB_TILE;
    // P^T: st[j][e] key ja and st[j][2 + e] key jb, at query q0 + 8 j + 2 t + e
    float st[8][4];
    head_dim_products<8, true>(st, Ks + la * TC_LD + t, Qs + g * TC_LD + t);
    const int q0 = it * WB_ROWS;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = q0 + 8 * j + 2 * t + e;
        float xa = st[j][e] * scale + kba, xb = st[j][2 + e] * scale + kbb;
        if constexpr (MASK) {
          const bool qv = qok[qi] > 0.f;
          if (!(koka && qv)) xa = -FLT_MAX;
          if (!(kokb && qv)) xb = -FLT_MAX;
        }
        st[j][e] = ina ? expf(xa - sm[qi]) * sr[qi] : 0.f;  // 0 past N (the row's +inf max)
        st[j][2 + e] = inb ? expf(xb - sm[qi]) * sr[qi] : 0.f;
      }
    // dV += P^T dO
    tile_products_acc(dvv, st, Ds + 2 * t * TC_LD + g);
    // dP^T with the cotangents, dS^T (unscaled) in place of P^T, and dbias
    float dpt[8][4];
    head_dim_products<8, true>(dpt, Vs + la * TC_LD + t, Ds + g * TC_LD + t);
#pragma unroll
    for (int j0 = 0; j0 < 8; j0 += 4) {
      float ua = 0.f, ub = 0.f;
#pragma unroll
      for (int j = j0; j < j0 + 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = q0 + 8 * j + 2 * t + e;
          const float pa = (dpt[j][e] + (qi == 0 ? wa : 0.f)) + ca;
          const float pb = (dpt[j][2 + e] + (qi == 0 ? wb : 0.f)) + cb;
          st[j][e] *= pa - sd[qi];
          st[j][2 + e] *= pb - sd[qi];
          if constexpr (MASK) {  // dS is zero at a masked pair
            const bool qv = qok[qi] > 0.f;
            if (!(koka && qv)) st[j][e] = 0.f;
            if (!(kokb && qv)) st[j][2 + e] = 0.f;
          }
          ua += st[j][e];
          ub += st[j][2 + e];
        }
      dba += quad_sum4(ua);
      dbb += quad_sum4(ub);
    }
    // dK += dS^T Q
    tile_products_acc(dkk, st, Qs + 2 * t * TC_LD + g);
    __syncthreads();  // the stage is read by no thread any more
  }
  if (dbias != nullptr && t == 0) {
    if (ina) dbias[vec + ja] = dba;
    if (inb) dbias[vec + jb] = dbb;
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (ina) {
      *reinterpret_cast<float2*>(dk.row(b, h, ja) + col) =
          make_float2(dkk[n][0] * scale, dkk[n][1] * scale);
      *reinterpret_cast<float2*>(dv.row(b, h, ja) + col) = make_float2(dvv[n][0], dvv[n][1]);
    }
    if (inb) {
      *reinterpret_cast<float2*>(dk.row(b, h, jb) + col) =
          make_float2(dkk[n][2] * scale, dkk[n][3] * scale);
      *reinterpret_cast<float2*>(dv.row(b, h, jb) + col) = make_float2(dvv[n][2], dvv[n][3]);
    }
  }
}

template <bool MASK>
int launch_wide_bwd_tf32(const Heads<const float>* x, const Heads<float>* d, const float2* stats,
                         const float* bias, const unsigned char* mask, const float* drow0,
                         const float* dcs, float* dbias, float* delta, int B, int N, int H,
                         float scale, cudaStream_t s) {
  const auto dq_kernel = attention_wide_tf32_bwd_dq<MASK>;
  const auto dkv_kernel = attention_wide_tf32_bwd_dkv<MASK>;
  const int most = static_cast<int>(wide_bwd_tf32_smem(WIDE_MAXN));
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, wb_keys(N) / WB_ROWS);
  const size_t bytes = wide_bwd_tf32_smem(N);
  dq_kernel<<<grid, WB_THREADS, bytes, s>>>(x[0], x[1], x[2], x[3], d[0], stats, bias, mask, drow0,
                                            dcs, delta, N, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_kernel<<<grid, WB_THREADS, bytes, s>>>(x[0], x[1], x[2], x[3], d[1], d[2], stats, bias,
                                             mask, drow0, dcs, delta, dbias, N, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace trk

// Returns the cudaError_t of the launches (0 on success): the contract of
// short_attention_bwd.cu's tr_short_attention_bwd in fp32 (q, k, v, dout,
// dq, dk, dv [B, H, N, 64] through their strides, in that order in
// `strides`; bias, mask, drow0, dcs, dbias, each may be null), for N up to
// 2048, with the forward's row statistics `stats` (fp32 [B, H, N, 2]: the
// row max of the logits and 1/sum) and `delta` (fp32 [B, H, N],
// contiguous), the scratch that the dQ launch writes and the dK, dV launch
// reads.
extern "C" int tr_attention_wide_tf32_bwd(const void* q, const void* k, const void* v,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          const long long* strides, const void* stats,
                                          const void* bias, const void* mask, const void* drow0,
                                          const void* dcs, void* dbias, void* delta, int B, int N,
                                          int H, float scale, void* stream) {
  using namespace trk;
  if (N < 1 || N > WIDE_MAXN || H < 1 || B < 0 || stats == nullptr || delta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Heads<const float> x[4] = {
      heads<const float>(q, strides, 0), heads<const float>(k, strides, 1),
      heads<const float>(v, strides, 2), heads<const float>(dout, strides, 3)};
  const Heads<float> d[3] = {heads<float>(dq, strides, 4), heads<float>(dk, strides, 5),
                             heads<float>(dv, strides, 6)};
  const float2* st = static_cast<const float2*>(stats);
  const float* bp = static_cast<const float*>(bias);
  const unsigned char* mp = static_cast<const unsigned char*>(mask);
  const float* w = static_cast<const float*>(drow0);
  const float* c = static_cast<const float*>(dcs);
  float* db = static_cast<float*>(dbias);
  float* dl = static_cast<float*>(delta);
  return mask != nullptr
             ? launch_wide_bwd_tf32<true>(x, d, st, bp, mp, w, c, db, dl, B, N, H, scale, s)
             : launch_wide_bwd_tf32<false>(x, d, st, bp, mp, w, c, db, dl, B, N, H, scale, s);
}

// The dynamic shared memory a block of either launch takes at n keys, for
// the host; 0 outside 1..2048.
extern "C" int tr_attention_wide_tf32_bwd_smem(int n) {
  if (n < 1 || n > trk::WIDE_MAXN) return 0;
  return static_cast<int>(trk::wide_bwd_tf32_smem(n));
}
