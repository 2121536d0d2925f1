// The matrix-product half of every kernel counterpart in ops/, and its
// backward:
//
//   layer_norm:     Y[M, K] = LN(X[src(m)]) over the K columns of each row
//                   in fp32 (two-pass statistics), rounded to the operand
//                   type; src(m) gathers output row m of image b from X row
//                   b * rows_in + idx[m] when idx is given. X is the
//                   operand type or fp32. One warp per row.
//   layer_norm_bwd: dX = rstd (dXhat - mean(dXhat) - Xhat mean(dXhat Xhat))
//                   with dXhat = dLN * gamma, from X and the fp32 dLN, in
//                   X's type; each band of rows's partial sums of dLN *
//                   Xhat and dLN (the gradients of gamma and beta) go to
//                   a workspace that sum_partials reduces in band order
//                   (see its kernel's note).
//   gemm:           Y[M, n_out] = epi( X[M, K] . W^T + bias ), W in
//                   nn.Linear's [n_out, K] layout, or Y = X . W with W
//                   [K, n_out] (the backward's dY . W, read untransposed:
//                   no transposed copy of W is made).
//                   epi: optional exact-erf GELU (optionally also writing
//                   GELU'(pre-activation) in fp32), then an optional fp32
//                   factor (dH = dA * GELU'(H)), then an optional residual
//                   add whose row can be gathered through idx like
//                   layer_norm's rows; optional per-row-tile column sums
//                   of the fp32 result (a bias gradient before rounding).
//   gemm_wgrad:     the partial dW[n_out, K] = dY^T X over one slice of
//                   the M rows per split, both operands read in
//                   their stored [M, *] layout, with the partial column
//                   sums of dY (the bias gradient) from the blocks of the
//                   first column tile.
//   sum_partials:   out[L] = sum over S fp32 partials, in order, in the
//                   output type, for up to eight such jobs a launch.
//   row_scale:      Y[M, K] = round(s[m / rows] * X[M, K]) in X's type.
//
// Two options serve the residual-fused attention branch of the kernel
// tools (tokenreduction_tpu_torch/tools/proto_residual_fuse.py, the
// counterpart of the TPU kernel tools/proto_residual_fuse.py
// _bwd_kernel_res): layer_norm_bwd may add a residual's cotangent to dX in
// fp32 before its rounding (dx_total = dx_branch + dy), and row_scale
// writes the branch's cotangent round(s_b . dy) once, a launch of its own
// before the products that read it (dY . Wproj, dWproj, dbproj), rather
// than a factor folded into their A loads.
//
// fp32 operands of the forward layout (W [n_out, K]: every eval product
// and every training forward's, GELU' out included) go through the sm_90a
// kernel of gemm_tf32_sm90.cu (TMA, mbarrier, wgmma in 3xTF32 on the
// tensor cores); the fp32 layouts that only the fp32 backward launches
// (dY . W and the weight gradient) through gemm_tf32_bwd_sm90.cu (the
// same, with the MN-major operands transposed as they are split); bf16
// operands through the sm_90a kernel of gemm_sm90.cu (TMA, mbarrier,
// wgmma). The entry points below call each with the same arguments. With
// bf16 operands the residual and Y may also be fp32: the whole block keeps
// its residual stream y in fp32 between its halves, as the TPU kernel
// does, so its proj GEMM writes fp32 y, LN2 reads it, and the fc2 GEMM
// adds it; the backward's dLN products write fp32.
//
// The weight gradients are sums over up to 50,432 rows. The TPU kernel
// carries them across a sequential grid in VMEM-resident accumulators;
// Hopper's blocks run in no order, so M is cut into slices whose fp32
// partials are summed in a fixed order by a second launch: no atomics,
// and the gradients are the same bits from run to run.
//
// Why LayerNorm is a launch of its own: applied to each staged slice of X
// inside the GEMM, it was redone for every column tile and cost the fc1
// product at DeiT-S width about a third of its time; written once, the
// normalised rows cost one round trip of [M, K] in the operand type.
#include <stdint.h>

#include "common.cuh"
#include "gemm.cuh"

namespace trk {
namespace {

constexpr int LN_THREADS = 256;

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// TX: the type of X's rows; T: the operand type of the LN parameters and Y.
template <typename TX, typename T>
__global__ void __launch_bounds__(LN_THREADS)
    layer_norm_kernel(const TX* __restrict__ x, const int* __restrict__ idx, int M, int K,
                      int rows_out, int rows_in, const T* __restrict__ w,
                      const T* __restrict__ b, float eps, T* __restrict__ y) {
  const int m = (blockIdx.x * LN_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (m >= M) return;
  const int src = idx != nullptr ? gathered_row(idx, m, rows_out, rows_in) : m;
  const TX* row = x + static_cast<size_t>(src) * K;
  float f[8];
  float s = 0.f;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    load8(row + k, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  const float mu = warp_sum(s) / K;
  float q = 0.f;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    load8(row + k, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) q += (f[i] - mu) * (f[i] - mu);
  }
  const float rs = 1.0f / sqrtf(warp_sum(q) / K + eps);
  T* out = y + static_cast<size_t>(m) * K;
  for (int k = lane * 8; k < K; k += 32 * 8) {
    float g[8], h[8];
    load8(row + k, f);
    load8(w + k, g);
    load8(b + k, h);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (f[i] - mu) * rs * g[i] + h[i];
    store8(out + k, f);
  }
}

// ---- layer_norm_bwd
// The LayerNorm backward of the TPU kernels
// tokenreduction_tpu/ops/fused_block_train.py _bwd_kernel (:199-204) and
// ops/fused_mlp_train.py _bwd_kernel (:112-128): dX in X's type, and
// d gamma = sum over rows of dLN * Xhat, d beta = sum of dLN.
//
// What bounds it: bytes. Each element reads X (bf16: 2 bytes) and dLN
// (fp32: 4) and writes dX (2): 8 bytes an element, 155 MB at B = 256,
// N = 197, D = 384, 0.046 ms at 3.35 TB/s. The arithmetic is a few
// operations an element and four warp reductions a row.
//
// Design. The rows are cut into bands of consecutive rows, one block a
// band and at most one block an SM (ops/_build.py ln_bwd_plan: the bands
// depend on M and the SM count only, never on scheduling). Warp w of a
// block takes the band's rows w, w + 16, ... and holds a whole row in
// registers: at K = 384 (the DeiT-S width, compiled apart) a lane holds
// 12 elements, 3 chunks of 4 (8-byte loads of bf16 X, 16-byte loads of
// dLN, each coalesced over the warp), and no lane idles. While the warp
// computes a row, the loads of its next row, X and dLN together, are in
// flight into a second set of registers, so a row's reductions never wait
// on a load that could have been issued earlier: 16 warps an SM keep
// about 37 KB of loads in flight, above the 20 KB an SM needs to draw its
// share of 3.35 TB/s at about 0.8 us of latency. A bring-up measurement
// (PERF.md) picked the registers over a shared-memory ring filled
// by 1-D bulk copies, which was not built: a second row in flight
// changed nothing, so the loads in flight do not hold the kernel back.
// The statistics are recomputed from X in fp32, two-pass, as
// layer_norm_kernel computes them (the sums are split over the lanes in
// other chunks, so they may round apart in the last bit).
//
// The parameter gradients, in a fixed order with no serial tail over the
// rows: each warp sums its rows' dLN * Xhat and dLN in registers; the
// block adds its warps in index order in shared memory and writes one
// fp32 partial row [2K]; a second launch (sum_partials) adds the partial
// rows in band order, a thread per column over one-warp blocks, and
// rounds d gamma and d beta once. The bring-up measurement picked it over
// the last block to finish summing them (a ticket counter): one SM
// reading every band's partial row took longer than the second launch.
// Two launches give the same bits.
//
// Other K (multiples of 8 up to 1024): the general instance, 8 warps a
// block, up to 8 chunks a lane (those past K masked) and no prefetch (two
// rows of 1024 would not fit in a thread's registers).
constexpr int LNB_MAX_K = 1024;

// KC: K fixed at compile time (a multiple of 128), or 0 for any K.
template <int KC> struct LnBwd {
  static constexpr int CH = KC ? KC / 128 : LNB_MAX_K / 128;  // chunks of 4 a lane
  static constexpr int WARPS = KC ? 16 : 8;
  static constexpr int THREADS = WARPS * 32;
  // a warp's rows in flight behind the one it computes
  static constexpr int DEPTH = KC ? 1 : 0;
};

// Four neighbouring elements as loaded (8 bytes of bf16, 16 of fp32),
// read and written past L1: each byte of X, dLN and dX is touched once.
template <typename T> struct Chunk;
template <> struct Chunk<float> { using type = float4; };
template <> struct Chunk<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ uint2 ld_chunk(const __nv_bfloat16* p) {
  return __ldcs(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 ld_chunk(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ void unpack4(uint2 r, float* f) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
  f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
}
__device__ __forceinline__ void unpack4(float4 r, float* f) {
  f[0] = r.x, f[1] = r.y, f[2] = r.z, f[3] = r.w;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
  uint2 r;
  *reinterpret_cast<__nv_bfloat162*>(&r.x) = __floats2bfloat162_rn(f[0], f[1]);
  *reinterpret_cast<__nv_bfloat162*>(&r.y) = __floats2bfloat162_rn(f[2], f[3]);
  __stcs(reinterpret_cast<uint2*>(p), r);
}
__device__ __forceinline__ void store4(float* p, const float* f) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(f[0], f[1], f[2], f[3]));
}

// Two warp sums at once (each in warp_sum's order).
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Block i takes rows [i * rows, min(M, (i + 1) * rows)); lane chunk c
// covers columns 4 (lane + 32 c) .. + 3. part: [gridDim.x][2K] fp32, each
// block's sums of dLN * Xhat and dLN. RES: res [M, K] (X's type) is added
// to dX in fp32 before its rounding (a variant of its own, so the training
// branches' launches keep their code).
template <typename T, int KC, bool RES>
__global__ void __launch_bounds__(LnBwd<KC>::THREADS, 1)
    layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dln, int M, int K,
                          int rows, const T* __restrict__ w, float eps, T* __restrict__ dx,
                          float* __restrict__ part, const T* __restrict__ res) {
  using C = typename Chunk<T>::type;
  using P = LnBwd<KC>;
  constexpr int CH = P::CH, DEPTH = P::DEPTH;
  extern __shared__ __align__(16) float red[];  // [WARPS][2K]
  const int kk = KC ? KC : K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m_end = min(M, (static_cast<int>(blockIdx.x) + 1) * rows);
  auto col = [&](int c) { return 4 * (lane + 32 * c); };
  auto in = [&](int c) { return KC != 0 || col(c) < kk; };

  float g[CH][4], gw[CH][4] = {}, gb[CH][4] = {};
#pragma unroll
  for (int c = 0; c < CH; ++c)
    if (in(c)) unpack4(*reinterpret_cast<const C*>(w + col(c)), g[c]);
  // slot 0: the row computed; slots 1 .. DEPTH: the next rows, in flight
  C xq[DEPTH + 1][CH];
  float4 dq[DEPTH + 1][CH];
  auto load = [&](int m, C* xr, float4* dr) {
    const T* xrow = x + static_cast<size_t>(m) * kk;
    const float* drow = dln + static_cast<size_t>(m) * kk;
#pragma unroll
    for (int c = 0; c < CH; ++c)
      if (in(c)) {
        xr[c] = ld_chunk(xrow + col(c));
        dr[c] = ld_chunk(drow + col(c));
      }
  };

  int m = static_cast<int>(blockIdx.x) * rows + warp;
#pragma unroll
  for (int i = 0; i < DEPTH; ++i)
    if (m + i * P::WARPS < m_end) load(m + i * P::WARPS, xq[i], dq[i]);
  for (; m < m_end; m += P::WARPS) {
    if (m + DEPTH * P::WARPS < m_end) load(m + DEPTH * P::WARPS, xq[DEPTH], dq[DEPTH]);
    float f[CH][4], d[CH][4];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c)
      if (in(c)) {
        unpack4(xq[0][c], f[c]);
        unpack4(dq[0][c], d[c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) s += f[c][i];
      }
    const float mu = warp_sum(s) / kk;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c)
      if (in(c)) {
#pragma unroll
        for (int i = 0; i < 4; ++i) q += (f[c][i] - mu) * (f[c][i] - mu);
      }
    const float rs = 1.0f / sqrtf(warp_sum(q) / kk + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c)
      if (in(c)) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          f[c][i] = (f[c][i] - mu) * rs;  // x_hat
          gw[c][i] += d[c][i] * f[c][i];
          gb[c][i] += d[c][i];
          d[c][i] *= g[c][i];  // dx_hat
          s1 += d[c][i];
          s2 += d[c][i] * f[c][i];
        }
      }
    warp_sum2(s1, s2);
    const float m1 = s1 / kk, m2 = s2 / kk;
    T* out = dx + static_cast<size_t>(m) * kk;
#pragma unroll
    for (int c = 0; c < CH; ++c)
      if (in(c)) {
#pragma unroll
        for (int i = 0; i < 4; ++i) d[c][i] = rs * (d[c][i] - m1 - f[c][i] * m2);
        if (RES) {
          float r[4];
          unpack4(ld_chunk(res + static_cast<size_t>(m) * kk + col(c)), r);
#pragma unroll
          for (int i = 0; i < 4; ++i) d[c][i] += r[i];
        }
        store4(out + col(c), d[c]);
      }
#pragma unroll
    for (int i = 0; i < DEPTH; ++i)
#pragma unroll
      for (int c = 0; c < CH; ++c) xq[i][c] = xq[i + 1][c], dq[i][c] = dq[i + 1][c];
  }

  // the block's partial row: its warps added in index order
  const int L = 2 * kk;
  float* mine = red + warp * L;
#pragma unroll
  for (int c = 0; c < CH; ++c)
    if (in(c)) {
      *reinterpret_cast<float4*>(mine + col(c)) = make_float4(gw[c][0], gw[c][1], gw[c][2], gw[c][3]);
      *reinterpret_cast<float4*>(mine + kk + col(c)) =
          make_float4(gb[c][0], gb[c][1], gb[c][2], gb[c][3]);
    }
  __syncthreads();
  float* row_part = part + static_cast<size_t>(blockIdx.x) * L;
  for (int j = threadIdx.x; j < L; j += P::THREADS) {
    float acc = 0.f;
#pragma unroll
    for (int wi = 0; wi < P::WARPS; ++wi) acc += red[wi * L + j];
    row_part[j] = acc;
  }
}

// The fixed-order sums of fp32 partial rows, up to kSumJobs of them in one
// launch (a branch backward's weight, bias and LayerNorm parameter
// gradients): job j is out_j[i] = the sum over z < S_j of part_j[z][i],
// added in z order from 0 and rounded once to out_j's type. The TPU
// kernels carry these sums across their sequential grid in VMEM; here
// each is a chain of S dependent adds a column, and the cost of the former
// launch a sum was the host's, so one launch takes every sum of a branch.
// A column's chain is bound by the latency of its loads, so each thread
// keeps two batches of rows in flight, the next batch's loads issued
// before the current one is added. A thread of a short job (S <= kSumTall,
// L % 4 == 0: the weight and bias gradients' few slices) takes
// four columns, a float4 load a row, kSumShort rows a batch; a thread of a
// tall job (the LayerNorm bands, db1's row tiles) or of a width that is no
// multiple of 4 takes one column, kSumLong rows a batch, so its chain has
// four times as many rows in flight and its job four times as many
// threads. A block takes kSumThreads threads' columns of one job and finds
// the job by a scan of the table's first blocks. The host orders the jobs
// tallest first (ops/_build.py sum_order), so the long chains start first
// and overlap the wide weight-gradient sums. The table goes by value as a
// __grid_constant__ parameter: no copy to the card and no launch besides
// the sum's.
constexpr int kSumJobs = 8;  // the jobs a launch (ops/_build.py SUM_JOBS)
constexpr int kSumThreads = 64, kSumTall = 32;
constexpr int kSumShort = 8, kSumLong = 32;  // rows a batch

struct SumJob {
  const float* part;  // [S][L], 16-byte aligned
  void* out;          // [L], float or bf16 (dtype)
  int S, L, dtype, cols;  // cols: columns a thread, 4 or 1
};

struct SumTable {
  SumJob job[kSumJobs];
  int first[kSumJobs];  // each job's first block, ascending
  int n;
};

// Rows [z0, z0 + R) (those below S) of C consecutive columns at p, row
// stride L, into buf.
template <int C, int R>
__device__ __forceinline__ void load_rows(float (&buf)[R][C], const float* p, int z0, int S,
                                          int L) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (z0 + i < S) {
      const float* row = p + static_cast<size_t>(z0 + i) * L;
      if constexpr (C == 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row));
        buf[i][0] = v.x, buf[i][1] = v.y, buf[i][2] = v.z, buf[i][3] = v.w;
      } else {
        buf[i][0] = __ldg(row);
      }
    }
}

// acc[c] = the sum of the S rows of column c at p, in z order from 0.
template <int C, int R>
__device__ __forceinline__ void sum_rows(const float* p, int S, int L, float (&acc)[C]) {
  float cur[R][C], nxt[R][C];
  load_rows<C, R>(cur, p, 0, S, L);
  for (int z0 = 0; z0 < S; z0 += R) {
    load_rows<C, R>(nxt, p, z0 + R, S, L);
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (z0 + i < S)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += cur[i][c];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) cur[i][c] = nxt[i][c];
  }
}

template <int C>
__device__ __forceinline__ void store_sums(const SumJob& job, int c0, const float (&acc)[C]) {
  const int cols = min(C, job.L - c0);
  if (job.dtype == kFloat32) {
    float* out = static_cast<float*>(job.out) + c0;
    for (int c = 0; c < cols; ++c) store1(out + c, acc[c]);
  } else {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(job.out) + c0;
    for (int c = 0; c < cols; ++c) store1(out + c, acc[c]);
  }
}

__global__ void __launch_bounds__(kSumThreads)
    sum_partials_kernel(const __grid_constant__ SumTable t) {
  const int b = static_cast<int>(blockIdx.x);
  int j = 0;
#pragma unroll
  for (int i = 1; i < kSumJobs; ++i)
    if (i < t.n && t.first[i] <= b) j = i;
  const SumJob& job = t.job[j];
  const int c0 = ((b - t.first[j]) * kSumThreads + static_cast<int>(threadIdx.x)) * job.cols;
  if (c0 >= job.L) return;
  if (job.cols == 4) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    sum_rows<4, kSumShort>(job.part + c0, job.S, job.L, acc);
    store_sums(job, c0, acc);
  } else {
    float acc[1] = {0.f};
    sum_rows<1, kSumLong>(job.part + c0, job.S, job.L, acc);
    store_sums(job, c0, acc);
  }
}

template <typename TX, typename T>
int launch_layer_norm(const void* x, const int* idx, int M, int K, int rows_out, int rows_in,
                      const void* w, const void* b, float eps, void* y, cudaStream_t stream) {
  const int rows_per_block = LN_THREADS / 32;
  layer_norm_kernel<TX, T><<<(M + rows_per_block - 1) / rows_per_block, LN_THREADS, 0, stream>>>(
      static_cast<const TX*>(x), idx, M, K, rows_out, rows_in, static_cast<const T*>(w),
      static_cast<const T*>(b), eps, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KC, bool RES = false>
int launch_layer_norm_bwd(const void* x, const float* dln, int M, int K, int bands, int rows,
                          const void* w, float eps, void* dx, float* part, cudaStream_t stream,
                          const void* res = nullptr) {
  using P = LnBwd<KC>;
  const auto kernel = layer_norm_bwd_kernel<T, KC, RES>;
  const size_t smem = sizeof(float) * P::WARPS * 2 * K;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<bands, P::THREADS, smem, stream>>>(static_cast<const T*>(x), dln, M, K, rows,
                                               static_cast<const T*>(w), eps, static_cast<T*>(dx),
                                               part, static_cast<const T*>(res));
  return static_cast<int>(cudaGetLastError());
}

// row_scale: a thread per 8 neighbouring elements of a row.
template <typename T>
__global__ void __launch_bounds__(256)
    row_scale_kernel(const T* __restrict__ x, const float* __restrict__ s, int M, int K, int rows,
                     T* __restrict__ y) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const int per_row = K / 8;
  if (i >= static_cast<long long>(M) * per_row) return;
  const int m = static_cast<int>(i / per_row);
  const size_t at = static_cast<size_t>(m) * K + 8 * (i % per_row);
  const float f = s[m / rows];
  float v[8];
  load8(x + at, v);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] *= f;
  store8(y + at, v);
}

template <typename T>
int launch_row_scale(const void* x, const float* s, int M, int K, int rows, void* y,
                     cudaStream_t stream) {
  const long long threads = static_cast<long long>(M) * (K / 8);
  row_scale_kernel<T><<<static_cast<int>((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(x), s, M, K, rows, static_cast<T*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace trk

extern "C" const char* tr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns the cudaError_t of the launch (0 on success). `dtype` is the
// type of w, b and y; x_dtype that of x: `dtype` or float32. idx may be
// null (row m reads x row m). K must be a multiple of 8; the caller checks
// shapes, dtypes, contiguity and 16-byte alignment.
extern "C" int tr_layer_norm(int dtype, int x_dtype, const void* x, const void* idx, int M,
                             int K, int rows_out, int rows_in, const void* w, const void* b,
                             float eps, void* y, void* stream) {
  using namespace trk;
  if (M == 0) return 0;
  if (K % 8 != 0 || (x_dtype != dtype && x_dtype != kFloat32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ids = static_cast<const int*>(idx);
  if (dtype == kFloat32)
    return launch_layer_norm<float, float>(x, ids, M, K, rows_out, rows_in, w, b, eps, y, s);
  if (dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == kFloat32)
    return launch_layer_norm<float, __nv_bfloat16>(x, ids, M, K, rows_out, rows_in, w, b, eps,
                                                   y, s);
  return launch_layer_norm<__nv_bfloat16, __nv_bfloat16>(x, ids, M, K, rows_out, rows_in, w,
                                                         b, eps, y, s);
}

// Returns the cudaError_t of the launch (0 on success). `dtype` is the
// type of x, w, dx and res; dln and part are fp32, part [bands][2][K]: each
// band's sums, which sum_partials reduces in band order. Block i takes
// rows [i * rows, min(M, (i + 1) * rows)): bands * rows >= M. res [M, K]
// or null is added to dx before its rounding. K must be a multiple of 8
// and at most 1024; the caller checks the rest.
extern "C" int tr_layer_norm_bwd(int dtype, const void* x, const void* dln, int M, int K,
                                 const void* w, float eps, void* dx, void* part, int bands,
                                 int rows, const void* res, void* stream) {
  using namespace trk;
  if (M == 0) return 0;
  if (K % 8 != 0 || K > LNB_MAX_K || bands < 1 || rows < 1 ||
      static_cast<long long>(bands) * rows < M)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dln);
  float* p = static_cast<float*>(part);
  if (res != nullptr) {  // the residual-fused branch's variant
    if (dtype == kFloat32)
      return K == 384 ? launch_layer_norm_bwd<float, 384, true>(x, d, M, K, bands, rows, w, eps,
                                                                dx, p, s, res)
                      : launch_layer_norm_bwd<float, 0, true>(x, d, M, K, bands, rows, w, eps, dx,
                                                              p, s, res);
    if (dtype == kBFloat16)
      return K == 384 ? launch_layer_norm_bwd<__nv_bfloat16, 384, true>(x, d, M, K, bands, rows,
                                                                        w, eps, dx, p, s, res)
                      : launch_layer_norm_bwd<__nv_bfloat16, 0, true>(x, d, M, K, bands, rows, w,
                                                                      eps, dx, p, s, res);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == kFloat32)
    return K == 384 ? launch_layer_norm_bwd<float, 384>(x, d, M, K, bands, rows, w, eps, dx, p, s)
                    : launch_layer_norm_bwd<float, 0>(x, d, M, K, bands, rows, w, eps, dx, p, s);
  if (dtype == kBFloat16)
    return K == 384
               ? launch_layer_norm_bwd<__nv_bfloat16, 384>(x, d, M, K, bands, rows, w, eps, dx, p, s)
               : launch_layer_norm_bwd<__nv_bfloat16, 0>(x, d, M, K, bands, rows, w, eps, dx, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Returns the cudaError_t of the launch (0 on success). `dtype` is the
// type of x, w and bias; res_dtype and y_dtype those of the residual and
// y: `dtype` or, with bf16 operands, float32. w is [n_out, K], or [K,
// n_out] with w_kn. gelu_grad (with gelu, w not w_kn), mul and col_sums
// ([ceil(M / 128)][n_out], both with w_kn) are fp32 or null; idx
// (residual rows) may be null. row_scale [M / scale_rows] fp32 or null:
// row m's result times row_scale[m / scale_rows] before the residual, in
// the bf16 forward layout with no GELU only. K and n_out must be multiples
// of 8; the caller checks shapes, dtypes, contiguity and 16-byte
// alignment.
extern "C" int tr_gemm(int dtype, const void* x, int M, int K, const void* w, int w_kn,
                       const void* bias, int n_out, int gelu, void* gelu_grad, const void* mul,
                       int res_dtype, const void* res, const void* idx, int rows_out,
                       int rows_in, int y_dtype, void* y, void* col_sums, const void* row_scale,
                       int scale_rows, void* stream) {
  using namespace trk;
  if (M == 0) return 0;
  auto takes = [&](int t) { return t == dtype || t == kFloat32; };
  if (K % 8 != 0 || n_out % 8 != 0 || (dtype != kFloat32 && dtype != kBFloat16) ||
      !takes(y_dtype) || (res != nullptr && !takes(res_dtype)) ||
      (gelu_grad != nullptr && (!gelu || w_kn)) || (mul != nullptr && !w_kn) ||
      (col_sums != nullptr && !w_kn) ||
      (row_scale != nullptr && (dtype != kBFloat16 || w_kn || gelu || scale_rows < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs a{};
  a.x = x, a.M = M, a.K = K, a.w = w, a.bias = bias, a.n_out = n_out, a.gelu = gelu;
  a.gelu_grad = static_cast<float*>(gelu_grad), a.mul = static_cast<const float*>(mul);
  a.res = res, a.res_f32 = res_dtype == kFloat32, a.idx = static_cast<const int*>(idx);
  a.rows_out = rows_out, a.rows_in = rows_in, a.y = y, a.y_f32 = y_dtype == kFloat32;
  a.col_sums = static_cast<float*>(col_sums);
  a.row_scale = static_cast<const float*>(row_scale), a.scale_rows = scale_rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return w_kn ? launch_gemm_tf32_bwd_sm90(a, false, 1, s) : launch_gemm_tf32_sm90(a, s);
  return launch_gemm_sm90(a, false, w_kn != 0, 1, s);
}

// The partial weight gradients of one linear layer: ws[z] = dY^T X over
// rows [z * rows_per_split, (z + 1) * rows_per_split) for z < splits, fp32
// [splits][n_out][K]; bias_ws (or null) [splits][n_out] the partial column
// sums of dY. dy [rows, n_out] and x [rows, K] share `dtype`;
// rows_per_split is a multiple of the kernel's K step: 32 (fp32,
// gemm_tf32_bwd_sm90.cu) or 64 (bf16, gemm_sm90.cu), which each launcher
// checks. Returns the cudaError_t of the launch.
extern "C" int tr_gemm_wgrad(int dtype, const void* dy, const void* x, int rows, int n_out,
                             int K, int splits, int rows_per_split, void* ws, void* bias_ws,
                             void* stream) {
  using namespace trk;
  if (n_out == 0 || K == 0) return 0;
  if (K % 8 != 0 || n_out % 8 != 0 || splits < 1 || rows_per_split < 1 ||
      static_cast<long long>(splits) * rows_per_split < rows ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs a{};
  a.x = dy, a.M = n_out, a.K = rows, a.w = x, a.n_out = K;
  a.y = ws, a.y_f32 = 1, a.k_split = rows_per_split, a.a_sums = static_cast<float*>(bias_ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_gemm_tf32_bwd_sm90(a, true, splits, s);
  return launch_gemm_sm90(a, true, true, splits, s);
}

// The sums of n <= kSumJobs jobs in one launch, in the given order (the
// caller's: tallest first, ops/_build.py sum_order): job j is out_j[i] =
// sum over z < S_j of part_j[z][i] in order, for i < L_j, written in
// out_dtype_j, where ptrs[2j], ptrs[2j + 1] are part_j (16-byte aligned)
// and out_j, and ints[3j .. 3j + 2] are S_j, L_j and out_dtype_j. The
// jobs' blocks follow one another in that order. Returns the cudaError_t
// of the launch.
extern "C" int tr_sum_partials_many(int n, const unsigned long long* ptrs, const int* ints,
                                    void* stream) {
  using namespace trk;
  if (n < 1 || n > kSumJobs) return static_cast<int>(cudaErrorInvalidValue);
  SumTable t{};
  t.n = n;
  int blocks = 0;
  for (int j = 0; j < n; ++j) {
    const int S = ints[3 * j], L = ints[3 * j + 1], dtype = ints[3 * j + 2];
    if (S < 0 || L < 0 || ptrs[2 * j] % 16 != 0 || (dtype != kFloat32 && dtype != kBFloat16))
      return static_cast<int>(cudaErrorInvalidValue);
    const int cols = S <= kSumTall && L % 4 == 0 ? 4 : 1;
    t.job[j] = SumJob{reinterpret_cast<const float*>(static_cast<uintptr_t>(ptrs[2 * j])),
                      reinterpret_cast<void*>(static_cast<uintptr_t>(ptrs[2 * j + 1])), S, L,
                      dtype, cols};
    t.first[j] = blocks;
    blocks += (L + kSumThreads * cols - 1) / (kSumThreads * cols);
  }
  if (blocks == 0) return 0;
  sum_partials_kernel<<<blocks, kSumThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// y [M, K] = round(s[m / rows] * x [M, K]) in `dtype` (x and y; s fp32);
// K a multiple of 8, contiguous 16-byte aligned tensors (the caller
// checks). Returns the cudaError_t of the launch.
extern "C" int tr_row_scale(int dtype, const void* x, const void* s, int M, int K, int rows,
                            void* y, void* stream) {
  using namespace trk;
  if (M == 0) return 0;
  if (K % 8 != 0 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* f = static_cast<const float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_row_scale<float>(x, f, M, K, rows, y, st);
  if (dtype == kBFloat16) return launch_row_scale<__nv_bfloat16>(x, f, M, K, rows, y, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
