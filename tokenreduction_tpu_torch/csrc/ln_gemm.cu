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
//                   X's type; the per-block partial sums of dLN * Xhat and
//                   dLN (the gradients of gamma and beta) go to a
//                   workspace that sum_partials reduces in a fixed order.
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
//                   output type.
//
// fp32 operands (the parity dtype) go through FMA in true fp32 on the CUDA
// cores, in this file; bf16 operands through the sm_90a kernel of
// gemm_sm90.cu (TMA, mbarrier, wgmma), which the entry points below call
// with the same arguments. With bf16 operands the residual and Y may also
// be fp32: the whole block keeps its residual stream y in fp32 between its
// halves, as the TPU kernel does, so its proj GEMM writes fp32 y, LN2
// reads it, and the fc2 GEMM adds it; the backward's dLN products write
// fp32.
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
//
// The fp32 GEMM computes a 128x128 output tile per block over 32-deep K
// slices, copied by cp.async into a ring of three shared-memory stages, so
// two slices are in flight while one multiplies.
#include <stdint.h>

#include "common.cuh"
#include "gemm.cuh"

namespace trk {
namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int STAGES = 3;  // K slices in the cp.async ring
constexpr int LN_THREADS = 256;
constexpr int LN_WARPS = LN_THREADS / 32;
constexpr int LN_CHUNKS = 4;  // layer_norm_bwd keeps a row in registers: K <= 4 * 256

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

// A warp per row (rows strided over the grid); lane l holds columns
// (l + 32 c) * 8 .. +7. The statistics are recomputed from X exactly as
// layer_norm_kernel computes them. part: [gridDim.x][2][K] fp32, the
// block's sums of dLN * Xhat and of dLN, its warps added in order.
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
    layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dln, int M, int K,
                          const T* __restrict__ w, float eps, T* __restrict__ dx,
                          float* __restrict__ part) {
  extern __shared__ __align__(16) float red[];  // [LN_WARPS][2 * K]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float gw[LN_CHUNKS][8] = {}, gb[LN_CHUNKS][8] = {};
  for (int m = blockIdx.x * LN_WARPS + warp; m < M; m += gridDim.x * LN_WARPS) {
    const T* row = x + static_cast<size_t>(m) * K;
    const float* drow = dln + static_cast<size_t>(m) * K;
    float f[LN_CHUNKS][8], g[LN_CHUNKS][8];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < LN_CHUNKS; ++c) {
      const int k = (lane + 32 * c) * 8;
      if (k >= K) continue;
      load8(row + k, f[c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += f[c][i];
    }
    const float mu = warp_sum(s) / K;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < LN_CHUNKS; ++c) {
      if ((lane + 32 * c) * 8 >= K) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) q += (f[c][i] - mu) * (f[c][i] - mu);
    }
    const float rs = 1.0f / sqrtf(warp_sum(q) / K + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int c = 0; c < LN_CHUNKS; ++c) {
      const int k = (lane + 32 * c) * 8;
      if (k >= K) continue;
      float d[8];
      load8(drow + k, d);
      load8(w + k, g[c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        f[c][i] = (f[c][i] - mu) * rs;  // x_hat
        gw[c][i] += d[i] * f[c][i];
        gb[c][i] += d[i];
        g[c][i] *= d[i];  // dx_hat
        s1 += g[c][i];
        s2 += g[c][i] * f[c][i];
      }
    }
    const float m1 = warp_sum(s1) / K, m2 = warp_sum(s2) / K;
#pragma unroll
    for (int c = 0; c < LN_CHUNKS; ++c) {
      const int k = (lane + 32 * c) * 8;
      if (k >= K) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) g[c][i] = rs * (g[c][i] - m1 - f[c][i] * m2);
      store8(dx + static_cast<size_t>(m) * K + k, g[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    const int k = (lane + 32 * c) * 8;
    if (k >= K) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      red[warp * 2 * K + k + i] = gw[c][i];
      red[warp * 2 * K + K + k + i] = gb[c][i];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * K; j += LN_THREADS) {
    float acc = 0.f;
    for (int wi = 0; wi < LN_WARPS; ++wi) acc += red[wi * 2 * K + j];
    part[static_cast<size_t>(blockIdx.x) * 2 * K + j] = acc;
  }
}

template <typename TO>
__global__ void sum_partials_kernel(const float* __restrict__ part, int S, int L,
                                    TO* __restrict__ out) {
  for (int i = blockIdx.x * 256 + threadIdx.x; i < L; i += gridDim.x * 256) {
    float acc = 0.f;
    for (int z = 0; z < S; ++z) acc += part[static_cast<size_t>(z) * L + i];
    store1(out + i, acc);
  }
}

// Staged tiles: STAGES K slices of A and B in dynamic shared memory. An
// operand stored K-contiguous ([rows][k]) is staged as [BM or BN][BK + pad],
// one stored K-major ([k][cols]) as [BK][BM or BN + pad]; the pad of 16
// bytes keeps every row 16-byte aligned.
template <bool A_KM, bool B_KN> struct Tile {
  static constexpr int PAD = 4;
  static constexpr int A_LD = A_KM ? BM + PAD : BK + PAD;
  static constexpr int B_LD = B_KN ? BN + PAD : BK + PAD;
  static constexpr int A_ELEMS = A_KM ? BK * A_LD : BM * A_LD;
  static constexpr int B_ELEMS = B_KN ? BK * B_LD : BN * B_LD;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
  static constexpr size_t SMEM_BYTES = sizeof(float) * STAGES * STAGE_ELEMS;
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// Start the copies of an [R][C] fp32 tile (C contiguous in device and
// shared memory) whose element (0, 0) is element (r0, c0) of a row-major
// matrix with `ld` columns; rows >= r_end and columns >= c_end are
// zero-filled (c_end is a multiple of 4, so a 16-byte chunk is all in or
// all out).
template <int R, int C, int LD>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, int ld, int r0, int r_end,
                                          int c0, int c_end) {
  constexpr int V = 4, CPR = C / V, CHUNKS = R * CPR / THREADS;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int chunk = threadIdx.x + c * THREADS;
    const int r = chunk / CPR, cc = (chunk % CPR) * V;
    const bool in = r0 + r < r_end && c0 + cc < c_end;
    cp_async16(dst + r * LD + cc, in ? src + static_cast<size_t>(r0 + r) * ld + c0 + cc : src, in);
  }
}

// Start the copies of the K slice at k0 (up to k_end) into stage `buf`.
template <bool A_KM, bool B_KN>
__device__ __forceinline__ void load_slice(const GemmArgs& a, float* tiles, int buf, int m0,
                                           int n0, int k0, int k_end) {
  using TL = Tile<A_KM, B_KN>;
  float* A = tiles + buf * TL::STAGE_ELEMS;
  float* B = A + TL::A_ELEMS;
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  if constexpr (A_KM)
    copy_tile<BK, BM, TL::A_LD>(A, x, a.M, k0, k_end, m0, a.M);
  else
    copy_tile<BM, BK, TL::A_LD>(A, x, a.K, m0, a.M, k0, k_end);
  if constexpr (B_KN)
    copy_tile<BK, BN, TL::B_LD>(B, w, a.n_out, k0, k_end, n0, a.n_out);
  else
    copy_tile<BN, BK, TL::B_LD>(B, w, a.K, n0, a.n_out, k0, k_end);
}

// The fp32 epilogue of one element; returns the value written (0 outside
// Y). MUL: the layout whose launches may carry the fp32 factor (the
// backward's dY . W); GRAD: the variant that writes GELU'.
template <bool MUL, bool GRAD>
__device__ __forceinline__ float store(const GemmArgs& a, int row, int col, float acc) {
  if (row >= a.M || col >= a.n_out) return 0.f;
  float v = acc;
  if (a.bias) v += static_cast<const float*>(a.bias)[col];
  if (a.gelu) {
    if (GRAD) a.gelu_grad[static_cast<size_t>(row) * a.n_out + col] = gelu_grad(v);
    v = gelu(v);
  }
  if (MUL && a.mul) v *= a.mul[static_cast<size_t>(row) * a.n_out + col];
  if (a.res) v += static_cast<const float*>(a.res)[res_row(a, row) * a.n_out + col];
  static_cast<float*>(a.y)[static_cast<size_t>(row) * a.n_out + col] = v;
  return v;
}

// The fp32 GEMM. A_KM: A is stored [K][M] (the weight gradient's dY), and
// the K rows may be split over blockIdx.z; B_KN: B is stored [K][n_out]
// (the backward's untransposed weight, or wgrad's X); GRAD: the GELU
// epilogue also writes GELU' (the training forward's fc1). The backward's
// own epilogue steps (the fp32 factor, the column sums) compile only into
// the layout with B_KN and not A_KM, the split only into A_KM.
template <bool A_KM, bool B_KN, bool GRAD>
__global__ void __launch_bounds__(THREADS) gemm_kernel(GemmArgs a) {
  using TL = Tile<A_KM, B_KN>;
  constexpr bool BWD = B_KN && !A_KM;
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* tiles = reinterpret_cast<float*>(dsmem);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  int k_begin = 0, k_end = a.K;
  if constexpr (A_KM) {
    if (a.k_split) {
      k_begin = blockIdx.z * a.k_split;
      k_end = min(a.K, k_begin + a.k_split);
      a.y = static_cast<float*>(a.y) + static_cast<size_t>(blockIdx.z) * a.M * a.n_out;
    }
  }
  // wgrad: the blocks of the first column tile also sum A's rows (dY's
  // columns) over their slice; rows past k_end are zero-filled
  const bool a_sums = A_KM && a.a_sums != nullptr && blockIdx.x == 0;
  float a_sum = 0.f;

  // 16x16 threads, each an 8x8 micro-tile strided over the 128x128 tile.
  float acc[8][8] = {};
  const int ty = tid >> 4, tx = tid & 15;
  // K loop over a ring of STAGES slices: slice i multiplies while the
  // copies of slices i+1 .. i+STAGES-1 are in flight. One commit group per
  // slice (empty past the end) keeps the wait count uniform.
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    const int k0 = k_begin + st * BK;
    if (k0 < k_end) load_slice<A_KM, B_KN>(a, tiles, st, m0, n0, k0, k_end);
    cp_async_commit();
  }
  for (int i = 0, k0 = k_begin; k0 < k_end; ++i, k0 += BK) {
    const int buf = i % STAGES;
    cp_async_wait_all_but_newest();
    __syncthreads();  // slice i visible; slice i-1's buffer free
    const int kn = k0 + (STAGES - 1) * BK;
    if (kn < k_end) load_slice<A_KM, B_KN>(a, tiles, (i + STAGES - 1) % STAGES, m0, n0, kn, k_end);
    cp_async_commit();
    const float* A = tiles + buf * TL::STAGE_ELEMS;
    const float* B = A + TL::A_ELEMS;
    if (a_sums && tid < BM) {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) a_sum += A[kk * TL::A_LD + tid];
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = A_KM ? A[kk * TL::A_LD + ty + 16 * i] : A[(ty + 16 * i) * TL::A_LD + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bv[j] = B_KN ? B[kk * TL::B_LD + tx + 16 * j] : B[(tx + 16 * j) * TL::B_LD + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  float cs[8] = {};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = store<BWD, GRAD>(a, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
      if constexpr (BWD) cs[j] += v;
    }
  if (BWD && a.col_sums != nullptr) {
    float* red = reinterpret_cast<float*>(dsmem);  // [16][BN]
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) red[ty * BN + tx + 16 * j] = cs[j];
    __syncthreads();
    if (tid < BN && n0 + tid < a.n_out) {
      float c = 0.f;
      for (int r = 0; r < 16; ++r) c += red[r * BN + tid];
      a.col_sums[static_cast<size_t>(blockIdx.y) * a.n_out + n0 + tid] = c;
    }
  }
  if (a_sums && tid < BM && m0 + tid < a.M)
    a.a_sums[static_cast<size_t>(blockIdx.z) * a.M + m0 + tid] = a_sum;
}

template <bool A_KM, bool B_KN, bool GRAD>
int launch_gemm(const GemmArgs& a, int splits, cudaStream_t stream) {
  using TL = Tile<A_KM, B_KN>;
  const auto kernel = gemm_kernel<A_KM, B_KN, GRAD>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(TL::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.n_out + BN - 1) / BN, (a.M + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, TL::SMEM_BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The four compiled fp32 variants: eval and forward, the training fc1
// (GELU' out), the backward's dY . W, and the weight gradient.
int launch_gemm_f32(const GemmArgs& a, bool a_km, bool b_kn, int splits, cudaStream_t s) {
  if (a_km) return launch_gemm<true, true, false>(a, splits, s);
  if (b_kn) return launch_gemm<false, true, false>(a, splits, s);
  if (a.gelu_grad != nullptr) return launch_gemm<false, false, true>(a, splits, s);
  return launch_gemm<false, false, false>(a, splits, s);
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

template <typename T>
int launch_layer_norm_bwd(const void* x, const float* dln, int M, int K, const void* w, float eps,
                          void* dx, float* part, int blocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * LN_WARPS * 2 * K;
  const cudaError_t err = cudaFuncSetAttribute(
      layer_norm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  layer_norm_bwd_kernel<T><<<blocks, LN_THREADS, smem, stream>>>(
      static_cast<const T*>(x), dln, M, K, static_cast<const T*>(w), eps, static_cast<T*>(dx),
      part);
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
// type of x, w, dx; dln and part are fp32, part [blocks][2][K]. K must be
// a multiple of 8 and at most 1024; the caller checks the rest.
extern "C" int tr_layer_norm_bwd(int dtype, const void* x, const void* dln, int M, int K,
                                 const void* w, float eps, void* dx, void* part, int blocks,
                                 void* stream) {
  using namespace trk;
  if (M == 0) return 0;
  if (K % 8 != 0 || K > LN_CHUNKS * 256 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dln);
  float* p = static_cast<float*>(part);
  if (dtype == kFloat32) return launch_layer_norm_bwd<float>(x, d, M, K, w, eps, dx, p, blocks, s);
  if (dtype == kBFloat16)
    return launch_layer_norm_bwd<__nv_bfloat16>(x, d, M, K, w, eps, dx, p, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Returns the cudaError_t of the launch (0 on success). `dtype` is the
// type of x, w and bias; res_dtype and y_dtype those of the residual and
// y: `dtype` or, with bf16 operands, float32. w is [n_out, K], or [K,
// n_out] with w_kn. gelu_grad (with gelu, w not w_kn), mul and col_sums
// ([ceil(M / 128)][n_out], both with w_kn) are fp32 or null; idx
// (residual rows) may be null. K and n_out must be multiples of 8; the
// caller checks shapes, dtypes, contiguity and 16-byte alignment.
extern "C" int tr_gemm(int dtype, const void* x, int M, int K, const void* w, int w_kn,
                       const void* bias, int n_out, int gelu, void* gelu_grad, const void* mul,
                       int res_dtype, const void* res, const void* idx, int rows_out,
                       int rows_in, int y_dtype, void* y, void* col_sums, void* stream) {
  using namespace trk;
  if (M == 0) return 0;
  auto takes = [&](int t) { return t == dtype || t == kFloat32; };
  if (K % 8 != 0 || n_out % 8 != 0 || (dtype != kFloat32 && dtype != kBFloat16) ||
      !takes(y_dtype) || (res != nullptr && !takes(res_dtype)) ||
      (gelu_grad != nullptr && (!gelu || w_kn)) || (mul != nullptr && !w_kn) ||
      (col_sums != nullptr && !w_kn))
    return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs a{};
  a.x = x, a.M = M, a.K = K, a.w = w, a.bias = bias, a.n_out = n_out, a.gelu = gelu;
  a.gelu_grad = static_cast<float*>(gelu_grad), a.mul = static_cast<const float*>(mul);
  a.res = res, a.res_f32 = res_dtype == kFloat32, a.idx = static_cast<const int*>(idx);
  a.rows_out = rows_out, a.rows_in = rows_in, a.y = y, a.y_f32 = y_dtype == kFloat32;
  a.col_sums = static_cast<float*>(col_sums);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_gemm_f32(a, false, w_kn != 0, 1, s);
  return launch_gemm_sm90(a, false, w_kn != 0, 1, s);
}

// The partial weight gradients of one linear layer: ws[z] = dY^T X over
// rows [z * rows_per_split, (z + 1) * rows_per_split) for z < splits, fp32
// [splits][n_out][K]; bias_ws (or null) [splits][n_out] the partial column
// sums of dY. dy [rows, n_out] and x [rows, K] share `dtype`;
// rows_per_split is a multiple of 32 (fp32) or of 64 (bf16: the K step of
// gemm_sm90.cu). Returns the cudaError_t of the launch.
extern "C" int tr_gemm_wgrad(int dtype, const void* dy, const void* x, int rows, int n_out,
                             int K, int splits, int rows_per_split, void* ws, void* bias_ws,
                             void* stream) {
  using namespace trk;
  if (n_out == 0 || K == 0) return 0;
  if (K % 8 != 0 || n_out % 8 != 0 || splits < 1 || rows_per_split % BK != 0 ||
      static_cast<long long>(splits) * rows_per_split < rows ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  GemmArgs a{};
  a.x = dy, a.M = n_out, a.K = rows, a.w = x, a.n_out = K;
  a.y = ws, a.y_f32 = 1, a.k_split = rows_per_split, a.a_sums = static_cast<float*>(bias_ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_gemm_f32(a, true, true, splits, s);
  return launch_gemm_sm90(a, true, true, splits, s);
}

// out[i] = sum over z < S of part[z][i] in order, for i < L, written in
// out_dtype. Returns the cudaError_t of the launch.
extern "C" int tr_sum_partials(const void* part, int S, int L, int out_dtype, void* out,
                               void* stream) {
  using namespace trk;
  if (L == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = L < 1024 * 256 ? (L + 255) / 256 : 1024;
  const float* p = static_cast<const float*>(part);
  if (out_dtype == kFloat32)
    sum_partials_kernel<float><<<blocks, 256, 0, s>>>(p, S, L, static_cast<float*>(out));
  else if (out_dtype == kBFloat16)
    sum_partials_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(p, S, L,
                                                             static_cast<__nv_bfloat16*>(out));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
