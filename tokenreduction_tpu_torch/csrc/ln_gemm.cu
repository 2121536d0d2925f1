// The matrix-product half of every kernel counterpart in ops/, as two
// kernels:
//
//   layer_norm: Y[M, K] = LN(X[src(m)]) over the K columns of each row in
//               fp32 (two-pass statistics), rounded to the operand type;
//               src(m) gathers output row m of image b from X row
//               b * rows_in + idx[m] when idx is given. X is the operand
//               type or fp32. One warp per row.
//   gemm:       Y[M, n_out] = epi( X[M, K] . W^T + bias )
//               epi: optional exact-erf GELU, then an optional residual add
//               whose row can be gathered through idx in the same way;
//               accumulation in fp32.
//
// W is in nn.Linear's [n_out, K] layout, so both operands are K-contiguous.
// bf16 operands go through mma.sync.m16n8k16 (fragments by ldmatrix) with
// fp32 accumulators; fp32 operands through FMA in true fp32 on the CUDA
// cores. With bf16 operands the residual and Y may also be fp32: the whole
// block keeps its residual stream y in fp32 between its halves, as the TPU
// kernel does, so its proj GEMM writes fp32 y, LN2 reads it, and the fc2
// GEMM adds it.
//
// Why LayerNorm is a launch of its own: applied to each staged slice of X
// inside the GEMM, it was redone for every column tile and cost the fc1
// product at DeiT-S width about a third of its time; written once, the
// normalised rows cost one round trip of [M, K] in the operand type.
//
// The GEMM computes a 128x128 output tile per block over 32-deep K slices,
// copied by cp.async into a ring of three shared-memory stages, so two
// slices are in flight while one multiplies. A first version. At the
// widths of DeiT-S (K = 384 or 1536) the products are small: with only 12
// K slices per tile at K = 384, each tile's pipeline fill and epilogue
// weigh about as much as its tensor-core work. wgmma, TMA, persistent
// tiles and keeping the MLP hidden tensor on chip are later work.
#include <stdint.h>

#include "common.cuh"

namespace trk {
namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int STAGES = 3;  // K slices in the cp.async ring
constexpr int LN_THREADS = 256;

// Row b * rows_in + idx[m] of a gathered tensor for output row m; an id
// outside the image's rows faults the launch, as torch.gather's
// device-side check does, instead of reading another image's rows.
__device__ __forceinline__ int gathered_row(const int* idx, int m, int rows_out, int rows_in) {
  const int i = idx[m];
  if (static_cast<unsigned>(i) >= static_cast<unsigned>(rows_in)) __trap();
  return (m / rows_out) * rows_in + i;
}

// Eight neighbouring elements (16-byte aligned) to and from fp32.
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

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

struct GemmArgs {
  const void* x;      // [M, K]
  int M;
  int K;
  const void* w;      // [n_out, K]
  const void* bias;   // [n_out], or null
  int n_out;
  int gelu;
  const void* res;    // [*, n_out] residual, or null; fp32 when res_f32
  int res_f32;
  const int* idx;     // [M] residual row ids within an image, or null
  int rows_out;       // rows of Y per image (gathered residual)
  int rows_in;        // rows of res per image (gathered residual)
  void* y;            // [M, n_out], fp32 when y_f32
  int y_f32;
};

__device__ __forceinline__ size_t res_row(const GemmArgs& a, int row) {
  return a.idx != nullptr ? gathered_row(a.idx, row, a.rows_out, a.rows_in) : row;
}

// Staged tiles: STAGES K slices of A [BM][LD] and B [BN][LD] in dynamic
// shared memory. Rows of 80 bytes (bf16) keep ldmatrix conflict-free;
// every row is 16-byte aligned for cp.async.
template <typename T> struct Tile {
  static constexpr int LD = BK + 16 / sizeof(T);
  static constexpr int V = 16 / sizeof(T);          // elements per 16-byte copy
  static constexpr int CPR = BK / V;                // 16-byte chunks per tile row
  static constexpr int A_CHUNKS = BM * CPR / THREADS;
  static constexpr int B_CHUNKS = BN * CPR / THREADS;
  static constexpr int STAGE_ELEMS = (BM + BN) * LD;
  static constexpr size_t SMEM_BYTES = sizeof(T) * STAGES * STAGE_ELEMS;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// Start the copies of the K slice at k0 into stage buffer `buf`; rows
// past M and columns past n_out or K are zero-filled.
template <typename T>
__device__ __forceinline__ void load_slice(const GemmArgs& a, T* tiles, int buf, int m0,
                                           int n0, int k0) {
  using TL = Tile<T>;
  T* A = tiles + buf * TL::STAGE_ELEMS;
  T* B = A + BM * TL::LD;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
#pragma unroll
  for (int c = 0; c < TL::A_CHUNKS; ++c) {
    const int chunk = threadIdx.x + c * THREADS;
    const int r = chunk / TL::CPR, kc = (chunk % TL::CPR) * TL::V, k = k0 + kc;
    const bool in = m0 + r < a.M && k < a.K;
    cp_async16(A + r * TL::LD + kc, in ? x + static_cast<size_t>(m0 + r) * a.K + k : x, in);
  }
#pragma unroll
  for (int c = 0; c < TL::B_CHUNKS; ++c) {
    const int chunk = threadIdx.x + c * THREADS;
    const int n = chunk / TL::CPR, kc = (chunk % TL::CPR) * TL::V, k = k0 + kc;
    const bool in = n0 + n < a.n_out && k < a.K;
    cp_async16(B + n * TL::LD + kc, in ? w + static_cast<size_t>(n0 + n) * a.K + k : w, in);
  }
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// The fp32 epilogue of one element.
__device__ __forceinline__ void store(const GemmArgs& a, int row, int col, float acc) {
  if (row >= a.M || col >= a.n_out) return;
  float v = acc;
  if (a.bias) v += static_cast<const float*>(a.bias)[col];
  if (a.gelu) v = gelu(v);
  if (a.res) v += static_cast<const float*>(a.res)[res_row(a, row) * a.n_out + col];
  static_cast<float*>(a.y)[static_cast<size_t>(row) * a.n_out + col] = v;
}

// The bf16 epilogue of two neighbouring columns (col even, n_out % 8 == 0);
// the residual and Y may be fp32.
__device__ __forceinline__ void store_pair(const GemmArgs& a, int row, int col, float v0,
                                           float v1) {
  if (row >= a.M || col >= a.n_out) return;
  using P = __nv_bfloat162;
  if (a.bias) {
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const P*>(static_cast<const __nv_bfloat16*>(a.bias) + col));
    v0 += b.x;
    v1 += b.y;
  }
  if (a.gelu) {
    v0 = gelu(v0);
    v1 = gelu(v1);
  }
  if (a.res) {
    const size_t at = res_row(a, row) * a.n_out + col;
    const float2 rv =
        a.res_f32 ? *reinterpret_cast<const float2*>(static_cast<const float*>(a.res) + at)
                  : __bfloat1622float2(
                        *reinterpret_cast<const P*>(static_cast<const __nv_bfloat16*>(a.res) + at));
    v0 += rv.x;
    v1 += rv.y;
  }
  const size_t at = static_cast<size_t>(row) * a.n_out + col;
  if (a.y_f32)
    *reinterpret_cast<float2*>(static_cast<float*>(a.y) + at) = make_float2(v0, v1);
  else
    *reinterpret_cast<P*>(static_cast<__nv_bfloat16*>(a.y) + at) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem_ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16x8x16(float* d, const uint32_t* a,
                                                 const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) gemm_kernel(GemmArgs a) {
  using TL = Tile<T>;
  extern __shared__ __align__(16) unsigned char dsmem[];
  T* tiles = reinterpret_cast<T*>(dsmem);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // K loop over a ring of STAGES slices: slice i multiplies while the
  // copies of slices i+1 .. i+STAGES-1 are in flight. One commit group
  // per slice (empty past K) keeps the wait count uniform.
  auto k_loop = [&](auto&& multiply) {
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st * BK < a.K) load_slice<T>(a, tiles, st, m0, n0, st * BK);
      cp_async_commit();
    }
    for (int i = 0, k0 = 0; k0 < a.K; ++i, k0 += BK) {
      const int buf = i % STAGES;
      cp_async_wait_all_but_newest();
      __syncthreads();  // slice i visible; slice i-1's buffer free
      const int kn = k0 + (STAGES - 1) * BK;
      if (kn < a.K) load_slice<T>(a, tiles, (i + STAGES - 1) % STAGES, m0, n0, kn);
      cp_async_commit();
      multiply(tiles + buf * TL::STAGE_ELEMS, tiles + buf * TL::STAGE_ELEMS + BM * TL::LD);
    }
  };

  if constexpr (sizeof(T) == 2) {
    // 2x4 warps, each a 64x32 sub-tile of 4x4 mma tiles (16x8).
    float acc[4][4][4] = {};
    const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
    const int g = lane >> 2, t = lane & 3;
    k_loop([&](const T* A, const T* B) {
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4(af[mt], A + (wm + mt * 16 + (lane & 15)) * TL::LD + ks + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r4[4];
          ldmatrix_x4(r4, B + (wn + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * TL::LD + ks +
                              ((lane >> 3) & 1) * 8);
          bf[2 * np][0] = r4[0];
          bf[2 * np][1] = r4[1];
          bf[2 * np + 1][0] = r4[2];
          bf[2 * np + 1][1] = r4[3];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16_16x8x16(acc[mt][nt], af[mt], bf[nt]);
      }
    });
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int row = m0 + wm + mt * 16 + g, col = n0 + wn + nt * 8 + 2 * t;
        store_pair(a, row, col, acc[mt][nt][0], acc[mt][nt][1]);
        store_pair(a, row + 8, col, acc[mt][nt][2], acc[mt][nt][3]);
      }
  } else {
    // 16x16 threads, each an 8x8 micro-tile strided over the 128x128 tile.
    float acc[8][8] = {};
    const int ty = tid >> 4, tx = tid & 15;
    k_loop([&](const T* A, const T* B) {
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = A[(ty + 16 * i) * TL::LD + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = B[(tx + 16 * j) * TL::LD + kk];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    });
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) store(a, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
  }
}

template <typename T>
int launch_gemm(const GemmArgs& a, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Tile<T>::SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.n_out + BN - 1) / BN, (a.M + BM - 1) / BM);
  gemm_kernel<T><<<grid, THREADS, Tile<T>::SMEM_BYTES, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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
// type of x, w and bias; res_dtype and y_dtype those of the residual and
// y: `dtype` or, with bf16 operands, float32. idx (residual rows) may be
// null. K and n_out must be multiples of 8; the caller checks shapes,
// dtypes, contiguity and 16-byte alignment.
extern "C" int tr_gemm(int dtype, const void* x, int M, int K, const void* w, const void* bias,
                       int n_out, int gelu, int res_dtype, const void* res, const void* idx,
                       int rows_out, int rows_in, int y_dtype, void* y, void* stream) {
  using namespace trk;
  if (M == 0) return 0;
  auto takes = [&](int t) { return t == dtype || t == kFloat32; };
  if (K % 8 != 0 || n_out % 8 != 0 || (dtype != kFloat32 && dtype != kBFloat16) ||
      !takes(y_dtype) || (res != nullptr && !takes(res_dtype)))
    return static_cast<int>(cudaErrorInvalidValue);
  const GemmArgs a{x,     M,        K,
                   w,     bias,     n_out,
                   gelu,  res,      res_dtype == kFloat32,
                   static_cast<const int*>(idx),
                   rows_out, rows_in,
                   y,     y_dtype == kFloat32};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch_gemm<float>(a, s);
  return launch_gemm<__nv_bfloat16>(a, s);
}
