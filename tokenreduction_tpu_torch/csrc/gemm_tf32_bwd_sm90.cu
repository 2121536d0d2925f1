// The fp32 GEMM of the backward's two layouts, for Hopper (sm_90a), in
// 3xTF32 on the tensor cores (gemm_tf32_sm90.cu's arithmetic):
//
//   dY . W:  Y[M, n_out] = epi(dY[M, K] . W[K, n_out]), W the nn.Linear
//            weight read as stored (B is MN-major: no transposed copy is
//            made in device memory). epi: optional bias, exact-erf GELU,
//            fp32 factor (GELU' of the forward's pre-activation) and fp32
//            residual (rows gathered through idx), in that order, and
//            optional per-128-row-tile column sums of the fp32 result (a
//            bias gradient before rounding).
//   wgrad:   the partial dW[n_out, K] = dY^T X over one slice of the rows
//            per split, fp32 partials [splits][n_out][K], and the slice's
//            column sums of dY (the bias gradient) from the tiles of the
//            first column tile; A = dY and B = X are both MN-major.
//
// ln_gemm.cu's tr_gemm (with w_kn) and tr_gemm_wgrad call it for every
// fp32 launch of these layouts: only the fp32 training backward launches
// them. It replaces the fp32 MXU dots of the backward kernels of
// tokenreduction_tpu/ops/fused_block_train.py attend_branch_train and
// ops/fused_mlp_train.py mlp_branch (dY . W, and the weight gradients they
// accumulate across their sequential grid in VMEM).
//
// What bounds it: operations. The eight products of a DeiT-S block's
// backward at B = 256 (M = 50,432) are 357 GFLOP, 1,071 in 3xTF32: 2.165 ms
// at the H100's 494.7 TFLOP/s of dense TF32.
//
// Design: gemm_tf32_sm90.cu's tile (128 x 128, K steps of BK = 32, two
// consumer warpgroups of 64 rows on m64n128k8 wgmmas, a K step's twelve
// products into a partial from zero, small ones first, added with rounding
// to nearest), persistent grid and fixed tile order (split, row tile,
// column tile). TF32 wgmma reads K-major operands only, so an MN-major
// operand is transposed where it is split, in shared memory:
//   - TMA lands each K step in a raw ring: an MN-major operand as one box
//     of BK k rows x 128 (unswizzled, 512-byte rows), dY of dY . W as the
//     forward lands it (K-major, 128-byte swizzle);
//   - warpgroup 0, the converters: thread r owns row r of both operands'
//     split tiles. From an MN-major box it reads column r, four k rows a
//     16-byte chunk (a warp reads 32 neighbouring words a k row), and
//     writes the chunk's hi = tf32(x) and lo = tf32(x - hi) into row r of
//     the K-major split tiles with the 128-byte swizzle (chunk c at
//     c ^ (r % 8): a phase of 8 lanes writes 8 distinct bank groups), so
//     neither side conflicts on banks; a K-major box keeps its chunks'
//     places. A K step's split tiles (A hi, B hi, A lo, B lo: 64 KB) go to
//     a split ring for the consumers (proxy fence, ready barrier). Once
//     all 128 have read a raw stage (a named barrier), thread 0 issues
//     the loads of the K step RAW_STAGES ahead into it. For the weight
//     gradient, thread r also sums its column of dY (row r of A) over the
//     slice, each K step's 32 rows in order and then the steps in order,
//     and writes it for the tiles of the first column tile;
//   - warpgroups 1 and 2, the consumers, as the forward's; the epilogue
//     stores from the accumulators (pairs of neighbouring columns). dY .
//     W's factor (fc2's GELU', a read of as many bytes as Y's write) is
//     read in two batches of 16 loads a thread, its rows prefetched into L2
//     by the converters as the tile starts. Its column sums go over a
//     warp's 16 rows by shuffles and over the 8 consumer warps through
//     4 KB of shared memory, in a fixed order. Nothing uses atomics: two
//     launches give the same bits.
// Shared memory: two split stages (128 KB) and a raw ring of two stages
// for dY . W, beside the column sums' 4 KB, or three for the weight
// gradient (both MN-major boxes wait there), held to 227 KB below. A
// split ring's two stages let the converters write one K step while the
// consumers read the other; a raw stage is free as soon as it is split.
#include <stdint.h>

#include "common.cuh"
#include "gemm.cuh"
#include "gemm_tf32.cuh"
#include "sm90.cuh"

namespace trk {
namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;  // one 128-byte swizzled row of fp32
constexpr int CONSUMERS = 2;  // warpgroups of 64 rows
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int TILE_BYTES = BM * BK * 4;  // one operand's K step (BN == BM)
constexpr int RAW_BYTES = 2 * TILE_BYTES;  // A and B as TMA lands them
constexpr int LO = 2 * TILE_BYTES;  // from a hi part to its lo part
constexpr int SPLIT_BYTES = 4 * TILE_BYTES;  // A hi, B hi, A lo, B lo
constexpr int SPLIT_STAGES = 2;
static_assert(BN == BM && BM == 128 && BN / 2 == TF32_ACC && BK == 32,
              "a converter thread a row, and gemm_tf32.cuh's wgmma and K step");

enum Layout { kDyW = 0, kWgrad = 1 };

template <int L> struct Plan {
  static constexpr int RAW_STAGES = L == kWgrad ? 3 : 2;
  static constexpr int RED_BYTES = L == kDyW ? 4 * CONSUMERS * BN * 4 : 0;  // column sums
  static constexpr int SMEM_BYTES = 1024 + SPLIT_STAGES * SPLIT_BYTES + RAW_STAGES * RAW_BYTES +
                                    RED_BYTES + 8 * (RAW_STAGES + 2 * SPLIT_STAGES);
  static_assert(SMEM_BYTES <= 232448, "over the H100's 227 KB of shared memory a block");
};

// The output tiles, walked in one fixed order: split, then row tile, then
// column tile.
struct Tiles {
  int m_tiles, n_tiles, splits, k_split, K;
  __device__ __forceinline__ int count() const { return splits * m_tiles * n_tiles; }
  __device__ __forceinline__ void at(int t, int& m0, int& n0, int& z, int& k0, int& k1) const {
    const int per = m_tiles * n_tiles;
    z = t / per;
    t -= z * per;
    m0 = (t / n_tiles) * BM;
    n0 = (t % n_tiles) * BN;
    k0 = z * k_split;
    k1 = min(K, k0 + k_split);
  }
};

// The loads' place in the block's sequence of (tile, K step).
struct Cursor {
  int t, m0, n0, k, k1;
  // the first K step from tile t on (a slice past the rows has none)
  __device__ __forceinline__ void settle(const Tiles& tiles) {
    for (; t < tiles.count(); t += gridDim.x) {
      int z;
      tiles.at(t, m0, n0, z, k, k1);
      if (k < k1) return;
    }
  }
  __device__ __forceinline__ bool valid(const Tiles& tiles) const { return t < tiles.count(); }
  __device__ __forceinline__ void next(const Tiles& tiles) {
    k += BK;
    if (k >= k1) {
      t += gridDim.x;
      settle(tiles);
    }
  }
};

// The loads of the cursor's K step into the raw stage at `raw`: A then B.
template <bool A_MN>
__device__ __forceinline__ void load_step(const CUtensorMap* map_a, const CUtensorMap* map_b,
                                          uint32_t raw, uint32_t full, const Cursor& c) {
  mbar_expect_tx(full, RAW_BYTES);
  if (A_MN)
    tma_load(raw, map_a, full, c.m0, c.k);
  else
    tma_load(raw, map_a, full, c.k, c.m0);
  tma_load(raw + TILE_BYTES, map_b, full, c.n0, c.k);
}

// hi = tf32(x) and lo = tf32(x - hi) of a 16-byte chunk of four k values,
// to `at` in a split tile and to its lo part.
__device__ __forceinline__ void put_split(uint8_t* at, float x0, float x1, float x2, float x3) {
  uint32_t h[4], l[4];
  split_tf32(x0, h[0], l[0]);
  split_tf32(x1, h[1], l[1]);
  split_tf32(x2, h[2], l[2]);
  split_tf32(x3, h[3], l[3]);
  *reinterpret_cast<uint4*>(at) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(at + LO) = make_uint4(l[0], l[1], l[2], l[3]);
}

// Row r of a split tile (K-major, 128-byte rows, 16-byte chunk c at
// c ^ (r % 8)) from column r of an MN-major raw box [BK][128]; returns the
// column's sum over the K step, in row order.
__device__ __forceinline__ float split_transposed(const float* raw, uint8_t* split, int r) {
  const float* col = raw + r;
  uint8_t* row = split + r * 128;
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < BK / 4; ++c) {
    const float x0 = col[(4 * c) * BM], x1 = col[(4 * c + 1) * BM];
    const float x2 = col[(4 * c + 2) * BM], x3 = col[(4 * c + 3) * BM];
    sum += x0;
    sum += x1;
    sum += x2;
    sum += x3;
    put_split(row + ((c ^ (r & 7)) << 4), x0, x1, x2, x3);
  }
  return sum;
}

// Row r of a split tile from a K-major raw box with the same swizzle (dY
// of dY . W): the chunks keep their places.
__device__ __forceinline__ void split_in_place(const uint8_t* raw, uint8_t* split, int r) {
#pragma unroll
  for (int c = 0; c < BK / 4; ++c) {
    const int at = r * 128 + ((c ^ (r & 7)) << 4);
    const float4 x = *reinterpret_cast<const float4*>(raw + at);
    put_split(split + at, x.x, x.y, x.z, x.w);
  }
}

template <int L>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_tf32_bwd_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                              const __grid_constant__ CUtensorMap map_b, GemmArgs a, int splits) {
  using P = Plan<L>;
  constexpr bool WGRAD = L == kWgrad;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the stages to it
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  uint8_t* split_smem = smem_raw + (base - raw_addr);
  uint8_t* raw_smem = split_smem + SPLIT_STAGES * SPLIT_BYTES;
  float* red = reinterpret_cast<float*>(raw_smem + P::RAW_STAGES * RAW_BYTES);  // [8][BN]
  const uint32_t raw0 = base + SPLIT_STAGES * SPLIT_BYTES;
  const uint32_t full0 = raw0 + P::RAW_STAGES * RAW_BYTES + P::RED_BYTES;  // a raw stage landed
  const uint32_t ready0 = full0 + 8 * P::RAW_STAGES;  // a split stage written
  const uint32_t empty0 = ready0 + 8 * SPLIT_STAGES;  // a split stage read
  const Tiles tiles{(a.M + BM - 1) / BM, (a.n_out + BN - 1) / BN, splits,
                    a.k_split ? a.k_split : a.K, a.K};
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::RAW_STAGES; ++s) mbar_init(full0 + 8 * s, 1);
    for (int s = 0; s < SPLIT_STAGES; ++s) {
      mbar_init(ready0 + 8 * s, 4);  // one arrival per converter warp
      mbar_init(empty0 + 8 * s, 4 * CONSUMERS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  if (wg == 0) {
    // the converters; thread 0 also issues every load, in the same order
    const int r = threadIdx.x;  // this thread's row of each split tile
    Cursor load{static_cast<int>(blockIdx.x)};
    if (r == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      load.settle(tiles);
      for (int s = 0; s < P::RAW_STAGES && load.valid(tiles); ++s, load.next(tiles))
        load_step<WGRAD>(&map_a, &map_b, raw0 + s * RAW_BYTES, full0 + 8 * s, load);
    }
    int rs = 0, ss = 0;
    uint32_t rphase = 0, sphase = 0;
    for (int t = blockIdx.x; t < tiles.count(); t += gridDim.x) {
      int m0, n0, z, k0, k1;
      tiles.at(t, m0, n0, z, k0, k1);
      float a_sum = 0.f;
      if (!WGRAD && a.mul != nullptr && m0 + r < a.M) {
        // the epilogue's factor, row r of the tile, into L2 while the
        // tile's products run
        const float* row = a.mul + static_cast<size_t>(m0 + r) * a.n_out + n0;
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(row),
                     "r"(min(BN, a.n_out - n0) * 4)
                     : "memory");
      }
      for (int k = k0; k < k1; k += BK) {
        mbar_wait(full0 + 8 * rs, rphase);
        mbar_wait(empty0 + 8 * ss, sphase ^ 1);
        const uint8_t* raw = raw_smem + rs * RAW_BYTES;
        uint8_t* split = split_smem + ss * SPLIT_BYTES;
        if constexpr (WGRAD)
          a_sum += split_transposed(reinterpret_cast<const float*>(raw), split, r);
        else
          split_in_place(raw, split, r);
        split_transposed(reinterpret_cast<const float*>(raw + TILE_BYTES), split + TILE_BYTES, r);
        fence_async_smem();  // the wgmmas read the split tiles through the async proxy
        __syncwarp();
        if (lane == 0) mbar_arrive(ready0 + 8 * ss);
        // every converter has read the raw stage: refill it
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        if (r == 0 && load.valid(tiles)) {
          load_step<WGRAD>(&map_a, &map_b, raw0 + rs * RAW_BYTES, full0 + 8 * rs, load);
          load.next(tiles);
        }
        if (++rs == P::RAW_STAGES) rs = 0, rphase ^= 1;
        if (++ss == SPLIT_STAGES) ss = 0, sphase ^= 1;
      }
      if (WGRAD && a.a_sums != nullptr && n0 == 0 && m0 + r < a.M)
        a.a_sums[static_cast<size_t>(z) * a.M + m0 + r] = a_sum;
    }
    return;
  }

  // consumers: warpgroup cw owns rows cw * 64 .. + 63 of each tile
  const int cw = wg - 1;
  const int warp = (threadIdx.x & 127) >> 5, g = lane >> 2, tq = lane & 3;
  const uint32_t a_off = cw * (64 * 128);  // the warpgroup's 64 rows of A
  int ss = 0;
  uint32_t sphase = 0;
  float d[TF32_ACC], p[TF32_ACC];
  for (int t = blockIdx.x; t < tiles.count(); t += gridDim.x) {
    int m0, n0, z, k0, k1;
    tiles.at(t, m0, n0, z, k0, k1);
#pragma unroll
    for (int i = 0; i < TF32_ACC; ++i) d[i] = 0.f;
    for (int k = k0; k < k1; k += BK) {
      mbar_wait(ready0 + 8 * ss, sphase);
      const uint32_t sa = base + ss * SPLIT_BYTES;
      k_step_3xtf32(p, sa + a_off, sa + TILE_BYTES, LO);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * ss);  // the stage is read
#pragma unroll
      for (int i = 0; i < TF32_ACC; ++i) d[i] += p[i];
      if (++ss == SPLIT_STAGES) ss = 0, sphase ^= 1;
    }

    // the epilogue: d[4 j + 2 r + e] is row g + 8 r of the warp's 16,
    // column 8 j + 2 tq + e
    const int row_a = m0 + cw * 64 + warp * 16 + g;
    if constexpr (WGRAD) {
      float* y = static_cast<float*>(a.y) + static_cast<size_t>(z) * a.M * a.n_out;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * tq;
        if (col >= a.n_out) continue;  // n_out % 8 == 0: col + 1 is in too
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row_a + 8 * r;
          if (row < a.M)
            *reinterpret_cast<float2*>(y + static_cast<size_t>(row) * a.n_out + col) =
                make_float2(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
        }
      }
    } else {
      const float* bias = static_cast<const float*>(a.bias);
      const float* res = static_cast<const float*>(a.res);
      float* y = static_cast<float*>(a.y);
      float cs[BN / 4];  // the thread's columns summed over its two rows
      // in two halves of the columns: each half's factors (their rows
      // prefetched into L2 by the converters) are loaded before any of its
      // stores; with no factor, 1
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float2 fac[BN / 16][2];
#pragma unroll
        for (int jj = 0; jj < BN / 16; ++jj)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int col = n0 + 8 * (half * (BN / 16) + jj) + 2 * tq, row = row_a + 8 * r;
            fac[jj][r] = a.mul != nullptr && col < a.n_out && row < a.M
                             ? *reinterpret_cast<const float2*>(
                                   a.mul + static_cast<size_t>(row) * a.n_out + col)
                             : make_float2(1.f, 1.f);
          }
#pragma unroll
        for (int jj = 0; jj < BN / 16; ++jj) {
          const int j = half * (BN / 16) + jj, col = n0 + 8 * j + 2 * tq;
          cs[2 * j] = cs[2 * j + 1] = 0.f;
          if (col >= a.n_out) continue;
          const float2 bb =
              bias ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.f, 0.f);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row_a + 8 * r;
            if (row >= a.M) continue;
            const size_t at = static_cast<size_t>(row) * a.n_out + col;
            float x0 = d[4 * j + 2 * r] + bb.x, x1 = d[4 * j + 2 * r + 1] + bb.y;
            if (a.gelu) x0 = gelu(x0), x1 = gelu(x1);
            x0 *= fac[jj][r].x, x1 *= fac[jj][r].y;
            if (res) {
              const float2 rr =
                  *reinterpret_cast<const float2*>(res + res_row(a, row) * a.n_out + col);
              x0 += rr.x, x1 += rr.y;
            }
            *reinterpret_cast<float2*>(y + at) = make_float2(x0, x1);
            cs[2 * j] += x0;
            cs[2 * j + 1] += x1;
          }
        }
      }
      if (a.col_sums != nullptr) {
        // over the warp's 8 row pairs (lanes 4 apart), then the 8 warps in order
#pragma unroll
        for (int i = 0; i < BN / 4; ++i) {
          cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 4);
          cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 8);
          cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], 16);
        }
        if (g == 0) {
          float* mine = red + (cw * 4 + warp) * BN + 2 * tq;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            *reinterpret_cast<float2*>(mine + 8 * j) = make_float2(cs[2 * j], cs[2 * j + 1]);
        }
        asm volatile("bar.sync 2, 256;\n" ::: "memory");
        const int c = threadIdx.x - 128;
        if (c < BN && n0 + c < a.n_out) {
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < 4 * CONSUMERS; ++w) s += red[w * BN + c];
          a.col_sums[static_cast<size_t>(m0 / BM) * a.n_out + n0 + c] = s;
        }
        asm volatile("bar.sync 2, 256;\n" ::: "memory");  // red is free for the next tile
      }
    }
  }
}

template <int L>
int launch(const GemmArgs& a, int splits, cudaStream_t stream) {
  using P = Plan<L>;
  const auto kernel = gemm_tf32_bwd_sm90_kernel<L>;
  // first: the context the tensor maps need (sm90.cuh encoder)
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_a, map_b;
  // A: dY [M, K] in swizzled boxes of BM rows x BK, or the weight
  // gradient's dY [K, M] in boxes of BK rows x BM; B: [K, n_out] in boxes
  // of BK rows x BN
  err = L == kWgrad
            ? tensor_map_f32(&map_a, a.x, a.K, a.M, BK, BM, CU_TENSOR_MAP_SWIZZLE_NONE)
            : tensor_map_f32(&map_a, a.x, a.M, a.K, BM, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map_f32(&map_b, a.w, a.K, a.n_out, BK, BN, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long count =
      static_cast<long long>(splits) * ((a.M + BM - 1) / BM) * ((a.n_out + BN - 1) / BN);
  const int grid = static_cast<int>(count < sms ? count : sms);
  kernel<<<grid, THREADS, P::SMEM_BYTES, stream>>>(map_a, map_b, a, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

int launch_gemm_tf32_bwd_sm90(const GemmArgs& a, bool wgrad, int splits, cudaStream_t stream) {
  if (a.M == 0 || a.n_out == 0) return 0;
  const bool epi = a.bias || a.gelu || a.mul || a.res || a.col_sums;
  if (!a.y_f32 || a.gelu_grad != nullptr || (a.res != nullptr && !a.res_f32) ||
      a.k_split % BK != 0 || splits < 1 ||
      (wgrad ? epi : (a.k_split != 0 || a.a_sums != nullptr || splits != 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  return wgrad ? launch<kWgrad>(a, splits, stream) : launch<kDyW>(a, 1, stream);
}

}  // namespace trk

// The kernel's tile, rings and dynamic shared memory a block, for the
// host: out[8] = {BM, BN, BK, SPLIT_STAGES, the raw stages of dY . W and
// of the weight gradient, their SMEM_BYTES}.
extern "C" int tr_gemm_tf32_bwd_config(int* out) {
  using namespace trk;
  const int config[8] = {BM, BN, BK, SPLIT_STAGES, Plan<kDyW>::RAW_STAGES,
                         Plan<kWgrad>::RAW_STAGES, Plan<kDyW>::SMEM_BYTES,
                         Plan<kWgrad>::SMEM_BYTES};
  for (int i = 0; i < 8; ++i) out[i] = config[i];
  return 0;
}
