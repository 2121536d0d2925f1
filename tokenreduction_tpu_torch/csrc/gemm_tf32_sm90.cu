// The fp32 GEMM of the forward layout, for Hopper (sm_90a), in 3xTF32 on
// the tensor cores: Y[M, n_out] = epi(X[M, K] . W^T + bias), W in
// nn.Linear's [n_out, K] layout, fp32 operands, bias, residual and Y. epi:
// optional exact-erf GELU (with GELU' of the pre-activation written out
// when asked: the training forward's fc1), then an optional fp32 residual
// whose rows may be gathered through idx. ln_gemm.cu's tr_gemm calls it
// for every fp32 launch of that layout, eval and training forward; the
// fp32 layouts of the backward (dY . W, the weight gradient) run
// gemm_tf32_bwd_sm90.cu, the same design with the operands transposed as
// they are split.
//
// It replaces the fp32 matrix products of the TPU kernels
// tokenreduction_tpu/ops/fused_full_block.py fused_full_block,
// ops/flash_attention.py fused_block_attention and fused_rect_block, and
// ops/fused_mlp.py fused_mlp_residual and fused_mlp_gather_residual, whose
// fp32 dots run on the MXU in the multi-pass form at the kernels' pinned
// DEFAULT precision. 3xTF32 is Hopper's counterpart: each operand is split
// into a TF32 high part and a TF32 low part (rounded to nearest, ties
// away from zero), and the product is
// lo.hi + hi.lo + hi.hi with fp32 accumulation; the dropped lo.lo is about
// 2^-22 of a product, a few fp32 ulps from a true fp32 sum.
//
// What bounds it: operations. A DeiT-S block's four products at B = 256
// (M = 50,432) are 59.5 GFLOP, 178.5 in 3xTF32: 0.361 ms at the H100's
// 494.7 TFLOP/s of dense TF32 (0.888 ms at 67 TFLOP/s of fp32 FMA).
//
// Design: gemm_sm90.cu's shape, in fp32. A tile is 128 x 128 (BM x BN,
// dividing 384, 1152 and 1536), K steps of BK = 32 (one 128-byte row of
// fp32: the TMA swizzle span, so the wgmma descriptors are the bf16
// kernel's byte for byte, a k8 slice 32 bytes further). A persistent grid
// of one block per SM walks the tiles in a fixed order (row tile, then
// column tile). Three roles:
//   - warp 0: one thread issues the TMA loads of A's and B's tiles with the
//     128-byte swizzle into a ring of three stages (zero fill past every
//     edge);
//   - warps 1-3, the converters: as a stage lands (full barrier), they
//     split it, 16 bytes a thread at a time: hi = tf32(x) in place, lo =
//     tf32(x - hi) into the stage's second half at the same offset, so the
//     lo tiles keep the swizzled layout; a proxy fence, then the stage's
//     ready barrier. The split of a stage overlaps the products of the
//     stage before;
//   - warpgroups 1 and 2, the consumers (setmaxnreg 224; the producer
//     warpgroup keeps 56), each owning 64 rows: per k8 slice three
//     m64n128k8 tf32 wgmmas from shared memory, A_lo.B_hi, A_hi.B_lo,
//     A_hi.B_hi. The tensor cores add each product to their fp32
//     accumulator with truncation, so one accumulator over all of K
//     drifts toward zero by about an ulp an addition (a build with one had
//     several times a true fp32 product's error over a block); a K step's
//     twelve products go into a partial from zero, the small ones first,
//     and each partial is added to the tile's sum in fp32 with rounding to
//     nearest. A stage is released (empty barrier) once its products have
//     retired; the two consumer warpgroups' K steps interleave on the
//     tensor cores. (A second partial, to keep one K step in flight, did
//     not fit the 168 registers a thread that ptxas allocates here, and
//     spilled.)
// A stage is 64 KB: A and B raw, then their lo parts; three stages and no
// staging of the epilogue, which stores from the accumulators (a thread's
// pairs of neighbouring columns, 8 bytes, a warp covering whole 32-byte
// sectors of 8 rows), each row's bias, residual and Y in fp32.
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
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;  // warpgroups of 64 rows
constexpr int CONVERTERS = 3;  // warps 1-3 of the producer warpgroup
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int A_BYTES = BM * BK * 4;
constexpr int B_BYTES = BN * BK * 4;
constexpr int RAW_BYTES = A_BYTES + B_BYTES;  // what TMA lands in a stage
constexpr int STAGE_BYTES = 2 * RAW_BYTES;    // and the lo parts
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 3 * STAGES * 8;
static_assert(SMEM_BYTES <= 232448, "over the H100's 227 KB of shared memory a block");
static_assert(BN / 2 == TF32_ACC && BK == 32, "gemm_tf32.cuh's wgmma and K step");

struct Tiles {
  int m_tiles, n_tiles;
  __device__ __forceinline__ int count() const { return m_tiles * n_tiles; }
  __device__ __forceinline__ void at(int t, int& m0, int& n0) const {
    m0 = (t / n_tiles) * BM;
    n0 = (t % n_tiles) * BN;
  }
};

// GRAD: the GELU epilogue also writes GELU' of the pre-activation (the
// training forward's fc1); a variant of its own: in the one kernel the
// extra epilogue code slowed the other products by 2-12% on an H100
// (tools/port_ab.py).
template <bool GRAD>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_tf32_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                          const __grid_constant__ CUtensorMap map_b, GemmArgs a) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the stages to it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* stages = smem_raw + (base - raw);
  const uint32_t full0 = base + STAGES * STAGE_BYTES;
  const uint32_t ready0 = full0 + STAGES * 8;
  const uint32_t empty0 = ready0 + STAGES * 8;
  const Tiles tiles{(a.M + BM - 1) / BM, (a.n_out + BN - 1) / BN};
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, CONVERTERS);  // one arrival per converter warp
      mbar_init(empty0 + 8 * s, 4 * CONSUMERS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    const int pw = threadIdx.x >> 5;
    int stage = 0;
    uint32_t phase = 0;
    if (pw == 0) {
      // the loads, in the consumers' order
      if (lane != 0) return;
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      for (int t = blockIdx.x; t < tiles.count(); t += gridDim.x) {
        int m0, n0;
        tiles.at(t, m0, n0);
        for (int k = 0; k < a.K; k += BK) {
          const uint32_t full = full0 + 8 * stage;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full, RAW_BYTES);
          const uint32_t sa = base + stage * STAGE_BYTES;
          tma_load(sa, &map_a, full, k, m0);
          tma_load(sa + A_BYTES, &map_b, full, k, n0);
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
      return;
    }
    // the converters: split each landed stage into hi (in place) and lo
    const int ct = threadIdx.x - 32;
    for (int t = blockIdx.x; t < tiles.count(); t += gridDim.x) {
      for (int k = 0; k < a.K; k += BK) {
        mbar_wait(full0 + 8 * stage, phase);
        float4* hi = reinterpret_cast<float4*>(stages + stage * STAGE_BYTES);
        float4* lo = hi + RAW_BYTES / 16;
#pragma unroll 4
        for (int i = ct; i < RAW_BYTES / 16; i += 32 * CONVERTERS) {
          const float4 x = hi[i];
          uint32_t h[4], l[4];
          split_tf32(x.x, h[0], l[0]);
          split_tf32(x.y, h[1], l[1]);
          split_tf32(x.z, h[2], l[2]);
          split_tf32(x.w, h[3], l[3]);
          hi[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                              __uint_as_float(h[2]), __uint_as_float(h[3]));
          lo[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                              __uint_as_float(l[2]), __uint_as_float(l[3]));
        }
        fence_async_smem();  // the wgmmas read both through the async proxy
        __syncwarp();
        if (lane == 0) mbar_arrive(ready0 + 8 * stage);
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows cw * 64 .. + 63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = (threadIdx.x & 127) >> 5, g = lane >> 2, tq = lane & 3;
  const uint32_t a_off = cw * (64 * 128);  // the warpgroup's 64 rows of A
  const float* bias = static_cast<const float*>(a.bias);
  const float* res = static_cast<const float*>(a.res);
  float* y = static_cast<float*>(a.y);
  int stage = 0;
  uint32_t phase = 0;
  float d[TF32_ACC], p[TF32_ACC];
  for (int t = blockIdx.x; t < tiles.count(); t += gridDim.x) {
    int m0, n0;
    tiles.at(t, m0, n0);
#pragma unroll
    for (int i = 0; i < TF32_ACC; ++i) d[i] = 0.f;
    for (int k = 0; k < a.K; k += BK) {
      mbar_wait(ready0 + 8 * stage, phase);
      const uint32_t sa = base + stage * STAGE_BYTES + a_off;
      const uint32_t sb = base + stage * STAGE_BYTES + A_BYTES;
      k_step_3xtf32(p, sa, sb, RAW_BYTES);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // the stage is read
#pragma unroll
      for (int i = 0; i < TF32_ACC; ++i) d[i] += p[i];
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }

    // the epilogue: d[4 j + 2 r + e] is row g + 8 r of the warp's 16,
    // column 8 j + 2 tq + e
    const int row_a = m0 + cw * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * tq;
      if (col >= a.n_out) continue;  // n_out % 8 == 0: col + 1 is in too
      const float2 bb = bias ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        if (row >= a.M) continue;
        float x0 = d[4 * j + 2 * r] + bb.x, x1 = d[4 * j + 2 * r + 1] + bb.y;
        if (a.gelu) {
          if constexpr (GRAD)
            *reinterpret_cast<float2*>(a.gelu_grad + static_cast<size_t>(row) * a.n_out + col) =
                make_float2(gelu_grad(x0), gelu_grad(x1));
          x0 = gelu(x0), x1 = gelu(x1);
        }
        if (res) {
          const float2 rr =
              *reinterpret_cast<const float2*>(res + res_row(a, row) * a.n_out + col);
          x0 += rr.x, x1 += rr.y;
        }
        *reinterpret_cast<float2*>(y + static_cast<size_t>(row) * a.n_out + col) =
            make_float2(x0, x1);
      }
    }
  }
}

}  // namespace

int launch_gemm_tf32_sm90(const GemmArgs& a, cudaStream_t stream) {
  if (a.M == 0 || a.n_out == 0) return 0;
  if (a.mul != nullptr || a.col_sums != nullptr || a.k_split ||
      !a.y_f32 || (a.res != nullptr && !a.res_f32))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel =
      a.gelu_grad != nullptr ? gemm_tf32_sm90_kernel<true> : gemm_tf32_sm90_kernel<false>;
  // first: the context the tensor maps need (sm90.cuh encoder)
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_a, map_b;
  constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B;
  err = tensor_map_f32(&map_a, a.x, a.M, a.K, BM, BK, SW);
  if (err == cudaSuccess) err = tensor_map_f32(&map_b, a.w, a.n_out, a.K, BN, BK, SW);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long count = static_cast<long long>((a.M + BM - 1) / BM) * ((a.n_out + BN - 1) / BN);
  const int grid = static_cast<int>(count < sms ? count : sms);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(map_a, map_b, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace trk

// The kernel's tile and its dynamic shared memory a block, for the host:
// out[5] = {BM, BN, BK, STAGES, SMEM_BYTES}.
extern "C" int tr_gemm_tf32_config(int* out) {
  const int config[5] = {trk::BM, trk::BN, trk::BK, trk::STAGES, trk::SMEM_BYTES};
  for (int i = 0; i < 5; ++i) out[i] = config[i];
  return 0;
}
