// The bf16 GEMM of every kernel counterpart in ops/, for Hopper (sm_90a):
// TMA loads into a ring of shared-memory stages, mbarriers between one
// producer warp and two consumer warpgroups, and wgmma from shared memory.
// It computes, with fp32 accumulators, the four layouts of ln_gemm.cu's
// entry points (tr_gemm and tr_gemm_wgrad call it for bf16 operands):
//
//   forward:  Y[M, n_out] = epi(X[M, K] . W^T + bias), W [n_out, K]; both
//             operands K-major. epi: optional exact-erf GELU, then an
//             optional residual (bf16 or fp32) whose rows may be gathered
//             through idx; Y bf16 or fp32.
//   fc1:      the same with GELU'(pre-activation) also written in fp32.
//   scaled:   the forward with each row's result times an fp32 factor
//             row_scale[m / scale_rows] before the residual is added: the
//             drop-path scale of a residual branch (an image's factor over
//             its N rows), Y = res + s_b (X . W^T + bias), for the
//             residual-fused attention branch of the kernel tools
//             (tokenreduction_tpu_torch/tools/proto_residual_fuse.py; the
//             TPU kernel tools/proto_residual_fuse.py _fwd_kernel_res).
//   dY . W:   Y = epi(dY[M, n_out] . W[n_out, K]) read untransposed: B is
//             MN-major. epi: an optional fp32 factor (GELU'), and optional
//             per-128-row-tile column sums of the fp32 result (a bias
//             gradient before rounding).
//   wgrad:    the partial dW[n_out, K] = dY^T X over one slice of the rows
//             per split, fp32 partials [splits][n_out][K], and the partial
//             column sums of dY (the bias gradient) from the tiles of the
//             first column tile; A = dY and B = X both MN-major.
//
// It replaces the matrix products of the TPU kernels
// tokenreduction_tpu/ops/fused_full_block.py fused_full_block,
// ops/flash_attention.py fused_block_attention and fused_rect_block,
// ops/fused_mlp.py fused_mlp_residual and fused_mlp_gather_residual,
// ops/fused_block_train.py attend_branch_train and ops/fused_mlp_train.py
// mlp_branch (the MXU dots of each, with their weight-gradient
// accumulators carried across the sequential grid in VMEM).
//
// What bounds it: at DeiT-S width (K = 384 or 1536, n_out = 384, 1152 or
// 1536, M = 50,432 rows at B = 256) each product is above the H100's
// ridge (989 TFLOP/s over 3.35 TB/s): the tensor cores bound it, except
// the training fc1, whose fp32 GELU' write (310 MB) bounds it by bytes.
// At K = 384 a 128-row tile has only six K steps of 64, so a tile's
// pipeline fill and its epilogue weigh as much as its products. The
// design answers that with a persistent grid: one block per SM walks the
// output tiles in a fixed order, and the producer warp loads the next
// tile's K steps while the consumers run this tile's epilogue, and with
// an epilogue whose every load and store runs along whole rows.
//
// Layout. A tile is 128 x 192 (BM x BN; 192 divides 384, 1152 and 1536, so
// the main path has no partial column tile), K steps of BK = 64 (one
// 128-byte row of bf16, the TMA swizzle span). A stage holds A's 128 rows
// and B's 192 rows of one K step, 40 KB; four stages. TMA writes each box
// with the 128-byte swizzle, and the wgmma descriptors read it with the
// same swizzle:
//   - K-major (X, W of the forward): one box of 64 k x rows; row r at
//     r * 128 bytes, 8-row groups 1024 bytes apart (SBO); a k16 slice
//     starts 32 bytes further.
//   - MN-major (W untransposed, dY and X of wgrad): boxes of 64 k rows x
//     64 elements along M or N, 8 KB each, side by side (LBO = 8 KB between
//     64-wide chunks); 8-k groups 1024 bytes apart (SBO); a k16 slice
//     starts 2048 bytes further. wgmma reads such an operand transposed
//     (its imm-trans bit): no transposed copy is made anywhere.
// TMA's zero fill past the tensor's edge replaces all masking of loads: the
// ragged last row tile, a partial column tile, a K that is no multiple of
// 64, and the end of the last wgrad slice.
//
// Roles. Warpgroup 0 is the producer: it gives up registers (setmaxnreg 40)
// and one thread issues every TMA load. Warpgroups 1 and 2 are consumers
// (setmaxnreg 232), each owning 64 rows of the tile: m64n192k16 wgmmas,
// 96 fp32 accumulators a thread. A stage's full barrier completes when
// its 40 KB have landed (expect_tx); its empty barrier when each of the 8
// consumer warps has retired the wgmmas that read it (wgmma.wait_group 1
// keeps one K step of products in flight while the next is issued).
//
// The epilogue. The accumulators hold, per row, pairs of neighbouring
// columns (the layout of mma.sync's C fragment); stored from there, a
// warp's store covers 8 rows of 16 bytes, and each residual or factor load
// waits before its store: on the H100 that epilogue cost more than the
// products. So each consumer warpgroup stages its 64 rows in shared memory,
// 64 columns a pass, as fp32, and reads them back 8 threads a row and 8
// columns a thread: bias, GELU (and GELU'), the fp32 factor and the
// residual are loaded, and Y stored, along whole rows, 16 bytes a lane,
// the loads of two row steps before their stores. The epilogue does not
// overlap the next tile's products, and at K = 384 it still takes longer
// than they do (not measured apart); a TMA store of the staged bf16 rows,
// and three epilogue warps working behind a staged tile, were both slower
// on the H100. Column sums are reduced over a warp's
// four rows by shuffles and over the 8 consumer warps through shared
// memory, in a fixed order; nothing uses atomics, so two identical
// launches give the same bits.
#include <stdint.h>

#include <cuda_bf16.h>

#include "gemm.cuh"
#include "sm90.cuh"

namespace trk {
namespace {

constexpr int BM = 128;
constexpr int BN = 192;
constexpr int BK = 64;      // one 128-byte swizzled row of bf16
constexpr int BOX = 64;     // the width of an MN-major box
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;  // warpgroups of 64 rows
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BOX_BYTES = BOX * BK * 2;  // an MN-major box, 8 KB
constexpr int EPI_COLS = 64;  // columns of one epilogue pass
constexpr int EPI_LD = EPI_COLS + 8;  // staged row stride in floats: conflict-free float2 writes
constexpr int EPI_BYTES = 64 * EPI_LD * 4;  // a consumer warpgroup's staged 64 x 64 fp32
constexpr int RED_BYTES = 4 * CONSUMERS * BN * 4;  // a row of column sums per consumer warp
constexpr int SMEM_BYTES =
    1024 + STAGES * STAGE_BYTES + CONSUMERS * EPI_BYTES + RED_BYTES + 2 * STAGES * 8;
constexpr int ACC = BN / 2;  // fp32 accumulators per consumer thread
static_assert(SMEM_BYTES <= 232448, "over the H100's 227 KB of shared memory a block");

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 192] += A[64 x 16] . B[16 x 192], both from shared memory; TA, TB:
// the operand is MN-major (transposed) rather than K-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_192(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, 1, 1, 1, %98, %99;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "n"(TA), "n"(TB));
}

// The epilogue of one pass: 64 rows from row0 on, eight neighbouring
// columns from col on (col % 8 == 0, n_out % 8 == 0), read from the staged
// fp32 products; a warp covers four whole rows of the pass at once, so
// every load and store of a row is one contiguous run, 16 bytes a lane
// (on the H100 a bf16 Y stored 8 bytes a lane went out more slowly, per
// byte, than an fp32 one stored 16 bytes a lane). The loads of
// two row steps are issued before any of their stores. Adds this
// thread's fp32 results (before Y's rounding) to cs. MUL: the layout
// whose launches may carry the fp32 factor and the column sums (dY . W);
// GRAD: the variant that writes GELU'. Each is compiled only where it is
// used, so the eval launches keep the smallest epilogue. SCALE: the
// variant with the per-row factor.
template <bool MUL, bool GRAD, bool SCALE>
__device__ __forceinline__ void epilogue_rows(const GemmArgs& a, float* y32, const float* staged,
                                              int row0, int col, int lane_row, float* cs) {
  if (col >= a.n_out) return;
  float b[8] = {};
  if (a.bias) load8(static_cast<const __nv_bfloat16*>(a.bias) + col, b);
  const int c8 = col & (EPI_COLS - 1);
#pragma unroll
  for (int g = 0; g < 4; g += 2) {  // four steps of 16 rows, two at a time
    float v[2][8], m[2][8] = {}, r[2][8] = {}, sc[2] = {1.f, 1.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int lr = (g + i) * 16 + lane_row, row = row0 + lr;
      load8(staged + lr * EPI_LD + c8, v[i]);
      if (row >= a.M) continue;
      if (MUL && a.mul) load8(a.mul + static_cast<size_t>(row) * a.n_out + col, m[i]);
      if (SCALE) sc[i] = a.row_scale[row / a.scale_rows];
      if (a.res) {
        const size_t at = res_row(a, row) * a.n_out + col;
        if (a.res_f32)
          load8(static_cast<const float*>(a.res) + at, r[i]);
        else
          load8(static_cast<const __nv_bfloat16*>(a.res) + at, r[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + (g + i) * 16 + lane_row;
      if (row >= a.M) continue;
      const size_t at = static_cast<size_t>(row) * a.n_out + col;
      float x[8], gg[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        x[k] = v[i][k] + b[k];
        if (a.gelu) {
          if (GRAD) gg[k] = gelu_grad(x[k]);
          x[k] = gelu(x[k]);
        }
        if (MUL && a.mul) x[k] *= m[i][k];
        if (SCALE) x[k] *= sc[i];
        x[k] += r[i][k];
        if (MUL) cs[k] += x[k];
      }
      if (GRAD && a.gelu) store8(a.gelu_grad + at, gg);
      if (a.y_f32)
        store8(y32 + at, x);
      else
        store8(static_cast<__nv_bfloat16*>(a.y) + at, x);
    }
  }
}

// The epilogue of a consumer warpgroup's 64 rows, in passes of 64
// columns: the accumulators go to the staging (a thread holds rows g and
// g + 8 of its warp's 16, columns 8 j + 2 (lane % 4) and the next), then 8
// threads a row read them back along the rows, 8 columns a thread. The
// column sums (BWD) of the warp's rows go to red.
template <bool BWD, bool GRAD, bool SCALE>
__device__ __forceinline__ void epilogue(const GemmArgs& a, const float* d, float* y32,
                                             float* staged, float* red, int m0, int n0, int cw,
                                             int warp, int lane, int t128) {
  const int frag_row = warp * 16 + (lane >> 2), frag_col = 2 * (lane & 3);
  const int lane_col = (t128 & 7) * 8, lane_row = t128 >> 3;
#pragma unroll
  for (int part = 0; part < BN / EPI_COLS; ++part) {
#pragma unroll
    for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
      const int j = part * (EPI_COLS / 8) + jj;
      float* at = staged + frag_row * EPI_LD + jj * 8 + frag_col;
      *reinterpret_cast<float2*>(at) = make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(at + 8 * EPI_LD) = make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
    float cs[8] = {};
    epilogue_rows<BWD, GRAD, SCALE>(a, y32, staged, m0 + cw * 64,
                                    n0 + part * EPI_COLS + lane_col, lane_row, cs);
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");  // staging free again
    if (BWD && a.col_sums != nullptr) {
      // the warp's four rows of lanes
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 8);
        cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], 16);
        if (lane < 8) red[(cw * 4 + warp) * BN + part * EPI_COLS + lane_col + e] = cs[e];
      }
    }
  }
}

// The output tiles, walked in one fixed order: split, then row tile, then
// column tile (neighbouring blocks share A's rows through L2).
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

// A_MN: A stored [K][M] (wgrad's dY; K split over `splits` slices); B_MN:
// B stored [K][n_out]; GRAD: the GELU epilogue also writes GELU'. The
// backward's own epilogue steps (the fp32 factor, the column sums) compile
// only into the layout with B_MN and not A_MN, the row sums of A only into
// A_MN; SCALE: the forward's per-row factor (a variant of its own, so the
// other launches keep their epilogue).
template <bool A_MN, bool B_MN, bool GRAD, bool SCALE>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b, GemmArgs a, int splits) {
  constexpr bool BWD = B_MN && !A_MN;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the stages to it
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* stages = smem_raw + (base - raw);
  float* epi = reinterpret_cast<float*>(stages + STAGES * STAGE_BYTES);
  float* red = epi + CONSUMERS * EPI_BYTES / 4;
  const uint32_t full0 = base + STAGES * STAGE_BYTES + CONSUMERS * EPI_BYTES + RED_BYTES;
  const uint32_t empty0 = full0 + STAGES * 8;
  const Tiles tiles{(a.M + BM - 1) / BM, (a.n_out + BN - 1) / BN, splits,
                    a.k_split ? a.k_split : a.K, a.K};
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * CONSUMERS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // producer: one thread issues every load, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x != 0) return;
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_a)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_b)) : "memory");
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles.count(); t += gridDim.x) {
      int m0, n0, z, k0, k1;
      tiles.at(t, m0, n0, z, k0, k1);
      for (int k = k0; k < k1; k += BK) {
        const uint32_t full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        mbar_expect_tx(full, STAGE_BYTES);
        const uint32_t sa = base + stage * STAGE_BYTES, sb = sa + A_BYTES;
        if constexpr (A_MN) {
#pragma unroll
          for (int j = 0; j < BM / BOX; ++j)
            tma_load(sa + j * BOX_BYTES, &map_a, full, m0 + j * BOX, k);
        } else {
          tma_load(sa, &map_a, full, k, m0);
        }
        if constexpr (B_MN) {
#pragma unroll
          for (int j = 0; j < BN / BOX; ++j)
            tma_load(sb + j * BOX_BYTES, &map_b, full, n0 + j * BOX, k);
        } else {
          tma_load(sb, &map_b, full, k, n0);
        }
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows cw * 64 .. + 63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wg - 1;
  const int t128 = threadIdx.x & 127, warp = t128 >> 5, lane = threadIdx.x & 31;
  const int ctid = threadIdx.x - 128;  // 0 .. 255
  // both layouts put a consumer's 64 rows of A 8 KB apart: 64 K-major rows
  // of 128 bytes, or one MN-major box
  const uint32_t a_off = cw * BOX_BYTES;
  int stage = 0;
  uint32_t phase = 0;
  float d[ACC];
  for (int t = blockIdx.x; t < tiles.count(); t += gridDim.x) {
    int m0, n0, z, k0, k1;
    tiles.at(t, m0, n0, z, k0, k1);
#pragma unroll
    for (int i = 0; i < ACC; ++i) d[i] = 0.f;
    // wgrad: the first column tile also sums A's rows (dY's columns) over
    // the slice: two threads per column of the warpgroup's box, each over
    // half the K step's rows in four running sums (a chain of 64 adds
    // would hold back the next K step's products)
    const bool a_sums = A_MN && a.a_sums != nullptr && n0 == 0;
    const int a_col = t128 & (BOX - 1), a_rows = (t128 / BOX) * (BK / 2);
    float a_sum[4] = {};
    int prev = -1;
    for (int k = k0; k < k1; k += BK) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t sa = base + stage * STAGE_BYTES + a_off;
      const uint32_t sb = base + stage * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = A_MN ? smem_desc(sa + kk * 2048, BOX_BYTES, 1024)
                                 : smem_desc(sa + kk * 32, 16, 1024);
        const uint64_t db = B_MN ? smem_desc(sb + kk * 2048, BOX_BYTES, 1024)
                                 : smem_desc(sb + kk * 32, 16, 1024);
        wgmma_192<A_MN, B_MN>(d, da, db);
      }
      wgmma_commit();
      if (A_MN && a_sums) {
        // k row r of the box: 128 bytes, 16-byte chunk c stored at c ^ (r % 8)
        const uint8_t* box = stages + stage * STAGE_BYTES + a_off;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int r = a_rows + i;
          a_sum[i & 3] += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
              box + r * 128 + ((((a_col >> 3) ^ (r & 7)) << 4) | ((a_col & 7) << 1))));
        }
      }
      wgmma_wait<1>();  // the products of the step before have read their stage
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      }
      prev = stage;
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);
    }

    epilogue<BWD, GRAD, SCALE>(a, d,
                               static_cast<float*>(a.y) +
                                   (A_MN ? static_cast<size_t>(z) * a.M * a.n_out : 0),
                               epi + cw * (EPI_BYTES / 4), red, m0, n0, cw, warp, lane, t128);
    if (BWD && a.col_sums != nullptr) {
      // the 8 consumer warps' column sums, in order
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      for (int c = ctid; c < BN; c += 128 * CONSUMERS) {
        if (n0 + c >= a.n_out) continue;
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < 4 * CONSUMERS; ++r) s += red[r * BN + c];
        a.col_sums[static_cast<size_t>(m0 / BM) * a.n_out + n0 + c] = s;
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");  // red is free for the next tile
    }
    if (a_sums) {
      // the second half of each column's rows through shared memory (red:
      // wgrad has no column sums), then added in a fixed order
      const float part = (a_sum[0] + a_sum[1]) + (a_sum[2] + a_sum[3]);
      if (a_rows) red[cw * BOX + a_col] = part;
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
      if (!a_rows && m0 + cw * 64 + a_col < a.M)
        a.a_sums[static_cast<size_t>(z) * a.M + m0 + cw * 64 + a_col] =
            part + red[cw * BOX + a_col];
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
    }
  }
}

// The map of a row-major bf16 tensor [rows][cols], cut into boxes of
// box_rows x 64 columns (128 bytes) with the 128-byte swizzle; reads past
// an edge are zeros.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {BOX, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <bool A_MN, bool B_MN, bool GRAD, bool SCALE = false>
int launch(const GemmArgs& a, int splits, cudaStream_t stream) {
  const auto kernel = gemm_sm90_kernel<A_MN, B_MN, GRAD, SCALE>;
  // first: the context the tensor maps need (sm90.cuh encoder)
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_a, map_b;
  // A: [M, K] K-major, or [K, M] for wgrad; B: [n_out, K], or [K, n_out]
  err = A_MN ? tensor_map(&map_a, a.x, a.K, a.M, BK) : tensor_map(&map_a, a.x, a.M, a.K, BM);
  if (err == cudaSuccess)
    err = B_MN ? tensor_map(&map_b, a.w, a.K, a.n_out, BK)
               : tensor_map(&map_b, a.w, a.n_out, a.K, BN);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long count =
      static_cast<long long>(splits) * ((a.M + BM - 1) / BM) * ((a.n_out + BN - 1) / BN);
  const int grid = static_cast<int>(count < sms ? count : sms);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(map_a, map_b, a, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The five compiled variants: eval and forward, the training fc1 (GELU'
// out), the backward's dY . W, the weight gradient, and the forward with
// the per-row factor.
int launch_gemm_sm90(const GemmArgs& a, bool a_mn, bool b_mn, int splits, cudaStream_t stream) {
  if (a.M == 0 || a.n_out == 0) return 0;
  if ((a.k_split && a.k_split % BK != 0) || (a_mn && !b_mn) || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.row_scale != nullptr) {
    if (a_mn || b_mn || a.gelu || a.scale_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
    return launch<false, false, false, true>(a, splits, stream);
  }
  if (a_mn) return launch<true, true, false>(a, splits, stream);
  if (b_mn) return launch<false, true, false>(a, splits, stream);
  if (a.gelu_grad != nullptr) return launch<false, false, true>(a, splits, stream);
  return launch<false, false, false>(a, splits, stream);
}

}  // namespace trk

// The kernel's tile and its dynamic shared memory a block, for the host:
// out[5] = {BM, BN, BK, STAGES, SMEM_BYTES}.
extern "C" int tr_gemm_sm90_config(int* out) {
  const int config[5] = {trk::BM, trk::BN, trk::BK, trk::STAGES, trk::SMEM_BYTES};
  for (int i = 0; i < 5; ++i) out[i] = config[i];
  return 0;
}
