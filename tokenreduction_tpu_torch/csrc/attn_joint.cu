// The qkv product fused into the short attention: the counterpart of the
// attention core of the TPU kernel tools/tune_kernels.py attn_joint (its
// pallas_call at :160, _attn_joint_kernel), for Hopper (sm_90a), in bf16.
// One block of one warpgroup per (image b, head h):
//
//   q, k, v = round(LN[b] . Wqkv_h^T + bqkv_h)     [N, 64] each, on chip
//   p = softmax(q k^T * scale)                     fp32, the exact row max
//   merged[b, :, 64 h ..] = round(round(p) . v)    [N, 64]
//   row0[b, h] = p[0, :],  colsum[b, h] = sum over the query rows of p
//
// where LN [B * N, D] holds LayerNorm's rounded rows (the layer_norm launch
// before it) and Wqkv_h the 3 x 64 rows of Wqkv [3 D, D] (nn.Linear's
// layout, timm's (3, H, 64) order) that make head h's q, k and v. The out
// projection, its bias and the residual stay a launch of the bf16 GEMM
// (ops/_build.py gemm) after it. The qkv tensor never reaches device
// memory.
//
// The qkv product. A pass takes two 64-row tiles of the image's LN rows
// (two passes at N > 128), each a [64, 192] fp32 accumulator on wgmma
// m64n192k16 with both operands in shared memory. D comes 32 columns a
// stage (one 64-byte swizzled row of bf16) in a ring of two stages under
// full and empty mbarriers, each stage two TMA boxes: the pass's 128 LN
// rows from a 3-D map [B][N][D] (a box past N reads zeros, never the next
// image's rows) and head h's q, k and v rows from a 4-D map [3][H][64][D]
// of Wqkv. A stage's products are issued behind the wait on the stage
// before's (wgmma.wait 1); then warp 0 refills that stage's slot with the
// step after, its whole warp waiting on the empty barrier and lane 0
// issuing. The epilogue adds head h's bias (staged in shared memory) in
// fp32, rounds once, and writes q, k and v (zeros past N) into shared
// memory in the 128-byte-swizzled layout that the attention's wgmma
// descriptors read. The ring's slots live in the q, k and v tiles of rows
// 128 .. 255, which their pass writes last.
//
// The attention is the main path's sm_90a forward (attention_sm90.cuh
// attention_fwd_tiles, NORM_P, no bias, no mask), run on these tiles: S =
// Q K^T on wgmma m64n64k16, the whole row of at most 256 keys in registers,
// logits in base-2 units (q.k * scale * log2 e; -inf past N), ex2 less
// the exact row max, P = e * (1 / sum) rounded to bf16 in registers as the
// A operand of O = P V (V read MN-major through the transpose bit), the
// output tile out by a TMA store on a [B, H, N, 64] map of merged; row0
// and colsum in fp32, colsum summed over a warp's rows by a fixed
// butterfly and over the four warps in order (no atomics: two launches
// give the same bits).
//
// What bounds it. At B = 256, N = 197, D = 384 a block computes 2 x 256 x
// 384 x 192 (the qkv rows padded to 256) + 4 x 256 x 256 x 64 operations;
// device memory sees the LN rows, the weights once and the merged heads:
// operations bound its function (the products at the bf16 rate take about
// twice the bytes' time). On this card the block's chain of steps sets its
// pace: each stage holds two products per row tile, and its load, issued
// one stage ahead, is not always in when the products want it; each block
// also reads its image's LN rows (once per head) and Wqkv_h (once a pass)
// from L2, about 0.48 MB. Two blocks an SM (about 104 KB of shared memory
// and at most 255 registers a thread each) hide each other's waits and
// each other's softmax. A producer warp of its own would take a fifth
// warp's registers at the consumers' count (setmaxnreg moves registers
// between whole warpgroups only) and leave one block an SM, and a third
// stage does not fit beside two blocks. Each fence sits beside its
// products, after every wait and branch: a fence before a loop or a
// branch left the compiler fencing and waiting on every product alone.
#include <stdint.h>

#include <cuda_bf16.h>

#include "attention_sm90.cuh"

namespace trk {
namespace {

using bf16 = __nv_bfloat16;

constexpr int JK = 32;                     // D columns a stage: one 64-byte swizzled row
constexpr int LN_SLOT = 2 * ROWS * JK * 2; // a pass's 128 LN rows, 8 KB (4 KB a row tile)
constexpr int W_SLOT = 3 * HD * JK * 2;    // head h's q, k, v rows of Wqkv, 12 KB
constexpr int STAGES = 2;                  // the most that fit beside two blocks an SM
// q, k, v tiles [MAXT] each; bias2, caps [MAXN]; per-warp column sums
// [4][MAXN]; head h's qkv bias [192]; the attention's 3 barriers and each
// stage's full and empty; 1 KB to align the tiles to the swizzle's 1024
constexpr int JOINT_SMEM =
    1024 + 3 * MAXT * TILE + 6 * MAXN * 4 + 3 * HD * 4 + (3 + 2 * STAGES) * 8;
static_assert(2 * (JOINT_SMEM + 1024) <= 233472, "two blocks no longer share an SM");
static_assert(STAGES * LN_SLOT <= 2 * TILE && W_SLOT <= 2 * TILE,
              "the stages overflow the tiles of rows 128 .. 255");

// Stage s: its LN rows in q's tiles 2 and 3, its weights in k's (s = 0)
// or v's (s = 1) tiles 2 and 3.
__device__ __forceinline__ uint32_t ln_slot(uint32_t sq, int s) {
  return sq + 2 * TILE + s * LN_SLOT;
}
__device__ __forceinline__ uint32_t w_slot(uint32_t sk, uint32_t sv, int s) {
  return (s == 0 ? sk : sv) + 2 * TILE;
}

// The ring: the q, k, v tiles' shared memory and the stages' barriers.
// Step i = p chunks + c: pass p (row tiles 2 p and 2 p + 1), D columns
// JK c ..; its stage is i % 2.
struct Ring {
  const CUtensorMap* map_ln;
  const CUtensorMap* map_w;
  uint32_t sq, sk, sv, full0, empty0;
  int chunks, steps, b, h, lane;
};

// Warp 0: step i = p chunks + c into its stage once the four warps have
// released the step two before; the whole warp waits and lane 0 issues,
// so that no lane runs a loop of its own between the warpgroup's
// products. Two boxes: the pass's 128 LN rows (zeros past N) and head h's
// q, k and v rows.
__device__ __forceinline__ void load_step(const Ring& r, int i, int p, int c) {
  if (i >= r.steps) return;
  const int s = i & 1;
  if (i >= STAGES) mbar_wait(r.empty0 + 8 * s, ((i >> 1) - 1) & 1);
  if (r.lane == 0) {
    const uint32_t full = r.full0 + 8 * s;
    mbar_expect_tx(full, LN_SLOT + W_SLOT);
    tma_load_3d(ln_slot(r.sq, s), r.map_ln, full, c * JK, 2 * p * ROWS, r.b);
    tma_load_4d(w_slot(r.sk, r.sv, s), r.map_w, full, c * JK, 0, r.h, 0);
  }
  __syncwarp();
}

// Pass p of the qkv product over T row tiles: each stage's products issued
// behind the wait on the stage before's (wgmma.wait 1), whose slot warp 0
// then refills with the step after this one. The fence sits beside each
// stage's products: one before a loop or a branch left the compiler
// fencing and waiting on every product alone. Returns with every product
// done.
template <int T>
__device__ __forceinline__ void qkv_pass(const Ring& r, float (&acc)[2][96], int p, int warp) {
#pragma unroll
  for (int j = 0; j < T; ++j)
#pragma unroll
    for (int e = 0; e < 96; ++e) acc[j][e] = 0.f;
  const int i0 = p * r.chunks;
  for (int c = 0; c < r.chunks; ++c) {
    const int i = i0 + c, s = i & 1;
    mbar_wait(r.full0 + 8 * s, (i >> 1) & 1);
    const uint32_t sa = ln_slot(r.sq, s), sw = w_slot(r.sk, r.sv, s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < JK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < T; ++j)
        wgmma_ss192(acc[j], smem_desc_sw64(sa + j * (LN_SLOT / 2) + kk * 32),
                    smem_desc_sw64(sw + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();  // the stage before's products are done
    if (c > 0) {
      __syncwarp();
      if (r.lane == 0) mbar_arrive(r.empty0 + 8 * (s ^ 1));
      if (warp == 0) {
        const bool same = c + 1 < r.chunks;
        load_step(r, i + 1, same ? p : p + 1, same ? c + 1 : 0);
      }
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < T; ++j)
#pragma unroll
    for (int e = 0; e < 96; ++e) asm volatile("" : "+f"(acc[j][e])::"memory");
  const int last = i0 + r.chunks - 1;
  __syncwarp();
  if (r.lane == 0) mbar_arrive(r.empty0 + 8 * (last & 1));
  if (warp == 0) load_step(r, last + 2, p + 1, 1);
}

__global__ void __launch_bounds__(THREADS, 2)
    attn_joint_kernel(const __grid_constant__ CUtensorMap map_ln,
                      const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_o, int ho,
                      const bf16* __restrict__ bqkv, int N, int D, int H, float scale,
                      float* __restrict__ row0, float* __restrict__ colsum) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* tiles = smem_raw + (base - raw);
  const uint32_t sq = base, sk = sq + MAXT * TILE, sv = sk + MAXT * TILE;
  float* bias2 = reinterpret_cast<float*>(tiles + 3 * MAXT * TILE);
  float* cap = bias2 + MAXN;
  float* csw = cap + MAXN;  // [4][MAXN]
  float* bh_qkv = csw + 4 * MAXN;  // head h's q, k, v bias [3][64]
  const uint32_t bars = smem_addr(bh_qkv + 3 * HD);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nt = tiles_of(N);
  Ring r;
  r.map_ln = &map_ln;
  r.map_w = &map_w;
  r.sq = sq, r.sk = sk, r.sv = sv;
  r.full0 = bars + 3 * 8;
  r.empty0 = r.full0 + STAGES * 8;
  r.chunks = D / JK, r.steps = (nt + 1) / 2 * r.chunks;
  r.b = b, r.h = h, r.lane = lane;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bars + 8 * i, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.full0 + 8 * s, 1);
      mbar_init(r.empty0 + 8 * s, 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_ln))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map_w))
                   : "memory");
    }
    load_step(r, 0, 0, 0);
    load_step(r, 1, 0, 1);
  }
  key_vectors(bias2, cap, nullptr, nullptr, b, N);
  for (int i = tid; i < 3 * HD; i += THREADS)
    bh_qkv[i] = __bfloat162float(bqkv[(i / HD) * D + h * HD + i % HD]);
  __syncthreads();

  float acc[2][96];
  for (int p = 0; 2 * p < nt; ++p) {
    const int live = min(2, nt - 2 * p);
    if (live == 2)
      qkv_pass<2>(r, acc, p, warp);
    else
      qkv_pass<1>(r, acc, p, warp);
    // the pass's rows: + bias, rounded, into q, k and v's tiles (zeros
    // past N); acc column 8 jn + 2 t: part jn / 8, column 8 (jn % 8) + 2 t
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (j < live) {
        const int tile = 2 * p + j, lr = warp * 16 + g;
        const bool in0 = tile * ROWS + lr < N, in1 = tile * ROWS + lr + 8 < N;
#pragma unroll
        for (int jn = 0; jn < 24; ++jn) {
          const int part = jn / 8, jj = jn % 8;
          const float2 bb = *reinterpret_cast<const float2*>(bh_qkv + part * HD + 8 * jj + 2 * t);
          uint8_t* dst = tiles + (part * MAXT + tile) * TILE;
          const float* d = acc[j] + 4 * jn;
          *reinterpret_cast<uint32_t*>(dst + pair_offset(lr, jj, t)) =
              in0 ? pack_bf16(d[0] + bb.x, d[1] + bb.y) : 0u;
          *reinterpret_cast<uint32_t*>(dst + pair_offset(lr + 8, jj, t)) =
              in1 ? pack_bf16(d[2] + bb.x, d[3] + bb.y) : 0u;
        }
      }
  }
  fence_async_smem();  // q, k and v into the async proxy, for the wgmmas
  __syncthreads();
  // the attention's barriers: every tile is in
  if (tid == 0)
    for (int i = 0; i < 3; ++i) mbar_arrive(bars + 8 * i);
  mbar_wait(bars, 0);
  attention_fwd_tiles<true, false, false, MAXT>(sq, sk, sv, bars, bias2, cap, csw, csw,
                                                &map_o, ho, row0, colsum, nullptr, N, N, nt, nt,
                                                bh, h, b, tid, warp, lane, g, t, scale);
}

}  // namespace
}  // namespace trk

// merged [B * N, D] (bf16; head h's columns 64 h ..) and, where not null,
// row0 and colsum [B, H, N] fp32 of the attention of each (image, head)
// over q, k, v = LN rows . Wqkv^T + bqkv (see above): ln [B * N, D], wqkv
// [3 D, D], bqkv [3 D], bf16, contiguous and 16-byte aligned (the caller
// checks). D = 64 H, 1 <= N <= 256. Returns the cudaError_t
// of the launch.
extern "C" int tr_attn_joint(const void* ln, const void* wqkv, const void* bqkv, int B, int N,
                             int D, int H, float scale, void* merged, void* row0, void* colsum,
                             void* stream) {
  using namespace trk;
  if (B == 0) return 0;
  if (N < 1 || N > MAXN || H < 1 || D != HD * H)
    return static_cast<int>(cudaErrorInvalidValue);
  // first: the context the tensor maps need (sm90.cuh encoder)
  cudaError_t err = cudaFuncSetAttribute(attn_joint_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, JOINT_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_ln, map_w, map_o;
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t ln_dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(N),
                                 static_cast<cuuint64_t>(B)};
  const cuuint64_t ln_strides[2] = {row, row * N};
  const cuuint32_t ln_box[3] = {JK, 2 * ROWS, 1};
  err = bf16_map(&map_ln, ln, 3, ln_dims, ln_strides, ln_box, CU_TENSOR_MAP_SWIZZLE_64B);
  // Wqkv [3 D, D] as [3][H][64][D]: one box is head h's q, k and v rows
  const cuuint64_t w_dims[4] = {static_cast<cuuint64_t>(D), HD, static_cast<cuuint64_t>(H), 3};
  const cuuint64_t w_strides[3] = {row, row * HD, row * D};
  const cuuint32_t w_box[4] = {JK, HD, 1, 3};
  if (err == cudaSuccess)
    err = bf16_map(&map_w, wqkv, 4, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_64B);
  // merged as [B, H, N, 64]: strides (N D, 64, D)
  const long long o_strides[3] = {static_cast<long long>(N) * D, HD, D};
  bool ho = false;
  if (err == cudaSuccess) err = heads_map(&map_o, merged, o_strides, B, H, N, &ho);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_joint_kernel<<<B * H, THREADS, JOINT_SMEM, static_cast<cudaStream_t>(stream)>>>(
      map_ln, map_w, map_o, ho, static_cast<const __nv_bfloat16*>(bqkv), N, D, H, scale,
      static_cast<float*>(row0), static_cast<float*>(colsum));
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block takes, the same at every N.
extern "C" int tr_attn_joint_smem() { return trk::JOINT_SMEM; }
