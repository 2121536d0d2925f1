// The MLP half with the hidden tensor kept on chip: the counterpart of the
// TPU kernel tools/tune_kernels.py mlp_chunked (its pallas_call at :282,
// _mlp_chunk_kernel), for Hopper (sm_90a), in bf16:
//
//   out = x + fc2(gelu(fc1(LN2 x))),   x, out [M, 384]; W1 [H4, 384] and
//   W2 [384, H4] in nn.Linear's [out, in] layout; H4 a multiple of 32 up to 1536.
//
// Numerics as the TPU kernel's: LayerNorm in fp32 (two-pass statistics),
// its output rounded to bf16; fc1 accumulated in fp32, plus b1, the exact
// GELU in fp32 (erff, where the TPU kernel has a rational erf within
// 1.5e-7), the hidden rounded to bf16; fc2 accumulated in fp32 over all
// hidden units, in the kernel's own order whatever the caller's chunks;
// x + acc + b2 in fp32, rounded once.
//
// Design. A block takes BM = 128 rows: two warpgroups of 64 rows each.
// Warp 0 (its lane 0) issues every TMA load: first the block's x rows
// (64-row boxes with the 128-byte swizzle) into the warpgroups' shared
// memory, then the weights in slices of HC = 32 hidden units, W1's
// [32, 384] (128-byte swizzle) and W2's [384, 32] (64-byte swizzle), each
// into a ring of its own (2 and 3 stages) under full and empty mbarriers,
// two slices ahead of the products. A warpgroup turns its x rows into
// LN2's rounded rows in place, then keeps [64, 384] fp32 of fc2 in
// registers (two m64n192 wgmma accumulators, 192 a thread) for the whole
// hidden width. For each slice: fc1's [64, 32] on wgmma m64n32k16 from the
// LN rows and W1's slice in shared memory; b1 (staged in shared memory)
// and the GELU in fp32 in registers; the hidden rounded to bf16 straight
// into the A fragments of fc2's wgmma m64n192k16 (A from registers: the
// hidden never goes through shared memory nor reaches device memory). The
// next slice's fc1 is issued before this slice's fc2, and the GELU of that
// next slice runs while this slice's fc2 products are in flight
// (wgmma.wait 1); the two warpgroups' products and GELUs interleave as
// well. At the end out = x + acc + b2 goes, rounded, through the LN rows'
// shared memory and out by TMA stores (rows past M dropped).
//
// What bounds it. Operations: 16 M D^2 = 119 GFLOP at M = 50,432, the least
// time at the bf16 rate. L2 bytes: each block reads W1 and W2 whole (2.36 MB)
// once for its 128 rows, 0.93 GB a call at M = 50,432 (half of what 64 rows a
// block read). Registers: the fc2 accumulator takes 192 of a thread's 255,
// which caps a warpgroup at 64 rows and a block at two of them, and leaves the
// GELU few registers: its sixteen erff a thread a slice run nearly one after
// another, and they, not the tensor cores, set the pace of a slice. With a
// producer warpgroup of its own (384 threads, setmaxnreg 24 and 240) ptxas
// reported 168 registers a thread and spilled; two warpgroups of 128 threads
// have 255 registers a thread and no spill. Shared memory: the LN rows (96 KB,
// later the output tile), the two rings (48 + 72 KB) and b1 (6 KB) take 223
// KB, one block an SM, 394 blocks at M = 50,432 (three waves; at M = 256 x 68,
// 136 blocks, two waves, the second nearly empty). Each fence sits beside its
// products, after every wait and branch: a fence before a loop or a branch
// left the compiler fencing and waiting on every product alone, and loop-
// invariant descriptors are rebuilt each slice (opaque), or the compiler kept
// them all in registers.
#include <stdint.h>

#include <cuda_bf16.h>

#include "common.cuh"
#include "sm90.cuh"

namespace trk {
namespace {

using bf16 = __nv_bfloat16;

constexpr int MD = 384;                    // the model width the kernel is compiled for
constexpr int MBM = 128;                   // rows a block
constexpr int HC = 32;                     // hidden units a slice
constexpr int MTHREADS = 256;              // two warpgroups of 64 rows
constexpr int KBOX = 64 * 64 * 2;          // a 64-row box of 64 columns, 8 KB
constexpr int LN_BYTES = 64 * MD * 2;      // a consumer's LN rows, 6 boxes, 48 KB
constexpr int W1_BYTES = HC * MD * 2;      // a W1 slice, 6 boxes of 32 rows, 24 KB
constexpr int W2_HALF = (MD / 2) * HC * 2; // a W2 slice's 192 rows, 12 KB
constexpr int W1_STAGES = 2;
constexpr int W2_STAGES = 3;
constexpr int MAX_H4 = 1536;               // b1's room in shared memory
constexpr int MLP_SMEM = 1024 + 2 * LN_BYTES + W1_STAGES * W1_BYTES +
                         W2_STAGES * 2 * W2_HALF + (2 + 2 * W1_STAGES + 2 * W2_STAGES) * 8 +
                         MAX_H4 * 4;
static_assert(MLP_SMEM <= 232448, "over the H100's 227 KB of shared memory a block");

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// The byte offset in a 128-byte-swizzled box of row r, columns 8 j + 2 t
// (+1) of a bf16 pair: 16-byte chunk j stored at j ^ (r % 8).
__device__ __forceinline__ uint32_t pair_at(int r, int j, int t) {
  return r * 128 + ((j ^ (r & 7)) << 4) + 4 * t;
}

__device__ __forceinline__ void consumer_arrive(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// x, as a value the compiler cannot see through: a descriptor built from it
// each slice, plus constant offsets, is not hoisted out of the slice loop
// (the 48 descriptors of fc1's two W1 stages and the LN rows would
// otherwise stay in registers across the loop and push the fc2
// accumulator out of them).
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  uint64_t y;
  asm volatile("mov.b64 %0, %1;\n" : "=l"(y) : "l"(x));
  return y;
}

// Registers the compiler may not move across the asynchronous products.
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A warpgroup's walk over the hidden slices: the rings' shared memory
// and barriers, and warp 0's producer role.
struct Walk {
  const CUtensorMap* map_w1;
  const CUtensorMap* map_w2;
  const float* b1;  // in shared memory, fp32
  uint32_t ln, w1, w2, full1, empty1, full2, empty2;
  int slices, lane, t;
  bool producer;  // warp 0 (lane 0 issues)
};

// Warp 0: W1's slice c into its stage once both warpgroups have released
// the stage's slice before (none past the last slice). The whole warp
// waits and lane 0 issues, so that no lane runs a loop of its own between
// the warpgroup's products: the compiler then waited on every product
// alone.
__device__ __forceinline__ void load_w1(const Walk& m, int c) {
  if (c >= m.slices) return;
  const int s = c % W1_STAGES;
  if (c >= W1_STAGES) mbar_wait(m.empty1 + 8 * s, (c / W1_STAGES - 1) & 1);
  if (m.lane == 0) {
    mbar_expect_tx(m.full1 + 8 * s, W1_BYTES);
#pragma unroll
    for (int kc = 0; kc < MD / 64; ++kc)
      tma_load(m.w1 + s * W1_BYTES + kc * (W1_BYTES / 6), m.map_w1, m.full1 + 8 * s, kc * 64,
               c * HC);
  }
  __syncwarp();
}

// The same for W2's slice c.
__device__ __forceinline__ void load_w2(const Walk& m, int c) {
  if (c >= m.slices) return;
  const int s = c % W2_STAGES;
  if (c >= W2_STAGES) mbar_wait(m.empty2 + 8 * s, (c / W2_STAGES - 1) & 1);
  if (m.lane == 0) {
    mbar_expect_tx(m.full2 + 8 * s, 2 * W2_HALF);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      tma_load(m.w2 + s * 2 * W2_HALF + hh * W2_HALF, m.map_w2, m.full2 + 8 * s, c * HC,
               hh * (MD / 2));
  }
  __syncwarp();
}

// fc1 of slice c into acc1: issued and committed, not waited on.
__device__ __forceinline__ void fc1(const Walk& m, float* acc1, int c) {
  const int s = c % W1_STAGES;
  mbar_wait(m.full1 + 8 * s, (c / W1_STAGES) & 1);
  // a descriptor's start address is its low 14 bits, in 16-byte units
  const uint64_t da = opaque(smem_desc(m.ln, 16, 1024));
  const uint64_t db = opaque(smem_desc(m.w1 + s * W1_BYTES, 16, 1024));
  // the fence after the wait, beside its products: one before a loop or a
  // branch leaves the compiler fencing each product itself, and waiting
  // on each product alone
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < MD / 64; ++kc)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss32(acc1, da + (kc * KBOX + kk * 32) / 16, db + (kc * (W1_BYTES / 6) + kk * 32) / 16,
                 kc > 0 || kk > 0);
  wgmma_commit();
}

// b1 and the GELU of slice c, rounded into the A fragments a[8]: the pair
// (d[2 i], d[2 i + 1]) of the accumulator is register i of the fragments
// (a thread's rows g, g + 8, columns 8 j + 2 t, + 1).
__device__ __forceinline__ void gelu(const Walk& m, const float* acc1, uint32_t* a, int c) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 bb = *reinterpret_cast<const float2*>(m.b1 + c * HC + 8 * j + 2 * m.t);
    const __nv_bfloat162 lo =
        __floats2bfloat162_rn(gelu_erf(acc1[4 * j] + bb.x), gelu_erf(acc1[4 * j + 1] + bb.y));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(gelu_erf(acc1[4 * j + 2] + bb.x),
                                                    gelu_erf(acc1[4 * j + 3] + bb.y));
    a[2 * j] = *reinterpret_cast<const uint32_t*>(&lo);
    a[2 * j + 1] = *reinterpret_cast<const uint32_t*>(&hi);
  }
}

// Slice c: fc1 of slice c + 1 issued (MORE), then slice c's fc2 from its
// hidden fragments cur; the GELU of slice c + 1 into next runs while this
// fc2 is in flight. No branch holds a product: the compiler would wait on
// each product alone.
template <bool MORE>
__device__ __forceinline__ void step(const Walk& m, float (&acc2)[2][96], float* acc1,
                                     const uint32_t* cur, uint32_t* next, int c) {
  if constexpr (MORE) fc1(m, acc1, c + 1);
  const int s = c % W2_STAGES;
  mbar_wait(m.full2 + 8 * s, (c / W2_STAGES) & 1);
  const uint64_t db = opaque(smem_desc_sw64(m.w2 + s * 2 * W2_HALF));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HC / 16; ++kk)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      wgmma_rs192(acc2[hh], cur + 4 * kk, db + (hh * W2_HALF + kk * 32) / 16);
  wgmma_commit();
  if constexpr (MORE) {
    wgmma_wait<1>();  // the next fc1 and the slice before's fc2 are done
    pin<16>(acc1);
    consumer_arrive(m.empty1 + 8 * ((c + 1) % W1_STAGES), m.lane);
    if (c > 0) consumer_arrive(m.empty2 + 8 * ((c - 1) % W2_STAGES), m.lane);
    if (m.producer) {  // two slices ahead, into the stages just released
      load_w1(m, c + 3);
      load_w2(m, c + 2);
    }
    gelu(m, acc1, next, c + 1);
  } else {
    wgmma_wait<0>();
  }
}

__global__ void __launch_bounds__(MTHREADS, 1)
    mlp_chunked_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w1,
                       const __grid_constant__ CUtensorMap map_w2,
                       const __grid_constant__ CUtensorMap map_out, const bf16* __restrict__ x,
                       int M, const bf16* __restrict__ ls, const bf16* __restrict__ lb,
                       const bf16* __restrict__ b1, const bf16* __restrict__ b2, int H4,
                       float eps) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* lnp0 = smem_raw + (base - raw);
  const int cw = threadIdx.x >> 7, t128 = threadIdx.x & 127;
  const int warp = t128 >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Walk m;
  m.map_w1 = &map_w1;
  m.map_w2 = &map_w2;
  m.ln = base + cw * LN_BYTES;
  m.w1 = base + 2 * LN_BYTES;
  m.w2 = m.w1 + W1_STAGES * W1_BYTES;
  const uint32_t xfull = m.w2 + W2_STAGES * 2 * W2_HALF;  // one per warpgroup
  m.full1 = xfull + 2 * 8;
  m.empty1 = m.full1 + W1_STAGES * 8;
  m.full2 = m.empty1 + W1_STAGES * 8;
  m.empty2 = m.full2 + W2_STAGES * 8;
  float* b1s = reinterpret_cast<float*>(lnp0 + (m.empty2 + W2_STAGES * 8 - base));
  m.b1 = b1s;
  m.slices = H4 / HC;
  m.lane = lane;
  m.t = t;
  m.producer = threadIdx.x < 32;
  const int m0 = blockIdx.x * MBM;
  uint8_t* lnp = lnp0 + cw * LN_BYTES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) mbar_init(xfull + 8 * i, 1);
    for (int s = 0; s < W1_STAGES; ++s) {
      mbar_init(m.full1 + 8 * s, 1);
      mbar_init(m.empty1 + 8 * s, 8);  // one arrival per warp
    }
    for (int s = 0; s < W2_STAGES; ++s) {
      mbar_init(m.full2 + 8 * s, 1);
      mbar_init(m.empty2 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < H4; i += MTHREADS) b1s[i] = __bfloat162float(b1[i]);
  __syncthreads();
  if (m.producer) {
    // each warpgroup's x rows, then the weights' first slices
    if (lane == 0)
      for (int w = 0; w < 2; ++w) {
        mbar_expect_tx(xfull + 8 * w, LN_BYTES);
        for (int kc = 0; kc < MD / 64; ++kc)
          tma_load(base + w * LN_BYTES + kc * KBOX, &map_x, xfull + 8 * w, kc * 64, m0 + w * 64);
      }
    __syncwarp();
    load_w1(m, 0);
    load_w1(m, 1);
    load_w2(m, 0);
    load_w2(m, 1);
  }

  // LN2 of the warpgroup's rows in place: a warp a row at a time, 12
  // elements a lane (4 at column 4 (lane + 32 c)); rows past M are zeros
  {
    float gm[3][4], bt[3][4];
    uint32_t at[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int col = 4 * (lane + 32 * c);
      const float2 g01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ls + col));
      const float2 g23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ls + col + 2));
      const float2 b01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(lb + col));
      const float2 b23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(lb + col + 2));
      gm[c][0] = g01.x, gm[c][1] = g01.y, gm[c][2] = g23.x, gm[c][3] = g23.y;
      bt[c][0] = b01.x, bt[c][1] = b01.y, bt[c][2] = b23.x, bt[c][3] = b23.y;
      // box col / 64, 16-byte chunk (col % 64) / 8, its half (col / 4) % 2
      at[c] = (col >> 6) * KBOX + ((((col & 63) >> 3)) << 4) + ((col >> 2) & 1) * 8;
    }
    mbar_wait(xfull + 8 * cw, 0);
    for (int row = warp * 16; row < warp * 16 + 16; ++row) {
      float f[3][4];
      uint2* p[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        // the chunk's swizzled place in the row: chunk ^ (row % 8)
        p[c] = reinterpret_cast<uint2*>(lnp + row * 128 + (at[c] ^ ((row & 7) << 4)));
        const uint2 v = *p[c];
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
        const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
        f[c][0] = a.x, f[c][1] = a.y, f[c][2] = b.x, f[c][3] = b.y;
      }
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) sum += (f[c][0] + f[c][1]) + (f[c][2] + f[c][3]);
      const float mu = warp_sum(sum) / MD;
      float q = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) q += (f[c][i] - mu) * (f[c][i] - mu);
      const float rs = 1.0f / sqrtf(warp_sum(q) / MD + eps);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) y[i] = (f[c][i] - mu) * rs * gm[c][i] + bt[c][i];
        const __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
        *p[c] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                           *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
  }
  fence_async_smem();  // the LN rows into the async proxy, for the wgmmas
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");

  float acc2[2][96];   // fc2: columns 0 .. 191 and 192 .. 383
  float acc1[16];      // fc1 of one slice: [64, 32]
  uint32_t hid[2][8];  // the rounded hidden of two slices, as fc2's A fragments
#pragma unroll
  for (int i = 0; i < 96; ++i) acc2[0][i] = acc2[1][i] = 0.f;
  fc1(m, acc1, 0);
  wgmma_wait<0>();
  pin<16>(acc1);
  consumer_arrive(m.empty1, lane);
  if (m.producer) load_w1(m, 2);
  gelu(m, acc1, hid[0], 0);
  // two slices an iteration, so that each slice's fragments have their
  // registers; the last one or two slices after the loop
  int c = 0;
  for (; c + 2 < m.slices; c += 2) {
    step<true>(m, acc2, acc1, hid[0], hid[1], c);
    step<true>(m, acc2, acc1, hid[1], hid[0], c + 1);
  }
  if (c + 1 < m.slices) {
    step<true>(m, acc2, acc1, hid[0], hid[1], c);
    step<false>(m, acc2, acc1, hid[1], hid[0], c + 1);
  } else {
    step<false>(m, acc2, acc1, hid[0], hid[1], c);
  }
  pin<96>(acc2[0]);
  pin<96>(acc2[1]);

  // out = x + acc + b2, rounded once, into the LN rows' shared memory
  // (every fc1 has read them), then TMA stores
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  const int lr = warp * 16 + g;
  const int row = m0 + cw * 64 + lr;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int jn = 0; jn < 24; ++jn) {
      const int col = hh * (MD / 2) + 8 * jn + 2 * t;
      const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + col));
      const float* d = acc2[hh] + 4 * jn;
      float2 x0 = make_float2(0.f, 0.f), x1 = x0;
      if (row < M)
        x0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(x + static_cast<size_t>(row) * MD + col));
      if (row + 8 < M)
        x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            x + static_cast<size_t>(row + 8) * MD + col));
      const __nv_bfloat162 o0 = __floats2bfloat162_rn((x0.x + d[0]) + bb.x, (x0.y + d[1]) + bb.y);
      const __nv_bfloat162 o1 = __floats2bfloat162_rn((x1.x + d[2]) + bb.x, (x1.y + d[3]) + bb.y);
      uint8_t* box = lnp + (col >> 6) * KBOX;
      const int j = (col & 63) >> 3;
      *reinterpret_cast<__nv_bfloat162*>(box + pair_at(lr, j, t)) = o0;
      *reinterpret_cast<__nv_bfloat162*>(box + pair_at(lr + 8, j, t)) = o1;
    }
  fence_async_smem();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  if (t128 == 0) {
    for (int kc = 0; kc < MD / 64; ++kc)
      tma_store_2d(&map_out, m.ln + kc * KBOX, kc * 64, m0 + cw * 64);
    tma_store_wait();
  }
}

}  // namespace
}  // namespace trk

// out [M, 384] = x + fc2(gelu(fc1(LN x))) in bf16 (see above): x, out
// [M, 384]; ls, lb, b2 [384]; w1 [H4, 384]; b1 [H4]; w2 [384, H4]; all
// bf16, contiguous, 16-byte aligned (the caller checks). K must be 384 and
// H4 a multiple of 32 up to 1536. Returns the cudaError_t of the launch.
extern "C" int tr_mlp_chunked(const void* x, int M, int K, const void* ls, const void* lb,
                              const void* w1, const void* b1, const void* w2, const void* b2,
                              int H4, float eps, void* out, void* stream) {
  using namespace trk;
  if (M == 0) return 0;
  if (K != MD || H4 < HC || H4 % HC != 0 || H4 > MAX_H4)
    return static_cast<int>(cudaErrorInvalidValue);
  // first: the context the tensor maps need (sm90.cuh encoder)
  cudaError_t err = cudaFuncSetAttribute(mlp_chunked_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, MLP_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_x, map_w1, map_w2, map_out;
  const cuuint64_t row = MD * 2, hrow = static_cast<cuuint64_t>(H4) * 2;
  const cuuint64_t x_dims[2] = {MD, static_cast<cuuint64_t>(M)};
  const cuuint32_t x_box[2] = {64, 64};
  err = bf16_map(&map_x, x, 2, x_dims, &row, x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = bf16_map(&map_out, out, 2, x_dims, &row, x_box, CU_TENSOR_MAP_SWIZZLE_128B);
  const cuuint64_t w1_dims[2] = {MD, static_cast<cuuint64_t>(H4)};
  const cuuint32_t w1_box[2] = {64, HC};
  if (err == cudaSuccess)
    err = bf16_map(&map_w1, w1, 2, w1_dims, &row, w1_box, CU_TENSOR_MAP_SWIZZLE_128B);
  const cuuint64_t w2_dims[2] = {static_cast<cuuint64_t>(H4), MD};
  const cuuint32_t w2_box[2] = {HC, MD / 2};
  if (err == cudaSuccess)
    err = bf16_map(&map_w2, w2, 2, w2_dims, &hrow, w2_box, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return static_cast<int>(err);
  using B = __nv_bfloat16;
  const int blocks = (M + MBM - 1) / MBM;
  mlp_chunked_kernel<<<blocks, MTHREADS, MLP_SMEM, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w1, map_w2, map_out, static_cast<const B*>(x), M, static_cast<const B*>(ls),
      static_cast<const B*>(lb), static_cast<const B*>(b1), static_cast<const B*>(b2), H4, eps);
  return static_cast<int>(cudaGetLastError());
}

// The kernel's rows a block, hidden units a slice and dynamic shared
// memory a block, for the host: out[3].
extern "C" int tr_mlp_chunked_config(int* out) {
  out[0] = trk::MBM, out[1] = trk::HC, out[2] = trk::MLP_SMEM;
  return 0;
}
