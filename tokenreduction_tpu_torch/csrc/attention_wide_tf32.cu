// The fp32 softmax attention at any width (up to WIDE_MAXN = 2048 tokens)
// at head dim 64, 3xTF32 on the tensor cores (mma.sync m16n8k8,
// attention_tf32.cuh): the square forward with every option (bias, mask,
// row0, colsum) and the rectangular one (RECT), for N (or M) above 256,
// where short_attention.cu's short_attention_tf32_kernel, which holds the
// head's Q, K and V in shared memory and a row of S in a pair of warps'
// registers, stops. The host launches it only above 256 tokens: every fp32
// launch at N <= 256 stays short_attention.cu's.
//
// It replaces, in fp32 above 256 tokens (the parity dtype, validate's
// default), the attention of the TPU kernels
// tokenreduction_tpu/ops/flash_attention.py fused_attention (:183),
// fused_attention_qkv (:313), fused_block_attention (:660),
// fused_rect_attention (:817) and fused_rect_block (:925), whose fp32 dots
// run on the MXU at the kernels' pinned DEFAULT precision. (No fp32
// backward above 256 tokens: a training attention half there keeps the
// plain composition.)
//
// Arithmetic: short_attention_tf32_kernel's (logits = q.k * scale + bias,
// -FLT_MAX at a masked pair, -inf past N; exp less the exact row max; O =
// the unnormalised P V times 1/sum; each product lo.hi + hi.lo + hi.hi,
// the small products of a slice first), with the keys walked in tiles.
//
// Design. One block of 4 warps per (image, head) walks the query tiles of
// 64 rows, a warp 16 rows; each query tile is copied by cp.async (RECT:
// row m from query row ids[b, m]; an id outside 0..N-1 traps), then the
// 64-key tiles of K (and V) stream through a ring of two stages by
// cp.async (rows padded to 68 floats, as attention_tf32.cuh's fragment
// loads read them), twice: pass 1 S = Q K^T and the row statistics online
// (a running max, the sum rescaled by exp(old - new)); pass 2 S again, P =
// exp(x - the final max), row0, colsum (a warp's 16 rows summed by
// shuffles, added to the warp's row of shared memory tile after tile, the
// 4 rows added in order at the end: no atomics) and O += P V in registers
// over the key tiles in order, then O / sum written from registers.
//
// What bounds it at B = 256, H = 6, N = 577: the products, 130.9 GFLOP,
// 392.8 in 3xTF32, 0.794 ms at the H100's 494.7 TFLOP/s of dense TF32;
// q, k, v and the output are 907 MB, 0.271 ms at 3.35 TB/s. mma.sync
// reaches a part of that rate, and S is computed twice: a simple form that
// is right, for later work to make fast.
#include "attention_tf32.cuh"

namespace trk {
namespace {

constexpr int WIDE_MAXN = 2048;
constexpr int W_ROWS = 64;  // rows of a query tile, keys of a key tile
constexpr int W_THREADS = 128;  // 4 warps, 16 query rows each
constexpr int W_TILE = W_ROWS * TC_LD;  // floats of a tile in shared memory
constexpr int W_RING = 2;

__host__ __device__ constexpr int wide_keys(int n) { return (n + W_ROWS - 1) / W_ROWS * W_ROWS; }

// the query tile, W_RING stages of a K and a V tile; the bias, the keys'
// validity and 4 warps' column sums [keys]; the query rows' validity [64]
constexpr size_t wide_tf32_smem(int n) {
  return sizeof(float) * ((1 + 2 * W_RING) * static_cast<size_t>(W_TILE) +
                          6 * static_cast<size_t>(wide_keys(n)) + W_ROWS);
}
static_assert(wide_tf32_smem(WIDE_MAXN) <= 232448, "over the H100's 227 KB of shared memory a block");

// MASK: the validity mask (one byte per token, the JAX pair mask). RECT
// (with MASK): out row m is query row ids[b, m] over all N keys; bias,
// row0 and colsum null. Otherwise M = N, and bias, row0 and colsum may be
// null.
template <bool MASK, bool RECT>
__global__ void __launch_bounds__(W_THREADS)
    attention_wide_tf32_kernel(Heads<const float> q, Heads<const float> k, Heads<const float> v,
                               Heads<float> out, const float* __restrict__ bias,
                               const unsigned char* __restrict__ mask, const int* __restrict__ ids,
                               float* __restrict__ row0, float* __restrict__ colsum, int N, int M,
                               int H, float scale) {
  static_assert(MASK || !RECT, "the rectangular forward takes a mask");
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = wide_keys(N) / W_ROWS, keys = nt * W_ROWS;
  const int nq = RECT ? M : N, ntq = (nq + W_ROWS - 1) / W_ROWS;
  float* Qs = reinterpret_cast<float*>(smem);  // [64][TC_LD]
  float* ring = Qs + W_TILE;  // stage i: K at ring + 2 i W_TILE, V after it
  float* bs = ring + 2 * W_RING * W_TILE;  // the bias of each key, 0 without one or past N
  float* kok = bs + keys;                  // 1 for a valid key < N, else 0 (MASK)
  float* csw = kok + keys;                 // [4][keys]
  float* qok = csw + 4 * keys;             // [64] 1 for a valid query row (MASK)
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int* irow = RECT ? ids + static_cast<size_t>(b) * M : nullptr;
  // the ring's items: for each query tile, pass 1's key tiles (K), then
  // pass 2's (K and V); every thread copies its share and commits a group
  const int total = ntq * 2 * nt;
  const auto issue = [&](int i) {
    if (i < total) {
      const int r = i % (2 * nt), kt = r % nt;
      const bool pv = r >= nt;
      float* Ks = ring + (i % W_RING) * 2 * W_TILE;
      for (int e = tid; e < W_ROWS * (HD / 4); e += W_THREADS) {
        const int n = e / (HD / 4), c = (e % (HD / 4)) * 4, key = kt * W_ROWS + n;
        const bool in = key < N;  // rows past N are zero-filled
        const int src = in ? key : 0;
        cp_async16(Ks + n * TC_LD + c, k.row(b, h, src) + c, in);
        if (pv) cp_async16(Ks + W_TILE + n * TC_LD + c, v.row(b, h, src) + c, in);
      }
    }
    cp_async_commit();
  };

  issue(0);
  for (int j = tid; j < keys; j += W_THREADS) {
    bs[j] = bias != nullptr && j < N ? bias[static_cast<size_t>(b) * N + j] : 0.f;
    kok[j] = j < N && (!MASK || mask[static_cast<size_t>(b) * N + j]) ? 1.f : 0.f;
  }
  if (!RECT && colsum != nullptr)
    for (int j = tid; j < 4 * keys; j += W_THREADS) csw[j] = 0.f;

  const int la = warp * 16 + g, lb = la + 8;  // this thread's rows of the tile
  int item = 0;
  for (int qi = 0; qi < ntq; ++qi) {
    // the query tile (read by no product since the last item's barrier)
    for (int e = tid; e < W_ROWS * (HD / 4); e += W_THREADS) {
      const int n = e / (HD / 4), c = (e % (HD / 4)) * 4, m = qi * W_ROWS + n;
      const bool in = m < nq;
      int src = in ? m : 0;
      if (RECT && in) {
        src = irow[m];
        if (static_cast<unsigned>(src) >= static_cast<unsigned>(N)) __trap();
      }
      cp_async16(Qs + n * TC_LD + c, q.row(b, h, src) + c, in);
    }
    cp_async_commit();
    if (MASK && tid < W_ROWS) {
      const int m = qi * W_ROWS + tid;
      bool ok = false;
      if (m < nq) {
        const int src = RECT ? irow[m] : m;
        if (RECT && static_cast<unsigned>(src) >= static_cast<unsigned>(N)) __trap();
        ok = mask[static_cast<size_t>(b) * N + src];
      }
      qok[tid] = ok ? 1.f : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    const int ra = qi * W_ROWS + la, rb = qi * W_ROWS + lb;  // rows past nq are zeros
    const bool oka = !MASK || qok[la] > 0.f, okb = !MASK || qok[lb] > 0.f;
    float mxa = -INFINITY, mxb = -INFINITY, suma = 0.f, sumb = 0.f, ria = 0.f, rib = 0.f;
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    for (int pass = 0; pass < 2; ++pass) {
      for (int kt = 0; kt < nt; ++kt, ++item) {
        issue(item + 1);
        cp_async_wait<1>();  // this item's tiles have landed
        __syncthreads();
        const float* Ks = ring + (item % W_RING) * 2 * W_TILE;
        const float* Vs = Ks + W_TILE;
        float s[8][4];
        head_dim_products<8>(s, Qs + la * TC_LD + t, Ks + g * TC_LD + t);
        // the logits: s[j][e] is row ra and s[j][2 + e] row rb, at key k0 +
        // 8 j + 2 t + e
        const int k0 = kt * W_ROWS;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + 2 * t + e;
            const bool in = key < N;
            float xa = s[j][e] * scale + bs[key], xb = s[j][2 + e] * scale + bs[key];
            if constexpr (MASK) {
              const bool kv = kok[key] > 0.f;
              if (!(oka && kv)) xa = -FLT_MAX;  // the JAX pair mask
              if (!(okb && kv)) xb = -FLT_MAX;
            }
            s[j][e] = in ? xa : -INFINITY;
            s[j][2 + e] = in ? xb : -INFINITY;
          }
        if (pass == 0) {
          // the running statistics (every tile has a key < N: the new max
          // is finite, and a first max of -inf scales a zero sum by 0)
          float ta = -INFINITY, tb = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              ta = fmaxf(ta, s[j][e]);
              tb = fmaxf(tb, s[j][2 + e]);
            }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            ta = fmaxf(ta, __shfl_xor_sync(0xffffffffu, ta, off));
            tb = fmaxf(tb, __shfl_xor_sync(0xffffffffu, tb, off));
          }
          const float na = fmaxf(mxa, ta), nb = fmaxf(mxb, tb);
          float pa = 0.f, pb = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              pa += expf(s[j][e] - na);
              pb += expf(s[j][2 + e] - nb);
            }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            pa += __shfl_xor_sync(0xffffffffu, pa, off);
            pb += __shfl_xor_sync(0xffffffffu, pb, off);
          }
          suma = suma * expf(mxa - na) + pa;
          sumb = sumb * expf(mxb - nb) + pb;
          mxa = na;
          mxb = nb;
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              s[j][e] = expf(s[j][e] - mxa);
              s[j][2 + e] = expf(s[j][2 + e] - mxb);
            }
          if (!RECT && row0 != nullptr && ra == 0) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int key = k0 + 8 * j + 2 * t + e;
                if (key < N) row0[static_cast<size_t>(bh) * N + key] = s[j][e] * ria;
              }
          }
          if (!RECT && colsum != nullptr) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float c = s[j][e] * ria + s[j][2 + e] * rib;
#pragma unroll
                for (int off = 4; off < 32; off <<= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
                if (g == 0) csw[warp * keys + k0 + 8 * j + 2 * t + e] += c;  // keys past N: 0
              }
          }
          // O += P V: A = P's registers (k index t <- key 2t, t + 4 <- key
          // 2t + 1), V's rows read in that order
#pragma unroll
          for (int big = 0; big < 2; ++big)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float p[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
              uint32_t ph[4], pl[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) split_tf32(p[i], ph[i], pl[i]);
              const float* vr = Vs + (8 * j + 2 * t) * TC_LD + g;
#pragma unroll
              for (int n = 0; n < HD / 8; ++n) {
                if (big)
                  mma_big(o[n], ph, vr[8 * n], vr[TC_LD + 8 * n]);
                else
                  mma_small(o[n], ph, pl, vr[8 * n], vr[TC_LD + 8 * n]);
              }
            }
        }
        __syncthreads();  // the stage is read by no thread any more
      }
      if (pass == 0) {
        ria = ra < nq ? 1.0f / suma : 0.f;  // rows past the last take no part
        rib = rb < nq ? 1.0f / sumb : 0.f;
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (ra < nq)
        *reinterpret_cast<float2*>(out.row(b, h, ra) + col) = make_float2(o[n][0] * ria, o[n][1] * ria);
      if (rb < nq)
        *reinterpret_cast<float2*>(out.row(b, h, rb) + col) = make_float2(o[n][2] * rib, o[n][3] * rib);
    }
  }

  if (!RECT && colsum != nullptr) {
    __syncthreads();
    for (int j = tid; j < N; j += W_THREADS)
      colsum[static_cast<size_t>(bh) * N + j] =
          ((csw[j] + csw[keys + j]) + csw[2 * keys + j]) + csw[3 * keys + j];
  }
}

template <bool MASK, bool RECT>
int launch_wide_tf32(const Heads<const float>& q, const Heads<const float>& k,
                     const Heads<const float>& v, const Heads<float>& out, const float* bias,
                     const unsigned char* mask, const int* ids, float* row0, float* colsum, int B,
                     int N, int M, int H, float scale, cudaStream_t s) {
  const auto kernel = attention_wide_tf32_kernel<MASK, RECT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(wide_tf32_smem(WIDE_MAXN)));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, W_THREADS, wide_tf32_smem(N), s>>>(q, k, v, out, bias, mask, ids, row0, colsum,
                                                     N, M, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace trk

// Returns the cudaError_t of the launch (0 on success): the contract of
// short_attention.cu's tr_short_attention for fp32 (q, k, v [B, H, N, 64],
// out [B, H, M, 64], their strides, bias, mask, ids, row0, colsum), for N
// and M up to 2048.
extern "C" int tr_attention_wide_tf32(const void* q, const void* k, const void* v, void* out,
                                      const long long* strides, const void* bias, const void* mask,
                                      const void* ids, void* row0, void* colsum, int B, int N,
                                      int M, int H, float scale, void* stream) {
  using namespace trk;
  const bool rect = ids != nullptr, masked = mask != nullptr;
  if (N < 1 || N > WIDE_MAXN || M < 1 || M > WIDE_MAXN || H < 1 || B < 0 || (!rect && M != N) ||
      (rect && (!masked || bias != nullptr || row0 != nullptr || colsum != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  const unsigned char* mp = static_cast<const unsigned char*>(mask);
  const int* ip = static_cast<const int*>(ids);
  float* r0 = static_cast<float*>(row0);
  float* cs = static_cast<float*>(colsum);
  const auto qh = heads<const float>(q, strides, 0), kh = heads<const float>(k, strides, 1);
  const auto vh = heads<const float>(v, strides, 2);
  const auto oh = heads<float>(out, strides, 3);
  if (rect)
    return launch_wide_tf32<true, true>(qh, kh, vh, oh, bp, mp, ip, r0, cs, B, N, M, H, scale, s);
  return masked ? launch_wide_tf32<true, false>(qh, kh, vh, oh, bp, mp, ip, r0, cs, B, N, M, H,
                                                scale, s)
                : launch_wide_tf32<false, false>(qh, kh, vh, oh, bp, mp, ip, r0, cs, B, N, M, H,
                                                 scale, s);
}

// The dynamic shared memory a block of the wide fp32 forward takes at n
// keys (both variants), for the host; 0 outside 1..2048.
extern "C" int tr_attention_wide_tf32_smem(int n) {
  if (n < 1 || n > trk::WIDE_MAXN) return 0;
  return static_cast<int>(trk::wide_tf32_smem(n));
}
