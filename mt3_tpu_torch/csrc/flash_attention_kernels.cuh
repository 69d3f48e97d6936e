// Kernel C's three kernels (forward; dQ with di; dK/dV), templated on a
// product policy, Ops, that fixes the element type of the tiles and how a
// 16-row tile of products runs on the tensor cores:
//   * flash_attention_tc.cu, Bf16Ops: bf16 tiles, mma.sync.m16n8k16 (bf16
//     in, float32 accumulate), fragments by ldmatrix; p and dS rounded to
//     bf16 before their products.
//   * flash_attention.cu, Tf32x3Ops: float32 tiles, each float32 product
//     as three mma.sync.m16n8k8 TF32 products (hi lo + lo hi, then hi hi),
//     fragments by ld.shared; p and dS stay float32.
// Both compute the function that ops/flash_attention.py sets out (for q
// [lq, 64], k and v [lk, 64] of one (batch, head)):
//   s   = q k^T * sm_scale, masked entries + kMaskValue (causal: col > row)
//   o   = p v / rowsum(p),  p = exp(s - rowmax)
//   lse = rowmax(s) + log(rowsum(p))                       float32
//   di  = rowsum(o * dO)                                   float32
//   p   = exp(s - lse), dP = dO v^T, dS = p * (dP - di) * sm_scale
//   dV  = p^T dO,  dK = dS^T q,  dQ = dS k
// every product summed in float32.  Scores are kept in log2 units (s *
// sm_scale * log2 e) so that each exp is one ex2; the mask constant is
// added in those units, which zeroes the same entries.
//
// Design (FlashAttention-2's, on mma.sync).
//   * One block of 4 warps owns a tile of rows: 64 * Ops::kFwdM query rows
//     in the forward, 64 query rows in dQ, 64 key rows in dK/dV.  Each warp
//     owns 16 rows (kFwdM tiles of 16 in the forward, so that each K and V
//     fragment feeds kFwdM products) and loops over 64-row tiles of the
//     other side.  Causal tiles wholly above the diagonal are skipped;
//     ragged edges are zero-filled and masked.
//   * The forward's online softmax takes the max of the raw scores on
//     interior tiles and folds sm_scale * log2 e into the exp's FFMA
//     (FA2's exp2(s * scale - max)).
//   * Tiles are 64 rows of 64 elements in shared memory, their 16-byte
//     chunks XOR-swizzled by the row (Ops::swz), loaded with cp.async (16
//     bytes a thread) into a ring of two stages: tile i + 1 loads while
//     tile i is multiplied.  The block's own tiles (q in the forward; q
//     and dO in dQ; k and v in dK/dV) are the A operands of every product
//     with a tile the loop walks over (Ops::A).
//   * p and dS never leave registers: the float32 S and dP accumulator
//     fragments are the A operands of the next product.  dK/dV computes
//     S^T = k q^T and dP^T = v dO^T with key rows as fragment rows, so p^T
//     and dS^T are A operands for dV and dK as they stand.
//   * di is computed by the dQ kernel for its own rows from o and dO
//     (loaded once per block) and written for the dK/dV kernel, which runs
//     after it.  dK/dV and dQ stay separate kernels with no atomics, as in
//     the stock kernel: the result is deterministic.
// Left for later: wgmma (the full tensor-core rate needs it), TMA loads and
// warp specialisation (a producer warp feeding consumer warpgroups).
//
// The kernels allocate nothing, launch on the caller's stream and do not
// synchronise.  Every tensor's rows must start on 16-byte boundaries (the
// wrapper checks it).

#pragma once

#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace flash {

constexpr int kD = 64;                  // head dim
constexpr int kRows = 64;               // rows of every tile
constexpr int kWarps = 4;               // each owns 16 rows of the block's tile
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = kRows * kD;       // elements of one tile
constexpr float kMaskValue = -0.7f * FLT_MAX;  // stock DEFAULT_MASK_VALUE
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Tiles and fragments
//
// Accumulator fragments (both policies): a 16 x 64 product is acc[8][4],
// 8 blocks of 8 columns; lane = 4 * g + t holds rows g (c0, c1) and g + 8
// (c2, c3) at columns 2t, 2t + 1 of each block.
// ---------------------------------------------------------------------------

// Rows [row0, row0 + 64) of a [len, 64] matrix with the given row stride
// into a tile, asynchronously; rows past len are zero.
template <class Ops>
__device__ __forceinline__ void load_tile(typename Ops::T* tile,
                                          const typename Ops::T* src,
                                          int64_t row_stride, int row0,
                                          int len) {
  constexpr int kPer = 16 / sizeof(typename Ops::T);  // elements a chunk
  constexpr int kChunks = kD / kPer;                  // chunks a row
  const int c = threadIdx.x % kChunks;
  for (int r = threadIdx.x / kChunks; r < kRows; r += kThreads / kChunks) {
    const int row = row0 + r;
    const bool valid = row < len;
    cp_async16(tile + Ops::swz(r, kPer * c),
               valid ? src + row * row_stride + kPer * c : src, valid);
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// The one-row-tile forms of the policy's products.
template <class Ops>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const typename Ops::A& a,
                                        const typename Ops::T* tile,
                                        int lane) {
  Ops::template mma_abt<1>(
      reinterpret_cast<float(&)[1][8][4]>(acc),
      reinterpret_cast<const typename Ops::A(&)[1]>(a), tile, lane);
}
template <class Ops>
__device__ __forceinline__ void mma_xb(float (&acc)[8][4],
                                       const float (&x)[8][4],
                                       const typename Ops::T* tile,
                                       int lane) {
  Ops::template mma_xb<1>(reinterpret_cast<float(&)[1][8][4]>(acc),
                          reinterpret_cast<const float(&)[1][8][4]>(x), tile,
                          lane);
}

// Writes rows g and g + 8 of a 16 x 64 accumulator (rows r0.. of the
// output) in the policy's type, rows past len skipped.
template <class Ops>
__device__ __forceinline__ void store_rows(typename Ops::T* base,
                                           int64_t row_stride, int r0,
                                           int len, const float (&acc)[8][4],
                                           const float (&scale)[2],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= len) continue;
    typename Ops::T* out = base + row * row_stride + 2 * t;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      Ops::store2(out + 8 * nb, acc[nb][2 * i] * scale[i],
                  acc[nb][2 * i + 1] * scale[i]);
  }
}

// Tile order of the forward and dQ grids: the heaviest causal tiles (the
// last query rows) first.
__device__ __forceinline__ int query_tile() {
  return gridDim.y - 1 - blockIdx.y;
}

// ---------------------------------------------------------------------------
// Forward: one block per (batch * head, 64 * Ops::kFwdM query rows).
// ---------------------------------------------------------------------------

// Online-softmax update of one 16-row tile by one key tile, rows g and
// g + 8: s holds scores in log2 units (kRaw: raw scores, to be scaled by
// scale2 > 0), m the running max, l this thread's share of the running
// sums, acc the output accumulator.  On return s holds p = exp2(x - max).
template <bool kRaw>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2],
                                             float (&l)[2],
                                             float (&acc)[8][4],
                                             float scale2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      mx = fmaxf(mx, fmaxf(s[nb][2 * i], s[nb][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (kRaw) mx *= scale2;
    // The first tile holds column 0, visible from every row, so mx is
    // finite from here on and exp2(m - mx) is 0 on the first tile.
    mx = fmaxf(mx, m[i]);
    const float alpha = exp2_approx(m[i] - mx);
    m[i] = mx;
    float sum = 0.f;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        const float p = exp2_approx(kRaw ? fmaf(s[nb][e], scale2, -mx)
                                         : s[nb][e] - mx);
        s[nb][e] = p;
        sum += p;
      }
    l[i] = l[i] * alpha + sum;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      acc[nb][2 * i] *= alpha;
      acc[nb][2 * i + 1] *= alpha;
    }
  }
}

template <class Ops>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashArgs a) {
  using T = typename Ops::T;
  constexpr int M = Ops::kFwdM;
  constexpr int kFwdRows = kRows * M;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);   // kFwdRows rows
  T* k_s = q_s + M * kTile;   // two stages
  T* v_s = k_s + 2 * kTile;   // two stages

  const int bh = blockIdx.x;
  const int q0 = query_tile() * kFwdRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + 16 * M * warp;  // this warp's first query row
  const T* qg = head_base<const T>(a.q, a.q_st, bh, a.heads);
  const T* kg = head_base<const T>(a.k, a.k_st, bh, a.heads);
  const T* vg = head_base<const T>(a.v, a.v_st, bh, a.heads);

  const int k_end = a.causal ? min(a.lk, q0 + kFwdRows) : a.lk;
  const int n_tiles = (k_end + kRows - 1) / kRows;

#pragma unroll
  for (int mi = 0; mi < M; ++mi)
    load_tile<Ops>(q_s + mi * kTile, qg, a.q_st.row, q0 + mi * kRows, a.lq);
  load_tile<Ops>(k_s, kg, a.k_st.row, 0, a.lk);
  load_tile<Ops>(v_s, vg, a.v_st.row, 0, a.lk);
  cp_async_commit();

  typename Ops::A qf[M];
  float acc[M][8][4];
  // Running max (log2 units) and this thread's share of the row sums, for
  // rows g and g + 8 of each row tile.
  float m[M][2], l[M][2];
#pragma unroll
  for (int mi = 0; mi < M; ++mi) {
    zero(acc[mi]);
    m[mi][0] = m[mi][1] = -INFINITY;
    l[mi][0] = l[mi][1] = 0.f;
  }
  const float scale2 = a.sm_scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      const int stage = (it + 1) & 1;
      load_tile<Ops>(k_s + stage * kTile, kg, a.k_st.row, (it + 1) * kRows,
                     a.lk);
      load_tile<Ops>(v_s + stage * kTile, vg, a.v_st.row, (it + 1) * kRows,
                     a.lk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile it (and q) have landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int mi = 0; mi < M; ++mi)
        Ops::load_a(qf[mi], q_s, 16 * (M * warp + mi), lane);
    }
    const T* ks = k_s + (it & 1) * kTile;
    const T* vs = v_s + (it & 1) * kTile;
    const int k0 = it * kRows;

    float s[M][8][4];
#pragma unroll
    for (int mi = 0; mi < M; ++mi) zero(s[mi]);
    Ops::template mma_abt<M>(s, qf, ks, lane);

    // Interior tiles with a positive scale take the max of the raw scores
    // and fold the scale into each exp's FFMA; edge tiles are scaled and
    // masked first.
    const bool edge = k0 + kRows > a.lk || (a.causal && k0 + kRows - 1 > w0);
    if (!edge && scale2 > 0.f) {
#pragma unroll
      for (int mi = 0; mi < M; ++mi)
        softmax_tile<true>(s[mi], m[mi], l[mi], acc[mi], scale2);
    } else {
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
#pragma unroll
        for (int nb = 0; nb < 8; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[mi][nb][e] * scale2;
            if (edge) {
              const int row = w0 + 16 * mi + g + 8 * (e >> 1);
              const int col = k0 + 8 * nb + 2 * t + (e & 1);
              if (a.causal && col > row) x += kMaskValue;
              if (col >= a.lk) x = -INFINITY;
            }
            s[mi][nb][e] = x;
          }
        softmax_tile<false>(s[mi], m[mi], l[mi], acc[mi], scale2);
      }
    }

    Ops::template mma_xb<M>(acc, s, vs, lane);
    __syncthreads();  // this stage is free for tile it + 2
  }

  T* og = head_base<T>(a.o, a.o_st, bh, a.heads);
#pragma unroll
  for (int mi = 0; mi < M; ++mi) {
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[mi][i] += __shfl_xor_sync(0xffffffffu, l[mi][i], 1);
      l[mi][i] += __shfl_xor_sync(0xffffffffu, l[mi][i], 2);
      inv[i] = l[mi][i] == 0.f ? 1.f : 1.f / l[mi][i];
      const int row = w0 + 16 * mi + g + 8 * i;
      if (t == 0 && row < a.lq)
        a.lse[static_cast<int64_t>(bh) * a.lq + row] =
            (m[mi][i] + log2f(l[mi][i])) * kLn2;
    }
    store_rows<Ops>(og, a.o_st.row, w0 + 16 * mi, a.lq, acc[mi], inv, lane);
  }
}

// ---------------------------------------------------------------------------
// Backward, part 1: di and dQ.  One block per (batch * head, 64 query rows).
// ---------------------------------------------------------------------------
template <class Ops>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const FlashArgs a) {
  using T = typename Ops::T;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* do_s = q_s + kTile;
  T* o_s = do_s + kTile;
  T* k_s = o_s + kTile;       // two stages
  T* v_s = k_s + 2 * kTile;   // two stages
  float* di_s = reinterpret_cast<float*>(v_s + 2 * kTile);  // [64]

  const int bh = blockIdx.x;
  const int q0 = query_tile() * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + 16 * warp;
  const T* kg = head_base<const T>(a.k, a.k_st, bh, a.heads);
  const T* vg = head_base<const T>(a.v, a.v_st, bh, a.heads);

  const int k_end = a.causal ? min(a.lk, q0 + kRows) : a.lk;
  const int n_tiles = (k_end + kRows - 1) / kRows;

  load_tile<Ops>(q_s, head_base<const T>(a.q, a.q_st, bh, a.heads),
                 a.q_st.row, q0, a.lq);
  load_tile<Ops>(do_s, head_base<const T>(a.dout, a.dout_st, bh, a.heads),
                 a.dout_st.row, q0, a.lq);
  load_tile<Ops>(o_s, head_base<const T>(a.o, a.o_st, bh, a.heads),
                 a.o_st.row, q0, a.lq);
  load_tile<Ops>(k_s, kg, a.k_st.row, 0, a.lk);
  load_tile<Ops>(v_s, vg, a.v_st.row, 0, a.lk);
  cp_async_commit();

  // di for the block's rows: two threads a row, 32 columns each.
  cp_async_wait<0>();
  __syncthreads();
  {
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    float sum = 0.f;
#pragma unroll
    for (int c = 32 * half; c < 32 * half + 32; c += 2) {
      const float2 o2 = Ops::load2(o_s, r, c);
      const float2 d2 = Ops::load2(do_s, r, c);
      sum += o2.x * d2.x + o2.y * d2.y;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      di_s[r] = sum;
      if (q0 + r < a.lq) a.di[static_cast<int64_t>(bh) * a.lq + q0 + r] = sum;
    }
  }
  __syncthreads();

  typename Ops::A qf, dof;
  Ops::load_a(qf, q_s, 16 * warp, lane);
  Ops::load_a(dof, do_s, 16 * warp, lane);
  float lse2[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w0 + g + 8 * i;
    lse2[i] = row < a.lq ? a.lse[static_cast<int64_t>(bh) * a.lq + row] * kLog2e
                         : INFINITY;
    di[i] = di_s[16 * warp + g + 8 * i];
  }

  float acc[8][4];
  zero(acc);
  const float scale2 = a.sm_scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      const int stage = (it + 1) & 1;
      load_tile<Ops>(k_s + stage * kTile, kg, a.k_st.row, (it + 1) * kRows,
                     a.lk);
      load_tile<Ops>(v_s + stage * kTile, vg, a.v_st.row, (it + 1) * kRows,
                     a.lk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* ks = k_s + (it & 1) * kTile;
    const T* vs = v_s + (it & 1) * kTile;
    const int k0 = it * kRows;

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_abt<Ops>(s, qf, ks, lane);
    mma_abt<Ops>(dp, dof, vs, lane);

    const bool edge = k0 + kRows > a.lk || (a.causal && k0 + kRows - 1 > w0);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = s[nb][e] * scale2;
        if (edge) {
          const int row = w0 + g + 8 * i;
          const int col = k0 + 8 * nb + 2 * t + (e & 1);
          if (a.causal && col > row) x += kMaskValue;
          if (col >= a.lk) x = -INFINITY;
        }
        const float p = exp2_approx(x - lse2[i]);
        dp[nb][e] = p * (dp[nb][e] - di[i]) * a.sm_scale;  // dS
      }

    mma_xb<Ops>(acc, dp, ks, lane);  // dQ += dS k
    __syncthreads();
  }

  const float one[2] = {1.f, 1.f};
  store_rows<Ops>(head_base<T>(a.dq, a.dq_st, bh, a.heads), a.dq_st.row, w0,
                  a.lq, acc, one, lane);
}

// One stage of the dK/dV kernel's ring: q and dO rows [q0, q0 + 64) and
// their lse and di, asynchronously; rows past lq are zero.
template <class Ops>
__device__ __forceinline__ void load_query_tile(
    typename Ops::T* q_s, typename Ops::T* do_s, float* lse_s, float* di_s,
    const typename Ops::T* qg, int64_t q_row, const typename Ops::T* dog,
    int64_t do_row, const float* lseg, const float* dig, int q0, int lq) {
  load_tile<Ops>(q_s, qg, q_row, q0, lq);
  load_tile<Ops>(do_s, dog, do_row, q0, lq);
  const int r = threadIdx.x % kRows;
  const bool valid = q0 + r < lq;
  if (threadIdx.x < kRows)
    cp_async4(lse_s + r, valid ? lseg + q0 + r : lseg, valid);
  else
    cp_async4(di_s + r, valid ? dig + q0 + r : dig, valid);
}

// ---------------------------------------------------------------------------
// Backward, part 2: dK and dV.  One block per (batch * head, 64 key rows);
// reads the di that the dQ kernel wrote.
// ---------------------------------------------------------------------------
template <class Ops>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const FlashArgs a) {
  using T = typename Ops::T;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + kTile;
  T* q_s = v_s + kTile;       // two stages
  T* do_s = q_s + 2 * kTile;  // two stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTile);  // [2][64]
  float* di_s = lse_s + 2 * kRows;                            // [2][64]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = k0 + 16 * warp;  // this warp's first key row
  const T* qg = head_base<const T>(a.q, a.q_st, bh, a.heads);
  const T* dog = head_base<const T>(a.dout, a.dout_st, bh, a.heads);
  const float* lseg = a.lse + static_cast<int64_t>(bh) * a.lq;
  const float* dig = a.di + static_cast<int64_t>(bh) * a.lq;

  // Query tiles from q_begin: under the causal mask only rows >= k0 see
  // this key tile.  Rows past lq are zero (q, dO, lse, di), so they add
  // nothing to dK or dV.
  const int q_begin = a.causal ? k0 : 0;
  const int n_tiles = q_begin < a.lq ? (a.lq - q_begin + kRows - 1) / kRows : 0;

  if (n_tiles > 0) {  // else no query sees these keys: dK = dV = 0
    load_tile<Ops>(k_s, head_base<const T>(a.k, a.k_st, bh, a.heads),
                   a.k_st.row, k0, a.lk);
    load_tile<Ops>(v_s, head_base<const T>(a.v, a.v_st, bh, a.heads),
                   a.v_st.row, k0, a.lk);
    load_query_tile<Ops>(q_s, do_s, lse_s, di_s, qg, a.q_st.row, dog,
                         a.dout_st.row, lseg, dig, q_begin, a.lq);
    cp_async_commit();
  }

  typename Ops::A kf, vf;
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  const float scale2 = a.sm_scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      const int stage = (it + 1) & 1;
      load_query_tile<Ops>(q_s + stage * kTile, do_s + stage * kTile,
                           lse_s + stage * kRows, di_s + stage * kRows, qg,
                           a.q_st.row, dog, a.dout_st.row, lseg, dig,
                           q_begin + (it + 1) * kRows, a.lq);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      Ops::load_a(kf, k_s, 16 * warp, lane);
      Ops::load_a(vf, v_s, 16 * warp, lane);
    }
    const int stage = it & 1;
    const T* qs = q_s + stage * kTile;
    const T* dos = do_s + stage * kTile;
    const float* lses = lse_s + stage * kRows;
    const float* dis = di_s + stage * kRows;
    const int q0 = q_begin + it * kRows;

    // S^T = k q^T: rows are keys, columns queries.  p^T = exp(S^T - lse).
    float p[8][4];
    zero(p);
    mma_abt<Ops>(p, kf, qs, lane);
    const bool edge = a.causal && w0 + 15 > q0;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 lse = *reinterpret_cast<const float2*>(lses + 8 * nb + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = p[nb][e] * scale2;
        if (edge) {
          const int key = w0 + g + 8 * (e >> 1);
          const int query = q0 + 8 * nb + 2 * t + (e & 1);
          if (key > query) x += kMaskValue;
        }
        p[nb][e] = exp2_approx(x - ((e & 1) ? lse.y : lse.x) * kLog2e);
      }
    }
    mma_xb<Ops>(dv, p, dos, lane);  // dV += p^T dO

    // dP^T = v dO^T; dS^T = p^T * (dP^T - di) * sm_scale.
    float ds[8][4];
    zero(ds);
    mma_abt<Ops>(ds, vf, dos, lane);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 d = *reinterpret_cast<const float2*>(dis + 8 * nb + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nb][e] = p[nb][e] * (ds[nb][e] - ((e & 1) ? d.y : d.x)) * a.sm_scale;
    }
    mma_xb<Ops>(dk, ds, qs, lane);  // dK += dS^T q
    __syncthreads();
  }

  const float one[2] = {1.f, 1.f};
  store_rows<Ops>(head_base<T>(a.dk, a.dk_st, bh, a.heads), a.dk_st.row, w0,
                  a.lk, dk, one, lane);
  store_rows<Ops>(head_base<T>(a.dv, a.dv_st, bh, a.heads), a.dv_st.row, w0,
                  a.lk, dv, one, lane);
}

// The three launches for a policy; each returns the cudaError_t of its
// launch.  The backward runs dq (which writes di) before dkv (which reads
// it).
template <class Ops>
struct Launch {
  static constexpr size_t kTileBytes = kTile * sizeof(typename Ops::T);

  static int fwd(const FlashArgs* a, void* stream) {
    return flash_launch(flash_fwd_kernel<Ops>, kThreads,
                        (Ops::kFwdM + 4) * kTileBytes, a->lq,
                        kRows * Ops::kFwdM, a, stream);
  }
  static int dq(const FlashArgs* a, void* stream) {
    return flash_launch(flash_bwd_dq_kernel<Ops>, kThreads,
                        7 * kTileBytes + kRows * sizeof(float), a->lq, kRows,
                        a, stream);
  }
  static int dkv(const FlashArgs* a, void* stream) {
    return flash_launch(flash_bwd_dkv_kernel<Ops>, kThreads,
                        6 * kTileBytes + 4 * kRows * sizeof(float), a->lk,
                        kRows, a, stream);
  }
};

}  // namespace flash
