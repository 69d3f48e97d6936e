// Kernel C in bfloat16 on the tensor cores: blockwise (flash) attention,
// forward and backward, for training.
//
// Replaces the stock Pallas TPU kernel that the JAX package calls at
// mt3_tpu/models/layers.py:230-243,
// jax/experimental/pallas/ops/tpu/flash_attention.py (jax 0.9.0):
//   mt3_flash_tc_fwd  <- _flash_attention_impl     (:589, pallas_call :758)
//   mt3_flash_tc_dq   <- _flash_attention_bwd_dq   (:1287, pallas_call :1456),
//                        plus di = rowsum(o * dO) (stock :274, done in XLA)
//   mt3_flash_tc_dkv  <- _flash_attention_bwd_dkv  (:941, pallas_call :1121)
// float32 inputs take the FMA kernels of flash_attention.cu instead (tensor
// cores in float32 would mean TF32, which the port never turns on).
//
// The function, as in flash_attention.cu: for q [lq, 64], k and v [lk, 64]
// of one (batch, head),
//   s   = q k^T * sm_scale, masked entries + kMaskValue (causal: col > row)
//   o   = cast(p) v / rowsum(p),  p = exp(s - rowmax)
//   lse = rowmax(s) + log(rowsum(p))                       float32
//   di  = rowsum(o * dO)                                   float32
//   p   = exp(s - lse), dP = dO v^T, dS = p * (dP - di) * sm_scale
//   dV  = cast(p)^T dO,  dK = cast(dS)^T q,  dQ = cast(dS) k
// with p and dS rounded to bf16 right before each product, where the stock
// kernel casts them (:471, :900, :918, :1258), and every product summed in
// float32.  Scores are kept in log2 units (s * sm_scale * log2 e) so that
// each exp is one ex2; the mask constant is added in those units, which
// zeroes the same entries.
//
// What bounds it on the H100.  At the training calls (b=64, h=6, d=64;
// 256x256 full, 1024x1024 causal, 1024x256 full) the forward and the whole
// backward are bound by bytes, each input read once and each output written
// once at 3.35 TB/s, by a small margin over their operations at the bf16
// tensor-core rate of 989 TFLOP/s (PERF.md, kernel table).  So the kernels
// have to run their products on the tensor cores and keep the score
// matrices out of device memory, and no more.
//
// Design (FlashAttention-2's, on mma.sync).
//   * One block of 4 warps owns a tile of rows: 128 query rows in the
//     forward, 64 query rows in dQ, 64 key rows in dK/dV.  Each warp owns
//     16 rows (two tiles of 16 in the forward, so that each K and V
//     fragment feeds two products) and loops over 64-row tiles of the
//     other side.  Causal tiles wholly above the diagonal are skipped;
//     ragged edges are zero-filled and masked.
//   * The forward's online softmax takes the max of the raw scores on
//     interior tiles and folds sm_scale * log2 e into the exp's FFMA
//     (FA2's exp2(s * scale - max)): the non-product instructions, not the
//     tensor cores, set its pace.
//   * Every product is mma.sync.m16n8k16 (bf16 in, float32 accumulate),
//     its operands fetched from shared memory by ldmatrix; ldmatrix.trans
//     gives the transposed operand (V in p.V, K in dS.K, dO and q in
//     dK/dV), so nothing is transposed in memory.
//   * Tiles are bf16 in shared memory, 128-byte rows whose 16-byte chunks
//     are XOR-swizzled by row % 8, so ldmatrix's eight rows hit eight
//     different bank groups.  The tiles the loop walks over are loaded with
//     cp.async (16 bytes a thread) into a ring of two stages: tile i + 1
//     loads while tile i is multiplied.  The block's own tiles (q in the
//     forward; q and dO in dQ; k and v in dK/dV) stay in registers as
//     A fragments.
//   * p and dS never leave registers: the float32 S and dP accumulator
//     fragments are rounded to bf16 pairs that are the A fragments of the
//     next product (FA2's register reuse).  dK/dV computes S^T = k q^T and
//     dP^T = v dO^T with key rows as fragment rows, so p^T and dS^T are A
//     operands for dV and dK as they stand.
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

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                  // head dim
constexpr int kRows = 64;               // rows of every tile
constexpr int kWarps = 4;               // each owns 16 rows of the block's tile
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = kRows * kD;       // elements of one bf16 tile, 8 KB
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b for a 16x16 bf16 A fragment and a 16x8 bf16 B fragment.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// Tiles and fragments
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t): A holds rows g and
// g + 8 at columns 2t, 2t + 1 (+ 8); B holds rows (k) 2t, 2t + 1 (+ 8) at
// column (n) g; the accumulator holds rows g (c0, c1) and g + 8 (c2, c3)
// at columns 2t, 2t + 1.
// ---------------------------------------------------------------------------

// Element offset of (row, col) in a [64][64] tile whose 16-byte chunks are
// XOR-swizzled by row % 8.
__device__ __forceinline__ int swz(int row, int col) {
  return row * kD + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
}

// Rows [row0, row0 + 64) of a [len, 64] matrix with the given row stride
// into a tile, asynchronously; rows past len are zero.
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          int64_t row_stride, int row0,
                                          int len) {
  const int c = threadIdx.x % 8;
  for (int r = threadIdx.x / 8; r < kRows; r += kThreads / 8) {
    const int row = row0 + r;
    const bool valid = row < len;
    cp_async16(tile + swz(r, 8 * c), valid ? src + row * row_stride + 8 * c
                                           : src,
               valid);
  }
}

// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  ldmatrix_x4(a, tile + swz(r0 + (lane & 15), c0 + ((lane >> 4) << 3)));
}

// B fragments of two 8-column blocks for a product with tile^T: tile rows
// [n0, n0 + 16) are the columns n, tile columns [k0, k0 + 16) the depth.
// b[0], b[1] serve columns n0..n0+7; b[2], b[3] columns n0+8..n0+15.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int n0, int k0, int lane) {
  ldmatrix_x4(b, tile + swz(n0 + (lane & 7) + ((lane >> 4) << 3),
                            k0 + (((lane >> 3) & 1) << 3)));
}

// B fragments of two 8-column blocks for a product with the tile as it
// stands: tile rows [k0, k0 + 16) are the depth, tile columns [n0, n0 + 16)
// the columns n.  Same register order as load_b.
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const bf16* tile, int k0, int n0,
                                             int lane) {
  ldmatrix_x4_trans(b, tile + swz(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                  n0 + ((lane >> 4) << 3)));
}

// acc[m][8][4] (M tiles of 16 rows x 64 columns) += a[m] (16 x 64, as 4
// A fragments) times tile^T, where the tile's rows are the 64 columns.  Each
// B fragment serves all M row tiles.
template <int M>
__device__ __forceinline__ void mma_abt(float (&acc)[M][8][4],
                                        const uint32_t (&a)[M][4][4],
                                        const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[4];
      load_b(b, tile, 16 * j, 16 * kk, lane);
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
        mma(acc[mi][2 * j], a[mi][kk], b[0], b[1]);
        mma(acc[mi][2 * j + 1], a[mi][kk], b[2], b[3]);
      }
    }
}

// acc[m][8][4] += cast(x[m]) (16 x 64 float32 accumulator fragments,
// rounded to bf16 A fragments in registers) times the tile.
template <int M>
__device__ __forceinline__ void mma_xb(float (&acc)[M][8][4],
                                       const float (&x)[M][8][4],
                                       const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[M][4];
#pragma unroll
    for (int mi = 0; mi < M; ++mi) {
      a[mi][0] = pack_bf16(x[mi][2 * kk][0], x[mi][2 * kk][1]);
      a[mi][1] = pack_bf16(x[mi][2 * kk][2], x[mi][2 * kk][3]);
      a[mi][2] = pack_bf16(x[mi][2 * kk + 1][0], x[mi][2 * kk + 1][1]);
      a[mi][3] = pack_bf16(x[mi][2 * kk + 1][2], x[mi][2 * kk + 1][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t b[4];
      load_b_trans(b, tile, 16 * kk, 16 * j, lane);
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
        mma(acc[mi][2 * j], a[mi], b[0], b[1]);
        mma(acc[mi][2 * j + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// The one-row-tile forms the backward kernels use.
__device__ __forceinline__ void mma_abt(float (&acc)[8][4],
                                        const uint32_t (&a)[4][4],
                                        const bf16* tile, int lane) {
  mma_abt<1>(reinterpret_cast<float(&)[1][8][4]>(acc),
             reinterpret_cast<const uint32_t(&)[1][4][4]>(a), tile, lane);
}
__device__ __forceinline__ void mma_xb(float (&acc)[8][4],
                                       const float (&x)[8][4],
                                       const bf16* tile, int lane) {
  mma_xb<1>(reinterpret_cast<float(&)[1][8][4]>(acc),
            reinterpret_cast<const float(&)[1][8][4]>(x), tile, lane);
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// Writes rows g and g + 8 of a 16 x 64 accumulator (rows r0.. of the
// output) as bf16, rows past len skipped.
__device__ __forceinline__ void store_rows(bf16* base, int64_t row_stride,
                                           int r0, int len,
                                           const float (&acc)[8][4],
                                           const float (&scale)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= len) continue;
    bf16* out = base + row * row_stride + 2 * t;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      *reinterpret_cast<uint32_t*>(out + 8 * nb) = pack_bf16(
          acc[nb][2 * i] * scale[i], acc[nb][2 * i + 1] * scale[i]);
  }
}

// Tile order of the forward and dQ grids: the heaviest causal tiles (the
// last query rows) first.
__device__ __forceinline__ int query_tile() {
  return gridDim.y - 1 - blockIdx.y;
}

// ---------------------------------------------------------------------------
// Forward: one block per (batch * head, 64 * kFwdM query rows); each warp
// owns kFwdM tiles of 16 rows, so that each K and V fragment read from
// shared memory feeds kFwdM products.
// ---------------------------------------------------------------------------
constexpr int kFwdM = 2;
constexpr int kFwdRows = kRows * kFwdM;

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

__global__ void __launch_bounds__(kThreads)
    flash_fwd_tc_kernel(const FlashArgs a) {
  constexpr int M = kFwdM;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // kFwdRows rows
  bf16* k_s = q_s + M * kTile;   // two stages
  bf16* v_s = k_s + 2 * kTile;   // two stages

  const int bh = blockIdx.x;
  const int q0 = query_tile() * kFwdRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + 16 * M * warp;  // this warp's first query row
  const bf16* qg = head_base<const bf16>(a.q, a.q_st, bh, a.heads);
  const bf16* kg = head_base<const bf16>(a.k, a.k_st, bh, a.heads);
  const bf16* vg = head_base<const bf16>(a.v, a.v_st, bh, a.heads);

  const int k_end = a.causal ? min(a.lk, q0 + kFwdRows) : a.lk;
  const int n_tiles = (k_end + kRows - 1) / kRows;

#pragma unroll
  for (int mi = 0; mi < M; ++mi)
    load_tile(q_s + mi * kTile, qg, a.q_st.row, q0 + mi * kRows, a.lq);
  load_tile(k_s, kg, a.k_st.row, 0, a.lk);
  load_tile(v_s, vg, a.v_st.row, 0, a.lk);
  cp_async_commit();

  uint32_t qf[M][4][4];
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
      load_tile(k_s + stage * kTile, kg, a.k_st.row, (it + 1) * kRows, a.lk);
      load_tile(v_s + stage * kTile, vg, a.v_st.row, (it + 1) * kRows, a.lk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile it (and q) have landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int mi = 0; mi < M; ++mi)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          load_a(qf[mi][kk], q_s, 16 * (M * warp + mi), 16 * kk, lane);
    }
    const bf16* ks = k_s + (it & 1) * kTile;
    const bf16* vs = v_s + (it & 1) * kTile;
    const int k0 = it * kRows;

    float s[M][8][4];
#pragma unroll
    for (int mi = 0; mi < M; ++mi) zero(s[mi]);
    mma_abt<M>(s, qf, ks, lane);

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

    mma_xb<M>(acc, s, vs, lane);
    __syncthreads();  // this stage is free for tile it + 2
  }

  bf16* og = head_base<bf16>(a.o, a.o_st, bh, a.heads);
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
    store_rows(og, a.o_st.row, w0 + 16 * mi, a.lq, acc[mi], inv, lane);
  }
}

// ---------------------------------------------------------------------------
// Backward, part 1: di and dQ.  One block per (batch * head, 64 query rows).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_tc_kernel(const FlashArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kTile;
  bf16* o_s = do_s + kTile;
  bf16* k_s = o_s + kTile;       // two stages
  bf16* v_s = k_s + 2 * kTile;   // two stages
  float* di_s = reinterpret_cast<float*>(v_s + 2 * kTile);  // [64]

  const int bh = blockIdx.x;
  const int q0 = query_tile() * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = q0 + 16 * warp;
  const bf16* kg = head_base<const bf16>(a.k, a.k_st, bh, a.heads);
  const bf16* vg = head_base<const bf16>(a.v, a.v_st, bh, a.heads);

  const int k_end = a.causal ? min(a.lk, q0 + kRows) : a.lk;
  const int n_tiles = (k_end + kRows - 1) / kRows;

  load_tile(q_s, head_base<const bf16>(a.q, a.q_st, bh, a.heads), a.q_st.row,
            q0, a.lq);
  load_tile(do_s, head_base<const bf16>(a.dout, a.dout_st, bh, a.heads),
            a.dout_st.row, q0, a.lq);
  load_tile(o_s, head_base<const bf16>(a.o, a.o_st, bh, a.heads), a.o_st.row,
            q0, a.lq);
  load_tile(k_s, kg, a.k_st.row, 0, a.lk);
  load_tile(v_s, vg, a.v_st.row, 0, a.lk);
  cp_async_commit();

  // di for the block's rows: two threads a row, 32 columns each.
  cp_async_wait<0>();
  __syncthreads();
  {
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    float sum = 0.f;
#pragma unroll
    for (int c = 32 * half; c < 32 * half + 32; c += 2) {
      const float2 o2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o_s + swz(r, c)));
      const float2 d2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(do_s + swz(r, c)));
      sum += o2.x * d2.x + o2.y * d2.y;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      di_s[r] = sum;
      if (q0 + r < a.lq) a.di[static_cast<int64_t>(bh) * a.lq + q0 + r] = sum;
    }
  }
  __syncthreads();

  uint32_t qf[4][4], dof[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    load_a(qf[kk], q_s, 16 * warp, 16 * kk, lane);
    load_a(dof[kk], do_s, 16 * warp, 16 * kk, lane);
  }
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
      load_tile(k_s + stage * kTile, kg, a.k_st.row, (it + 1) * kRows, a.lk);
      load_tile(v_s + stage * kTile, vg, a.v_st.row, (it + 1) * kRows, a.lk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = k_s + (it & 1) * kTile;
    const bf16* vs = v_s + (it & 1) * kTile;
    const int k0 = it * kRows;

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_abt(s, qf, ks, lane);
    mma_abt(dp, dof, vs, lane);

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

    mma_xb(acc, dp, ks, lane);  // dQ += cast(dS) k
    __syncthreads();
  }

  const float one[2] = {1.f, 1.f};
  store_rows(head_base<bf16>(a.dq, a.dq_st, bh, a.heads), a.dq_st.row, w0,
             a.lq, acc, one, lane);
}

// One stage of the dK/dV kernel's ring: q and dO rows [q0, q0 + 64) and
// their lse and di, asynchronously; rows past lq are zero.
__device__ __forceinline__ void load_query_tile(
    bf16* q_s, bf16* do_s, float* lse_s, float* di_s, const bf16* qg,
    int64_t q_row, const bf16* dog, int64_t do_row, const float* lseg,
    const float* dig, int q0, int lq) {
  load_tile(q_s, qg, q_row, q0, lq);
  load_tile(do_s, dog, do_row, q0, lq);
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
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_tc_kernel(const FlashArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kTile;
  bf16* q_s = v_s + kTile;       // two stages
  bf16* do_s = q_s + 2 * kTile;  // two stages
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTile);  // [2][64]
  float* di_s = lse_s + 2 * kRows;                            // [2][64]

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = k0 + 16 * warp;  // this warp's first key row
  const bf16* qg = head_base<const bf16>(a.q, a.q_st, bh, a.heads);
  const bf16* dog = head_base<const bf16>(a.dout, a.dout_st, bh, a.heads);
  const float* lseg = a.lse + static_cast<int64_t>(bh) * a.lq;
  const float* dig = a.di + static_cast<int64_t>(bh) * a.lq;

  // Query tiles from q_begin: under the causal mask only rows >= k0 see
  // this key tile.  Rows past lq are zero (q, dO, lse, di), so they add
  // nothing to dK or dV.
  const int q_begin = a.causal ? k0 : 0;
  const int n_tiles = q_begin < a.lq ? (a.lq - q_begin + kRows - 1) / kRows : 0;

  if (n_tiles > 0) {  // else no query sees these keys: dK = dV = 0
    load_tile(k_s, head_base<const bf16>(a.k, a.k_st, bh, a.heads),
              a.k_st.row, k0, a.lk);
    load_tile(v_s, head_base<const bf16>(a.v, a.v_st, bh, a.heads),
              a.v_st.row, k0, a.lk);
    load_query_tile(q_s, do_s, lse_s, di_s, qg, a.q_st.row, dog,
                    a.dout_st.row, lseg, dig, q_begin, a.lq);
    cp_async_commit();
  }

  uint32_t kf[4][4], vf[4][4];
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  const float scale2 = a.sm_scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      const int stage = (it + 1) & 1;
      load_query_tile(q_s + stage * kTile, do_s + stage * kTile,
                      lse_s + stage * kRows, di_s + stage * kRows, qg,
                      a.q_st.row, dog, a.dout_st.row, lseg, dig,
                      q_begin + (it + 1) * kRows, a.lq);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        load_a(kf[kk], k_s, 16 * warp, 16 * kk, lane);
        load_a(vf[kk], v_s, 16 * warp, 16 * kk, lane);
      }
    }
    const int stage = it & 1;
    const bf16* qs = q_s + stage * kTile;
    const bf16* dos = do_s + stage * kTile;
    const float* lses = lse_s + stage * kRows;
    const float* dis = di_s + stage * kRows;
    const int q0 = q_begin + it * kRows;

    // S^T = k q^T: rows are keys, columns queries.  p^T = exp(S^T - lse).
    float p[8][4];
    zero(p);
    mma_abt(p, kf, qs, lane);
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
    mma_xb(dv, p, dos, lane);  // dV += cast(p)^T dO

    // dP^T = v dO^T; dS^T = p^T * (dP^T - di) * sm_scale.
    float ds[8][4];
    zero(ds);
    mma_abt(ds, vf, dos, lane);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const float2 d = *reinterpret_cast<const float2*>(dis + 8 * nb + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nb][e] = p[nb][e] * (ds[nb][e] - ((e & 1) ? d.y : d.x)) * a.sm_scale;
    }
    mma_xb(dk, ds, qs, lane);  // dK += cast(dS)^T q
    __syncthreads();
  }

  const float one[2] = {1.f, 1.f};
  store_rows(head_base<bf16>(a.dk, a.dk_st, bh, a.heads), a.dk_st.row, w0,
             a.lk, dk, one, lane);
  store_rows(head_base<bf16>(a.dv, a.dv_st, bh, a.heads), a.dv_st.row, w0,
             a.lk, dv, one, lane);
}

// Dynamic shared memory of each kernel, in bytes.
constexpr size_t kTileBytes = kTile * sizeof(bf16);
constexpr size_t kFwdSmem = (kFwdM + 4) * kTileBytes;
constexpr size_t kDqSmem = 7 * kTileBytes + kRows * sizeof(float);
constexpr size_t kDkvSmem = 6 * kTileBytes + 4 * kRows * sizeof(float);

}  // namespace

extern "C" {

// bfloat16 entry points; each returns the cudaError_t of its launch.
// The backward runs mt3_flash_tc_dq (which writes di) before
// mt3_flash_tc_dkv (which reads it).

int mt3_flash_tc_fwd(const FlashArgs* a, void* stream) {
  return flash_launch(flash_fwd_tc_kernel, kThreads, kFwdSmem, a->lq,
                      kFwdRows, a, stream);
}

int mt3_flash_tc_dq(const FlashArgs* a, void* stream) {
  return flash_launch(flash_bwd_dq_tc_kernel, kThreads, kDqSmem, a->lq, kRows,
                      a, stream);
}

int mt3_flash_tc_dkv(const FlashArgs* a, void* stream) {
  return flash_launch(flash_bwd_dkv_tc_kernel, kThreads, kDkvSmem, a->lk,
                      kRows, a, stream);
}

const char* mt3_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
