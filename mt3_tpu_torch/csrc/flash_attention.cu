// Kernel C in float32: blockwise (flash) attention, forward and backward,
// for training, as float32 FMAs.
//
// Replaces the stock Pallas TPU kernel that the JAX package calls at
// mt3_tpu/models/layers.py:230-243,
// jax/experimental/pallas/ops/tpu/flash_attention.py (jax 0.9.0):
//   mt3_flash_fma_fwd  <- _flash_attention_impl     (:589, pallas_call :758)
//   mt3_flash_fma_dq   <- _flash_attention_bwd_dq   (:1287, pallas_call :1456),
//                         plus di = rowsum(o * dO) (stock :274, done in XLA)
//   mt3_flash_fma_dkv  <- _flash_attention_bwd_dkv  (:941, pallas_call :1121)
// for float32 inputs; bfloat16, the training dtype, takes the tensor-core
// kernels of flash_attention_tc.cu.  Tensor cores in float32 would mean
// TF32, which the port never turns on, so float32 stays on FMAs.
//
// For q [lq, 64], k and v [lk, 64] of one (batch, head), sm_scale and an
// optional causal mask (column j visible from row i iff j <= i):
//
//   s   = q k^T * sm_scale (float32); masked entries get + kMaskValue
//   o   = softmax(s) v
//   lse = rowmax(s) + log(rowsum(exp(s - rowmax)))      float32 [bh, lq]
//
// and, given dO, with di = rowsum(o * dO) (computed by the dQ kernel):
//
//   p  = exp(s - lse)
//   dV = p^T dO,  dP = dO v^T,  dS = p * (dP - di) * sm_scale
//   dK = dS^T q,  dQ = dS k
//
// What bounds it on the H100.  At the training shapes attention does
// 4*lq*lk*d flops per (b, h) forward and 10*lq*lk*d backward; as float32
// FMAs out of shared memory it can reach at most the 67 TFLOP/s of the
// float32 units, far from the function's bound.  float32 is the parity
// dtype (chip_smoke.py phase 8a), not the training one, so this kernel is
// kept simple.
//
// Design.  A CUDA block of 256 threads owns one 64-row tile and loops over
// the other length itself:
//   * forward and dQ: one block per (bh, 64 query rows), looping over
//     64-row key tiles; dK/dV: one block per (bh, 64 key rows), looping
//     over 64-row query tiles.  Tiles sit in shared memory with row pitch
//     65 floats, so column walks hit distinct banks.
//   * A thread owns a 4x4 patch of each 64x64 product: rows 4*ty..4*ty+3
//     and columns tx, tx+16, tx+32, tx+48 (ty = tid / 16, tx = tid % 16).
//     Row reductions of the online softmax are shuffles over the 16
//     threads of one row group, which share a warp.
//   * Causal tiles wholly above the diagonal are skipped.  Ragged edges
//     (lengths not a multiple of 64) are zero-filled and masked.
//   * The forward pass keeps (running max, running sum) per row, rescales
//     its output accumulator as in the stock kernel, and writes the row
//     log-sum-exp for the backward pass instead of the stock (l, m) pair.
//   * The dQ kernel first forms di for its 64 rows from o and dO and writes
//     it for the dK/dV kernel, which runs after it.
// The kernels allocate nothing, launch on the caller's stream and do not
// synchronise.

#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kD = 64;                // head dim
constexpr int kTile = 64;             // rows of a q or k tile
constexpr int kPitch = kTile + 1;     // shared-memory row pitch, in floats
constexpr int kTileFloats = kTile * kPitch;
constexpr float kMaskValue = -0.7f * FLT_MAX;  // stock DEFAULT_MASK_VALUE

// Sum / max over the 16 threads (tx = 0..15) that share a row group.
__device__ __forceinline__ float group_max(float v) {
  for (int offset = 8; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
  for (int offset = 8; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// rows [row0, row0 + 64) of a [len, 64] matrix with the given row stride
// into a tile; rows past len are zero.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t row_stride, int row0,
                                          int len) {
  for (int idx = threadIdx.x; idx < kTile * kD; idx += kThreads) {
    const int r = idx / kD;
    const int c = idx % kD;
    const int row = row0 + r;
    dst[r * kPitch + c] = row < len ? src[row * row_stride + c] : 0.f;
  }
}

// Scores of this thread's 4x4 patch: s[i][j] = a[4ty+i] . b[tx+16j].
__device__ __forceinline__ void patch_dot(const float* a, const float* b,
                                          int ty, int tx, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(4 * ty + i) * kPitch + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kPitch + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// s * sm_scale with the causal mask added, as the stock kernel forms it;
// columns past lk are excluded outright.
__device__ __forceinline__ float masked_score(float s, float sm_scale,
                                              bool causal, int row, int col,
                                              int lk) {
  if (sm_scale != 1.f) s *= sm_scale;
  if (causal && col > row) s += kMaskValue;
  return col < lk ? s : -INFINITY;
}

// ---------------------------------------------------------------------------
// Forward: one block per (bh, 64 query rows).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashArgs a) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTileFloats;
  float* v_s = k_s + kTileFloats;
  float* p_s = v_s + kTileFloats;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float* kg = head_base<const float>(a.k, a.k_st, bh, a.heads);
  const float* vg = head_base<const float>(a.v, a.v_st, bh, a.heads);

  load_tile(q_s, head_base<const float>(a.q, a.q_st, bh, a.heads), a.q_st.row,
            q0, a.lq);

  constexpr int kCols = kD / 16;  // output columns per thread
  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int k_end = a.causal ? min(a.lk, q0 + kTile) : a.lk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's k_s, v_s and p_s are consumed
    load_tile(k_s, kg, a.k_st.row, k0, a.lk);
    load_tile(v_s, vg, a.v_st.row, k0, a.lk);
    __syncthreads();

    float s[4][4];
    patch_dot(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score(s[i][j], a.sm_scale, a.causal, row,
                               k0 + tx + 16 * j, a.lk);
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(tile_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        p_s[(4 * ty + i) * kPitch + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + group_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float vv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = v_s[c * kPitch + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(4 * ty + i) * kPitch + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  float* og = head_base<float>(a.o, a.o_st, bh, a.heads);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= a.lq) continue;
    const float inv_l = l[i] == 0.f ? 1.f : 1.f / l[i];
    float* orow = og + row * a.o_st.row;
#pragma unroll
    for (int j = 0; j < kCols; ++j) orow[tx + 16 * j] = acc[i][j] * inv_l;
    if (tx == 0) a.lse[static_cast<int64_t>(bh) * a.lq + row] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// Backward, part 1: di and dQ.  One block per (bh, 64 query rows).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const FlashArgs a) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTileFloats;
  float* k_s = do_s + kTileFloats;
  float* v_s = k_s + kTileFloats;
  float* ds_s = v_s + kTileFloats;   // dS [q row][k row]; o before the loop
  float* lse_s = ds_s + kTileFloats;
  float* di_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float* kg = head_base<const float>(a.k, a.k_st, bh, a.heads);
  const float* vg = head_base<const float>(a.v, a.v_st, bh, a.heads);

  load_tile(q_s, head_base<const float>(a.q, a.q_st, bh, a.heads), a.q_st.row,
            q0, a.lq);
  load_tile(do_s, head_base<const float>(a.dout, a.dout_st, bh, a.heads),
            a.dout_st.row, q0, a.lq);
  load_tile(ds_s, head_base<const float>(a.o, a.o_st, bh, a.heads), a.o_st.row,
            q0, a.lq);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = q0 + r < a.lq;
    lse_s[r] = in ? a.lse[static_cast<int64_t>(bh) * a.lq + q0 + r] : 0.f;
  }
  __syncthreads();
  {
    // di for the block's rows: four threads a row, 16 columns each.
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    float sum = 0.f;
    for (int c = 16 * part; c < 16 * part + 16; ++c)
      sum = fmaf(ds_s[r * kPitch + c], do_s[r * kPitch + c], sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      di_s[r] = sum;
      if (q0 + r < a.lq) a.di[static_cast<int64_t>(bh) * a.lq + q0 + r] = sum;
    }
  }

  constexpr int kCols = kD / 16;
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  const int k_end = a.causal ? min(a.lk, q0 + kTile) : a.lk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile(k_s, kg, a.k_st.row, k0, a.lk);
    load_tile(v_s, vg, a.v_st.row, k0, a.lk);
    __syncthreads();

    float s[4][4], dp[4][4];
    patch_dot(q_s, k_s, ty, tx, s);
    patch_dot(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const bool row_in = q0 + r < a.lq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float x = masked_score(s[i][j], a.sm_scale, a.causal, q0 + r,
                                     k0 + c, a.lk);
        const float p = row_in ? expf(x - lse_s[r]) : 0.f;
        float ds = p * (dp[i][j] - di_s[r]);
        if (a.sm_scale != 1.f) ds *= a.sm_scale;
        ds_s[r * kPitch + c] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float kv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = k_s[c * kPitch + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = ds_s[(4 * ty + i) * kPitch + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

  float* dqg = head_base<float>(a.dq, a.dq_st, bh, a.heads);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= a.lq) continue;
    float* drow = dqg + row * a.dq_st.row;
#pragma unroll
    for (int j = 0; j < kCols; ++j) drow[tx + 16 * j] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// Backward, part 2: dK and dV.  One block per (bh, 64 key rows); reads the
// di that the dQ kernel wrote.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const FlashArgs a) {
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTileFloats;
  float* q_s = v_s + kTileFloats;
  float* do_s = q_s + kTileFloats;
  float* p_s = do_s + kTileFloats;   // p  [q row][k row]
  float* ds_s = p_s + kTileFloats;   // dS [q row][k row]
  float* lse_s = ds_s + kTileFloats;
  float* di_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const float* qg = head_base<const float>(a.q, a.q_st, bh, a.heads);
  const float* dog = head_base<const float>(a.dout, a.dout_st, bh, a.heads);
  const float* lseg = a.lse + static_cast<int64_t>(bh) * a.lq;
  const float* dig = a.di + static_cast<int64_t>(bh) * a.lq;

  load_tile(k_s, head_base<const float>(a.k, a.k_st, bh, a.heads), a.k_st.row,
            k0, a.lk);
  load_tile(v_s, head_base<const float>(a.v, a.v_st, bh, a.heads), a.v_st.row,
            k0, a.lk);

  constexpr int kCols = kD / 16;
  float acc_dk[4][kCols], acc_dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  // Under the causal mask only rows >= k0 see this key tile.
  for (int q0 = a.causal ? k0 : 0; q0 < a.lq; q0 += kTile) {
    __syncthreads();
    load_tile(q_s, qg, a.q_st.row, q0, a.lq);
    load_tile(do_s, dog, a.dout_st.row, q0, a.lq);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool in = q0 + r < a.lq;
      lse_s[r] = in ? lseg[q0 + r] : 0.f;
      di_s[r] = in ? dig[q0 + r] : 0.f;
    }
    __syncthreads();

    // Patch rows are query rows, columns are key rows.
    float s[4][4], dp[4][4];
    patch_dot(q_s, k_s, ty, tx, s);
    patch_dot(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const bool row_in = q0 + r < a.lq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float x = masked_score(s[i][j], a.sm_scale, a.causal, q0 + r,
                                     k0 + c, a.lk);
        const float p = row_in ? expf(x - lse_s[r]) : 0.f;
        float ds = p * (dp[i][j] - di_s[r]);
        if (a.sm_scale != 1.f) ds *= a.sm_scale;
        p_s[r * kPitch + c] = p;
        ds_s[r * kPitch + c] = ds;
      }
    }
    __syncthreads();

    // Now this thread owns key rows 4*ty+i and head dims tx+16j.
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float qv[kCols], dov[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        qv[j] = q_s[r * kPitch + tx + 16 * j];
        dov[j] = do_s[r * kPitch + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[r * kPitch + 4 * ty + i];
        const float ds = ds_s[r * kPitch + 4 * ty + i];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          acc_dv[i][j] = fmaf(p, dov[j], acc_dv[i][j]);
          acc_dk[i][j] = fmaf(ds, qv[j], acc_dk[i][j]);
        }
      }
    }
  }

  float* dkg = head_base<float>(a.dk, a.dk_st, bh, a.heads);
  float* dvg = head_base<float>(a.dv, a.dv_st, bh, a.heads);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= a.lk) continue;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dkg[row * a.dk_st.row + tx + 16 * j] = acc_dk[i][j];
      dvg[row * a.dv_st.row + tx + 16 * j] = acc_dv[i][j];
    }
  }
}

// Dynamic shared memory of each kernel, in bytes.
constexpr size_t kFwdSmem = 4 * kTileFloats * sizeof(float);
constexpr size_t kDqSmem = (5 * kTileFloats + 2 * kTile) * sizeof(float);
constexpr size_t kDkvSmem = (6 * kTileFloats + 2 * kTile) * sizeof(float);

}  // namespace

extern "C" {

// float32 entry points; each returns the cudaError_t of its launch.  The
// backward runs mt3_flash_fma_dq (which writes di) before
// mt3_flash_fma_dkv (which reads it).

int mt3_flash_fma_fwd(const FlashArgs* a, void* stream) {
  return flash_launch(flash_fwd_kernel, kThreads, kFwdSmem, a->lq, kTile, a,
                      stream);
}

int mt3_flash_fma_dq(const FlashArgs* a, void* stream) {
  return flash_launch(flash_bwd_dq_kernel, kThreads, kDqSmem, a->lq, kTile, a,
                      stream);
}

int mt3_flash_fma_dkv(const FlashArgs* a, void* stream) {
  return flash_launch(flash_bwd_dkv_kernel, kThreads, kDkvSmem, a->lk, kTile,
                      a, stream);
}

const char* mt3_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
