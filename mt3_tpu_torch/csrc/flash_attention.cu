// Kernel C: blockwise (flash) attention, forward and backward, for training.
//
// Replaces the stock Pallas TPU kernel that the JAX package calls at
// mt3_tpu/models/layers.py:230-243,
// jax/experimental/pallas/ops/tpu/flash_attention.py (jax 0.9.0):
//   forward  _flash_attention_impl       (:589, pallas_call :758)
//   dK/dV    _flash_attention_bwd_dkv    (:941, pallas_call :1121)
//   dQ       _flash_attention_bwd_dq     (:1287, pallas_call :1456)
//
// For q [bh, lq, d], k and v [bh, lk, d] (d = 64), sm_scale and an optional
// causal mask (column j visible from row i iff j <= i):
//
//   s   = q k^T * sm_scale (float32); masked entries get + kMaskValue
//   o   = softmax(s) v, with p cast to v's type before p v (stock :471)
//   lse = rowmax(s) + log(rowsum(exp(s - rowmax)))      float32 [bh, lq]
//
// and, given dO and di = rowsum(o * dO) in float32 (stock :274):
//
//   p  = exp(s - lse)
//   dV = cast(p)^T dO,  dP = dO v^T,  dS = p * (dP - di) * sm_scale
//   dK = cast(dS)^T q,  dQ = cast(dS) k        (casts as stock :900,918,1258)
//
// every product accumulated in float32, every output in the input's type.
//
// What bounds it on the H100.  At the training shapes (b=64, h=6, d=64;
// lengths 256/1024) attention does 4*lq*lk*d flops per (b, h) forward and
// 10*lq*lk*d backward against 2-byte elements read once: hundreds of flops
// per byte, so the function is bound by operations.  This first version
// runs them as float32 FMAs out of shared memory (67 TFLOP/s peak at best,
// not the 989 TFLOP/s of bf16 tensor cores), so it is far from the
// function's bound; wgmma, TMA and warp specialisation are a later change.
//
// Design.  The TPU kernels walk a sequential grid with scratch carried in
// VMEM across 512-wide blocks.  Here a CUDA block of 256 threads owns one
// 64-row tile and loops over the other length itself:
//   * forward and dQ: one block per (bh, 64 query rows), looping over
//     64-row key tiles; dK/dV: one block per (bh, 64 key rows), looping
//     over 64-row query tiles.  Tiles are converted to float32 in shared
//     memory (row pitch 65 floats, so column walks hit distinct banks).
//   * A thread owns a 4x4 patch of each 64x64 product: rows 4*ty..4*ty+3
//     and columns tx, tx+16, tx+32, tx+48 (ty = tid / 16, tx = tid % 16).
//     Row reductions of the online softmax are shuffles over the 16
//     threads of one row group, which share a warp.
//   * Causal tiles wholly above the diagonal are skipped.  Ragged edges
//     (lengths not a multiple of 64) are zero-filled and masked.
//   * The forward pass keeps (running max, running sum) per row, rescales
//     its output accumulator as in the stock kernel, and writes the row
//     log-sum-exp for the backward pass instead of the stock (l, m) pair.
// The kernels allocate nothing, launch on the caller's stream and do not
// synchronise.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // rows of a q or k tile
constexpr int kPitch = kTile + 1;     // shared-memory row pitch, in floats
constexpr int kTileFloats = kTile * kPitch;
constexpr float kMaskValue = -0.7f * FLT_MAX;  // stock DEFAULT_MASK_VALUE

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to T and back: the cast the stock kernel applies before a dot.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

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

// rows [row0, row0 + 64) of a [len, D] matrix into a float tile; rows past
// len are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int len) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const int row = row0 + r;
    dst[r * kPitch + c] =
        row < len ? load(src + static_cast<size_t>(row) * D + c) : 0.f;
  }
}

// Scores of this thread's 4x4 patch: s[i][j] = a[4ty+i] . b[tx+16j].
template <int D>
__device__ __forceinline__ void patch_dot(const float* a, const float* b,
                                          int ty, int tx, float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int lq, int lk,
    float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTileFloats;
  float* v_s = k_s + kTileFloats;
  float* p_s = v_s + kTileFloats;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const T* qg = q + static_cast<size_t>(bh) * lq * D;
  const T* kg = k + static_cast<size_t>(bh) * lk * D;
  const T* vg = v + static_cast<size_t>(bh) * lk * D;

  load_tile<T, D>(q_s, qg, q0, lq);

  constexpr int kCols = D / 16;  // output columns per thread
  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(lk, q0 + kTile) : lk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's k_s, v_s and p_s are consumed
    load_tile<T, D>(k_s, kg, k0, lk);
    load_tile<T, D>(v_s, vg, k0, lk);
    __syncthreads();

    float s[4][4];
    patch_dot<D>(q_s, k_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score(s[i][j], sm_scale, causal, row,
                               k0 + tx + 16 * j, lk);
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(tile_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        row_sum += p;
        p_s[(4 * ty + i) * kPitch + tx + 16 * j] = round_to(p, v);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= lq) continue;
    const float inv_l = l[i] == 0.f ? 1.f : 1.f / l[i];
    T* orow = o + (static_cast<size_t>(bh) * lq + row) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) store(orow + tx + 16 * j, acc[i][j] * inv_l);
    if (tx == 0) lse[static_cast<size_t>(bh) * lq + row] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// Backward, part 1: dK and dV.  One block per (bh, 64 key rows).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
    int lq, int lk, float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTileFloats;
  float* q_s = v_s + kTileFloats;
  float* do_s = q_s + kTileFloats;
  float* p_s = do_s + kTileFloats;   // cast(p)  [q row][k row]
  float* ds_s = p_s + kTileFloats;   // cast(dS) [q row][k row]
  float* lse_s = ds_s + kTileFloats;
  float* di_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const T* qg = q + static_cast<size_t>(bh) * lq * D;
  const T* dog = dout + static_cast<size_t>(bh) * lq * D;
  const float* lseg = lse + static_cast<size_t>(bh) * lq;
  const float* dig = di + static_cast<size_t>(bh) * lq;

  load_tile<T, D>(k_s, k + static_cast<size_t>(bh) * lk * D, k0, lk);
  load_tile<T, D>(v_s, v + static_cast<size_t>(bh) * lk * D, k0, lk);

  constexpr int kCols = D / 16;
  float acc_dk[4][kCols], acc_dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  // Under the causal mask only rows >= k0 see this key tile.
  for (int q0 = causal ? k0 : 0; q0 < lq; q0 += kTile) {
    __syncthreads();
    load_tile<T, D>(q_s, qg, q0, lq);
    load_tile<T, D>(do_s, dog, q0, lq);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool in = q0 + r < lq;
      lse_s[r] = in ? lseg[q0 + r] : 0.f;
      di_s[r] = in ? dig[q0 + r] : 0.f;
    }
    __syncthreads();

    // Patch rows are query rows, columns are key rows.
    float s[4][4], dp[4][4];
    patch_dot<D>(q_s, k_s, ty, tx, s);
    patch_dot<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const bool row_in = q0 + r < lq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float x = masked_score(s[i][j], sm_scale, causal, q0 + r,
                                     k0 + c, lk);
        const float p = row_in ? expf(x - lse_s[r]) : 0.f;
        float ds = p * (dp[i][j] - di_s[r]);
        if (sm_scale != 1.f) ds *= sm_scale;
        p_s[r * kPitch + c] = round_to(p, dout);
        ds_s[r * kPitch + c] = round_to(ds, dout);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= lk) continue;
    const size_t at = (static_cast<size_t>(bh) * lk + row) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      store(dk + at + tx + 16 * j, acc_dk[i][j]);
      store(dv + at + tx + 16 * j, acc_dv[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, part 2: dQ.  One block per (bh, 64 query rows).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ di, T* __restrict__ dq, int lq, int lk,
    float sm_scale, int causal) {
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTileFloats;
  float* k_s = do_s + kTileFloats;
  float* v_s = k_s + kTileFloats;
  float* ds_s = v_s + kTileFloats;   // cast(dS) [q row][k row]
  float* lse_s = ds_s + kTileFloats;
  float* di_s = lse_s + kTile;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const T* kg = k + static_cast<size_t>(bh) * lk * D;
  const T* vg = v + static_cast<size_t>(bh) * lk * D;

  load_tile<T, D>(q_s, q + static_cast<size_t>(bh) * lq * D, q0, lq);
  load_tile<T, D>(do_s, dout + static_cast<size_t>(bh) * lq * D, q0, lq);
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = q0 + r < lq;
    lse_s[r] = in ? lse[static_cast<size_t>(bh) * lq + q0 + r] : 0.f;
    di_s[r] = in ? di[static_cast<size_t>(bh) * lq + q0 + r] : 0.f;
  }

  constexpr int kCols = D / 16;
  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  const int k_end = causal ? min(lk, q0 + kTile) : lk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<T, D>(k_s, kg, k0, lk);
    load_tile<T, D>(v_s, vg, k0, lk);
    __syncthreads();

    float s[4][4], dp[4][4];
    patch_dot<D>(q_s, k_s, ty, tx, s);
    patch_dot<D>(do_s, v_s, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const bool row_in = q0 + r < lq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float x = masked_score(s[i][j], sm_scale, causal, q0 + r,
                                     k0 + c, lk);
        const float p = row_in ? expf(x - lse_s[r]) : 0.f;
        float ds = p * (dp[i][j] - di_s[r]);
        if (sm_scale != 1.f) ds *= sm_scale;
        ds_s[r * kPitch + c] = round_to(ds, k);
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= lq) continue;
    T* drow = dq + (static_cast<size_t>(bh) * lq + row) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) store(drow + tx + 16 * j, acc[i][j]);
  }
}

// Dynamic shared memory of each kernel, in bytes.
constexpr size_t kFwdSmem = 4 * kTileFloats * sizeof(float);
constexpr size_t kDkvSmem = (6 * kTileFloats + 2 * kTile) * sizeof(float);
constexpr size_t kDqSmem = (5 * kTileFloats + 2 * kTile) * sizeof(float);

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  // Above 48 KB a kernel must opt in to dynamic shared memory.
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

dim3 grid(int batch_heads, int len) {
  return dim3(batch_heads, (len + kTile - 1) / kTile);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int lq, int lk, float scale,
                       int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, kFwdSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid(bh, lq), kThreads, kFwdSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      lq, lk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dk, void* dv, int bh, int lq, int lk, float scale,
                       int causal, cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, kDkvSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid(bh, lk), kThreads, kDkvSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dk), static_cast<T*>(dv), lq, lk, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* di,
                      void* dq, int bh, int lq, int lk, float scale,
                      int causal, cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, kDqSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid(bh, lq), kThreads, kDqSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(di),
      static_cast<T*>(dq), lq, lk, scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int bh, int lq, int lk, int head_dim) {
  return bh <= 0 || lq <= 0 || lk <= 0 ||
         (lq + kTile - 1) / kTile > 65535 || (lk + kTile - 1) / kTile > 65535 ||
         head_dim != 64;
}

}  // namespace

extern "C" {

// All entry points: q [bh, lq, 64], k and v [bh, lk, 64], contiguous, of
// one dtype (0 = float32, 1 = bfloat16); lse and di float32 [bh, lq];
// causal 0 or 1.  Each returns the cudaError_t of its launch.

int mt3_flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int bh, int lq, int lk,
                            int head_dim, int causal, float sm_scale,
                            int dtype, void* stream) {
  if (bad_shape(bh, lq, lk, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_fwd<float, 64>(q, k, v, o, lse, bh, lq, lk,
                                                  sm_scale, causal, s));
  if (dtype == 1)
    return static_cast<int>(launch_fwd<__nv_bfloat16, 64>(
        q, k, v, o, lse, bh, lq, lk, sm_scale, causal, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

int mt3_flash_attention_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, const void* di,
                            void* dk, void* dv, int bh, int lq, int lk,
                            int head_dim, int causal, float sm_scale,
                            int dtype, void* stream) {
  if (bad_shape(bh, lq, lk, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_dkv<float, 64>(
        q, k, v, dout, lse, di, dk, dv, bh, lq, lk, sm_scale, causal, s));
  if (dtype == 1)
    return static_cast<int>(launch_dkv<__nv_bfloat16, 64>(
        q, k, v, dout, lse, di, dk, dv, bh, lq, lk, sm_scale, causal, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

int mt3_flash_attention_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* di,
                           void* dq, int bh, int lq, int lk, int head_dim,
                           int causal, float sm_scale, int dtype,
                           void* stream) {
  if (bad_shape(bh, lq, lk, head_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_dq<float, 64>(
        q, k, v, dout, lse, di, dq, bh, lq, lk, sm_scale, causal, s));
  if (dtype == 1)
    return static_cast<int>(launch_dq<__nv_bfloat16, 64>(
        q, k, v, dout, lse, di, dq, bh, lq, lk, sm_scale, causal, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mt3_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
