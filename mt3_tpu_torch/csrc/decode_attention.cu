// Kernel B: one decode step of multi-head self-attention, with the new
// K/V column written into the cache in place.
//
// Replaces the Pallas TPU kernel
// mt3_tpu/ops/pallas/decode_attention_v3.py:decode_attention_inplace
// (wrapper :159, body _kernel :32, pallas_call :205).
//
//   cache[b, h, :, index] = new_k / new_v
//   out[b, h, :] = softmax_{j <= index}(q . K[:, j]) . V[:, j]
//
// What bounds it on the H100: memory.  A call must read the live prefix of
// both caches, 2*b*h*d*index elements, and writes b*h*d*2 elements; the
// arithmetic is about 2 flops per element read.  At the served shape
// (b=8, h=6, d=64, bf16, index < 1024) that is at most 12.6 MB, under 4 us
// at 3.35 TB/s, so at the served batch the launch itself dominates.
//
// Design.  The TPU kernel streams 256-wide length blocks through VMEM with
// double-buffered DMA and carries an online softmax across a loop.  Here
// one block owns one (batch, head) pair, 256 threads:
//   * The prefix j < index is walked in chunks of 256 positions.  Each
//     thread forms one logit q . K[:, j]; consecutive threads read
//     consecutive positions of each [d, len] row of the cache, so the reads
//     of the JAX package's [b, h, d, len] layout coalesce.  The head dim is
//     a template parameter, so a thread issues all its d loads at once
//     instead of waiting out one memory latency per element.
//   * The block takes the chunk's max and rescales its running state: an
//     online softmax in float32, the same recurrence as the TPU kernel.
//   * Each warp then accumulates p . V for its 1/8 of the head dims, lanes
//     again on consecutive positions; partial sums stay per lane and are
//     reduced across the warp once at the end.
//   * Position `index` enters analytically from new_k/new_v, and only after
//     all reads is that column written to the cache.  Positions > index are
//     never touched.
//   * `index` is read from device memory, so a launch does not depend on a
//     host-side value (and can later be captured in a CUDA graph).  It is
//     clamped to [0, len - 1], as dynamic_update_slice clamps in the JAX
//     reference.
// The kernel allocates nothing, launches on the caller's stream and does
// not synchronise.  Splitting the length across blocks (more blocks than
// b*h = 48 in flight) is left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads;  // positions per chunk: one per thread
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // as the TPU kernel's NEG_INF

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

template <typename T, int kHeadDim>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ query, const T* __restrict__ new_k,
    const T* __restrict__ new_v, T* __restrict__ cache_k,
    T* __restrict__ cache_v, const int32_t* __restrict__ index_ptr,
    T* __restrict__ out, int len) {
  constexpr int kDimsPerWarp = (kHeadDim + kWarps - 1) / kWarps;
  __shared__ float q_s[kHeadDim];
  __shared__ float p_s[kChunk];
  __shared__ float max_s[kWarps];
  __shared__ float sum_s[kWarps];

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int index = min(max(*index_ptr, 0), len - 1);

  const size_t vec = static_cast<size_t>(bh) * kHeadDim;
  const T* k_rows = cache_k + vec * len;
  const T* v_rows = cache_v + vec * len;

  for (int d = tid; d < kHeadDim; d += kThreads) q_s[d] = load(query + vec + d);
  __syncthreads();

  float acc[kDimsPerWarp];
#pragma unroll
  for (int r = 0; r < kDimsPerWarp; ++r) acc[r] = 0.f;
  float m = kNegInf;   // running max, identical in every thread
  float l_part = 0.f;  // this thread's share of the running sum

  for (int base = 0; base < index; base += kChunk) {
    const int j = base + tid;
    float s = kNegInf;
    if (j < index) {
      // All head_dim loads are issued before the first FMA needs one.
      float k_col[kHeadDim];
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d)
        k_col[d] = load(k_rows + static_cast<size_t>(d) * len + j);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) dot = fmaf(q_s[d], k_col[d], dot);
      s = dot;
    }
    const float wmax = warp_max(s);
    if (lane == 0) max_s[warp] = wmax;
    __syncthreads();
    float m_new = m;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, max_s[w]);
    const float correction = expf(m - m_new);
    const float p = j < index ? expf(s - m_new) : 0.f;
    p_s[tid] = p;
    l_part = l_part * correction + p;
    __syncthreads();

    // p . V: this warp's head dims, lanes on consecutive positions.
    const int n = min(kChunk, index - base);
#pragma unroll
    for (int r = 0; r < kDimsPerWarp; ++r) acc[r] *= correction;
    for (int jj = lane; jj < n; jj += 32) {
      const float pj = p_s[jj];
#pragma unroll
      for (int r = 0; r < kDimsPerWarp; ++r) {
        const int d = warp + kWarps * r;
        if (d < kHeadDim)
          acc[r] = fmaf(pj, load(v_rows + static_cast<size_t>(d) * len + base + jj),
                        acc[r]);
      }
    }
    m = m_new;
    __syncthreads();  // p_s and max_s are rewritten by the next chunk
  }

  // Position `index` from the new K/V (same sum order in every thread).
  float s_new = 0.f;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d)
    s_new = fmaf(q_s[d], load(new_k + vec + d), s_new);
  const float m_final = fmaxf(m, s_new);
  const float correction = expf(m - m_final);
  const float p_new = expf(s_new - m_final);

  const float wsum = warp_sum(l_part);
  if (lane == 0) sum_s[warp] = wsum;
  __syncthreads();
  float l = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l += sum_s[w];
  const float inv_l = 1.f / (l * correction + p_new);

#pragma unroll
  for (int r = 0; r < kDimsPerWarp; ++r) {
    const int d = warp + kWarps * r;
    const float a = warp_sum(acc[r]);
    if (lane == 0 && d < kHeadDim) {
      const float v_new = load(new_v + vec + d);
      store(out + vec + d, (a * correction + p_new * v_new) * inv_l);
    }
  }

  // The cache write: column `index` only, after every read of this block.
  for (int d = tid; d < kHeadDim; d += kThreads) {
    const size_t at = vec * len + static_cast<size_t>(d) * len + index;
    cache_k[at] = new_k[vec + d];
    cache_v[at] = new_v[vec + d];
  }
}

template <typename T>
cudaError_t launch(const void* query, const void* new_k, const void* new_v,
                   void* cache_k, void* cache_v, const void* index,
                   void* out, int batch_heads, int head_dim, int len,
                   cudaStream_t stream) {
  const T* q = static_cast<const T*>(query);
  const T* nk = static_cast<const T*>(new_k);
  const T* nv = static_cast<const T*>(new_v);
  T* ck = static_cast<T*>(cache_k);
  T* cv = static_cast<T*>(cache_v);
  const int32_t* idx = static_cast<const int32_t*>(index);
  T* o = static_cast<T*>(out);
#define MT3_LAUNCH(D)                                                        \
  case D:                                                                    \
    decode_attention_kernel<T, D><<<batch_heads, kThreads, 0, stream>>>(     \
        q, nk, nv, ck, cv, idx, o, len);                                     \
    break;
  switch (head_dim) {
    MT3_LAUNCH(8)   // tiny_config
    MT3_LAUNCH(64)  // mt3_config, ismir2021_config
    default:
      return cudaErrorInvalidValue;
  }
#undef MT3_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (query, new K/V, caches and output all
// share it); head_dim 8 or 64.  Returns the cudaError_t
// of the launch.
int mt3_decode_attention(const void* query, const void* new_k,
                         const void* new_v, void* cache_k, void* cache_v,
                         const void* index, void* out, int batch_heads,
                         int head_dim, int len, int dtype, void* stream) {
  if (batch_heads <= 0 || len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(query, new_k, new_v, cache_k,
                                          cache_v, index, out, batch_heads,
                                          head_dim, len, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(
        query, new_k, new_v, cache_k, cache_v, index, out, batch_heads,
        head_dim, len, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mt3_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
