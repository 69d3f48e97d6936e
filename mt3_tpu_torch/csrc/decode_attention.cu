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
// arithmetic is about 2 flops per element read.  At the served shape (b=8,
// h=6, d=64, bf16, index 1023) that is 12.6 MB, 3.8 us at 3.35 TB/s.  To
// come near that rate the reads must come from every SM at once, with a few
// MB in flight (HBM's latency times its rate).  One block per (batch, head)
// gives 48 blocks on 132 SMs, each walking 256 KB alone.
//
// Design: the length is split across blocks (flash-decoding).
//   * The grid is (splits, b*h), one block per kSplit = 64 positions of one
//     (batch, head): 768 blocks at the served shape.  `index` is read from
//     device memory, so the grid is sized by len; a split that starts at or
//     past index reads nothing.
//   * A block issues all of its split's K and V loads at once, 16 bytes a
//     thread per load, straight to registers.  In the [b, h, d, len] layout
//     each of the d rows is contiguous in positions; a thread owns one
//     16-byte chunk of positions in several rows, so a warp reads whole
//     128-byte lines.  Positions at or past index are masked to zero.
//   * Logits: each thread sums q[d] * K[d, j] over its rows for its chunk's
//     positions; lanes holding the same positions are reduced by shuffles,
//     the warps through shared memory.  One warp takes the split's max m,
//     p_j = exp(s_j - m) and l = sum p_j (float32, the -1e30 mask).  (Every
//     warp forming its own p_j instead, without the second barrier,
//     measured slower on the H100: eight exps a thread on the critical path
//     where one warp takes two a lane.)
//   * p . V from the V registers: each thread sums over its chunk, and the
//     lanes sharing a row are reduced by shuffles once.
//   * The split's (acc[d], m, l) go in float32 to the scratch tensor
//     partials[b*h, splits, d + 2], which the wrapper allocates.
//   * Combine, in the same launch: each block counts itself on a
//     per-(batch, head) int32 counter (__threadfence, then atomicAdd).  The
//     last block of a (batch, head) merges the live splits' partials with
//     position `index`, which enters analytically from new_k/new_v, writes
//     out, and resets the counter to 0.  So a call leaves the counters as it
//     found them, and a replayed CUDA graph stays correct.  Calls that share
//     a counter buffer must not overlap: the wrapper keeps one buffer per
//     device, for calls from one stream, as the decode loop makes them.
//   * The column write: no split reads column index (the split holding it
//     reads only j < index, and its 16-byte loads are the only ones that
//     touch that column), so that block writes the column after its reads.
//     `index` is clamped to [0, len - 1], as dynamic_update_slice clamps in
//     the JAX reference.
// The kernel allocates nothing, launches on the caller's stream and does
// not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kSplit = 64;          // positions per block (ops L_SPLIT)
constexpr float kNegInf = -1e30f;   // as the TPU kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);      // positions per chunk
  static constexpr int kChunks = kSplit / kVec;    // chunks per row
};

// How a block of head dim kD covers its [kD, kSplit] tile of one cache:
// thread t holds chunk t % kChunks of rows t / kChunks + kRows * i.
template <typename T, int kD>
struct Layout {
  static constexpr int kVec = Tile<T>::kVec;
  static constexpr int kChunks = Tile<T>::kChunks;
  static constexpr int kThreads = kD * kChunks < 128 ? kD * kChunks : 128;
  static constexpr int kRows = kThreads / kChunks;
  static constexpr int kPasses = kD / kRows;
  static constexpr int kWarps = kThreads / 32;
  static_assert(32 % kChunks == 0 && kThreads % 32 == 0, "chunk layout");
  static_assert(kRows * kPasses == kD && kThreads >= kD, "row layout");
};

template <typename T> struct Bits;
template <> struct Bits<float> { using type = uint32_t; };
template <> struct Bits<__nv_bfloat16> { using type = uint16_t; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, offset));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(kFull, v, offset);
  return v;
}

// One chunk of a cache row: 16 bytes from p, of which the first `live`
// elements are wanted.  vec_ok: p is 16-byte aligned (one vector load);
// otherwise element loads, none past `live`.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, int live, int vec_ok) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (live <= 0) return r;
  if (vec_ok) return *reinterpret_cast<const uint4*>(p);
  using B = typename Bits<T>::type;
  constexpr int kVec = Tile<T>::kVec;
  B e[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    e[i] = i < live ? reinterpret_cast<const B*>(p)[i] : B(0);
  memcpy(&r, e, sizeof(r));
  return r;
}

// A chunk as floats, elements at or past `live` set to zero (so stale
// values past index, even NaN, contribute exact zeros).
__device__ __forceinline__ void unpack(const uint4& r, int live,
                                       float (&x)[4]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = i < live ? __uint_as_float(w[i]) : 0.f;
}
__device__ __forceinline__ void unpack(const uint4& r, int live,
                                       float (&x)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the top half of a float32
    x[2 * i] = 2 * i < live ? __uint_as_float(w[i] << 16) : 0.f;
    x[2 * i + 1] = 2 * i + 1 < live ? __uint_as_float(w[i] & 0xffff0000u) : 0.f;
  }
}

template <typename T, int kD>
__global__ void __launch_bounds__(Layout<T, kD>::kThreads)
decode_attention_split_kernel(
    const T* __restrict__ query, const T* __restrict__ new_k,
    const T* __restrict__ new_v, T* cache_k, T* cache_v,
    const int32_t* __restrict__ index_ptr, T* __restrict__ out,
    float* __restrict__ partials, int* __restrict__ counters, int len,
    int vec_ok) {
  using L = Layout<T, kD>;
  constexpr int kVec = L::kVec;
  constexpr int kChunks = L::kChunks;
  __shared__ float logit_s[L::kWarps][kSplit];
  __shared__ float p_s[kSplit];
  __shared__ float ml_s[2];
  __shared__ int last_s;

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int index = min(max(*index_ptr, 0), len - 1);
  const int p0 = split * kSplit;
  const size_t vec = static_cast<size_t>(bh) * kD;
  const size_t part_row = kD + 2;
  float* part = partials + (static_cast<size_t>(bh) * splits + split) * part_row;

  if (p0 < index) {
    const int chunk = tid % kChunks;
    const int row0 = tid / kChunks;
    const int pos = p0 + chunk * kVec;
    const int live = index - pos;   // this chunk's positions before index
    // Every load of the split is in flight before the first is used.
    uint4 k_raw[L::kPasses], v_raw[L::kPasses];
    float q[L::kPasses];
#pragma unroll
    for (int i = 0; i < L::kPasses; ++i) {
      const size_t row = vec + row0 + i * L::kRows;
      k_raw[i] = load_chunk(cache_k + row * len + pos, live, vec_ok);
      v_raw[i] = load_chunk(cache_v + row * len + pos, live, vec_ok);
      q[i] = to_float(query[row]);
    }

    // Logits of this chunk's positions, over this thread's rows, then over
    // the lanes holding the same chunk, then over the warps.
    float s[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) s[e] = 0.f;
#pragma unroll
    for (int i = 0; i < L::kPasses; ++i) {
      float k[kVec];
      unpack(k_raw[i], live, k);
#pragma unroll
      for (int e = 0; e < kVec; ++e) s[e] = fmaf(q[i], k[e], s[e]);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e)
#pragma unroll
      for (int offset = kChunks; offset < 32; offset <<= 1)
        s[e] += __shfl_xor_sync(kFull, s[e], offset);
    if (lane < kChunks) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) logit_s[warp][chunk * kVec + e] = s[e];
    }
    __syncthreads();

    if (warp == 0) {  // the split's softmax: positions lane + 32 r
      float x[kSplit / 32];
      float m = kNegInf;
#pragma unroll
      for (int r = 0; r < kSplit / 32; ++r) {
        const int j = lane + 32 * r;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < L::kWarps; ++w) sum += logit_s[w][j];
        x[r] = p0 + j < index ? sum : kNegInf;
        m = fmaxf(m, x[r]);
      }
      m = warp_max(m);
      float l = 0.f;
#pragma unroll
      for (int r = 0; r < kSplit / 32; ++r) {
        const int j = lane + 32 * r;
        const float p = p0 + j < index ? expf(x[r] - m) : 0.f;
        p_s[j] = p;
        l += p;
      }
      l = warp_sum(l);
      if (lane == 0) {
        ml_s[0] = m;
        ml_s[1] = l;
      }
    }
    __syncthreads();

    // acc[d] = sum_j p_j V[d, j]: over the chunk, then over the row's lanes.
#pragma unroll
    for (int i = 0; i < L::kPasses; ++i) {
      float v[kVec];
      unpack(v_raw[i], live, v);
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) a = fmaf(p_s[chunk * kVec + e], v[e], a);
#pragma unroll
      for (int offset = 1; offset < kChunks; offset <<= 1)
        a += __shfl_xor_sync(kFull, a, offset);
      if (chunk == 0) part[row0 + i * L::kRows] = a;
    }
    if (tid == 0) {
      part[kD] = ml_s[0];
      part[kD + 1] = ml_s[1];
    }
  }

  // Count this block; the partials are visible device-wide before it is.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(counters + bh, 1) == splits - 1;
  __syncthreads();

  // The cache write: column `index`, by the split that holds it, after its
  // reads (every thread of the block has passed the barriers above).
  if (split == index / kSplit) {
    for (int d = tid; d < kD; d += L::kThreads) {
      const size_t at = (vec + d) * len + index;
      cache_k[at] = new_k[vec + d];
      cache_v[at] = new_v[vec + d];
    }
  }
  if (!last_s) return;

  // The last block of this (batch, head): every other block has counted,
  // so the counter is reset for the next call, and the partials are read
  // from L2.  The merge walks the live splits 32 at a time, every load of
  // a round issued at once: lane i takes split i's (m, l), thread d its
  // acc[d]; the running state starts from position index (weight 1 at
  // m = s_new) and is rescaled as a larger max arrives.
  if (tid == 0) counters[bh] = 0;
  __threadfence();
  const int live_splits = (index + kSplit - 1) / kSplit;
  const float* parts = partials + static_cast<size_t>(bh) * splits * part_row;
  const int d = tid < kD ? tid : 0;   // threads past kD merge d = 0 unused

  float s_new = 0.f;   // q . new_k, in every warp
  for (int e = lane; e < kD; e += 32)
    s_new = fmaf(to_float(query[vec + e]), to_float(new_k[vec + e]), s_new);
  s_new = warp_sum(s_new);
  float m = s_new;
  float l = 1.f;
  float acc = to_float(new_v[vec + d]);
  for (int first = 0; first < live_splits; first += 32) {
    const int count = min(32, live_splits - first);
    const float* base = parts + static_cast<size_t>(first) * part_row;
    const bool mine = lane < count;
    const float m_s = mine ? __ldcg(base + lane * part_row + kD) : kNegInf;
    const float l_s = mine ? __ldcg(base + lane * part_row + kD + 1) : 0.f;
    float a[32];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      a[i] = i < count ? __ldcg(base + i * part_row + d) : 0.f;
    const float m_new = fmaxf(m, warp_max(m_s));
    const float rescale = expf(m - m_new);
    const float w = mine ? expf(m_s - m_new) : 0.f;
    l = l * rescale + warp_sum(w * l_s);
    acc *= rescale;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc = fmaf(__shfl_sync(kFull, w, i), a[i], acc);
    m = m_new;
  }
  if (tid < kD) store(out + vec + tid, acc / l);
}

template <typename T, int kD>
cudaError_t launch_split(const void* query, const void* new_k,
                         const void* new_v, void* cache_k, void* cache_v,
                         const void* index, void* out, void* partials,
                         void* counters, int batch_heads, int len, int splits,
                         cudaStream_t stream) {
  using L = Layout<T, kD>;
  const int vec_ok = len % L::kVec == 0 &&
                     reinterpret_cast<uintptr_t>(cache_k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(cache_v) % 16 == 0;
  const dim3 grid(splits, batch_heads);
  decode_attention_split_kernel<T, kD><<<grid, L::kThreads, 0, stream>>>(
      static_cast<const T*>(query), static_cast<const T*>(new_k),
      static_cast<const T*>(new_v), static_cast<T*>(cache_k),
      static_cast<T*>(cache_v), static_cast<const int32_t*>(index),
      static_cast<T*>(out), static_cast<float*>(partials),
      static_cast<int*>(counters), len, vec_ok);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* query, const void* new_k, const void* new_v,
                   void* cache_k, void* cache_v, const void* index, void* out,
                   void* partials, void* counters, int batch_heads,
                   int head_dim, int len, int splits, cudaStream_t stream) {
  switch (head_dim) {
    case 8:   // tiny_config
      return launch_split<T, 8>(query, new_k, new_v, cache_k, cache_v, index,
                                out, partials, counters, batch_heads, len,
                                splits, stream);
    case 64:  // mt3_config, ismir2021_config
      return launch_split<T, 64>(query, new_k, new_v, cache_k, cache_v,
                                 index, out, partials, counters, batch_heads,
                                 len, splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (query, new K/V, caches and output all
// share it); head_dim 8 or 64.  partials: float32 [batch_heads, splits,
// head_dim + 2] scratch; counters: int32 [>= batch_heads], all zero between
// calls (the kernel leaves them so); splits = ceil(len / 64).  Returns the
// cudaError_t of the launch.
int mt3_decode_attention(const void* query, const void* new_k,
                         const void* new_v, void* cache_k, void* cache_v,
                         const void* index, void* out, void* partials,
                         void* counters, int batch_heads, int head_dim,
                         int len, int splits, int dtype, void* stream) {
  if (batch_heads <= 0 || batch_heads > 65535 || len <= 0 ||
      splits != (len + kSplit - 1) / kSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(
        query, new_k, new_v, cache_k, cache_v, index, out, partials,
        counters, batch_heads, head_dim, len, splits, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(
        query, new_k, new_v, cache_k, cache_v, index, out, partials,
        counters, batch_heads, head_dim, len, splits, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mt3_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
