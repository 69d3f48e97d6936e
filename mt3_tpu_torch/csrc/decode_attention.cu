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
// Both kernels allocate nothing, launch on the caller's stream and do
// not synchronise.
//
// The grouped kernel (decode_attention_grouped_kernel) takes every other
// cache of the JAX package's decode: K/V heads shared by g query heads
// (GQA), int8 codes, and int4 codes packed two per byte along head_dim
// ([b, kv, d/2, len] uint8, row r = dims 2r and 2r+1 in the low and high
// nibble), both with float32 scales [b, kv, len].  It replaces the XLA
// branches of mt3_tpu/models/layers.py:_cached_attention_math (:497) that
// read those caches, and the column write of attention_decode_step (:379).
//   * Bound: memory again, now in codes: at the production shape (int4,
//     one K/V head, b=1024, index 1023) the live prefix is 72 bytes a
//     position and (batch, K/V head), 75.5 MB, 22.5 us at 3.35 TB/s.  With
//     g query heads on each K/V element the products reach 2*g flops a
//     code, so float32 FMAs come close to that bound as well.
//   * The same splits, grid (splits, b*kv), in-launch merge, counter reset,
//     clamp and ordered column write as the multi-head kernel, with one
//     block per (batch, K/V head, split) for all g query heads: the cache
//     is read once per K/V head, not once per query head.
//   * A block issues every 16-byte load of its split's K and V tiles and
//     scales at once, then unpacks them to float32 in shared memory
//     ([d][65], positions at or past index set to zero).  Threads then take
//     (query head, position) pairs for the logits and (query head, dim)
//     pairs for p . V, each a plain loop over shared memory: simple first,
//     and a later PR's to make fast.
//   * Dequantisation folds in as in the JAX branch: the product is over
//     the integer codes, logit_j *= k_scale[j] in float32, and the weight
//     p_j * v_scale[j] meets the V codes; the partials keep l = sum p_j.
//   * The new column is quantized in the kernel, in the steps XLA compiles
//     _quantize_kv to in the query's dtype: absmax over d; the scale
//     max|x| times the float32 reciprocal of levels, rounded to the dtype,
//     floored at 1e-8; codes rint(x / scale) (an IEEE division, rounded to
//     the dtype first), clamped as XLA's saturating cast.
//     The split holding index writes the codes and both scales; the last
//     block of each (batch, K/V head) recomputes them for the merge, where
//     position index enters from them.  So the quantized route keeps one
//     launch per layer and step.

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
template <> struct Bits<int8_t> { using type = uint8_t; };
template <> struct Bits<uint8_t> { using type = uint8_t; };

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

// ---------------------------------------------------------------------------
// The grouped kernel: grouped (GQA) float caches and int8 / int4 caches.
// ---------------------------------------------------------------------------
enum CacheKind { kCacheF32 = 0, kCacheBF16 = 1, kCacheInt8 = 2, kCacheInt4 = 3 };

// The stored element of each cache kind and the head dims one stored row
// holds (int4: two, in its two nibbles).
template <int kKind> struct CacheOf;
template <> struct CacheOf<kCacheF32> {
  using T = float;
  static constexpr int kDimsPerRow = 1;
};
template <> struct CacheOf<kCacheBF16> {
  using T = __nv_bfloat16;
  static constexpr int kDimsPerRow = 1;
};
template <> struct CacheOf<kCacheInt8> {
  using T = int8_t;
  static constexpr int kDimsPerRow = 1;
};
template <> struct CacheOf<kCacheInt4> {
  using T = uint8_t;
  static constexpr int kDimsPerRow = 2;
};

constexpr int kMaxGroup = 8;            // query heads per K/V head (ops MAX_GROUP)
constexpr int kGroupedThreads = 128;
constexpr int kGroupedWarps = kGroupedThreads / 32;
constexpr int kPitch = kSplit + 1;      // shared tiles [dim][kPitch]
static_assert(kGroupedThreads == 2 * kSplit && kSplit == 64, "layout");

// x rounded to the query's dtype, as each step of _quantize_kv rounds.
template <typename Q> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One 16-byte chunk (positions j0 .. j0 + kVec - 1 of stored row `row`) to
// float32 in the shared tile, positions at or past `live` as zeros.
template <int kKind>
__device__ __forceinline__ void store_chunk(const uint4& r, int live,
                                            float (*tile)[kPitch], int row,
                                            int j0) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  if constexpr (kKind == kCacheF32) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tile[row][j0 + e] = e < live ? __uint_as_float(w[e]) : 0.f;
  } else if constexpr (kKind == kCacheBF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      tile[row][j0 + 2 * i] =
          2 * i < live ? __uint_as_float(w[i] << 16) : 0.f;
      tile[row][j0 + 2 * i + 1] =
          2 * i + 1 < live ? __uint_as_float(w[i] & 0xffff0000u) : 0.f;
    }
  } else if constexpr (kKind == kCacheInt8) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int shift = 8 * (e & 3);
      const int code = static_cast<int32_t>(w[e >> 2] << (24 - shift)) >> 24;
      tile[row][j0 + e] = e < live ? static_cast<float>(code) : 0.f;
    }
  } else {  // int4: dim 2 row in the low nibble, 2 row + 1 in the high one
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int shift = 8 * (e & 3);
      const int low = static_cast<int32_t>(w[e >> 2] << (28 - shift)) >> 28;
      const int high = static_cast<int32_t>(w[e >> 2] << (24 - shift)) >> 28;
      tile[2 * row][j0 + e] = e < live ? static_cast<float>(low) : 0.f;
      tile[2 * row + 1][j0 + e] = e < live ? static_cast<float>(high) : 0.f;
    }
  }
}

// Two int4 codes as the byte a packed cache row holds: the first in the
// low nibble, the second in the high one, two's complement.
__device__ __forceinline__ uint8_t pack_nibbles(float low, float high) {
  return static_cast<uint8_t>((static_cast<int>(low) & 15) |
                              ((static_cast<int>(high) & 15) << 4));
}

template <typename Q, int kKind, int kD>
__global__ void __launch_bounds__(kGroupedThreads)
decode_attention_grouped_kernel(
    const Q* __restrict__ query, const Q* __restrict__ new_k,
    const Q* __restrict__ new_v, void* cache_k_raw, void* cache_v_raw,
    float* k_scale, float* v_scale, const int32_t* __restrict__ index_ptr,
    Q* __restrict__ out, float* __restrict__ partials,
    int* __restrict__ counters, int len, int group, int vec_ok) {
  using CT = typename CacheOf<kKind>::T;
  constexpr bool kQuant = kKind == kCacheInt8 || kKind == kCacheInt4;
  constexpr int kRows = kD / CacheOf<kKind>::kDimsPerRow;
  constexpr int kVec = Tile<CT>::kVec;              // positions per chunk
  constexpr int kChunksPerRow = kSplit / kVec;
  constexpr int kChunks = kRows * kChunksPerRow;
  constexpr int kPerThread = (kChunks + kGroupedThreads - 1) / kGroupedThreads;
  constexpr float kLevels = kKind == kCacheInt4 ? 7.f : 127.f;
  constexpr float kLow = kKind == kCacheInt4 ? -8.f : -128.f;
  constexpr float kHigh = kLevels;
  constexpr float kReciprocal = 1.f / kLevels;   // rounded to float32
  __shared__ float k_s[kD][kPitch];
  __shared__ float v_s[kD][kPitch];
  __shared__ float q_s[kMaxGroup][kD];
  __shared__ float p_s[kMaxGroup][kPitch];   // logits, then weights
  __shared__ float scale_s[2][kSplit];       // k_scale, v_scale of the split
  __shared__ float col_s[2][kD];             // new K/V column: codes or values
  __shared__ float col_scale_s[2];
  __shared__ float amax_s[2][kGroupedWarps];
  __shared__ float head_s[kMaxGroup][3];     // merge: s_new, m, l
  __shared__ int last_s;

  CT* cache_k = static_cast<CT*>(cache_k_raw);
  CT* cache_v = static_cast<CT*>(cache_v_raw);
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int bkv = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int index = min(max(*index_ptr, 0), len - 1);
  const int p0 = split * kSplit;
  const size_t head0 = static_cast<size_t>(bkv) * group;  // first query head
  const size_t row0 = static_cast<size_t>(bkv) * kRows;   // first cache row
  const size_t part_row = kD + 2;
  const size_t part_head = static_cast<size_t>(splits) * part_row;

  for (int i = tid; i < group * kD; i += kGroupedThreads)
    q_s[i / kD][i % kD] = to_float(query[head0 * kD + i]);

  if (p0 < index) {
    // Every load of the split is in flight before the first is used.
    uint4 k_raw[kPerThread], v_raw[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = tid + i * kGroupedThreads;
      const int pos = p0 + (c % kChunksPerRow) * kVec;
      const size_t at = (row0 + c / kChunksPerRow) * len + pos;
      const int live = c < kChunks ? index - pos : 0;
      k_raw[i] = load_chunk(cache_k + (c < kChunks ? at : 0), live, vec_ok);
      v_raw[i] = load_chunk(cache_v + (c < kChunks ? at : 0), live, vec_ok);
    }
    float scale = 0.f;   // threads < kSplit: k_scale, the others v_scale
    const int js = tid % kSplit;
    if (kQuant && p0 + js < index)
      scale = (tid < kSplit ? k_scale : v_scale)[
          static_cast<size_t>(bkv) * len + p0 + js];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = tid + i * kGroupedThreads;
      if (c < kChunks) {
        const int j0 = (c % kChunksPerRow) * kVec;
        store_chunk<kKind>(k_raw[i], index - p0 - j0, k_s, c / kChunksPerRow,
                           j0);
        store_chunk<kKind>(v_raw[i], index - p0 - j0, v_s, c / kChunksPerRow,
                           j0);
      }
    }
    scale_s[tid / kSplit][js] = scale;
    __syncthreads();

    // Logits: a (query head, position) pair per thread and round.
    for (int pair = tid; pair < group * kSplit; pair += kGroupedThreads) {
      const int hq = pair / kSplit;
      const int j = pair % kSplit;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) s = fmaf(q_s[hq][d], k_s[d][j], s);
      if (kQuant) s *= scale_s[0][j];
      p_s[hq][j] = p0 + j < index ? s : kNegInf;
    }
    __syncthreads();

    // The split's softmax, a warp per query head: positions lane, lane + 32.
    float* part = partials + (head0 * splits + split) * part_row;
    for (int hq = warp; hq < group; hq += kGroupedWarps) {
      const float x0 = p_s[hq][lane];
      const float x1 = p_s[hq][lane + 32];
      const float m = warp_max(fmaxf(x0, x1));
      const float e0 = p0 + lane < index ? expf(x0 - m) : 0.f;
      const float e1 = p0 + lane + 32 < index ? expf(x1 - m) : 0.f;
      const float l = warp_sum(e0 + e1);
      p_s[hq][lane] = kQuant ? e0 * scale_s[1][lane] : e0;
      p_s[hq][lane + 32] = kQuant ? e1 * scale_s[1][lane + 32] : e1;
      if (lane == 0) {
        part[hq * part_head + kD] = m;
        part[hq * part_head + kD + 1] = l;
      }
    }
    __syncthreads();

    // acc[d] = sum_j w_j V[d, j]: a (query head, dim) pair per thread.
    for (int pair = tid; pair < group * kD; pair += kGroupedThreads) {
      const int hq = pair / kD;
      const int d = pair % kD;
      float a = 0.f;
#pragma unroll 16
      for (int j = 0; j < kSplit; ++j) a = fmaf(p_s[hq][j], v_s[d][j], a);
      part[hq * part_head + d] = a;
    }
  }

  // Count this block; the partials are visible device-wide before it is.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(counters + bkv, 1) == splits - 1;
  __syncthreads();
  const bool writer = split == index / kSplit;
  const bool last = last_s;
  if (!writer && !last) return;

  // The new column as the cache holds it: quantized as _quantize_kv does,
  // in the query's dtype, or as it is.
  const size_t vec = static_cast<size_t>(bkv) * kD;
  const float xk = tid < kD ? to_float(new_k[vec + tid]) : 0.f;
  const float xv = tid < kD ? to_float(new_v[vec + tid]) : 0.f;
  if constexpr (kQuant) {
    const float ak = warp_max(fabsf(xk));
    const float av = warp_max(fabsf(xv));
    if (lane == 0) {
      amax_s[0][warp] = ak;
      amax_s[1][warp] = av;
    }
    __syncthreads();
    float scale[2] = {amax_s[0][0], amax_s[1][0]};
#pragma unroll
    for (int w = 1; w < kGroupedWarps; ++w) {
      scale[0] = fmaxf(scale[0], amax_s[0][w]);
      scale[1] = fmaxf(scale[1], amax_s[1][w]);
    }
    const float min_scale = round_to<Q>(1e-8f);
#pragma unroll
    for (int c = 0; c < 2; ++c)
      scale[c] = fmaxf(round_to<Q>(scale[c] * kReciprocal), min_scale);
    if (tid < kD) {
      col_s[0][tid] = fminf(fmaxf(
          rintf(round_to<Q>(__fdiv_rn(xk, scale[0]))), kLow), kHigh);
      col_s[1][tid] = fminf(fmaxf(
          rintf(round_to<Q>(__fdiv_rn(xv, scale[1]))), kLow), kHigh);
    }
    if (tid == 0) {
      col_scale_s[0] = scale[0];
      col_scale_s[1] = scale[1];
    }
  } else if (tid < kD) {
    col_s[0][tid] = xk;
    col_s[1][tid] = xv;
  }
  __syncthreads();

  // The cache write: column `index`, by the split that holds it, after its
  // reads (every thread of the block has passed the barriers above).
  if (writer) {
    for (int r = tid; r < kRows; r += kGroupedThreads) {
      const size_t at = (row0 + r) * len + index;
      if constexpr (kKind == kCacheInt4) {
        cache_k[at] = pack_nibbles(col_s[0][2 * r], col_s[0][2 * r + 1]);
        cache_v[at] = pack_nibbles(col_s[1][2 * r], col_s[1][2 * r + 1]);
      } else if constexpr (kKind == kCacheInt8) {
        cache_k[at] = static_cast<int8_t>(static_cast<int>(col_s[0][r]));
        cache_v[at] = static_cast<int8_t>(static_cast<int>(col_s[1][r]));
      } else {   // a float cache holds the query's dtype
        cache_k[at] = new_k[vec + r];
        cache_v[at] = new_v[vec + r];
      }
    }
    if (kQuant && tid < 2)
      (tid == 0 ? k_scale : v_scale)[static_cast<size_t>(bkv) * len + index] =
          col_scale_s[tid];
  }
  if (!last) return;

  // The last block of this (batch, K/V head): reset the counter, then per
  // query head the merge of the live splits with position index, a warp
  // per head for (m, l), then a (head, dim) pair per thread for acc.
  if (tid == 0) counters[bkv] = 0;
  __threadfence();
  const int live_splits = (index + kSplit - 1) / kSplit;
  const float k_scale_new = kQuant ? col_scale_s[0] : 1.f;
  const float v_scale_new = kQuant ? col_scale_s[1] : 1.f;
  for (int hq = warp; hq < group; hq += kGroupedWarps) {
    const float* parts = partials + (head0 + hq) * part_head;
    float s = 0.f;
    for (int d = lane; d < kD; d += 32) s = fmaf(q_s[hq][d], col_s[0][d], s);
    s = warp_sum(s) * k_scale_new;
    float m = s;
    for (int sp = lane; sp < live_splits; sp += 32)
      m = fmaxf(m, __ldcg(parts + sp * part_row + kD));
    m = warp_max(m);
    float l = 0.f;
    for (int sp = lane; sp < live_splits; sp += 32)
      l += expf(__ldcg(parts + sp * part_row + kD) - m) *
           __ldcg(parts + sp * part_row + kD + 1);
    l = warp_sum(l) + expf(s - m);
    if (lane == 0) {
      head_s[hq][0] = s;
      head_s[hq][1] = m;
      head_s[hq][2] = l;
    }
  }
  __syncthreads();
  for (int pair = tid; pair < group * kD; pair += kGroupedThreads) {
    const int hq = pair / kD;
    const int d = pair % kD;
    const float* parts = partials + (head0 + hq) * part_head;
    const float m = head_s[hq][1];
    float acc = expf(head_s[hq][0] - m) * v_scale_new * col_s[1][d];
    for (int sp = 0; sp < live_splits; ++sp)
      acc = fmaf(expf(__ldcg(parts + sp * part_row + kD) - m),
                 __ldcg(parts + sp * part_row + d), acc);
    store(out + (head0 + hq) * kD + d, acc / head_s[hq][2]);
  }
}

template <typename Q, int kKind, int kD>
cudaError_t launch_grouped(const void* query, const void* new_k,
                           const void* new_v, void* cache_k, void* cache_v,
                           void* k_scale, void* v_scale, const void* index,
                           void* out, void* partials, void* counters,
                           int batch_kv, int group, int len, int splits,
                           cudaStream_t stream) {
  constexpr int kVec = Tile<typename CacheOf<kKind>::T>::kVec;
  const int vec_ok = len % kVec == 0 &&
                     reinterpret_cast<uintptr_t>(cache_k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(cache_v) % 16 == 0;
  const dim3 grid(splits, batch_kv);
  decode_attention_grouped_kernel<Q, kKind, kD>
      <<<grid, kGroupedThreads, 0, stream>>>(
          static_cast<const Q*>(query), static_cast<const Q*>(new_k),
          static_cast<const Q*>(new_v), cache_k, cache_v,
          static_cast<float*>(k_scale), static_cast<float*>(v_scale),
          static_cast<const int32_t*>(index), static_cast<Q*>(out),
          static_cast<float*>(partials), static_cast<int*>(counters), len,
          group, vec_ok);
  return cudaGetLastError();
}

template <typename Q, int kKind>
cudaError_t launch_grouped_dim(const void* query, const void* new_k,
                               const void* new_v, void* cache_k,
                               void* cache_v, void* k_scale, void* v_scale,
                               const void* index, void* out, void* partials,
                               void* counters, int batch_kv, int group,
                               int head_dim, int len, int splits,
                               cudaStream_t stream) {
  switch (head_dim) {
    case 8:
      return launch_grouped<Q, kKind, 8>(
          query, new_k, new_v, cache_k, cache_v, k_scale, v_scale, index,
          out, partials, counters, batch_kv, group, len, splits, stream);
    case 64:
      return launch_grouped<Q, kKind, 64>(
          query, new_k, new_v, cache_k, cache_v, k_scale, v_scale, index,
          out, partials, counters, batch_kv, group, len, splits, stream);
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

// The grouped kernel.  query [batch_kv * group, head_dim] and out alike;
// new_k/new_v [batch_kv, head_dim] in the query's dtype (0 = float32, 1 =
// bfloat16); caches [batch_kv, rows, len] of cache_kind 0 (float32, the
// query's dtype), 1 (bfloat16, likewise), 2 (int8, rows = head_dim) or 3
// (int4 packed two per uint8, rows = head_dim / 2); k_scale/v_scale float32
// [batch_kv, len] for kinds 2 and 3, else null; group 1 to 8 query heads
// per K/V head; partials float32 [batch_kv * group, splits, head_dim + 2];
// counters int32 [>= batch_kv], all zero between calls.  Returns the
// cudaError_t of the launch.
int mt3_decode_attention_grouped(
    const void* query, const void* new_k, const void* new_v, void* cache_k,
    void* cache_v, void* k_scale, void* v_scale, const void* index,
    void* out, void* partials, void* counters, int batch_kv, int group,
    int head_dim, int len, int splits, int dtype, int cache_kind,
    void* stream) {
  const bool quantized = cache_kind == kCacheInt8 || cache_kind == kCacheInt4;
  if (batch_kv <= 0 || batch_kv > 65535 || group < 1 || group > kMaxGroup ||
      len <= 0 || splits != (len + kSplit - 1) / kSplit ||
      quantized != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MT3_GROUPED(Q, KIND)                                                 \
  launch_grouped_dim<Q, KIND>(query, new_k, new_v, cache_k, cache_v,         \
                              k_scale, v_scale, index, out, partials,        \
                              counters, batch_kv, group, head_dim, len,      \
                              splits, s)
  cudaError_t status = cudaErrorInvalidValue;
  if (dtype == 0 && cache_kind == kCacheF32)
    status = MT3_GROUPED(float, kCacheF32);
  else if (dtype == 0 && cache_kind == kCacheInt8)
    status = MT3_GROUPED(float, kCacheInt8);
  else if (dtype == 0 && cache_kind == kCacheInt4)
    status = MT3_GROUPED(float, kCacheInt4);
  else if (dtype == 1 && cache_kind == kCacheBF16)
    status = MT3_GROUPED(__nv_bfloat16, kCacheBF16);
  else if (dtype == 1 && cache_kind == kCacheInt8)
    status = MT3_GROUPED(__nv_bfloat16, kCacheInt8);
  else if (dtype == 1 && cache_kind == kCacheInt4)
    status = MT3_GROUPED(__nv_bfloat16, kCacheInt4);
#undef MT3_GROUPED
  return static_cast<int>(status);
}

const char* mt3_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
