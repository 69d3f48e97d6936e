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
// The grouped kernels take every other cache of the JAX package's decode:
// K/V heads shared by g <= 8 query heads (GQA), int8 codes, and int4 codes
// packed two per byte along head_dim ([b, kv, d/2, len] uint8, row r =
// dims 2r and 2r+1 in the low and high nibble), both with float32 scales
// [b, kv, len].  They replace the XLA branches of
// mt3_tpu/models/layers.py:_cached_attention_math (:497) that read those
// caches, and the column write of attention_decode_step (:379).
//   * Bound: memory, now in codes.  At the production shape (int4, one K/V
//     head, b=1024, index 1023) the live prefix is 72 bytes a position and
//     (batch, K/V head), 75.5 MB, 22.5 us at 3.35 TB/s; the products are
//     2*g flops a code, far below the bf16 tensor-core rate.  So the codes
//     must travel from HBM to the tensor cores at their own width, with
//     enough of them in flight, and every other step must stay off the
//     critical path.
//   * Blocks.  Grid (splits, b*kv): one block per (batch, K/V head) and
//     `span` positions (a multiple of 64) for all g query heads, so the
//     cache is read once per K/V head.  The wrapper picks span from b*kv
//     and len, never from index, so a captured graph stays valid: where
//     b*kv fills the card (b=1024) span = len, one block walks the whole
//     live prefix and writes out itself, with no partials and no counter;
//     where it does not (b=8), span = 64 and the blocks merge in the
//     launch as the multi-head kernel's do (partials[b*h, splits, d + 2],
//     the last block of each (batch, K/V head) merges and resets its
//     counter).  `index` is read from device memory and clamped to
//     [0, len - 1]; the block holding column index writes it after its
//     reads.
//   * bfloat16 queries with head dim 64 (decode_attention_grouped_tc_kernel):
//     both products on the tensor cores, mma.sync.m16n8k16 bf16 -> float32,
//     with the g query heads as the N = 8 columns.  A block walks its span
//     in 64-position tiles through a cp.async ring (3 stages for int4, 2
//     for int8 and bf16; positions at or past index zero-filled; each
//     16-byte copy asks L2 for the 256 bytes around it, which the next
//     tiles of the row read), codes kept at their stored width in shared
//     memory (rows padded to 80 bytes, conflict-free for the loads below;
//     bf16 rows 128 bytes, 16-byte chunks XOR-swizzled by row % 8 for
//     ldmatrix).  Warp w takes
//     positions 16w .. 16w + 15 of every tile and keeps its own online
//     softmax state (m, l per head; acc in registers), so a tile costs one
//     barrier; the four warps' states are merged once, at the end.
//       - Logits S^T[16 positions, 8 heads] = K q^T, over d in four k-steps:
//         the A fragment pairs dims 2t, 2t + 1 at one position, which is
//         one int4 byte; bf16 K comes by ldmatrix.trans, int8 K as bytes
//         of neighbouring rows.  For codes, fragment rows g and g + 8 are
//         positions 2g and 2g + 1 (row_position), so a thread's K bytes
//         are 16-bit loads and its V bytes 32-bit loads.  The codes become
//         bf16 in registers, exactly (byte_perm into a float32 magic number
//         for int8; for int4 the nibble under the bf16 exponent byte 0x43,
//         which is code + 136, the bias taken off through the
//         accumulators: the logits' starts at -136 sum_d q_d, and a product
//         of the weights with ones tracks the 136 sum_j w_j taken off acc).
//       - k_scale (and log2 e) multiplies S^T's rows in float32, the mask
//         sets positions >= index to -1e30 (and their weights to 0), the
//         running max rescales l and, when it moved, acc; p = 2^(s - m).
//       - w = p * v_scale is rounded to bf16, JAX's
//         (weights * v_scale).astype(dtype) rounding point, and movmatrix
//         transposes the two 8x8 halves of the bf16 S^T fragment into the
//         B fragment (positions as depth) of O^T[64 dims, 8 heads] = V w^T,
//         whose A fragment is V's rows as stored (positions contiguous):
//         four products, one per 16 dims.
//   * float32 queries, and tiny_config's head dim 8 (below one k16 step),
//     take decode_attention_grouped_fma_kernel: exact float32 FMAs, as the
//     JAX reference runs float32 at HIGHEST precision and the port never
//     turns on TF32.  It walks the same blocks and tiles, unpacking a
//     tile to float32 in shared memory and looping over (query head,
//     position) and (query head, dim) pairs, with the same online softmax
//     per head and the same rounding point for the weights.  The C entry
//     routes by dtype and head dim; every call launches one of the two.
//   * The new column is quantized in the kernel, in the steps XLA compiles
//     _quantize_kv to in the query's dtype: absmax over d; the scale
//     max|x| times the float32 reciprocal of levels, rounded to the dtype,
//     floored at 1e-8; codes rint(x / scale) (an IEEE division, rounded to
//     the dtype first), clamped as XLA's saturating cast.  Every block
//     quantizes it at its start, while its first tiles load
//     (grouped_column); the block holding index writes the codes and both
//     scales after its reads, and the merging block takes position index
//     from them (its weight rounded as the tiles' are).  So the quantized
//     route keeps one launch per layer and step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

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
// The grouped kernels: grouped (GQA) float caches and int8 / int4 caches.
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
constexpr int kTile = kSplit;           // positions a block takes at a time
constexpr int kPitch = kTile + 1;       // FMA kernel's float tiles [dim][kPitch]
static_assert(kGroupedThreads == 2 * kTile && kTile == 64, "layout");

// Everything a grouped kernel reads or writes, and its blocks' span.
struct GroupedArgs {
  const void* query;     // [batch_kv * group, head_dim], the query dtype
  const void* new_k;     // [batch_kv, head_dim]
  const void* new_v;
  void* cache_k;         // [batch_kv, rows, len]
  void* cache_v;
  float* k_scale;        // [batch_kv, len] or null
  float* v_scale;
  const int32_t* index;  // one element
  void* out;             // like query
  float* partials;       // [batch_kv * group, splits, head_dim + 2]; null if splits == 1
  int* counters;         // [>= batch_kv], zero between calls
  int len;
  int group;
  int span;              // positions per block, a multiple of kTile
  int vec_ok;            // 16-byte loads of cache and scale rows are aligned
};

// x rounded to the query's dtype, as each step of _quantize_kv rounds, and
// as the weights are rounded before the V product.
template <typename Q> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two int4 codes as the byte a packed cache row holds: the first in the
// low nibble, the second in the high one, two's complement.
__device__ __forceinline__ uint8_t pack_nibbles(float low, float high) {
  return static_cast<uint8_t>((static_cast<int>(low) & 15) |
                              ((static_cast<int>(high) & 15) << 4));
}

// The new K/V column as the cache holds it, into col[2][kD] (codes, or
// the values) and col_scale[2]: quantized as _quantize_kv does, in the
// query's dtype.  Every thread of the block calls it at the start, so that
// its loads overlap the first tiles'; the caller's next barrier publishes
// it.
template <typename Q, int kKind, int kD>
__device__ __forceinline__ void grouped_column(const GroupedArgs& a,
                                               float (*col_s)[kD],
                                               float* col_scale_s) {
  constexpr bool kQuant = kKind == kCacheInt8 || kKind == kCacheInt4;
  constexpr float kLevels = kKind == kCacheInt4 ? 7.f : 127.f;
  constexpr float kLow = kKind == kCacheInt4 ? -8.f : -128.f;
  constexpr float kHigh = kLevels;
  constexpr float kReciprocal = 1.f / kLevels;   // rounded to float32
  __shared__ float amax_s[2][kGroupedWarps];
  const Q* new_k = static_cast<const Q*>(a.new_k);
  const Q* new_v = static_cast<const Q*>(a.new_v);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // The new column as the cache holds it: quantized as _quantize_kv does,
  // in the query's dtype, or as it is.
  const size_t vec = static_cast<size_t>(blockIdx.y) * kD;
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
    if (tid == 0) col_scale_s[0] = col_scale_s[1] = 1.f;
  }
}

// The end of every grouped block.  `state` holds the block's softmax state
// per query head over its positions, [acc[0..kD), m, l] (valid when
// `live`).  With several splits the block writes it to the partials and
// counts itself; the block holding column index writes the
// new column (grouped_column's) after its reads; the last block (the only
// one, with one split) merges the states with position index and writes
// out.
template <typename Q, int kKind, int kD>
__device__ __forceinline__ void grouped_finish(const GroupedArgs& a,
                                               float (*state)[kD + 2],
                                               bool live, int index,
                                               const float (*col_s)[kD],
                                               const float* col_scale_s) {
  constexpr bool kQuant = kKind == kCacheInt8 || kKind == kCacheInt4;
  constexpr int kRows = kD / CacheOf<kKind>::kDimsPerRow;
  constexpr int kRow = kD + 2;
  __shared__ float head_s[kMaxGroup][3];     // merge: s_new, m, l
  __shared__ int last_s;

  using CT = typename CacheOf<kKind>::T;
  const Q* query = static_cast<const Q*>(a.query);
  const Q* new_k = static_cast<const Q*>(a.new_k);
  const Q* new_v = static_cast<const Q*>(a.new_v);
  CT* cache_k = static_cast<CT*>(a.cache_k);
  CT* cache_v = static_cast<CT*>(a.cache_v);
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int bkv = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = a.group;
  const size_t head0 = static_cast<size_t>(bkv) * group;
  const size_t part_head = static_cast<size_t>(splits) * kRow;

  bool last = true;
  if (splits > 1) {
    if (live) {
      for (int i = tid; i < group * kRow; i += kGroupedThreads)
        a.partials[(head0 + i / kRow) * part_head +
                   static_cast<size_t>(split) * kRow + i % kRow] =
            state[i / kRow][i % kRow];
    }
    // Count this block; the partials are visible device-wide before it is.
    __threadfence();
    __syncthreads();
    if (tid == 0) last_s = atomicAdd(a.counters + bkv, 1) == splits - 1;
    __syncthreads();
    last = last_s;
  }
  const bool writer = split == index / a.span;
  if (!writer && !last) return;
  const size_t vec = static_cast<size_t>(bkv) * kD;

  // The cache write: column `index`, by the block that holds it, after its
  // reads (every thread of the block has passed the barriers above).
  if (writer) {
    const size_t row0 = static_cast<size_t>(bkv) * kRows;
    for (int r = tid; r < kRows; r += kGroupedThreads) {
      const size_t at = (row0 + r) * a.len + index;
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
      (tid == 0 ? a.k_scale : a.v_scale)[static_cast<size_t>(bkv) * a.len +
                                         index] = col_scale_s[tid];
  }
  if (!last) return;

  // The merge: the live splits' states (or this block's own) with position
  // index, a warp per query head for (m, l), then a (head, dim) pair per
  // thread for acc.  Several splits: reset the counter, read the partials
  // from L2.
  const float* parts;
  size_t head_stride;
  int sources;
  if (splits > 1) {
    if (tid == 0) a.counters[bkv] = 0;
    __threadfence();
    parts = a.partials + head0 * part_head;
    head_stride = part_head;
    sources = (index + a.span - 1) / a.span;
  } else {
    parts = &state[0][0];
    head_stride = kRow;
    sources = live ? 1 : 0;
  }
  auto load = [&](const float* p) { return splits > 1 ? __ldcg(p) : *p; };
  const float k_scale_new = kQuant ? col_scale_s[0] : 1.f;
  const float v_scale_new = kQuant ? col_scale_s[1] : 1.f;
  for (int hq = warp; hq < group; hq += kGroupedWarps) {
    const float* mine = parts + hq * head_stride;
    float s = 0.f;
    for (int d = lane; d < kD; d += 32)
      s = fmaf(to_float(query[(head0 + hq) * kD + d]), col_s[0][d], s);
    s = warp_sum(s) * k_scale_new;
    float m = s;
    for (int sp = lane; sp < sources; sp += 32)
      m = fmaxf(m, load(mine + sp * kRow + kD));
    m = warp_max(m);
    float l = 0.f;
    for (int sp = lane; sp < sources; sp += 32)
      l += expf(load(mine + sp * kRow + kD) - m) * load(mine + sp * kRow + kD + 1);
    l = warp_sum(l) + expf(s - m);
    if (lane == 0) {
      head_s[hq][0] = s;
      head_s[hq][1] = m;
      head_s[hq][2] = l;
    }
  }
  __syncthreads();
  Q* out = static_cast<Q*>(a.out);
  for (int pair = tid; pair < group * kD; pair += kGroupedThreads) {
    const int hq = pair / kD;
    const int d = pair % kD;
    const float* mine = parts + hq * head_stride;
    const float m = head_s[hq][1];
    float acc = round_to<Q>(expf(head_s[hq][0] - m) * v_scale_new) *
                col_s[1][d];
    // Eight splits a round, every load of a round issued at once.
    for (int first = 0; first < sources; first += 8) {
      float m_sp[8], acc_sp[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* part = mine + (first + i) * kRow;
        const bool used = first + i < sources;
        m_sp[i] = used ? load(part + kD) : kNegInf;
        acc_sp[i] = used ? load(part + d) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc = fmaf(expf(m_sp[i] - m), acc_sp[i], acc);
    }
    store(out + (head0 + hq) * kD + d, acc / head_s[hq][2]);
  }
}

// ---------------------------------------------------------------------------
// float32 queries (and head dim 8): exact FMAs over float32 tiles.
// ---------------------------------------------------------------------------

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

template <typename Q, int kKind, int kD>
__global__ void __launch_bounds__(kGroupedThreads)
decode_attention_grouped_fma_kernel(GroupedArgs a) {
  using CT = typename CacheOf<kKind>::T;
  constexpr bool kQuant = kKind == kCacheInt8 || kKind == kCacheInt4;
  constexpr int kRows = kD / CacheOf<kKind>::kDimsPerRow;
  constexpr int kVec = Tile<CT>::kVec;              // positions per chunk
  constexpr int kChunksPerRow = kTile / kVec;
  constexpr int kChunks = kRows * kChunksPerRow;
  constexpr int kPerThread = (kChunks + kGroupedThreads - 1) / kGroupedThreads;
  constexpr int kPairs = (kMaxGroup * kD + kGroupedThreads - 1) / kGroupedThreads;
  constexpr int kHeadsPerWarp = kMaxGroup / kGroupedWarps;
  __shared__ float k_s[kD][kPitch];
  __shared__ float v_s[kD][kPitch];
  __shared__ float q_s[kMaxGroup][kD];
  __shared__ float p_s[kMaxGroup][kPitch];   // logits, then weights
  __shared__ float scale_s[2][kTile];        // k_scale, v_scale of the tile
  __shared__ float rescale_s[kMaxGroup];
  __shared__ float state[kMaxGroup][kD + 2];
  __shared__ float col_s[2][kD];             // the new column (grouped_column)
  __shared__ float col_scale_s[2];

  const CT* cache_k = static_cast<const CT*>(a.cache_k);
  const CT* cache_v = static_cast<const CT*>(a.cache_v);
  const Q* query = static_cast<const Q*>(a.query);
  const int bkv = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int group = a.group;
  const int len = a.len;
  const int index = min(max(*a.index, 0), len - 1);
  const int p_begin = blockIdx.x * a.span;
  const int p_end = min(p_begin + a.span, index);
  const size_t head0 = static_cast<size_t>(bkv) * group;  // first query head
  const size_t row0 = static_cast<size_t>(bkv) * kRows;   // first cache row

  for (int i = tid; i < group * kD; i += kGroupedThreads)
    q_s[i / kD][i % kD] = to_float(query[head0 * kD + i]);
  grouped_column<Q, kKind, kD>(a, col_s, col_scale_s);
  // Running state: acc of this thread's (head, dim) pairs; (m, l) of the
  // warp's heads warp, warp + 4, alike in every lane.
  float acc[kPairs];
  float m_run[kHeadsPerWarp], l_run[kHeadsPerWarp];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) acc[i] = 0.f;
#pragma unroll
  for (int k = 0; k < kHeadsPerWarp; ++k) {
    m_run[k] = kNegInf;
    l_run[k] = 0.f;
  }

  for (int p0 = p_begin; p0 < p_end; p0 += kTile) {
    // Every load of the tile is in flight before the first is used.
    uint4 k_raw[kPerThread], v_raw[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int c = tid + i * kGroupedThreads;
      const int pos = p0 + (c % kChunksPerRow) * kVec;
      const size_t at = (row0 + c / kChunksPerRow) * len + pos;
      const int live = c < kChunks ? index - pos : 0;
      k_raw[i] = load_chunk(cache_k + (c < kChunks ? at : 0), live, a.vec_ok);
      v_raw[i] = load_chunk(cache_v + (c < kChunks ? at : 0), live, a.vec_ok);
    }
    float scale = 0.f;   // threads < kTile: k_scale, the others v_scale
    const int js = tid % kTile;
    if (kQuant && p0 + js < index)
      scale = (tid < kTile ? a.k_scale : a.v_scale)[
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
    scale_s[tid / kTile][js] = scale;
    __syncthreads();

    // Logits: a (query head, position) pair per thread and round.
    for (int pair = tid; pair < group * kTile; pair += kGroupedThreads) {
      const int hq = pair / kTile;
      const int j = pair % kTile;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) s = fmaf(q_s[hq][d], k_s[d][j], s);
      if (kQuant) s *= scale_s[0][j];
      p_s[hq][j] = p0 + j < index ? s : kNegInf;
    }
    __syncthreads();

    // The online softmax, a warp per query head: positions lane, lane + 32.
#pragma unroll
    for (int k = 0; k < kHeadsPerWarp; ++k) {
      const int hq = warp + k * kGroupedWarps;
      if (hq >= group) break;
      const float x0 = p_s[hq][lane];
      const float x1 = p_s[hq][lane + 32];
      const float m = fmaxf(m_run[k], warp_max(fmaxf(x0, x1)));
      const float rescale = expf(m_run[k] - m);
      const float e0 = p0 + lane < index ? expf(x0 - m) : 0.f;
      const float e1 = p0 + lane + 32 < index ? expf(x1 - m) : 0.f;
      l_run[k] = l_run[k] * rescale + warp_sum(e0 + e1);
      m_run[k] = m;
      p_s[hq][lane] = round_to<Q>(kQuant ? e0 * scale_s[1][lane] : e0);
      p_s[hq][lane + 32] =
          round_to<Q>(kQuant ? e1 * scale_s[1][lane + 32] : e1);
      if (lane == 0) rescale_s[hq] = rescale;
    }
    __syncthreads();

    // acc[d] = acc[d] * rescale + sum_j w_j V[d, j]: (query head, dim) pairs.
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int pair = tid + i * kGroupedThreads;
      if (pair < group * kD) {
        const int hq = pair / kD;
        const int d = pair % kD;
        float s = acc[i] * rescale_s[hq];
#pragma unroll 16
        for (int j = 0; j < kTile; ++j) s = fmaf(p_s[hq][j], v_s[d][j], s);
        acc[i] = s;
      }
    }
    __syncthreads();   // the tiles are overwritten next
  }

#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int pair = tid + i * kGroupedThreads;
    if (pair < group * kD) state[pair / kD][pair % kD] = acc[i];
  }
#pragma unroll
  for (int k = 0; k < kHeadsPerWarp; ++k) {
    const int hq = warp + k * kGroupedWarps;
    if (lane == 0 && hq < group) {
      state[hq][kD] = m_run[k];
      state[hq][kD + 1] = l_run[k];
    }
  }
  __syncthreads();
  grouped_finish<Q, kKind, kD>(a, state, p_begin < index, index, col_s,
                               col_scale_s);
}

// ---------------------------------------------------------------------------
// bfloat16 queries, head dim 64: both products on the tensor cores.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 g + t): A holds rows g and
// g + 8 at columns 2t, 2t + 1 (+ 8); B holds rows (k) 2t, 2t + 1 (+ 8) at
// column (n) g; the accumulator holds rows g (c0, c1) and g + 8 (c2, c3)
// at columns 2t, 2t + 1.  Here the columns are the query heads.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously, of which the first `bytes`
// (0 to 16) are read and the rest zero-filled.  L2 fetches the 256 bytes
// around them: a tile reads 64 or 128 bytes of each cache row, and the
// block's next tiles read the bytes after them, so they come from L2.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// The 8x8 bf16 matrix whose fragment (rows lane / 4, columns 2 (lane % 4)
// and + 1) this warp holds, transposed, in the same fragment layout.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
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
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four int8 codes (the bytes of `four`) as two bf16 pairs, exactly: bytes
// (0, 1) and (2, 3), or with kEvenOdd bytes (0, 2) and (1, 3).  Each code
// + 128 goes into the low byte of the float32 2^23 + 128, whose
// subtraction leaves the code; |code| <= 128 has at most 8 significant
// bits, so the float's top half is the code in bf16.
template <bool kEvenOdd>
__device__ __forceinline__ void int8x4_to_bf16(uint32_t four, uint32_t& a,
                                               uint32_t& b) {
  const uint32_t x = four ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 + i)) -
           8388736.f;
  const int first = kEvenOdd ? 2 : 1;
  a = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[first]), 0x7632);
  b = __byte_perm(__float_as_uint(f[3 - first]), __float_as_uint(f[3]),
                  0x7632);
}

// int4 codes enter the products biased, as code + 136, exactly: the
// nibble's code + 8 becomes the low mantissa bits of bf16 128 (byte 0x43
// above it), so each pair costs a mask, a shift and a byte_perm.  The
// bias leaves each logit raised by 136 * sum_d q_d, which the logits'
// accumulator starts below, and each V product raised by 136 * sum_j w_j,
// which a product with ones tracks and which is taken off at the end.
constexpr float kInt4Bias = 136.f;

// Two packed int4 bytes (bits 0-7 and 8-15 of `two`; low nibble dim 2r,
// high nibble dim 2r + 1) as one biased bf16 pair (dims 2r, 2r + 1) each.
__device__ __forceinline__ void int4_dim_pairs(uint32_t two, uint32_t& a,
                                               uint32_t& b) {
  const uint32_t low = (two & 0x0F0Fu) ^ 0x43430808u;
  const uint32_t high = ((two >> 4) & 0x0F0Fu) ^ 0x43430808u;
  a = __byte_perm(low, high, 0x6420);
  b = __byte_perm(low, high, 0x7531);
}

// Nibble `shift` / 4 of four packed int4 bytes as two biased bf16 pairs:
// bytes (0, 2) and (1, 3).
__device__ __forceinline__ void int4_position_pairs(uint32_t four, int shift,
                                                    uint32_t& a,
                                                    uint32_t& b) {
  const uint32_t x = ((four >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u;
  a = __byte_perm(x, 0x43u, 0x4240);
  b = __byte_perm(x, 0x43u, 0x4341);
}

// 2^x (the logits are kept in log2 units in the tensor-core kernel).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// One stage of the ring: a 64-position tile of K, of V and, for quantized
// caches, of both scales, at the stored width.
template <int kKind>
struct TcTile {
  using CT = typename CacheOf<kKind>::T;
  static constexpr bool kQuant = kKind == kCacheInt8 || kKind == kCacheInt4;
  static constexpr int kElt = static_cast<int>(sizeof(CT));
  static constexpr int kRows = 64 / CacheOf<kKind>::kDimsPerRow;
  static constexpr int kPosPerChunk = 16 / kElt;
  static constexpr int kChunksPerRow = kTile / kPosPerChunk;  // 8 bf16, 4 int
  // bf16 rows are 128 bytes, their chunks swizzled; code rows padded to 80.
  static constexpr int kPitch = kKind == kCacheBF16 ? 128 : 80;
  static constexpr int kCacheBytes = kRows * kPitch;
  static constexpr int kScaleBytes = kQuant ? 2 * kTile * 4 : 0;
  static constexpr int kStageBytes = 2 * kCacheBytes + kScaleBytes;
  static constexpr int kStages = kKind == kCacheInt4 ? 3 : 2;
  // A thread copies chunk tid % kChunksPerRow of rows tid / kChunksPerRow
  // + i * kRowStep of each cache.
  static constexpr int kRowStep = kGroupedThreads / kChunksPerRow;
  static constexpr int kIters = kRows / kRowStep;

  // Byte offset of chunk `chunk` of stored row `row` in a cache tile.
  static __device__ __forceinline__ int chunk_at(int row, int chunk) {
    return kKind == kCacheBF16 ? row * kPitch + ((chunk ^ (row & 7)) << 4)
                               : row * kPitch + (chunk << 4);
  }
};

// 16 bytes from global to shared, of which `bytes` are wanted (the rest
// zero): asynchronously where the rows allow 16-byte loads, else byte by
// byte now.
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const uint8_t* src,
                                           const void* base, int bytes,
                                           int vec_ok) {
  bytes = min(max(bytes, 0), 16);
  if (vec_ok) {
    cp_async16(dst, bytes > 0 ? src : base, bytes);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = i < bytes ? src[i] : uint8_t(0);
  }
}

// What one thread copies of every tile of its (batch, K/V head): its
// chunks' sources at position 0, their place in a stage, and their first
// position in a tile.
template <int kKind>
struct TileCopy {
  using T = TcTile<kKind>;
  const uint8_t* k;
  const uint8_t* v;
  const uint8_t* scale;   // quantized caches, threads < 32: k, then v
  size_t row_step;        // bytes between its rows
  int at;                 // byte offset of its first chunk in a cache tile
  int pos;                // the chunk's first position in a tile
  int scale_pos;

  __device__ __forceinline__ TileCopy(const GroupedArgs& a, int bkv) {
    const int tid = threadIdx.x;
    const int chunk = tid % T::kChunksPerRow;
    const int row = tid / T::kChunksPerRow;
    pos = chunk * T::kPosPerChunk;
    const size_t first =
        (static_cast<size_t>(bkv) * T::kRows + row) * a.len + pos;
    k = static_cast<const uint8_t*>(a.cache_k) + first * T::kElt;
    v = static_cast<const uint8_t*>(a.cache_v) + first * T::kElt;
    row_step = static_cast<size_t>(T::kRowStep) * a.len * T::kElt;
    at = T::chunk_at(row, chunk);
    scale_pos = 4 * (tid % (kTile / 4));
    scale = nullptr;
    if constexpr (T::kQuant)
      scale = reinterpret_cast<const uint8_t*>(
          (tid < kTile / 4 ? a.k_scale : a.v_scale) +
          static_cast<size_t>(bkv) * a.len + scale_pos);
  }

  // The tile at positions p0 .. p0 + 63 into a stage; positions at or past
  // index (or len) as zeros.
  __device__ __forceinline__ void operator()(uint8_t* stage,
                                             const GroupedArgs& a, int p0,
                                             int index) const {
    const int bytes = (index - p0 - pos) * T::kElt;
    const size_t off = static_cast<size_t>(p0) * T::kElt;
#pragma unroll
    for (int i = 0; i < T::kIters; ++i) {
      const int to = at + i * T::kRowStep * T::kPitch;
      copy_chunk(stage + to, k + off + i * row_step, a.cache_k, bytes,
                 a.vec_ok);
      copy_chunk(stage + T::kCacheBytes + to, v + off + i * row_step,
                 a.cache_v, bytes, a.vec_ok);
    }
    if constexpr (T::kQuant) {
      if (threadIdx.x < 2 * kTile / 4)
        copy_chunk(stage + 2 * T::kCacheBytes + 16 * threadIdx.x,
                   scale + static_cast<size_t>(p0) * 4, a.k_scale,
                   (index - p0 - scale_pos) * 4, a.vec_ok);
    }
  }
};

// Positions of a warp's 16 (of each tile) behind the fragment rows g and
// g + 8: g and g + 8 for bf16 (ldmatrix's layout), 2g and 2g + 1 for codes,
// so that a thread's two positions are one 16-bit load in each K row and a
// V fragment's four positions (2t, 2t + 1, 2t + 8, 2t + 9 as depth) are
// 4t .. 4t + 3, one 32-bit load.
template <int kKind>
__device__ __forceinline__ int row_position(int g, int high) {
  return kKind == kCacheBF16 ? g + 8 * high : 2 * g + high;
}

// A fragment of the logits' product for warp w, k-step ks: positions
// row_position(g, 0 / 1) of the warp's 16 as rows, dims 16 ks + 2t, + 1
// (+ 8) as depth.
template <int kKind>
__device__ __forceinline__ void k_fragment(uint32_t (&r)[4],
                                           const uint8_t* kt, int w, int ks,
                                           int lane) {
  using T = TcTile<kKind>;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kKind == kCacheBF16) {
    // Matrix j of ldmatrix: dims + 8 (j >> 1), positions + 8 (j & 1).
    const int j = lane >> 3;
    const int d = 16 * ks + (lane & 7) + 8 * (j >> 1);
    ldmatrix_x4_trans(r, kt + T::chunk_at(d, 2 * w + (j & 1)));
  } else if constexpr (kKind == kCacheInt8) {
    // Rows d, d + 1 (and + 8, + 9) at positions 2g, 2g + 1.
    const uint8_t* p = kt + (16 * ks + 2 * t) * T::kPitch + 16 * w + 2 * g;
    auto pairs = [&](int drow, uint32_t& at_even, uint32_t& at_odd) {
      const uint32_t a = *reinterpret_cast<const uint16_t*>(
          p + drow * T::kPitch);
      const uint32_t b = *reinterpret_cast<const uint16_t*>(
          p + (drow + 1) * T::kPitch);
      int8x4_to_bf16<false>(__byte_perm(a, b, 0x5140), at_even, at_odd);
    };
    pairs(0, r[0], r[1]);
    pairs(8, r[2], r[3]);
  } else {   // int4: row 8 ks + t holds dims 16 ks + 2t (low), + 1 (high)
    const uint8_t* p = kt + (8 * ks + t) * T::kPitch + 16 * w + 2 * g;
    int4_dim_pairs(*reinterpret_cast<const uint16_t*>(p), r[0], r[1]);
    int4_dim_pairs(*reinterpret_cast<const uint16_t*>(p + 4 * T::kPitch),
                   r[2], r[3]);
  }
}

// A fragment of the V product for warp w: dims 16 mt + g (+ 8) as rows,
// the positions behind depth 2t, 2t + 1 (+ 8) as depth, from V's rows as
// stored.
template <int kKind>
__device__ __forceinline__ void v_fragment(uint32_t (&r)[4],
                                           const uint8_t* vt, int w, int mt,
                                           int lane) {
  using T = TcTile<kKind>;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kKind == kCacheBF16) {
    // Matrix j of ldmatrix: dims + 8 (j & 1), positions + 8 (j >> 1).
    const int j = lane >> 3;
    const int d = 16 * mt + (lane & 7) + 8 * (j & 1);
    ldmatrix_x4(r, vt + T::chunk_at(d, 2 * w + (j >> 1)));
  } else if constexpr (kKind == kCacheInt8) {
    // Positions 4t .. 4t + 3: depth 2t, 2t + 1 are 4t, 4t + 2; + 8 the odd.
    const uint8_t* p = vt + (16 * mt + g) * T::kPitch + 16 * w + 4 * t;
    int8x4_to_bf16<true>(*reinterpret_cast<const uint32_t*>(p), r[0], r[2]);
    int8x4_to_bf16<true>(
        *reinterpret_cast<const uint32_t*>(p + 8 * T::kPitch), r[1], r[3]);
  } else {   // int4: dim d is nibble d % 2 of row d / 2
    const uint8_t* p = vt + (8 * mt + (g >> 1)) * T::kPitch + 16 * w + 4 * t;
    const int shift = 4 * (g & 1);
    int4_position_pairs(*reinterpret_cast<const uint32_t*>(p), shift, r[0],
                        r[2]);
    int4_position_pairs(
        *reinterpret_cast<const uint32_t*>(p + 4 * T::kPitch), shift, r[1],
        r[3]);
  }
}

template <int kKind>
__global__ void __launch_bounds__(kGroupedThreads)
decode_attention_grouped_tc_kernel(GroupedArgs a) {
  using T = TcTile<kKind>;
  constexpr int kD = 64;
  constexpr int kStages = T::kStages;
  __shared__ __align__(128) uint8_t ring[kStages * T::kStageBytes];
  __shared__ float state[kMaxGroup][kD + 2];
  __shared__ float warp_ml[kGroupedWarps][kMaxGroup][2];
  __shared__ float col_s[2][kD];             // the new column (grouped_column)
  __shared__ float col_scale_s[2];
  static_assert(kGroupedWarps * kMaxGroup * kD * 4 <= kStages * T::kStageBytes,
                "the warps' acc are exchanged through the ring");

  const int bkv = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int group = a.group;
  const int index = min(max(*a.index, 0), a.len - 1);
  const int p_begin = blockIdx.x * a.span;
  const int p_end = min(p_begin + a.span, index);
  const int tiles = p_end > p_begin ? (p_end - p_begin + kTile - 1) / kTile : 0;
  const size_t head0 = static_cast<size_t>(bkv) * group;

  if (tiles > 0) {
    // q^T as B fragments: dims 16 ks + 2t, + 1 (+ 8) of query head g.
    uint32_t qf[4][2];
    const bf16* query = static_cast<const bf16*>(a.query);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(
          query + (head0 + min(g, group - 1)) * kD + 16 * ks + 2 * t);
      qf[ks][0] = g < group ? q[0] : 0u;
      qf[ks][1] = g < group ? q[4] : 0u;
    }
    // This warp's state, in log2 units: heads 2t and 2t + 1; acc[mt] holds
    // dims 16 mt + g (c0, c1) and + 8 (c2, c3); for int4, w_sum[0], [1]
    // the weights' sums of the two heads (rescaled as acc).
    float acc[4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
    float w_sum[4] = {0.f, 0.f, 0.f, 0.f};
    const uint32_t ones[4] = {0x3F803F80u, 0x3F803F80u, 0x3F803F80u,
                              0x3F803F80u};   // bf16 1.0
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};

    const TileCopy<kKind> copy(a, bkv);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < tiles)
        copy(ring + s * T::kStageBytes, a, p_begin + s * kTile, index);
      cp_async_commit();
    }
    grouped_column<bf16, kKind, kD>(a, col_s, col_scale_s);
    // The logits' accumulator starts at 0, or for int4 at -136 sum_d q_d
    // of heads 2t and 2t + 1 (the bias of the codes).  After the first
    // tiles' loads are issued, as it waits for q.
    float s_init[2] = {0.f, 0.f};
    if constexpr (kKind == kCacheInt4) {
      float q_sum = 0.f;   // of head g, over this lane's 16 dims
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 pair = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&qf[ks][i]));
          q_sum += pair.x + pair.y;
        }
      q_sum += __shfl_xor_sync(kFull, q_sum, 1);
      q_sum += __shfl_xor_sync(kFull, q_sum, 2);
      s_init[0] = -kInt4Bias * __shfl_sync(kFull, q_sum, 8 * t);
      s_init[1] = -kInt4Bias * __shfl_sync(kFull, q_sum, 8 * t + 4);
    }
    for (int it = 0; it < tiles; ++it) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // tile it has landed; tile it - 1 is consumed
      const int next = it + kStages - 1;
      if (next < tiles)
        copy(ring + (next % kStages) * T::kStageBytes, a,
             p_begin + next * kTile, index);
      cp_async_commit();
      const uint8_t* stage = ring + (it % kStages) * T::kStageBytes;
      const int p0 = p_begin + it * kTile;

      // S^T = K q^T: s[0], s[1] at the thread's first row, s[2], s[3] at
      // its second (row_position).
      // Two accumulators, even and odd k-steps, halve the chain of
      // dependent products.
      float s[4] = {s_init[0], s_init[1], s_init[0], s_init[1]};
      float s_odd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t kf[4];
        k_fragment<kKind>(kf, stage, warp, ks, lane);
        if (ks & 1)
          mma(s_odd, kf, qf[ks][0], qf[ks][1]);
        else
          mma(s, kf, qf[ks][0], qf[ks][1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] += s_odd[e];
      // This thread's rows are positions j0 and j1 of the tile.
      const int j0 = 16 * warp + row_position<kKind>(g, 0);
      const int j1 = 16 * warp + row_position<kKind>(g, 1);
      float k0 = kLog2e, k1 = kLog2e, v0 = 1.f, v1 = 1.f;
      if constexpr (T::kQuant) {   // j1 = j0 + 1: one 8-byte load each
        const float* scale =
            reinterpret_cast<const float*>(stage + 2 * T::kCacheBytes);
        const float2 ks = *reinterpret_cast<const float2*>(scale + j0);
        const float2 vs = *reinterpret_cast<const float2*>(scale + kTile + j0);
        k0 = ks.x * kLog2e;
        k1 = ks.y * kLog2e;
        v0 = vs.x;
        v1 = vs.y;
      }
      const bool live0 = p0 + j0 < index;
      const bool live1 = p0 + j1 < index;
      s[0] = live0 ? s[0] * k0 : kNegInf;
      s[1] = live0 ? s[1] * k0 : kNegInf;
      s[2] = live1 ? s[2] * k1 : kNegInf;
      s[3] = live1 ? s[3] * k1 : kNegInf;
      float mx0 = fmaxf(s[0], s[2]);
      float mx1 = fmaxf(s[1], s[3]);
#pragma unroll
      for (int offset = 4; offset < 32; offset <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, offset));
        mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, offset));
      }
      const float mn0 = fmaxf(m[0], mx0);
      const float mn1 = fmaxf(m[1], mx1);
      const float r0 = exp2_approx(m[0] - mn0);
      const float r1 = exp2_approx(m[1] - mn1);
      // acc is rescaled only when a max of the warp moved.
      if (__any_sync(kFull, mn0 != m[0] || mn1 != m[1])) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          acc[mt][0] *= r0;
          acc[mt][1] *= r1;
          acc[mt][2] *= r0;
          acc[mt][3] *= r1;
        }
        w_sum[0] *= r0;
        w_sum[1] *= r1;
      }
      m[0] = mn0;
      m[1] = mn1;
      const float e0 = live0 ? exp2_approx(s[0] - mn0) : 0.f;
      const float e1 = live0 ? exp2_approx(s[1] - mn1) : 0.f;
      const float e2 = live1 ? exp2_approx(s[2] - mn0) : 0.f;
      const float e3 = live1 ? exp2_approx(s[3] - mn1) : 0.f;
      l[0] = l[0] * r0 + e0 + e2;
      l[1] = l[1] * r1 + e1 + e3;
      // The weights times v_scale in bf16, transposed into the B fragment
      // of O^T = V w^T (positions 2t, 2t + 1 (+ 8) of query head g).
      const uint32_t b0 = movmatrix_trans(pack_bf16(e0 * v0, e1 * v0));
      const uint32_t b1 = movmatrix_trans(pack_bf16(e2 * v1, e3 * v1));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t vf[4];
        v_fragment<kKind>(vf, stage + T::kCacheBytes, warp, mt, lane);
        mma(acc[mt], vf, b0, b1);
      }
      if constexpr (kKind == kCacheInt4) mma(w_sum, ones, b0, b1);
    }
    if constexpr (kKind == kCacheInt4) {   // the codes' bias off acc
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        acc[mt][0] = fmaf(-kInt4Bias, w_sum[0], acc[mt][0]);
        acc[mt][1] = fmaf(-kInt4Bias, w_sum[1], acc[mt][1]);
        acc[mt][2] = fmaf(-kInt4Bias, w_sum[0], acc[mt][2]);
        acc[mt][3] = fmaf(-kInt4Bias, w_sum[1], acc[mt][3]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // every warp is done with the ring

    // The four warps' states into the block's: (m, l) per head, then acc
    // through the ring.
#pragma unroll
    for (int offset = 4; offset < 32; offset <<= 1) {
      l[0] += __shfl_xor_sync(kFull, l[0], offset);
      l[1] += __shfl_xor_sync(kFull, l[1], offset);
    }
    if (g == 0) {
      warp_ml[warp][2 * t][0] = m[0];
      warp_ml[warp][2 * t][1] = l[0];
      warp_ml[warp][2 * t + 1][0] = m[1];
      warp_ml[warp][2 * t + 1][1] = l[1];
    }
    float (*xacc)[kMaxGroup][kD] = reinterpret_cast<float (*)[kMaxGroup][kD]>(ring);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int d = 16 * mt + g;
      xacc[warp][2 * t][d] = acc[mt][0];
      xacc[warp][2 * t + 1][d] = acc[mt][1];
      xacc[warp][2 * t][d + 8] = acc[mt][2];
      xacc[warp][2 * t + 1][d + 8] = acc[mt][3];
    }
    __syncthreads();
    for (int pair = tid; pair < group * kD; pair += kGroupedThreads) {
      const int hq = pair / kD;
      const int d = pair % kD;
      float mb = warp_ml[0][hq][0];
#pragma unroll
      for (int w = 1; w < kGroupedWarps; ++w) mb = fmaxf(mb, warp_ml[w][hq][0]);
      float sum = 0.f, lb = 0.f;
#pragma unroll
      for (int w = 0; w < kGroupedWarps; ++w) {
        const float f = exp2_approx(warp_ml[w][hq][0] - mb);
        sum = fmaf(f, xacc[w][hq][d], sum);
        lb = fmaf(f, warp_ml[w][hq][1], lb);
      }
      state[hq][d] = sum;
      if (d == 0) {   // the max back in natural units for the merge
        state[hq][kD] = mb * kLn2;
        state[hq][kD + 1] = lb;
      }
    }
  } else {
    grouped_column<bf16, kKind, kD>(a, col_s, col_scale_s);
  }
  __syncthreads();
  grouped_finish<bf16, kKind, kD>(a, state, tiles > 0, index, col_s,
                                  col_scale_s);
}

template <int kKind>
bool rows_aligned(const GroupedArgs& a) {
  constexpr int kPos = TcTile<kKind>::kPosPerChunk;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return a.len % kPos == 0 && a.len % 4 == 0 && aligned(a.cache_k) &&
         aligned(a.cache_v) &&
         (a.k_scale == nullptr || (aligned(a.k_scale) && aligned(a.v_scale)));
}

// bfloat16 queries, head dim 64 and a bf16, int8 or int4 cache: the
// tensor-core kernel; every other combination: the FMA kernel.
template <typename Q, int kKind, int kD>
cudaError_t launch_grouped(GroupedArgs a, int batch_kv, int splits,
                           cudaStream_t stream) {
  const dim3 grid(splits, batch_kv);
  constexpr bool kTensorCores = std::is_same<Q, __nv_bfloat16>::value &&
                                kD == 64 && kKind != kCacheF32;
  if constexpr (kTensorCores) {
    a.vec_ok = rows_aligned<kKind>(a);
    decode_attention_grouped_tc_kernel<kKind>
        <<<grid, kGroupedThreads, 0, stream>>>(a);
  } else {
    constexpr int kVec = Tile<typename CacheOf<kKind>::T>::kVec;
    a.vec_ok = a.len % kVec == 0 &&
               reinterpret_cast<uintptr_t>(a.cache_k) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(a.cache_v) % 16 == 0;
    decode_attention_grouped_fma_kernel<Q, kKind, kD>
        <<<grid, kGroupedThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename Q, int kKind>
cudaError_t launch_grouped_dim(const GroupedArgs& a, int batch_kv,
                               int head_dim, int splits,
                               cudaStream_t stream) {
  switch (head_dim) {
    case 8:
      return launch_grouped<Q, kKind, 8>(a, batch_kv, splits, stream);
    case 64:
      return launch_grouped<Q, kKind, 64>(a, batch_kv, splits, stream);
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

// The grouped kernels.  query [batch_kv * group, head_dim] and out alike;
// new_k/new_v [batch_kv, head_dim] in the query's dtype (0 = float32, 1 =
// bfloat16); caches [batch_kv, rows, len] of cache_kind 0 (float32, the
// query's dtype), 1 (bfloat16, likewise), 2 (int8, rows = head_dim) or 3
// (int4 packed two per uint8, rows = head_dim / 2); k_scale/v_scale float32
// [batch_kv, len] for kinds 2 and 3, else null; group 1 to 8 query heads
// per K/V head.  Each block takes `span` positions (a positive multiple of
// 64) of one (batch, K/V head), so splits = ceil(len / span); the wrapper
// picks span from batch_kv and len (ops/decode_attention.grouped_split).
// With splits > 1, partials float32 [batch_kv * group, splits, head_dim +
// 2] and counters int32 [>= batch_kv], all zero between calls; with one
// split neither is touched (either may be null).  Returns the cudaError_t
// of the launch.
int mt3_decode_attention_grouped(
    const void* query, const void* new_k, const void* new_v, void* cache_k,
    void* cache_v, void* k_scale, void* v_scale, const void* index,
    void* out, void* partials, void* counters, int batch_kv, int group,
    int head_dim, int len, int span, int splits, int dtype, int cache_kind,
    void* stream) {
  const bool quantized = cache_kind == kCacheInt8 || cache_kind == kCacheInt4;
  if (batch_kv <= 0 || batch_kv > 65535 || group < 1 || group > kMaxGroup ||
      len <= 0 || span <= 0 || span % kTile != 0 ||
      splits != (len + span - 1) / span ||
      (splits > 1 && (partials == nullptr || counters == nullptr)) ||
      quantized != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const GroupedArgs a{query, new_k, new_v, cache_k, cache_v,
                      static_cast<float*>(k_scale),
                      static_cast<float*>(v_scale),
                      static_cast<const int32_t*>(index), out,
                      static_cast<float*>(partials),
                      static_cast<int*>(counters), len, group, span, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MT3_GROUPED(Q, KIND) \
  launch_grouped_dim<Q, KIND>(a, batch_kv, head_dim, splits, s)
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
