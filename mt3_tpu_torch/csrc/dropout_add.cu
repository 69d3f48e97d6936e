// Kernel E: dropout and its residual add (models/t5._dropout), forward and
// backward.
//
// It replaces no Pallas kernel: the JAX package leaves dropout to XLA, which
// fuses the mask, the scale and the residual add into one pass.  PyTorch ran
// the plain version (ops/dropout.py:dropout_add_plain) as three kernels over
// the activations (the product with 1 / (1 - rate), a `where` over a mask
// broadcast along the length, the residual add), each reading and writing
// the whole tensor, and autograd's backward as two more.  Counted by issuing
// function, dropout was the largest elementwise cost of the bf16 train step
// once kernel D had taken the norm's, which is why this kernel was added.
//
// What bounds it on the H100: bytes.  Two flops an element against, in
// bf16, 6 bytes forward with a residual (x and h read, y written), 4
// without, and 4 backward (dy read, dh written) at 3.35 TB/s; the mask,
// [b, 1, d] at every site but the encoder's output, is read from L1/L2.
//
//   inv = 1 / to_t(1 - rate)                        float32, from the host
//   d   = keep ? to_t(h * inv) : +0
//   y   = to_t(x + d)  with a residual x, else d
//   dh  = keep ? to_t(dy * inv) : +0               the backward: the same
//                                                  kernel without x
//
// These are the roundings of the plain version's kernels, so the two agree
// to the bit: PyTorch divides by a CPU scalar as a product with its float32
// reciprocal and rounds to t, `where` writes +0 where the mask drops, and
// the add sums in float32 and rounds again.  The product and the sum are
// __fmul_rn and __fadd_rn, so that nvcc does not contract them into one
// FMA in float32.  x, h, y share one type t, float32 or bf16.
//
// Design:
//   * One lane takes 8 elements at a time (a 16-byte load of bf16, two of
//     float32) and four such pieces, their loads issued before any
//     arithmetic, so that enough bytes are in flight to fill HBM.  A
//     launch covers the tensor once: no grid-stride loop, no reduction.
//   * The mask is bool [batch, length or 1, d].  A piece of 8 elements lies
//     in one row (d a multiple of 8), so its 8 mask bytes are one 8-byte
//     load at (b, column); the broadcast mask is never expanded.  A full
//     mask is the same with a length of 1.
//   * Widths that are not a multiple of 8, or tensors that are not 16-byte
//     aligned (mask: 8), take the same kernel one element a lane.
//   * Launches go on the caller's stream; nothing synchronises or
//     allocates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // pieces a lane loads before it computes

// dtype codes, as ops/dropout.py's DTYPES.
constexpr int kFloat32 = 0;
constexpr int kBfloat16 = 1;

template <int kVec>
__device__ __forceinline__ void load(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 8) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = p[e];
  }
}

template <int kVec>
__device__ __forceinline__ void load(const __nv_bfloat16* p,
                                     float (&v)[kVec]) {
  if constexpr (kVec == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = __bfloat162float(p[e]);
  }
}

// The mask's kVec bytes (torch.bool: 0 or 1), byte e at bits 8e.
template <int kVec>
__device__ __forceinline__ uint64_t load_mask(const uint8_t* p) {
  static_assert(kVec <= 8, "one byte of the word an element");
  if constexpr (kVec == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    return uint64_t(u.y) << 32 | u.x;
  } else {
    uint64_t m = 0;
#pragma unroll
    for (int e = 0; e < kVec; ++e) m |= uint64_t(p[e]) << (8 * e);
    return m;
  }
}

// Stores values that are already rounded to the element type.
template <int kVec>
__device__ __forceinline__ void store(float* p, const float (&v)[kVec]) {
  if constexpr (kVec == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) p[e] = v[e];
  }
}

template <int kVec>
__device__ __forceinline__ void store(__nv_bfloat16* p,
                                      const float (&v)[kVec]) {
  if constexpr (kVec == 8) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) p[e] = __float2bfloat16_rn(v[e]);
  }
}

// v rounded to T (round to nearest even, as torch's casts), as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v);

template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// y = [x +] keep ? h * inv : +0 over `pieces` pieces of kVec elements.  A
// piece's mask lies at (piece / slice) * row + piece % row, in pieces: row
// is d / kVec, slice length * d / kVec (row itself for a full mask).
template <typename T, int kVec, bool kResidual>
__global__ void __launch_bounds__(kThreads)
dropout_add_kernel(const T* __restrict__ x, const T* __restrict__ h,
                   const uint8_t* __restrict__ keep, T* __restrict__ y,
                   uint32_t pieces, uint32_t row, uint32_t slice, float inv) {
  float hv[kUnroll][kVec];
  float xv[kUnroll][kResidual ? kVec : 1];
  uint64_t mv[kUnroll];
  const uint32_t first = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const uint32_t piece = first + u * kThreads;
    if (piece < pieces) {
      const uint32_t m =
          slice == row ? piece : piece / slice * row + piece % row;
      load<kVec>(h + size_t(piece) * kVec, hv[u]);
      if constexpr (kResidual) load<kVec>(x + size_t(piece) * kVec, xv[u]);
      mv[u] = load_mask<kVec>(keep + size_t(m) * kVec);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const uint32_t piece = first + u * kThreads;
    if (piece < pieces) {
      float out[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const bool kept = (mv[u] >> (8 * e)) & 0xffu;
        const float d = kept ? round_to<T>(__fmul_rn(hv[u][e], inv)) : 0.f;
        if constexpr (kResidual) {
          out[e] = round_to<T>(__fadd_rn(xv[u][e], d));
        } else {
          out[e] = d;
        }
      }
      store<kVec>(y + size_t(piece) * kVec, out);
    }
  }
}

template <typename T, int kVec, bool kResidual>
cudaError_t launch(const void* x, const void* h, const void* keep, void* y,
                   int64_t n, int d, int length, float inv,
                   cudaStream_t stream) {
  const uint32_t pieces = static_cast<uint32_t>(n / kVec);
  const uint32_t row = static_cast<uint32_t>(d / kVec);
  const uint32_t slice = static_cast<uint32_t>(int64_t(length) * d / kVec);
  const uint32_t per_block = kThreads * kUnroll;
  const uint32_t blocks = (pieces + per_block - 1) / per_block;
  dropout_add_kernel<T, kVec, kResidual><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const uint8_t*>(keep), static_cast<T*>(y), pieces, row,
      slice, inv);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
cudaError_t by_width(const void* x, const void* h, const void* keep, void* y,
                     int64_t n, int d, int length, float inv,
                     cudaStream_t stream) {
  const bool pieces = d % 8 == 0 && aligned(h, 16) && aligned(y, 16) &&
                      (x == nullptr || aligned(x, 16)) && aligned(keep, 8);
  if (pieces) {
    return x != nullptr
        ? launch<T, 8, true>(x, h, keep, y, n, d, length, inv, stream)
        : launch<T, 8, false>(x, h, keep, y, n, d, length, inv, stream);
  }
  return x != nullptr
      ? launch<T, 1, true>(x, h, keep, y, n, d, length, inv, stream)
      : launch<T, 1, false>(x, h, keep, y, n, d, length, inv, stream);
}

}  // namespace

extern "C" {

// h, y and x (the residual, or null) [n / (length * d), length, d] in dtype,
// keep bool [n / (length * d), 1, d] (or [n / d, 1, d] with length 1, for a
// full mask); all contiguous, n below 2**31.  y = [x +] (keep ? h * inv :
// 0), rounded as the plain version rounds.  Returns the cudaError_t of the
// launch.
int mt3_dropout_add(const void* x, const void* h, const void* keep, void* y,
                    int64_t n, int d, int length, float inv, int dtype,
                    cudaStream_t stream) {
  if (n <= 0 || n >= (int64_t(1) << 31) || d <= 0 || length <= 0 ||
      n % (int64_t(length) * d) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == kBfloat16) {
    return static_cast<int>(
        by_width<__nv_bfloat16>(x, h, keep, y, n, d, length, inv, stream));
  }
  if (dtype == kFloat32) {
    return static_cast<int>(
        by_width<float>(x, h, keep, y, n, d, length, inv, stream));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mt3_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
