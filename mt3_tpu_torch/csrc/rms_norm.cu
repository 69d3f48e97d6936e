// Kernel D: T5's RMS norm (models/layers.rms_norm), forward and backward.
//
// It replaces no Pallas kernel: the JAX package leaves the norm to XLA,
// which fuses its elementwise ops into one pass over the activations.
// PyTorch runs the norm's plain version (ops/rms_norm.py:rms_norm_plain)
// as nine kernels over [tokens, width] (cast, square, mean, +eps, rsqrt,
// multiply, cast, the scale's cast, multiply), each writing a float32
// intermediate, and autograd's backward about as many again: about 38
// bytes an element forward where the function needs 4.  Counted by issuing
// function, those kernels moved most of the bf16 train step's elementwise
// bytes, which is why this kernel was added.
//
// What bounds it on the H100: bytes.  A few flops an element against 4
// bytes forward in bf16 (x read, y written) and 6 backward (x and dy
// read, dx written) at 3.35 TB/s.  Its design reads and writes each of
// them once and keeps every intermediate in registers.
//
//   rstd = rsqrt(sum(x^2) / d + eps)                      float32, per row
//   y    = to_t(to_t(x * rstd) * to_t(scale))              the plain rounding
//   g    = dy * to_t(scale)
//   dx   = to_t(rstd * g - x * rstd^3 * sum(g * x) / d)
//   dscale = sum over rows of dy * x * rstd                float32
//
// x, y, dy and dx share one type t, float32 or bf16 (the port norms the
// residual stream in its activation dtype); scale and dscale are float32.
//
// Design:
//   * One warp reduces one row of at most 1024 elements (at width 512,
//     1 KB of bf16: two 16-byte loads a lane), eight rows a block.  The
//     number of 256-element pieces a lane walks comes from the row width
//     the wrapper observes; each lane holds its 8-element pieces of the row
//     in registers (one 16-byte load of bf16, two of float32), so x is read
//     once.  No configuration norms a wider row; the wrapper refuses one.
//   * The forward writes rstd (float32, one a row) only when the caller
//     needs a gradient.  The scale is read as the float32 parameter and
//     rounded to t in registers.
//   * The backward reduces dscale without atomics, in a fixed order: a grid
//     of as many blocks as fit on the card at once walks the rows, each
//     block sums its rows' terms in registers and writes one row of a
//     float32 partial [blocks, d], and rms_norm_dscale_kernel sums the
//     partials over blocks.  mt3_rms_norm_bwd_blocks gives the grid, so
//     that the wrapper allocates the partial.
//   * Launches go on the caller's stream; nothing synchronises or
//     allocates, so the forward runs inside a CUDA-graph capture.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                 // elements a lane loads at once
constexpr int kChunk = 32 * kVec;       // a warp's elements in one piece
constexpr int kMaxRow = 4 * kChunk;     // 1024: the widest row a warp takes
static_assert(kChunk == kThreads, "a block sums one piece of the partial");

// dtype codes, as ops/rms_norm.py's DTYPES.
constexpr int kFloat32 = 0;
constexpr int kBfloat16 = 1;

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Stores values that are already rounded to the element type.
__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  }
  *reinterpret_cast<uint4*>(p) = u;
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

// Every lane gets the same sum: a butterfly adds the same pairs on both
// sides.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  }
  return v;
}

// A warp holds a row in kChunks pieces of kChunk elements, kVec a lane.
template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const T* __restrict__ x,
                    const float* __restrict__ scale, T* __restrict__ y,
                    float* __restrict__ rstd_out, int rows, int d,
                    float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = int64_t(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  float v[kChunks][kVec];
  float squares = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = c * kChunk + lane * kVec;
    if (col < d) {
      load8(xr + col, v[c]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[c][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) squares += v[c][e] * v[c][e];
  }
  squares = warp_sum(squares);
  const float r = rsqrtf(squares / static_cast<float>(d) + eps);
  if (rstd_out != nullptr && lane == 0) rstd_out[row] = r;
  T* yr = y + row * d;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = c * kChunk + lane * kVec;
    if (col < d) {
      float s[kVec];
      load8(scale + col, s);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        v[c][e] = round_to<T>(round_to<T>(v[c][e] * r) * round_to<T>(s[e]));
      }
      store8(yr + col, v[c]);
    }
  }
}

template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ rstd,
                    const float* __restrict__ scale, T* __restrict__ dx,
                    float* __restrict__ partial, int rows, int d) {
  // Eight warps' pieces of the partial, added in warp order.
  __shared__ float stage[kWarps][kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float s[kChunks][kVec];
  float acc[kChunks][kVec];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = c * kChunk + lane * kVec;
    if (col < d) {
      load8(scale + col, s[c]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) s[c][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      s[c][e] = round_to<T>(s[c][e]);
      acc[c][e] = 0.f;
    }
  }
  const int64_t stride = int64_t(gridDim.x) * kWarps;
  for (int64_t row = int64_t(blockIdx.x) * kWarps + warp; row < rows;
       row += stride) {
    float xv[kChunks][kVec];
    float g[kChunks][kVec];
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = c * kChunk + lane * kVec;
      if (col < d) {
        load8(x + row * d + col, xv[c]);
        load8(dy + row * d + col, g[c]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) xv[c][e] = g[c][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) dot += g[c][e] * s[c][e] * xv[c][e];
    }
    dot = warp_sum(dot);
    const float r = rstd[row];
    const float k = dot * r * r * r / static_cast<float>(d);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = c * kChunk + lane * kVec;
      if (col < d) {
        float out[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          acc[c][e] += g[c][e] * (xv[c][e] * r);
          out[e] = round_to<T>(r * (g[c][e] * s[c][e]) - xv[c][e] * k);
        }
        store8(dx + row * d + col, out);
      }
    }
  }
  if (partial == nullptr) return;
  float* part = partial + int64_t(blockIdx.x) * d;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) stage[warp][lane * kVec + e] = acc[c][e];
    __syncthreads();
    const int col = c * kChunk + threadIdx.x;   // kChunk == kThreads
    if (col < d) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += stage[w][threadIdx.x];
      part[col] = total;
    }
    __syncthreads();
  }
}

// dscale[col] = the sum of partial[:, col] over blocks, in a fixed order:
// eight slices of the blocks, then the slices in order.
__global__ void __launch_bounds__(kThreads)
rms_norm_dscale_kernel(const float* __restrict__ partial,
                       float* __restrict__ dscale, int blocks, int d) {
  __shared__ float sums[kWarps][33];
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float total = 0.f;
  if (col < d) {
    for (int b = slice; b < blocks; b += kWarps) {
      total += partial[int64_t(b) * d + col];
    }
  }
  sums[slice][lane] = total;
  __syncthreads();
  if (slice == 0 && col < d) {
    total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += sums[w][lane];
    dscale[col] = total;
  }
}

int row_blocks(int rows) { return (rows + kWarps - 1) / kWarps; }

template <typename T>
struct Forward {
  const void* x;
  const float* scale;
  void* y;
  float* rstd;
  int rows, d;
  float eps;
  cudaStream_t stream;

  template <int kChunks>
  cudaError_t run() const {
    rms_norm_fwd_kernel<T, kChunks><<<row_blocks(rows), kThreads, 0, stream>>>(
            static_cast<const T*>(x), scale, static_cast<T*>(y), rstd, rows,
            d, eps);
    return cudaGetLastError();
  }
};

// The backward's grid: the row blocks, at most as many as fit on the card
// at once.
template <typename T>
struct BackwardGrid {
  int rows, d;
  int* blocks;

  template <int kChunks>
  cudaError_t run() const {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t status = cudaGetDevice(&device);
    if (status == cudaSuccess) {
      status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device);
    }
    if (status == cudaSuccess) {
      status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rms_norm_bwd_kernel<T, kChunks>,
          kThreads, 0);
    }
    if (status != cudaSuccess) return status;
    *blocks = std::min(row_blocks(rows),
                       std::max(1, per_sm) * sms);
    return cudaSuccess;
  }
};

template <typename T>
struct Backward {
  const void* x;
  const void* dy;
  const float* rstd;
  const float* scale;
  void* dx;
  float* partial;
  float* dscale;
  int rows, d, blocks;
  cudaStream_t stream;

  template <int kChunks>
  cudaError_t run() const {
    rms_norm_bwd_kernel<T, kChunks><<<blocks, kThreads, 0, stream>>>(
            static_cast<const T*>(x), static_cast<const T*>(dy), rstd, scale,
            static_cast<T*>(dx), partial, rows, d);
    cudaError_t status = cudaGetLastError();
    if (status != cudaSuccess || partial == nullptr) return status;
    rms_norm_dscale_kernel<<<(d + 31) / 32, kThreads, 0, stream>>>(
        partial, dscale, blocks, d);
    return cudaGetLastError();
  }
};

// Runs op with the fewest pieces that hold a row of d elements.
template <typename Op>
cudaError_t by_width(const Op& op, int d) {
  if (d <= kChunk) return op.template run<1>();
  if (d <= 2 * kChunk) return op.template run<2>();
  return op.template run<4>();
}

// Runs Op<T>{args...} for the dtype code.
template <template <typename> class Op, typename... Args>
cudaError_t by_dtype(int dtype, int d, Args... args) {
  if (d <= 0 || d % kVec != 0 || d > kMaxRow) return cudaErrorInvalidValue;
  if (dtype == kBfloat16) return by_width(Op<__nv_bfloat16>{args...}, d);
  if (dtype == kFloat32) return by_width(Op<float>{args...}, d);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x and y [rows, d] in dtype, scale [d] float32, rstd [rows] float32 or
// null; all contiguous and 16-byte aligned, d a multiple of 8 and at most
// 1024.  Returns the cudaError_t of the launch.
int mt3_rms_norm_fwd(const void* x, const float* scale, void* y, float* rstd,
                     int rows, int d, float eps, int dtype,
                     cudaStream_t stream) {
  return static_cast<int>(
      by_dtype<Forward>(dtype, d, x, scale, y, rstd, rows, d, eps, stream));
}

// *blocks = the backward's grid for rows x d: the rows of the partial that
// mt3_rms_norm_bwd writes.
int mt3_rms_norm_bwd_blocks(int rows, int d, int dtype, int* blocks) {
  return static_cast<int>(by_dtype<BackwardGrid>(dtype, d, rows, d, blocks));
}

// x, dy and dx [rows, d] in dtype, rstd [rows] and scale [d] float32 ->
// dx and, when partial ([blocks, d] float32 scratch) is not null, dscale
// [d] float32.  blocks from mt3_rms_norm_bwd_blocks.  Returns the
// cudaError_t of the launches.
int mt3_rms_norm_bwd(const void* x, const void* dy, const float* rstd,
                     const float* scale, void* dx, float* partial,
                     float* dscale, int rows, int d, int blocks, int dtype,
                     cudaStream_t stream) {
  return static_cast<int>(by_dtype<Backward>(dtype, d, x, dy, rstd, scale, dx,
                                             partial, dscale, rows, d, blocks,
                                             stream));
}

const char* mt3_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
