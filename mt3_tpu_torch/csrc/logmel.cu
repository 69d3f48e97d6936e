// Kernel A: fused log-mel spectrogram of 16 kHz audio.
//
// Replaces the Pallas TPU kernel mt3_tpu/ops/pallas/logmel.py:logmel_fused
// (wrapper :81, body _logmel_kernel :52, pallas_call :99).
//
//   frame i of a segment = samples [hop*i, hop*i + 2048), zero past the end
//   X     = rfft_2048(periodic Hann window * frame)           [1025]
//   out   = log(max-clamp(|X| @ mel))                          [num_mel]
//
// What bounds it on the H100.  The function needs little: a real FFT of
// 2048 points is about 2.5*N*log2(N) = 56k flops a frame, and each HTK mel
// filter is one contiguous band of at most 10 DFT bins (about 1934
// nonzeros in all for 512 filters), so a frame needs under 70k flops
// against 0.5 KB of new audio read and 2 KB written: bound about evenly by
// the float32 rate and the memory rate (2 us for 8 x 32768 samples).  The
// TPU kernel's dense windowed DFT as a matmul needs 140x those flops.
// Float32 throughout, no TF32 and no tensor cores: the 5e-3 log-domain
// tolerance that the JAX tests hold the TPU kernel to rules out TF32.
//
// Design: an FFT log-mel, one warp per frame, no intermediate in device
// memory.
//   * Framing.  A block owns 8 consecutive frames of one segment and stages
//     the samples they span once in shared memory, hop*7 + 2048 floats with
//     16-byte loads (zero past the segment's end).
//   * Packed real FFT.  A frame's 2048-point real FFT is the 1024-point
//     complex FFT of z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1], done as
//     32 x 32 (four-step): lane b takes z[32a + b] for a < 32 and runs a
//     32-point radix-2 FFT over a in registers; the results are multiplied
//     by W_1024^(b c), transposed through shared memory (pitch 33), and
//     lane c runs the second 32-point FFT over b, which gives
//     Z[c + 32 d].  Then the split step
//       X[k] = (Z[k] + Z*[1024-k])/2 - i e^(-2 pi i k / 2048) (Z[k] - Z*[1024-k])/2
//     gives bins k and 1024 - k from one pair of Z values.  Twiddles come
//     from a float32 table that ops/logmel.py builds in float64.
//   * Magnitude and mel.  Magnitudes go to shared memory, never to device
//     memory.  Lane m sums filter m over its band only, in ascending bin
//     order, with the float32 weights of spectrogram._mel_matrix; an empty
//     filter sums to 0 and gives log(eps) exactly (passed in from the host,
//     rounded once).  Stores are coalesced rows of the [frames, num_mel]
//     output.

#include <cuda_runtime.h>

namespace {

constexpr int kFft = 2048;
constexpr int kWarps = 8;                 // frames per block, one per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kPitch = 33;                // float2 pitch of the transpose
constexpr int kWarpBuffer = 32 * kPitch;  // float2 per warp
// The twiddle table (float2): W_32^k for k < 16; W_1024^(b c) at c*32 + b;
// e^(-2 pi i k / 2048) for k <= 1024.  ops/logmel.py builds the same.
constexpr int kTw32 = 0;
constexpr int kTwStep = 16;
constexpr int kTwSplit = kTwStep + 1024;

__host__ __device__ constexpr int bitrev5(int k) {
  return ((k & 1) << 4) | ((k & 2) << 2) | (k & 4) | ((k & 8) >> 2) |
         ((k & 16) >> 4);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// One radix-2 decimation-in-frequency stage over groups of 2 * kSpan.
template <int kSpan>
__device__ __forceinline__ void dif_stage(float2 (&v)[32],
                                          const float2* __restrict__ tw32) {
#pragma unroll
  for (int g = 0; g < 32; g += 2 * kSpan) {
#pragma unroll
    for (int j = 0; j < kSpan; ++j) {
      const float2 a = v[g + j];
      const float2 b = v[g + j + kSpan];
      v[g + j] = make_float2(a.x + b.x, a.y + b.y);
      const float2 d = make_float2(a.x - b.x, a.y - b.y);
      const int e = j * (16 / kSpan);   // W_(2 kSpan)^j = W_32^e
      if (e == 0) {
        v[g + j + kSpan] = d;
      } else if (e == 8) {              // W_32^8 = -i
        v[g + j + kSpan] = make_float2(d.y, -d.x);
      } else {
        v[g + j + kSpan] = cmul(d, __ldg(tw32 + e));
      }
    }
  }
}

// In-place radix-2 DIF FFT of 32 points in registers (every index a
// compile-time constant): afterwards v[bitrev5(k)] = sum_a v_in[a] W_32^(a k).
__device__ __forceinline__ void fft32(float2 (&v)[32],
                                      const float2* __restrict__ tw32) {
  dif_stage<16>(v, tw32);
  dif_stage<8>(v, tw32);
  dif_stage<4>(v, tw32);
  dif_stage<2>(v, tw32);
  dif_stage<1>(v, tw32);
}

__global__ void __launch_bounds__(kThreads, 2) logmel_fft_kernel(
    const float* __restrict__ samples, const float* __restrict__ window,
    const float2* __restrict__ twiddles, const int2* __restrict__ bands,
    const float* __restrict__ weights, float* __restrict__ out, int n,
    int hop, int n_frames, int num_mel, float log_eps) {
  extern __shared__ __align__(16) float smem[];
  const int stage_len = (kWarps - 1) * hop + kFft;   // a multiple of 4
  float* stage = smem;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float2* buf = reinterpret_cast<float2*>(smem + stage_len) + warp * kWarpBuffer;

  // Stage the block's samples: 16-byte loads, zero past the segment's end
  // (n and hop are multiples of 4, so a vector is all in or all out).
  const int frame0 = blockIdx.x * kWarps;
  const int base = frame0 * hop;
  const float* segment = samples + static_cast<size_t>(blockIdx.y) * n;
  for (int i = 4 * tid; i < stage_len; i += 4 * kThreads) {
    const int pos = base + i;
    *reinterpret_cast<float4*>(stage + i) =
        pos < n ? __ldg(reinterpret_cast<const float4*>(segment + pos))
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  const int frame = frame0 + warp;
  if (frame >= n_frames) return;   // no block-wide barrier follows

  // z[32 a + lane], windowed.
  const float* x = stage + warp * hop;
  float2 v[32];
#pragma unroll
  for (int a = 0; a < 32; ++a) {
    const int t = 64 * a + 2 * lane;
    const float2 s = *reinterpret_cast<const float2*>(x + t);
    const float2 w = __ldg(reinterpret_cast<const float2*>(window + t));
    v[a] = make_float2(s.x * w.x, s.y * w.y);
  }

  // First 32-point FFTs (over a, lane = b), twiddle, transpose.
  const float2* tw32 = twiddles + kTw32;
  fft32(v, tw32);
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    float2 y = v[bitrev5(c)];
    if (c > 0) y = cmul(y, __ldg(twiddles + kTwStep + c * 32 + lane));
    buf[c * kPitch + lane] = y;
  }
  __syncwarp();
#pragma unroll
  for (int b = 0; b < 32; ++b) v[b] = buf[lane * kPitch + b];
  __syncwarp();

  // Second 32-point FFTs (over b, lane = c): Z[lane + 32 d], stored in
  // natural order.
  fft32(v, tw32);
#pragma unroll
  for (int d = 0; d < 32; ++d) buf[lane + 32 * d] = v[bitrev5(d)];
  __syncwarp();

  // Split step: bins k and 1024 - k from Z[k] and Z[1024 - k], for
  // k = lane + 32 j < 512; lane 0 also takes bin 512.
  float lo[16], hi[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int k = lane + 32 * j;
    const float2 za = buf[k];
    const float2 zb = buf[(1024 - k) & 1023];
    const float2 t = __ldg(twiddles + kTwSplit + k);
    const float ex = za.x + zb.x, ey = za.y - zb.y;   // Z[k] + Z*[1024-k]
    const float ox = za.x - zb.x, oy = za.y + zb.y;   // Z[k] - Z*[1024-k]
    const float p = t.x * oy + t.y * ox;
    const float q = t.x * ox - t.y * oy;
    lo[j] = 0.5f * sqrtf((ex + p) * (ex + p) + (ey - q) * (ey - q));
    hi[j] = 0.5f * sqrtf((ex - p) * (ex - p) + (ey + q) * (ey + q));
  }
  const float2 z512 = buf[512];
  const float mid = sqrtf(z512.x * z512.x + z512.y * z512.y);   // |conj Z[512]|
  __syncwarp();
  float* mag = reinterpret_cast<float*>(buf);   // bins 0..1024
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int k = lane + 32 * j;
    mag[k] = lo[j];
    mag[1024 - k] = hi[j];
  }
  if (lane == 0) mag[512] = mid;
  __syncwarp();

  // Mel bands and the safe log; lanes write consecutive filters.
  float* row = out + (static_cast<size_t>(blockIdx.y) * n_frames + frame) * num_mel;
  for (int m = lane; m < num_mel; m += 32) {
    const int2 band = __ldg(bands + m);   // (first bin, count)
    float acc = 0.f;
    for (int t = 0; t < band.y; ++t)
      acc = fmaf(__ldg(weights + t * num_mel + m), mag[band.x + t], acc);
    row[m] = acc <= 0.f ? log_eps : logf(acc);
  }
}

int shared_bytes(int hop) {
  return ((kWarps - 1) * hop + kFft) * 4 + kWarps * kWarpBuffer * 8;
}

}  // namespace

extern "C" {

// samples [batch, n] float32; window [2048] float32; twiddles [2065, 2]
// float32 (see kTw*); bands [num_mel, 2] int32 (first bin, count); weights
// [max count, num_mel] float32; out [batch, n / hop, num_mel] float32.  All
// contiguous, 16-byte aligned.  n a multiple of hop, hop of 4.  log_eps is
// log(eps) in float32.  Returns the cudaError_t of the launch.
int mt3_logmel(const void* samples, const void* window, const void* twiddles,
               const void* bands, const void* weights, void* out, int batch,
               int n, int hop, int fft, int num_mel, float log_eps,
               void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || hop <= 0 || hop % 4 != 0 ||
      n % hop != 0 || fft != kFft || num_mel <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB of shared memory a kernel must opt in, on each device; done
  // once per device and size, so that calls captured in a CUDA graph make
  // no such host call.
  constexpr int kMaxDevices = 64;
  static int opted_in_bytes[kMaxDevices] = {};
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return static_cast<int>(status);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const int bytes = shared_bytes(hop);
  if (bytes > opted_in_bytes[device]) {
    status = cudaFuncSetAttribute(
        logmel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (status != cudaSuccess) return static_cast<int>(status);
    opted_in_bytes[device] = bytes;
  }
  const int n_frames = n / hop;
  const dim3 grid((n_frames + kWarps - 1) / kWarps, batch);
  logmel_fft_kernel<<<grid, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(samples), static_cast<const float*>(window),
      static_cast<const float2*>(twiddles), static_cast<const int2*>(bands),
      static_cast<const float*>(weights), static_cast<float*>(out), n, hop,
      n_frames, num_mel, log_eps);
  return static_cast<int>(cudaGetLastError());
}

const char* mt3_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
