// Kernel A: fused log-mel spectrogram of 16 kHz audio.
//
// Replaces the Pallas TPU kernel mt3_tpu/ops/pallas/logmel.py:logmel_fused
// (wrapper :81, body _logmel_kernel :52, pallas_call :99).
//
//   frame i of a segment = samples [hop*i, hop*i + fft), zero past the end
//   re, im = frame @ (Hann-windowed real-DFT cos, sin)      [fft, fft/2+1]
//   out    = log(max-clamp(sqrt(re^2 + im^2) @ mel))        [fft/2+1, 512]
//
// What bounds it on the H100.  The function itself needs little: a real FFT
// of 2048 points is about 2.5*N*log2(N) = 56k flops a frame, and the HTK mel
// filters have about 2 nonzeros per DFT bin, so a frame needs under 70k
// flops against 0.5 KB of new audio read and 2 KB written; its bound is
// about even between the float32 rate and the memory rate.  This kernel
// keeps the TPU kernel's algorithm instead, a dense windowed DFT as a
// matmul: 2*2048*1025*2 flops a frame for the two DFT products plus
// 2*1025*512 for a dense mel product, 9.45 MFLOP, all float32 (TF32 keeps
// ~3 digits, which misses the 5e-3 log-domain tolerance the JAX tests hold
// the TPU kernel to).  That algorithm is bound by the card's float32 rate
// outside the tensor cores; chip_smoke.py reports both bounds.
//
// Design.  The TPU kernel carries the mel sum across a sequential frequency
// grid axis; CUDA blocks run in no order, so here one block owns 16
// consecutive frames of one segment and loops over the frequency tiles
// itself, keeping the [16, 512] mel accumulator in registers (32 floats a
// thread).  Per 64-bin frequency tile:
//   * 32-sample chunks of the block's frames are gathered straight from the
//     flat [batch, n] audio (the framing is fused: no [N, 2048] frames tensor
//     exists) and, with the matching rows of the cos/sin bases, staged in
//     shared memory;
//   * each thread accumulates re/im for 4 frames x 1 bin with float32 FMAs;
//   * the magnitudes go to shared memory, never to device memory, and are
//     multiplied into the accumulator against the tile's mel rows, staged 8
//     rows at a time.
// The safe log is applied once, at the end.  The bases are zero-padded to a
// multiple of 64 bins, so padded bins add exact zeros.  Tensor cores (3xTF32
// or wgmma) and a split over frequency across blocks are later changes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 16;     // frames per block
constexpr int kFreqTile = 64;   // DFT bins per tile
constexpr int kChunk = 32;      // samples per staged chunk
constexpr int kMel = 512;       // mel bins (fixed: 64 threads x 8 columns)
constexpr int kMelRows = 8;     // mel rows staged at a time
constexpr int kFramePad = 4;    // breaks the stride of the frame stores

static_assert(kThreads == 4 * kFreqTile, "4 frame groups x 64 bins");
static_assert(kFrames == 16, "4 frame groups x 4 frames");

__global__ void __launch_bounds__(kThreads) logmel_kernel(
    const float* __restrict__ samples, const float* __restrict__ w_cos,
    const float* __restrict__ w_sin, const float* __restrict__ mel,
    float* __restrict__ out, int n, int hop, int fft, int n_freq_pad,
    int n_frames, float eps) {
  __shared__ __align__(16) float frames_s[kChunk][kFrames + kFramePad];
  __shared__ __align__(16) float cos_s[kChunk][kFreqTile];
  __shared__ __align__(16) float sin_s[kChunk][kFreqTile];
  __shared__ __align__(16) float mag_s[kFreqTile][kFrames];
  __shared__ __align__(16) float mel_s[kMelRows][kMel];

  const int tid = threadIdx.x;
  const int frame0 = blockIdx.x * kFrames;
  const float* segment = samples + static_cast<size_t>(blockIdx.y) * n;
  // DFT phase: frames 4*group .. 4*group+3, bin `bin` of the tile.
  // Mel phase: the same 4 frames, mel columns col + 64*c for c < 8.
  const int group = tid / kFreqTile;
  const int bin = tid % kFreqTile;
  const int col = tid % 64;

  float acc[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int f0 = 0; f0 < n_freq_pad; f0 += kFreqTile) {
    float re[4] = {0.f, 0.f, 0.f, 0.f};
    float im[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < fft; k0 += kChunk) {
      __syncthreads();  // every thread is done with the previous chunk
      for (int e = tid; e < kFrames * kChunk; e += kThreads) {
        const int k = e % kChunk;
        const int f = e / kChunk;
        const int frame = frame0 + f;
        const int pos = frame * hop + k0 + k;
        frames_s[k][f] = (frame < n_frames && pos < n) ? segment[pos] : 0.f;
      }
      for (int e = tid; e < kChunk * kFreqTile / 4; e += kThreads) {
        const int row = e / (kFreqTile / 4);
        const int c4 = 4 * (e % (kFreqTile / 4));
        const size_t at = static_cast<size_t>(k0 + row) * n_freq_pad + f0 + c4;
        *reinterpret_cast<float4*>(&cos_s[row][c4]) =
            *reinterpret_cast<const float4*>(w_cos + at);
        *reinterpret_cast<float4*>(&sin_s[row][c4]) =
            *reinterpret_cast<const float4*>(w_sin + at);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float4 x = *reinterpret_cast<const float4*>(&frames_s[k][4 * group]);
        const float c = cos_s[k][bin];
        const float s = sin_s[k][bin];
        re[0] = fmaf(x.x, c, re[0]);
        re[1] = fmaf(x.y, c, re[1]);
        re[2] = fmaf(x.z, c, re[2]);
        re[3] = fmaf(x.w, c, re[3]);
        im[0] = fmaf(x.x, s, im[0]);
        im[1] = fmaf(x.y, s, im[1]);
        im[2] = fmaf(x.z, s, im[2]);
        im[3] = fmaf(x.w, s, im[3]);
      }
    }
    // Every thread has passed this tile's first barrier, so no thread still
    // reads the previous tile's magnitudes.
    float4 magnitude;
    magnitude.x = sqrtf(re[0] * re[0] + im[0] * im[0]);
    magnitude.y = sqrtf(re[1] * re[1] + im[1] * im[1]);
    magnitude.z = sqrtf(re[2] * re[2] + im[2] * im[2]);
    magnitude.w = sqrtf(re[3] * re[3] + im[3] * im[3]);
    *reinterpret_cast<float4*>(&mag_s[bin][4 * group]) = magnitude;

    for (int r0 = 0; r0 < kFreqTile; r0 += kMelRows) {
      __syncthreads();  // magnitudes written; previous mel rows consumed
      for (int e = tid; e < kMelRows * kMel / 4; e += kThreads) {
        const int row = e / (kMel / 4);
        const int c4 = 4 * (e % (kMel / 4));
        *reinterpret_cast<float4*>(&mel_s[row][c4]) =
            *reinterpret_cast<const float4*>(
                mel + static_cast<size_t>(f0 + r0 + row) * kMel + c4);
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kMelRows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(&mag_s[r0 + r][4 * group]);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float w = mel_s[r][col + 64 * c];
          acc[0][c] = fmaf(a.x, w, acc[0][c]);
          acc[1][c] = fmaf(a.y, w, acc[1][c]);
          acc[2][c] = fmaf(a.z, w, acc[2][c]);
          acc[3][c] = fmaf(a.w, w, acc[3][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int frame = frame0 + 4 * group + r;
    if (frame >= n_frames) continue;
    float* row = out + (static_cast<size_t>(blockIdx.y) * n_frames + frame) * kMel;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float v = acc[r][c];
      row[col + 64 * c] = logf(v <= 0.f ? eps : v);
    }
  }
}

}  // namespace

extern "C" {

// samples [batch, n] float32; w_cos, w_sin [fft, n_freq_pad]; mel
// [n_freq_pad, num_mel]; out [batch, n / hop, num_mel].  All contiguous
// float32.  Returns the cudaError_t of the launch.
int mt3_logmel(const void* samples, const void* w_cos, const void* w_sin,
               const void* mel, void* out, int batch, int n, int hop, int fft,
               int n_freq_pad, int num_mel, float eps, void* stream) {
  if (batch <= 0 || n <= 0 || hop <= 0 || n % hop != 0 || fft % kChunk != 0 ||
      n_freq_pad % kFreqTile != 0 || num_mel != kMel || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_frames = n / hop;
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  logmel_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(samples), static_cast<const float*>(w_cos),
      static_cast<const float*>(w_sin), static_cast<const float*>(mel),
      static_cast<float*>(out), n, hop, fft, n_freq_pad, n_frames, eps);
  return static_cast<int>(cudaGetLastError());
}

const char* mt3_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
