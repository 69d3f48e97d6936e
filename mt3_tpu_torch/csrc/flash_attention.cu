// Kernel C in float32 on the tensor cores: blockwise (flash) attention,
// forward and backward, for training, with split TF32 products.
//
// Replaces the stock Pallas TPU kernel that the JAX package calls at
// mt3_tpu/models/layers.py:230-243,
// jax/experimental/pallas/ops/tpu/flash_attention.py (jax 0.9.0):
//   mt3_flash_3xtf32_fwd  <- _flash_attention_impl     (:589, pallas_call :758)
//   mt3_flash_3xtf32_dq   <- _flash_attention_bwd_dq   (:1287, pallas_call
//                            :1456), plus di = rowsum(o * dO) (stock :274,
//                            done in XLA)
//   mt3_flash_3xtf32_dkv  <- _flash_attention_bwd_dkv  (:941, pallas_call :1121)
// for float32 inputs, the JAX package's default activation dtype; bfloat16
// takes flash_attention_tc.cu.  Both instantiate the kernels of
// flash_attention_kernels.cuh (tiling, cp.async ring, online softmax,
// causal skip, di, dK/dV), here on Tf32x3Ops.
//
// What bounds it on the H100.  At the training calls (b=64, h=6, d=64;
// 256x256 full, 1024x1024 causal, 1024x256 full) float32 attention is
// bound by its operations: 4, 6 and 8 flops per (query, key, dim) for the
// forward, dQ and dK/dV, against 3.35 TB/s for 4-byte elements read once.
// The float32 units give 67 TFLOP/s; float32-accurate products on the
// tensor cores give 495 / 3 = 165 TFLOP/s, three TF32 products for each
// float32 product.  That second rate is the bound (PERF.md, kernel table).
//
// The split.  Each operand x becomes hi = x rounded to TF32 (to nearest,
// ties away) and lo = x - hi, which the tensor cores truncate to TF32:
// about 21 bits of x where TF32 alone keeps 11.  A product is hi lo + lo
// hi, then hi hi, as three mma.sync.m16n8k8 TF32 products (CUTLASS's
// OpMultiplyAddFastF32).  The lo lo term (2**-22 of the product) is left
// out.  The tensor cores' float32 sums may truncate, so the small terms go
// to an accumulator of their own, and each tile's product starts from
// zero and joins the running sum by a float32 add: the truncation then
// touches the 8 k-steps of a tile, not the 128 of a 1024-key row
// (tests/test_torch_flash_attention_split.py mirrors this).  What it
// costs: three products where bf16 runs one, at a sixth of bf16's rate;
// two integer operations and a subtraction for every operand element a
// warp reads; a second accumulator.  The global TF32 flags stay off;
// phase 7 of chip_smoke.py holds each output within 4 times the plain
// float32 version's own error against float64.
//
// The policy.  Tiles are float32 with 256-byte rows whose 16-byte chunks
// are XOR-swizzled by swz() below.  Fragments come from shared memory by
// ld.shared (ldmatrix moves 16-bit elements), two ways:
//   * along rows (q k^T, dO v^T, k q^T, v dO^T): a product over the head
//     dim may take its depth in any order, so within each 16 columns lane
//     t reads columns 4t..4t+3 as one 16-byte load, the depth indices t
//     and t + 4 of two k-steps, for A and B alike;
//   * across rows (p v, dS k, p^T dO, dS^T q): the A operand is the float32
//     accumulator, whose lane holds columns 2t and 2t + 1 of each 8-column
//     block; they are taken as depth indices t and t + 4, so B reads rows
//     2t and 2t + 1 of the same block (scalar loads).
// The swizzle puts both access patterns on distinct banks.  The block's
// own tiles stay in shared memory, read again at every tile the loop walks
// over (registers do not hold split fragments of 16 rows of q, dO, k or
// v), and the forward gives each warp one 16-row tile (64 query rows a
// block).
//
// Registers.  The forward and dQ instantiations use all 255 registers and
// ptxas spills 16 and 20 bytes a thread (its `-v` report, which
// ops/cuda_build.py asks for and chip_smoke.py logs; dK/dV fits in 227
// registers without).  The spills come from mma_abt, which holds the hi and
// lo fragments of both k-steps of a 16-column chunk at once (ah/al below)
// beside two accumulators.  The design accepts them: a few words a thread,
// stored once and reloaded from L1, against the tile traffic of every loop
// step.  Splitting mma_abt's fragments per k-step would remove them; that is
// left for the kernel's next redesign (wgmma, TMA).

#include "flash_attention_kernels.cuh"

namespace {

using flash::kD;

// d += a b for a 16x8 TF32 A fragment and an 8x8 TF32 B fragment.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to TF32, to nearest with ties away from zero, as
// cvt.rna.tf32.f32 rounds it: half a TF32 ulp added to the magnitude bits,
// then the 13 low bits cleared: two integer operations in place of a
// conversion instruction.  x is finite and far from FLT_MAX.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo exactly, hi in TF32.  lo goes to the tensor cores as it
// stands: they read its top 19 bits, so lo is truncated to TF32 there
// (CUTLASS's FastF32 passes its small part the same way), which leaves
// under 2**-21 of x out.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// small += a_lo b_hi + a_hi b_lo; big += a_hi b_hi.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

// Fragment layouts of mma.m16n8k8 with TF32 (lane = 4 * g + t): A holds
// (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B holds (k t, n g)
// and (t + 4, g); the accumulator as in flash_attention_kernels.cuh.
struct Tf32x3Ops {
  using T = float;
  static constexpr int kFwdM = 1;

  // The 16 x 64 A operand: rows [r0, r0 + 16) of a tile in shared memory.
  struct A {
    const float* tile;
    int r0;
  };

  // Element offset of (row, col) in a [64][64] float32 tile: the 16-byte
  // chunk col / 4 is XORed with (row & 6) ^ ((row & 1) << 2).  Along rows,
  // each quarter warp reads rows 2i and 2i + 1, 4 chunks each, whose chunk
  // XORs differ in bit 2: 8 distinct bank groups.  Across rows, a warp
  // reads rows 2t (or 2t + 1) of an 8-row block at 8 consecutive columns
  // (2 chunks), whose XORs differ in bits 1-2: 32 distinct banks.
  static __device__ __forceinline__ int swz(int row, int col) {
    const int x = (row & 6) ^ ((row & 1) << 2);
    return row * kD + ((((col >> 2) ^ x)) << 2) + (col & 3);
  }

  static __device__ __forceinline__ void load_a(A& a, const float* tile,
                                                int r0, int lane) {
    a.tile = tile;
    a.r0 = r0;
  }

  // acc[m] (M tiles of 16 rows x 64 columns) += a[m] times tile^T, where
  // the tile's rows are the 64 columns; the kernels pass acc zeroed, so the
  // hi hi products go to acc itself.  Within 16 columns of depth, lane t
  // reads columns 4t..4t+3: k-step 2kk takes 4t, 4t + 1 as depth indices t
  // and t + 4, k-step 2kk + 1 takes 4t + 2, 4t + 3.
  template <int M>
  static __device__ __forceinline__ void mma_abt(float (&acc)[M][8][4],
                                                 const A (&a)[M],
                                                 const float* tile,
                                                 int lane) {
    const int g = lane >> 2, t = lane & 3;
    float small[M][8][4];
#pragma unroll
    for (int mi = 0; mi < M; ++mi) flash::zero(small[mi]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ah[M][2][4], al[M][2][4];   // [k-step][register]
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
        const float4 x0 = *reinterpret_cast<const float4*>(
            a[mi].tile + swz(a[mi].r0 + g, 16 * kk + 4 * t));
        const float4 x1 = *reinterpret_cast<const float4*>(
            a[mi].tile + swz(a[mi].r0 + g + 8, 16 * kk + 4 * t));
        split(x0.x, ah[mi][0][0], al[mi][0][0]);
        split(x1.x, ah[mi][0][1], al[mi][0][1]);
        split(x0.y, ah[mi][0][2], al[mi][0][2]);
        split(x1.y, ah[mi][0][3], al[mi][0][3]);
        split(x0.z, ah[mi][1][0], al[mi][1][0]);
        split(x1.z, ah[mi][1][1], al[mi][1][1]);
        split(x0.w, ah[mi][1][2], al[mi][1][2]);
        split(x1.w, ah[mi][1][3], al[mi][1][3]);
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const float4 y = *reinterpret_cast<const float4*>(
            tile + swz(8 * nb + g, 16 * kk + 4 * t));
        uint32_t bh[4], bl[4];
        split(y.x, bh[0], bl[0]);
        split(y.y, bh[1], bl[1]);
        split(y.z, bh[2], bl[2]);
        split(y.w, bh[3], bl[3]);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int mi = 0; mi < M; ++mi)
            mma3(acc[mi][nb], small[mi][nb], ah[mi][ks], al[mi][ks],
                 bh[2 * ks], bh[2 * ks + 1], bl[2 * ks], bl[2 * ks + 1]);
      }
    }
#pragma unroll
    for (int mi = 0; mi < M; ++mi)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nb][e] += small[mi][nb][e];
  }

  // acc[m] += x[m] (16 x 64 float32 accumulator fragments) times the tile.
  // k-step kb is x's column block kb: the lane's columns 2t and 2t + 1 are
  // depth indices t and t + 4, and B reads tile rows 8kb + 2t, 8kb + 2t +
  // 1 at column 8nb + g.
  template <int M>
  static __device__ __forceinline__ void mma_xb(float (&acc)[M][8][4],
                                                const float (&x)[M][8][4],
                                                const float* tile, int lane) {
    const int g = lane >> 2, t = lane & 3;
    float big[M][8][4], small[M][8][4];
#pragma unroll
    for (int mi = 0; mi < M; ++mi) {
      flash::zero(big[mi]);
      flash::zero(small[mi]);
    }
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      uint32_t ah[M][4], al[M][4];
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
        split(x[mi][kb][0], ah[mi][0], al[mi][0]);   // (g, 2t)
        split(x[mi][kb][2], ah[mi][1], al[mi][1]);   // (g + 8, 2t)
        split(x[mi][kb][1], ah[mi][2], al[mi][2]);   // (g, 2t + 1)
        split(x[mi][kb][3], ah[mi][3], al[mi][3]);   // (g + 8, 2t + 1)
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        uint32_t bh0, bl0, bh1, bl1;
        split(tile[swz(8 * kb + 2 * t, 8 * nb + g)], bh0, bl0);
        split(tile[swz(8 * kb + 2 * t + 1, 8 * nb + g)], bh1, bl1);
#pragma unroll
        for (int mi = 0; mi < M; ++mi)
          mma3(big[mi][nb], small[mi][nb], ah[mi], al[mi], bh0, bh1, bl0,
               bl1);
      }
    }
#pragma unroll
    for (int mi = 0; mi < M; ++mi)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mi][nb][e] += big[mi][nb][e] + small[mi][nb][e];
  }

  // Elements (row, col) and (row, col + 1) of a tile, col even.
  static __device__ __forceinline__ float2 load2(const float* tile, int row,
                                                 int col) {
    return *reinterpret_cast<const float2*>(tile + swz(row, col));
  }

  static __device__ __forceinline__ void store2(float* out, float lo,
                                                float hi) {
    *reinterpret_cast<float2*>(out) = make_float2(lo, hi);
  }
};

using Run = flash::Launch<Tf32x3Ops>;

}  // namespace

extern "C" {

// float32 entry points; each returns the cudaError_t of its launch.  The
// backward runs mt3_flash_3xtf32_dq (which writes di) before
// mt3_flash_3xtf32_dkv (which reads it).

int mt3_flash_3xtf32_fwd(const FlashArgs* a, void* stream) {
  return Run::fwd(a, stream);
}

int mt3_flash_3xtf32_dq(const FlashArgs* a, void* stream) {
  return Run::dq(a, stream);
}

int mt3_flash_3xtf32_dkv(const FlashArgs* a, void* stream) {
  return Run::dkv(a, stream);
}

const char* mt3_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
