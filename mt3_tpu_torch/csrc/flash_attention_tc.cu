// Kernel C in bfloat16 on the tensor cores: blockwise (flash) attention,
// forward and backward, for training.
//
// Replaces the stock Pallas TPU kernel that the JAX package calls at
// mt3_tpu/models/layers.py:230-243,
// jax/experimental/pallas/ops/tpu/flash_attention.py (jax 0.9.0):
//   mt3_flash_tc_fwd  <- _flash_attention_impl     (:589, pallas_call :758)
//   mt3_flash_tc_dq   <- _flash_attention_bwd_dq   (:1287, pallas_call :1456),
//                        plus di = rowsum(o * dO) (stock :274, done in XLA)
//   mt3_flash_tc_dkv  <- _flash_attention_bwd_dkv  (:941, pallas_call :1121)
// float32 inputs take flash_attention.cu, the same kernels with split TF32
// products.  The kernels are flash_attention_kernels.cuh's, instantiated
// here on Bf16Ops: bf16 tiles, mma.sync.m16n8k16 (bf16 in, float32
// accumulate), with p and dS rounded to bf16 right before each product,
// where the stock kernel casts them (:471, :900, :918, :1258).
//
// What bounds it on the H100.  At the training calls (b=64, h=6, d=64;
// 256x256 full, 1024x1024 causal, 1024x256 full) the forward and the whole
// backward are bound by bytes, each input read once and each output written
// once at 3.35 TB/s, by a small margin over their operations at the bf16
// tensor-core rate of 989 TFLOP/s (PERF.md, kernel table).  So the kernels
// have to run their products on the tensor cores and keep the score
// matrices out of device memory, and no more.
//
// The policy: operands come from shared memory by ldmatrix, and
// ldmatrix.trans gives the transposed operand (V in p.V, K in dS.K, dO and
// q in dK/dV), so nothing is transposed in memory.  Tiles have 128-byte
// rows whose 16-byte chunks are XOR-swizzled by row % 8, so ldmatrix's
// eight rows hit eight different bank groups.  The block's own tiles stay
// in registers as A fragments; the forward gives each warp two 16-row
// tiles, so that each K and V fragment feeds two products.  p and dS are
// the float32 S and dP accumulator fragments rounded to bf16 pairs, the A
// fragments of the next product as they stand (FA2's register reuse).

#include <cuda_bf16.h>

#include "flash_attention_kernels.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::kD;
using flash::smem_u32;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
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
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t): A holds rows g and
// g + 8 at columns 2t, 2t + 1 (+ 8); B holds rows (k) 2t, 2t + 1 (+ 8) at
// column (n) g; the accumulator holds rows g (c0, c1) and g + 8 (c2, c3)
// at columns 2t, 2t + 1.
struct Bf16Ops {
  using T = bf16;
  static constexpr int kFwdM = 2;

  // The 16 x 64 A operand as 4 fragments of 16 columns.
  struct A {
    uint32_t f[4][4];
  };

  // Element offset of (row, col) in a [64][64] tile whose 16-byte chunks
  // are XOR-swizzled by row % 8.
  static __device__ __forceinline__ int swz(int row, int col) {
    return row * kD + ((((col >> 3) ^ row) & 7) << 3) + (col & 7);
  }

  // Rows [r0, r0 + 16) of a tile.
  static __device__ __forceinline__ void load_a(A& a, const bf16* tile,
                                                int r0, int lane) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldmatrix_x4(a.f[kk],
                  tile + swz(r0 + (lane & 15), 16 * kk + ((lane >> 4) << 3)));
  }

  // B fragments of two 8-column blocks for a product with tile^T: tile
  // rows [n0, n0 + 16) are the columns n, tile columns [k0, k0 + 16) the
  // depth.  b[0], b[1] serve columns n0..n0+7; b[2], b[3] n0+8..n0+15.
  static __device__ __forceinline__ void load_b(uint32_t (&b)[4],
                                                const bf16* tile, int n0,
                                                int k0, int lane) {
    ldmatrix_x4(b, tile + swz(n0 + (lane & 7) + ((lane >> 4) << 3),
                              k0 + (((lane >> 3) & 1) << 3)));
  }

  // B fragments of two 8-column blocks for a product with the tile as it
  // stands: tile rows [k0, k0 + 16) are the depth, tile columns [n0, n0 +
  // 16) the columns n.  Same register order as load_b.
  static __device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                                      const bf16* tile,
                                                      int k0, int n0,
                                                      int lane) {
    ldmatrix_x4_trans(b,
                      tile + swz(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                 n0 + ((lane >> 4) << 3)));
  }

  // acc[m] (M tiles of 16 rows x 64 columns) += a[m] times tile^T, where
  // the tile's rows are the 64 columns.  Each B fragment serves all M row
  // tiles.
  template <int M>
  static __device__ __forceinline__ void mma_abt(float (&acc)[M][8][4],
                                                 const A (&a)[M],
                                                 const bf16* tile, int lane) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        load_b(b, tile, 16 * j, 16 * kk, lane);
#pragma unroll
        for (int mi = 0; mi < M; ++mi) {
          mma(acc[mi][2 * j], a[mi].f[kk], b[0], b[1]);
          mma(acc[mi][2 * j + 1], a[mi].f[kk], b[2], b[3]);
        }
      }
  }

  // acc[m] += cast(x[m]) (16 x 64 float32 accumulator fragments, rounded
  // to bf16 A fragments in registers) times the tile.
  template <int M>
  static __device__ __forceinline__ void mma_xb(float (&acc)[M][8][4],
                                                const float (&x)[M][8][4],
                                                const bf16* tile, int lane) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[M][4];
#pragma unroll
      for (int mi = 0; mi < M; ++mi) {
        a[mi][0] = pack_bf16(x[mi][2 * kk][0], x[mi][2 * kk][1]);
        a[mi][1] = pack_bf16(x[mi][2 * kk][2], x[mi][2 * kk][3]);
        a[mi][2] = pack_bf16(x[mi][2 * kk + 1][0], x[mi][2 * kk + 1][1]);
        a[mi][3] = pack_bf16(x[mi][2 * kk + 1][2], x[mi][2 * kk + 1][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b[4];
        load_b_trans(b, tile, 16 * kk, 16 * j, lane);
#pragma unroll
        for (int mi = 0; mi < M; ++mi) {
          mma(acc[mi][2 * j], a[mi], b[0], b[1]);
          mma(acc[mi][2 * j + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }

  // Elements (row, col) and (row, col + 1) of a tile, col even.
  static __device__ __forceinline__ float2 load2(const bf16* tile, int row,
                                                 int col) {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(tile + swz(row, col)));
  }

  static __device__ __forceinline__ void store2(bf16* out, float lo,
                                                float hi) {
    *reinterpret_cast<uint32_t*>(out) = pack_bf16(lo, hi);
  }
};

using Run = flash::Launch<Bf16Ops>;

}  // namespace

extern "C" {

// bfloat16 entry points; each returns the cudaError_t of its launch.
// The backward runs mt3_flash_tc_dq (which writes di) before
// mt3_flash_tc_dkv (which reads it).

int mt3_flash_tc_fwd(const FlashArgs* a, void* stream) {
  return Run::fwd(a, stream);
}

int mt3_flash_tc_dq(const FlashArgs* a, void* stream) {
  return Run::dq(a, stream);
}

int mt3_flash_tc_dkv(const FlashArgs* a, void* stream) {
  return Run::dkv(a, stream);
}

const char* mt3_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
