// Arguments shared by the kernel C entry points of flash_attention.cu
// (float32, FMA) and flash_attention_tc.cu (bfloat16, tensor cores).
//
// ops/flash_attention.py fills a ctypes.Structure of the same layout and
// passes its address; each entry point copies it into the kernel's
// parameters.  q, o, dout and dq are [b, h, lq, 64], k, v, dk and dv
// [b, h, lk, 64], each with its own batch, head and row strides (in
// elements) and a unit last stride, so the [b, len, h, d] activations of
// layers.attention go in as transposed views, without a copy.  lse and di
// are contiguous float32 [b, h, lq].

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct FlashStrides {
  int64_t batch, head, row;
};

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;      // written by the forward; read by dQ for di
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;   // written by the forward
  float* di;    // rowsum(o * dout), written by dQ, read by dK/dV
  FlashStrides q_st, k_st, v_st, o_st, dout_st, dq_st, dk_st, dv_st;
  int batch, heads, lq, lk, head_dim, causal;
  float sm_scale;
};

// First element of (batch, head) bh = batch * heads + head of a tensor.
template <typename T>
__device__ __forceinline__ T* head_base(const void* p, const FlashStrides& st,
                                        int bh, int heads) {
  return static_cast<T*>(const_cast<void*>(p)) + (bh / heads) * st.batch +
         (bh % heads) * st.head;
}

// Launches kernel over (batch * heads, ceil(len / rows)) blocks of
// `threads` threads with `smem` bytes of dynamic shared memory (a kernel
// must opt in above 48 KB), on the caller's stream.  Returns the
// cudaError_t of the launch; what the kernels do not take (empty inputs,
// a grid too large, a head dim other than 64) is cudaErrorInvalidValue.
template <typename Kernel>
int flash_launch(Kernel kernel, int threads, size_t smem, int len, int rows,
                 const FlashArgs* a, void* stream) {
  const int64_t tiles =
      len > 0 ? (static_cast<int64_t>(len) + rows - 1) / rows : 0;
  if (a->batch <= 0 || a->heads <= 0 || a->lq <= 0 || a->lk <= 0 ||
      static_cast<int64_t>(a->batch) * a->heads > 0x7fffffff ||
      tiles > 65535 || a->head_dim != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) {
    kernel<<<dim3(a->batch * a->heads, static_cast<unsigned>(tiles)), threads,
             smem, static_cast<cudaStream_t>(stream)>>>(*a);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
