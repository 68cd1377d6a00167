// Shared helpers for the port's CUDA kernels (built by kernels/build.py).
//
// Streams (z, xbc, dt, conv tails, outputs) come in the model's dtype T,
// float or bf16; every interior is fp32.  The activations use the same
// formulas as PyTorch's own CUDA ops (silu = x / (1 + exp(-x)); softplus
// with threshold 20), so a kernel and its plain PyTorch version differ
// only in the order of their sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// Round a float to T and back: the stream dtype's rounding point.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float silu_f(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ float softplus_f(float x) {
  return x > 20.0f ? x : log1pf(expf(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dtype codes passed from Python: 0 = float32, 1 = bfloat16.
#define DISPATCH_T(code, ...)                          \
  do {                                                 \
    if ((code) == 0) {                                 \
      using T = float;                                 \
      __VA_ARGS__;                                     \
    } else {                                           \
      using T = __nv_bfloat16;                         \
      __VA_ARGS__;                                     \
    }                                                  \
  } while (0)

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
