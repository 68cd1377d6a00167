// CumBA: the cumulative sum along the last axis, fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/cumba.py:51 cumsum_last, which
// multiplies (rows, 256) blocks by an upper-triangular ones mask on the
// MXU and carries each row's running prefix across the sequential grid in
// a VMEM scratch.  out[r, i] = sum_{j <= i} x[r, j], in x's dtype T.
//
// Bound: bytes.  Each element is read once and written once, with one add
// of work; on the SSD path (rows = b*h*c = 192, t = chunk = 256, fp32)
// that is 0.4 MB, so the launch itself sets the pace.
//
// Design.  A triangular matmul does t/2 times the adds a scan needs and
// buys nothing on a card whose CUDA cores do the adds directly, so the
// port keeps what the TPU kernel carries and drops the mask: one warp per
// row walks the row in tiles of 32 elements, takes an inclusive shuffle
// scan inside the tile (5 steps), adds the carried prefix of the earlier
// tiles and passes the tile's total on as the next carry, like the TPU
// kernel's scratch accumulator.
#include "common.cuh"

template <typename T>
__global__ void cumsum_last_kernel(const T* __restrict__ x,
                                   T* __restrict__ out, int rows, int t) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const T* xr = x + static_cast<size_t>(row) * t;
  T* orow = out + static_cast<size_t>(row) * t;
  float carry = 0.f;
  for (int t0 = 0; t0 < t; t0 += 32) {
    const int i = t0 + lane;
    float v = i < t ? to_f(xr[i]) : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (i < t) orow[i] = from_f<T>(v + carry);
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
}

// x, out: (rows, t) contiguous in T.  Returns the cudaError_t.
extern "C" int cumsum_last_launch(int dtype, const void* x, void* out,
                                  int rows, int t, void* stream) {
  if (rows == 0 || t == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int threads = 256;  // 8 rows per block
  const int blocks = (rows + threads / 32 - 1) / (threads / 32);
  DISPATCH_T(dtype, cumsum_last_kernel<T><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, t));
  return static_cast<int>(cudaGetLastError());
}
