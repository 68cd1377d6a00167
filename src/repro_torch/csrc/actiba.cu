// ActiBA: the elementwise piecewise-linear activation over any shape.
//
// Replaces the TPU kernel src/repro/kernels/actiba.py:52 pwl_activate:
// out = m0*x + c0 + sum_k dm_k * max(x - b_k, 0) per element (pwl_eval in
// common.cuh), fp32 inside, the output in the input's dtype T.
//
// Bound: each element is read once and written once, and the table's
// K - 1 terms cost 4 operations each (126 at K = 32).  At 67 TFLOP/s of
// fp32 those take as long as ~6.3 bytes at 3.35 TB/s, so an fp32 element
// (8 bytes in and out) is just bound by bytes and a bf16 one (4 bytes) by
// operations.
//
// Design.  The TPU kernel bakes the table into its body as compile-time
// scalars.  Here the table is a small fp32 device tensor built once per
// (table, device) by the wrapper; each block copies it into shared memory
// (all threads then read the same word, a broadcast) and walks the flat
// array with a grid-stride loop.
#include "common.cuh"

namespace {
constexpr int MAX_NK = 127;  // K - 1 breakpoints at most (K <= 128)
}  // namespace

template <typename T>
__global__ void pwl_activate_kernel(const T* __restrict__ x,
                                    T* __restrict__ out, long long n,
                                    const float* __restrict__ tab, int nk) {
  __shared__ float ts[2 * MAX_NK + 2];
  for (int i = threadIdx.x; i < 2 * nk + 2; i += blockDim.x) ts[i] = tab[i];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    out[i] = from_f<T>(pwl_eval(to_f(x[i]), ts, nk));
}

// x, out: n contiguous elements of T; tab: 2*nk + 2 fp32 values.  Returns
// the cudaError_t.
extern "C" int pwl_activate_launch(int dtype, const void* x, void* out,
                                   long long n, const void* tab, int nk,
                                   void* stream) {
  if (n == 0) return 0;
  if (nk < 1 || nk > MAX_NK) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  DISPATCH_T(dtype, pwl_activate_kernel<T><<<blocks, 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n,
      static_cast<const float*>(tab), nk));
  return static_cast<int>(cudaGetLastError());
}
