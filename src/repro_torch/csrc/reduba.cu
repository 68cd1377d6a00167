// ReduBA's reduction: the sum over axis 0 of an (m, n) array,
//
//   out[j] = sum_i x[i, j],
//
// Replaces the TPU kernel src/repro/kernels/reduba.py:35 reduce_rows,
// which runs the sum as a (1, m) ones-vector product on the MXU over
// 512 x 512 tiles, accumulating into an fp32 output block that stays in
// VMEM across the sequential row axis of its grid.  x (m, n) contiguous
// in T (float or bf16), out (n,) in T; the sums are fp32.
//
// Bound: bytes.  x is read once (16.8 MB at (2048, 2048) in fp32), one
// addition per element.
//
// Design.  A ones-vector product has nothing for a tensor core to do on
// this card: the sum is a column-wise walk down the rows.  Each block owns
// a strip of NT columns, each thread one column, neighbouring threads on
// neighbouring addresses, so every row's loads are coalesced.  A tall x
// is cut into `splits` row ranges of `rows` rows (the wrapper picks them
// from the shape alone, so that some 500 blocks fill the card); each
// block sums its range in row order into an fp32 partial, and a second
// pass sums the partials in split order and casts.  Fixed orders and no
// atomics: the same bits every call.  Ragged m and n are masked here.
#include "common.cuh"

namespace {
constexpr int NT = 128;
}

template <typename T>
__global__ void __launch_bounds__(NT) reduce_rows_kernel(
    const T* __restrict__ x, float* __restrict__ partial, T* __restrict__ out,
    int m, int n, int rows, int splits) {
  const int j = blockIdx.x * NT + threadIdx.x;
  if (j >= n) return;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(m, r0 + rows);
  const T* p = x + static_cast<size_t>(r0) * n + j;
  float acc = 0.f;
#pragma unroll 8
  for (int r = r0; r < r1; ++r, p += n) acc += to_f(*p);
  if (splits == 1)
    out[j] = from_f<T>(acc);
  else
    partial[static_cast<size_t>(blockIdx.y) * n + j] = acc;
}

template <typename T>
__global__ void __launch_bounds__(NT) reduce_partials_kernel(
    const float* __restrict__ partial, T* __restrict__ out, int n,
    int splits) {
  const int j = blockIdx.x * NT + threadIdx.x;
  if (j >= n) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s)
    acc += partial[static_cast<size_t>(s) * n + j];
  out[j] = from_f<T>(acc);
}

// x (m, n) contiguous in `dtype` (0 float, 1 bf16); out (n,) in dtype;
// partial (splits, n) fp32 scratch, unused when splits == 1.  Split s sums
// rows [s * rows, min(m, (s + 1) * rows)).  Returns the cudaError_t.
extern "C" int reduce_rows_launch(int dtype, const void* x, void* partial,
                                  void* out, int m, int n, int rows,
                                  int splits, void* stream) {
  if (n == 0) return 0;
  if (m <= 0 || rows <= 0 || splits <= 0 || splits > 65535 ||
      static_cast<long long>(rows) * splits < m)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int strips = (n + NT - 1) / NT;
  cudaError_t err = cudaSuccess;
  DISPATCH_T(dtype, {
    reduce_rows_kernel<T><<<dim3(strips, splits), NT, 0, s>>>(
        static_cast<const T*>(x), static_cast<float*>(partial),
        static_cast<T*>(out), m, n, rows, splits);
    err = cudaGetLastError();
    if (err == cudaSuccess && splits > 1) {
      reduce_partials_kernel<T><<<strips, NT, 0, s>>>(
          static_cast<const float*>(partial), static_cast<T*>(out), n,
          splits);
      err = cudaGetLastError();
    }
  });
  return static_cast<int>(err);
}
