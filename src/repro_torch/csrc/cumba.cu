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
// port keeps what the TPU kernel carries and drops the mask.  One warp a
// row, in one pass of 32 S elements (S = 8 at t = 256), or in several
// where the row is longer than 32 x 16: each lane owns a contiguous strip
// of S elements, reads it with 16-byte loads where every strip is aligned
// (else element by element), scans it in registers, and one 5-step
// shuffle scan of the 32 strip totals gives each lane the sum of the
// strips before its own; the lane adds that and the carried prefix of the
// earlier passes (the TPU kernel's scratch accumulator) and writes its
// strip back the way it read it.  Four rows a block (128 threads), so the
// SSD path's 192 rows spread over 48 SMs.
#include <cstdint>

#include "common.cuh"

namespace {
constexpr int ROWS_PER_BLOCK = 4;   // one warp each
constexpr int MAX_STRIP = 16;       // elements a lane takes in one pass

// S elements of T at p (16-byte aligned when vec) into v, fp32.
template <typename T, int S, bool VEC>
__device__ __forceinline__ void load_strip(float (&v)[S], const T* p) {
  if constexpr (VEC) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < S / PER; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < PER; ++i) v[c * PER + i] = to_f(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < S; ++i) v[i] = to_f(p[i]);
  }
}

template <typename T, int S, bool VEC>
__device__ __forceinline__ void store_strip(T* p, const float (&v)[S]) {
  if constexpr (VEC) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < S / PER; ++c) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int i = 0; i < PER; ++i) e[i] = from_f<T>(v[c * PER + i]);
      reinterpret_cast<uint4*>(p)[c] = u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < S; ++i) p[i] = from_f<T>(v[i]);
  }
}
}  // namespace

// Strips of S elements; vec: every strip of a full pass is 16-byte
// aligned (the host checks the bases, t and S; VEC needs S * sizeof(T)
// to be a multiple of 16).  A pass that runs past t goes element by
// element, with the elements past t read as 0 and not written.
template <typename T, int S, bool VEC>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK) cumsum_last_kernel(
    const T* __restrict__ x, T* __restrict__ out, int rows, int t) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform across the warp
  const T* xr = x + static_cast<size_t>(row) * t;
  T* orow = out + static_cast<size_t>(row) * t;
  float carry = 0.f;
  for (int t0 = 0; t0 < t; t0 += 32 * S) {
    const int i0 = t0 + lane * S;
    const bool full = t0 + 32 * S <= t;  // uniform across the warp
    float v[S];
    if (VEC && full) {
      load_strip<T, S, true>(v, xr + i0);
    } else {
#pragma unroll
      for (int i = 0; i < S; ++i) v[i] = i0 + i < t ? to_f(xr[i0 + i]) : 0.f;
    }
#pragma unroll
    for (int i = 1; i < S; ++i) v[i] += v[i - 1];
    float tot = v[S - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, tot, o);
      if (lane >= o) tot += u;
    }
    // tot: the strips up to this lane's; less its own, plus the carry.
    const float off = carry + (tot - v[S - 1]);
#pragma unroll
    for (int i = 0; i < S; ++i) v[i] += off;
    if (VEC && full) {
      store_strip<T, S, true>(orow + i0, v);
    } else {
#pragma unroll
      for (int i = 0; i < S; ++i)
        if (i0 + i < t) orow[i0 + i] = from_f<T>(v[i]);
    }
    carry += __shfl_sync(0xffffffffu, tot, 31);
  }
}

// A call's arguments as 64-bit fields, packed by the wrapper into one
// buffer (kernels/cumba.py: _ARGS) so the call crosses ctypes as one
// pointer.  dtype 0 float, 1 bf16; x, out (rows, t) contiguous; strip:
// elements a lane takes in a pass (1, 2, 4, 8 or 16); vec: 1 when every
// strip of a full pass is 16-byte aligned.
struct CumsumArgs {
  int64_t dtype;
  const void* x;
  void* out;
  int64_t rows, t, strip, vec;
  void* stream;
};

template <typename T, int S>
static void launch_strip(const CumsumArgs* a, cudaStream_t s) {
  const int rows = static_cast<int>(a->rows), t = static_cast<int>(a->t);
  const int blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const T* x = static_cast<const T*>(a->x);
  T* out = static_cast<T*>(a->out);
  constexpr bool CAN_VEC = (S * sizeof(T)) % 16 == 0;
  if (CAN_VEC && a->vec)
    cumsum_last_kernel<T, S, CAN_VEC><<<blocks, 32 * ROWS_PER_BLOCK, 0, s>>>(
        x, out, rows, t);
  else
    cumsum_last_kernel<T, S, false><<<blocks, 32 * ROWS_PER_BLOCK, 0, s>>>(
        x, out, rows, t);
}

// Returns the cudaError_t (cudaErrorInvalidValue for a strip it has no
// body for).
extern "C" int cumsum_last_launch(const CumsumArgs* a) {
  if (a->rows == 0 || a->t == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  switch (a->strip) {
    case 1: DISPATCH_T(a->dtype, (launch_strip<T, 1>(a, s))); break;
    case 2: DISPATCH_T(a->dtype, (launch_strip<T, 2>(a, s))); break;
    case 4: DISPATCH_T(a->dtype, (launch_strip<T, 4>(a, s))); break;
    case 8: DISPATCH_T(a->dtype, (launch_strip<T, 8>(a, s))); break;
    case MAX_STRIP: DISPATCH_T(a->dtype, (launch_strip<T, MAX_STRIP>(a, s))); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
