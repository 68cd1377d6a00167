// The RG-LRU linear recurrence over a whole sequence, zero initial state:
//
//   h_t = a_t h_{t-1} + b_t,   h_{-1} = 0
//
// Replaces the TPU kernel src/repro/kernels/rg_lru.py:55 rg_lru_scan,
// which streams (256, 512) (time, channel) tiles through VMEM, takes an
// in-tile associative scan and carries the last state across the
// sequential time axis of its grid in a scratch register.  a, b (B, L, D)
// in T (float or bf16), h (B, L, D) in T; the carry is fp32.
//
// Bound: bytes.  a and b are read once and h written once (31.5 MB at
// (4, 256, 2560) in fp32); two operations per element.
//
// Design.  The channels are independent, so the port keeps the carry in a
// register and drops the in-tile tree: one thread per (batch, channel)
// walks t in order, neighbouring threads on neighbouring channels, so
// every load and store of a time step is coalesced.  The multiply and the
// add are rounded one by one (no fma), in the order of the sequential
// oracle (src/repro/kernels/ref.py:242 rg_lru_scan_ref), so the kernel
// and its plain version give the same bits; the TPU kernel's tree sums in
// another order.  At B = 4, D = 2560 that is 10,240 threads: 80 blocks on
// 132 SMs, each thread a chain of L dependent steps; a chunked two-pass
// carry would fill the card (later work).
#include "common.cuh"

namespace {
constexpr int THREADS = 128;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rg_lru_scan_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ h,
    int L, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  size_t off = static_cast<size_t>(blockIdx.y) * L * D + d;
  float hv = 0.f;
#pragma unroll 8
  for (int t = 0; t < L; ++t, off += D) {
    hv = __fadd_rn(__fmul_rn(to_f(a[off]), hv), to_f(b[off]));
    h[off] = from_f<T>(hv);
  }
}

// a, b, h (B, L, D) contiguous in `dtype` (0 float, 1 bf16).  Returns the
// cudaError_t.
extern "C" int rg_lru_scan_launch(int dtype, const void* a, const void* b,
                                  void* h, int B, int L, int D, void* stream) {
  if (B == 0 || L == 0 || D == 0) return 0;
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  DISPATCH_T(dtype, rg_lru_scan_kernel<T><<<grid, THREADS, 0, s>>>(
                        static_cast<const T*>(a), static_cast<const T*>(b),
                        static_cast<T*>(h), L, D));
  return static_cast<int>(cudaGetLastError());
}
