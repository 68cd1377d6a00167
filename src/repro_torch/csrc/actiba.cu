// ActiBA: the elementwise piecewise-linear activation over any shape.
//
// Replaces the TPU kernel src/repro/kernels/actiba.py:52 pwl_activate:
// out = m0*x + c0 + sum_k dm_k * max(x - b_k, 0) per element, fp32 inside,
// the output in the input's dtype T.  The sum is taken in core/pwl.py:
// eval_pwl's order with every operation rounded on its own (no
// contraction into fma), so fp32 outputs equal the plain version's bit for
// bit.
//
// Bound.  Each element is read once and written once: at the pallas()
// forward's fp32 (4, 300, 1792) operand, 17.2 MB, 0.0051 ms at 3.35 TB/s.
// But the kept order costs 2 + 4 (K - 1) fp32 instructions an element (m0*x
// + c0, then a subtraction, a max, a product and a sum a breakpoint), and
// each takes a whole issue slot: at K = 32, 126 an element, 2.15 M
// elements over 132 SMs x 4 schedulers x 32 lanes at ~1.98 GHz, ~0.0080
// ms.  That instruction floor, not the bytes, bounds the kernel (in bf16,
// half the bytes, all the more).
//
// Design, against that floor:
// * The table is the kernel's parameter, by value (PwlParams, a
//   __grid_constant__ struct of at most 1 KB): each term's b_k and dm_k are
//   constant-bank operands of its FADD and FMUL, with no load instruction
//   and no shared-memory copy.
// * The term count NK is a template parameter and the term loop is fully
//   unrolled, instantiated for the counts of PwlNks (K = 8, 16, 32, 64 and
//   128 segments).  A table of another size is padded to the next NK with
//   terms b = +inf, dm = 0, which add an exact zero: for finite x, x - inf
//   = -inf and max(-inf, 0) = +0; for x = +inf, inf - inf is NaN, which
//   fmaxf drops (it returns the other operand, 0); so the term is dm * +0 =
//   +0, and y + +0 is y, bit for bit, except y = -0, which becomes +0 and
//   compares equal (for x = NaN, y is NaN already).  Checked on the CPU by
//   tests/test_torch_pwl_unrolled.py.
// * Bytes: 16-byte loads and stores (4 fp32 or 8 bf16 a vector), the
//   ragged tail by scalars.  The grid is a vector a thread up to one wave
//   (the blocks an SM holds at this build's registers, times the SMs);
//   past a wave, as at the pallas() forward's xBC and gate operands, a
//   thread loads two vectors before it computes either.  A small operand
//   (dt's, 29 K elements) is latency-bound and gets as many blocks as it
//   has vectors for.  A base that is not 16-byte aligned takes the scalar
//   body of the same kernel (vec = 0; the wrapper counts bodies).
// * The unrolled arithmetic takes four elements at a time (four
//   independent chains) in a loop that is not unrolled, so the body stays
//   4 x 4 (K - 1) instructions whatever the dtype (~8 KB of code at K = 32).
//
// The fused kernels' ActiBA epilogues (common.cuh: pwl_eval, a run-time nk
// over a device table) are not this kernel and keep their form.
#include <cstdint>
#include <limits>

#include "common.cuh"

// The launcher's one argument: 64-bit fields in this order
// (kernels/actiba.py: PWL_FIELDS packs them).  x, out: n contiguous
// elements of T; vec: both 16-byte aligned; tab: a host pointer to the fp32
// table [b_0..b_{nk-1}, dm_0..dm_{nk-1}, m0, c0] (core/pwl.py:
// PWLTable.packed_f32), nk = K - 1 for K segments.
struct PwlLaunch {
  int64_t dtype;
  const void* x;
  void* out;
  int64_t n;
  int64_t vec;
  const void* tab;
  int64_t nk;
  void* stream;
};

namespace {
template <int... NKs>
struct NkList {};
// The instantiated term counts (K - 1 for K = 8, 16, 32, 64, 128).
using PwlNks = NkList<7, 15, 31, 63, 127>;
constexpr int MAX_NK = 127;
constexpr int THREADS = 256;
constexpr int UNROLL = 2;  // 16-byte vectors a thread holds in flight

// The kernel's one parameter, by value: the table in the constant bank.
template <int NK>
struct PwlParams {
  const void* x;
  void* out;
  int64_t n;
  int64_t vec;
  float b[NK];
  float dm[NK];
  float m0;
  float c0;
};
static_assert(sizeof(PwlParams<MAX_NK>) <= 4096, "kernel parameter limit");

template <int NK>
__device__ __forceinline__ float pwl1(float x, const PwlParams<NK>& p) {
  float y = __fadd_rn(__fmul_rn(p.m0, x), p.c0);
#pragma unroll
  for (int k = 0; k < NK; ++k)
    y = __fadd_rn(y, __fmul_rn(p.dm[k], fmaxf(__fsub_rn(x, p.b[k]), 0.f)));
  return y;
}

template <int NK>
__device__ __forceinline__ float4 pwl4(float4 v, const PwlParams<NK>& p) {
  return make_float4(pwl1(v.x, p), pwl1(v.y, p), pwl1(v.z, p), pwl1(v.w, p));
}

// One 16-byte vector of T through the table.
template <int NK>
__device__ __forceinline__ uint4 pwl_vec(uint4 v, const PwlParams<NK>& p,
                                         float) {
  const float4 f = pwl4(make_float4(__uint_as_float(v.x),
                                    __uint_as_float(v.y),
                                    __uint_as_float(v.z),
                                    __uint_as_float(v.w)), p);
  return make_uint4(__float_as_uint(f.x), __float_as_uint(f.y),
                    __float_as_uint(f.z), __float_as_uint(f.w));
}

// Two bf16 in a 32-bit word (the lower address in the low half) as fp32,
// exactly (a bf16 is the high half of its fp32), and back, rounded to
// nearest even as from_f does.
__device__ __forceinline__ float2 bf2_to_f2(unsigned w) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ unsigned f2_to_bf2(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(a))) |
         static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(b)))
             << 16;
}

// Eight bf16: two chunks of four, in a loop that is not unrolled.
template <int NK>
__device__ __forceinline__ uint4 pwl_vec(uint4 v, const PwlParams<NK>& p,
                                         __nv_bfloat16) {
  uint2 in = make_uint2(v.x, v.y), next = make_uint2(v.z, v.w);
  uint2 lo = make_uint2(0u, 0u), hi = make_uint2(0u, 0u);
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    const float2 a = bf2_to_f2(in.x), b = bf2_to_f2(in.y);
    const float4 f = pwl4(make_float4(a.x, a.y, b.x, b.y), p);
    lo = hi;
    hi = make_uint2(f2_to_bf2(f.x, f.y), f2_to_bf2(f.z, f.w));
    in = next;
  }
  return make_uint4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T, int NK>
__global__ void __launch_bounds__(THREADS)
    pwl_activate_kernel(const __grid_constant__ PwlParams<NK> p) {
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const int64_t n = p.n;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * THREADS;
  int64_t tail = 0;  // elements [0, tail) go by vectors
  if (p.vec) {
    constexpr int V = 16 / sizeof(T);
    const int64_t nv = n / V;
    const uint4* xv = static_cast<const uint4*>(p.x);
    uint4* ov = static_cast<uint4*>(p.out);
    for (int64_t base = tid; base < nv; base += UNROLL * nthreads) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t i = base + u * nthreads;
        v[u] = i < nv ? __ldg(xv + i) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll 1
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t i = base + u * nthreads;
        if (i < nv) ov[i] = pwl_vec(v[0], p, T());
#pragma unroll
        for (int j = 0; j + 1 < UNROLL; ++j) v[j] = v[j + 1];
      }
    }
    tail = nv * V;
  }
  for (int64_t i = tail + tid; i < n; i += nthreads)
    out[i] = from_f<T>(pwl1(to_f(x[i]), p));
}

template <typename T, int NK>
int launch(const PwlLaunch& a) {
  static int wave = 0;  // blocks of one wave on this card
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pwl_activate_kernel<T, NK>, THREADS, 0);
    wave = sms * (per_sm > 0 ? per_sm : 1);
  }
  PwlParams<NK> p;
  p.x = a.x;
  p.out = a.out;
  p.n = a.n;
  p.vec = a.vec;
  const float* tab = static_cast<const float*>(a.tab);
  const int nk = static_cast<int>(a.nk);
  for (int k = 0; k < NK; ++k) {
    p.b[k] = k < nk ? tab[k] : std::numeric_limits<float>::infinity();
    p.dm[k] = k < nk ? tab[nk + k] : 0.f;
  }
  p.m0 = tab[2 * nk];
  p.c0 = tab[2 * nk + 1];
  // The grid: a vector (or an element) a thread, at most one wave; an
  // operand past one wave takes UNROLL vectors a thread a pass.
  const int64_t per_block =
      static_cast<int64_t>(THREADS) *
      (a.vec ? static_cast<int>(16 / sizeof(T)) : 1);
  const int64_t want = (a.n + per_block - 1) / per_block;
  const int blocks = static_cast<int>(want < wave ? want : wave);
  pwl_activate_kernel<T, NK>
      <<<blocks, THREADS, 0, static_cast<cudaStream_t>(a.stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The smallest instantiated NK that holds nk terms.
template <typename T, int NK, int... Rest>
int dispatch_nk(const PwlLaunch& a, NkList<NK, Rest...>) {
  if (a.nk <= NK) return launch<T, NK>(a);
  if constexpr (sizeof...(Rest) > 0)
    return dispatch_nk<T>(a, NkList<Rest...>{});
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace

// Returns the cudaError_t (cudaErrorInvalidValue for a table of more than
// 128 segments).
extern "C" int pwl_activate_launch(const PwlLaunch* a) {
  if (a->n == 0) return 0;
  if (a->nk < 1 || a->nk > MAX_NK)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  DISPATCH_T(a->dtype, err = dispatch_nk<T>(*a, PwlNks{}));
  return err;
}
