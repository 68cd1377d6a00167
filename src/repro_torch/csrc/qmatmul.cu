// W8 dequant-matmul: int8 weights widened in the kernel, the per-channel
// scale applied once to the fp32 sums.
//
// Replaces the TPU kernel src/repro/kernels/qmatmul.py:85 qmatmul:
//
//   out = epi((x @ q) * scale) [* ((x @ qv) * vscale)]
//
// x (m, k) in T (float or bf16), q and qv (k, n) int8 row-major, scale and
// vscale (n,) fp32, out (m, n) in T.  epi is ActiBA's PWL table
// (common.cuh: pwl_eval; the same fp32 device table kernel 12 reads) or
// the identity for a null table.  The sums are fp32; the scale multiplies
// them once, as in the TPU kernel's drain, and the epilogue's multiplies
// are rounded one by one (__fmul_rn), as kernels/qmatmul.py:
// qmatmul_plain takes them, so kernel and plain version differ only in
// the order of their sums.  int8 -> fp32 widening is exact.
//
// The bodies live in gemm.cuh, templated on the weight loader: here the
// int8 one (gemm::I8W) with the per-channel scales; matmul_pwl.cu (kernel
// 11) runs them on bf16 / fp32 weights without a scale.  At decode (m <=
// 8) a split-k GEMV that reads the int8 weight once, bound by its bytes
// (k*n; 2.6 MB for mamba2-130m's in_proj; at n = 3352 the 27 column tiles
// alone fill few of the 132 SMs, so k is split over blocks too); at
// prefill (m = slots x chunk) a 64 x 64 tiled product on the CUDA cores,
// bound by operations (2 m k n); int8 -> bf16 widening is exact too (|q|
// <= 127), so a later version can feed bf16 tensor cores (wgmma).
#include "gemm.cuh"

// x (m, k) contiguous in the dtype `dtype` (0 float, 1 bf16); q, qv (k, n)
// contiguous int8 (qv null: the plain form); scale, vscale (n,) fp32;
// out (m, n) in x's dtype; partial: splits * (qv ? 2 : 1) * m * n fp32
// scratch when m <= 8 and splits > 1 (else unused); vec4: n % 4 == 0 and
// q, qv 4-byte aligned; tab: the PWL table (2 nk + 2 fp32) or null.
// Returns the cudaError_t.
extern "C" int qmatmul_launch(int dtype, const void* x, const void* q,
                              const void* scale, const void* qv,
                              const void* vscale, void* out, void* partial,
                              int m, int k, int n, int splits, int vec4,
                              const void* tab, int nk, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (k < 1 || splits < 1 || scale == nullptr || (qv != nullptr) != (vscale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tb = static_cast<const float*>(tab);
  const gemm::I8W w{static_cast<const int8_t*>(q)}, v{static_cast<const int8_t*>(qv)};
  const float* st = static_cast<const float*>(scale);
  const float* vst = static_cast<const float*>(vscale);
  int err = 0;
  DISPATCH_T(dtype, err = qv ? gemm::launch<T, gemm::I8W, true>(
                                   x, w, st, v, vst, out, partial, m, k, n,
                                   splits, vec4, tb, nk, s)
                             : gemm::launch<T, gemm::I8W, false>(
                                   x, w, st, v, vst, out, partial, m, k, n,
                                   splits, vec4, tb, nk, s));
  return err;
}
