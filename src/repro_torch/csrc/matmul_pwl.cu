// ActiBA's drain-fused matrix product: the PWL activation applied to the
// fp32 sums before the output tile is written.
//
// Replaces the TPU kernel src/repro/kernels/matmul_pwl.py:69 matmul_pwl:
//
//   out = pwl(x @ w) [* (x @ v)]
//
// x (m, k) in T (float or bf16), w and v (k, n) row-major in the weight
// dtype W (float or bf16, widened exactly), out (m, n) in T; pwl is the
// table (common.cuh: pwl_eval), the gated form keeps two fp32 sums.  On
// recurrentgemma-2b's GeGLU MLP (k = 2560, n = 7680) it runs on every
// prefill, chunk and decode call under XambaConfig.pallas().
//
// The bodies are qmatmul.cu's (gemm.cuh), on a bf16 / fp32 weight loader
// and with no scale: at decode (m = slots <= 8) the split-k GEMV, bound by
// the weights' bytes (78.6 MB of bf16 wg + wi per call at m = 4); at
// prefill (m = slots x chunk) the 64 x 64 tiled product on the CUDA cores,
// bound by operations (2 m k n per weight).  The TPU kernel's (256, 256,
// 512) blocks carried sums across the sequential k axis of its grid; here
// each GEMV block sums its k slice and a fixed-order drain adds the
// slices, and each tiled block walks all of k itself.
#include "gemm.cuh"

// x (m, k) contiguous in `dtype` (0 float, 1 bf16); w, v (k, n) contiguous
// in `wdtype` (0 float, 1 bf16; v null: the plain form); out (m, n) in x's
// dtype; partial: splits * (v ? 2 : 1) * m * n fp32 scratch when m <= 8
// and splits > 1 (else unused); vec4: n % 4 == 0 and w, v aligned to four
// elements; tab: the PWL table (2 nk + 2 fp32), not null.  Returns the
// cudaError_t.
extern "C" int matmul_pwl_launch(int dtype, int wdtype, const void* x,
                                 const void* w, const void* v, void* out,
                                 void* partial, int m, int k, int n, int splits,
                                 int vec4, const void* tab, int nk,
                                 void* stream) {
  if (m == 0 || n == 0) return 0;
  if (k < 1 || splits < 1 || tab == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tb = static_cast<const float*>(tab);
  int err = 0;
  if (wdtype == 0) {
    const gemm::F32W wl{static_cast<const float*>(w)}, vl{static_cast<const float*>(v)};
    DISPATCH_T(dtype, err = v ? gemm::launch<T, gemm::F32W, true>(
                                    x, wl, nullptr, vl, nullptr, out, partial, m,
                                    k, n, splits, vec4, tb, nk, s)
                              : gemm::launch<T, gemm::F32W, false>(
                                    x, wl, nullptr, vl, nullptr, out, partial, m,
                                    k, n, splits, vec4, tb, nk, s));
  } else {
    const gemm::BF16W wl{static_cast<const __nv_bfloat16*>(w)},
        vl{static_cast<const __nv_bfloat16*>(v)};
    DISPATCH_T(dtype, err = v ? gemm::launch<T, gemm::BF16W, true>(
                                    x, wl, nullptr, vl, nullptr, out, partial, m,
                                    k, n, splits, vec4, tb, nk, s)
                              : gemm::launch<T, gemm::BF16W, false>(
                                    x, wl, nullptr, vl, nullptr, out, partial, m,
                                    k, n, splits, vec4, tb, nk, s));
  }
  return err;
}
