// The fused RG-LRU decode step (recurrentgemma's recurrent block, one
// token):
//
//   u_c   = conv step of u over the conv tail (no SiLU)
//   r, i  = sigmoid(u_c @ rg_w + rg_b), sigmoid(u_c @ ig_w + ig_b)
//   a     = exp(-8 softplus(lam) r)
//   h'    = a h + sqrt(max(1 - a^2, 1e-12)) (i u_c)
//   y     = h' gelu(gate)            (formed in fp32, cast once)
//
// Replaces the TPU kernel src/repro/kernels/decode_step.py:282 rglru_step.
// u, gate (b, w) and the conv tail (b, wc-1, w) in T (float or bf16), h
// (b, w) fp32; rg_w, ig_w (w, w) in W (float or bf16, widened exactly);
// conv_w (wc, w), conv_b, rg_b, ig_b, lam (w,) fp32.  Out: y (b, w) in T,
// the new conv tail in T, h' fp32.  sigmoid, softplus and gelu (tanh form)
// are exact or ActiBA's PWL tables (common.cuh: pwl_eval).
//
// Bound: bytes.  The two w x w gate weights dominate: 26.2 MB in bf16 at
// w = 2560, against 2 * 2 * b * w^2 operations (105 MFLOP at b = 4).  In
// the model they are cold: the 18 layers' 472 MB pass the 50 MB L2.
//
// Design: one launch of gemm.cuh's cluster GEMV (gemv_cluster_body) in its
// gated form, w = rg_w and v = ig_w, read once for every row of the call,
// its column group and k splits from the shapes alone
// (kernels/decode_step.py: rglru_plan).  Two pieces are kernel 6's own:
// * the x loader (ConvX) stages the conv step u_c itself, computed in fp32
//   from the conv tail and u as the block loads its k slice (4 taps an
//   input), so u_c is never rounded to T and never leaves the chip;
// * the epilogue (RglruEpi): the thread of the owning rank that holds an
//   output's rg and ig sums (met in rank order in distributed shared
//   memory) runs the whole update on it: biases, sigmoids, a, the gated
//   input (u_c of its column computed again from the window), h', y and
//   that column's conv-tail shift, written once, while the other ranks
//   finish their sums.
// No partial sums pass through device memory, and a shape always takes
// the same sums in the same order: the same inputs give the same bits.
// Rows go in groups of GEMV_M = 8, one launch a group.
#include "gemm.cuh"

namespace {
constexpr float RG_C = 8.0f;     // Griffin's fixed gate exponent
constexpr int RG_MAX_CONV = 4;   // the widest conv (its loads unrolled)

__device__ __forceinline__ float sigmoid_act(float x, const float* tab, int nk) {
  return tab ? pwl_eval(x, tab, nk) : 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float gelu_act(float x, const float* tab, int nk) {
  if (tab) return pwl_eval(x, tab, nk);
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

// The GEMV's x: u_c of row r, channel c, the causal conv's step in fp32
// (staged as fp32: V = float).  The pointers start at the row group's
// first row.
template <typename T> struct ConvX {
  using V = float;
  const T* u;
  const T* conv;
  const float* cw;
  const float* cb;
  int w, wc;
  __device__ __forceinline__ float at(int r, int c) const {
    const T* cs = conv + static_cast<size_t>(r) * (wc - 1) * w + c;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j + 1 < RG_MAX_CONV; ++j)   // one round of loads
      if (j < wc - 1) acc += to_f(cs[static_cast<size_t>(j) * w]) * cw[j * w + c];
    acc += to_f(u[static_cast<size_t>(r) * w + c]) * cw[(wc - 1) * w + c];
    return acc + cb[c];
  }
  static __device__ __forceinline__ float widen(float v) { return v; }
};

// The GEMV's epilogue: output (r, c) of the row group from its rg and ig
// sums, the whole RG-LRU update; the pointers start at the group's first
// row.
template <typename T> struct RglruEpi {
  ConvX<T> xl;
  const T* gate;
  const float* h;
  const float* rg_b;
  const float* ig_b;
  const float* lam;
  T* y;
  T* new_conv;
  float* new_h;
  const float* sig_tab;
  const float* sp_tab;
  const float* gelu_tab;
  int sig_nk, sp_nk, gelu_nk;
  __device__ __forceinline__ void operator()(int r, int c, float ra,
                                             float ia) const {
    const int w = xl.w, wc = xl.wc;
    const size_t idx = static_cast<size_t>(r) * w + c;
    const float rr = sigmoid_act(ra + rg_b[c], sig_tab, sig_nk);
    const float ii = sigmoid_act(ia + ig_b[c], sig_tab, sig_nk);
    const float uc = xl.at(r, c);
    const float sp = sp_tab ? pwl_eval(lam[c], sp_tab, sp_nk) : softplus_f(lam[c]);
    const float log_a = (-RG_C * sp) * rr;
    const float a = expf(log_a);
    const float gin = sqrtf(fmaxf(1.0f - expf(2.0f * log_a), 1e-12f)) * (ii * uc);
    const float hn = a * h[idx] + gin;
    new_h[idx] = hn;
    y[idx] = from_f<T>(hn * gelu_act(to_f(gate[idx]), gelu_tab, gelu_nk));
    // The conv tail shifts by one: rows 1.. of the old tail, then u.
    const size_t tail = static_cast<size_t>(r) * (wc - 1) * w + c;
#pragma unroll
    for (int j = 0; j + 2 < RG_MAX_CONV; ++j)
      if (j + 1 < wc - 1)
        new_conv[tail + static_cast<size_t>(j) * w] = xl.conv[tail + static_cast<size_t>(j + 1) * w];
    new_conv[tail + static_cast<size_t>(wc - 2) * w] = xl.u[idx];
  }
};

template <typename T, typename WL>
__global__ void __launch_bounds__(gemm::GW_THREADS, 1) rglru_step_kernel(
    ConvX<T> xl, WL rg, WL ig, RglruEpi<T> ep, int m, int w, int lanes, int ks,
    int vec) {
  gemm::gemv_cluster_body<ConvX<T>, WL, true>(xl, rg, ig, ep, m, w, w, lanes,
                                              ks, vec);
}
}  // namespace

// The launcher's one argument: 64-bit fields in this order
// (kernels/decode_step.py: RG_FIELDS packs them).  u, gate (b, w),
// conv_state (b, wc-1, w) contiguous in `dtype` (0 float, 1 bf16); h (b,
// w), conv_w (wc, w), conv_b, rg_b, ig_b, lam (w,) contiguous fp32; rg_w,
// ig_w (w, w) contiguous in `wdtype` (0 float, 1 bf16); wc 2 to 4; y,
// new_conv in `dtype`, new_h fp32, apart from the inputs; lanes, splits,
// vec: the GEMV's column group, k splits and load bytes
// (gemm::launch_gemv); each table (2 nk + 2 fp32) or null for the exact
// activation.
struct RgArgs {
  int64_t dtype, wdtype;
  const void *u, *gate, *conv_state, *h, *conv_w, *conv_b, *rg_w, *rg_b;
  const void *ig_w, *ig_b, *lam;
  void *y, *new_conv, *new_h;
  int64_t b, w, wc, lanes, splits, vec;
  const void* sig_tab;
  int64_t sig_nk;
  const void* sp_tab;
  int64_t sp_nk;
  const void* gelu_tab;
  int64_t gelu_nk;
  void* stream;
};

namespace {
template <typename T, typename WL>
int run(const RgArgs* a, WL rg, WL ig) {
  const int b = static_cast<int>(a->b), w = static_cast<int>(a->w),
            wc = static_cast<int>(a->wc), lanes = static_cast<int>(a->lanes),
            splits = static_cast<int>(a->splits), vec = static_cast<int>(a->vec);
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  const auto kern = rglru_step_kernel<T, WL>;
  for (int r0 = 0; r0 < b; r0 += gemm::GEMV_M) {
    const int m = b - r0 < gemm::GEMV_M ? b - r0 : gemm::GEMV_M;
    const size_t row = static_cast<size_t>(r0) * w;
    const size_t crow = row * (wc - 1);
    const ConvX<T> xl{static_cast<const T*>(a->u) + row,
                      static_cast<const T*>(a->conv_state) + crow,
                      static_cast<const float*>(a->conv_w),
                      static_cast<const float*>(a->conv_b), w, wc};
    const RglruEpi<T> ep{xl,
                         static_cast<const T*>(a->gate) + row,
                         static_cast<const float*>(a->h) + row,
                         static_cast<const float*>(a->rg_b),
                         static_cast<const float*>(a->ig_b),
                         static_cast<const float*>(a->lam),
                         static_cast<T*>(a->y) + row,
                         static_cast<T*>(a->new_conv) + crow,
                         static_cast<float*>(a->new_h) + row,
                         static_cast<const float*>(a->sig_tab),
                         static_cast<const float*>(a->sp_tab),
                         static_cast<const float*>(a->gelu_tab),
                         static_cast<int>(a->sig_nk), static_cast<int>(a->sp_nk),
                         static_cast<int>(a->gelu_nk)};
    const int err = gemm::launch_gemv<WL, true>(
        kern, rg, ig, w, w, lanes, splits, vec, s, xl, rg, ig, ep, m, w, lanes,
        gemm::gemv_ks(w, splits), vec);
    if (err) return err;
  }
  return 0;
}
}  // namespace

// One launch of rglru_step_kernel a group of 8 rows.  Returns the
// cudaError_t.
extern "C" int rglru_step_launch(const RgArgs* a) {
  if (a->b == 0 || a->w == 0) return 0;
  if (a->wc < 2 || a->wc > RG_MAX_CONV) return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  if (a->wdtype == 0) {
    const gemm::F32W rg{static_cast<const float*>(a->rg_w)},
        ig{static_cast<const float*>(a->ig_w)};
    DISPATCH_T(a->dtype, err = run<T, gemm::F32W>(a, rg, ig));
  } else {
    const gemm::BF16W rg{static_cast<const __nv_bfloat16*>(a->rg_w)},
        ig{static_cast<const __nv_bfloat16*>(a->ig_w)};
    DISPATCH_T(a->dtype, err = run<T, gemm::BF16W>(a, rg, ig));
  }
  return err;
}
