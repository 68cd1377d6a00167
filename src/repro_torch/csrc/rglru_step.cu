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
// w = 2560, against 2 * 2 * b * w^2 operations (105 MFLOP at b = 4).
//
// Design.  The TPU kernel runs one program per row, and each re-reads
// both weights; here the rows share them.  Launch 1 is the split-k GEMV
// of gemm.cuh (as qmatmul's decode path) over the two weights at once, its
// x the conv step computed while the block loads its k slice (4 taps per
// input, cheaper than a launch of its own): grid (w / 128 column tiles, k
// splits), fp32 partial sums per split.  Launch 2 takes one thread per
// (row, channel): it sums the splits' partials in split order (no
// atomics: the same inputs give the same bits), recomputes its u_c, and
// applies the gates, the recurrence, the output gate and the conv shift.
// Rows go in groups of 8 (the GEMV's row count).
#include "gemm.cuh"

namespace {
constexpr float RG_C = 8.0f;     // Griffin's fixed gate exponent
constexpr int UPD_THREADS = 256;

__device__ __forceinline__ float sigmoid_act(float x, const float* tab, int nk) {
  return tab ? pwl_eval(x, tab, nk) : 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float gelu_act(float x, const float* tab, int nk) {
  if (tab) return pwl_eval(x, tab, nk);
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

// u_c of row r, channel c: the causal conv's step, fp32.  The pointers
// start at the row group's first row.
template <typename T> struct ConvX {
  const T* u;
  const T* conv;
  const float* cw;
  const float* cb;
  int w, wc;
  __device__ __forceinline__ float operator()(int r, int c) const {
    const T* cs = conv + static_cast<size_t>(r) * (wc - 1) * w + c;
    float acc = 0.f;
    for (int j = 0; j < wc - 1; ++j) acc += to_f(cs[static_cast<size_t>(j) * w]) * cw[j * w + c];
    acc += to_f(u[static_cast<size_t>(r) * w + c]) * cw[(wc - 1) * w + c];
    return acc + cb[c];
  }
};
}  // namespace

// Grid (ceil(w / 128), splits); dynamic shared memory GV_SMEM floats.
// partial[(s * 2 + g) * m * w + r * w + c]: split s's sum for rg (g = 0)
// and ig (g = 1).
template <typename T, typename WL>
__global__ void __launch_bounds__(gemm::GV_THREADS) rglru_gates_kernel(
    ConvX<T> xl, WL rg, WL ig, float* __restrict__ partial, int m, int w,
    int ks, bool vec4) {
  extern __shared__ float sm[];
  const int split = blockIdx.y;
  const int k0 = split * ks;
  const int kn = min(ks, w - k0);
  float tot[gemm::GV_OWN], gtot[gemm::GV_OWN];
  gemm::gemv_sums<ConvX<T>, WL, true>(xl, rg, ig, m, w, k0, kn, vec4, sm, tot,
                                      gtot);
  const size_t mw = static_cast<size_t>(m) * w;
#pragma unroll
  for (int i = 0; i < gemm::GV_OWN; ++i) {
    const int o = threadIdx.x + i * gemm::GV_THREADS;
    const int r = o / gemm::GV_COLS, c = blockIdx.x * gemm::GV_COLS + o % gemm::GV_COLS;
    if (r >= m || c >= w) continue;
    const size_t idx = static_cast<size_t>(r) * w + c;
    partial[static_cast<size_t>(split) * 2 * mw + idx] = tot[i];
    partial[(static_cast<size_t>(split) * 2 + 1) * mw + idx] = gtot[i];
  }
}

// One thread per (row, channel) of the row group.
template <typename T>
__global__ void __launch_bounds__(UPD_THREADS) rglru_update_kernel(
    ConvX<T> xl, const T* __restrict__ gate, const float* __restrict__ h,
    const float* __restrict__ rg_b, const float* __restrict__ ig_b,
    const float* __restrict__ lam, const float* __restrict__ partial,
    int splits, T* __restrict__ y, T* __restrict__ new_conv,
    float* __restrict__ new_h, int m, const float* __restrict__ sig_tab,
    int sig_nk, const float* __restrict__ sp_tab, int sp_nk,
    const float* __restrict__ gelu_tab, int gelu_nk) {
  const int w = xl.w, wc = xl.wc;
  const size_t mw = static_cast<size_t>(m) * w;
  const size_t idx = static_cast<size_t>(blockIdx.x) * UPD_THREADS + threadIdx.x;
  if (idx >= mw) return;
  const int r = static_cast<int>(idx / w), c = static_cast<int>(idx % w);
  float ra = 0.f, ia = 0.f;
  for (int s = 0; s < splits; ++s) {
    ra += partial[static_cast<size_t>(s) * 2 * mw + idx];
    ia += partial[(static_cast<size_t>(s) * 2 + 1) * mw + idx];
  }
  const float rr = sigmoid_act(ra + rg_b[c], sig_tab, sig_nk);
  const float ii = sigmoid_act(ia + ig_b[c], sig_tab, sig_nk);
  const float uc = xl(r, c);
  const float sp = sp_tab ? pwl_eval(lam[c], sp_tab, sp_nk) : softplus_f(lam[c]);
  const float log_a = (-RG_C * sp) * rr;
  const float a = expf(log_a);
  const float gin = sqrtf(fmaxf(1.0f - expf(2.0f * log_a), 1e-12f)) * (ii * uc);
  const float hn = a * h[idx] + gin;
  new_h[idx] = hn;
  y[idx] = from_f<T>(hn * gelu_act(to_f(gate[idx]), gelu_tab, gelu_nk));
  // The conv tail shifts by one: rows 1.. of the old tail, then u.
  const size_t tail = static_cast<size_t>(r) * (wc - 1) * w + c;
  for (int j = 0; j + 1 < wc - 1; ++j)
    new_conv[tail + static_cast<size_t>(j) * w] = xl.conv[tail + static_cast<size_t>(j + 1) * w];
  new_conv[tail + static_cast<size_t>(wc - 2) * w] = xl.u[static_cast<size_t>(r) * w + c];
}

template <typename T, typename WL>
static int run(const void* u, const void* gate, const void* conv_state,
               const float* h, const float* cw, const float* cb, WL rg,
               const float* rg_b, WL ig, const float* ig_b, const float* lam,
               float* partial, void* y, void* new_conv, float* new_h, int b,
               int w, int wc, int splits, int vec4, const float* sig_tab,
               int sig_nk, const float* sp_tab, int sp_nk,
               const float* gelu_tab, int gelu_nk, cudaStream_t s) {
  const int ks = (w + splits - 1) / splits;
  if (ks > gemm::GV_MAX_KS) return static_cast<int>(cudaErrorInvalidValue);
  for (int r0 = 0; r0 < b; r0 += gemm::GEMV_M) {
    const int m = b - r0 < gemm::GEMV_M ? b - r0 : gemm::GEMV_M;
    const size_t row = static_cast<size_t>(r0) * w;
    const size_t crow = row * (wc - 1);
    const ConvX<T> xl{static_cast<const T*>(u) + row,
                      static_cast<const T*>(conv_state) + crow, cw, cb, w, wc};
    const dim3 grid((w + gemm::GV_COLS - 1) / gemm::GV_COLS, splits);
    rglru_gates_kernel<T, WL><<<grid, gemm::GV_THREADS,
                                gemm::GV_SMEM * sizeof(float), s>>>(
        xl, rg, ig, partial, m, w, ks, vec4 != 0);
    int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    const size_t mw = static_cast<size_t>(m) * w;
    rglru_update_kernel<T><<<static_cast<unsigned>((mw + UPD_THREADS - 1) / UPD_THREADS),
                             UPD_THREADS, 0, s>>>(
        xl, static_cast<const T*>(gate) + row, h + row, rg_b, ig_b, lam,
        partial, splits, static_cast<T*>(y) + row,
        static_cast<T*>(new_conv) + crow, new_h + row, m, sig_tab, sig_nk,
        sp_tab, sp_nk, gelu_tab, gelu_nk);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  return 0;
}

// u, gate (b, w), conv_state (b, wc-1, w) contiguous in `dtype` (0 float,
// 1 bf16); h (b, w), conv_w (wc, w), conv_b, rg_b, ig_b, lam (w,)
// contiguous fp32; rg_w, ig_w (w, w) contiguous in `wdtype` (0 float, 1
// bf16); partial: splits * 2 * min(b, 8) * w fp32 scratch; y, new_conv in
// `dtype`, new_h fp32, apart from the inputs; vec4: w % 4 == 0 and the
// weights aligned to four elements; each table (2 nk + 2 fp32) or null for
// the exact activation.  Returns the cudaError_t.
extern "C" int rglru_step_launch(
    int dtype, int wdtype, const void* u, const void* gate,
    const void* conv_state, const void* h, const void* conv_w,
    const void* conv_b, const void* rg_w, const void* rg_b, const void* ig_w,
    const void* ig_b, const void* lam, void* partial, void* y, void* new_conv,
    void* new_h, int b, int w, int wc, int splits, int vec4,
    const void* sig_tab, int sig_nk, const void* sp_tab, int sp_nk,
    const void* gelu_tab, int gelu_nk, void* stream) {
  if (b == 0 || w == 0) return 0;
  if (wc < 2 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h);
  const float* cwf = static_cast<const float*>(conv_w);
  const float* cbf = static_cast<const float*>(conv_b);
  const float* rbf = static_cast<const float*>(rg_b);
  const float* ibf = static_cast<const float*>(ig_b);
  const float* lf = static_cast<const float*>(lam);
  float* pf = static_cast<float*>(partial);
  float* nhf = static_cast<float*>(new_h);
  const float* st = static_cast<const float*>(sig_tab);
  const float* pt = static_cast<const float*>(sp_tab);
  const float* gt = static_cast<const float*>(gelu_tab);
  int err = 0;
  if (wdtype == 0) {
    const gemm::F32W rg{static_cast<const float*>(rg_w)}, ig{static_cast<const float*>(ig_w)};
    DISPATCH_T(dtype, err = run<T, gemm::F32W>(
                          u, gate, conv_state, hf, cwf, cbf, rg, rbf, ig, ibf,
                          lf, pf, y, new_conv, nhf, b, w, wc, splits, vec4, st,
                          sig_nk, pt, sp_nk, gt, gelu_nk, s));
  } else {
    const gemm::BF16W rg{static_cast<const __nv_bfloat16*>(rg_w)},
        ig{static_cast<const __nv_bfloat16*>(ig_w)};
    DISPATCH_T(dtype, err = run<T, gemm::BF16W>(
                          u, gate, conv_state, hf, cwf, cbf, rg, rbf, ig, ibf,
                          lf, pf, y, new_conv, nhf, b, w, wc, splits, vec4, st,
                          sig_nk, pt, sp_nk, gt, gelu_nk, s));
  }
  return err;
}
