// Fused Mamba-1 single-token step and the bare selective-scan update.
//
// mamba1_step replaces the TPU kernel src/repro/kernels/decode_step.py:221
// mamba1_step: conv-tail shift + bias, SiLU, xs @ x_proj -> (dt_low, B, C),
// softplus(dt_low @ dt_proj + b), the selective-scan update
//   s' = s * exp(dt A) + (dt u) B,   y = s' . C + D u,
// and the SiLU(z) gate.  sscan_step replaces decode_step.py:113
// sscan_step, the update alone.
//
// Bound: bytes.  Per call the fp32 state (b x 1536 x 16 at mamba-130m's
// width, 98 KB a row) is read and written once and the fp32 x_proj
// (1536 x 80), dt_proj (48 x 1536) and A (1536 x 16) are read once:
// ~1.8 MB at b = 4; the arithmetic is ~0.6 MFLOP a row.
//
// Design.  B, C and dt_low need xs @ x_proj over all of d_inner, and every
// channel's dt needs all of dt_low, so one row cannot be cut into
// independent channel blocks.  The TPU kernel runs one program per row;
// on the card that would fill b of 132 SMs.  Here it is two launches:
//   1. grid (d_inner / 64, b): conv + SiLU of 64 channels (written to an
//      fp32 scratch row and, shifted, to the new conv tail), and the 64
//      channels' partial sums of xs @ x_proj (80 values);
//   2. grid (d_inner / 128, b): every block sums the row's partials in
//      block order (a fixed order, so the same inputs give the same bits;
//      no atomics), then one thread per channel takes dt_proj's column,
//      softplus, the 16 state elements, the D skip and the gate.
// Both products are fp32 on the CUDA cores.  Under ActiBA the SiLUs and
// the softplus are PWL tables (silu_tab, sp_tab; null for the exact
// functions), as the TPU kernel's silu and softplus callables are.
#include "common.cuh"

namespace {
constexpr int CONV_CH = 64;    // channels per block of launch 1
constexpr int CONV_NT = 128;   // threads per block of launch 1
constexpr int SCAN_NT = 128;   // channels (threads) per block of launch 2

// One channel's state row: s'[k] = s[k] exp(dt A[k]) + (dt u) B[k], written
// to ns; returns s' . C.  A, B, C are the channel's A row and the token's
// B and C, all fp32.
__device__ __forceinline__ float scan_channel(const float* __restrict__ s,
                                              float* __restrict__ ns,
                                              const float* __restrict__ A,
                                              const float* B, const float* C,
                                              float dt, float dtu, int n) {
  float y = 0.f;
  for (int k = 0; k < n; ++k) {
    const float v = s[k] * expf(dt * A[k]) + dtu * B[k];
    ns[k] = v;
    y += v * C[k];
  }
  return y;
}
}  // namespace

template <typename T>
__global__ void mamba1_conv_xproj_kernel(
    const T* __restrict__ xs_raw, int x_rs, const T* __restrict__ conv_state,
    const float* __restrict__ conv_w, const float* __restrict__ conv_b,
    const float* __restrict__ xproj_w, float* __restrict__ xs_out,
    float* __restrict__ partial, T* __restrict__ new_conv, int di, int rn,
    int width, const float* silu_tab, int silu_nk) {
  __shared__ float xs[CONV_CH];
  const int blk = blockIdx.x, bi = blockIdx.y, nblk = gridDim.x;
  const int c0 = blk * CONV_CH, cnt = min(CONV_CH, di - c0);
  const int wm1 = width - 1;
  const T* xrow = xs_raw + static_cast<size_t>(bi) * x_rs;
  const T* crow = conv_state + static_cast<size_t>(bi) * wm1 * di;
  T* ncrow = new_conv + static_cast<size_t>(bi) * wm1 * di;
  const int t = threadIdx.x;
  if (t < cnt) {
    const int ch = c0 + t;
    auto win = [&](int j) -> float {
      return j < wm1 ? to_f(crow[j * di + ch]) : to_f(xrow[ch]);
    };
    float acc = 0.f;
    for (int j = 0; j < width; ++j)
      acc = __fadd_rn(acc, __fmul_rn(win(j), conv_w[j * di + ch]));
    const float u = silu_act(__fadd_rn(acc, conv_b[ch]), silu_tab, silu_nk);
    xs[t] = u;
    xs_out[static_cast<size_t>(bi) * di + ch] = u;
    for (int j = 0; j < wm1; ++j) ncrow[j * di + ch] = from_f<T>(win(j + 1));
  }
  __syncthreads();
  float* prow = partial + (static_cast<size_t>(bi) * nblk + blk) * rn;
  for (int j = t; j < rn; j += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < cnt; ++c)
      acc += xs[c] * xproj_w[static_cast<size_t>(c0 + c) * rn + j];
    prow[j] = acc;
  }
}

template <typename T>
__global__ void mamba1_scan_kernel(
    const float* __restrict__ xs_in, const float* __restrict__ partial,
    int nblk, const T* __restrict__ z, int z_rs,
    const float* __restrict__ ssm_state, const float* __restrict__ dtproj_w,
    const float* __restrict__ dtproj_b, const float* __restrict__ A,
    const float* __restrict__ D, T* __restrict__ y, float* __restrict__ new_ssm,
    int di, int n, int r, const float* silu_tab, int silu_nk,
    const float* sp_tab, int sp_nk) {
  extern __shared__ float dbc[];  // (r + 2n,): dt_low, B, C of this row
  const int bi = blockIdx.y, rn = r + 2 * n;
  const float* prow = partial + static_cast<size_t>(bi) * nblk * rn;
  for (int j = threadIdx.x; j < rn; j += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < nblk; ++k) acc += prow[static_cast<size_t>(k) * rn + j];
    dbc[j] = acc;
  }
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= di) return;
  float acc = 0.f;
  for (int k = 0; k < r; ++k) acc += dbc[k] * dtproj_w[static_cast<size_t>(k) * di + c];
  const float dt = softplus_act(acc + dtproj_b[c], sp_tab, sp_nk);
  const float u = xs_in[static_cast<size_t>(bi) * di + c];
  const size_t so = (static_cast<size_t>(bi) * di + c) * n;
  float yc = scan_channel(ssm_state + so, new_ssm + so,
                          A + static_cast<size_t>(c) * n, dbc + r, dbc + r + n,
                          dt, dt * u, n);
  yc = yc + D[c] * u;
  const float zg = silu_act(to_f(z[static_cast<size_t>(bi) * z_rs + c]),
                            silu_tab, silu_nk);
  y[static_cast<size_t>(bi) * di + c] = from_f<T>(yc * zg);
}

template <typename T>
__global__ void sscan_step_kernel(const float* __restrict__ state,
                                  const T* __restrict__ u,
                                  const float* __restrict__ dt,
                                  const float* __restrict__ A,
                                  const float* __restrict__ B,
                                  const float* __restrict__ C,
                                  const float* __restrict__ D,
                                  float* __restrict__ new_state,
                                  T* __restrict__ y, int b, int d, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= b * d) return;
  const int bi = idx / d, c = idx % d;
  const float uf = to_f(u[idx]), dtf = dt[idx];
  const size_t so = static_cast<size_t>(idx) * n;
  float yc = scan_channel(state + so, new_state + so,
                          A + static_cast<size_t>(c) * n,
                          B + static_cast<size_t>(bi) * n,
                          C + static_cast<size_t>(bi) * n, dtf, dtf * uf, n);
  if (D) yc = yc + uf * D[c];
  y[idx] = from_f<T>(yc);
}

// xs_raw / z: rows of di values at row strides x_rs / z_rs (the in_proj
// halves, in T); conv_state (b, w-1, di) T; ssm_state (b, di, n) fp32;
// conv_w (w, di), conv_b (di,), xproj_w (di, r+2n), dtproj_w (r, di),
// dtproj_b (di,), A (di, n), D (di,) fp32.  scratch: b * (di + nblk *
// (r+2n)) floats, nblk = ceil(di / 64).  Writes y (b, di) T (gated,
// pre-out_proj), new_conv (b, w-1, di) T and new_ssm (b, di, n) fp32.
extern "C" int mamba1_step_launch(
    int dtype, const void* xs_raw, int x_rs, const void* z, int z_rs,
    const void* conv_state, const void* ssm_state, const void* conv_w,
    const void* conv_b, const void* xproj_w, const void* dtproj_w,
    const void* dtproj_b, const void* A, const void* D, void* scratch,
    void* y, void* new_conv, void* new_ssm, int b, int di, int n, int r,
    int width, const void* silu_tab, int silu_nk, const void* sp_tab,
    int sp_nk, void* stream) {
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rn = r + 2 * n;
  const int nblk = (di + CONV_CH - 1) / CONV_CH;
  float* xs = static_cast<float*>(scratch);
  float* partial = xs + static_cast<size_t>(b) * di;
  const float* stab = static_cast<const float*>(silu_tab);
  const float* ptab = static_cast<const float*>(sp_tab);
  DISPATCH_T(dtype, {
    mamba1_conv_xproj_kernel<T><<<dim3(nblk, b), CONV_NT, 0, s>>>(
        static_cast<const T*>(xs_raw), x_rs,
        static_cast<const T*>(conv_state), static_cast<const float*>(conv_w),
        static_cast<const float*>(conv_b), static_cast<const float*>(xproj_w),
        xs, partial, static_cast<T*>(new_conv), di, rn, width, stab, silu_nk);
    mamba1_scan_kernel<T><<<dim3((di + SCAN_NT - 1) / SCAN_NT, b), SCAN_NT,
                            rn * sizeof(float), s>>>(
        xs, partial, nblk, static_cast<const T*>(z), z_rs,
        static_cast<const float*>(ssm_state),
        static_cast<const float*>(dtproj_w),
        static_cast<const float*>(dtproj_b), static_cast<const float*>(A),
        static_cast<const float*>(D), static_cast<T*>(y),
        static_cast<float*>(new_ssm), di, n, r, stab, silu_nk, ptab, sp_nk);
  });
  return static_cast<int>(cudaGetLastError());
}

// state (b, d, n) fp32; u (b, d) T; dt (b, d), A (d, n), B / C (b, n) and
// D (d,) fp32, D null for no skip.  Writes new_state (b, d, n) fp32 and
// y (b, d) T.
extern "C" int sscan_step_launch(int dtype, const void* state, const void* u,
                                 const void* dt, const void* A, const void* B,
                                 const void* C, const void* D,
                                 void* new_state, void* y, int b, int d,
                                 int n, void* stream) {
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = b * d, nt = 128;
  DISPATCH_T(dtype, sscan_step_kernel<T><<<(total + nt - 1) / nt, nt, 0, s>>>(
      static_cast<const float*>(state), static_cast<const T*>(u),
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<const float*>(D), static_cast<float*>(new_state),
      static_cast<T*>(y), b, d, n));
  return static_cast<int>(cudaGetLastError());
}
