// Fused Mamba-2 single-token step, up to (not including) the gated norm.
//
// Replaces the TPU kernel src/repro/kernels/decode_step.py:155
// mamba2_step: conv-tail shift + bias, SiLU, softplus(dt + dt_bias), the
// SSD update  st' = st * exp(dt*A) + (dt*x) (x) B,  y = st' . C,  and the
// D skip.  The gated RMSNorm that ends the TPU kernel runs afterwards in
// gated_norm.cu over whole rows.
//
// Bound: bytes.  Per layer and batch row the fp32 state (24 x 64 x 128 at
// full width, 786 KB) is read once and written once; everything else is
// a few KB, and the arithmetic is ~5 operations per state element.
//
// Design.  The TPU kernel holds a row's whole state in VMEM, which does
// not fit a Hopper block, so the grid is (batch, head): one block owns a
// head's 64 x 128 state and streams it straight from device memory to
// device memory, one warp per state row, lanes along d_state so every
// load and store is coalesced; y's row sum is a warp shuffle reduction.
// Each block recomputes the conv + SiLU of its group's B/C channels (256
// values, cheaper than a second pass).  The x channels of the new conv
// tail are written by their head's block and the B/C channels by head 0,
// so every element is written exactly once.
//
// Under ActiBA the conv's SiLU and dt's softplus are PWL tables (silu_tab,
// sp_tab; null for the exact functions), as the TPU kernel's silu and
// softplus callables are (decode_step.py:159-160).
//
// ssd_step replaces the TPU kernel decode_step.py:76 ssd_step, the bare
// SSD update without the conv, the activations or the norm (dt comes in
// raw): the same (batch, head) grid and the same head update.
#include "common.cuh"

// One head's p x n state: s'[pi][k] = s[pi][k] decay + (dt x[pi]) B[k],
// written to ns, one warp per state row, lanes along n.  done(pi, y) gets
// y = s'[pi] . C on lane 0 of the row's warp.
template <typename F>
__device__ __forceinline__ void ssd_head_update(
    const float* __restrict__ s, float* __restrict__ ns, const float* xs,
    const float* Bv, const float* Cv, float dtf, float decay, int p, int n,
    F done) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int pi = warp; pi < p; pi += nwarps) {
    const float dx = dtf * xs[pi];
    const float* srow = s + static_cast<size_t>(pi) * n;
    float* nrow = ns + static_cast<size_t>(pi) * n;
    float part = 0.f;
    for (int k = lane; k < n; k += 32) {
      const float v = srow[k] * decay + dx * Bv[k];
      nrow[k] = v;
      part += v * Cv[k];
    }
    part = warp_sum(part);
    if (lane == 0) done(pi, part);
  }
}

template <typename T>
__global__ void mamba2_step_kernel(
    const T* __restrict__ xbc, int xbc_rs, const T* __restrict__ dt,
    int dt_rs, const T* __restrict__ conv_state,
    const float* __restrict__ ssm_state, const float* __restrict__ conv_w,
    const float* __restrict__ conv_b, const float* __restrict__ dt_bias,
    const float* __restrict__ A, const float* __restrict__ D,
    float* __restrict__ ypre, T* __restrict__ new_conv,
    float* __restrict__ new_ssm, int h, int p, int g, int n, int width,
    const float* silu_tab, int silu_nk, const float* sp_tab, int sp_nk) {
  extern __shared__ float smem[];
  float* xs = smem;      // (p,)  activated x channels of this head
  float* Bv = xs + p;    // (n,)  activated B of this head's group
  float* Cv = Bv + n;    // (n,)  activated C

  const int bi = blockIdx.x, hi = blockIdx.y;
  const int di = h * p, dxbc = di + 2 * g * n, gi = hi / (h / g);
  const int wm1 = width - 1;
  const T* xrow = xbc + static_cast<size_t>(bi) * xbc_rs;
  const T* crow = conv_state + static_cast<size_t>(bi) * wm1 * dxbc;
  T* ncrow = new_conv + static_cast<size_t>(bi) * wm1 * dxbc;

  // Window row j of channel ch: the old tail for j < w-1, then the token.
  auto win = [&](int j, int ch) -> float {
    return j < wm1 ? to_f(crow[j * dxbc + ch]) : to_f(xrow[ch]);
  };
  auto conv_act = [&](int ch) -> float {
    float acc = 0.f;
    for (int j = 0; j < width; ++j)
      acc = __fadd_rn(acc, __fmul_rn(win(j, ch), conv_w[j * dxbc + ch]));
    return silu_act(__fadd_rn(acc, conv_b[ch]), silu_tab, silu_nk);
  };
  auto shift = [&](int ch) {
    for (int j = 0; j < wm1; ++j) ncrow[j * dxbc + ch] = from_f<T>(win(j + 1, ch));
  };

  for (int c = threadIdx.x; c < p; c += blockDim.x) {
    xs[c] = conv_act(hi * p + c);
    shift(hi * p + c);
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    Bv[k] = conv_act(di + gi * n + k);
    Cv[k] = conv_act(di + g * n + gi * n + k);
  }
  if (hi == 0) {
    for (int c = threadIdx.x; c < 2 * g * n; c += blockDim.x) shift(di + c);
  }
  __syncthreads();

  const float dtf = softplus_act(
      to_f(dt[static_cast<size_t>(bi) * dt_rs + hi]) + dt_bias[hi], sp_tab,
      sp_nk);
  const float decay = expf(dtf * A[hi]);
  const float dh = D[hi];
  const size_t sbase = (static_cast<size_t>(bi) * h + hi) * p * n;
  float* yrow = ypre + static_cast<size_t>(bi) * di + hi * p;
  ssd_head_update(ssm_state + sbase, new_ssm + sbase, xs, Bv, Cv, dtf, decay,
                  p, n, [&](int pi, float part) {
                    yrow[pi] = part + dh * xs[pi];
                  });
}

template <typename T>
__global__ void ssd_step_kernel(const float* __restrict__ state,
                                const T* __restrict__ x,
                                const float* __restrict__ dt,
                                const float* __restrict__ A,
                                const float* __restrict__ B,
                                const float* __restrict__ C,
                                float* __restrict__ new_state,
                                T* __restrict__ y, int h, int p, int g,
                                int n) {
  extern __shared__ float smem[];
  float* xs = smem;      // (p,)  this head's x
  float* Bv = xs + p;    // (n,)  B of this head's group
  float* Cv = Bv + n;    // (n,)  C
  const int bi = blockIdx.x, hi = blockIdx.y, gi = hi / (h / g);
  const size_t hrow = static_cast<size_t>(bi) * h + hi;
  const size_t grow = (static_cast<size_t>(bi) * g + gi) * n;
  for (int c = threadIdx.x; c < p; c += blockDim.x) xs[c] = to_f(x[hrow * p + c]);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    Bv[k] = B[grow + k];
    Cv[k] = C[grow + k];
  }
  __syncthreads();
  const float dtf = dt[hrow];
  const size_t sbase = hrow * p * n;
  T* yrow = y + hrow * p;
  ssd_head_update(state + sbase, new_state + sbase, xs, Bv, Cv, dtf,
                  expf(dtf * A[hi]), p, n,
                  [&](int pi, float part) { yrow[pi] = from_f<T>(part); });
}

// xbc rows of dxbc values at row stride xbc_rs, dt rows of h values at
// row stride dt_rs (both in T); conv_state (b, w-1, dxbc) T; ssm_state
// (b, h, p, n) fp32; conv_w (w, dxbc), conv_b (dxbc,), dt_bias/A/D (h,)
// fp32.  Writes ypre (b, h*p) fp32 (pre-norm y with the D skip),
// new_conv (b, w-1, dxbc) T and new_ssm (b, h, p, n) fp32.  silu_tab /
// sp_tab: the ActiBA tables (common.cuh: pwl_eval), or null for exact.
extern "C" int mamba2_step_launch(
    int dtype, const void* xbc, int xbc_rs, const void* dt, int dt_rs,
    const void* conv_state, const void* ssm_state, const void* conv_w,
    const void* conv_b, const void* dt_bias, const void* A, const void* D,
    void* ypre, void* new_conv, void* new_ssm, int b, int h, int p, int g,
    int n, int width, const void* silu_tab, int silu_nk, const void* sp_tab,
    int sp_nk, void* stream) {
  if (b == 0) return 0;
  const dim3 grid(b, h);
  const size_t smem = static_cast<size_t>(p + 2 * n) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH_T(dtype, mamba2_step_kernel<T><<<grid, 128, smem, s>>>(
      static_cast<const T*>(xbc), xbc_rs, static_cast<const T*>(dt), dt_rs,
      static_cast<const T*>(conv_state), static_cast<const float*>(ssm_state),
      static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
      static_cast<const float*>(dt_bias), static_cast<const float*>(A),
      static_cast<const float*>(D), static_cast<float*>(ypre),
      static_cast<T*>(new_conv), static_cast<float*>(new_ssm), h, p, g, n,
      width, static_cast<const float*>(silu_tab), silu_nk,
      static_cast<const float*>(sp_tab), sp_nk));
  return static_cast<int>(cudaGetLastError());
}

// state (b, h, p, n) fp32; x (b, h, p) T; dt (b, h), A (h,) and B / C
// (b, g, n) fp32.  Writes new_state (b, h, p, n) fp32 and y (b, h, p) T.
extern "C" int ssd_step_launch(int dtype, const void* state, const void* x,
                               const void* dt, const void* A, const void* B,
                               const void* C, void* new_state, void* y,
                               int b, int h, int p, int g, int n,
                               void* stream) {
  if (b == 0) return 0;
  const dim3 grid(b, h);
  const size_t smem = static_cast<size_t>(p + 2 * n) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH_T(dtype, ssd_step_kernel<T><<<grid, 128, smem, s>>>(
      static_cast<const float*>(state), static_cast<const T*>(x),
      static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(new_state), static_cast<T*>(y), h, p, g, n));
  return static_cast<int>(cudaGetLastError());
}
