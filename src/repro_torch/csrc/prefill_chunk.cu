// Fused Mamba-2 multi-token prefill, up to (not including) the gated norm.
//
// Replaces the TPU kernel src/repro/kernels/prefill_chunk.py:294
// mamba2_prefill_pallas: the causal conv over [tail; tokens], SiLU,
// softplus(dt + dt_bias), the CumBA prefix sums of dt*A, per head the
// intra-chunk term (C B^T (.) exp(segsum)) @ (x*dt) plus the carried-state
// term (C . state) * exp(cs), the outgoing state, and the D skip, with the
// TPU kernel's stream-dtype rounding (conv rounded to T before SiLU; y
// rounded to T before + x*D, that sum taken in T).  The gated RMSNorm
// runs afterwards in gated_norm.cu with the prefill's rounding.
//
// Bound: operations.  At full width (h 24, p 64, n 128, chunk 256) a head
// does ~15 fp32 operations for every byte a chunk's streams bring in;
// the work is fp32 on the CUDA cores (67 TFLOP/s), not the tensor cores.
//
// Design.  The TPU kernel walks a sequential (batch, chunk) grid and
// carries the conv tail and state in VMEM scratch; Hopper runs blocks in
// no order, so:
//   1. conv_act_kernel computes the activated xBC streams of the whole
//      sequence in one parallel pass (each position reads its w-1
//      predecessors straight from the input or the incoming tail, so no
//      carry is needed) and writes the outgoing conv tail;
//   2. ssd_scan_kernel runs one block per (batch, head) that loops over
//      the chunks in order and keeps the head's 64 x 128 fp32 state in
//      shared memory.  Each chunk's diagonal term and state contribution
//      are the 64 x 64 tiles of common.cuh (ssd_tiles), which ssd_chunk.cu
//      shares; this kernel adds the carried-state term and the state's
//      decay across chunks.
// Under ActiBA the conv's SiLU and dt's softplus are PWL tables (silu_tab,
// sp_tab; null for the exact functions), as the TPU kernel's silu and
// softplus callables are (prefill_chunk.py:178,182).
// A later PR moves the three products to wgmma; this one is plain fp32.
#include "common.cuh"

using namespace ssd_tiles;

template <typename T>
__global__ void conv_act_kernel(const T* __restrict__ xbc, int xbc_rs,
                                const T* __restrict__ conv_state,
                                const float* __restrict__ conv_w,
                                const float* __restrict__ conv_b,
                                T* __restrict__ act, T* __restrict__ new_conv,
                                int l, int dxbc, int width,
                                const float* silu_tab, int silu_nk) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= dxbc) return;
  const int t = blockIdx.y, bi = blockIdx.z, wm1 = width - 1;
  // Input at sequence position pos; negative positions read the tail.
  auto at = [&](int pos) -> float {
    return pos >= 0
               ? to_f(xbc[(static_cast<size_t>(bi) * l + pos) * xbc_rs + c])
               : to_f(conv_state[(static_cast<size_t>(bi) * wm1 + wm1 + pos) *
                                     dxbc + c]);
  };
  if (t < l) {
    float acc = 0.f;
    for (int j = 0; j < width; ++j)
      acc = __fadd_rn(acc, __fmul_rn(at(t - wm1 + j), conv_w[j * dxbc + c]));
    acc = __fadd_rn(acc, conv_b[c]);
    act[(static_cast<size_t>(bi) * l + t) * dxbc + c] =
        from_f<T>(silu_act(round_to<T>(acc), silu_tab, silu_nk));
  }
  if (t < wm1)
    new_conv[(static_cast<size_t>(bi) * wm1 + t) * dxbc + c] =
        from_f<T>(at(l - wm1 + t));
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(
    const T* __restrict__ act, const T* __restrict__ dt, int dt_rs,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    const float* __restrict__ D, const float* __restrict__ state_in,
    float* __restrict__ state_out, float* __restrict__ ypre, int l,
    int chunk, int h, int p, int g, int n, const float* sp_tab, int sp_nk) {
  extern __shared__ float sm[];
  const int ns = n + 1;
  float* st = sm;                 // (p, ns)   carried state
  float* cs = st + p * ns;        // (chunk,)  CumBA prefix sums of dt*A
  float* dtf = cs + chunk;        // (chunk,)  softplus(dt + dt_bias)
  const Tiles tl = carve(dtf + chunk, p, n);

  const int bi = blockIdx.x, hi = blockIdx.y, tid = threadIdx.x;
  const int di = h * p, dxbc = di + 2 * g * n, gi = hi / (h / g);
  const int xoff = hi * p, boff = di + gi * n, coff = di + g * n + gi * n;
  const float Ah = A[hi], dtb = dt_bias[hi];
  const float Dt = round_to<T>(D[hi]);
  const size_t sbase = (static_cast<size_t>(bi) * h + hi) * p * n;

  for (int e = tid; e < p * n; e += NT)
    st[(e / n) * ns + e % n] = state_in[sbase + e];

  for (int c0 = 0; c0 < l; c0 += chunk) {
    const size_t row0 = static_cast<size_t>(bi) * l + c0;
    const T* arow = act + row0 * dxbc;  // this chunk's activated rows
    __syncthreads();
    for (int t = tid; t < chunk; t += NT) {
      const float v = softplus_act(to_f(dt[(row0 + t) * dt_rs + hi]) + dtb,
                                   sp_tab, sp_nk);
      dtf[t] = v;
      cs[t] = v * Ah;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int t = 0; t < chunk; ++t) {
        run += cs[t];
        cs[t] = run;
      }
    }
    __syncthreads();
    const float cl = cs[chunk - 1];

    auto load_b = [&](int s0, int tk) {
      load_tile(tl.Bt, ns, arow + s0 * dxbc + boff, dxbc, tk, n, Ident());
    };
    auto load_x = [&](int s0, int tk) {
      load_tile(tl.Xt, tl.ps, arow + s0 * dxbc + xoff, dxbc, tk, p,
                [&](int r, float v) { return v * dtf[s0 + r]; });
    };
    auto load_xw = [&](int s0, int tk) {
      load_tile(tl.Xt, tl.ps, arow + s0 * dxbc + xoff, dxbc, tk, p,
                [&](int r, float v) {
                  return v * dtf[s0 + r] * expf(cl - cs[s0 + r]);
                });
    };

    // ---- outputs, one tile of TQ query rows at a time ------------------
    for (int q0 = 0; q0 < chunk; q0 += TQ) {
      const int tq = min(TQ, chunk - q0);
      load_tile(tl.Ct, ns, arow + q0 * dxbc + coff, dxbc, tq, n, Ident());
      __syncthreads();

      float acc[ACC_Y];
#pragma unroll
      for (int j = 0; j < ACC_Y; ++j) {  // carried-state term
        const int e = tid + j * NT;
        acc[j] = 0.f;
        if (e < tq * p) {
          const int i = e / p, pi = e % p;
          float s = 0.f;
          for (int k = 0; k < n; ++k) s += tl.Ct[i * ns + k] * st[pi * ns + k];
          acc[j] = s * expf(cs[q0 + i]);
        }
      }
      diag_rows(acc, tl, cs, q0, tq, chunk, p, n, load_b, load_x);
#pragma unroll
      for (int j = 0; j < ACC_Y; ++j) {  // D skip in the stream dtype
        const int e = tid + j * NT;
        if (e < tq * p) {
          const int i = e / p, pi = e % p;
          const size_t r = row0 + q0 + i;
          const float xv = to_f(act[r * dxbc + xoff + pi]);
          ypre[r * di + xoff + pi] =
              round_to<T>(round_to<T>(acc[j]) + round_to<T>(xv * Dt));
        }
      }
    }

    // ---- outgoing state: st * exp(cs_L) + sum_s (x dt exp(cs_L - cs_s)) B_s
    float sacc[ACC_S];
    chunk_state(sacc, tl, chunk, p, n, load_b, load_xw);
    const float dcl = expf(cl);
#pragma unroll
    for (int j = 0; j < ACC_S; ++j) {
      const int e = tid + j * NT;
      if (e < p * n) {
        float& v = st[(e / n) * ns + e % n];
        v = v * dcl + sacc[j];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < p * n; e += NT)
    state_out[sbase + e] = st[(e / n) * ns + e % n];
}

// Streams: xbc rows of dxbc values and dt rows of h values, each at its
// own row stride over the b*l rows (T); conv_state (b, w-1, dxbc) T;
// state_in (b, h, p, n) fp32; conv_w (w, dxbc), conv_b (dxbc,),
// dt_bias/A/D (h,) fp32.  Scratch act (b, l, dxbc) T.  Writes ypre
// (b, l, h*p) fp32 (the T-rounded pre-norm y with the D skip), new_conv
// (b, w-1, dxbc) T and state_out (b, h, p, n) fp32.  l % chunk == 0,
// p <= 64, p * n <= 8192.  silu_tab / sp_tab: the ActiBA tables of the
// conv's SiLU and dt's softplus (common.cuh: pwl_eval), or null for the
// exact functions.  Returns the cudaError_t.
extern "C" int mamba2_prefill_launch(
    int dtype, const void* xbc, int xbc_rs, const void* dt, int dt_rs,
    const void* conv_state, const void* state_in, const void* conv_w,
    const void* conv_b, const void* dt_bias, const void* A, const void* D,
    void* act, void* ypre, void* new_conv, void* state_out, int b, int l,
    int chunk, int h, int p, int g, int n, int width, const void* silu_tab,
    int silu_nk, const void* sp_tab, int sp_nk, void* stream) {
  if (b == 0) return 0;
  if (p > 64 || p * n > 8192 || chunk <= 0 || l % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dxbc = h * p + 2 * g * n;
  const int rows = l > width - 1 ? l : width - 1;
  const dim3 cgrid((dxbc + 255) / 256, rows, b);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(p) * (n + 1) + 2 * chunk +
                       tile_floats(p, n));
  cudaError_t err = cudaSuccess;
  DISPATCH_T(dtype, {
    conv_act_kernel<T><<<cgrid, 256, 0, s>>>(
        static_cast<const T*>(xbc), xbc_rs, static_cast<const T*>(conv_state),
        static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
        static_cast<T*>(act), static_cast<T*>(new_conv), l, dxbc, width,
        static_cast<const float*>(silu_tab), silu_nk);
    err = cudaGetLastError();
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err == cudaSuccess) {
      ssd_scan_kernel<T><<<dim3(b, h), NT, smem, s>>>(
          static_cast<const T*>(act), static_cast<const T*>(dt), dt_rs,
          static_cast<const float*>(dt_bias), static_cast<const float*>(A),
          static_cast<const float*>(D), static_cast<const float*>(state_in),
          static_cast<float*>(state_out), static_cast<float*>(ypre), l, chunk,
          h, p, g, n, static_cast<const float*>(sp_tab), sp_nk);
      err = cudaGetLastError();
    }
  });
  return static_cast<int>(err);
}
