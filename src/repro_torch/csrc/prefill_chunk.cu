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
//      shared memory.  The (L, L) decay block at L = 256 is 256 KB, more
//      than a block's 227 KB, so it is never held whole: 64 query rows x
//      64 key rows at a time, with 64 x 128 B and C tiles, the masked and
//      decayed scores in a 64 x 65 tile, and row strides padded by one
//      float so the shared-memory reads are free of bank conflicts.
// A later PR moves the three products to wgmma; this one is plain fp32.
#include "common.cuh"

namespace {
constexpr int TQ = 64;   // query rows per tile
constexpr int TK = 64;   // key rows per tile
constexpr int NT = 256;  // threads per scan block
constexpr int ACC_Y = TQ * 64 / NT;  // y outputs per thread (p <= 64): 16
constexpr int ACC_S = 8192 / NT;     // state outputs per thread (p*n <= 8192)
}  // namespace

template <typename T>
__global__ void conv_act_kernel(const T* __restrict__ xbc, int xbc_rs,
                                const T* __restrict__ conv_state,
                                const float* __restrict__ conv_w,
                                const float* __restrict__ conv_b,
                                T* __restrict__ act, T* __restrict__ new_conv,
                                int l, int dxbc, int width) {
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
        from_f<T>(silu_f(round_to<T>(acc)));
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
    int chunk, int h, int p, int g, int n) {
  extern __shared__ float sm[];
  const int ns = n + 1, ps = p + 1, ss = TK + 1;
  float* st = sm;                 // (p, ns)   carried state
  float* cs = st + p * ns;        // (chunk,)  CumBA prefix sums of dt*A
  float* dtf = cs + chunk;        // (chunk,)  softplus(dt + dt_bias)
  float* Ct = dtf + chunk;        // (TQ, ns)
  float* Bt = Ct + TQ * ns;       // (TK, ns)
  float* Xt = Bt + TK * ns;       // (TK, ps)  x*dt (times decay for state)
  float* S = Xt + TK * ps;        // (TQ, ss)  masked, decayed C.B scores

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
    __syncthreads();
    for (int t = tid; t < chunk; t += NT) {
      const float v = softplus_f(to_f(dt[(row0 + t) * dt_rs + hi]) + dtb);
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

    // ---- outputs, one tile of TQ query rows at a time ------------------
    for (int q0 = 0; q0 < chunk; q0 += TQ) {
      const int tq = min(TQ, chunk - q0);
      for (int e = tid; e < tq * n; e += NT)
        Ct[(e / n) * ns + e % n] =
            to_f(act[(row0 + q0 + e / n) * dxbc + coff + e % n]);
      __syncthreads();

      float acc[ACC_Y];
#pragma unroll
      for (int j = 0; j < ACC_Y; ++j) {  // carried-state term
        const int e = tid + j * NT;
        acc[j] = 0.f;
        if (e < tq * p) {
          const int i = e / p, pi = e % p;
          float s = 0.f;
          for (int k = 0; k < n; ++k) s += Ct[i * ns + k] * st[pi * ns + k];
          acc[j] = s * expf(cs[q0 + i]);
        }
      }
      for (int s0 = 0; s0 <= q0; s0 += TK) {  // intra-chunk term
        const int tk = min(TK, chunk - s0);
        for (int e = tid; e < tk * n; e += NT)
          Bt[(e / n) * ns + e % n] =
              to_f(act[(row0 + s0 + e / n) * dxbc + boff + e % n]);
        for (int e = tid; e < tk * p; e += NT) {
          const int j = e / p, pi = e % p;
          Xt[j * ps + pi] =
              to_f(act[(row0 + s0 + j) * dxbc + xoff + pi]) * dtf[s0 + j];
        }
        __syncthreads();
        for (int e = tid; e < TQ * TK; e += NT) {
          const int i = e / TK, j = e % TK;
          float v = 0.f;
          if (i < tq && j < tk && s0 + j <= q0 + i) {
            float d = 0.f;
            for (int k = 0; k < n; ++k) d += Ct[i * ns + k] * Bt[j * ns + k];
            v = d * expf(cs[q0 + i] - cs[s0 + j]);
          }
          S[i * ss + j] = v;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < ACC_Y; ++j) {
          const int e = tid + j * NT;
          if (e < tq * p) {
            const int i = e / p, pi = e % p;
            float s = 0.f;
            for (int jj = 0; jj < tk; ++jj) s += S[i * ss + jj] * Xt[jj * ps + pi];
            acc[j] += s;
          }
        }
        __syncthreads();
      }
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
#pragma unroll
    for (int j = 0; j < ACC_S; ++j) sacc[j] = 0.f;
    for (int s0 = 0; s0 < chunk; s0 += TK) {
      const int tk = min(TK, chunk - s0);
      __syncthreads();
      for (int e = tid; e < tk * n; e += NT)
        Bt[(e / n) * ns + e % n] =
            to_f(act[(row0 + s0 + e / n) * dxbc + boff + e % n]);
      for (int e = tid; e < tk * p; e += NT) {
        const int j = e / p, pi = e % p;
        Xt[j * ps + pi] = to_f(act[(row0 + s0 + j) * dxbc + xoff + pi]) *
                          dtf[s0 + j] * expf(cl - cs[s0 + j]);
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < ACC_S; ++j) {
        const int e = tid + j * NT;
        if (e < p * n) {
          const int pi = e / n, k = e % n;
          float s = 0.f;
          for (int jj = 0; jj < tk; ++jj) s += Xt[jj * ps + pi] * Bt[jj * ns + k];
          sacc[j] += s;
        }
      }
    }
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
// p <= 64, p * n <= 8192.  Returns the cudaError_t.
extern "C" int mamba2_prefill_launch(
    int dtype, const void* xbc, int xbc_rs, const void* dt, int dt_rs,
    const void* conv_state, const void* state_in, const void* conv_w,
    const void* conv_b, const void* dt_bias, const void* A, const void* D,
    void* act, void* ypre, void* new_conv, void* state_out, int b, int l,
    int chunk, int h, int p, int g, int n, int width, void* stream) {
  if (b == 0) return 0;
  if (p > 64 || p * n > 8192 || chunk <= 0 || l % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dxbc = h * p + 2 * g * n;
  const int rows = l > width - 1 ? l : width - 1;
  const dim3 cgrid((dxbc + 255) / 256, rows, b);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(p) * (n + 1) + 2 * chunk +
                       2 * TQ * (n + 1) + TK * (p + 1) + TQ * (TK + 1));
  cudaError_t err = cudaSuccess;
  DISPATCH_T(dtype, {
    conv_act_kernel<T><<<cgrid, 256, 0, s>>>(
        static_cast<const T*>(xbc), xbc_rs, static_cast<const T*>(conv_state),
        static_cast<const float*>(conv_w), static_cast<const float*>(conv_b),
        static_cast<T*>(act), static_cast<T*>(new_conv), l, dxbc, width);
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
          h, p, g, n);
      err = cudaGetLastError();
    }
  });
  return static_cast<int>(err);
}
