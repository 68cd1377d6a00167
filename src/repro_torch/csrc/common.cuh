// Shared helpers for the port's CUDA kernels (built by kernels/build.py).
//
// Streams (z, xbc, dt, conv tails, outputs) come in the model's dtype T,
// float or bf16; every interior is fp32.  The activations use the same
// formulas as PyTorch's own CUDA ops (silu = x / (1 + exp(-x)); softplus
// with threshold 20), so a kernel and its plain PyTorch version differ
// only in the order of their sums.  Under ActiBA they are the PWL table
// instead (pwl_eval), evaluated in the plain version's order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// Round a float to T and back: the stream dtype's rounding point.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float silu_f(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ float softplus_f(float x) {
  return x > 20.0f ? x : log1pf(expf(x));
}

// ActiBA's piecewise-linear activation in its basis form,
//   f(x) = m0*x + c0 + sum_k dm_k * max(x - b_k, 0),
// the epilogue of src/repro/kernels/actiba.py:27 make_pwl_epilogue.  tab is
// the fp32 table [b_0..b_{nk-1}, dm_0..dm_{nk-1}, m0, c0] with nk = K - 1
// for K segments (core/pwl.py: PWLTable.packed_f32).  Rounded operations
// and no contraction into fma: the sum is taken in core/pwl.py: eval_pwl's
// order, so kernel and plain version agree bit for bit.
__device__ __forceinline__ float pwl_eval(float x, const float* tab, int nk) {
  float y = __fadd_rn(__fmul_rn(tab[2 * nk], x), tab[2 * nk + 1]);
  for (int k = 0; k < nk; ++k)
    y = __fadd_rn(y, __fmul_rn(tab[nk + k], fmaxf(__fsub_rn(x, tab[k]), 0.f)));
  return y;
}

// The kernels' activations: exact when tab is null, else the PWL table.
__device__ __forceinline__ float silu_act(float x, const float* tab, int nk) {
  return tab ? pwl_eval(x, tab, nk) : silu_f(x);
}

__device__ __forceinline__ float softplus_act(float x, const float* tab,
                                              int nk) {
  return tab ? pwl_eval(x, tab, nk) : softplus_f(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- SSD chunk tiles (prefill_chunk.cu and ssd_chunk.cu) -----------------
//
// Both kernels take, per (batch, head) and chunk of L rows, the diagonal
// term y_i += sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) x_j and the chunk's
// outgoing state sum_j (x_j exp(cs_L - cs_j)) (x) B_j, with x already
// scaled by dt and cs the prefix sums of dt*A.  The (L, L) decay block at
// L = 256 is 256 KB, more than a block's 227 KB, so it never exists
// whole: 64 query rows x 64 key rows at a time, with 64 x n C and B tiles,
// a 64 x p tile of x and the masked, decayed scores in a 64 x 65 tile.
// Row strides are padded by one float so the shared-memory reads are free
// of bank conflicts.  256 threads; p <= 64 and p * n <= 8192.
namespace ssd_tiles {
constexpr int TQ = 64;                 // query rows per tile
constexpr int TK = 64;                 // key rows per tile
constexpr int NT = 256;                // threads per block
constexpr int ACC_Y = TQ * 64 / NT;    // y outputs per thread (p <= 64)
constexpr int ACC_S = 8192 / NT;       // state outputs per thread

struct Tiles {
  float* Ct;  // (TQ, n+1)  C rows of the query tile
  float* Bt;  // (TK, n+1)  B rows of the key tile
  float* Xt;  // (TK, p+1)  x rows of the key tile (decay-weighted for states)
  float* S;   // (TQ, TK+1) masked, decayed C.B scores
  int ns, ps;
};

// Floats of shared memory the tiles take.
__host__ __device__ inline size_t tile_floats(int p, int n) {
  return static_cast<size_t>(TQ + TK) * (n + 1) +
         static_cast<size_t>(TK) * (p + 1) + static_cast<size_t>(TQ) * (TK + 1);
}

__device__ __forceinline__ Tiles carve(float* base, int p, int n) {
  Tiles t;
  t.ns = n + 1;
  t.ps = p + 1;
  t.Ct = base;
  t.Bt = t.Ct + TQ * t.ns;
  t.Xt = t.Bt + TK * t.ns;
  t.S = t.Xt + TK * t.ps;
  return t;
}

// dst[r][c] = f(r, src[r * src_rs + c]) for a rows x cols tile, as fp32.
template <typename T, typename F>
__device__ __forceinline__ void load_tile(float* dst, int ds, const T* src,
                                          size_t src_rs, int rows, int cols,
                                          F f) {
  for (int e = threadIdx.x; e < rows * cols; e += NT) {
    const int r = e / cols, c = e % cols;
    dst[r * ds + c] = f(r, to_f(src[r * src_rs + c]));
  }
}

struct Ident {
  __device__ __forceinline__ float operator()(int, float v) const { return v; }
};

// S[i][j] = (C_i . B_j) exp(cs[q0+i] - cs[s0+j]) where s0+j <= q0+i, else 0.
__device__ __forceinline__ void score_tile(const Tiles& t, const float* cs,
                                           int q0, int s0, int tq, int tk,
                                           int n) {
  for (int e = threadIdx.x; e < TQ * TK; e += NT) {
    const int i = e / TK, j = e % TK;
    float v = 0.f;
    if (i < tq && j < tk && s0 + j <= q0 + i) {
      float d = 0.f;
      for (int k = 0; k < n; ++k) d += t.Ct[i * t.ns + k] * t.Bt[j * t.ns + k];
      v = d * expf(cs[q0 + i] - cs[s0 + j]);
    }
    t.S[i * (TK + 1) + j] = v;
  }
}

// The diagonal term of query rows [q0, q0+tq): acc[j] (element tid + j*NT
// of the tq x p tile) += sum over key tiles s0 <= q0 of S X.  Ct must hold
// the query rows (loaded and synchronised); load_b(s0, tk) and
// load_x(s0, tk) fill Bt and Xt with the key rows.
template <typename LB, typename LX>
__device__ __forceinline__ void diag_rows(float (&acc)[ACC_Y], const Tiles& t,
                                          const float* cs, int q0, int tq,
                                          int chunk, int p, int n, LB load_b,
                                          LX load_x) {
  for (int s0 = 0; s0 <= q0; s0 += TK) {
    const int tk = min(TK, chunk - s0);
    load_b(s0, tk);
    load_x(s0, tk);
    __syncthreads();
    score_tile(t, cs, q0, s0, tq, tk, n);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ACC_Y; ++j) {
      const int e = threadIdx.x + j * NT;
      if (e < tq * p) {
        const int i = e / p, pi = e % p;
        float s = 0.f;
        for (int jj = 0; jj < tk; ++jj)
          s += t.S[i * (TK + 1) + jj] * t.Xt[jj * t.ps + pi];
        acc[j] += s;
      }
    }
    __syncthreads();
  }
}

// The chunk's state contribution: sacc[j] (element tid + j*NT of the p x n
// state) = sum over the chunk's rows of Xw[pi] B[k], where load_xw(s0, tk)
// fills Xt with x weighted by its decay to the chunk's end.
template <typename LB, typename LX>
__device__ __forceinline__ void chunk_state(float (&sacc)[ACC_S],
                                            const Tiles& t, int chunk, int p,
                                            int n, LB load_b, LX load_xw) {
#pragma unroll
  for (int j = 0; j < ACC_S; ++j) sacc[j] = 0.f;
  for (int s0 = 0; s0 < chunk; s0 += TK) {
    const int tk = min(TK, chunk - s0);
    __syncthreads();
    load_b(s0, tk);
    load_xw(s0, tk);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ACC_S; ++j) {
      const int e = threadIdx.x + j * NT;
      if (e < p * n) {
        const int pi = e / n, k = e % n;
        float s = 0.f;
        for (int jj = 0; jj < tk; ++jj)
          s += t.Xt[jj * t.ps + pi] * t.Bt[jj * t.ns + k];
        sacc[j] += s;
      }
    }
  }
}
}  // namespace ssd_tiles

// dtype codes passed from Python: 0 = float32, 1 = bfloat16.
#define DISPATCH_T(code, ...)                          \
  do {                                                 \
    if ((code) == 0) {                                 \
      using T = float;                                 \
      __VA_ARGS__;                                     \
    } else {                                           \
      using T = __nv_bfloat16;                         \
      __VA_ARGS__;                                     \
    }                                                  \
  } while (0)

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
