// The matrix-product bodies shared by qmatmul.cu (TPU kernel 10, int8
// weights), matmul_pwl.cu (kernel 11, bf16 or fp32 weights) and
// rglru_step.cu (kernel 6's gate products):
//
//   out = epi((x @ w) [* scale]) [* ((x @ v) [* vscale])]
//
// x (m, k) in T (float or bf16), w and v (k, n) row-major read through a
// weight loader that widens them to fp32 exactly (int8, bf16 or float),
// out (m, n) in T.  scale / vscale (n,) fp32 are the W8 per-channel scales,
// null for unscaled weights; epi is ActiBA's PWL table (common.cuh:
// pwl_eval) or the identity for a null table.  The sums are fp32; the
// scale multiplies them once, as in the TPU kernels' drain, and the
// epilogue's multiplies are rounded one by one (__fmul_rn), as the plain
// versions take them, so kernel and plain version differ only in the
// order of their sums.
//
// Two regimes:
//
// * m <= GEMV_M (decode, m = slots): a GEMV that reads the weights once,
//   bound by their bytes.  A block takes 128 columns (four per thread, one
//   vector load per row where n and alignment allow) and a slice of k; its
//   8 warps split the slice by rows and sum their partials in shared
//   memory in warp order.  k is split over blocks too, so that the column
//   tiles of a narrow n fill the 132 SMs (the wrapper picks the split
//   count from the shapes alone).  The splits write fp32 partials and a
//   second kernel sums them in split order: no float atomics, so the same
//   inputs give the same bits on every run.  One split writes the output
//   directly.  The x slice comes through an x loader, so a caller can
//   compute x on the fly (kernel 6 computes its conv there).
// * m > GEMV_M (prefill): a tiled product, 64 x 64 outputs per block over
//   k in steps of 32, the x tile and the widened weight tile in shared
//   memory, 4 x 4 outputs per thread on the CUDA cores.  Bound by
//   operations (2 m k n).  The widening is exact, so a later version can
//   feed bf16 tensor cores (wgmma) and compute the same function.
//
// Ragged edges are masked in the kernels; nothing is padded on the host.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace gemm {
constexpr int GEMV_M = 8;      // rows the GEMV path takes
constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_COLS = 128;   // columns per GEMV block (4 per lane)
constexpr int GV_MAX_KS = 1024;  // k rows per split (x slice in smem)
constexpr int GV_SMEM = GEMV_M * GV_COLS * GV_WARPS;  // floats
constexpr int GV_OWN = GEMV_M * GV_COLS / GV_THREADS;  // outputs per thread

constexpr int TM = 64, TN = 64, TK = 32, T_THREADS = 256;

// ---- weight loaders: element `off` and four consecutive columns of a row,
// widened to fp32 (zero past n).  vec4: n % 4 == 0 and the base aligned to
// four elements, so one vector load.
struct I8W {
  const int8_t* p;
  __device__ __forceinline__ float at(size_t off) const {
    return static_cast<float>(p[off]);
  }
  __device__ __forceinline__ void load4(size_t row, int c, int n, bool vec4,
                                        float (&w)[4]) const {
    const int8_t* q = p + row * n + c;
    if (vec4 && c + 3 < n) {
      const char4 v = *reinterpret_cast<const char4*>(q);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = c + j < n ? static_cast<float>(q[j]) : 0.f;
    }
  }
};

struct F32W {
  const float* p;
  __device__ __forceinline__ float at(size_t off) const { return p[off]; }
  __device__ __forceinline__ void load4(size_t row, int c, int n, bool vec4,
                                        float (&w)[4]) const {
    const float* q = p + row * n + c;
    if (vec4 && c + 3 < n) {
      const float4 v = *reinterpret_cast<const float4*>(q);
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = c + j < n ? q[j] : 0.f;
    }
  }
};

struct BF16W {
  const __nv_bfloat16* p;
  __device__ __forceinline__ float at(size_t off) const {
    return __bfloat162float(p[off]);
  }
  __device__ __forceinline__ void load4(size_t row, int c, int n, bool vec4,
                                        float (&w)[4]) const {
    const __nv_bfloat16* q = p + row * n + c;
    if (vec4 && c + 3 < n) {
      const uint2 v = *reinterpret_cast<const uint2*>(q);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
      w[0] = lo.x;
      w[1] = lo.y;
      w[2] = hi.x;
      w[3] = hi.y;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = c + j < n ? __bfloat162float(q[j]) : 0.f;
    }
  }
};

// x loader of a plain (m, k) row-major input in T.
template <typename T> struct RowX {
  const T* x;
  int k;
  __device__ __forceinline__ float operator()(int r, int kk) const {
    return to_f(x[static_cast<size_t>(r) * k + kk]);
  }
};

// The epilogue: scale, activation, gate (each multiply rounded alone).
__device__ __forceinline__ float epi(float acc, const float* scale, int c,
                                     const float* tab, int nk) {
  const float y = scale ? __fmul_rn(acc, scale[c]) : acc;
  return tab ? pwl_eval(y, tab, nk) : y;
}

__device__ __forceinline__ float gate(float y, float g, const float* vscale,
                                      int c) {
  return __fmul_rn(y, vscale ? __fmul_rn(g, vscale[c]) : g);
}

// One GEMV block's sums: columns [blockIdx.x * 128, +128) of rows [0, m)
// over k rows [k0, k0 + kn).  sm holds GV_SMEM floats.  On return thread t
// owns outputs o = t + i * GV_THREADS (row o / 128, column o % 128 of the
// tile): tot[i] = sum x w, gtot[i] = sum x v (GATED).
template <typename XL, typename WL, bool GATED>
__device__ __forceinline__ void gemv_sums(XL xl, WL w, WL v, int m, int n,
                                          int k0, int kn, bool vec4, float* sm,
                                          float (&tot)[GV_OWN],
                                          float (&gtot)[GV_OWN]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * GV_COLS + lane * 4;

  for (int e = threadIdx.x; e < m * kn; e += GV_THREADS) {
    const int r = e / kn, kk = e % kn;
    sm[r * kn + kk] = xl(r, k0 + kk);
  }
  __syncthreads();

  float acc[GEMV_M][4], gacc[GEMV_M][4];
#pragma unroll
  for (int r = 0; r < GEMV_M; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = gacc[r][j] = 0.f;

#pragma unroll 4
  for (int kk = warp; kk < kn; kk += GV_WARPS) {
    float wv[4], vv[4];
    w.load4(static_cast<size_t>(k0 + kk), c0, n, vec4, wv);
    if (GATED) v.load4(static_cast<size_t>(k0 + kk), c0, n, vec4, vv);
#pragma unroll
    for (int r = 0; r < GEMV_M; ++r) {
      if (r < m) {
        const float xv = sm[r * kn + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[r][j] += xv * wv[j];
          if (GATED) gacc[r][j] += xv * vv[j];
        }
      }
    }
  }

  // Sum the warps' partials in warp order.
#pragma unroll
  for (int pass = 0; pass < (GATED ? 2 : 1); ++pass) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < GEMV_M; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sm[(warp * GEMV_M + r) * GV_COLS + lane * 4 + j] =
            pass ? gacc[r][j] : acc[r][j];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < GV_OWN; ++i) {
      const int o = threadIdx.x + i * GV_THREADS;
      const int r = o / GV_COLS, cl = o % GV_COLS;
      float s = 0.f;
      for (int wi = 0; wi < GV_WARPS; ++wi) s += sm[(wi * GEMV_M + r) * GV_COLS + cl];
      if (pass)
        gtot[i] = s;
      else
        tot[i] = s;
    }
  }
}

// Grid (ceil(n / 128), splits); dynamic shared memory GV_SMEM floats.
// partial == nullptr: one split, write out.  Else write the fp32 sums of
// split s to partial[(s * G + g) * m * n + r * n + c], g = 0 for w and 1
// for v (G = 2 when gated, else 1).
template <typename T, typename WL, bool GATED>
__global__ void __launch_bounds__(GV_THREADS) gemv_kernel(
    const T* __restrict__ x, WL w, const float* __restrict__ scale, WL v,
    const float* __restrict__ vscale, T* __restrict__ out,
    float* __restrict__ partial, int m, int k, int n, int ks, bool vec4,
    const float* __restrict__ tab, int nk) {
  extern __shared__ float sm[];
  const int split = blockIdx.y;
  const int k0 = split * ks;
  const int kn = min(ks, k - k0);
  float tot[GV_OWN], gtot[GV_OWN];
  gemv_sums<RowX<T>, WL, GATED>(RowX<T>{x, k}, w, v, m, n, k0, kn, vec4, sm,
                                tot, gtot);
  const int cb = blockIdx.x * GV_COLS;
#pragma unroll
  for (int i = 0; i < GV_OWN; ++i) {
    const int o = threadIdx.x + i * GV_THREADS;
    const int r = o / GV_COLS, c = cb + o % GV_COLS;
    if (r >= m || c >= n) continue;
    const size_t idx = static_cast<size_t>(r) * n + c;
    if (partial == nullptr) {
      float y = epi(tot[i], scale, c, tab, nk);
      if (GATED) y = gate(y, gtot[i], vscale, c);
      out[idx] = from_f<T>(y);
    } else {
      const size_t mn = static_cast<size_t>(m) * n;
      partial[(static_cast<size_t>(split) * (GATED ? 2 : 1)) * mn + idx] = tot[i];
      if (GATED) partial[(static_cast<size_t>(split) * 2 + 1) * mn + idx] = gtot[i];
    }
  }
}

// The split-k drain: sum the splits' partials in split order, then the
// epilogue.  One thread per output element.
template <typename T, bool GATED>
__global__ void drain_kernel(const float* __restrict__ partial, int splits,
                             const float* __restrict__ scale,
                             const float* __restrict__ vscale,
                             T* __restrict__ out, int m, int n,
                             const float* __restrict__ tab, int nk) {
  const size_t mn = static_cast<size_t>(m) * n;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  const int c = static_cast<int>(idx % n);
  constexpr int G = GATED ? 2 : 1;
  float a = 0.f, g = 0.f;
  for (int s = 0; s < splits; ++s) {
    a += partial[(static_cast<size_t>(s) * G) * mn + idx];
    if (GATED) g += partial[(static_cast<size_t>(s) * G + 1) * mn + idx];
  }
  float y = epi(a, scale, c, tab, nk);
  if (GATED) y = gate(y, g, vscale, c);
  out[idx] = from_f<T>(y);
}

// Grid (ceil(n / TN), ceil(m / TM)), T_THREADS threads.  Thread (ty, tx)
// owns rows ty + 16 i and columns tx + 16 j (i, j < 4) of the block's
// tile, so neighbouring threads read neighbouring shared words.
template <typename T, typename WL, bool GATED>
__global__ void __launch_bounds__(T_THREADS) tiled_kernel(
    const T* __restrict__ x, WL w, const float* __restrict__ scale, WL v,
    const float* __restrict__ vscale, T* __restrict__ out, int m, int k, int n,
    const float* __restrict__ tab, int nk) {
  __shared__ float As[TK][TM + 1];   // x tile, transposed
  __shared__ float Bs[TK][TN];       // widened w tile
  __shared__ float Vs[GATED ? TK : 1][TN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  float acc[4][4], gacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = gacc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += TK) {
    for (int e = threadIdx.x; e < TM * TK; e += T_THREADS) {
      const int r = e / TK, kk = e % TK;
      const int gr = m0 + r, gk = k0 + kk;
      As[kk][r] = gr < m && gk < k ? to_f(x[static_cast<size_t>(gr) * k + gk]) : 0.f;
    }
    for (int e = threadIdx.x; e < TK * TN; e += T_THREADS) {
      const int kk = e / TN, c = e % TN;
      const int gk = k0 + kk, gc = n0 + c;
      const bool in = gk < k && gc < n;
      const size_t off = static_cast<size_t>(gk) * n + gc;
      Bs[kk][c] = in ? w.at(off) : 0.f;
      if (GATED) Vs[kk][c] = in ? v.at(off) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = Bs[kk][tx + 16 * j];
        if (GATED) vv[j] = Vs[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += a[i] * b[j];
          if (GATED) gacc[i][j] += a[i] * vv[j];
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= n) continue;
      float y = epi(acc[i][j], scale, c, tab, nk);
      if (GATED) y = gate(y, gacc[i][j], vscale, c);
      out[static_cast<size_t>(r) * n + c] = from_f<T>(y);
    }
  }
}

// Launch the product on stream s: the GEMV (with its drain when splits >
// 1) for m <= GEMV_M, else the tiled kernel.  partial: splits * (gated ? 2
// : 1) * m * n fp32 scratch when m <= 8 and splits > 1.  Returns the
// cudaError_t.
template <typename T, typename WL, bool GATED>
int launch(const void* x, WL w, const float* scale, WL v, const float* vscale,
           void* out, void* partial, int m, int k, int n, int splits, int vec4,
           const float* tab, int nk, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (m <= GEMV_M) {
    const int ks = (k + splits - 1) / splits;
    if (ks > GV_MAX_KS || (splits > 1 && partial == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n + GV_COLS - 1) / GV_COLS, splits);
    float* pt = splits > 1 ? static_cast<float*>(partial) : nullptr;
    gemv_kernel<T, WL, GATED><<<grid, GV_THREADS, GV_SMEM * sizeof(float), s>>>(
        xt, w, scale, v, vscale, ot, pt, m, k, n, ks, vec4 != 0, tab, nk);
    if (splits > 1) {
      const int err = static_cast<int>(cudaGetLastError());
      if (err) return err;
      const size_t mn = static_cast<size_t>(m) * n;
      drain_kernel<T, GATED><<<static_cast<unsigned>((mn + 255) / 256), 256, 0,
                               s>>>(pt, splits, scale, vscale, ot, m, n, tab, nk);
    }
  } else {
    const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
    tiled_kernel<T, WL, GATED><<<grid, T_THREADS, 0, s>>>(xt, w, scale, v, vscale,
                                                          ot, m, k, n, tab, nk);
  }
  return static_cast<int>(cudaGetLastError());
}
}  // namespace gemm
