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
//   bound by their bytes (gemv_cluster_body; design at the body).  One
//   launch: a lane reads 16 bytes of a weight row at a time (16 int8, 8
//   bf16 or 4 fp32 columns; one 16-byte load where n and the base allow,
//   else two of 8 bytes, else element by element), U rows in flight; k is
//   split over the blocks of a thread-block cluster so that the column
//   tiles of a narrow n fill the SMs, and the splits' partial sums meet in
//   distributed shared memory, added in rank order.  The wrapper picks the
//   column group and the split count from the shapes alone
//   (kernels/qmatmul.py: gemv_plan; kernels/decode_step.py: rglru_plan),
//   so a shape always takes the same sums in the same order: the same
//   inputs give the same bits.  The body is templated on its x loader and
//   its epilogue: kernels 10 and 11 (gemv_cluster_kernel) read x rows in T
//   and write epi(...) [* gate]; kernel 6 (rglru_step.cu) computes its x,
//   the conv step, in fp32 as it stages it, and runs the whole RG-LRU
//   update on each output.
// * m > GEMV_M (prefill): tiled_kernel, 64 x 64 outputs per block over k
//   in steps of 32, the x tile and the widened weight tile in shared
//   memory, 4 x 4 outputs per thread on the CUDA cores.  Bound by
//   operations (2 m k n).  It serves fp32 x (whose 1e-4 limit TF32 does
//   not meet) and shapes the tensor-core bodies cannot read; bf16 x that
//   TMA can read takes qmatmul.cu's or matmul_pwl.cu's wgmma body.
//
// Ragged edges are masked in the kernels; nothing is padded on the host.
#pragma once

#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace gemm {
constexpr int GEMV_M = 8;      // rows the GEMV path takes

constexpr int TM = 64, TN = 64, TK = 32, T_THREADS = 256;

// ---- weight loaders.  at(off): element `off` widened to fp32 (the tiled
// body).  raw / widen (the cluster GEMV): LC columns of a row as 16 raw
// bytes, zero past n, read by one 16-byte load (vec 16: rows a multiple of
// 16 bytes, base 16-byte aligned), two 8-byte loads (vec 8) or element by
// element (vec 0); widen(r, j) is column j of them in fp32, exactly.
__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// LC = 16 / sizeof(B) elements of bits B from q (column c of n).
template <typename B>
__device__ __forceinline__ uint4 raw16(const B* q, int c, int n, int vec) {
  constexpr int LC = 16 / sizeof(B);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (c >= n) return r;
  if (vec == 16) return __ldg(reinterpret_cast<const uint4*>(q));
  if (vec == 8) {
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(q));
    r.x = a.x;
    r.y = a.y;
    if (c + LC / 2 < n) {
      const uint2 b = __ldg(reinterpret_cast<const uint2*>(q) + 1);
      r.z = b.x;
      r.w = b.y;
    }
    return r;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < LC; ++j)
    if (c + j < n)
      w[j * sizeof(B) / 4] |= static_cast<uint32_t>(q[j])
                              << (8 * ((j * sizeof(B)) % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct I8W {
  static constexpr int LC = 16;
  const int8_t* p;
  __device__ __forceinline__ float at(size_t off) const {
    return static_cast<float>(p[off]);
  }
  __device__ __forceinline__ uint4 raw(size_t row, int c, int n, int vec) const {
    return raw16(reinterpret_cast<const uint8_t*>(p) + row * n + c, c, n, vec);
  }
  // Byte j as 2^23 + (q + 128) in a float's bits, less 2^23 + 128: exact.
  static __device__ __forceinline__ float widen(const uint4& r, int j) {
    const uint32_t u = word(r, j / 4) ^ 0x80808080u;
    return __int_as_float(static_cast<int>(
               __byte_perm(u, 0x4B000000u, 0x7540u + j % 4))) -
           8388736.f;
  }
};

struct F32W {
  static constexpr int LC = 4;
  const float* p;
  __device__ __forceinline__ float at(size_t off) const { return p[off]; }
  __device__ __forceinline__ uint4 raw(size_t row, int c, int n, int vec) const {
    return raw16(reinterpret_cast<const uint32_t*>(p) + row * n + c, c, n, vec);
  }
  static __device__ __forceinline__ float widen(const uint4& r, int j) {
    return __uint_as_float(word(r, j));
  }
};

struct BF16W {
  static constexpr int LC = 8;
  const __nv_bfloat16* p;
  __device__ __forceinline__ float at(size_t off) const {
    return __bfloat162float(p[off]);
  }
  __device__ __forceinline__ uint4 raw(size_t row, int c, int n, int vec) const {
    return raw16(reinterpret_cast<const uint16_t*>(p) + row * n + c, c, n, vec);
  }
  // bf16 is the high half of an fp32.
  static __device__ __forceinline__ float widen(const uint4& r, int j) {
    const uint32_t w = word(r, j / 2);
    return __uint_as_float(j % 2 ? w & 0xFFFF0000u : w << 16);
  }
};

// x loaders of the cluster GEMV.  at(r, kk): row r, column kk of x as V,
// the type the body stages in registers; widen(v): that value in fp32.
// A plain (m, k) row-major input in T: loaded as T, widened at the store,
// so that no load waits for another's value.
template <typename T> struct RowX {
  using V = T;
  const T* x;
  int k;
  __device__ __forceinline__ V at(int r, int kk) const {
    return x[static_cast<size_t>(r) * k + kk];
  }
  static __device__ __forceinline__ float widen(V v) { return to_f(v); }
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

// The GEMV's epilogue for kernels 10 and 11: (row, col, sum x w, sum x v)
// -> out[row, col] = epi(...) [* gate(...)], in T.
template <typename T, bool GATED> struct OutEpi {
  const float* scale;
  const float* vscale;
  const float* tab;
  int nk;
  T* out;
  int n;
  __device__ __forceinline__ void operator()(int row, int col, float a,
                                             float ga) const {
    float y = epi(a, scale, col, tab, nk);
    if constexpr (GATED) y = gate(y, ga, vscale, col);
    out[static_cast<size_t>(row) * n + col] = from_f<T>(y);
  }
};

// ---- the GEMV of kernels 10, 11 and 6 (m <= GEMV_M) ---------------------
//
// A block of GW_THREADS threads takes `lanes` x LC columns (LC = 16 bytes
// of weights a lane) and a k slice of ks rows; a warp's 32 lanes are 32 /
// lanes k lanes of `lanes` lanes each, and a k lane takes every klanes-th
// row of the slice (klanes = 8 warps x 32 / lanes), the loads of U rows
// issued before their products.  x comes GW_RB rows a pass (rows past m
// are zero), its slice staged in shared memory up to GW_XCH rows at a
// time, every load of a chunk in flight before the first store.  The
// sums: a k lane's rows in order; the k lanes of a warp by a butterfly of
// shuffles (every lane of a column ends with the same bits); the warps in
// warp order through shared memory; the splits, which are the blocks of a
// cluster along y, in rank order through distributed shared memory: rank
// s adds up every rank's partial of the outputs o = s (mod splits), all
// the ranks' loads in flight before the sums, and writes them.  No float
// atomics and no scratch in device memory: the same inputs give the same
// bits.  The owning rank's thread hands each output's sums to the
// epilogue, ep(row, col, sum x w, sum x v), as it adds them up.
constexpr int GW_THREADS = 256, GW_WARPS = GW_THREADS / 32;
constexpr int GW_RB = 4;           // rows of x a pass takes
constexpr int GW_XCH = 1024;       // k rows of x in shared memory at a time
constexpr int GW_MAX_SPLITS = 8;   // blocks of a cluster (the portable limit)

// Floats of dynamic shared memory: the x slice, or the warps' partials,
// then the block's partials (G = 2 when gated), read by the cluster.
__host__ __device__ constexpr int gemv_floats(int cols, int xch, int G) {
  return (GW_RB * xch > GW_WARPS * GW_RB * cols ? GW_RB * xch
                                                : GW_WARPS * GW_RB * cols) +
         G * GW_RB * cols;
}

// The body of a block of a kernel launched as launch_gemv sets it up:
// grid (ceil(n / (lanes LC)), splits), clusters (1, splits), GW_THREADS
// threads, dynamic shared memory gemv_floats(lanes LC, min(ks, GW_XCH), G)
// floats.  xl: the x loader (rows [0, m)); ep: the epilogue.
template <typename XL, typename WL, bool GATED, typename EP>
__device__ __forceinline__ void gemv_cluster_body(XL xl, WL w, WL v, EP ep,
                                                  int m, int k, int n,
                                                  int lanes, int ks, int vec) {
  using XV = typename XL::V;
  constexpr int LC = WL::LC, G = GATED ? 2 : 1;
  constexpr int U = GATED && LC == 16 ? 4 : 8;   // rows in flight a k lane
  extern __shared__ float sm[];
  const int split = wg::cluster_rank(), splits = wg::cluster_blocks();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = 32 / lanes, klanes = GW_WARPS * per_warp;
  const int kl = warp * per_warp + lane / lanes;
  const int cols = lanes * LC, rn = GW_RB * cols;
  const int cb = blockIdx.x * cols, c = cb + lane % lanes * LC;
  const int k0 = split * ks, kn = min(ks, k - k0);
  const int xch = min(ks, GW_XCH);
  float* xs = sm;    // GW_RB x xch, then the warps' partials
  float* psum = sm + (GW_RB * xch > GW_WARPS * rn ? GW_RB * xch : GW_WARPS * rn);

  for (int r0 = 0; r0 < m; r0 += GW_RB) {
    float acc[GW_RB][LC], gacc[GATED ? GW_RB : 1][LC];
#pragma unroll
    for (int r = 0; r < GW_RB; ++r)
#pragma unroll
      for (int j = 0; j < LC; ++j) {
        acc[r][j] = 0.f;
        if constexpr (GATED) gacc[r][j] = 0.f;
      }
    for (int x0 = 0; x0 < kn; x0 += xch) {
      const int xn = min(xch, kn - x0);
      // Every value of the chunk is loaded (as the loader's V) before the
      // first store.
      XV xv[GW_RB][GW_XCH / GW_THREADS];
#pragma unroll
      for (int r = 0; r < GW_RB; ++r)
#pragma unroll
        for (int i = 0; i < GW_XCH / GW_THREADS; ++i) {
          const int kk = threadIdx.x + i * GW_THREADS;
          if (kk < xn && r0 + r < m) xv[r][i] = xl.at(r0 + r, k0 + x0 + kk);
        }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < GW_RB; ++r)
#pragma unroll
        for (int i = 0; i < GW_XCH / GW_THREADS; ++i) {
          const int kk = threadIdx.x + i * GW_THREADS;
          if (kk < xn) xs[r * xch + kk] = r0 + r < m ? XL::widen(xv[r][i]) : 0.f;
        }
      __syncthreads();
      if (c < n)
        for (int kb = kl; kb < xn; kb += U * klanes) {
          uint4 rw[U], rv[GATED ? U : 1];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int kk = kb + u * klanes;
            const size_t row = static_cast<size_t>(k0 + x0 + kk);
            rw[u] = kk < xn ? w.raw(row, c, n, vec) : make_uint4(0u, 0u, 0u, 0u);
            if constexpr (GATED)
              rv[u] = kk < xn ? v.raw(row, c, n, vec) : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int kk = kb + u * klanes;
            if (kk >= xn) break;
            float wf[LC], vf[GATED ? LC : 1];
#pragma unroll
            for (int j = 0; j < LC; ++j) {
              wf[j] = WL::widen(rw[u], j);
              if constexpr (GATED) vf[j] = WL::widen(rv[u], j);
            }
#pragma unroll
            for (int r = 0; r < GW_RB; ++r) {
              const float xr = xs[r * xch + kk];
#pragma unroll
              for (int j = 0; j < LC; ++j) {
                acc[r][j] = fmaf(xr, wf[j], acc[r][j]);
                if constexpr (GATED) gacc[r][j] = fmaf(xr, vf[j], gacc[r][j]);
              }
            }
          }
        }
    }

    // The k lanes of a warp, then the warps in order: psum[g][o], o = (r
    // LC + j) lanes + l for column cb + l LC + j of row r0 + r.
    for (int off = lanes; off < 32; off <<= 1)
#pragma unroll
      for (int r = 0; r < GW_RB; ++r)
#pragma unroll
        for (int j = 0; j < LC; ++j) {
          acc[r][j] += __shfl_xor_sync(0xFFFFFFFFu, acc[r][j], off);
          if constexpr (GATED)
            gacc[r][j] += __shfl_xor_sync(0xFFFFFFFFu, gacc[r][j], off);
        }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      __syncthreads();
      if (lane < lanes)
#pragma unroll
        for (int r = 0; r < GW_RB; ++r)
#pragma unroll
          for (int j = 0; j < LC; ++j)
            xs[warp * rn + (r * LC + j) * lanes + lane] = g ? gacc[r][j] : acc[r][j];
      __syncthreads();
      for (int o = threadIdx.x; o < rn; o += GW_THREADS) {
        float s = xs[o];
        for (int wi = 1; wi < GW_WARPS; ++wi) s += xs[wi * rn + o];
        psum[g * rn + o] = s;
      }
    }

    wg::cluster_sync();
    for (int o = split + splits * static_cast<int>(threadIdx.x); o < rn;
         o += splits * GW_THREADS) {
      float p[GW_MAX_SPLITS], pg[GATED ? GW_MAX_SPLITS : 1];
#pragma unroll
      for (int s = 0; s < GW_MAX_SPLITS; ++s)
        if (s < splits) {
          p[s] = wg::ld_rank(psum, o, s);
          if constexpr (GATED) pg[s] = wg::ld_rank(psum, rn + o, s);
        }
      float a = p[0], ga = GATED ? pg[0] : 0.f;
#pragma unroll
      for (int s = 1; s < GW_MAX_SPLITS; ++s)
        if (s < splits) {
          a += p[s];
          if constexpr (GATED) ga += pg[s];
        }
      const int r = o / (LC * lanes), j = o / lanes % LC, l = o % lanes;
      const int row = r0 + r, col = cb + l * LC + j;
      if (row < m && col < n) ep(row, col, a, ga);
    }
    wg::cluster_sync();   // no rank reads psum any more
  }
}

// Kernels 10 and 11's GEMV: x rows in T, out = epi(...) [* gate(...)].
template <typename T, typename WL, bool GATED>
__global__ void __launch_bounds__(GW_THREADS, 1) gemv_cluster_kernel(
    const T* __restrict__ x, WL w, const float* __restrict__ scale, WL v,
    const float* __restrict__ vscale, T* __restrict__ out, int m, int k,
    int n, int lanes, int ks, int vec, const float* __restrict__ tab, int nk) {
  gemv_cluster_body<RowX<T>, WL, GATED>(
      RowX<T>{x, k}, w, v, OutEpi<T, GATED>{scale, vscale, tab, nk, out, n}, m,
      k, n, lanes, ks, vec);
}

// The k rows a split takes: ceil(k / splits).
inline int gemv_ks(int k, int splits) { return (k + splits - 1) / splits; }

// Launches `kern` (gemv_cluster_kernel, or a kernel around
// gemv_cluster_body) with `args` as the body wants it: `lanes` lanes a
// column group (4 to 32, a power of two), `splits` blocks over k (1 to
// GW_MAX_SPLITS, none empty; args carry ks = gemv_ks(k, splits)) and loads
// of `vec` bytes (16, 8 or 0: element by element; the rows and the bases
// of w and v must allow them).  Returns the cudaError_t.
template <typename WL, bool GATED, typename... P, typename... A>
int launch_gemv(void (*kern)(P...), WL w, WL v, int k, int n, int lanes,
                int splits, int vec, cudaStream_t s, A... args) {
  const size_t row_bytes = static_cast<size_t>(n) * (16 / WL::LC);
  const auto aligned = [vec](const void* p) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % vec == 0;
  };
  if ((lanes != 4 && lanes != 8 && lanes != 16 && lanes != 32) || splits < 1 ||
      splits > GW_MAX_SPLITS || (vec != 0 && vec != 8 && vec != 16) ||
      (vec && (row_bytes % vec != 0 || !aligned(w.p) || !aligned(v.p))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ks = gemv_ks(k, splits);
  if ((splits - 1) * ks >= k) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = lanes * WL::LC;
  const size_t smem =
      gemv_floats(cols, ks < GW_XCH ? ks : GW_XCH, GATED ? 2 : 1) * sizeof(float);
  return static_cast<int>(wg::launch_cluster(
      kern, dim3((n + cols - 1) / cols, splits), dim3(GW_THREADS),
      dim3(1, splits, 1), smem, s, args...));
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

// The product on stream s: for m <= GEMV_M the cluster GEMV with `lanes`
// lanes a column group (4 to 32, a power of two), `splits` blocks over k
// (1 to GW_MAX_SPLITS, none empty) and loads of `vec` bytes (16, 8 or 0:
// element by element; the rows and bases must allow them); above it the
// tiled kernel (lanes, splits and vec unused).  Returns the cudaError_t.
template <typename T, typename WL, bool GATED>
int launch(const void* x, WL w, const float* scale, WL v, const float* vscale,
           void* out, int m, int k, int n, int lanes, int splits, int vec,
           const float* tab, int nk, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (m > GEMV_M) {
    const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
    tiled_kernel<T, WL, GATED><<<grid, T_THREADS, 0, s>>>(xt, w, scale, v, vscale,
                                                          ot, m, k, n, tab, nk);
    return static_cast<int>(cudaGetLastError());
  }
  const auto kern = gemv_cluster_kernel<T, WL, GATED>;
  return launch_gemv<WL, GATED>(kern, w, v, k, n, lanes, splits, vec, s, xt, w,
                                scale, v, vscale, ot, m, k, n, lanes,
                                gemv_ks(k, splits), vec, tab, nk);
}
}  // namespace gemm
