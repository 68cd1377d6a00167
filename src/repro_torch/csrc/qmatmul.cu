// W8 dequant-matmul: int8 weights widened in the kernel, the per-channel
// scale applied once to the fp32 sums.
//
// Replaces the TPU kernel src/repro/kernels/qmatmul.py:85 qmatmul:
//
//   out = epi((x @ q) * scale) [* ((x @ qv) * vscale)]
//
// x (m, k) in T (float or bf16), q and qv (k, n) int8 row-major, scale and
// vscale (n,) fp32, out (m, n) in T.  epi is ActiBA's PWL table
// (common.cuh: pwl_eval; the same fp32 device table kernel 12 reads) or
// the identity for a null table.  The sums are fp32; the scale multiplies
// them once, as in the TPU kernel's drain, and the epilogue's multiplies
// are rounded one by one (__fmul_rn), as kernels/qmatmul.py:
// qmatmul_plain takes them, so kernel and plain version differ only in
// the order of their sums.  int8 -> fp32 widening is exact.
//
// Two regimes, two kernels:
//
// * m <= GEMV_M (decode, m = slots): a GEMV that reads the int8 weight
//   once, bound by its bytes (k*n; 2.6 MB for mamba2-130m's in_proj).
//   A block takes 128 columns (four per thread, one 4-byte load per row
//   where n allows) and a slice of k; its 8 warps split the slice by rows
//   and sum their partials in shared memory in warp order.  At n = 3352
//   the 27 column tiles alone fill few of the 132 SMs, so k is split over
//   blocks too (the wrapper picks the split count from the shapes).  The
//   splits write fp32 partials and a second kernel sums them in split
//   order: no float atomics, so the same inputs give the same bits on
//   every run.  One split writes the output directly.
// * m > GEMV_M (prefill, m = slots x chunk): a tiled product, 64 x 64
//   outputs per block over k in steps of 32, the x tile and the widened
//   int8 tile in shared memory, 4 x 4 outputs per thread on the CUDA
//   cores.  Bound by operations (2 m k n) at fp32 CUDA-core rate; the
//   int8 -> bf16 widening is exact too (|q| <= 127), so a later version
//   can feed bf16 tensor cores (wgmma) and compute the same function.
//
// Ragged edges (n = 3352 is no multiple of a tile) are masked in the
// kernels; nothing is padded on the host.
#include <cstdint>

#include "common.cuh"

namespace {
constexpr int GEMV_M = 8;      // rows the GEMV path takes
constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_COLS = 128;   // columns per GEMV block (4 per lane)
constexpr int GV_MAX_KS = 1024;  // k rows per split (x slice in smem)
constexpr int GV_SMEM = GEMV_M * GV_COLS * GV_WARPS;  // floats

constexpr int TM = 64, TN = 64, TK = 32, T_THREADS = 256;

// The epilogue: scale, activation, gate (each multiply rounded alone).
__device__ __forceinline__ float qmm_epi(float acc, float s, const float* tab,
                                         int nk) {
  const float y = __fmul_rn(acc, s);
  return tab ? pwl_eval(y, tab, nk) : y;
}

// Four consecutive int8 weights of row `row` from column c, widened; zero
// past n.  vec4: n % 4 == 0 and q 4-byte aligned, so one 4-byte load.
__device__ __forceinline__ void load4(const int8_t* __restrict__ q, size_t row,
                                      int c, int n, bool vec4, float (&w)[4]) {
  const int8_t* p = q + row * n + c;
  if (vec4 && c + 3 < n) {
    const char4 v = *reinterpret_cast<const char4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = c + j < n ? static_cast<float>(p[j]) : 0.f;
  }
}
}  // namespace

// Grid (ceil(n / 128), splits); dynamic shared memory GV_SMEM floats.
// partial == nullptr: one split, write out.  Else write the fp32 sums of
// split s to partial[(s * G + g) * m * n + r * n + c], g = 0 for q and 1
// for qv (G = 2 when gated, else 1).
template <typename T, bool GATED>
__global__ void __launch_bounds__(GV_THREADS) qmm_gemv_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, const int8_t* __restrict__ qv,
    const float* __restrict__ vscale, T* __restrict__ out,
    float* __restrict__ partial, int m, int k, int n, int ks, bool vec4,
    const float* __restrict__ tab, int nk) {
  extern __shared__ float sm[];
  const int split = blockIdx.y;
  const int k0 = split * ks;
  const int kn = min(ks, k - k0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cb = blockIdx.x * GV_COLS;
  const int c0 = cb + lane * 4;

  for (int e = threadIdx.x; e < m * kn; e += GV_THREADS) {
    const int r = e / kn, kk = e % kn;
    sm[r * kn + kk] = to_f(x[static_cast<size_t>(r) * k + k0 + kk]);
  }
  __syncthreads();

  float acc[GEMV_M][4], gacc[GEMV_M][4];
#pragma unroll
  for (int r = 0; r < GEMV_M; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = gacc[r][j] = 0.f;

#pragma unroll 4
  for (int kk = warp; kk < kn; kk += GV_WARPS) {
    float w[4], v[4];
    load4(q, static_cast<size_t>(k0 + kk), c0, n, vec4, w);
    if (GATED) load4(qv, static_cast<size_t>(k0 + kk), c0, n, vec4, v);
#pragma unroll
    for (int r = 0; r < GEMV_M; ++r) {
      if (r < m) {
        const float xv = sm[r * kn + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[r][j] += xv * w[j];
          if (GATED) gacc[r][j] += xv * v[j];
        }
      }
    }
  }

  // Sum the warps' partials in warp order: each thread then owns
  // GEMV_M * GV_COLS / GV_THREADS (row, column) outputs.
  constexpr int OWN = GEMV_M * GV_COLS / GV_THREADS;
  float tot[OWN], gtot[OWN];
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
    for (int i = 0; i < OWN; ++i) {
      const int o = threadIdx.x + i * GV_THREADS;
      const int r = o / GV_COLS, cl = o % GV_COLS;
      float s = 0.f;
      for (int w = 0; w < GV_WARPS; ++w) s += sm[(w * GEMV_M + r) * GV_COLS + cl];
      if (pass)
        gtot[i] = s;
      else
        tot[i] = s;
    }
  }

#pragma unroll
  for (int i = 0; i < OWN; ++i) {
    const int o = threadIdx.x + i * GV_THREADS;
    const int r = o / GV_COLS, c = cb + o % GV_COLS;
    if (r >= m || c >= n) continue;
    const size_t idx = static_cast<size_t>(r) * n + c;
    if (partial == nullptr) {
      float y = qmm_epi(tot[i], scale[c], tab, nk);
      if (GATED) y = __fmul_rn(y, __fmul_rn(gtot[i], vscale[c]));
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
__global__ void qmm_drain_kernel(const float* __restrict__ partial, int splits,
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
  float y = qmm_epi(a, scale[c], tab, nk);
  if (GATED) y = __fmul_rn(y, __fmul_rn(g, vscale[c]));
  out[idx] = from_f<T>(y);
}

// Grid (ceil(n / TN), ceil(m / TM)), T_THREADS threads.  Thread (ty, tx)
// owns rows ty + 16 i and columns tx + 16 j (i, j < 4) of the block's
// tile, so neighbouring threads read neighbouring shared words.
template <typename T, bool GATED>
__global__ void __launch_bounds__(T_THREADS) qmm_tiled_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, const int8_t* __restrict__ qv,
    const float* __restrict__ vscale, T* __restrict__ out, int m, int k, int n,
    const float* __restrict__ tab, int nk) {
  __shared__ float As[TK][TM + 1];   // x tile, transposed
  __shared__ float Bs[TK][TN];       // widened q tile
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
      Bs[kk][c] = in ? static_cast<float>(q[off]) : 0.f;
      if (GATED) Vs[kk][c] = in ? static_cast<float>(qv[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = Bs[kk][tx + 16 * j];
        if (GATED) v[j] = Vs[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += a[i] * b[j];
          if (GATED) gacc[i][j] += a[i] * v[j];
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
      float y = qmm_epi(acc[i][j], scale[c], tab, nk);
      if (GATED) y = __fmul_rn(y, __fmul_rn(gacc[i][j], vscale[c]));
      out[static_cast<size_t>(r) * n + c] = from_f<T>(y);
    }
  }
}

template <typename T, bool GATED>
static int launch(const void* x, const void* q, const void* scale,
                  const void* qv, const void* vscale, void* out, void* partial,
                  int m, int k, int n, int splits, int vec4, const float* tab,
                  int nk, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const int8_t* qvt = static_cast<const int8_t*>(qv);
  const float* st = static_cast<const float*>(scale);
  const float* vst = static_cast<const float*>(vscale);
  T* ot = static_cast<T*>(out);
  if (m <= GEMV_M) {
    const int ks = (k + splits - 1) / splits;
    if (ks > GV_MAX_KS || (splits > 1 && partial == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n + GV_COLS - 1) / GV_COLS, splits);
    float* pt = splits > 1 ? static_cast<float*>(partial) : nullptr;
    qmm_gemv_kernel<T, GATED><<<grid, GV_THREADS, GV_SMEM * sizeof(float), s>>>(
        xt, qt, st, qvt, vst, ot, pt, m, k, n, ks, vec4 != 0, tab, nk);
    if (splits > 1) {
      const int err = static_cast<int>(cudaGetLastError());
      if (err) return err;
      const size_t mn = static_cast<size_t>(m) * n;
      qmm_drain_kernel<T, GATED><<<static_cast<unsigned>((mn + 255) / 256), 256,
                                   0, s>>>(pt, splits, st, vst, ot, m, n, tab, nk);
    }
  } else {
    const dim3 grid((n + TN - 1) / TN, (m + TM - 1) / TM);
    qmm_tiled_kernel<T, GATED><<<grid, T_THREADS, 0, s>>>(xt, qt, st, qvt, vst, ot,
                                                          m, k, n, tab, nk);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (m, k) contiguous in the dtype `dtype` (0 float, 1 bf16); q, qv (k, n)
// contiguous int8 (qv null: the plain form); scale, vscale (n,) fp32;
// out (m, n) in x's dtype; partial: splits * (qv ? 2 : 1) * m * n fp32
// scratch when m <= 8 and splits > 1 (else unused); vec4: n % 4 == 0 and
// q, qv 4-byte aligned; tab: the PWL table (2 nk + 2 fp32) or null.
// Returns the cudaError_t.
extern "C" int qmatmul_launch(int dtype, const void* x, const void* q,
                              const void* scale, const void* qv,
                              const void* vscale, void* out, void* partial,
                              int m, int k, int n, int splits, int vec4,
                              const void* tab, int nk, void* stream) {
  if (m == 0 || n == 0) return 0;
  if (k < 1 || splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tb = static_cast<const float*>(tab);
  int err = 0;
  DISPATCH_T(dtype, err = qv ? launch<T, true>(x, q, scale, qv, vscale, out,
                                               partial, m, k, n, splits, vec4,
                                               tb, nk, s)
                             : launch<T, false>(x, q, scale, qv, vscale, out,
                                                partial, m, k, n, splits, vec4,
                                                tb, nk, s));
  return err;
}
