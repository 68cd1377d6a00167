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
// the order of their sums.  int8 -> fp32 and int8 -> bf16 widening are
// exact (|q| <= 128), and bf16 x bf16 products are exact in fp32.
//
// Three bodies; the wrapper's path() picks one from dtypes, shapes and
// alignment alone:
//
// * "gemv", m <= 8 (decode, m = slots): gemm.cuh's cluster GEMV on the
//   int8 loader (gemm::I8W), one launch, bound by the weight's bytes (k n;
//   2.6 MB at mamba2-130m's in_proj).  16 int8 columns a lane, by one
//   16-byte load where n % 16 == 0, else two of 8 bytes: mamba2-130m's
//   in_proj rows (n = 3352) are only 8-byte aligned.
// * "wgmma", bf16 x with m > 8, k % 8 == n % 8 == 0 and aligned bases
//   (prefill, m = slots x chunk): qmatmul_wgmma_kernel below, on the bf16
//   tensor cores, bound by operations (2 m k n at the bf16 rate).
// * "tiled", the rest (fp32 x, which keeps its CUDA-core arithmetic
//   because TF32 misses the 1e-4 limit, and shapes the wgmma body cannot
//   read): gemm.cuh's 64 x 64 SIMT tiled product.
//
// qmatmul_wgmma_kernel.  A block takes 64 rows x 128 columns, one
// warpgroup of m64n128k16 wgmmas (two fp32 accumulators of 64 registers
// when gated), k in steps of 64 through a ring of 4 stages.  x is the
// K-major A operand, loaded by TMA as kernel 11's x is.  The int8 weight
// cannot come by TMA: at n = 3352 its rows are 3352 bytes apart, and TMA
// takes only strides that are multiples of 16 bytes.  So the block's own
// threads copy the int8 rows with 8-byte asynchronous copies (cp.async,
// zero past k and n) into a raw stage three steps ahead, and at each step
// widen their own bytes to bf16 and store them where TMA would have put a
// bf16 tile: the 128-byte-swizzled MN-major layout that kernel 11's B
// descriptor reads (wgmma's transpose bit), so the weight needs no copy on
// the host.  No producer warp: the one warpgroup widens its next stage
// itself (the widening is a few instructions a byte and the wgmmas run
// asynchronously meanwhile), which keeps 128 threads a block and two
// blocks an SM.  The widened stores are generic-proxy writes that wgmma
// (the async proxy) reads, so each writer issues fence.proxy.async before
// the block's barrier.  Where the output tiles do not fill the 132 SMs
// (out_proj at n = 768: 4 x 6 tiles at m = 256) k is split over the blocks
// of a cluster along z; their fp32 accumulators meet in distributed
// shared memory and rank s adds up, in rank order, the fragment pairs p =
// s (mod splits) and writes them.  The split count is a pure function of
// (m, k, n) (kernels/qmatmul.py: wgmma_splits): the same bits every call.
#include "gemm.cuh"
#include "wgmma.cuh"

// A call's arguments, packed by the wrapper into one block of 64-bit
// fields (kernels/qmatmul.py: _ARGS), so that the call crosses ctypes as
// one pointer: the decode path makes 48 of these calls a step, and
// converting sixteen arguments one by one is host time on that path.
// x (m, k) contiguous in the dtype `dtype` (0 float, 1 bf16); q, qv (k, n)
// contiguous int8 (qv null: the plain form); scale, vscale (n,) fp32;
// out (m, n) in x's dtype; lanes, splits, vec: the GEMV's column group,
// k splits and load bytes (gemm::launch), or the wgmma body's k splits;
// tab: the PWL table (2 nk + 2 fp32) or null.
struct QmmArgs {
  int64_t dtype;
  const void *x, *q, *scale, *qv, *vscale;
  void* out;
  int64_t m, k, n, lanes, splits, vec;
  const void* tab;
  int64_t nk;
  void* stream;
};

// m <= 8 runs the GEMV, else the SIMT tiled body.  Returns the
// cudaError_t.
extern "C" int qmatmul_launch(const QmmArgs* a) {
  const int m = static_cast<int>(a->m), k = static_cast<int>(a->k),
            n = static_cast<int>(a->n);
  if (m == 0 || n == 0) return 0;
  if (k < 1 || a->scale == nullptr || (a->qv != nullptr) != (a->vscale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  const float* tb = static_cast<const float*>(a->tab);
  const int nk = static_cast<int>(a->nk), lanes = static_cast<int>(a->lanes),
            splits = static_cast<int>(a->splits), vec = static_cast<int>(a->vec);
  const gemm::I8W w{static_cast<const int8_t*>(a->q)},
      v{static_cast<const int8_t*>(a->qv)};
  const float* st = static_cast<const float*>(a->scale);
  const float* vst = static_cast<const float*>(a->vscale);
  int err = 0;
  DISPATCH_T(a->dtype, err = a->qv ? gemm::launch<T, gemm::I8W, true>(
                                         a->x, w, st, v, vst, a->out, m, k, n,
                                         lanes, splits, vec, tb, nk, s)
                                   : gemm::launch<T, gemm::I8W, false>(
                                         a->x, w, st, v, vst, a->out, m, k, n,
                                         lanes, splits, vec, tb, nk, s));
  return err;
}

namespace {
constexpr int QM = 64, QN = 128, QK = 64;     // block tile and k step
constexpr int Q_THREADS = 128;                // one warpgroup
constexpr int Q_STAGES = 4;                   // x and int8 tiles in flight
constexpr int Q_MAX_SPLITS = 8;               // blocks of a cluster
constexpr int Q_BATCH = 4;                    // pairs an epilogue pass takes
constexpr int QX_BYTES = QM * QK * 2;         // x tile, 64 rows x 128 bytes
constexpr int QB_CHUNK = QK * 64 * 2;         // 64 k rows x 64 bf16 columns
constexpr int QB_BYTES = QN / 64 * QB_CHUNK;  // a widened weight tile
constexpr int QR_BYTES = QK * QN;             // an int8 weight tile
constexpr int Q_CHUNKS = QK * QN / 8;         // its 8-byte pieces

// Shared memory: Q_STAGES x tiles, two widened tiles (per weight), the
// raw int8 ring (per weight), the x barriers; 1024 bytes of alignment.
template <bool GATED> __host__ __device__ constexpr int q_smem() {
  return Q_STAGES * QX_BYTES + (GATED ? 2 : 1) * (2 * QB_BYTES + Q_STAGES * QR_BYTES) +
         Q_STAGES * 8 + 1024;
}

// 8 bytes from global to shared memory, asynchronously; zeros when !in.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   wg::smem_u32(dst)),
               "l"(src), "r"(in ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Eight int8 as eight bf16 (exact), the first in the low half.
__device__ __forceinline__ uint4 widen8(uint2 r) {
  const uint4 u = make_uint4(r.x, r.y, 0u, 0u);
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = wg::pack_bf16(gemm::I8W::widen(u, 2 * i), gemm::I8W::widen(u, 2 * i + 1));
  return make_uint4(o[0], o[1], o[2], o[3]);
}
}  // namespace

// Grid (ceil(m / QM), ceil(n / QN), splits), clusters (1, 1, splits),
// Q_THREADS threads, q_smem<GATED>() bytes of dynamic shared memory; a
// split takes `steps` k steps of QK.  out (m, n) bf16 row-major.
template <bool GATED>
__global__ void __launch_bounds__(Q_THREADS, 1) qmatmul_wgmma_kernel(
    const __grid_constant__ CUtensorMap xm, const int8_t* __restrict__ q,
    const float* __restrict__ scale, const int8_t* __restrict__ qv,
    const float* __restrict__ vscale, __nv_bfloat16* __restrict__ out, int m,
    int k, int n, int steps, const float* __restrict__ tab, int nk) {
  constexpr int G = GATED ? 2 : 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = wg::align1024(smem_raw);
  uint8_t* bs = xs + Q_STAGES * QX_BYTES;
  int8_t* rs = reinterpret_cast<int8_t*>(bs + 2 * G * QB_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(rs + Q_STAGES * G * QR_BYTES);
  const int split = wg::cluster_rank(), splits = wg::cluster_blocks();
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * QM, n0 = blockIdx.y * QN;
  const int kt0 = split * steps;
  const int kt_n = min(steps, (k + QK - 1) / QK - kt0);

  if (tid == 0) {
    for (int s = 0; s < Q_STAGES; ++s) wg::bar_init(&full[s], 1);
    wg::fence_bar_init();
  }
  __syncthreads();

  // Step i of this split into stage i % Q_STAGES: x by TMA (one thread),
  // the int8 rows by every thread, 8 pieces each.  One copy group a step,
  // empty past the split's end, so the group count stays in step.
  const auto issue = [&](int i) {
    if (i < kt_n) {
      const int s = i % Q_STAGES, kt = kt0 + i;
      if (tid == 0) {
        wg::bar_expect(&full[s], QX_BYTES);
        wg::tma_load_2d(xs + s * QX_BYTES, &xm, &full[s], kt * QK, m0);
      }
#pragma unroll
      for (int p = 0; p < Q_CHUNKS / Q_THREADS; ++p) {
        const int e = tid + p * Q_THREADS, kr = e / (QN / 8), cc = e % (QN / 8);
        const int gk = kt * QK + kr, gc = n0 + cc * 8;
        const bool in = gk < k && gc < n;
        const size_t off = in ? static_cast<size_t>(gk) * n + gc : 0;
        int8_t* d = rs + s * G * QR_BYTES + kr * QN + cc * 8;
        cp_async8(d, q + off, in);
        if constexpr (GATED) cp_async8(d + QR_BYTES, qv + off, in);
      }
    }
    cp_commit();
  };

  for (int i = 0; i < Q_STAGES - 1; ++i) issue(i);

  float acc[QN / 2], gacc[GATED ? QN / 2 : 1];
#pragma unroll
  for (int j = 0; j < QN / 2; ++j) {
    acc[j] = 0.f;
    if constexpr (GATED) gacc[j] = 0.f;
  }

  for (int i = 0; i < kt_n; ++i) {
    const int s = i % Q_STAGES, b = i % 2;
    // This thread's int8 pieces of step i have landed: widen them into
    // tile b where TMA would put them (row kr at kr * 128 bytes of its
    // 64-column chunk, 16-byte piece p at p ^ (kr % 8)).
    cp_wait<Q_STAGES - 2>();
#pragma unroll
    for (int p = 0; p < Q_CHUNKS / Q_THREADS; ++p) {
      const int e = tid + p * Q_THREADS, kr = e / (QN / 8), cc = e % (QN / 8);
      const int off = (cc / 8) * QB_CHUNK + kr * 128 + (((cc % 8) ^ (kr % 8)) << 4);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const uint2 r8 = *reinterpret_cast<const uint2*>(
            rs + (s * G + g) * QR_BYTES + kr * QN + cc * 8);
        *reinterpret_cast<uint4*>(bs + (b * G + g) * QB_BYTES + off) = widen8(r8);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    wg::bar_wait(&full[s], (i / Q_STAGES) & 1);
    const uint32_t xa = wg::smem_u32(xs + s * QX_BYTES);
    const uint32_t ba = wg::smem_u32(bs + b * G * QB_BYTES);
    wg::pin(acc);
    if constexpr (GATED) wg::pin(gacc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < QK / 16; ++kk) {
      const uint64_t da = wg::desc(xa + kk * 32, 16, 1024, 128);
      wg::Mma<QN>::ss<1>(acc, da, wg::desc(ba + kk * 16 * 128, QB_CHUNK, 1024, 128));
      if constexpr (GATED)
        wg::Mma<QN>::ss<1>(gacc, da,
                           wg::desc(ba + QB_BYTES + kk * 16 * 128, QB_CHUNK, 1024, 128));
    }
    wg::commit();
    // Step i - 1's wgmmas are done in every warp: its x stage, widened
    // tile and raw stage are free for step i + 3 (and tile b ^ 1 for i + 1).
    wg::wait<1>();
    __syncthreads();
    issue(i + Q_STAGES - 1);
  }
  wg::wait<0>();
  wg::pin(acc);
  if constexpr (GATED) wg::pin(gacc);

  // Every rank's fragments into its shared memory, over the x and
  // widened tiles that no wgmma reads any more (element j of thread t at
  // j * Q_THREADS + t).  Rank s then finishes the fragment pairs p = s
  // (mod splits) of every thread: each element summed over the ranks in
  // rank order, Q_BATCH pairs' loads in flight at once; then the scale,
  // ActiBA's table with the knots in the outer loop over the batch
  // (pwl_eval's operations for each element, in its order, as kernel 11's
  // epilogue takes them) and the gate.  Fragment element j of thread t is
  // row 16 (t / 32) + (t % 32) / 4 + 8 ((j / 2) % 2), column 8 (j / 4) +
  // 2 (t % 4) + j % 2; n % 8 == 0, so a pair is in or out whole.
  float* part = reinterpret_cast<float*>(xs);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < QN / 2; ++j) {
    part[j * Q_THREADS + tid] = acc[j];
    if constexpr (GATED) part[(QN / 2 + j) * Q_THREADS + tid] = gacc[j];
  }
  wg::cluster_sync();
  const int lane = tid % 32;
  const int r0 = m0 + (tid / 32) * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
  for (int p0 = split; p0 < QN / 4; p0 += Q_BATCH * splits) {
    float s[Q_BATCH][Q_MAX_SPLITS][2], sg[GATED ? Q_BATCH : 1][Q_MAX_SPLITS][2];
#pragma unroll
    for (int u = 0; u < Q_BATCH; ++u)
#pragma unroll
      for (int r = 0; r < Q_MAX_SPLITS; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * (p0 + u * splits) + h;
          const bool in = j < QN / 2 && r < splits;
          s[u][r][h] = in ? wg::ld_rank(part, j * Q_THREADS + tid, r) : 0.f;
          if constexpr (GATED)
            sg[u][r][h] = in ? wg::ld_rank(part, (QN / 2 + j) * Q_THREADS + tid, r) : 0.f;
        }
    float y[2 * Q_BATCH], g[GATED ? 2 * Q_BATCH : 1];
#pragma unroll
    for (int u = 0; u < Q_BATCH; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float a = s[u][0][h], ga = GATED ? sg[u][0][h] : 0.f;
#pragma unroll
        for (int r = 1; r < Q_MAX_SPLITS; ++r)
          if (r < splits) {
            a += s[u][r][h];
            if constexpr (GATED) ga += sg[u][r][h];
          }
        const int c = c0 + 8 * ((p0 + u * splits) / 2) + h;
        y[2 * u + h] = __fmul_rn(a, c < n ? scale[c] : 0.f);
        if constexpr (GATED) g[2 * u + h] = ga;
      }
    if (tab != nullptr) {
      const float slope = tab[2 * nk], icpt = tab[2 * nk + 1];
      float z[2 * Q_BATCH];
#pragma unroll
      for (int e = 0; e < 2 * Q_BATCH; ++e) z[e] = __fadd_rn(__fmul_rn(slope, y[e]), icpt);
      for (int kn = 0; kn < nk; ++kn) {
        const float knot = tab[kn], dm = tab[nk + kn];
#pragma unroll
        for (int e = 0; e < 2 * Q_BATCH; ++e)
          z[e] = __fadd_rn(z[e], __fmul_rn(dm, fmaxf(__fsub_rn(y[e], knot), 0.f)));
      }
#pragma unroll
      for (int e = 0; e < 2 * Q_BATCH; ++e) y[e] = z[e];
    }
#pragma unroll
    for (int u = 0; u < Q_BATCH; ++u) {
      const int p = p0 + u * splits;
      const int r = r0 + 8 * (p % 2), c = c0 + 8 * (p / 2);
      if (p >= QN / 4 || r >= m || c >= n) continue;
      float y0 = y[2 * u], y1 = y[2 * u + 1];
      if constexpr (GATED) {
        y0 = gemm::gate(y0, g[2 * u], vscale, c);
        y1 = gemm::gate(y1, g[2 * u + 1], vscale, c + 1);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r) * n + c) =
          __floats2bfloat162_rn(y0, y1);
    }
  }
  wg::cluster_sync();   // no rank reads these fragments any more
}

template <bool GATED>
static int launch_wgmma(const CUtensorMap& xm, const int8_t* q,
                        const float* scale, const int8_t* qv,
                        const float* vscale, void* out, int m, int k, int n,
                        int splits, int steps, const float* tab, int nk,
                        cudaStream_t s) {
  return static_cast<int>(wg::launch_cluster(
      qmatmul_wgmma_kernel<GATED>,
      dim3((m + QM - 1) / QM, (n + QN - 1) / QN, splits), dim3(Q_THREADS),
      dim3(1, 1, splits), q_smem<GATED>(), s, xm, q, scale, qv, vscale,
      static_cast<__nv_bfloat16*>(out), m, k, n, steps, tab, nk));
}

// The bf16 tensor-core body (QmmArgs; lanes and vec unused): x (m, k)
// bf16 with a 16-byte aligned base, q, qv with 8-byte aligned bases, out
// bf16; k % 8 == 0 (x's TMA stride) and n % 8 == 0 (8-byte int8 pieces);
// splits: k splits, 1 to 8, none empty.  Returns the cudaError_t
// (cudaErrorInvalidValue when the shapes or the tensor map are refused).
extern "C" int qmatmul_wgmma_launch(const QmmArgs* a) {
  const int m = static_cast<int>(a->m), k = static_cast<int>(a->k),
            n = static_cast<int>(a->n), splits = static_cast<int>(a->splits);
  if (m == 0 || n == 0) return 0;
  const int kt = (k + QK - 1) / QK;
  const auto a8 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 8 == 0;
  };
  if (a->dtype != 1 || k < 1 || k % 8 != 0 || n % 8 != 0 ||
      a->scale == nullptr || (a->qv != nullptr) != (a->vscale != nullptr) ||
      !a8(a->q) || !a8(a->qv) || splits < 1 || splits > Q_MAX_SPLITS ||
      (n + QN - 1) / QN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int steps = (kt + splits - 1) / splits;
  if ((splits - 1) * steps >= kt) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(k),
                            static_cast<cuuint64_t>(m)};
  const cuuint64_t xst[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t xb[2] = {QK, QM};
  CUtensorMap xm;
  if (!wg::make_map(&xm, a->x, 2, xd, xst, xb, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  const int8_t* qt = static_cast<const int8_t*>(a->q);
  const int8_t* qvt = static_cast<const int8_t*>(a->qv);
  const float* st = static_cast<const float*>(a->scale);
  const float* vst = static_cast<const float*>(a->vscale);
  const float* tb = static_cast<const float*>(a->tab);
  const int nk = static_cast<int>(a->nk);
  return a->qv ? launch_wgmma<true>(xm, qt, st, qvt, vst, a->out, m, k, n,
                                    splits, steps, tb, nk, s)
               : launch_wgmma<false>(xm, qt, st, qvt, vst, a->out, m, k, n,
                                     splits, steps, tb, nk, s);
}

// Bytes of dynamic shared memory the bf16 body's launch asks for.
extern "C" int qmatmul_wgmma_smem(int gated) {
  return gated ? q_smem<true>() : q_smem<false>();
}
