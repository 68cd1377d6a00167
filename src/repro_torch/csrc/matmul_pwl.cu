// ActiBA's drain-fused matrix product: the PWL activation applied to the
// fp32 sums before the output tile is written.
//
// Replaces the TPU kernel src/repro/kernels/matmul_pwl.py:69 matmul_pwl:
//
//   out = pwl(x @ w) [* (x @ v)]
//
// x (m, k) in T (float or bf16), w and v (k, n) row-major in the weight
// dtype W (float or bf16, widened exactly), out (m, n) in T; pwl is the
// table (common.cuh: pwl_eval), the gated form keeps two fp32 sums.  On
// recurrentgemma-2b's GeGLU MLP (k = 2560, n = 7680) it runs on every
// prefill, chunk and decode call under XambaConfig.pallas().
//
// The GEMV and SIMT bodies are qmatmul.cu's (gemm.cuh), on a bf16 / fp32
// weight loader and with no scale: at decode (m = slots <= 8) the cluster
// GEMV, one launch, bound by the weights' bytes (78.6 MB of bf16 wg + wi
// per call at m = 4: 8 bf16 columns a lane by 16-byte loads, 30 column
// tiles of 256 x 4 k splits = 120 blocks, one wave on the 132 SMs); at
// prefill (m = slots x chunk) fp32 operands take the 64 x 64 tiled
// product on the CUDA cores, bound by operations (2 m k n per weight).
// The TPU kernel's (256, 256, 512) blocks carried sums across the
// sequential k axis of its grid; here a GEMV cluster's blocks sum k slices
// that meet in distributed shared memory in rank order, and each tiled
// block walks all of k itself.
//
// The bf16 tiled body, matmul_pwl_wgmma_kernel (x, w and v all bf16, m >
// GEMV_M, k and n multiples of 8, 16-byte aligned bases: every model
// shape).  The same function as the SIMT body: bf16 x bf16 products are
// exact in fp32, so the tensor cores' fp32 sums differ from the plain
// version only in their order, as the SIMT body's do, and the epilogue
// takes pwl_eval's operations in its order and gemm.cuh's gate.  At
// recurrentgemma-2b's prefill (m = 512, k = 2560, n = 7680, gated) it is
// bound by operations (40.3 GFLOP at the bf16 tensor-core rate, 0.041
// ms).  Design: a 128 x 128 output tile per block, two consumer
// warpgroups of 64 rows, each issuing m64n128k16 wgmmas (two fp32
// accumulators of 64 registers when gated), and one producer warp; k in
// steps of 64 through a ring of 4 stages (x 16 KB, w 16 KB, v 16 KB) that
// the producer fills by TMA as fast as the consumers release them (a
// "full" and an "empty" mbarrier per stage, no block-wide barrier in the
// loop), while each consumer keeps one step's wgmmas in flight as it
// issues the next.  x is the K-major A operand, w and v the MN-major B
// operand straight from their row-major (k, n) layout: no copy on the
// host.  TMA zero-fills the ragged edges of m, n and k.  Blocks walk m
// fastest, so the m tiles of one weight tile run together and the weights
// are read from HBM about once.  Shapes TMA cannot read (k or n not a
// multiple of 8, a misaligned base) are routed to the SIMT body by the
// wrapper's shape rule and counted there: the first version stays simple,
// and no model path has such a shape.
#include "gemm.cuh"
#include "wgmma.cuh"

// A call's arguments in one block of 64-bit fields (kernels/matmul_pwl.py:
// _ARGS; as qmatmul.cu's QmmArgs): x (m, k) contiguous in `dtype` (0
// float, 1 bf16); w, v (k, n) contiguous in `wdtype` (0 float, 1 bf16; v
// null: the plain form); out (m, n) in x's dtype; lanes, splits, vec: the
// GEMV's column group, k splits and load bytes (gemm::launch; used when m
// <= 8); tab: the PWL table (2 nk + 2 fp32), not null.
struct MpwlArgs {
  int64_t dtype, wdtype;
  const void *x, *w, *v;
  void* out;
  int64_t m, k, n, lanes, splits, vec;
  const void* tab;
  int64_t nk;
  void* stream;
};

// m <= 8 runs the GEMV, else the SIMT tiled body.  Returns the
// cudaError_t.
extern "C" int matmul_pwl_launch(const MpwlArgs* a) {
  const int m = static_cast<int>(a->m), k = static_cast<int>(a->k),
            n = static_cast<int>(a->n);
  if (m == 0 || n == 0) return 0;
  if (k < 1 || a->tab == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  const float* tb = static_cast<const float*>(a->tab);
  const int nk = static_cast<int>(a->nk), lanes = static_cast<int>(a->lanes),
            splits = static_cast<int>(a->splits), vec = static_cast<int>(a->vec);
  const void* x = a->x;
  void* out = a->out;
  int err = 0;
  if (a->wdtype == 0) {
    const gemm::F32W wl{static_cast<const float*>(a->w)},
        vl{static_cast<const float*>(a->v)};
    DISPATCH_T(a->dtype, err = a->v ? gemm::launch<T, gemm::F32W, true>(
                                          x, wl, nullptr, vl, nullptr, out, m, k,
                                          n, lanes, splits, vec, tb, nk, s)
                                    : gemm::launch<T, gemm::F32W, false>(
                                          x, wl, nullptr, vl, nullptr, out, m, k,
                                          n, lanes, splits, vec, tb, nk, s));
  } else {
    const gemm::BF16W wl{static_cast<const __nv_bfloat16*>(a->w)},
        vl{static_cast<const __nv_bfloat16*>(a->v)};
    DISPATCH_T(a->dtype, err = a->v ? gemm::launch<T, gemm::BF16W, true>(
                                          x, wl, nullptr, vl, nullptr, out, m, k,
                                          n, lanes, splits, vec, tb, nk, s)
                                    : gemm::launch<T, gemm::BF16W, false>(
                                          x, wl, nullptr, vl, nullptr, out, m, k,
                                          n, lanes, splits, vec, tb, nk, s));
  }
  return err;
}

namespace {
constexpr int WM = 128, WN = 128, WK = 64;  // block tile and k step
constexpr int W_CONSUMERS = 256;            // two warpgroups
constexpr int W_THREADS = W_CONSUMERS + 32; // and the producer warp
constexpr int W_STAGES = 4;
constexpr int X_BYTES = WM * WK * 2;        // x tile, 128 rows x 128 bytes
constexpr int B_CHUNK = WK * 64 * 2;        // 64 k rows x 64 columns
constexpr int B_BYTES = WN / 64 * B_CHUNK;  // a w or v tile

template <bool GATED> __host__ __device__ constexpr int stage_bytes() {
  return X_BYTES + (GATED ? 2 : 1) * B_BYTES;
}
template <bool GATED> __host__ __device__ constexpr int wgmma_smem() {
  return W_STAGES * stage_bytes<GATED>() + 1024 + 2 * W_STAGES * 8;
}

// The producer: k tile kt of x, w (and v) into its stage.
template <bool GATED>
__device__ __forceinline__ void load_stage(uint8_t* tiles, uint64_t* full,
                                           const CUtensorMap* xm,
                                           const CUtensorMap* wm,
                                           const CUtensorMap* vm, int kt,
                                           int m0, int n0) {
  const int s = kt % W_STAGES;
  uint8_t* st = tiles + s * stage_bytes<GATED>();
  wg::bar_expect(&full[s], stage_bytes<GATED>());
  wg::tma_load_2d(st, xm, &full[s], kt * WK, m0);
#pragma unroll
  for (int c = 0; c < WN / 64; ++c) {
    wg::tma_load_2d(st + X_BYTES + c * B_CHUNK, wm, &full[s], n0 + 64 * c,
                    kt * WK);
    if constexpr (GATED)
      wg::tma_load_2d(st + X_BYTES + B_BYTES + c * B_CHUNK, vm, &full[s],
                      n0 + 64 * c, kt * WK);
  }
}
}  // namespace

// Grid (ceil(m / WM), ceil(n / WN)), W_THREADS threads, wgmma_smem<GATED>()
// bytes of dynamic shared memory.  out (m, n) bf16 row-major.
template <bool GATED>
__global__ void __launch_bounds__(W_THREADS, 1) matmul_pwl_wgmma_kernel(
    const __grid_constant__ CUtensorMap xm,
    const __grid_constant__ CUtensorMap wm,
    const __grid_constant__ CUtensorMap vm, __nv_bfloat16* __restrict__ out,
    int m, int k, int n, const float* __restrict__ tab, int nk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = wg::align1024(smem_raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(tiles + W_STAGES * stage_bytes<GATED>());
  uint64_t* empty = full + W_STAGES;
  const int tid = threadIdx.x, grp = tid / 128;
  const int m0 = blockIdx.x * WM, n0 = blockIdx.y * WN;
  const int kt_n = (k + WK - 1) / WK;

  if (tid == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      wg::bar_init(&full[s], 1);
      wg::bar_init(&empty[s], W_CONSUMERS / 128);
    }
    wg::fence_bar_init();
  }
  __syncthreads();

  if (tid >= W_CONSUMERS) {
    // The producer warp: one lane refills each stage once both consumer
    // warpgroups have released it.
    if (tid == W_CONSUMERS)
      for (int kt = 0; kt < kt_n; ++kt) {
        if (kt >= W_STAGES)
          wg::bar_wait(&empty[kt % W_STAGES], (kt / W_STAGES - 1) & 1);
        load_stage<GATED>(tiles, full, &xm, &wm, &vm, kt, m0, n0);
      }
    return;
  }

  float acc[WN / 2], gacc[WN / 2];
#pragma unroll
  for (int j = 0; j < WN / 2; ++j) acc[j] = gacc[j] = 0.f;

  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % W_STAGES;
    wg::bar_wait(&full[s], (kt / W_STAGES) & 1);
    const uint32_t xa =
        wg::smem_u32(tiles + s * stage_bytes<GATED>()) + grp * 64 * 128;
    const uint32_t wa =
        wg::smem_u32(tiles + s * stage_bytes<GATED>()) + X_BYTES;
    wg::pin(acc);
    if constexpr (GATED) wg::pin(gacc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      const uint64_t da = wg::desc(xa + kk * 32, 16, 1024, 128);
      wg::Mma<WN>::ss<1>(acc, da,
                         wg::desc(wa + kk * 16 * 128, B_CHUNK, 1024, 128));
      if constexpr (GATED)
        wg::Mma<WN>::ss<1>(
            gacc, da,
            wg::desc(wa + B_BYTES + kk * 16 * 128, B_CHUNK, 1024, 128));
    }
    wg::commit();
    // Step kt - 1's wgmmas are done: release its stage to the producer.
    wg::wait<1>();
    if (kt > 0 && tid % 128 == 0) wg::bar_arrive(&empty[(kt - 1) % W_STAGES]);
  }
  wg::wait<0>();
  wg::pin(acc);
  if constexpr (GATED) wg::pin(gacc);

  // The epilogue on the fragments: row 16 warp + lane / 4 (+ 8), columns
  // 8 i + 2 (lane % 4) + {0, 1}; n % 8 == 0, so a pair is in or out whole.
  // ActiBA's table takes pwl_eval's operations in its order element by
  // element (common.cuh), but with the knots in the outer loop over a
  // quarter of the fragment (16 elements) at a time, so that 16 chains of
  // dependent adds overlap: one element at a time, the epilogue takes
  // longer than the main loop.  A quarter, not a half, because ptxas
  // gives a 288-thread block 168 registers a thread, and a half spills.
  const int t = tid % 128, lane = t % 32;
  const int r0 = m0 + grp * 64 + (t / 32) * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
  const float slope = tab[2 * nk], icpt = tab[2 * nk + 1];
  constexpr int Q = WN / 8;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    float y[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j)
      y[j] = __fadd_rn(__fmul_rn(slope, acc[h * Q + j]), icpt);
    for (int kn = 0; kn < nk; ++kn) {
      const float knot = tab[kn], dm = tab[nk + kn];
#pragma unroll
      for (int j = 0; j < Q; ++j)
        y[j] = __fadd_rn(
            y[j], __fmul_rn(dm, fmaxf(__fsub_rn(acc[h * Q + j], knot), 0.f)));
    }
#pragma unroll
    for (int j = 0; j < Q; j += 2) {
      const int e = h * Q + j;
      const int r = r0 + 8 * ((e / 2) % 2), c = c0 + 8 * (e / 4);
      if (r >= m || c >= n) continue;
      float y0 = y[j], y1 = y[j + 1];
      if constexpr (GATED) {
        y0 = gemm::gate(y0, gacc[e], nullptr, c);
        y1 = gemm::gate(y1, gacc[e + 1], nullptr, c + 1);
      }
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r) * n +
                                         c) = __floats2bfloat162_rn(y0, y1);
    }
  }
}

template <bool GATED>
static int launch_wgmma(const CUtensorMap& xm, const CUtensorMap& wm,
                        const CUtensorMap& vm, void* out, int m, int k, int n,
                        const float* tab, int nk, cudaStream_t s) {
  const int smem = wgmma_smem<GATED>();
  cudaError_t err = cudaFuncSetAttribute(
      matmul_pwl_wgmma_kernel<GATED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + WM - 1) / WM, (n + WN - 1) / WN);
  matmul_pwl_wgmma_kernel<GATED><<<grid, W_THREADS, smem, s>>>(
      xm, wm, vm, static_cast<__nv_bfloat16*>(out), m, k, n, tab, nk);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 tiled body: x (m, k), w and v (k, n) contiguous bf16 (v null:
// the plain form), out (m, n) bf16; k % 8 == 0, n % 8 == 0 and every base
// 16-byte aligned (TMA's rule; the wrapper routes other shapes to
// matmul_pwl_launch).  tab: the PWL table (2 nk + 2 fp32).  Returns the
// cudaError_t (cudaErrorInvalidValue when a tensor map is refused).
extern "C" int matmul_pwl_wgmma_launch(const void* x, const void* w,
                                       const void* v, void* out, int m,
                                       int k, int n, const void* tab, int nk,
                                       void* stream) {
  if (m == 0 || n == 0) return 0;
  if (k < 1 || k % 8 != 0 || n % 8 != 0 || tab == nullptr ||
      (n + WN - 1) / WN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(k),
                            static_cast<cuuint64_t>(m)};
  const cuuint64_t xs[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t xb[2] = {WK, WM};
  const cuuint64_t wd[2] = {static_cast<cuuint64_t>(n),
                            static_cast<cuuint64_t>(k)};
  const cuuint64_t ws[1] = {static_cast<cuuint64_t>(n) * 2};
  const cuuint32_t wb[2] = {64, WK};
  CUtensorMap xm, wm, vm;
  if (!wg::make_map(&xm, x, 2, xd, xs, xb, 128) ||
      !wg::make_map(&wm, w, 2, wd, ws, wb, 128) ||
      !wg::make_map(&vm, v ? v : w, 2, wd, ws, wb, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tb = static_cast<const float*>(tab);
  return v ? launch_wgmma<true>(xm, wm, vm, out, m, k, n, tb, nk, s)
           : launch_wgmma<false>(xm, wm, vm, out, m, k, n, tb, nk, s);
}

// Bytes of dynamic shared memory the bf16 body's launch asks for.
extern "C" int matmul_pwl_wgmma_smem(int gated) {
  return gated ? wgmma_smem<true>() : wgmma_smem<false>();
}
