// Fused Mamba-1 single-token step and the bare selective-scan update.
//
// mamba1_step replaces the TPU kernel src/repro/kernels/decode_step.py:221
// mamba1_step: conv-tail shift + bias, SiLU, xs @ x_proj -> (dt_low, B, C),
// softplus(dt_low @ dt_proj + b), the selective-scan update
//   s' = s * exp(dt A) + (dt u) B,   y = s' . C + D u,
// and the SiLU(z) gate.  sscan_step (kernel 4) replaces decode_step.py:113
// sscan_step, the update alone: bound by bytes, the fp32 state read and
// written once and A read once (0.89 MB at b = 4, mamba-130m's width:
// 0.0003 ms), so what the card spends is a launch and one round trip to
// memory.  It is kernel 5's state stream with nothing around it
// (chan_update / chan_sum below, shared by both): four threads a channel,
// its first 16-byte state and A loads issued before anything else, y over
// n met by shuffles in a fixed order; the element by element path of the
// same kernel for n % 4 != 0 or a base that is not 16-byte aligned; b d /
// 32 blocks of 128 threads (192 at b = 4, d = 1536: one wave).
//
// Bound: bytes.  Per call the fp32 state (b x 1536 x 16 at mamba-130m's
// width, 98 KB a row) is read and written once and the fp32 x_proj
// (1536 x 80), dt_proj (48 x 1536) and A (1536 x 16) are read once:
// ~1.8 MB at b = 4; the arithmetic is ~0.6 MFLOP a row.  At these sizes
// what the card spends is latency: each dependent round trip to memory
// or between blocks costs about a microsecond, so the design counts them.
//
// Design: one launch, each batch row one thread-block cluster of
// M1_CLUSTER = 16 blocks over d_inner (96 channels a block at mamba-130m's
// 1536; a cluster of 8 measured slower there).  dt_low, B and C need xs @
// x_proj over all of d_inner and every channel needs all of them: an
// all-to-all within the row, met in distributed shared memory instead of
// device memory.
// What bounds it is the number of dependent round trips and the bytes an
// SM can have in flight, so the stages are:
//   1. The loads needed first go out at once: the block's x_proj rows (a
//      thread's column j for every G-th channel), the conv window, bias, D
//      and z.
//   2. Conv + SiLU of the block's channels (four threads a channel compute
//      the same bits; __fadd_rn / __fmul_rn as the plain version rounds).
//      Then the loads needed only after the exchange go out (state, A,
//      dt_proj), overlapping stages 3 and 4.
//   3. The block's x_proj partial (r + 2n values): row groups in order.
//   4. Every block stores its partial into its slot of every block's
//      inbox (posted stores, nothing waited on), one cluster barrier, and
//      each block adds the slots in rank order: every block of the row
//      holds the same dbc and a call repeats bit for bit (no atomics, no
//      scratch).  The new conv tail is written after the barrier, whose
//      release would otherwise wait for it.
//   5. Four threads a channel, 16-byte loads and stores of the state
//      (coalesced: a warp covers 8 channels' 512 contiguous bytes): dt_proj
//      split over the four and met by shuffles, softplus, the update, y
//      over n by shuffles in a fixed order (the state stream kernel 4
//      shares), the D skip and the gate.
// Both products are fp32 on the CUDA cores.  Under ActiBA the SiLUs and
// the softplus are PWL tables (silu_tab, sp_tab; null for the exact
// functions), as the TPU kernel's silu and softplus callables are.
#include "common.cuh"
#include "wgmma.cuh"

namespace {
constexpr int M1_TPC = 4;             // threads a channel (16 state bytes each)
constexpr int M1_MAX_THREADS = 768;   // threads a block at most
constexpr int M1_CLUSTER = 16;        // blocks a row (a non-portable size)
constexpr int M1_XPRE = 24;           // x_proj rows a thread loads up front
constexpr int M1_DTPRE = 12;          // dt_proj rows a thread loads up front
constexpr int M1_MAX_CONV = 4;        // the widest conv the kernel takes

// p[k .. k+3] in fp32, zero at and past n: one 16-byte load (vec: n % 4
// == 0 and p 16-byte aligned), else element by element.  The state
// streams past L1 (read once); A is a weight, shared by the rows.
__device__ __forceinline__ float4 ld_state(const float* p, int k, int n,
                                           bool vec) {
  if (vec) return __ldcs(reinterpret_cast<const float4*>(p + k));
  return make_float4(k < n ? __ldcs(p + k) : 0.f, k + 1 < n ? __ldcs(p + k + 1) : 0.f,
                     k + 2 < n ? __ldcs(p + k + 2) : 0.f,
                     k + 3 < n ? __ldcs(p + k + 3) : 0.f);
}

__device__ __forceinline__ float4 ld_param(const float* p, int k, int n,
                                           bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p + k));
  return make_float4(k < n ? __ldg(p + k) : 0.f, k + 1 < n ? __ldg(p + k + 1) : 0.f,
                     k + 2 < n ? __ldg(p + k + 2) : 0.f,
                     k + 3 < n ? __ldg(p + k + 3) : 0.f);
}

__device__ __forceinline__ void st_state(float* p, int k, int n, bool vec,
                                         const float (&v)[4]) {
  if (vec) {
    __stcs(reinterpret_cast<float4*>(p + k), make_float4(v[0], v[1], v[2], v[3]));
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (k + e < n) __stcs(p + k + e, v[e]);
}

// Kernels 5 and 4's state stream: four lanes a channel (M1_TPC), lane q
// holding the channel's state and A elements [4 q + 16 i, 4 q + 16 i + 4)
// in 16-byte loads and stores where vec (a warp covers 8 channels' 512
// contiguous bytes at n = 16).  Each kernel issues the first four (s_pre,
// a_pre: ld_state / ld_param at 4 q) before anything that needs them;
// chan_update runs the update s' = s exp(dt A) + dtu B, stores s' to ns
// and returns the lane's part of s' . C (its elements in order), taking
// the first four from s_pre / a_pre where use_head; chan_sum meets the
// four lanes' parts by shuffles in a fixed order (every lane of the warp
// reaches it).  B and C: the token's, fp32, in shared (kernel 5) or global
// (kernel 4) memory.
__device__ __forceinline__ float chan_update(bool use_head, float4 s_pre,
                                             float4 a_pre, const float* s,
                                             float* ns,
                                             const float* a, int n, int q,
                                             bool vec, bool on, float dt,
                                             float dtu, const float* Bv,
                                             const float* Cv) {
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float yv = 0.f;
  for (int k = M1_TPC * q; k < n; k += M1_TPC * 4) {
    const bool pre = use_head && k == M1_TPC * q;
    const float4 s4 = pre ? s_pre : (on ? ld_state(s, k, n, vec) : zero4);
    const float4 a4 = pre ? a_pre : (on ? ld_param(a, k, n, vec) : zero4);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    float nv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      nv[e] = 0.f;
      if (k + e < n) {
        nv[e] = sv[e] * expf(dt * av[e]) + dtu * Bv[k + e];
        yv += nv[e] * Cv[k + e];
      }
    }
    if (on) st_state(ns, k, n, vec, nv);
  }
  return yv;
}

__device__ __forceinline__ float chan_sum(float yv) {
  yv += __shfl_xor_sync(0xFFFFFFFFu, yv, 1);
  yv += __shfl_xor_sync(0xFFFFFFFFu, yv, 2);
  return yv;
}

template <typename T> struct M1Params {
  const T* xs_raw;
  const T* z;
  const T* conv_state;
  const float *ssm_state, *conv_w, *conv_b, *xproj_w, *dtproj_w, *dtproj_b;
  const float *A, *D, *silu_tab, *sp_tab;
  T* y;
  T* new_conv;
  float* new_ssm;
  int x_rs, z_rs, di, n, r, width, vec, silu_nk, sp_nk;
};

// Grid (M1_CLUSTER, b), clusters (M1_CLUSTER, 1): block `rank` of row
// blockIdx.y takes channels [rank chb, rank chb + chb) (chb = ceil(di /
// M1_CLUSTER);
// fewer or none at the ragged end).  blockDim.x >= r + 2n, a multiple of
// 32, at most MAXT (384 or 768: the register budget a thread gets);
// dynamic shared memory (chb + (G + M1_CLUSTER + 2)(r + 2n)) floats, G =
// blockDim.x / (r + 2n).
template <typename T, int MAXT>
__global__ void __launch_bounds__(MAXT, 1) mamba1_step_kernel(M1Params<T> p) {
  extern __shared__ float sm[];
  const int rank = wg::cluster_rank();
  const int bi = blockIdx.y, t = threadIdx.x, nt = blockDim.x;
  const int di = p.di, n = p.n, r = p.r, rn = r + 2 * n, wm1 = p.width - 1;
  const int chb = (di + M1_CLUSTER - 1) / M1_CLUSTER, c0 = rank * chb;
  const int cnt = max(0, min(chb, di - c0));
  const int cpp = nt / M1_TPC;          // channels a pass
  const int q = t % M1_TPC;
  const int groups = nt / rn;           // x_proj row groups
  float* xs = sm;                       // chb: SiLU(conv) of the channels
  float* part = xs + chb;               // groups x rn: the groups' sums
  float* psum = part + groups * rn;     // rn: the block's partial
  float* inbox = psum + rn;             // M1_CLUSTER x rn: every rank's partial
  float* dbc = inbox + M1_CLUSTER * rn; // rn: dt_low, B, C of the row
  const bool vec = p.vec != 0;
  const size_t srow = static_cast<size_t>(bi) * di;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // 1. Loads that depend on nothing and are needed first: the x_proj rows
  //    of this thread's (group, column), bias, D and z (the window's come
  //    with the conv).  The cluster barrier's first phase makes sure every
  //    block of the row runs before any writes to its shared memory.
  wg::cluster_arrive_relaxed();
  const int cl0 = t / M1_TPC, ch0 = c0 + cl0;
  const bool on0 = cl0 < cnt;
  float dtb0 = 0.f, d0 = 0.f, z0 = 0.f;
  if (on0) {
    dtb0 = p.dtproj_b[ch0];
    d0 = p.D[ch0];
    z0 = to_f(p.z[static_cast<size_t>(bi) * p.z_rs + ch0]);
  }
  const int g = t / rn, j = t % rn;
  const bool xp_on = g < groups;
  float xw[M1_XPRE];
#pragma unroll
  for (int i = 0; i < M1_XPRE; ++i) {
    const int c = g + groups * i;
    xw[i] = xp_on && c < cnt ? p.xproj_w[static_cast<size_t>(c0 + c) * rn + j] : 0.f;
  }

  // 2. Conv + SiLU, and the new conv tail.
  const T* xrow = p.xs_raw + static_cast<size_t>(bi) * p.x_rs;
  const T* crow = p.conv_state + static_cast<size_t>(bi) * wm1 * di;
  T* ncrow = p.new_conv + static_cast<size_t>(bi) * wm1 * di;
  float tail0 = 0.f;
  for (int cl = cl0; cl < cnt; cl += cpp) {
    const int ch = c0 + cl;
    // The window and its weights in one round of loads (unrolled to the
    // widest conv, the taps past the width predicated off).
    float win[M1_MAX_CONV], cw[M1_MAX_CONV];
#pragma unroll
    for (int jj = 0; jj < M1_MAX_CONV; ++jj) {
      win[jj] = jj < wm1 ? to_f(crow[static_cast<size_t>(jj) * di + ch])
                         : jj == wm1 ? to_f(xrow[ch]) : 0.f;
      cw[jj] = jj <= wm1 ? p.conv_w[static_cast<size_t>(jj) * di + ch] : 0.f;
    }
    const float cb = p.conv_b[ch];
    float acc = 0.f;
#pragma unroll
    for (int jj = 0; jj < M1_MAX_CONV; ++jj)
      if (jj <= wm1) acc = __fadd_rn(acc, __fmul_rn(win[jj], cw[jj]));
    const float u = silu_act(__fadd_rn(acc, cb), p.silu_tab, p.silu_nk);
    if (q == 0) xs[cl] = u;
    // Lane q keeps row q of the new tail (window value q + 1); it is
    // stored after the cluster's exchange, whose release would otherwise
    // wait for these stores to reach memory.
    if (cl == cl0) {
#pragma unroll
      for (int jj = 0; jj + 1 < M1_MAX_CONV; ++jj)
        if (jj == q) tail0 = win[jj + 1];
    } else {
#pragma unroll
      for (int jj = 0; jj + 1 < M1_MAX_CONV; ++jj)
        if (jj < wm1 && jj == q)
          ncrow[static_cast<size_t>(jj) * di + ch] = from_f<T>(win[jj + 1]);
    }
  }
  __syncthreads();

  // The loads needed only after the exchange go out now, beside the x_proj
  // sums and the exchange: the first pass's state and A (this thread's
  // first four elements) and its dt_proj rows.
  float4 s_pre = zero4, a_pre = zero4;
  if (on0 && M1_TPC * q < n) {
    s_pre = ld_state(p.ssm_state + (srow + ch0) * n, M1_TPC * q, n, vec);
    a_pre = ld_param(p.A + static_cast<size_t>(ch0) * n, M1_TPC * q, n, vec);
  }
  float dw_pre[M1_DTPRE];
#pragma unroll
  for (int i = 0; i < M1_DTPRE; ++i) {
    const int k = q + M1_TPC * i;
    dw_pre[i] = on0 && k < r ? p.dtproj_w[static_cast<size_t>(k) * di + ch0] : 0.f;
  }

  // 3. The block's x_proj partial: each group's rows in order, then the
  //    groups in order.
  if (xp_on) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < M1_XPRE; ++i) {
      const int c = g + groups * i;
      if (c < cnt) acc = fmaf(xs[c], xw[i], acc);
    }
    for (int c = g + groups * M1_XPRE; c < cnt; c += groups)
      acc = fmaf(xs[c], p.xproj_w[static_cast<size_t>(c0 + c) * rn + j], acc);
    part[g * rn + j] = acc;
  }
  __syncthreads();
  for (int jj = t; jj < rn; jj += nt) {
    float s = part[jj];
    for (int gg = 1; gg < groups; ++gg) s += part[gg * rn + jj];
    psum[jj] = s;
  }
  __syncthreads();

  // 4. The exchange: every block stores its partial into slot `rank` of
  //    every block's inbox (posted stores into distributed shared memory,
  //    no round trip waited on), one cluster barrier, then each block adds
  //    the slots in rank order: every block of the row holds the same dbc.
  wg::cluster_wait();     // every block of the row has started
  for (int e = t; e < M1_CLUSTER * rn; e += nt)
    wg::st_rank(inbox, rank * rn + e % rn, e / rn, psum[e % rn]);
  wg::cluster_sync();
  if (on0 && q < wm1) ncrow[static_cast<size_t>(q) * di + ch0] = from_f<T>(tail0);
  for (int jj = t; jj < rn; jj += nt) {
    float a = inbox[jj];
    for (int s = 1; s < M1_CLUSTER; ++s) a += inbox[s * rn + jj];
    dbc[jj] = a;
  }
  __syncthreads();

  // 5. Each channel: dt, the state update, y, the D skip and the gate.
  //    Every lane of a warp reaches the shuffles.
  const float* Bv = dbc + r;
  const float* Cv = dbc + r + n;
  for (int base = 0; base < cnt; base += cpp) {
    const bool first = base == 0;
    const int cl = base + cl0, ch = c0 + cl;
    const bool on = cl < cnt;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < M1_DTPRE; ++i) {
      const int k = q + M1_TPC * i;
      if (k < r)
        acc = fmaf(dbc[k], first ? dw_pre[i]
                                 : (on ? p.dtproj_w[static_cast<size_t>(k) * di + ch] : 0.f),
                   acc);
    }
    for (int k = q + M1_TPC * M1_DTPRE; k < r; k += M1_TPC)
      acc = fmaf(dbc[k], on ? p.dtproj_w[static_cast<size_t>(k) * di + ch] : 0.f, acc);
    acc += __shfl_xor_sync(0xFFFFFFFFu, acc, 1);
    acc += __shfl_xor_sync(0xFFFFFFFFu, acc, 2);
    const float dtb = first ? dtb0 : (on ? p.dtproj_b[ch] : 0.f);
    const float dt = softplus_act(acc + dtb, p.sp_tab, p.sp_nk);
    const float u = on ? xs[cl] : 0.f;
    const float dtu = dt * u;
    const size_t so = (srow + ch) * n;
    const float yv = chan_sum(chan_update(first, s_pre, a_pre, p.ssm_state + so,
                                          p.new_ssm + so,
                                          p.A + static_cast<size_t>(ch) * n, n,
                                          q, vec, on, dt, dtu, Bv, Cv));
    if (on && q == 0) {
      const float d = first ? d0 : p.D[ch];
      const float zv = first ? z0 : to_f(p.z[static_cast<size_t>(bi) * p.z_rs + ch]);
      const float yc = yv + d * u;
      p.y[srow + ch] = from_f<T>(yc * silu_act(zv, p.silu_tab, p.silu_nk));
    }
  }
}

}  // namespace

// Kernel 4's one argument: 64-bit fields in this order
// (kernels/decode_step.py: SSCAN_FIELDS packs them).  state (b, d, n)
// fp32; u (b, d) T; dt (b, d), A (d, n), B / C (b, n) and D (d,) fp32, D
// null for no skip.  Writes new_state (b, d, n) fp32 and y (b, d) T.  vec:
// n % 4 == 0 and 16-byte aligned state, new_state and A.
struct SscanArgs {
  int64_t dtype;
  const void *state, *u, *dt, *A, *B, *C, *D;
  void *new_state, *y;
  int64_t b, d, n, vec;
  void* stream;
};

namespace {
constexpr int SS_THREADS = 128;   // kernel 4: 32 channels a block

// Kernel 4: kernel 5's state stream alone.  Thread 4 c + q of the grid
// is lane q of (row, channel) c = bi d + ch: its first state and A loads
// go out before anything else, then u, dt, D, and the update reads the
// row's B and C (fp32, through L1).  Lane 0 writes y = s' . C (+ u D).
template <typename T>
__global__ void __launch_bounds__(SS_THREADS) sscan_step_kernel(const SscanArgs a) {
  const int n = static_cast<int>(a.n), d = static_cast<int>(a.d);
  const long long idx = static_cast<long long>(blockIdx.x) * SS_THREADS + threadIdx.x;
  const long long c = idx / M1_TPC;
  const int q = threadIdx.x % M1_TPC;
  const bool on = c < a.b * d, vec = a.vec != 0;
  const long long cc = on ? c : 0;
  const int bi = static_cast<int>(cc / d), ch = static_cast<int>(cc % d);
  const float* s = static_cast<const float*>(a.state) + cc * n;
  float* ns = static_cast<float*>(a.new_state) + cc * n;
  const float* A = static_cast<const float*>(a.A) + static_cast<size_t>(ch) * n;
  float4 s_pre = make_float4(0.f, 0.f, 0.f, 0.f), a_pre = s_pre;
  if (on && M1_TPC * q < n) {
    s_pre = ld_state(s, M1_TPC * q, n, vec);
    a_pre = ld_param(A, M1_TPC * q, n, vec);
  }
  const float* D = static_cast<const float*>(a.D);
  const float uf = to_f(static_cast<const T*>(a.u)[cc]);
  const float dtf = static_cast<const float*>(a.dt)[cc];
  const float dv = D ? D[ch] : 0.f;
  const size_t bc = static_cast<size_t>(bi) * n;
  const float yv = chan_sum(chan_update(
      true, s_pre, a_pre, s, ns, A, n, q, vec, on, dtf, dtf * uf,
      static_cast<const float*>(a.B) + bc, static_cast<const float*>(a.C) + bc));
  if (on && q == 0)
    static_cast<T*>(a.y)[cc] = from_f<T>(D ? yv + uf * dv : yv);
}
}  // namespace

// The launcher's one argument: 64-bit fields in this order
// (kernels/decode_step.py: M1_FIELDS packs them).  xs_raw / z: rows of di
// values at row strides x_rs / z_rs (the in_proj halves, in T);
// conv_state (b, w-1, di) T; ssm_state (b, di, n) fp32; conv_w (w, di),
// conv_b (di,), xproj_w (di, r+2n), dtproj_w (r, di), dtproj_b (di,), A
// (di, n), D (di,) fp32.  Writes y (b, di) T (gated, pre-out_proj),
// new_conv (b, w-1, di) T and new_ssm (b, di, n) fp32; w at most 4 (the
// window's loads unrolled).  vec: n % 4
// == 0 and 16-byte aligned ssm_state, new_ssm and A; each table (2 nk + 2
// fp32) or null for the exact activation.
struct M1Args {
  int64_t dtype;
  const void* xs_raw;
  int64_t x_rs;
  const void* z;
  int64_t z_rs;
  const void *conv_state, *ssm_state, *conv_w, *conv_b, *xproj_w, *dtproj_w;
  const void *dtproj_b, *A, *D;
  void *y, *new_conv, *new_ssm;
  int64_t b, di, n, r, width, vec;
  const void* silu_tab;
  int64_t silu_nk;
  const void* sp_tab;
  int64_t sp_nk;
  void* stream;
};

namespace {
// A cluster of more than 8 blocks is a non-portable size: allowed once per
// kernel.
template <typename T, int MAXT> cudaError_t allow_wide_clusters() {
  static const cudaError_t err = cudaFuncSetAttribute(
      mamba1_step_kernel<T, MAXT>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <typename T, int MAXT>
cudaError_t launch_m1(const M1Params<T>& p, int b, int nt, size_t smem,
                      cudaStream_t s) {
  const cudaError_t err = allow_wide_clusters<T, MAXT>();
  if (err != cudaSuccess) return err;
  return wg::launch_cluster(mamba1_step_kernel<T, MAXT>, dim3(M1_CLUSTER, b),
                            dim3(nt), dim3(M1_CLUSTER, 1, 1), smem, s, p);
}
}  // namespace

// One launch of mamba1_step_kernel.  Returns the cudaError_t.
extern "C" int mamba1_step_launch(const M1Args* a) {
  if (a->b == 0 || a->di == 0) return 0;
  const int b = static_cast<int>(a->b), di = static_cast<int>(a->di),
            n = static_cast<int>(a->n), r = static_cast<int>(a->r), rn = r + 2 * n;
  if (n < 1 || r < 1 || a->width < 1 ||
      a->width > M1_MAX_CONV ||
      rn > M1_MAX_THREADS || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chb = (di + M1_CLUSTER - 1) / M1_CLUSTER;
  int nt = M1_TPC * (chb < M1_MAX_THREADS / M1_TPC ? chb : M1_MAX_THREADS / M1_TPC);
  nt = (nt > rn ? nt : rn) + 31;
  nt -= nt % 32;
  if (nt > M1_MAX_THREADS) nt = M1_MAX_THREADS;
  const size_t smem =
      static_cast<size_t>(chb + (nt / rn + M1_CLUSTER + 2) * rn) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  cudaError_t err = cudaSuccess;
  DISPATCH_T(a->dtype, {
    const M1Params<T> p{
        static_cast<const T*>(a->xs_raw), static_cast<const T*>(a->z),
        static_cast<const T*>(a->conv_state),
        static_cast<const float*>(a->ssm_state),
        static_cast<const float*>(a->conv_w), static_cast<const float*>(a->conv_b),
        static_cast<const float*>(a->xproj_w),
        static_cast<const float*>(a->dtproj_w),
        static_cast<const float*>(a->dtproj_b), static_cast<const float*>(a->A),
        static_cast<const float*>(a->D), static_cast<const float*>(a->silu_tab),
        static_cast<const float*>(a->sp_tab), static_cast<T*>(a->y),
        static_cast<T*>(a->new_conv), static_cast<float*>(a->new_ssm),
        static_cast<int>(a->x_rs), static_cast<int>(a->z_rs), di, n, r,
        static_cast<int>(a->width), static_cast<int>(a->vec),
        static_cast<int>(a->silu_nk), static_cast<int>(a->sp_nk)};
    err = nt <= M1_MAX_THREADS / 2 ? launch_m1<T, M1_MAX_THREADS / 2>(p, b, nt, smem, s)
                                   : launch_m1<T, M1_MAX_THREADS>(p, b, nt, smem, s);
  });
  return static_cast<int>(err);
}

// One launch of sscan_step_kernel: b d four-lane groups.  Returns the
// cudaError_t.
extern "C" int sscan_step_launch(const SscanArgs* a) {
  if (a->b == 0 || a->d == 0) return 0;
  if (a->n < 1 || a->b < 0 || a->d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = a->b * a->d * M1_TPC;
  const long long blocks = (threads + SS_THREADS - 1) / SS_THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  DISPATCH_T(a->dtype, sscan_step_kernel<T><<<static_cast<unsigned>(blocks),
                                              SS_THREADS, 0, s>>>(*a));
  return static_cast<int>(cudaGetLastError());
}
