// Fused Mamba-2 single-token step, the gated RMSNorm included: one launch.
//
// Replaces the TPU kernel src/repro/kernels/decode_step.py:155
// mamba2_step: conv-tail shift + bias, SiLU, softplus(dt + dt_bias), the
// SSD update  st' = st * exp(dt*A) + (dt*x) (x) B,  y = st' . C,  the D
// skip and the gated RMSNorm over the whole row (:196-200), fp32 inside
// with one rounding to T at the end (the decode step's round_stream = 0).
//
// Bound: bytes.  Per layer and batch row the fp32 state (24 x 64 x 128 at
// full width, 786 KB) is read once and written once; everything else is
// a few KB, and the arithmetic is ~5 operations per state element.
//
// Design.  The kernel's whole job is to stream the state through, so it
// keeps as many bytes in flight as the card takes:
// * Grid (p / R, h, b): R state rows of one head a block
//   (kernels/decode_step.py: step_rows; 16 at p = 64, so 384 blocks of 8
//   warps at b = 4, one wave), a warp taking rows w and w + 8, lanes
//   along d_state with 16-byte loads and stores (n = 128: one float4 a
//   lane a row).  Every state load of the block is issued first, before
//   the conv and the activations, which they do not depend on: the whole
//   3.1 MB of state at b = 4 is in flight at once.  State loads and
//   stores stream past L1 (read once, written once).
// * Each block recomputes the conv + SiLU it needs: its R x channels and
//   its group's B and C channels (2n values, cheaper than a second pass).
//   The new conv tail is written exactly once: the x channels by their
//   rows' block, the B and C channels by the blocks of head 0, split
//   among them.
// * The norm spans a whole batch row (h p values, h p / R blocks).  It is
//   taken through a per-row arrival counter, not a thread-block cluster:
//   a row is 96 blocks at full width and a cluster holds at most 16.
//   Each block writes its rows' pre-norm y (fp32, with the D skip) and
//   their sum of squares to a scratch row, fences (its new state is stored
//   only after, so the fence waits on a few values, not on the state), and
//   adds one to the row's counter; the block that brings it to h p / R
//   sums the partial
//   sums in a fixed order, normalises the row in one pass and sets the
//   counter back to 0 for the next call.  A call gives the same bits
//   every time, whichever block is last.  The scratch and counters belong
//   to the calls of one stream (the wrapper keeps them per device).
//
// Under ActiBA the conv's SiLU, dt's softplus and the gate's SiLU are PWL
// tables (silu_tab, sp_tab; null for the exact functions), as the TPU
// kernel's silu and softplus callables are (decode_step.py:159-160).
//
// ssd_step (kernel 3) replaces the TPU kernel decode_step.py:76 ssd_step,
// the bare SSD update without the conv, the activations or the norm (dt
// comes in raw: decay = exp(dt A)).  Bound: bytes, the fp32 state read once
// and written once (6.3 MB at b = 4, full width: 0.0019 ms).  It is kernel
// 1's state stream with nothing around it: the same grid, rows a block and
// warps (rows_load / rows_update / rows_store below, shared by both), every
// state load issued first, then the block's x rows and its group's B and C
// into shared memory; y written per row in x's dtype.  No arrival counter
// or scratch: nothing spans blocks.
#include <cstdint>

#include "common.cuh"

// The launcher's one argument: 64-bit fields in this order
// (kernels/decode_step.py: STEP_FIELDS packs them).  Streams xbc, dt and z
// are rows of dxbc, h and h p values at their row strides (elements, T);
// conv_state (b, w-1, dxbc) T; ssm_state (b, h, p, n) fp32; conv_w (w,
// dxbc), conv_b (dxbc,), dt_bias / A / D (h,), norm_scale (h p,) fp32.
// Writes out (b, h p) T, new_conv, new_ssm; ypre (b, h p + h p / rows)
// fp32 (each row's pre-norm y, then its blocks' sums of squares) and
// counts (b,) int32 are the norm's scratch (counts 0 on entry, 0 on exit).
// rows: state rows a block (1 .. MAX_ROWS, a divisor of p); vec: n % 4
// == 0 and 16-byte aligned states (float4 loads and stores).
struct StepArgs {
  int64_t dtype;
  const void* xbc;
  int64_t xbc_rs;
  const void* dt;
  int64_t dt_rs;
  const void* z;
  int64_t z_rs;
  const void* conv_state;
  const void* ssm_state;
  const void* conv_w;
  const void* conv_b;
  const void* dt_bias;
  const void* A;
  const void* D;
  const void* norm_scale;
  void* out;
  void* new_conv;
  void* new_ssm;
  void* ypre;
  void* counts;
  int64_t b, h, p, g, n, width, rows, vec;
  double eps;
  const void* silu_tab;
  int64_t silu_nk;
  const void* sp_tab;
  int64_t sp_nk;
  void* stream;
};

namespace {
constexpr int MAX_ROWS = 16;  // state rows a block
constexpr int WARPS = 8;      // warps a block: rows w, w + 8 of warp w
constexpr int ROWS_W = MAX_ROWS / WARPS;   // rows a warp at most
constexpr int PREFETCH = 2;   // float4 a lane holds in flight a row: n <= 256
constexpr int CONV_W = 4;     // conv taps a thread holds in registers
constexpr int NORM_C = 8;     // row values a thread of the last block holds

// s' = s decay + dx b, written back through v; part += s' c.
__device__ __forceinline__ float step_elem(float s, float decay, float dx,
                                           float b, float c, float& part) {
  const float v = s * decay + dx * b;
  part += v * c;
  return v;
}

// Elements [k, k + 4) of a state row (those below n) as a float4; VEC: one
// 16-byte streaming load.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* row, int k, int n) {
  if (VEC) return __ldcs(reinterpret_cast<const float4*>(row + k));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (k < n) v.x = __ldcs(row + k);
  if (k + 1 < n) v.y = __ldcs(row + k + 1);
  if (k + 2 < n) v.z = __ldcs(row + k + 2);
  if (k + 3 < n) v.w = __ldcs(row + k + 3);
  return v;
}

// Elements [k, k + 4) of a state row updated in place, and their part of
// y; VEC: B and C as float4.
template <bool VEC>
__device__ __forceinline__ void update4(float4& s, int k, int n, float decay,
                                        float dx, const float* Bv,
                                        const float* Cv, float& part) {
  float4 b4, c4;
  if (VEC) {
    b4 = *reinterpret_cast<const float4*>(Bv + k);
    c4 = *reinterpret_cast<const float4*>(Cv + k);
  } else {
    b4 = make_float4(Bv[k], k + 1 < n ? Bv[k + 1] : 0.f,
                     k + 2 < n ? Bv[k + 2] : 0.f, k + 3 < n ? Bv[k + 3] : 0.f);
    c4 = make_float4(Cv[k], k + 1 < n ? Cv[k + 1] : 0.f,
                     k + 2 < n ? Cv[k + 2] : 0.f, k + 3 < n ? Cv[k + 3] : 0.f);
  }
  s.x = step_elem(s.x, decay, dx, b4.x, c4.x, part);
  s.y = step_elem(s.y, decay, dx, b4.y, c4.y, part);
  s.z = step_elem(s.z, decay, dx, b4.z, c4.z, part);
  s.w = step_elem(s.w, decay, dx, b4.w, c4.w, part);
}

// Elements [k, k + 4) of a state row (those below n) stored; VEC: one
// 16-byte streaming store.
template <bool VEC>
__device__ __forceinline__ void store4(float* row, int k, int n, float4 v) {
  if (VEC) {
    __stcs(reinterpret_cast<float4*>(row + k), v);
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < n) __stcs(row + k + i, e[i]);
}

// A warp's state rows of one block (kernels 1 and 3): rows w and
// w + WARPS of the block's R, lanes along n, a float4 a lane a row held in
// registers for the first 4 * 32 * PREFETCH elements of a row.
using RowRegs = float4[ROWS_W][PREFETCH];

// Every state load of the warp's rows issued (s: the block's first row).
template <bool VEC>
__device__ __forceinline__ void rows_load(RowRegs& s4, const float* s, int R,
                                          int n, int warp, int lane) {
#pragma unroll
  for (int r = 0; r < ROWS_W; ++r)
#pragma unroll
    for (int j = 0; j < PREFETCH; ++j) {
      const int row = warp + WARPS * r, k = 4 * (lane + 32 * j);
      s4[r][j] = row < R && k < n
                     ? load4<VEC>(s + static_cast<size_t>(row) * n, k, n)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
}

// The update of the warp's rows in registers, s' = s decay + (dt x) B,
// and y = s' . C: done(row, y, x) on lane 0.  Past the registers (n > 256)
// a row's elements are loaded, updated and stored here.
template <bool VEC, typename F>
__device__ __forceinline__ void rows_update(
    RowRegs& s4, const float* s, float* ns, int R, int n, int warp, int lane,
    float dtf, float decay, const float* xs, const float* Bv,
    const float* Cv, F done) {
#pragma unroll
  for (int r = 0; r < ROWS_W; ++r) {
    const int row = warp + WARPS * r;
    if (row >= R) break;
    const float xv = xs[row];
    const float dx = dtf * xv;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < PREFETCH; ++j) {
      const int k = 4 * (lane + 32 * j);
      if (k < n) update4<VEC>(s4[r][j], k, n, decay, dx, Bv, Cv, part);
    }
    for (int k = 4 * (lane + 32 * PREFETCH); k < n; k += 128) {   // n > 256
      float4 v = load4<VEC>(s + static_cast<size_t>(row) * n, k, n);
      update4<VEC>(v, k, n, decay, dx, Bv, Cv, part);
      store4<VEC>(ns + static_cast<size_t>(row) * n, k, n, v);
    }
    part = warp_sum(part);
    if (lane == 0) done(row, part, xv);
  }
}

// The warp's updated rows stored (ns: the block's first row).
template <bool VEC>
__device__ __forceinline__ void rows_store(const RowRegs& s4, float* ns,
                                           int R, int n, int warp, int lane) {
#pragma unroll
  for (int r = 0; r < ROWS_W; ++r) {
    const int row = warp + WARPS * r;
#pragma unroll
    for (int j = 0; j < PREFETCH; ++j) {
      const int k = 4 * (lane + 32 * j);
      if (row < R && k < n)
        store4<VEC>(ns + static_cast<size_t>(row) * n, k, n, s4[r][j]);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * WARPS)
    mamba2_step_kernel(const StepArgs a) {
  extern __shared__ float smem[];
  float* xs = smem;            // (MAX_ROWS,) activated x of this block's rows
  float* Bv = xs + MAX_ROWS;   // (n,) activated B of this head's group
  float* Cv = Bv + a.n;        // (n,) activated C
  __shared__ float yv[MAX_ROWS];
  __shared__ float red[WARPS];
  __shared__ int last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = static_cast<int>(a.rows);
  const int rs = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int h = static_cast<int>(a.h), p = static_cast<int>(a.p);
  const int g = static_cast<int>(a.g), n = static_cast<int>(a.n);
  const int width = static_cast<int>(a.width), wm1 = width - 1;
  const int di = h * p, dxbc = di + 2 * g * n, gi = hi / (h / g);

  // 1. This warp's state rows (w, w + WARPS of the block) in flight before
  //    anything else, then the head's scalars.
  const size_t hbase = (static_cast<size_t>(bi) * h + hi) * p + rs * R;
  const float* s = static_cast<const float*>(a.ssm_state) + hbase * n;
  float* ns = static_cast<float*>(a.new_ssm) + hbase * n;
  RowRegs s4;
  rows_load<VEC>(s4, s, R, n, warp, lane);
  const float dtraw =
      to_f(static_cast<const T*>(a.dt)[static_cast<size_t>(bi) * a.dt_rs + hi]);
  const float dtb = static_cast<const float*>(a.dt_bias)[hi];
  const float Ah = static_cast<const float*>(a.A)[hi];
  const float Dh = static_cast<const float*>(a.D)[hi];

  // 2. The conv + SiLU of this block's x channels and its group's B, C.
  const T* xrow = static_cast<const T*>(a.xbc) + static_cast<size_t>(bi) *
                                                     a.xbc_rs;
  const T* crow = static_cast<const T*>(a.conv_state) +
                  static_cast<size_t>(bi) * wm1 * dxbc;
  T* ncrow = static_cast<T*>(a.new_conv) + static_cast<size_t>(bi) * wm1 *
                                               dxbc;
  const float* conv_w = static_cast<const float*>(a.conv_w);
  const float* conv_b = static_cast<const float*>(a.conv_b);
  const float* silu_tab = static_cast<const float*>(a.silu_tab);
  const int silu_nk = static_cast<int>(a.silu_nk);
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
    for (int j = 0; j < wm1; ++j)
      ncrow[j * dxbc + ch] = from_f<T>(win(j + 1, ch));
  };
  // Items: the group's B channels, its C channels, this block's x
  // channels; a thread takes items tid and tid + 256, all their window and
  // weight loads issued before any arithmetic (one round trip).
  const int items = 2 * n + R;
  auto item_ch = [&](int i) -> int {
    return i < n ? di + gi * n + i
                 : i < 2 * n ? di + g * n + gi * n + (i - n)
                             : hi * p + rs * R + (i - 2 * n);
  };
  auto item_put = [&](int i, float v) {
    if (i < n)
      Bv[i] = v;
    else if (i < 2 * n)
      Cv[i - n] = v;
    else
      xs[i - 2 * n] = v;
  };
  if (width <= CONV_W) {
    float wv[2][CONV_W], cw[2][CONV_W], cb[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * WARPS * 32;
      const int ch = i < items ? item_ch(i) : 0;
#pragma unroll
      for (int j = 0; j < CONV_W; ++j) {
        wv[u][j] = i < items && j < width ? win(j, ch) : 0.f;
        cw[u][j] = i < items && j < width ? conv_w[j * dxbc + ch] : 0.f;
      }
      cb[u] = i < items ? conv_b[ch] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * WARPS * 32;
      if (i >= items) continue;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < CONV_W; ++j)
        if (j < width) acc = __fadd_rn(acc, __fmul_rn(wv[u][j], cw[u][j]));
      item_put(i, silu_act(__fadd_rn(acc, cb[u]), silu_tab, silu_nk));
    }
    for (int i = tid + 2 * WARPS * 32; i < items; i += WARPS * 32)
      item_put(i, conv_act(item_ch(i)));               // n > 248
  } else {
    for (int i = tid; i < items; i += WARPS * 32)
      item_put(i, conv_act(item_ch(i)));
  }
  if (tid < R) shift(hi * p + rs * R + tid);
  if (hi == 0) {
    const int step = gridDim.x * blockDim.x;
    for (int c = rs * blockDim.x + tid; c < 2 * g * n; c += step)
      shift(di + c);
  }
  const float dtf = softplus_act(dtraw + dtb,
                                 static_cast<const float*>(a.sp_tab),
                                 static_cast<int>(a.sp_nk));
  const float decay = expf(dtf * Ah);
  __syncthreads();

  // 3. The update of this warp's rows in registers, y = s' . C + D x.
  float* yrows = yv;
  rows_update<VEC>(s4, s, ns, R, n, warp, lane, dtf, decay, xs, Bv, Cv,
                   [&](int row, float part, float xv) {
                     yrows[row] = part + Dh * xv;
                   });
  __syncthreads();

  // 4. The rows' y and their sum of squares to scratch (only their writers
  //    fence); arrival: the row's last block takes the gated norm of the
  //    row.  The new state is stored after the arrival, off its path.
  const int per_row = gridDim.x * gridDim.y;
  float* yrow = static_cast<float*>(a.ypre) +
                static_cast<size_t>(bi) * (di + per_row);
  float* parts = yrow + di;
  if (tid < R) yrow[hi * p + rs * R + tid] = yv[tid];
  if (tid == 0) {
    float sq = 0.f;
    for (int r = 0; r < R; ++r) sq += yv[r] * yv[r];
    parts[hi * gridDim.x + rs] = sq;
  }
  if (tid < R) __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(static_cast<int*>(a.counts) + bi, 1) == per_row - 1;
  rows_store<VEC>(s4, ns, R, n, warp, lane);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The row's y, gates and scales in flight with the partial sums.
  const float* scale = static_cast<const float*>(a.norm_scale);
  const T* zr = static_cast<const T*>(a.z) + static_cast<size_t>(bi) * a.z_rs;
  T* orow = static_cast<T*>(a.out) + static_cast<size_t>(bi) * di;
  float yc[NORM_C], zc[NORM_C], sc[NORM_C];
#pragma unroll
  for (int u = 0; u < NORM_C; ++u) {
    const int c = tid + u * WARPS * 32;
    yc[u] = c < di ? __ldcg(yrow + c) : 0.f;
    zc[u] = c < di ? to_f(zr[c]) : 0.f;
    sc[u] = c < di ? scale[c] : 0.f;
  }
  float ss = 0.f;
  for (int i = tid; i < per_row; i += blockDim.x) ss += __ldcg(parts + i);
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) tot += red[w];
  const float inv = rsqrtf(tot / static_cast<float>(di) +
                           static_cast<float>(a.eps));
#pragma unroll
  for (int u = 0; u < NORM_C; ++u) {
    const int c = tid + u * WARPS * 32;
    if (c < di)
      orow[c] = from_f<T>(yc[u] * inv * sc[u] *
                          silu_act(zc[u], silu_tab, silu_nk));
  }
  for (int c = tid + NORM_C * WARPS * 32; c < di; c += blockDim.x) {
    const float yn = __ldcg(yrow + c) * inv * scale[c];     // di > 2048
    orow[c] = from_f<T>(yn * silu_act(to_f(zr[c]), silu_tab, silu_nk));
  }
  if (tid == 0) static_cast<int*>(a.counts)[bi] = 0;
}
}  // namespace

// Returns the cudaError_t (cudaErrorInvalidValue for a rows value the
// kernel does not take).
extern "C" int mamba2_step_launch(const StepArgs* a) {
  if (a->b == 0) return 0;
  const int R = static_cast<int>(a->rows);
  if (R < 1 || R > MAX_ROWS || a->p % R != 0 || a->g <= 0 ||
      a->h % a->g != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(a->p / R),
                  static_cast<unsigned>(a->h), static_cast<unsigned>(a->b));
  const size_t smem = static_cast<size_t>(MAX_ROWS + 2 * a->n) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  DISPATCH_T(a->dtype, {
    if (a->vec)
      mamba2_step_kernel<T, true><<<grid, 32 * WARPS, smem, s>>>(*a);
    else
      mamba2_step_kernel<T, false><<<grid, 32 * WARPS, smem, s>>>(*a);
  });
  return static_cast<int>(cudaGetLastError());
}

// Kernel 3's one argument: 64-bit fields in this order
// (kernels/decode_step.py: SSD_FIELDS packs them).  state (b, h, p, n)
// fp32; x (b, h, p) T; dt (b, h), A (h,) and B / C (b, g, n) fp32.  Writes
// new_state (b, h, p, n) fp32 and y (b, h, p) T.  rows: state rows a block
// (1 .. MAX_ROWS, a divisor of p); vec: n % 4 == 0 and 16-byte aligned
// states.
struct SsdArgs {
  int64_t dtype;
  const void* state;
  const void* x;
  const void* dt;
  const void* A;
  const void* B;
  const void* C;
  void* new_state;
  void* y;
  int64_t b, h, p, g, n, rows, vec;
  void* stream;
};

namespace {
template <typename T, bool VEC>
__global__ void __launch_bounds__(32 * WARPS)
    ssd_step_kernel(const SsdArgs a) {
  extern __shared__ float smem[];
  float* xs = smem;            // (MAX_ROWS,) x of this block's rows
  float* Bv = xs + MAX_ROWS;   // (n,) B of this head's group
  float* Cv = Bv + a.n;        // (n,) C

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = static_cast<int>(a.rows);
  const int rs = blockIdx.x, hi = blockIdx.y, bi = blockIdx.z;
  const int h = static_cast<int>(a.h), p = static_cast<int>(a.p);
  const int g = static_cast<int>(a.g), n = static_cast<int>(a.n);
  const int gi = hi / (h / g);

  // This warp's state rows in flight before anything else.
  const size_t hrow = static_cast<size_t>(bi) * h + hi;
  const size_t hbase = hrow * p + rs * R;
  const float* s = static_cast<const float*>(a.state) + hbase * n;
  float* ns = static_cast<float*>(a.new_state) + hbase * n;
  RowRegs s4;
  rows_load<VEC>(s4, s, R, n, warp, lane);

  const float* B = static_cast<const float*>(a.B) +
                   (static_cast<size_t>(bi) * g + gi) * n;
  const float* C = static_cast<const float*>(a.C) +
                   (static_cast<size_t>(bi) * g + gi) * n;
  const T* x = static_cast<const T*>(a.x) + hbase;
  for (int i = tid; i < 2 * n + R; i += 32 * WARPS) {
    if (i < n)
      Bv[i] = B[i];
    else if (i < 2 * n)
      Cv[i - n] = C[i - n];
    else
      xs[i - 2 * n] = to_f(x[i - 2 * n]);
  }
  const float dtf = static_cast<const float*>(a.dt)[hrow];
  const float decay = expf(dtf * static_cast<const float*>(a.A)[hi]);
  __syncthreads();

  T* y = static_cast<T*>(a.y) + hbase;
  rows_update<VEC>(s4, s, ns, R, n, warp, lane, dtf, decay, xs, Bv, Cv,
                   [&](int row, float part, float) {
                     y[row] = from_f<T>(part);
                   });
  rows_store<VEC>(s4, ns, R, n, warp, lane);
}
}  // namespace

// Returns the cudaError_t (cudaErrorInvalidValue for a rows value the
// kernel does not take).
extern "C" int ssd_step_launch(const SsdArgs* a) {
  if (a->b == 0) return 0;
  const int R = static_cast<int>(a->rows);
  if (R < 1 || R > MAX_ROWS || a->p % R != 0 || a->g <= 0 ||
      a->h % a->g != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(a->p / R),
                  static_cast<unsigned>(a->h), static_cast<unsigned>(a->b));
  const size_t smem = static_cast<size_t>(MAX_ROWS + 2 * a->n) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  DISPATCH_T(a->dtype, {
    if (a->vec)
      ssd_step_kernel<T, true><<<grid, 32 * WARPS, smem, s>>>(*a);
    else
      ssd_step_kernel<T, false><<<grid, 32 * WARPS, smem, s>>>(*a);
  });
  return static_cast<int>(cudaGetLastError());
}
