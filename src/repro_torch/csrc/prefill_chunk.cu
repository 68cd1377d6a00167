// Fused Mamba-2 multi-token prefill, up to (not including) the gated norm.
//
// Replaces the TPU kernel src/repro/kernels/prefill_chunk.py:294
// mamba2_prefill_pallas (reference semantics: mamba2_prefill_xla, :154):
// the causal conv over [tail; tokens], SiLU, softplus(dt + dt_bias), the
// CumBA prefix sums cs of dt*A, per head the intra-chunk term
// (C B^T (.) exp(segsum)) @ (x*dt) plus the carried-state term
// (C . state) * exp(cs), the outgoing state, and the D skip, with the TPU
// kernel's stream-dtype rounding (conv rounded to T before SiLU; y
// rounded to T before + x*D, that sum taken in T).  y is written in T
// (lossless: it is a T value); the gated RMSNorm runs afterwards in
// gated_norm.cu with the prefill's rounding.
//
// Bound: bytes.  At b = 4, l = 128 (one chunk), full width (h 24, p 64,
// n 128, one group) the streams, state and output are ~13 MB (0.004 ms at
// 3.35 TB/s) against ~0.5 GFLOP, most of it three bf16 products each
// (0.0015 ms at a third of the tensor cores' 989 TFLOP/s).
//
// The TPU kernel walks a sequential (batch, chunk) grid carrying the conv
// tail and state in VMEM; Hopper runs blocks in no order.  Two bodies,
// picked by the wrapper's path() from shapes alone, share a first pass:
//
// 1. conv_act_kernel: the activated xBC streams of the whole sequence in
//    one parallel pass (a thread a channel and 16 positions, its window
//    and weights in registers, the first w-1 of it from the incoming tail)
//    and the outgoing conv tail.  For the
//    tensor-core body it also takes dt's softplus and each chunk's prefix
//    sums of dt*A, one warp a (batch, chunk, head) over strips of chunk /
//    32 values (cumba.cu's pattern) joined by shuffles in serial order
//    (dt_scan), into fp32 scratch (b, h, l).
// 2a. "wgmma" (p 64, n 64 or 128, chunks of 64-256 rows): the SSD split
//    of ssd_chunk.cu (kernel 7) extended by the carried state, on
//    ssd_tc.cuh's tiles.  Blocks of one warpgroup (128 threads), two
//    kinds in one grid:
//    * y blocks, one per (batch, chunk, 64-row query tile q, set of hs
//      heads of one group; kernels/prefill_chunk.py: heads_per_set),
//      heaviest query tiles first.  The group's score tiles S_k = C_q B_k^T
//      (k <= q) are taken once for the set and kept as fp32 fragments in
//      shared memory.  Then per head: the carried-state term
//      (C_q . state^T) * exp(cs_i) starts y; per key tile the fragments
//      are folded with the decay exp(cs_i - cs_j), masked for j > i, and
//      dt_j, split into terms in registers (wgmma's A operand, as flash
//      attention keeps P), and y += S_folded x_k (x MN-major through
//      wgmma's transpose bit); the D skip with the TPU kernel's rounding
//      ends it.
//    * state blocks, one per (batch, chunk, head): the chunk state
//      (x (.) dt (.) exp(cs_L - cs))^T B over the chunk's 64-row tiles.
//      A single chunk ends there: state_out = state_in * exp(cs_L) + it,
//      and its y and state blocks share one launch (both read only
//      state_in).  Several chunks write the chunk states to scratch; a
//      short pass (state_pass_kernel) walks the chunks in order, elementwise
//      over p x n, leaving each chunk's incoming state in place of its
//      chunk state and the last state in state_out; then the y blocks run.
//    Precision.  With bf16 streams the activated x, B and C are exact bf16
//    values (rounded to T before the scan, as the TPU kernel does): C B^T
//    is ONE bf16 product (exact products, fp32 accumulation), and the fp32
//    factors (the decay, dt, exp(cs_L - cs), the state) go on the other
//    operand as ssd_tc.cuh's three truncated terms: three bf16 products
//    each.  fp32 streams take ssd_tc.cuh's six products everywhere.
//    Data movement: 64 x 64 tiles of the act stream (a bf16 box, or an
//    fp32 unit of two boxes) and fp32 units of the incoming state arrive
//    by TMA into a ring of two 16 KB stages; the warpgroup takes every
//    unit in order and issues unit j + 2 once all its threads are past
//    unit j (and fenced), so a parity wait never meets a unit two ahead.
//    Terms the threads write are fenced to the async proxy before the
//    barrier that precedes the wgmma reading them.  Every sum is taken in
//    a fixed order: the same bits every call.  Two blocks an SM at bf16
//    chunks up to 128 (~105 KB of shared memory each).
// 2b. "simt", the rest: ssd_scan_kernel, one block per (batch, head)
//    walking the chunks in order with the head's fp32 state in shared
//    memory, over common.cuh's ssd_tiles (the SIMT tiles ssd_chunk.cu's
//    SIMT body shares).
//
// Under ActiBA the conv's SiLU and dt's softplus are PWL tables (silu_tab,
// sp_tab; null for the exact functions), as the TPU kernel's silu and
// softplus callables are (prefill_chunk.py:178,182).
#include <cstdint>

#include "common.cuh"
#include "ssd_tc.cuh"

// The launcher's one argument: 64-bit fields in this order
// (kernels/prefill_chunk.py: PREFILL_FIELDS packs them).  Streams xbc and
// dt are rows of dxbc and h values at their row strides over the b*l rows
// (T); conv_state (b, w-1, dxbc) T; state_in (b, h, p, n) fp32; conv_w
// (w, dxbc), conv_b (dxbc,), dt_bias / A / D (h,) fp32.  Scratch: act
// (b, l, dxbc) T; for the tensor-core body cs and dtv (b, h, l) fp32 and,
// with several chunks, chunk_states (b, l / chunk, h, p, n) fp32.  Writes
// y (b, l, h p) T (the pre-norm y with the D skip), new_conv (b, w-1,
// dxbc) T and state_out (b, h, p, n) fp32.  body: 0 SIMT, 1 tensor-core;
// hs: heads a y block of the tensor-core body takes.
struct PrefillArgs {
  int64_t dtype;
  int64_t body;
  const void* xbc;
  int64_t xbc_rs;
  const void* dt;
  int64_t dt_rs;
  const void* conv_state;
  const void* state_in;
  const void* conv_w;
  const void* conv_b;
  const void* dt_bias;
  const void* A;
  const void* D;
  void* act;
  void* y;
  void* new_conv;
  void* state_out;
  void* cs;
  void* dtv;
  void* chunk_states;
  int64_t b, l, chunk, h, p, g, n, width, hs;
  const void* silu_tab;
  int64_t silu_nk;
  const void* sp_tab;
  int64_t sp_nk;
  void* stream;
};

using namespace ssd_tiles;

namespace {
constexpr int SCAN_WARPS = 8;   // (chunk, head) scans a dt block takes
constexpr int MAX_STRIP = 8;    // dt values a lane scans: chunks up to 256
constexpr int CONV_T = 16;      // positions a conv thread takes
constexpr int CONV_W = 4;       // conv taps held in registers (wider loop)

// One warp: softplus(dt + dt_bias) of (batch bi, chunk ci, head hh) into
// dtv and its inclusive prefix sums of dt*A into cs, both (b, h, l).  The
// lanes load and activate strips of chunk / 32 values in parallel, then
// take the sums lane after lane, the running total passed on by a
// shuffle: the serial order ((a_0 + a_1) + a_2) + ... of the SIMT body and
// of the plain version's triangular product, so cs is the same fp32 value
// on every path (a pairwise order moves cs ~ -190 by a few ulps, and the
// decays of far pairs by ~1e-4).
template <typename T>
__device__ __forceinline__ void dt_scan(const T* __restrict__ dt, int dt_rs,
                                        const float* __restrict__ dt_bias,
                                        const float* __restrict__ A,
                                        float* __restrict__ cs,
                                        float* __restrict__ dtv, int bi,
                                        int l, int chunk, int h,
                                        const float* sp_tab, int sp_nk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pair = blockIdx.y * SCAN_WARPS + warp;
  const int ci = pair / h, hh = pair % h;
  if (ci >= l / chunk) return;
  const int s = chunk / 32;
  const float Ah = A[hh], dtb = dt_bias[hh];
  const int t0 = ci * chunk + lane * s;
  const size_t base = (static_cast<size_t>(bi) * h + hh) * l + t0;
  const T* src = dt + (static_cast<size_t>(bi) * l + t0) * dt_rs + hh;
  float av[MAX_STRIP];
#pragma unroll
  for (int i = 0; i < MAX_STRIP; ++i)
    if (i < s) {
      const float v = softplus_act(to_f(src[static_cast<size_t>(i) * dt_rs]) +
                                       dtb, sp_tab, sp_nk);
      dtv[base + i] = v;
      av[i] = v * Ah;
    }
  float run = 0.f;
#pragma unroll 1
  for (int k = 0; k < 32; ++k) {
    if (lane == k) {
#pragma unroll
      for (int i = 0; i < MAX_STRIP; ++i)
        if (i < s) {
          run += av[i];
          cs[base + i] = run;
        }
    }
    run = __shfl_sync(0xffffffffu, run, k);
  }
}

// Grid (ceil(dxbc / 256) [+ 1 column of dt blocks when cs is not null],
// ceil(l / CONV_T), b): a thread per (channel, CONV_T positions), its
// conv window and weights in registers (each input read once); the dt
// blocks take SCAN_WARPS (chunk, head) scans each.
template <typename T>
__global__ void conv_act_kernel(const T* __restrict__ xbc, int xbc_rs,
                                const T* __restrict__ conv_state,
                                const float* __restrict__ conv_w,
                                const float* __restrict__ conv_b,
                                T* __restrict__ act, T* __restrict__ new_conv,
                                int l, int dxbc, int width,
                                const float* silu_tab, int silu_nk,
                                const T* __restrict__ dt, int dt_rs,
                                const float* __restrict__ dt_bias,
                                const float* __restrict__ A,
                                float* __restrict__ cs,
                                float* __restrict__ dtv, int chunk, int h,
                                const float* sp_tab, int sp_nk) {
  const int bi = blockIdx.z, wm1 = width - 1;
  if (cs != nullptr && blockIdx.x == gridDim.x - 1) {
    dt_scan(dt, dt_rs, dt_bias, A, cs, dtv, bi, l, chunk, h, sp_tab, sp_nk);
    return;
  }
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= dxbc) return;
  // Input at sequence position pos; negative positions read the tail.
  auto at = [&](int pos) -> float {
    return pos >= 0
               ? to_f(xbc[(static_cast<size_t>(bi) * l + pos) * xbc_rs + c])
               : to_f(conv_state[(static_cast<size_t>(bi) * wm1 + wm1 + pos) *
                                     dxbc + c]);
  };
  auto put = [&](int t, float acc) {
    act[(static_cast<size_t>(bi) * l + t) * dxbc + c] = from_f<T>(silu_act(
        round_to<T>(__fadd_rn(acc, conv_b[c])), silu_tab, silu_nk));
  };
  const int t0 = blockIdx.y * CONV_T;
  if (t0 < l && width <= CONV_W) {
    // win[i]: the input at t0 - (CONV_W - 1) + i; output t takes taps j at
    // win[t - t0 + CONV_W - width + j], in the order of j.
    float w[CONV_W], win[CONV_T + CONV_W - 1];
#pragma unroll
    for (int j = 0; j < CONV_W; ++j)
      w[j] = j < width ? conv_w[j * dxbc + c] : 0.f;
#pragma unroll
    for (int i = 0; i < CONV_T + CONV_W - 1; ++i) {
      const int pos = t0 - (CONV_W - 1) + i;
      win[i] = pos >= -wm1 && pos < l ? at(pos) : 0.f;
    }
#pragma unroll
    for (int tt = 0; tt < CONV_T; ++tt) {
      if (t0 + tt >= l) break;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < CONV_W; ++j)
        if (j < width)
          acc = __fadd_rn(acc, __fmul_rn(win[tt + CONV_W - width + j], w[j]));
      put(t0 + tt, acc);
    }
  } else {
    for (int t = t0; t < l && t < t0 + CONV_T; ++t) {   // wider convs
      float acc = 0.f;
      for (int j = 0; j < width; ++j)
        acc = __fadd_rn(acc, __fmul_rn(at(t - wm1 + j), conv_w[j * dxbc + c]));
      put(t, acc);
    }
  }
  if (blockIdx.y == 0)
    for (int t = 0; t < wm1; ++t)
      new_conv[(static_cast<size_t>(bi) * wm1 + t) * dxbc + c] =
          from_f<T>(at(l - wm1 + t));
}

// ---- the SIMT body ---------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(
    const T* __restrict__ act, const T* __restrict__ dt, int dt_rs,
    const float* __restrict__ dt_bias, const float* __restrict__ A,
    const float* __restrict__ D, const float* __restrict__ state_in,
    float* __restrict__ state_out, T* __restrict__ y, int l, int chunk,
    int h, int p, int g, int n, const float* sp_tab, int sp_nk) {
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
          y[r * di + xoff + pi] = from_f<T>(
              round_to<T>(round_to<T>(acc[j]) + round_to<T>(xv * Dt)));
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

// ---- the tensor-core body --------------------------------------------------

using namespace ssd_tc;
constexpr int P = 64;            // head_dim the tensor-core body takes
constexpr int PSTAGES = 2;       // ring stages (two blocks an SM at bf16)
constexpr int PTHREADS = 128;    // one warpgroup
constexpr int MAX_CHUNK = 256;
constexpr int MAX_SMEM = 232448;

// A stream tile of 64 rows x 64 columns: one bf16 box (an exact bf16
// term, read by wgmma where it lands) or an fp32 unit of two boxes (split
// into TERMS terms first).
template <typename T> struct Stream;
template <> struct Stream<float> {
  static constexpr int TS = TERMS;
};
template <> struct Stream<__nv_bfloat16> {
  static constexpr int TS = 1;
};

template <typename T>
__device__ __forceinline__ void load_stream(uint8_t* dst,
                                            const CUtensorMap* m,
                                            uint64_t* bar, int col, int row) {
  if constexpr (Stream<T>::TS == 1) {
    wg::bar_expect(bar, CHUNK_BYTES);
    wg::tma_load_2d(dst, m, bar, col, row);
  } else {
    load_unit(dst, m, bar, col, row);
  }
}

// The stream tile at src as the TS terms wgmma reads, at dst, term_stride
// apart (bf16: the chunk copied; fp32: the unit split).
template <typename T>
__device__ __forceinline__ void stream_terms(const uint8_t* src, uint8_t* dst,
                                             int term_stride, int tid) {
  if constexpr (Stream<T>::TS == 1)
    copy_chunk<PTHREADS>(src, dst, tid);
  else
    split_unit<PTHREADS>(src, dst, term_stride, tid, One());
}

// The stream tile at src, row r times scale(r) in fp32, as TERMS terms at
// dst, CHUNK_BYTES apart.
template <typename T, typename SC>
__device__ __forceinline__ void scaled_terms(const uint8_t* src, uint8_t* dst,
                                             int tid, SC scale) {
  if constexpr (Stream<T>::TS == 1)
    split_chunk<PTHREADS>(src, dst, CHUNK_BYTES, tid, scale);
  else
    split_unit<PTHREADS>(src, dst, CHUNK_BYTES, tid, scale);
}

// Shared memory at n = NS: the ring; C_q's terms (TS x NS / 64 chunks,
// term i of column chunk v at (i NS / 64 + v) chunks); the split terms
// (TERMS chunks, and TERMS more for fp32 B tiles in the state blocks); the
// score fragments (L / 64 tiles of 16 KB: float4 e4 of thread t at e4 *
// 128 + t); cs and dt of the chunk; the ring's barriers.
template <typename T, int NS> struct PCarve {
  static constexpr int TS = Stream<T>::TS;
  static constexpr int NC = NS / 64;
  static constexpr int RING = PSTAGES * UNIT_BYTES;
  static constexpr int CREG = TS * NC * CHUNK_BYTES;
  static constexpr int TERM = (TS > 1 ? 2 : 1) * TERMS * CHUNK_BYTES;
  static constexpr int SCORE = ROWS * ROWS * 4;
  static constexpr size_t bytes(int L) {
    return 1024 + RING + CREG + TERM + static_cast<size_t>(L / ROWS) * SCORE +
           2 * static_cast<size_t>(L) * 4 + PSTAGES * 8;
  }
};

struct KArgs {
  const void* act;
  void* y;
  const float* cs;
  const float* dtv;
  const float* D;
  const float* state_in;
  float* state_out;
  float* chunk_states;
  int b, c, L, l, h, g, hs, n_y, dxbc, multi;
};

// Every thread past its reads of unit j (fenced against the async proxy):
// the stage takes unit j + PSTAGES.
#define RELEASE(issue, j)                     \
  do {                                        \
    fence_async();                            \
    __syncthreads();                          \
    if (threadIdx.x == 0) issue((j) + PSTAGES); \
    ++(j);                                    \
  } while (0)

// A y block (see the note at the top).  yb: its index among the y blocks.
template <typename T, int NS>
__device__ __forceinline__ void y_block(const CUtensorMap* am,
                                        const CUtensorMap* smap,
                                        const KArgs& k,
                                        const Ring<PSTAGES>& ring,
                                        uint8_t* creg, uint8_t* terms,
                                        float* scache, float* csm, float* dtm,
                                        int yb) {
  using K = PCarve<T, NS>;
  constexpr int TS = K::TS, NC = K::NC;
  const int tid = threadIdx.x, wp = tid / 32, lane = tid % 32;
  const int L = k.L, h = k.h, g = k.g, hs = k.hs;
  const int hpg = h / g, spg = hpg / hs, sets = g * spg;
  const int per_q = k.b * k.c * sets;
  const int q = L / ROWS - 1 - yb / per_q, rem = yb % per_q;
  const int cell = rem / sets, set = rem % sets;
  const int gi = set / spg, h0 = gi * hpg + (set % spg) * hs;
  const int bi = cell / k.c, ci = cell % k.c, row0 = cell * L;
  const int nk = q + 1;
  const int di = h * P, boff = di + gi * NS, coff = di + g * NS + gi * NS;
  // Units: C_q's column tiles; each key tile's B column tiles; then per
  // head the incoming state's column units and its x tile of each key tile.
  const int n_a = NC * (nk + 1), per_head = NC + nk;
  const int total = n_a + hs * per_head;
  const auto issue = [&](int j) {
    if (j >= total) return;
    uint8_t* dst = ring.stage(j);
    uint64_t* bar = &ring.full[j % PSTAGES];
    if (j < NC) {
      load_stream<T>(dst, am, bar, coff + 64 * j, row0 + q * ROWS);
    } else if (j < n_a) {
      const int u = j - NC;
      load_stream<T>(dst, am, bar, boff + 64 * (u % NC), row0 + (u / NC) * ROWS);
    } else {
      const int u = j - n_a, hh = h0 + u / per_head, r = u % per_head;
      if (r < NC)
        load_unit(dst, smap, bar, 64 * r,
                  (k.multi ? (bi * k.c + ci) * h + hh : bi * h + hh) * P);
      else
        load_stream<T>(dst, am, bar, hh * P, row0 + (r - NC) * ROWS);
    }
  };
  if (tid == 0)
    for (int j = 0; j < PSTAGES; ++j) issue(j);
  int j = 0;
  const uint32_t creg_a = wg::smem_u32(creg), terms_a = wg::smem_u32(terms);

  for (int v = 0; v < NC; ++v) {   // C_q's terms, kept for the block
    stream_terms<T>(ring.arrived(j), creg + v * CHUNK_BYTES, NC * CHUNK_BYTES,
                    tid);
    RELEASE(issue, j);
  }

  // The score tiles S_k = C_q B_k^T (m64n64, K = n by column tiles), kept
  // as this thread's fragments.
  float4* sc4 = reinterpret_cast<float4*>(scache);
  for (int kk = 0; kk < nk; ++kk) {
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    for (int v = 0; v < NC; ++v) {
      const uint8_t* st = ring.arrived(j);
      uint32_t bt = wg::smem_u32(st);
      if constexpr (TS > 1) {
        split_unit<PTHREADS>(st, terms, CHUNK_BYTES, tid, One());
        RELEASE(issue, j);
        bt = terms_a;
      }
      wg::pin(s);
      wg::fence();
#pragma unroll
      for (int st4 = 0; st4 < 4; ++st4)
        for_terms<TS, TS>([&](int a, int bb) {
          wg::Mma<64>::ss<0, 0>(
              s, kmajor(creg_a + (a * NC + v) * CHUNK_BYTES, st4),
              kmajor(bt + bb * CHUNK_BYTES, st4));
        });
      wg::commit();
      wg::wait<0>();
      wg::pin(s);
      if constexpr (TS == 1) {
        RELEASE(issue, j);
      } else {
        __syncthreads();   // the terms are free
      }
    }
    float4* sc = sc4 + kk * 8 * 128 + tid;
#pragma unroll
    for (int e = 0; e < 32; e += 4)
      sc[e / 4 * 128] = make_float4(s[e], s[e + 1], s[e + 2], s[e + 3]);
  }

  // Fragment element e of thread tid: row r0 + 8 ((e / 2) % 2) of the
  // query tile, column 8 (e / 4) + kq (+ e % 2) of the key or x tile.
  const int r0 = 16 * wp + lane / 4, kq = 2 * (lane % 4);
  const T* act = static_cast<const T*>(k.act);
  T* yout = static_cast<T*>(k.y);
  for (int i = 0; i < hs; ++i) {
    const int hh = h0 + i;
    const size_t cbase = (static_cast<size_t>(bi) * h + hh) * k.l +
                         static_cast<size_t>(ci) * L;
    __syncthreads();   // the last head's reads of csm and dtm are done
    for (int e = tid; e < L; e += PTHREADS) {
      csm[e] = k.cs[cbase + e];
      dtm[e] = k.dtv[cbase + e];
    }
    __syncthreads();
    const float c0 = csm[q * ROWS + r0], c1 = csm[q * ROWS + r0 + 8];

    // The carried-state term: (C_q . state^T) * exp(cs_i).
    float o[32];
    {
      float yo[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) yo[e] = 0.f;
      for (int v = 0; v < NC; ++v) {
        split_unit<PTHREADS>(ring.arrived(j), terms, CHUNK_BYTES, tid, One());
        RELEASE(issue, j);
        wg::pin(yo);
        wg::fence();
#pragma unroll
        for (int st4 = 0; st4 < 4; ++st4)
          for_terms<TS, TERMS>([&](int a, int bb) {
            wg::Mma<64>::ss<0, 0>(
                yo, kmajor(creg_a + (a * NC + v) * CHUNK_BYTES, st4),
                kmajor(terms_a + bb * CHUNK_BYTES, st4));
          });
        wg::commit();
        wg::wait<0>();
        wg::pin(yo);
        __syncthreads();   // the terms are free
      }
      const float e0 = expf(c0), e1 = expf(c1);
#pragma unroll
      for (int e = 0; e < 32; ++e) o[e] = yo[e] * ((e / 2) % 2 ? e1 : e0);
    }

    // y += (S (.) decay (.) dt) x_k over the key tiles.
    for (int kk = 0; kk < nk; ++kk) {
      const int kb = kk * ROWS;
      const bool diag = kk == q;
      const float4* sc = sc4 + kk * 8 * 128 + tid;
      uint32_t pa[TERMS][4][4];
#pragma unroll
      for (int st4 = 0; st4 < 4; ++st4)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int e4 = 2 * st4 + e2;
          const float4 sv = sc[e4 * 128];
          const int key = 8 * e4 + kq;
          const float2 ck = *reinterpret_cast<const float2*>(csm + kb + key);
          const float2 dk = *reinterpret_cast<const float2*>(dtm + kb + key);
          float v0 = sv.x * expf(c0 - ck.x) * dk.x,
                v1 = sv.y * expf(c0 - ck.y) * dk.y,
                v2 = sv.z * expf(c1 - ck.x) * dk.x,
                v3 = sv.w * expf(c1 - ck.y) * dk.y;
          if (diag) {
            v0 = key <= r0 ? v0 : 0.f;
            v1 = key + 1 <= r0 ? v1 : 0.f;
            v2 = key <= r0 + 8 ? v2 : 0.f;
            v3 = key + 1 <= r0 + 8 ? v3 : 0.f;
          }
          uint32_t w0[TERMS], w1[TERMS];
          split2(v0, v1, w0);
          split2(v2, v3, w1);
#pragma unroll
          for (int tt = 0; tt < TERMS; ++tt) {
            pa[tt][st4][2 * e2] = w0[tt];
            pa[tt][st4][2 * e2 + 1] = w1[tt];
          }
        }
      const uint8_t* st = ring.arrived(j);
      uint32_t xt = wg::smem_u32(st);
      if constexpr (TS > 1) {
        split_unit<PTHREADS>(st, terms, CHUNK_BYTES, tid, One());
        RELEASE(issue, j);
        xt = terms_a;
      }
      wg::pin(o);
      wg::fence();
#pragma unroll
      for (int st4 = 0; st4 < 4; ++st4)
        for_terms<TERMS, TS>([&](int a, int bb) {
          wg::Mma<64>::rs<1>(o, pa[a][st4], mnmajor(xt + bb * CHUNK_BYTES, st4));
        });
      wg::commit();
      wg::wait<0>();
      wg::pin(o);
      if constexpr (TS == 1) {
        RELEASE(issue, j);
      } else {
        __syncthreads();   // the terms are free
      }
    }

    // The D skip in the stream dtype (prefill_chunk.py:147-156), y in T.
    const float Dt = round_to<T>(k.D[hh]);
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const size_t grow = static_cast<size_t>(row0 + q * ROWS + r0 +
                                              8 * ((e / 2) % 2));
      const int col = hh * P + 8 * (e / 4) + kq;
      const T* xp = act + grow * k.dxbc + col;
      T* yp = yout + grow * di + col;
      yp[0] = from_f<T>(round_to<T>(round_to<T>(o[e]) +
                                    round_to<T>(to_f(xp[0]) * Dt)));
      yp[1] = from_f<T>(round_to<T>(round_to<T>(o[e + 1]) +
                                    round_to<T>(to_f(xp[1]) * Dt)));
    }
  }
}

// A state block (see the note at the top).  sb: its index among them.
template <typename T, int NS>
__device__ __forceinline__ void state_block(const CUtensorMap* am,
                                            const KArgs& k,
                                            const Ring<PSTAGES>& ring,
                                            uint8_t* terms, float* csm,
                                            float* dtm, int sb) {
  using K = PCarve<T, NS>;
  constexpr int TS = K::TS, NC = K::NC;
  const int tid = threadIdx.x, wp = tid / 32, lane = tid % 32;
  const int L = k.L, h = k.h, tiles = L / ROWS;
  const int cell = sb / h, hh = sb % h, gi = hh / (h / k.g);
  const int bi = cell / k.c, ci = cell % k.c, row0 = cell * L;
  const int boff = h * P + gi * NS;
  // Units: per 64-row tile, x's tile, then B's column tiles.
  const int total = tiles * (1 + NC);
  const auto issue = [&](int j) {
    if (j >= total) return;
    const int lt = j / (1 + NC), v = j % (1 + NC);
    load_stream<T>(ring.stage(j), am, &ring.full[j % PSTAGES],
                   v == 0 ? hh * P : boff + 64 * (v - 1), row0 + lt * ROWS);
  };
  if (tid == 0)
    for (int j = 0; j < PSTAGES; ++j) issue(j);
  const size_t cbase = (static_cast<size_t>(bi) * h + hh) * k.l +
                       static_cast<size_t>(ci) * L;
  for (int e = tid; e < L; e += PTHREADS) {
    csm[e] = k.cs[cbase + e];
    dtm[e] = k.dtv[cbase + e];
  }
  __syncthreads();
  const float cl = csm[L - 1];
  uint8_t* bterms = terms + TERMS * CHUNK_BYTES;
  const uint32_t xa = wg::smem_u32(terms), ba = wg::smem_u32(bterms);

  float acc[NC][32];
#pragma unroll
  for (int v = 0; v < NC; ++v)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[v][e] = 0.f;
  int j = 0;
  for (int lt = 0; lt < tiles; ++lt) {
    // x (.) dt (.) exp(cs_L - cs) as TERMS terms (MN-major A).
    scaled_terms<T>(ring.arrived(j), terms, tid, [&](int r) {
      const int t = lt * ROWS + r;
      return dtm[t] * expf(cl - csm[t]);
    });
    RELEASE(issue, j);
#pragma unroll
    for (int v = 0; v < NC; ++v) {
      const uint8_t* st = ring.arrived(j);
      uint32_t bt = wg::smem_u32(st);
      if constexpr (TS > 1) {
        split_unit<PTHREADS>(st, bterms, CHUNK_BYTES, tid, One());
        RELEASE(issue, j);
        bt = ba;
      }
      wg::pin(acc[v]);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk)
        for_terms<TERMS, TS>([&](int a, int bb) {
          wg::Mma<64>::ss<1, 1>(acc[v], mnmajor(xa + a * CHUNK_BYTES, kk),
                                mnmajor(bt + bb * CHUNK_BYTES, kk));
        });
      wg::commit();
      wg::wait<0>();
      wg::pin(acc[v]);
      if constexpr (TS == 1) {
        RELEASE(issue, j);
      } else {
        __syncthreads();   // the B terms are free
      }
    }
  }

  // One chunk: state_out = state_in * exp(cs_L) + the chunk state; several:
  // the chunk state to scratch for the pass over the chunks.
  const size_t pn = static_cast<size_t>(P) * NS;
  const float dcl = expf(cl);
  const size_t sidx = (static_cast<size_t>(bi) * h + hh) * pn;
  const size_t cidx = ((static_cast<size_t>(bi) * k.c + ci) * h + hh) * pn;
#pragma unroll
  for (int v = 0; v < NC; ++v)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const size_t off =
          static_cast<size_t>(16 * wp + lane / 4 + 8 * ((e / 2) % 2)) * NS +
          64 * v + 8 * (e / 4) + 2 * (lane % 4);
      float2 val = make_float2(acc[v][e], acc[v][e + 1]);
      if (k.multi) {
        *reinterpret_cast<float2*>(k.chunk_states + cidx + off) = val;
      } else {
        const float2 sin =
            *reinterpret_cast<const float2*>(k.state_in + sidx + off);
        val = make_float2(sin.x * dcl + val.x, sin.y * dcl + val.y);
        *reinterpret_cast<float2*>(k.state_out + sidx + off) = val;
      }
    }
}

// Grid: n_y y blocks (query tiles with more key tiles first), then the
// state blocks; PTHREADS threads; PCarve<T, NS>::bytes(L) bytes of dynamic
// shared memory.  am: the act stream as (b l, dxbc) tiles of 64 x 64;
// smap: the incoming states as (rows of p, n) fp32 units.
template <typename T, int NS>
__global__ void __launch_bounds__(PTHREADS) ssd_prefill_wgmma_kernel(
    const __grid_constant__ CUtensorMap am,
    const __grid_constant__ CUtensorMap smap, const KArgs k) {
  using K = PCarve<T, NS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = wg::align1024(smem_raw);
  uint8_t* creg = base + K::RING;
  uint8_t* terms = creg + K::CREG;
  float* scache = reinterpret_cast<float*>(terms + K::TERM);
  float* csm = scache + (k.L / ROWS) * (K::SCORE / 4);
  float* dtm = csm + k.L;
  uint64_t* bars = reinterpret_cast<uint64_t*>(dtm + k.L);
  const Ring<PSTAGES> ring{base, bars};
  if (threadIdx.x == 0) {
    for (int s = 0; s < PSTAGES; ++s) wg::bar_init(&bars[s], 1);
    wg::fence_bar_init();
  }
  __syncthreads();
  if (static_cast<int>(blockIdx.x) < k.n_y)
    y_block<T, NS>(&am, &smap, k, ring, creg, terms, scache, csm, dtm,
                   blockIdx.x);
  else
    state_block<T, NS>(&am, k, ring, terms, csm, dtm, blockIdx.x - k.n_y);
}

// Several chunks: each element of the (b, h, p, n) state walks the chunks
// in order, leaving each chunk's incoming state in place of its chunk
// state (the y blocks read it) and the last state in state_out.
__global__ void state_pass_kernel(const float* __restrict__ state_in,
                                  float* __restrict__ chunk_states,
                                  float* __restrict__ state_out,
                                  const float* __restrict__ cs, int b, int c,
                                  int L, int h, int pn) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(b) * h * pn) return;
  const size_t bh = e / pn, inner = e % pn;
  const size_t bi = bh / h, hh = bh % h, l = static_cast<size_t>(c) * L;
  float run = state_in[e];
  for (int ci = 0; ci < c; ++ci) {
    float* cell = chunk_states + ((bi * c + ci) * h + hh) * pn + inner;
    const float t = *cell;
    *cell = run;
    run = run * expf(cs[bh * l + static_cast<size_t>(ci) * L + L - 1]) + t;
  }
  state_out[e] = run;
}

template <typename T, int NS>
int launch_wgmma(const PrefillArgs* a, cudaStream_t s) {
  using K = PCarve<T, NS>;
  const int b = static_cast<int>(a->b), l = static_cast<int>(a->l);
  const int L = static_cast<int>(a->chunk), c = l / L;
  const int h = static_cast<int>(a->h), g = static_cast<int>(a->g);
  const int hs = static_cast<int>(a->hs), dxbc = h * P + 2 * g * NS;
  const size_t smem = K::bytes(L);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool BF = Stream<T>::TS == 1;
  const cuuint32_t abox[2] = {BF ? 64u : 32u, static_cast<cuuint32_t>(ROWS)};
  const cuuint64_t ad[2] = {static_cast<cuuint64_t>(dxbc),
                            static_cast<cuuint64_t>(b) * l};
  const cuuint64_t as[1] = {static_cast<cuuint64_t>(dxbc) * sizeof(T)};
  const cuuint32_t sbox[2] = {32, static_cast<cuuint32_t>(ROWS)};
  const cuuint64_t sd[2] = {
      static_cast<cuuint64_t>(NS),
      static_cast<cuuint64_t>(b) * (c > 1 ? c : 1) * h * P};
  const cuuint64_t ss[1] = {static_cast<cuuint64_t>(NS) * 4};
  CUtensorMap am, smap;
  if (!wg::make_map(&am, a->act, 2, ad, as, abox, 128,
                    BF ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !wg::make_map(&smap, c > 1 ? a->chunk_states : a->state_in, 2, sd, ss,
                    sbox, 128, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_prefill_wgmma_kernel<T, NS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  KArgs k{a->act,
          a->y,
          static_cast<const float*>(a->cs),
          static_cast<const float*>(a->dtv),
          static_cast<const float*>(a->D),
          static_cast<const float*>(a->state_in),
          static_cast<float*>(a->state_out),
          static_cast<float*>(a->chunk_states),
          b, c, L, l, h, g, hs, b * c * (L / ROWS) * (h / hs), dxbc, c > 1};
  const int n_s = b * c * h;
  if (c == 1) {
    ssd_prefill_wgmma_kernel<T, NS><<<k.n_y + n_s, PTHREADS, smem, s>>>(
        am, smap, k);
    return static_cast<int>(cudaGetLastError());
  }
  KArgs ks = k;
  ks.n_y = 0;
  ssd_prefill_wgmma_kernel<T, NS><<<n_s, PTHREADS, smem, s>>>(am, smap, ks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pn = P * NS, total = b * h * pn;
  state_pass_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(a->state_in),
      static_cast<float*>(a->chunk_states),
      static_cast<float*>(a->state_out), static_cast<const float*>(a->cs), b,
      c, L, h, pn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_prefill_wgmma_kernel<T, NS><<<k.n_y, PTHREADS, smem, s>>>(am, smap, k);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

// The conv pass, then the body `body` names.  The SIMT body: l % chunk ==
// 0, p <= 64, p * n <= 8192.  The tensor-core body: p == 64, n 64 or 128,
// chunk a multiple of 64 up to MAX_CHUNK, hs a divisor of h / g, 16-byte
// aligned act and state_in.  Returns the cudaError_t
// (cudaErrorInvalidValue for shapes the body does not take or a refused
// tensor map).
extern "C" int mamba2_prefill_launch(const PrefillArgs* a) {
  if (a->b == 0) return 0;
  const int b = static_cast<int>(a->b), l = static_cast<int>(a->l);
  const int chunk = static_cast<int>(a->chunk), h = static_cast<int>(a->h);
  const int p = static_cast<int>(a->p), g = static_cast<int>(a->g);
  const int n = static_cast<int>(a->n), width = static_cast<int>(a->width);
  const bool tc = a->body == 1;
  const auto a16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  if (chunk <= 0 || l % chunk != 0 || g <= 0 || h % g != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc ? (p != P || (n != 64 && n != 128) || chunk % ROWS != 0 ||
            chunk > MAX_CHUNK || a->hs <= 0 || (h / g) % a->hs != 0 ||
            !a16(a->act) || !a16(a->state_in))
         : (p > 64 || p * n > 8192))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  const int dxbc = h * p + 2 * g * n;
  const int tiles = (l + CONV_T - 1) / CONV_T;
  const int scans = (l / chunk * h + SCAN_WARPS - 1) / SCAN_WARPS;
  const dim3 cgrid((dxbc + 255) / 256 + (tc ? 1 : 0),
                   tc && scans > tiles ? scans : tiles, b);
  const float* silu_tab = static_cast<const float*>(a->silu_tab);
  const float* sp_tab = static_cast<const float*>(a->sp_tab);
  const int silu_nk = static_cast<int>(a->silu_nk);
  const int sp_nk = static_cast<int>(a->sp_nk);
  cudaError_t err = cudaSuccess;
  DISPATCH_T(a->dtype, {
    conv_act_kernel<T><<<cgrid, 256, 0, s>>>(
        static_cast<const T*>(a->xbc), static_cast<int>(a->xbc_rs),
        static_cast<const T*>(a->conv_state),
        static_cast<const float*>(a->conv_w),
        static_cast<const float*>(a->conv_b), static_cast<T*>(a->act),
        static_cast<T*>(a->new_conv), l, dxbc, width, silu_tab, silu_nk,
        static_cast<const T*>(a->dt), static_cast<int>(a->dt_rs),
        static_cast<const float*>(a->dt_bias),
        static_cast<const float*>(a->A),
        tc ? static_cast<float*>(a->cs) : nullptr,
        static_cast<float*>(a->dtv), chunk, h, sp_tab, sp_nk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (tc)
      return n == 128 ? launch_wgmma<T, 128>(a, s) : launch_wgmma<T, 64>(a, s);
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(p) * (n + 1) + 2 * chunk +
                         tile_floats(p, n));
    err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_scan_kernel<T><<<dim3(b, h), NT, smem, s>>>(
        static_cast<const T*>(a->act), static_cast<const T*>(a->dt),
        static_cast<int>(a->dt_rs), static_cast<const float*>(a->dt_bias),
        static_cast<const float*>(a->A), static_cast<const float*>(a->D),
        static_cast<const float*>(a->state_in),
        static_cast<float*>(a->state_out), static_cast<T*>(a->y), l, chunk,
        h, p, g, n, sp_tab, sp_nk);
  });
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory the tensor-core body asks for (stream
// dtype code 0 fp32 / 1 bf16) at n = 128 and a chunk of L rows.
extern "C" int mamba2_prefill_wgmma_smem(int dtype, int L) {
  return static_cast<int>(dtype == 0 ? PCarve<float, 128>::bytes(L)
                                     : PCarve<__nv_bfloat16, 128>::bytes(L));
}
