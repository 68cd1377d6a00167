// SSD intra-chunk pass: the diagonal blocks and the chunk states.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py:62 ssd_chunk.
// Per (batch, chunk, head), in fp32:
//   decay   = exp(cs_i - cs_j) for j <= i, else 0   (cs: the CumBA prefix
//             sums A_cum of the chunk's log decays)
//   y_diag  = ((C B^T) (.) decay) x                 (L, p)
//   state   = (x (.) exp(cs_L - cs))^T B            (p, n)
// with B and C those of the head's group (head / heads_per_group).  The
// inter-chunk recurrence stays outside, as in the JAX package.
//
// Bound.  At b = 4, two chunks of 256, 24 heads, p 64, n 128 the lower
// triangle of C B^T (once per group), its product with x and the state
// product are ~1.7 GFLOP against ~34 MB of inputs and outputs (3.35 TB/s:
// 0.0101 ms).  On the CUDA cores (67 TFLOP/s) the operations bound it
// (0.0253 ms); as fp32-accurate tensor-core products (ssd_tc.cuh: six bf16
// products each, ~165 TFLOP/s) the two bounds meet (0.0103 ms).
//
// Two bodies; the wrapper's path() picks one from shapes and alignment:
//
// * "wgmma" (p 64, n 64 or 128, L a multiple of 64 up to 4096, 16-byte
//   aligned x, B and C): ssd_chunk_wgmma_kernel below, on the tensor cores.
// * "simt", the rest: ssd_chunk_kernel, fp32 on the CUDA cores, one block
//   per (batch, chunk, head) over the 64 x 64 tiles it shares with
//   prefill_chunk.cu (common.cuh: ssd_tiles): C B^T and the decay one 64 x
//   64 score tile at a time, tiles above the diagonal never computed, y
//   accumulated in registers, the state product over 64-row key tiles.
//
// The TPU kernel holds a cell's whole (L, L) block in VMEM and takes one
// (batch, chunk, head) cell a grid step.  The wgmma body splits the work
// instead so that a group's C B^T is computed once for many heads, and
// runs every product as six bf16 wgmmas on the terms of its fp32
// operands (ssd_tc.cuh).  One launch, two kinds of block of 384 threads:
// warpgroups 1 and 2 are producers, which split fp32 tiles into bf16
// terms, and warpgroup 0 is the consumer, which runs the wgmmas on them.
// Two handoff buffers pass between them through mbarriers (full: the
// producers are done; empty: the consumer's products are), so the
// producers make step u + 1's operands while the consumer's products of
// step u run.
//
// * y blocks, one per (batch, chunk, 64-row query tile q, set of hs heads
//   of one group).  The consumer holds C_q's terms as A fragments in
//   registers (read from global memory) and takes the score tiles S_k =
//   C_q B_k^T for key tiles k <= q (m64n64, K = n) on the B terms the
//   producers split, keeping them in shared memory as fp32 fragments (at
//   most KG = 4 tiles, 64 KB; a query tile with more key tiles takes them
//   in groups of four and adds each group's y to the last).  Then a step
//   for each head of the set and each key tile: the producers split x's
//   unit into terms and take the decay exp(cs_i - cs_j), masked for j >
//   i, times the fp32 scores, split into terms and stored in the order of
//   the consumer's A fragments; the consumer runs y += S_decayed x_k
//   (m64n64, A from registers, x MN-major through the transpose bit: no
//   transposed copy), holds each head's y and writes it.  Query tiles
//   with more key tiles come first in the grid.  hs (kernels/ssd_chunk.py:
//   heads_per_set) is the smallest divisor of the heads per group whose y
//   blocks fit in one wave of the SMs (6 at the ablation's shape: 128 y
//   blocks), so every y block starts at once and a group's score tile is
//   computed h / hs times, not h times.
// * state blocks, one per (batch, chunk, head): over the chunk's 64-row
//   tiles, the producers split x weighted by exp(cs_L - cs_l) and B into
//   terms, and the consumer runs state += Xw^T B (m64nN, both operands
//   MN-major: wgmma's A and B transpose bits).  b c h of them (192 at the
//   ablation's shape) fill the card without splitting n.
//
// Data movement: fp32 64 x 64 units of B and x arrive by TMA (2-D tensor
// maps over the (b c L, g n) and (b c L, h p) views, no copy) into a ring
// of three stages with mbarriers, each unit issued once the unit three
// before it has been split; only the producers take units, in order (an
// mbarrier parity wait cannot tell a unit from the one three before it).
// The producers write the bf16 terms in the layout the descriptors read
// and fence the async proxy before their arrival.  Every sum is taken in
// a fixed order: the same bits every call.
#include "common.cuh"
#include "ssd_tc.cuh"

using namespace ssd_tiles;

__global__ void __launch_bounds__(NT) ssd_chunk_kernel(
    const float* __restrict__ x, const float* __restrict__ acum,
    const float* __restrict__ B, const float* __restrict__ C,
    float* __restrict__ y, float* __restrict__ states, int c, int L, int h,
    int p, int g, int n) {
  extern __shared__ float sm[];
  float* cs = sm;  // (L,) this cell's prefix sums
  const Tiles tl = carve(cs + L, p, n);
  const int hi = blockIdx.x, ci = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, gi = hi / (h / g);
  const int hp = h * p, gn = g * n;
  const size_t cell = static_cast<size_t>(bi) * c + ci;  // (batch, chunk)
  const float* xc = x + cell * L * hp + hi * p;          // rows at stride hp
  float* yc = y + cell * L * hp + hi * p;
  const float* Bc = B + cell * L * gn + gi * n;          // rows at stride gn
  const float* Cc = C + cell * L * gn + gi * n;
  const float* csg = acum + (static_cast<size_t>(bi) * h + hi) * c * L +
                     static_cast<size_t>(ci) * L;

  for (int t = tid; t < L; t += NT) cs[t] = csg[t];
  __syncthreads();
  const float cl = cs[L - 1];

  auto load_b = [&](int s0, int tk) {
    load_tile(tl.Bt, tl.ns, Bc + static_cast<size_t>(s0) * gn, gn, tk, n,
              Ident());
  };
  auto load_x = [&](int s0, int tk) {
    load_tile(tl.Xt, tl.ps, xc + static_cast<size_t>(s0) * hp, hp, tk, p,
              Ident());
  };
  auto load_xw = [&](int s0, int tk) {
    load_tile(tl.Xt, tl.ps, xc + static_cast<size_t>(s0) * hp, hp, tk, p,
              [&](int r, float v) { return v * expf(cl - cs[s0 + r]); });
  };

  for (int q0 = 0; q0 < L; q0 += TQ) {
    const int tq = min(TQ, L - q0);
    load_tile(tl.Ct, tl.ns, Cc + static_cast<size_t>(q0) * gn, gn, tq, n,
              Ident());
    __syncthreads();
    float acc[ACC_Y];
#pragma unroll
    for (int j = 0; j < ACC_Y; ++j) acc[j] = 0.f;
    diag_rows(acc, tl, cs, q0, tq, L, p, n, load_b, load_x);
#pragma unroll
    for (int j = 0; j < ACC_Y; ++j) {
      const int e = tid + j * NT;
      if (e < tq * p) {
        const int i = e / p, pi = e % p;
        yc[static_cast<size_t>(q0 + i) * hp + pi] = acc[j];
      }
    }
  }

  float sacc[ACC_S];
  chunk_state(sacc, tl, L, p, n, load_b, load_xw);
  float* st = states + (cell * h + hi) * p * n;
#pragma unroll
  for (int j = 0; j < ACC_S; ++j) {
    const int e = tid + j * NT;
    if (e < p * n) st[e] = sacc[j];
  }
}

// x (b, c, L, h, p), A_cum (b, h, c, L), B and C (b, c, L, g, n), all
// contiguous fp32.  Writes y (b, c, L, h, p) and states (b, c, h, p, n)
// fp32.  p <= 64, p * n <= 8192, h % g == 0.  Returns the cudaError_t.
extern "C" int ssd_chunk_launch(const void* x, const void* acum,
                                const void* B, const void* C, void* y,
                                void* states, int b, int c, int L, int h,
                                int p, int g, int n, void* stream) {
  if (b == 0 || c == 0) return 0;
  if (p > 64 || p * n > 8192 || L <= 0 || g <= 0 || h % g != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (static_cast<size_t>(L) +
                                       tile_floats(p, n));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_kernel<<<dim3(h, c, b), NT, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(acum),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(y), static_cast<float*>(states), c, L, h, p, g, n);
  return static_cast<int>(cudaGetLastError());
}

namespace {
using namespace ssd_tc;
constexpr int P = 64;              // head_dim the wgmma body takes
constexpr int KG = 4;              // score tiles a y block holds at once
constexpr int MAX_SMEM = 232448;   // dynamic shared memory of one block
constexpr int MAX_L = 4096;

// Shared memory of the wgmma body at n = NS: the ring of fp32 units; the
// work space; the chunk's prefix sums; the barriers (the ring's, then
// full[2] and empty[2] of the handoff).  A y block's work space holds two
// handoff buffers of YBUF bytes (B terms while it takes scores; x's terms
// and the decayed scores' A fragments in its head loop) and the score
// fragments; a state block's, two buffers of Xw and B terms.
template <int NS> struct Carve {
  static constexpr int NC = NS / 64;                  // units of a B / C row
  static constexpr int TERM_N = NC * CHUNK_BYTES;     // a term of 64 x NS
  static constexpr int RING = STAGES * UNIT_BYTES;
  static constexpr int BT = TERMS * TERM_N;           // B terms
  static constexpr int XT = TERMS * CHUNK_BYTES;      // a 64 x 64 tile's
  static constexpr int YBUF = BT > 2 * XT ? BT : 2 * XT;
  static constexpr int SBUF = XT + BT;
  static constexpr int SC = KG * 16 * 128 * 8;        // KG 64 x 64 fp32
  static constexpr int WORK =
      2 * YBUF + SC > 2 * SBUF ? 2 * YBUF + SC : 2 * SBUF;
  static constexpr int BARS = STAGES + 4;
  static constexpr size_t bytes(int L) {
    return 1024 + RING + WORK + static_cast<size_t>(L) * 4 + BARS * 8;
  }
};

// The handoff between the producers (warpgroups 1 and 2) and the
// consumer (warpgroup 0): step u's buffer u % 2 is filled by the
// producers, who arrive on full[u % 2] (256 arrivals), and drained by the
// consumer, who arrives on empty[u % 2] (128) once its products are done.
struct Handoff {
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ void wait_empty(int u) const {  // producers
    if (u >= 2) wg::bar_wait(&empty[u % 2], (u / 2 - 1) & 1);
  }
  __device__ __forceinline__ void wait_full(int u) const {   // consumer
    wg::bar_wait(&full[u % 2], (u / 2) & 1);
  }
};

// A y block (see the note at the top).  yb: its index among the y blocks.
template <int NS>
__device__ __forceinline__ void y_block(
    const CUtensorMap* xm, const CUtensorMap* bm, const float* __restrict__ C,
    const float* __restrict__ acum, float* __restrict__ y, const Ring<>& ring,
    const Handoff& ho, uint8_t* work, float* scache, float* cs, int yb,
    int cells, int c, int L, int h, int g, int hs) {
  using K = Carve<NS>;
  constexpr int NC = K::NC;
  const int tid = threadIdx.x, wgi = tid / WG, t = tid % WG;
  const int pt = tid - WG;            // a producer's index, 0 .. 255
  const int lane = t % 32, wp = t / 32;
  const int hpg = h / g, spg = hpg / hs, sets = g * spg;
  const int per_q = cells * sets;
  const int q = L / ROWS - 1 - yb / per_q, rem = yb % per_q;
  const int cell = rem / sets, set = rem % sets;
  const int gi = set / spg, h0 = gi * hpg + (set % spg) * hs;
  const int bi = cell / c, ci = cell % c, row0 = cell * L;
  const int nk = q + 1;

  // Unit j of the block: for each group of key tiles, the B tiles' units
  // and each head's x tiles (head by head).  Only the producers take
  // units, each in order (a waiter on unit j must have seen unit j -
  // STAGES land: an mbarrier parity wait cannot tell the two apart).
  const auto issue = [&](int j) {
    const int at = j;
    const CUtensorMap* m = nullptr;
    int col = 0, row = 0;
    for (int k0 = 0; k0 < nk && m == nullptr; k0 += KG) {
      const int nkg = min(KG, nk - k0);
      if (j < nkg * NC) {
        m = bm, col = gi * NS + (j % NC) * 64;
        row = row0 + (k0 + j / NC) * ROWS;
      } else if (j < nkg * NC + hs * nkg) {
        j -= nkg * NC;
        m = xm, col = (h0 + j / nkg) * P;
        row = row0 + (k0 + j % nkg) * ROWS;
      } else {
        j -= nkg * NC + hs * nkg;
      }
    }
    if (m != nullptr)
      load_unit(ring.stage(at), m, &ring.full[at % STAGES], col, row);
  };
  if (tid == 0)
    for (int j = 0; j < STAGES; ++j) issue(j);

  float4* sc4 = reinterpret_cast<float4*>(scache);
  int base = 0;   // the group's first unit
  int u = 0;      // handoff steps so far
  for (int k0 = 0; k0 < nk; k0 += KG) {
    const int nkg = min(KG, nk - k0);
    const int ybase = base + nkg * NC;   // the head loop's first unit
    if (wgi == 0) {
      // Consumer.  C_q's terms as A fragments in registers (read from
      // global memory), then the score tiles S_k = C_q B_k^T (m64n64, K =
      // n), stored as this warpgroup's fragments (float4 e4 of thread t at
      // e4 * 128 + t).
      uint32_t cf[TERMS][NS / 16][4];
      a_fragments<NS>(C + static_cast<size_t>(row0 + q * ROWS) * g * NS +
                          gi * NS,
                      static_cast<size_t>(g) * NS, t, cf);
      for (int kk = 0; kk < nkg; ++kk, ++u) {
        const uint32_t ba = wg::smem_u32(work + (u % 2) * K::YBUF);
        ho.wait_full(u);
        float s[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = 0.f;
        wg::pin(s);
        wg::fence();
#pragma unroll
        for (int st = 0; st < NS / 16; ++st)
          for_terms<TERMS, TERMS>([&](int a, int b) {
            wg::Mma<64>::rs<0>(s, cf[a][st], kmajor(ba + b * K::TERM_N, st));
          });
        wg::commit();
        wg::wait<0>();
        wg::pin(s);
        wg::bar_arrive(&ho.empty[u % 2]);
        float4* sc = sc4 + kk * 8 * 128 + t;
#pragma unroll
        for (int e = 0; e < 32; e += 4)
          sc[e / 4 * 128] = make_float4(s[e], s[e + 1], s[e + 2], s[e + 3]);
      }
    } else {
      // Producers: each B tile's units into terms, in buffer u % 2.
      for (int kk = 0; kk < nkg; ++kk, ++u) {
        uint8_t* bt = work + (u % 2) * K::YBUF;
        ho.wait_empty(u);
        for (int v = 0; v < NC; ++v) {
          const int j = base + kk * NC + v;
          split_unit<PRODUCERS>(ring.arrived(j), bt + v * CHUNK_BYTES,
                                K::TERM_N, pt, One());
          fence_async();
          producer_sync();
          if (pt == 0) issue(j + STAGES);
        }
        wg::bar_arrive(&ho.full[u % 2]);
      }
    }
    __syncthreads();   // the group's scores are in place
    // Each head: y += (S (.) decay) x over the group's key tiles, a step a
    // (head, key tile).  The producers split the step's x unit and take
    // the decayed scores, split into terms and stored in the order of
    // warpgroup 0's A fragments (a uint4 of thread t at i * 128 + t; the
    // producers of warpgroup p + 1 take the 16-key steps 2 p and 2 p + 1),
    // in buffer u % 2.  The consumer loads those fragments and runs the
    // step's products (A from registers, x's terms MN-major) while the
    // producers make the next step's operands.
    if (wgi == 0) {
      for (int hi = 0; hi < hs; ++hi) {
        const int hh = h0 + hi;
        float o[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) o[e] = 0.f;
        for (int kk = 0; kk < nkg; ++kk, ++u) {
          uint8_t* buf = work + (u % 2) * K::YBUF;
          const uint4* af = reinterpret_cast<const uint4*>(buf + K::XT) + t;
          const uint32_t xa = wg::smem_u32(buf);
          ho.wait_full(u);
          uint32_t pa[TERMS][ROWS / 16][4];
#pragma unroll
          for (int tt = 0; tt < TERMS; ++tt)
#pragma unroll
            for (int st = 0; st < ROWS / 16; ++st) {
              const uint4 v = af[(tt * 4 + st) * 128];
              pa[tt][st][0] = v.x, pa[tt][st][1] = v.y;
              pa[tt][st][2] = v.z, pa[tt][st][3] = v.w;
            }
          wg::pin(o);
          wg::fence();
#pragma unroll
          for (int st = 0; st < ROWS / 16; ++st)
            for_terms<TERMS, TERMS>([&](int a, int b) {
              wg::Mma<64>::rs<1>(o, pa[a][st],
                                 mnmajor(xa + b * CHUNK_BYTES, st));
            });
          wg::commit();
          wg::wait<0>();
          wg::pin(o);
          wg::bar_arrive(&ho.empty[u % 2]);
        }
        float* yr = y + static_cast<size_t>(row0 + q * ROWS + 16 * wp +
                                            lane / 4) * h * P +
                    hh * P + 2 * (lane % 4);
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          float2* dst = reinterpret_cast<float2*>(
              yr + static_cast<size_t>(8 * ((e / 2) % 2)) * h * P +
              8 * (e / 4));
          float2 v = make_float2(o[e], o[e + 1]);
          if (k0 > 0) {               // add to the earlier groups' y
            const float2 prev = *dst;
            v = make_float2(prev.x + v.x, prev.y + v.y);
          }
          *dst = v;
        }
      }
    } else {
      const int p = wgi - 1;          // 16-key steps 2 p, 2 p + 1
      // Score fragment element e of warpgroup 0's thread t: row r0 +
      // 8 ((e / 2) % 2), key 8 (e / 4) + 2 (t % 4) + e % 2.
      const int r0 = 16 * wp + lane / 4, kq = 2 * (lane % 4);
      for (int hi = 0; hi < hs; ++hi) {
        const int hh = h0 + hi;
        producer_sync();              // no one reads the last head's cs
        const float* csg = acum + (static_cast<size_t>(bi) * h + hh) * c * L +
                           static_cast<size_t>(ci) * L;
        for (int e = pt; e < L; e += PRODUCERS) cs[e] = csg[e];
        producer_sync();
        const float c0 = cs[q * ROWS + r0], c1 = cs[q * ROWS + r0 + 8];
        for (int kk = 0; kk < nkg; ++kk, ++u) {
          uint8_t* buf = work + (u % 2) * K::YBUF;
          const int j = ybase + hi * nkg + kk;
          ho.wait_empty(u);
          split_unit<PRODUCERS>(ring.arrived(j), buf, CHUNK_BYTES, pt, One());
          fence_async();
          producer_sync();
          if (pt == 0) issue(j + STAGES);
          const int kb = (k0 + kk) * ROWS;
          const bool diag = k0 + kk == q;
          const float4* sc = sc4 + kk * 8 * 128 + t;
          uint4* af = reinterpret_cast<uint4*>(buf + K::XT) + t;
#pragma unroll
          for (int sp = 0; sp < 2; ++sp) {
            const int st = 2 * p + sp;
            uint32_t pf[TERMS][4];
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const int e4 = 2 * st + e2;
              const float4 sv = sc[e4 * 128];
              const int key = 8 * e4 + kq;
              const float2 ck =
                  *reinterpret_cast<const float2*>(cs + kb + key);
              float v0 = sv.x * __expf(c0 - ck.x),
                    v1 = sv.y * __expf(c0 - ck.y),
                    v2 = sv.z * __expf(c1 - ck.x),
                    v3 = sv.w * __expf(c1 - ck.y);
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
                pf[tt][2 * e2] = w0[tt];
                pf[tt][2 * e2 + 1] = w1[tt];
              }
            }
#pragma unroll
            for (int tt = 0; tt < TERMS; ++tt)
              af[(tt * 4 + st) * 128] =
                  make_uint4(pf[tt][0], pf[tt][1], pf[tt][2], pf[tt][3]);
          }
          wg::bar_arrive(&ho.full[u % 2]);
        }
      }
    }
    __syncthreads();   // the scores are free for the next group
    base = ybase + hs * nkg;
  }
}

// A state block (see the note at the top).  sb: its index among them.
// The producers split each 64-row tile's x (weighted) and B into terms in
// buffer lt % 2; the consumer runs the tile's products (m64nNS, both
// operands MN-major) while the next tile's are made.
template <int NS>
__device__ __forceinline__ void state_block(
    const CUtensorMap* xm, const CUtensorMap* bm,
    const float* __restrict__ acum, float* __restrict__ states,
    const Ring<>& ring, const Handoff& ho, uint8_t* work, float* cs, int sb,
    int c, int L, int h, int g) {
  using K = Carve<NS>;
  constexpr int NC = K::NC;
  const int tid = threadIdx.x, wgi = tid / WG, t = tid % WG;
  const int pt = tid - WG;
  const int lane = t % 32, wp = t / 32;
  const int cell = sb / h, hh = sb % h, gi = hh / (h / g);
  const int bi = cell / c, ci = cell % c, row0 = cell * L;
  const int tiles = L / ROWS;

  // Unit j: per 64-row tile, x's unit, then B's.
  const auto issue = [&](int j) {
    const int lt = j / (1 + NC), v = j % (1 + NC);
    if (lt >= tiles) return;
    load_unit(ring.stage(j), v == 0 ? xm : bm, &ring.full[j % STAGES],
              v == 0 ? hh * P : gi * NS + (v - 1) * 64, row0 + lt * ROWS);
  };
  if (tid == 0)
    for (int j = 0; j < STAGES; ++j) issue(j);
  const float* csg = acum + (static_cast<size_t>(bi) * h + hh) * c * L +
                     static_cast<size_t>(ci) * L;
  for (int e = tid; e < L; e += THREADS) cs[e] = csg[e];
  __syncthreads();

  if (wgi != 0) {
    const float cl = cs[L - 1];
    for (int lt = 0; lt < tiles; ++lt) {
      uint8_t* xw = work + (lt % 2) * K::SBUF;
      uint8_t* bw = xw + K::XT;
      ho.wait_empty(lt);
      for (int v = 0; v <= NC; ++v) {
        const int j = lt * (1 + NC) + v;
        if (v == 0)
          split_unit<PRODUCERS>(ring.arrived(j), xw, CHUNK_BYTES, pt,
                                [&](int r) { return __expf(cl - cs[lt * ROWS + r]); });
        else
          split_unit<PRODUCERS>(ring.arrived(j), bw + (v - 1) * CHUNK_BYTES,
                                K::TERM_N, pt, One());
        fence_async();
        producer_sync();
        if (pt == 0) issue(j + STAGES);
      }
      wg::bar_arrive(&ho.full[lt % 2]);
    }
  } else {
    float acc[NS / 2];
#pragma unroll
    for (int e = 0; e < NS / 2; ++e) acc[e] = 0.f;
    for (int lt = 0; lt < tiles; ++lt) {
      const uint32_t xa = wg::smem_u32(work + (lt % 2) * K::SBUF);
      const uint32_t ba = xa + K::XT;
      ho.wait_full(lt);
      wg::pin(acc);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk)
        for_terms<TERMS, TERMS>([&](int a, int b) {
          wg::Mma<NS>::template ss<1, 1>(acc, mnmajor(xa + a * CHUNK_BYTES, kk),
                                         mnmajor(ba + b * K::TERM_N, kk));
        });
      wg::commit();
      wg::wait<0>();
      wg::pin(acc);
      wg::bar_arrive(&ho.empty[lt % 2]);
    }
    float* st = states + (static_cast<size_t>(cell) * h + hh) * P * NS +
                static_cast<size_t>(16 * wp + lane / 4) * NS + 2 * (lane % 4);
#pragma unroll
    for (int e = 0; e < NS / 2; e += 2)
      *reinterpret_cast<float2*>(st + (8 * ((e / 2) % 2)) * NS + 8 * (e / 4)) =
          make_float2(acc[e], acc[e + 1]);
  }
}
}  // namespace

// Grid: n_y y blocks (query tiles with more key tiles first), then b c h
// state blocks; THREADS threads; Carve<NS>::bytes(L) bytes of dynamic shared
// memory.  Maps: x as (b c L, h p), B and C as (b c L, g n), fp32 units of
// 64 x 64 in two 32-column boxes, 128-byte swizzle.
template <int NS>
__global__ void __launch_bounds__(THREADS, 1) ssd_chunk_wgmma_kernel(
    const __grid_constant__ CUtensorMap xm,
    const __grid_constant__ CUtensorMap bm,
    const float* __restrict__ C, const float* __restrict__ acum,
    float* __restrict__ y, float* __restrict__ states, int cells, int c,
    int L, int h, int g, int hs, int n_y) {
  using K = Carve<NS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = wg::align1024(smem_raw);
  uint8_t* work = base + K::RING;
  float* scache = reinterpret_cast<float*>(work + 2 * K::YBUF);
  float* cs = reinterpret_cast<float*>(work + K::WORK);
  uint64_t* bars = reinterpret_cast<uint64_t*>(cs + L);
  const Ring<> ring{base, bars};
  const Handoff ho{bars + STAGES, bars + STAGES + 2};
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) wg::bar_init(&bars[s], 1);
    for (int s = 0; s < 2; ++s) {
      wg::bar_init(&ho.full[s], PRODUCERS);
      wg::bar_init(&ho.empty[s], WG);
    }
    wg::fence_bar_init();
  }
  __syncthreads();
  if (static_cast<int>(blockIdx.x) < n_y)
    y_block<NS>(&xm, &bm, C, acum, y, ring, ho, work, scache, cs,
                blockIdx.x, cells, c, L, h, g, hs);
  else
    state_block<NS>(&xm, &bm, acum, states, ring, ho, work, cs,
                    blockIdx.x - n_y, c, L, h, g);
}

template <int NS>
static int launch_wgmma(const void* x, const void* acum, const void* B,
                        const void* C, void* y, void* states, int b, int c,
                        int L, int h, int g, int hs, cudaStream_t s) {
  const size_t smem = Carve<NS>::bytes(L);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t rows = static_cast<cuuint64_t>(b) * c * L;
  const cuuint32_t box[2] = {32, ROWS};
  const cuuint64_t xd[2] = {static_cast<cuuint64_t>(h) * P, rows};
  const cuuint64_t xs[1] = {static_cast<cuuint64_t>(h) * P * 4};
  const cuuint64_t bd[2] = {static_cast<cuuint64_t>(g) * NS, rows};
  const cuuint64_t bs[1] = {static_cast<cuuint64_t>(g) * NS * 4};
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap xm, bm;
  if (!wg::make_map(&xm, x, 2, xd, xs, box, 128, F32) ||
      !wg::make_map(&bm, B, 2, bd, bs, box, 128, F32))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_wgmma_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_y = b * c * (L / ROWS) * (h / hs);
  ssd_chunk_wgmma_kernel<NS><<<n_y + b * c * h, THREADS, smem, s>>>(
      xm, bm, static_cast<const float*>(C), static_cast<const float*>(acum),
      static_cast<float*>(y),
      static_cast<float*>(states), b * c, c, L, h, g, hs, n_y);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core body (arguments as ssd_chunk_launch's, plus hs: heads a
// y block takes, a divisor of h / g): p == 64, n 64 or 128, L a multiple
// of 64 up to MAX_L, x, B and C 16-byte aligned.  Returns the cudaError_t
// (cudaErrorInvalidValue for shapes it does not take or a refused map).
extern "C" int ssd_chunk_wgmma_launch(const void* x, const void* acum,
                                      const void* B, const void* C, void* y,
                                      void* states, int b, int c, int L,
                                      int h, int p, int g, int n, int hs,
                                      void* stream) {
  if (b == 0 || c == 0) return 0;
  const auto a16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  if (p != P || (n != 64 && n != 128) || L < ROWS || L % ROWS != 0 ||
      L > MAX_L || g <= 0 || h % g != 0 || hs <= 0 || (h / g) % hs != 0 ||
      !a16(x) || !a16(B) || !a16(C))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n == 128 ? launch_wgmma<128>(x, acum, B, C, y, states, b, c, L, h,
                                      g, hs, s)
                  : launch_wgmma<64>(x, acum, B, C, y, states, b, c, L, h, g,
                                     hs, s);
}

// Bytes of dynamic shared memory the tensor-core body asks for at n = 128.
extern "C" int ssd_chunk_wgmma_smem(int L) {
  return static_cast<int>(Carve<128>::bytes(L));
}
