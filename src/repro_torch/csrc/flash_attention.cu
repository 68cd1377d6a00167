// Flash attention, forward: online-softmax attention with causal and
// sliding-window masks and grouped (GQA / MQA) key and value heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:92
// _flash_forward (body _flash_kernel, :30-89), which walks 128 x 128
// (query, key) blocks with a running max m, a running sum l and an fp32
// accumulator in VMEM scratch, carried across the sequential key axis of
// its grid.  q (b, hq, Lq, d), k and v (b, hkv, Lk, d) in T (float or
// bf16), hq % hkv == 0; out (b, hq, Lq, d) in T.  Query head h reads key
// and value head h / (hq / hkv).  Masks are left-aligned: query i and key
// j are both positions from 0 (kernels/ref.py: attention_ref).
//
// What it computes, as the TPU kernel: q * scale in fp32 before the
// product; scores of masked pairs set to -1e30; per key tile
// m_new = max(m, rowmax(s)), p = exp(s - m_new), alpha = exp(m - m_new),
// l = l * alpha + rowsum(p), acc = acc * alpha + p v; the drain divides
// by l (1 where l == 0).  A row that meets a tile it cannot see before
// any key it can (the window) takes m_new = -1e30 and p = 1 there; the
// first real key's alpha = exp(-1e30 - m) = 0 wipes that out, as on the
// TPU.  Key tiles that no query row of the block can see are skipped.
// Unlike the TPU kernel, keys at j >= Lk are always masked: the TPU
// kernel pads the keys with zeros to a multiple of 128 and masks them
// only through the causal mask, so it differs from attention_ref when
// attention is not causal and Lk is no multiple of 128.
//
// Three bodies, each computing that function; the wrapper's path() picks
// one from dtypes, head_dim, alignment and strides alone:
//
// * "wgmma": q, k, v bf16 that TMA can read (16-byte aligned bases, (b,
//   h, s) strides multiples of 16 bytes: every model path in bf16),
//   flash_attention_wgmma_kernel below;
// * "wgmma_fp32": q, k, v fp32 that TMA can read, d 64, 128 or 256,
//   flash_attention_fp32_wgmma_kernel below;
// * "simt": the rest (d = 32 in fp32, views TMA cannot read),
//   flash_attention_kernel.
//
// Bound.  The bytes (q, k, v read once, out written once) or the
// operations of the unmasked pairs (4 d a pair) at the rate of the body's
// arithmetic: bf16 at the tensor cores' 989 TFLOP/s; fp32 at the CUDA
// cores' 67, or as the fp32 body takes it, six bf16 products each (~165).
// At gemma-2b's prefill (b = 4, L = 128, d = 256) the bytes; at L = 4096
// the operations.
//
// The SIMT body (the first kernel of this port: right, and the same bits
// every call).  One block per (64-query tile, batch, query head); 8
// warps, warp w owns query rows 8w..8w+7 for the scores, the softmax and
// the accumulator, so only the key / value tile loads need the whole
// block.  Shared memory (dynamic): the scaled q tile 64 x d, a 64 x (d +
// 1) key tile (padded: lane c reads row c, conflict-free), a 64 x d value
// tile and the warp's probabilities, 208.5 KB at d = 256 (one block per
// SM).  Every product and sum is fp32 on the CUDA cores in a fixed order
// (no atomics, no tensor cores); each lane holds 8 rows x d/32
// accumulator columns.  The query heads of a group each load the same
// key / value tiles (through L2).
//
// The bf16 body, on the tensor cores:
//
// * S = q k^T as a bf16 wgmma with an fp32 accumulator (the products are
//   exact), then S * scale in fp32, the masks and the online softmax above
//   with expf, in the same order;
// * O += P V with P split into P_hi = bf16(P) and P_lo = bf16(P - P_hi),
//   two wgmmas with P as the register A operand.  One bf16 P would change
//   ~40% of the bf16 outputs against the fp32 plain version (the product
//   the plain version and the TPU kernel take in fp32); the two terms keep
//   P to ~16 bits, and the outputs that differ to ~0.2%
//   (tests/test_torch_tensorcore.py emulates this arithmetic).  The split
//   makes the work 6 d operations per unmasked pair instead of 4 d.
//
// Design: 128 queries per block in two warpgroups of 64 rows, key / value
// tiles of 64 keys in two stages filled by TMA from 4-D tensor maps over
// the (d, s, h, b) strides the wrapper passes (so the (b, s, h, d)
// projections arrive without a copy), one thread issuing the next tile's
// loads while both warpgroups work on this one.  Tiles are swizzled 128
// (64 at d = 32) bytes wide: q (128 x d) and k (64 x d) are K-major
// operands, v (64 x d) the MN-major B operand.  Shared memory at d = 256:
// q 64 KB + 2 x (k 32 KB + v 32 KB) = 192 KB, one block per SM; each
// thread holds d / 2 accumulator registers (m64n256 at d = 256), the 32 of
// S and the P fragments.  The causal and window tile skip is the SIMT
// body's, and a warpgroup skips a tile whose keys all follow its rows (p
// = 0 and alpha = 1 there exactly).  Query tiles run last-first, so the
// longest causal blocks start first.  The output is written from the
// fragments in q's layout.
//
// The fp32 body, on the tensor cores with fp32-accurate products: every
// fp32 operand (q * scale, k, P, v) split into three bf16 terms by
// truncation and each product taken as the six term products a_i b_j, i
// + j <= 2, summed in fp32 (ssd_tc.cuh: within 2^-20 of each product; one
// bf16 term, or TF32, misses chip_smoke.py's 1e-4 limit).  The head
// dimension is cut into units of 64 columns (ssd_tc.cuh's 64 x 64 fp32
// unit), one warpgroup a unit, two units a block (one at d = 64), and
// each (64-query tile, batch, query head) is a thread-block cluster of d
// / 128 blocks (1 or 2) over the head dimension: at gemma-2b's fp32 shape
// (b = 4, 8 heads, L = 64, d = 256) 64 blocks of 256 threads where one
// block a tile gave 32.  Each block holds its units of q, of each key
// tile and of each value tile (loaded by TMA from the same 4-D maps in
// fp32), not a whole d = 256 head:
//
// * q * scale (fp32) as three terms of A fragments in registers, taken
//   from the warpgroup's unit at every key tile (see the note at
//   q_fragments);
// * each key tile: the block's threads split k's units into terms; each
//   warpgroup's partial S over its unit's 64 columns (24 m64n64k16
//   wgmmas); the block's partial, unit 0's plus unit 1's, through shared
//   memory; in a cluster the blocks' partials meet in distributed shared
//   memory: each block stages its partial in its own shared memory (its
//   last k unit's ring stage, split by then) and one thread copies it with
//   the bulk-copy engine into its slot of the other block's inbox,
//   completing on that block's mbarrier; the threads split v's units while
//   the copies fly; each block adds the partials in rank order, so every
//   warpgroup of the cluster holds the same S bits (no atomics, no
//   scratch).  Two inboxes, alternate tiles: a block copies its tile j + 2
//   partial only after it has received the other's tile j + 1 partial,
//   which that one sent after reading its tile j inbox;
// * the masks and the online softmax of the bf16 body, in every warpgroup
//   alike; P as three terms of A fragments; the tile's P V over the
//   unit's v terms (24 wgmmas, v MN-major) in a fresh accumulator, added
//   to O (64 x 64, the unit's columns) on the CUDA cores, O alpha + P V,
//   so that the tensor cores' rounding of their own additions, coarser
//   than fp32's, does not compound over the key tiles;
// * the drain writes each unit's 64 columns of each row.
//
// Key and value units arrive in a ring of four stages (ssd_tc.cuh: Ring):
// each issued once the one four before it is split, the last k unit's
// once it has also staged the partial.  Shared memory at d = 256: the
// ring 64 KB, q's units 32 KB, k's and v's terms 48 KB each, the two
// inboxes 32 KB: 225 KB, one block per SM (flash_attention_fp32_clusters
// says how many clusters the card holds at once).  (Measured on the H100
// and replaced: clusters of d / 64 blocks of one warpgroup, of which too
// few fit at once for gemma-2b's 32 tiles, so two waves; and partials
// stored into the other blocks one float4 at a time around a cluster
// barrier, the slowest stage of a key tile.)  The tile skip and the query
// tile order are the other bodies'.  Every sum is taken in a fixed order:
// the same bits every call.
#include "common.cuh"
#include "ssd_tc.cuh"
#include "wgmma.cuh"

namespace {
constexpr int BQ = 64;                 // queries per block
constexpr int BK = 64;                 // keys per tile
constexpr int NT = 256;                // 8 warps
constexpr int ROWS = BQ / (NT / 32);   // query rows per warp
constexpr float NEG_INF = -1e30f;      // kernels/common.py: NEG_INF

// Element strides of the batch, head and sequence axes (the last axis is
// contiguous) of q, k, v and out.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(BQ) * d +
                          static_cast<size_t>(BK) * (d + 1) +
                          static_cast<size_t>(BK) * d +
                          static_cast<size_t>(BQ) * (BK + 1));
}
}  // namespace

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, Strides st, int hq,
    int qpg, int lq, int lk, int causal, int window, float scale) {
  constexpr int DC = D / 32;           // accumulator columns per lane
  extern __shared__ float smem[];
  float* sq = smem;                    // BQ x D, q * scale
  float* sk = sq + BQ * D;             // BK x (D + 1)
  float* sv = sk + BK * (D + 1);       // BK x D
  float* sp = sv + BK * D;             // BQ x (BK + 1), probabilities

  const int bi = blockIdx.y / hq, h = blockIdx.y % hq, hk = h / qpg;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* qb = q + bi * st.q[0] + h * st.q[1];
  const T* kb = k + bi * st.k[0] + hk * st.k[1];
  const T* vb = v + bi * st.v[0] + hk * st.v[1];
  T* ob = out + bi * st.o[0] + h * st.o[1];

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    sq[i] = q0 + r < lq ? to_f(qb[(q0 + r) * st.q[2] + c]) * scale : 0.f;
  }

  // The key tiles some row of the block can see.
  const int q_last = min(q0 + BQ, lq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int k_hi = causal ? min(lk, q_last + 1) : lk;

  float m[ROWS], l[ROWS], acc[ROWS][DC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[r][j] = 0.f;
  }
  const int row0 = warp * ROWS;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();                   // the last tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < lk;
      sk[r * (D + 1) + c] = ok ? to_f(kb[(k0 + r) * st.k[2] + c]) : 0.f;
      sv[i] = ok ? to_f(vb[(k0 + r) * st.v[2] + c]) : 0.f;
    }
    __syncthreads();

    // Scores of rows row0..row0+7 against keys lane and lane + 32.
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float k_a = sk[lane * (D + 1) + c];
      const float k_b = sk[(lane + 32) * (D + 1) + c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qv = sq[(row0 + r) * D + c];
        s[r][0] = fmaf(qv, k_a, s[r][0]);
        s[r][1] = fmaf(qv, k_b, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qi = q0 + row0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ki = k0 + lane + 32 * j;
        const bool ok = ki < lk && (!causal || ki <= qi) &&
                        (window <= 0 || ki > qi - window);
        if (!ok) s[r][j] = NEG_INF;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float p0 = expf(s[r][0] - m_new);
      const float p1 = expf(s[r][1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
      sp[(row0 + r) * (BK + 1) + lane] = p0;
      sp[(row0 + r) * (BK + 1) + lane + 32] = p1;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[r][j] *= alpha;
    }
    __syncwarp();

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float vv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = sv[c * D + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = sp[(row0 + r) * (BK + 1) + c];
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= lq) continue;
    const float safe = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int j = 0; j < DC; ++j)
      ob[qi * st.o[2] + lane + 32 * j] = from_f<T>(acc[r][j] / safe);
  }
}

namespace tc {
constexpr int BQ = 128;     // queries per block: two warpgroups of 64
constexpr int BK = 64;      // keys per tile
constexpr int NT = 256;
constexpr int STAGES = 2;
constexpr int P_TERMS = 2;  // bf16 terms of P in P V

// Tile geometry at head_dim D: swizzle bytes, d elements per chunk (one
// TMA box wide), chunks, and bytes of a q, k or v chunk and tile.
template <int D> struct Geo {
  static constexpr int SW = D >= 64 ? 128 : 64;
  static constexpr int CH = SW / 2;
  static constexpr int NCH = D / CH;
  static constexpr int Q_CHUNK = BQ * SW;
  static constexpr int KV_CHUNK = BK * SW;
  static constexpr int Q_BYTES = NCH * Q_CHUNK;
  static constexpr int KV_BYTES = NCH * KV_CHUNK;
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024 + 64;
};

// Thread 0: key / value tile j (keys from k0) into stage j % STAGES.
template <int D>
__device__ __forceinline__ void load_kv(uint8_t* skv, uint64_t* bars,
                                        const CUtensorMap* km,
                                        const CUtensorMap* vm, int j, int k0,
                                        int hk, int bi) {
  using G = Geo<D>;
  const int s = j % STAGES;
  uint8_t* ks = skv + s * 2 * G::KV_BYTES;
  wg::bar_expect(&bars[1 + s], 2 * G::KV_BYTES);
#pragma unroll
  for (int c = 0; c < G::NCH; ++c) {
    wg::tma_load_4d(ks + c * G::KV_CHUNK, km, &bars[1 + s], c * G::CH, k0,
                    hk, bi);
    wg::tma_load_4d(ks + G::KV_BYTES + c * G::KV_CHUNK, vm, &bars[1 + s],
                    c * G::CH, k0, hk, bi);
  }
}
}  // namespace tc

// Grid (ceil(lq / 128), b * hq), tc::NT threads, Geo<D>::SMEM bytes of
// dynamic shared memory.  out: bf16 at element strides o[3] (batch, head,
// sequence) with a contiguous last axis.
template <int D>
__global__ void __launch_bounds__(tc::NT, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap qm,
    const __grid_constant__ CUtensorMap km,
    const __grid_constant__ CUtensorMap vm, __nv_bfloat16* __restrict__ out,
    long long ob, long long oh, long long os, int hq, int qpg, int lq, int lk,
    int causal, int window, float scale) {
  using G = tc::Geo<D>;
  constexpr int SW = G::SW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = wg::align1024(smem_raw);
  uint8_t* skv = sq + G::Q_BYTES;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(skv + tc::STAGES * 2 * G::KV_BYTES);

  const int tid = threadIdx.x, grp = tid / 128, t = tid % 128;
  const int lane = t % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * tc::BQ;
  const int bi = blockIdx.y / hq, h = blockIdx.y % hq, hk = h / qpg;

  // The key tiles some row of the block can see (the SIMT body's).
  const int q_last = min(q0 + tc::BQ, lq) - 1;
  const int k_lo =
      window > 0 ? max(0, q0 - window + 1) / tc::BK * tc::BK : 0;
  const int k_hi = causal ? min(lk, q_last + 1) : lk;
  const int n_kt = k_hi > k_lo ? (k_hi - k_lo + tc::BK - 1) / tc::BK : 0;

  if (tid == 0) {
    for (int i = 0; i < 1 + tc::STAGES; ++i) wg::bar_init(&bars[i], 1);
    wg::fence_bar_init();
  }
  __syncthreads();
  if (tid == 0) {
    wg::bar_expect(&bars[0], G::Q_BYTES);
#pragma unroll
    for (int c = 0; c < G::NCH; ++c)
      wg::tma_load_4d(sq + c * G::Q_CHUNK, &qm, &bars[0], c * G::CH, q0, h,
                      bi);
    if (n_kt > 0) tc::load_kv<D>(skv, bars, &km, &vm, 0, k_lo, hk, bi);
  }

  // This thread's rows: qi0 and qi0 + 8 (fragment rows, wgmma.cuh).
  const int qi0 = q0 + grp * 64 + (t / 32) * 16 + lane / 4;
  const int g_last = q0 + grp * 64 + 63;
  float o[D / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
  const uint32_t qa = wg::smem_u32(sq) + grp * 64 * SW;
  wg::bar_wait(&bars[0], 0);

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = k_lo + j * tc::BK;
    __syncthreads();  // both warpgroups are done with tile j - 1's stage
    if (tid == 0 && j + 1 < n_kt)
      tc::load_kv<D>(skv, bars, &km, &vm, j + 1, k0 + tc::BK, hk, bi);
    wg::bar_wait(&bars[1 + j % tc::STAGES], (j / tc::STAGES) & 1);
    if (causal && k0 > g_last) continue;
    const uint32_t ka = wg::smem_u32(skv + (j % tc::STAGES) * 2 * G::KV_BYTES);
    const uint32_t va = ka + G::KV_BYTES;

    // S = q k^T: 64 rows x 64 keys, d / 16 steps.
    float s[tc::BK / 2];
#pragma unroll
    for (int i = 0; i < tc::BK / 2; ++i) s[i] = 0.f;
    wg::pin(s);
    wg::fence();
#pragma unroll
    for (int st = 0; st < D / 16; ++st) {
      const int c = st / (G::CH / 16), off = (st % (G::CH / 16)) * 32;
      wg::Mma<tc::BK>::template ss<0>(
          s, wg::desc(qa + c * G::Q_CHUNK + off, 16, 8 * SW, SW),
          wg::desc(ka + c * G::KV_CHUNK + off, 16, 8 * SW, SW));
    }
    wg::commit();
    wg::wait<0>();
    wg::pin(s);

    // Scale, mask, online softmax (rows r = 0, 1: qi0, qi0 + 8; a row's 64
    // keys lie in the 4 lanes of its quad).
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < tc::BK / 2; ++i) {
      const int r = (i / 2) % 2, qi = qi0 + 8 * r;
      const int ki = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      const bool ok = ki < lk && (!causal || ki <= qi) &&
                      (window <= 0 || ki > qi - window);
      s[i] = ok ? s[i] * scale : NEG_INF;
      mx[r] = fmaxf(mx[r], s[i]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r]);
    }
#pragma unroll
    for (int i = 0; i < tc::BK / 2; ++i) {
      const int r = (i / 2) % 2;
      s[i] = expf(s[i] - mx[r]);
      sum[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      alpha[r] = expf(m[r] - mx[r]);
      l[r] = l[r] * alpha[r] + sum[r];
      m[r] = mx[r];
    }

    // P as bf16 terms in A fragments: keys [16 kk, 16 kk + 16) are S
    // elements 8 kk .. 8 kk + 7, pair e = elements 8 kk + 2 e, + 1.
    uint32_t pf[tc::P_TERMS][tc::BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < tc::BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a = s[8 * kk + 2 * e], b = s[8 * kk + 2 * e + 1];
#pragma unroll
        for (int term = 0; term < tc::P_TERMS; ++term) {
          const __nv_bfloat162 p2 = __floats2bfloat162_rn(a, b);
          pf[term][kk][e] = *reinterpret_cast<const uint32_t*>(&p2);
          const float2 back = __bfloat1622float2(p2);
          a -= back.x;
          b -= back.y;
        }
      }

    wg::pin(o);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
    wg::pin(o);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < tc::BK / 16; ++kk)
#pragma unroll
      for (int term = 0; term < tc::P_TERMS; ++term)
        wg::Mma<D>::template rs<1>(
            o, pf[term][kk],
            wg::desc(va + kk * 16 * SW, G::KV_CHUNK, 8 * SW, SW));
    wg::commit();
    wg::wait<0>();
    wg::pin(o);
  }

  // Drain: o / l (1 where l == 0), columns 8 i + 2 (lane % 4) + {0, 1}.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qi0 + 8 * r;
    if (qi >= lq) continue;
    const float safe = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* orow = out + bi * ob + h * oh + qi * os + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = __floats2bfloat162_rn(
          o[4 * i + 2 * r] / safe, o[4 * i + 2 * r + 1] / safe);
  }
}

namespace tc32 {
constexpr int NT = 128;         // a warpgroup: the tile's 64 query rows
constexpr int STAGES = 4;       // ring stages
constexpr int FRAG = 32;        // S and O fragment floats a thread
constexpr int SLOT = NT * FRAG * 4;   // one block's partial S: 16 KB

// A block of a cluster of CL takes U units (64 columns each) of the head
// dimension, d = 64 U CL, one warpgroup a unit.  Shared memory: the ring;
// q's U units; k's and v's terms, U units each; two inboxes of CL - 1
// partial S slots; the barriers (q's, the ring's, the two inboxes').
template <int CL, int U> struct Carve {
  static constexpr int RING = STAGES * ssd_tc::UNIT_BYTES;
  static constexpr int TERMS_BYTES = ssd_tc::TERMS * ssd_tc::CHUNK_BYTES;
  static constexpr int INBOX = (CL - 1) * SLOT;
  static constexpr int BARS = 1 + STAGES + 2;
  static constexpr int BYTES = 1024 + RING + U * ssd_tc::UNIT_BYTES +
                               2 * U * TERMS_BYTES + 2 * INBOX + 8 * BARS;
};

// Thread 0: n fp32 units (64 rows from row0, 64 columns each from col0) of
// head h, batch bi of 4-D map m into dst, 16 KB apart, completing on bar.
__device__ __forceinline__ void load_units(uint8_t* dst, const CUtensorMap* m,
                                           uint64_t* bar, int n, int col0,
                                           int row0, int h, int bi) {
  wg::bar_expect(bar, n * ssd_tc::UNIT_BYTES);
  for (int x = 0; x < 2 * n; ++x)
    wg::tma_load_4d(dst + x * ssd_tc::BOX_BYTES, m, bar, col0 + 32 * x, row0,
                    h, bi);
}

// Thread 0: `bytes` of this block's shared memory at src copied by the
// bulk-copy engine to `dst` as it lies in block `rank` of the cluster,
// completing on `bar` as it lies there.
__device__ __forceinline__ void copy_to_rank(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar,
                                             int rank) {
  uint32_t d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(wg::smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(b)
               : "r"(wg::smem_u32(bar)), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(d),
      "r"(wg::smem_u32(src)), "r"(bytes), "r"(b)
      : "memory");
}
__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// This thread's committed copies have read their sources.
__device__ __forceinline__ void copies_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
}  // namespace tc32

// Grid (ceil(lq / 64) CL, b * hq), clusters (CL, 1, 1), U tc32::NT
// threads, Carve<CL, U>::BYTES of dynamic shared memory.  Maps: q, k, v fp32 (d, s,
// h, b), boxes of 32 columns x 64 rows, 128-byte swizzle.  out: fp32 at
// element strides (ob, oh, os), 8-byte aligned rows.
template <int CL, int U>
__global__ void __launch_bounds__(U * tc32::NT, 1) flash_attention_fp32_wgmma_kernel(
    const __grid_constant__ CUtensorMap qm,
    const __grid_constant__ CUtensorMap km,
    const __grid_constant__ CUtensorMap vm, float* __restrict__ out,
    long long ob, long long oh, long long os, int hq, int qpg, int lq, int lk,
    int causal, int window, float scale) {
  using ssd_tc::BOX_BYTES;
  using ssd_tc::CHUNK_BYTES;
  using ssd_tc::TERMS;
  using ssd_tc::UNIT_BYTES;
  using K = tc32::Carve<CL, U>;
  constexpr int NT = tc32::NT, STAGES = tc32::STAGES, ROWS = ssd_tc::ROWS;
  constexpr int NB = U * NT;              // threads a block
  constexpr int E4 = tc32::FRAG / 4;      // float4s of a thread's fragment
  constexpr int UT = 2 * U;               // ring units a key tile
  // The last k unit's ring stage stages a partial S once split (the block
  // sum of its warpgroups', the copies' source): its refill waits.
  constexpr bool STAGED = U > 1 || CL > 1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring_base = wg::align1024(smem_raw);
  uint8_t* sq = ring_base + K::RING;      // q's units
  uint8_t* kt = sq + U * UNIT_BYTES;      // k's terms, unit x at x TERMS_BYTES
  uint8_t* vt = kt + U * K::TERMS_BYTES;
  float4* inbox = reinterpret_cast<float4*>(vt + U * K::TERMS_BYTES);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(vt + U * K::TERMS_BYTES + 2 * K::INBOX);
  uint64_t* xfull = bars + 1 + STAGES;    // the inboxes' barriers
  const ssd_tc::Ring<STAGES> ring{ring_base, bars + 1};

  const int t = threadIdx.x, lane = t % 32;
  const int w = t / NT, tw = t % NT;      // warpgroup = unit, its thread
  const int rank = CL > 1 ? wg::cluster_rank() : 0;
  const int n_qt = gridDim.x / CL;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / CL) * ROWS;
  const int bi = blockIdx.y / hq, h = blockIdx.y % hq, hk = h / qpg;
  const int col = rank * 64 * U;

  // The key tiles some row of the tile can see (the other bodies').
  const int q_last = min(q0 + ROWS, lq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / ROWS * ROWS : 0;
  const int k_hi = causal ? min(lk, q_last + 1) : lk;
  const int n_kt = k_hi > k_lo ? (k_hi - k_lo + ROWS - 1) / ROWS : 0;

  if (t == 0) {
    for (int i = 0; i < K::BARS; ++i) wg::bar_init(&bars[i], 1);
    wg::fence_bar_init();
  }
  __syncthreads();
  // Every block of the cluster runs, its barriers initialised, before
  // another copies into its inboxes: this arrival's wait comes before the
  // first copy.
  if constexpr (CL > 1) wg::cluster_arrive();
  // Ring unit u: key tile u / UT's k unit u % UT (below U) or v unit
  // u % UT - U.
  const CUtensorMap* kmp = &km;
  const CUtensorMap* vmp = &vm;
  const auto issue = [&](int u) {
    const int x = u % UT;
    if (u / UT < n_kt)
      tc32::load_units(ring.stage(u), x < U ? kmp : vmp,
                       &ring.full[u % STAGES], 1, col + 64 * (x % U),
                       k_lo + (u / UT) * ROWS, hk, bi);
  };
  if (t == 0) {
    tc32::load_units(sq, &qm, &bars[0], U, col, q0, h, bi);
    for (int u = 0; u < STAGES; ++u) issue(u);
  }

  // q * scale as three terms of the m64k16 A fragments of the four
  // 16-column steps of unit x (wgmma.cuh's fragment rows and columns,
  // warpgroup thread tw), read from the swizzled unit: column c of row r
  // at box c / 32, 16-byte piece ((c % 32) / 4) ^ (r % 8).  Taken anew for every
  // batch of products, as are P's terms: an A fragment held in registers
  // from one batch of wgmmas to a later one was overwritten in between by
  // ptxas (CUDA 12.9; q's third term, from one key tile to the next: a
  // 2^-16-sized error in S, found on the H100).
  const int r0 = 16 * (tw / 32) + lane / 4;
  const auto q_fragments = [&](uint32_t (&qf)[TERMS][4][4], int x) {
#pragma unroll
    for (int st = 0; st < 4; ++st)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + 8 * (j % 2);
        const int c = 16 * st + 8 * (j / 2) + 2 * (lane % 4);
        const float2 v = *reinterpret_cast<const float2*>(
            sq + x * UNIT_BYTES + (c / 32) * BOX_BYTES + r * 128 +
            ((((c % 32) / 4) ^ (r % 8)) << 4) + (c % 4) * 4);
        uint32_t w[TERMS];
        ssd_tc::split2(v.x * scale, v.y * scale, w);
#pragma unroll
        for (int tt = 0; tt < TERMS; ++tt) qf[tt][st][j] = w[tt];
      }
  };
  wg::bar_wait(&bars[0], 0);

  const int qi0 = q0 + r0;
  float o[tc32::FRAG], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < tc32::FRAG; ++i) o[i] = 0.f;
  const uint32_t ka = wg::smem_u32(kt), va = wg::smem_u32(vt);

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = k_lo + j * ROWS;
    const int u0 = j * UT;                // the tile's first ring unit
    float4* in = inbox + (j % 2) * (CL - 1) * E4 * NT;
    float4* part = reinterpret_cast<float4*>(ring.stage(u0 + U - 1));
    // Every warp is done with tile j - 1's products before k's terms are
    // overwritten.
    if constexpr (CL > 1) {
      if (t == 0) wg::bar_expect(&xfull[j % 2], (CL - 1) * tc32::SLOT);
    }
    __syncthreads();
#pragma unroll
    for (int x = 0; x < U; ++x)
      ssd_tc::split_unit<NB>(ring.arrived(u0 + x), kt + x * K::TERMS_BYTES,
                             CHUNK_BYTES, t, ssd_tc::One());
    ssd_tc::fence_async();
    __syncthreads();   // k's terms in place; their ring stages free
    if (t == 0) {
#pragma unroll
      for (int x = 0; x < U; ++x)   // (the last one may stage the partial)
        if (!STAGED || x < U - 1) issue(u0 + x + STAGES);
    }

    // Each warpgroup's partial S over its unit's columns (24 m64n64k16
    // wgmmas); with two, the block's is unit 0's plus unit 1's, staged.
    float s[tc32::FRAG];
    {
      uint32_t qf[TERMS][4][4];
      q_fragments(qf, w);
#pragma unroll
      for (int i = 0; i < tc32::FRAG; ++i) s[i] = 0.f;
      wg::pin(s);
      wg::fence();
#pragma unroll
      for (int st = 0; st < 4; ++st)
        ssd_tc::for_terms<TERMS, TERMS>([&](int a, int b) {
          wg::Mma<64>::rs<0>(
              s, qf[a][st],
              ssd_tc::kmajor(ka + w * K::TERMS_BYTES + b * CHUNK_BYTES, st));
        });
      wg::commit();
      wg::wait<0>();
      wg::pin(s);
    }
    if constexpr (U > 1) {
      if (w == 1) {
#pragma unroll
        for (int e4 = 0; e4 < E4; ++e4)
          part[e4 * NT + tw] = make_float4(s[4 * e4], s[4 * e4 + 1],
                                           s[4 * e4 + 2], s[4 * e4 + 3]);
      }
      __syncthreads();
      if (w == 0) {
#pragma unroll
        for (int e4 = 0; e4 < E4; ++e4) {
          const float4 v = part[e4 * NT + tw];
          s[4 * e4] += v.x, s[4 * e4 + 1] += v.y;
          s[4 * e4 + 2] += v.z, s[4 * e4 + 3] += v.w;
          part[e4 * NT + tw] = make_float4(s[4 * e4], s[4 * e4 + 1],
                                           s[4 * e4 + 2], s[4 * e4 + 3]);
        }
      }
      ssd_tc::fence_async();
      __syncthreads();
      if (w == 1) {
#pragma unroll
        for (int e4 = 0; e4 < E4; ++e4) {
          const float4 v = part[e4 * NT + tw];
          s[4 * e4] = v.x, s[4 * e4 + 1] = v.y;
          s[4 * e4 + 2] = v.z, s[4 * e4 + 3] = v.w;
        }
      }
    }

    if constexpr (CL > 1) {
      // The partials meet: each block stages its fragments (float4 e4 of
      // warpgroup thread tw at e4 NT + tw, in its last k unit's ring
      // stage) and thread 0 copies them into slot `rank` (or rank - 1 past
      // the receiver's own) of inbox j % 2 of every other block, completing
      // on that block's xfull[j % 2]; v's units are split meanwhile.  Each
      // block adds the partials in rank order, so every warpgroup of the
      // cluster holds the same S bits.  Inbox j % 2 is written again only
      // by tile j + 2's copies, which its senders issue after receiving
      // this block's tile j + 1 partial, sent after its reads of this one.
      if constexpr (U == 1) {
#pragma unroll
        for (int e4 = 0; e4 < E4; ++e4)
          part[e4 * NT + tw] = make_float4(s[4 * e4], s[4 * e4 + 1],
                                           s[4 * e4 + 2], s[4 * e4 + 3]);
        ssd_tc::fence_async();
      }
      if (j == 0) wg::cluster_wait();
      __syncthreads();
      if (t == 0) {
#pragma unroll
        for (int dst = 0; dst < CL; ++dst) {
          if (dst == rank) continue;
          const int slot = rank < dst ? rank : rank - 1;
          tc32::copy_to_rank(in + slot * E4 * NT, part, tc32::SLOT,
                             &xfull[j % 2], dst);
        }
        tc32::copies_commit();
      }
    }
#pragma unroll
    for (int x = 0; x < U; ++x)
      ssd_tc::split_unit<NB>(ring.arrived(u0 + U + x),
                             vt + x * K::TERMS_BYTES, CHUNK_BYTES, t,
                             ssd_tc::One());
    ssd_tc::fence_async();
    if constexpr (CL > 1) {
      wg::bar_wait(&xfull[j % 2], (j / 2) & 1);
      float tot[tc32::FRAG];
#pragma unroll
      for (int r = 0; r < CL; ++r) {
        const int slot = r < rank ? r : max(r - 1, 0);
#pragma unroll
        for (int e4 = 0; e4 < E4; ++e4) {
          const float4 v = r == rank ? make_float4(s[4 * e4], s[4 * e4 + 1],
                                                   s[4 * e4 + 2], s[4 * e4 + 3])
                                     : in[(slot * E4 + e4) * NT + tw];
          const float pv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tot[4 * e4 + e] = r == 0 ? pv[e] : tot[4 * e4 + e] + pv[e];
        }
      }
#pragma unroll
      for (int i = 0; i < tc32::FRAG; ++i) s[i] = tot[i];
      ssd_tc::fence_async();   // the inbox's reads before later copies
    }
    __syncthreads();   // v's terms in place; their ring stages free
    if (t == 0) {
      if constexpr (STAGED) {   // the staging stage takes its next unit
        if constexpr (CL > 1) tc32::copies_read();
        issue(u0 + U - 1 + STAGES);
      }
#pragma unroll
      for (int x = 0; x < U; ++x) issue(u0 + U + x + STAGES);
    }

    // Mask, online softmax (rows r = 0, 1: qi0, qi0 + 8; a row's 64 keys
    // lie in the 4 lanes of its quad), as the bf16 body.
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < tc32::FRAG; ++i) {
      const int r = (i / 2) % 2, qi = qi0 + 8 * r;
      const int ki = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
      const bool ok = ki < lk && (!causal || ki <= qi) &&
                      (window <= 0 || ki > qi - window);
      if (!ok) s[i] = NEG_INF;
      mx[r] = fmaxf(mx[r], s[i]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r]);
    }
#pragma unroll
    for (int i = 0; i < tc32::FRAG; ++i) {
      const int r = (i / 2) % 2;
      s[i] = expf(s[i] - mx[r]);
      sum[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      alpha[r] = expf(m[r] - mx[r]);
      l[r] = l[r] * alpha[r] + sum[r];
      m[r] = mx[r];
    }

    // The warpgroup's unit's P V: P as three terms of A fragments (keys
    // [16 kk, 16 kk + 16) are S elements 8 kk .. 8 kk + 7, pair e =
    // elements 8 kk + 2 e, + 1), a batch of 24 wgmmas on the unit's v
    // terms (MN-major) in a fresh accumulator, added to O on the CUDA cores
    // (the note at the top).
    {
      uint32_t pf[TERMS][4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t w[TERMS];
          ssd_tc::split2(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], w);
#pragma unroll
          for (int tt = 0; tt < TERMS; ++tt) pf[tt][kk][e] = w[tt];
        }
      float pv[tc32::FRAG];
#pragma unroll
      for (int i = 0; i < tc32::FRAG; ++i) pv[i] = 0.f;
      wg::pin(pv);
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ssd_tc::for_terms<TERMS, TERMS>([&](int a, int b) {
          wg::Mma<64>::rs<1>(
              pv, pf[a][kk],
              ssd_tc::mnmajor(va + w * K::TERMS_BYTES + b * CHUNK_BYTES, kk));
        });
      wg::commit();
      wg::wait<0>();
      wg::pin(pv);
#pragma unroll
      for (int i = 0; i < tc32::FRAG; ++i)
        o[i] = fmaf(o[i], alpha[(i / 2) % 2], pv[i]);
    }
  }
  if constexpr (CL > 1) {
    if (n_kt == 0) wg::cluster_wait();
  }

  // Drain: o / l (1 where l == 0), columns col + 64 w + 8 i + 2 (lane %
  // 4) + {0, 1}.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qi0 + 8 * r;
    if (qi >= lq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    float* orow =
        out + bi * ob + h * oh + qi * os + col + 64 * w + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < tc32::FRAG / 4; ++i)
      *reinterpret_cast<float2*>(orow + 8 * i) =
          make_float2(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
  }
}

// The launchers' one argument: 64-bit fields in this order
// (kernels/flash_attention.py: FLASH_FIELDS packs them).  q, k, v, out in
// `dtype` (0 float, 1 bf16), each with a contiguous last axis of d in {32,
// 64, 128, 256}; the batch, head and sequence element strides of each (for
// the tensor-core bodies q's, k's and v's as their tensor maps take them:
// an axis of extent 1 given the span of the axes inside it); window <= 0
// means none; scale multiplies q (in fp32) before the product.
struct FlashArgs {
  int64_t dtype;
  const void *q, *k, *v;
  void* out;
  int64_t q_b, q_h, q_s, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_s;
  int64_t b, hq, hkv, lq, lk, d, causal, window;
  double scale;
  void* stream;
};

namespace {
// A 4-D tensor map (d, s, h, b) over the element strides (sb, sh, ss) of
// a q, k or v of `len` rows and `heads` heads, elements of `esize` bytes,
// boxes of `box_cols` x `box_rows`, swizzle `sw`.
bool flash_map(CUtensorMap* mp, const void* base, int64_t sb, int64_t sh,
               int64_t ss, const FlashArgs& a, int64_t len, int64_t heads,
               int esize, int box_cols, int box_rows, int sw,
               CUtensorMapDataType type) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.d),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(a.b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * esize,
                                 static_cast<cuuint64_t>(sh) * esize,
                                 static_cast<cuuint64_t>(sb) * esize};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  return wg::make_map(mp, base, 4, dims, strides, box, sw, type);
}

bool flash_shape_ok(const FlashArgs& a) {
  return a.hkv > 0 && a.hq % a.hkv == 0 && a.b * a.hq <= 65535 && a.lk >= 1;
}

template <typename T, int D>
cudaError_t launch(const FlashArgs& a, cudaStream_t s) {
  const Strides st{{a.q_b, a.q_h, a.q_s},
                   {a.k_b, a.k_h, a.k_s},
                   {a.v_b, a.v_h, a.v_s},
                   {a.o_b, a.o_h, a.o_s}};
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int hq = static_cast<int>(a.hq), lq = static_cast<int>(a.lq);
  const dim3 grid((lq + BQ - 1) / BQ, static_cast<unsigned>(a.b * hq));
  flash_attention_kernel<T, D><<<grid, NT, smem, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), st, hq,
      static_cast<int>(a.hq / a.hkv), lq, static_cast<int>(a.lk),
      static_cast<int>(a.causal), static_cast<int>(a.window),
      static_cast<float>(a.scale));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const FlashArgs& a, cudaStream_t s) {
  using G = tc::Geo<D>;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const int lq = static_cast<int>(a.lq), lk = static_cast<int>(a.lk);
  CUtensorMap qm, km, vm;
  if (!flash_map(&qm, a.q, a.q_b, a.q_h, a.q_s, a, lq, a.hq, 2, G::CH, tc::BQ,
                 G::SW, BF16) ||
      !flash_map(&km, a.k, a.k_b, a.k_h, a.k_s, a, lk, a.hkv, 2, G::CH,
                 tc::BK, G::SW, BF16) ||
      !flash_map(&vm, a.v, a.v_b, a.v_h, a.v_s, a, lk, a.hkv, 2, G::CH,
                 tc::BK, G::SW, BF16))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const int hq = static_cast<int>(a.hq);
  const dim3 grid((lq + tc::BQ - 1) / tc::BQ, static_cast<unsigned>(a.b * hq));
  flash_attention_wgmma_kernel<D><<<grid, tc::NT, G::SMEM, s>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(a.out), a.o_b, a.o_h, a.o_s, hq,
      static_cast<int>(a.hq / a.hkv), lq, lk, static_cast<int>(a.causal),
      static_cast<int>(a.window), static_cast<float>(a.scale));
  return cudaGetLastError();
}

template <int CL, int U>
cudaError_t launch_fp32_wgmma(const FlashArgs& a, cudaStream_t s) {
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr int R = ssd_tc::ROWS;
  const int lq = static_cast<int>(a.lq), lk = static_cast<int>(a.lk);
  CUtensorMap qm, km, vm;
  if (!flash_map(&qm, a.q, a.q_b, a.q_h, a.q_s, a, lq, a.hq, 4, 32, R, 128,
                 F32) ||
      !flash_map(&km, a.k, a.k_b, a.k_h, a.k_s, a, lk, a.hkv, 4, 32, R, 128,
                 F32) ||
      !flash_map(&vm, a.v, a.v_b, a.v_h, a.v_s, a, lk, a.hkv, 4, 32, R, 128,
                 F32))
    return cudaErrorInvalidValue;
  const int hq = static_cast<int>(a.hq);
  return wg::launch_cluster(
      flash_attention_fp32_wgmma_kernel<CL, U>,
      dim3(((lq + R - 1) / R) * CL, static_cast<unsigned>(a.b * hq)),
      dim3(U * tc32::NT), dim3(CL, 1, 1), tc32::Carve<CL, U>::BYTES, s, qm, km,
      vm, static_cast<float*>(a.out), a.o_b, a.o_h, a.o_s, hq,
      static_cast<int>(a.hq / a.hkv), lq, lk, static_cast<int>(a.causal),
      static_cast<int>(a.window), static_cast<float>(a.scale));
}
}  // namespace

// The bf16 body (all bf16): every base 16-byte aligned and every stride a
// multiple of 8 elements, with an axis of extent 1 given any such stride
// (TMA's rule; the wrapper routes other views to flash_attention_launch).
// Returns the cudaError_t (cudaErrorInvalidValue when a tensor map is
// refused).
extern "C" int flash_attention_wgmma_launch(const FlashArgs* a) {
  if (a->b == 0 || a->lq == 0) return 0;
  if (a->dtype != 1 || !flash_shape_ok(*a))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  switch (a->d) {
    case 32: return static_cast<int>(launch_wgmma<32>(*a, s));
    case 64: return static_cast<int>(launch_wgmma<64>(*a, s));
    case 128: return static_cast<int>(launch_wgmma<128>(*a, s));
    case 256: return static_cast<int>(launch_wgmma<256>(*a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The fp32 tensor-core body (all fp32, d 64, 128 or 256): TMA's rule as
// the bf16 body's (strides multiples of 4 elements), and out with an
// 8-byte aligned base and even strides.  Returns the cudaError_t
// (cudaErrorInvalidValue for what it does not take or a refused map).
extern "C" int flash_attention_fp32_wgmma_launch(const FlashArgs* a) {
  if (a->b == 0 || a->lq == 0) return 0;
  if (a->dtype != 0 || !flash_shape_ok(*a) ||
      reinterpret_cast<uintptr_t>(a->out) % 8 != 0 ||
      (a->o_b | a->o_h | a->o_s) % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  switch (a->d) {
    case 64: return static_cast<int>(launch_fp32_wgmma<1, 1>(*a, s));
    case 128: return static_cast<int>(launch_fp32_wgmma<1, 2>(*a, s));
    case 256: return static_cast<int>(launch_fp32_wgmma<2, 2>(*a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Clusters of the fp32 body at head_dim d that the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0 for a d it does not take or on
// error).
extern "C" int flash_attention_fp32_clusters(int d) {
  const auto query = [](auto kern, int cl, int u, int smem) {
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess)
      return 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cl * 1024, 1);
    cfg.blockDim = dim3(u * tc32::NT);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = cl;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    int n = 0;
    return cudaOccupancyMaxActiveClusters(&n, kern, &cfg) == cudaSuccess ? n : 0;
  };
  switch (d) {
    case 64:
      return query(flash_attention_fp32_wgmma_kernel<1, 1>, 1, 1,
                   tc32::Carve<1, 1>::BYTES);
    case 128:
      return query(flash_attention_fp32_wgmma_kernel<1, 2>, 1, 2,
                   tc32::Carve<1, 2>::BYTES);
    case 256:
      return query(flash_attention_fp32_wgmma_kernel<2, 2>, 2, 2,
                   tc32::Carve<2, 2>::BYTES);
    default: return 0;
  }
}

// Bytes of dynamic shared memory the bf16 body's launch asks for at
// head_dim d (0 for a d it does not take); fp32: the fp32 body's.
extern "C" int flash_attention_wgmma_smem(int d, int fp32) {
  if (fp32) {
    switch (d) {
      case 64: return tc32::Carve<1, 1>::BYTES;
      case 128: return tc32::Carve<1, 2>::BYTES;
      case 256: return tc32::Carve<2, 2>::BYTES;
      default: return 0;
    }
  }
  switch (d) {
    case 32: return tc::Geo<32>::SMEM;
    case 64: return tc::Geo<64>::SMEM;
    case 128: return tc::Geo<128>::SMEM;
    case 256: return tc::Geo<256>::SMEM;
    default: return 0;
  }
}

// The SIMT body, any dtype, d and strides the wrapper takes.  Returns the
// cudaError_t.
extern "C" int flash_attention_launch(const FlashArgs* a) {
  if (a->b == 0 || a->lq == 0) return 0;
  if (!flash_shape_ok(*a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(a->stream);
  cudaError_t err = cudaErrorInvalidValue;
  DISPATCH_T(a->dtype, {
    switch (a->d) {
      case 32: err = launch<T, 32>(*a, s); break;
      case 64: err = launch<T, 64>(*a, s); break;
      case 128: err = launch<T, 128>(*a, s); break;
      case 256: err = launch<T, 256>(*a, s); break;
      default: break;
    }
  });
  return static_cast<int>(err);
}
