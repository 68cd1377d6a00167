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
// Bound.  bf16 operands: the operations at the tensor cores' rate, or the
// bytes (q, k, v read once, out written once); at gemma-2b's prefill
// (b = 4, L = 128, d = 256) the bytes, at L = 4096 the operations.
//
// Design (a first, simple kernel: right, and the same bits every call).
// One block per (64-query tile, batch, query head); 8 warps, warp w owns
// query rows 8w..8w+7 for the scores, the softmax and the accumulator, so
// only the key / value tile loads need the whole block.  Shared memory
// (dynamic): the scaled q tile 64 x d, a 64 x (d + 1) key tile (padded:
// lane c reads row c, conflict-free), a 64 x d value tile and the warp's
// probabilities, 208.5 KB at d = 256 (one block per SM).  Every product
// and sum is fp32 on the CUDA cores in a fixed order (no atomics, no
// tensor cores); each lane holds 8 rows x d/32 accumulator columns.  The
// eight query heads of an MQA group each load the same key / value tiles
// (through L2); sharing them is later work.
//
// The bf16 body, flash_attention_wgmma_kernel (q, k and v bf16 whose
// bases and (b, h, s) byte strides TMA can read: every model path), on
// the tensor cores, computing the same function:
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
#include "common.cuh"
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

template <typename T, int D>
static cudaError_t launch(const void* q, const void* k, const void* v,
                          void* out, const Strides& st, int b, int hq,
                          int qpg, int lq, int lk, int causal, int window,
                          float scale, cudaStream_t s) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + BQ - 1) / BQ, b * hq);
  flash_attention_kernel<T, D><<<grid, NT, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), st, hq, qpg, lq, lk,
      causal, window, scale);
  return cudaGetLastError();
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

template <int D>
static cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                                void* out, const long long* st, int b, int hq,
                                int hkv, int lq, int lk, int causal,
                                int window, float scale, cudaStream_t s) {
  using G = tc::Geo<D>;
  // 4-D maps (d, s, h, b) over the element strides st[0..2] (b, h, s).
  auto map = [&](CUtensorMap* mp, const void* base, const long long* ts,
                 int len, int heads, int rows) {
    const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(len),
                                static_cast<cuuint64_t>(heads),
                                static_cast<cuuint64_t>(b)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ts[2]) * 2,
                                   static_cast<cuuint64_t>(ts[1]) * 2,
                                   static_cast<cuuint64_t>(ts[0]) * 2};
    const cuuint32_t box[4] = {G::CH, static_cast<cuuint32_t>(rows), 1, 1};
    return wg::make_map(mp, base, 4, dims, strides, box, G::SW);
  };
  CUtensorMap qm, km, vm;
  if (!map(&qm, q, st, lq, hq, tc::BQ) ||
      !map(&km, k, st + 3, lk, hkv, tc::BK) ||
      !map(&vm, v, st + 6, lk, hkv, tc::BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + tc::BQ - 1) / tc::BQ, b * hq);
  flash_attention_wgmma_kernel<D><<<grid, tc::NT, G::SMEM, s>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), st[9], st[10], st[11], hq,
      hq / hkv, lq, lk, causal, window, scale);
  return cudaGetLastError();
}

// The bf16 body (arguments as flash_attention_launch's, all bf16): every
// base 16-byte aligned and every stride a multiple of 8 elements, with an
// axis of extent 1 given any such stride (TMA's rule; the wrapper routes
// other views to flash_attention_launch).  Returns the cudaError_t
// (cudaErrorInvalidValue when a tensor map is refused).
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out,
                                            const long long* strides, int b,
                                            int hq, int hkv, int lq, int lk,
                                            int d, int causal, int window,
                                            float scale, void* stream) {
  if (b == 0 || lq == 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || b * hq > 65535 || lk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (d) {
    case 32:
      err = launch_wgmma<32>(q, k, v, out, strides, b, hq, hkv, lq, lk,
                             causal, window, scale, s);
      break;
    case 64:
      err = launch_wgmma<64>(q, k, v, out, strides, b, hq, hkv, lq, lk,
                             causal, window, scale, s);
      break;
    case 128:
      err = launch_wgmma<128>(q, k, v, out, strides, b, hq, hkv, lq, lk,
                              causal, window, scale, s);
      break;
    case 256:
      err = launch_wgmma<256>(q, k, v, out, strides, b, hq, hkv, lq, lk,
                              causal, window, scale, s);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

// Bytes of dynamic shared memory the bf16 body's launch asks for at
// head_dim d (0 for a d it does not take).
extern "C" int flash_attention_wgmma_smem(int d) {
  switch (d) {
    case 32: return tc::Geo<32>::SMEM;
    case 64: return tc::Geo<64>::SMEM;
    case 128: return tc::Geo<128>::SMEM;
    case 256: return tc::Geo<256>::SMEM;
    default: return 0;
  }
}

// q, k, v, out in `dtype` (0 float, 1 bf16), each with a contiguous last
// axis of d in {32, 64, 128, 256}; `strides` holds 12 element strides:
// the batch, head and sequence strides of q, k, v and out in that order.
// window <= 0 means none.  Returns the cudaError_t.
extern "C" int flash_attention_launch(int dtype, const void* q,
                                      const void* k, const void* v,
                                      void* out, const long long* strides,
                                      int b, int hq, int hkv, int lq, int lk,
                                      int d, int causal, int window,
                                      float scale, void* stream) {
  if (b == 0 || lq == 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || b * hq > 65535 || lk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int qpg = hq / hkv;
  cudaError_t err = cudaErrorInvalidValue;
  DISPATCH_T(dtype, {
    switch (d) {
      case 32:
        err = launch<T, 32>(q, k, v, out, st, b, hq, qpg, lq, lk, causal,
                            window, scale, s);
        break;
      case 64:
        err = launch<T, 64>(q, k, v, out, st, b, hq, qpg, lq, lk, causal,
                            window, scale, s);
        break;
      case 128:
        err = launch<T, 128>(q, k, v, out, st, b, hq, qpg, lq, lk, causal,
                             window, scale, s);
        break;
      case 256:
        err = launch<T, 256>(q, k, v, out, st, b, hq, qpg, lq, lk, causal,
                             window, scale, s);
        break;
      default:
        break;
    }
  });
  return static_cast<int>(err);
}
