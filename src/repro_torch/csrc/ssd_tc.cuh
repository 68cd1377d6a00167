// Split-precision tensor-core tiles of the SSD chunk pass: fp32 tiles that
// TMA brings in, split by the block's threads into bf16 terms that wgmma
// reads, the ring of TMA stages they arrive in, and the descriptors of
// those terms.  Used by ssd_chunk.cu's wgmma body (kernel 7),
// prefill_chunk.cu's (kernel 2) and flash_attention.cu's fp32 body
// (kernel 9).
//
// Precision (bf16x6).  An fp32 product on one bf16 term of each operand
// loses ~2^-8 of each factor and misses the kernels' 1e-4 limit by a wide
// margin (tests/test_torch_ssd_tc.py).  So every fp32 operand a is split
// into TERMS = 3 bf16 terms by truncation: a0 = the top 16 bits of a (an
// exact bf16: sign, exponent and 7 mantissa bits), a1 = the top 16 bits of
// a - a0, a2 = a - a0 - a1 (each difference exact in fp32, and a2 an exact
// bf16, so a0 + a1 + a2 = a).  A product is the sum of the six term
// products a_i b_j with i + j <= 2, accumulated in fp32 by wgmma (bf16 x
// bf16 products are exact in fp32); what it drops is below 2^-20 |a b|.
// Truncation takes a mask, a subtraction and a byte permute a pair, all
// full-rate instructions, where rounding would take the conversion unit.
// Six bf16 products run at 989 / 6 ~ 165 TFLOP/s of fp32-accurate
// products.  An operand that is an exact bf16 already (kernel 2's bf16
// streams) is its own one term: its product with a split operand keeps
// three term products, and two such operands one (for_terms).
//
// Layouts.  A "unit" is a 64-row x 64-column fp32 tile, loaded by TMA as
// two boxes of 32 columns with the 128-byte swizzle (box j at j * 8 KB,
// row r at r * 128 bytes, its 16-byte piece f at f ^ (r % 8)): the
// threads' reads of it are then free of bank conflicts.  A unit splits
// into TERMS bf16 chunks of 64 x 64, each in the 128-byte-swizzled layout
// wgmma.cuh describes (row r at r * 128 bytes, 16-byte piece c at c ^ (r
// % 8)), the same whether a descriptor reads it K-major or MN-major.  A
// tile of NS columns is NS / 64 units and, per term, NS / 64 chunks 8 KB
// apart.
#pragma once

#include "wgmma.cuh"

namespace ssd_tc {
constexpr int TERMS = 3;                        // bf16 terms an operand
constexpr int ROWS = 64;                        // rows of every tile
constexpr int THREADS = 384;                    // three warpgroups
constexpr int WG = 128;                         // one warpgroup
constexpr int PRODUCERS = 256;                  // warpgroups 1 and 2
constexpr int UNIT_BYTES = ROWS * 64 * 4;       // a 64 x 64 fp32 unit
constexpr int BOX_BYTES = ROWS * 128;           // 32 fp32 columns of it
constexpr int CHUNK_BYTES = ROWS * 128;         // a 64 x 64 bf16 chunk
constexpr int STAGES = 3;                       // units in flight

// f(i, j) for each term product a_i b_j that the split keeps, a taken as
// TA terms and b as TB (1 for an exact bf16 operand, TERMS for a split
// fp32 one): those with i + j < TERMS, in order of i, then j.
template <int TA, int TB, typename F>
__device__ __forceinline__ void for_terms(F f) {
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int j = 0; j < TB; ++j)
      if (i + j < TERMS) f(i, j);
}

// Two floats as TERMS bf16 pairs (low half first): term t of (a, b),
// split by truncation (see the note above).
__device__ __forceinline__ void split2(float a, float b,
                                       uint32_t (&o)[TERMS]) {
#pragma unroll
  for (int t = 0; t < TERMS; ++t) {
    const uint32_t ua = __float_as_uint(a), ub = __float_as_uint(b);
    o[t] = __byte_perm(ua, ub, 0x7632);   // the high halves of a and b
    if (t + 1 < TERMS) {
      a -= __uint_as_float(ua & 0xffff0000u);
      b -= __uint_as_float(ub & 0xffff0000u);
    }
  }
}

// Thread 0: the unit whose top-left element is (col0, row0) of tensor map
// m into dst (1024-byte aligned), completing on bar.
__device__ __forceinline__ void load_unit(uint8_t* dst, const CUtensorMap* m,
                                          uint64_t* bar, int col0, int row0) {
  wg::bar_expect(bar, UNIT_BYTES);
  wg::tma_load_2d(dst, m, bar, col0, row0);
  wg::tma_load_2d(dst + BOX_BYTES, m, bar, col0 + 32, row0);
}

// NTH threads (tid: 0 .. NTH - 1; NTH 128 or 256): the unit at src, each
// row r multiplied by scale(r), into TERMS bf16 chunks at dst,
// term_stride bytes apart.  Thread tid takes row tid % 64 and the 16-byte
// output pieces tid / 64 + (NTH / 64) i: a quarter-warp reads and writes
// 8 rows at 8 distinct swizzled positions.  The writes are generic-proxy
// stores that wgmma reads, and the reads of src come before a TMA load
// that refills it: the threads issue fence_async() after the split, before
// the barrier or arrival that either follows.
template <int NTH, typename SC>
__device__ __forceinline__ void split_unit(const uint8_t* src, uint8_t* dst,
                                           int term_stride, int tid,
                                           SC scale) {
  const int r = tid % ROWS, sw = r % 8;
  const float s = scale(r);
#pragma unroll
  for (int it = 0; it < 8 * ROWS / NTH; ++it) {
    const int pc = tid / ROWS + (NTH / ROWS) * it;   // output piece
    const int f0 = 2 * (pc % 4);                     // its two fp32 pieces
    const uint8_t* row = src + (pc / 4) * BOX_BYTES + r * 128;
    const float4 a = *reinterpret_cast<const float4*>(row + ((f0 ^ sw) << 4));
    const float4 b =
        *reinterpret_cast<const float4*>(row + (((f0 + 1) ^ sw) << 4));
    const float v[8] = {a.x * s, a.y * s, a.z * s, a.w * s,
                        b.x * s, b.y * s, b.z * s, b.w * s};
    uint32_t w[4][TERMS];
#pragma unroll
    for (int e = 0; e < 4; ++e) split2(v[2 * e], v[2 * e + 1], w[e]);
    const int off = r * 128 + ((pc ^ sw) << 4);
#pragma unroll
    for (int t = 0; t < TERMS; ++t)
      *reinterpret_cast<uint4*>(dst + t * term_stride + off) =
          make_uint4(w[0][t], w[1][t], w[2][t], w[3][t]);
  }
}

// NTH threads: the 64 x 64 bf16 chunk at src (128-byte-swizzled rows, as
// TMA writes a 64-column bf16 box), each row r multiplied by scale(r) in
// fp32, into TERMS bf16 chunks at dst, term_stride bytes apart, in the
// same layout (a 16-byte piece keeps its place).  Thread tid takes row
// tid % 64 and the pieces tid / 64 + (NTH / 64) i; fencing as split_unit.
template <int NTH, typename SC>
__device__ __forceinline__ void split_chunk(const uint8_t* src, uint8_t* dst,
                                            int term_stride, int tid,
                                            SC scale) {
  const int r = tid % ROWS, sw = r % 8;
  const float s = scale(r);
#pragma unroll
  for (int it = 0; it < 8 * ROWS / NTH; ++it) {
    const int pc = tid / ROWS + (NTH / ROWS) * it;
    const int off = r * 128 + ((pc ^ sw) << 4);
    const uint4 raw = *reinterpret_cast<const uint4*>(src + off);
    const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t w[4][TERMS];
#pragma unroll
    for (int e = 0; e < 4; ++e)   // a pair's low half is its first value
      split2(__uint_as_float(u[e] << 16) * s,
             __uint_as_float(u[e] & 0xffff0000u) * s, w[e]);
#pragma unroll
    for (int t = 0; t < TERMS; ++t)
      *reinterpret_cast<uint4*>(dst + t * term_stride + off) =
          make_uint4(w[0][t], w[1][t], w[2][t], w[3][t]);
  }
}

// NTH threads: the 8 KB chunk at src copied to dst (an exact bf16 tile
// kept past its ring stage); fencing as split_unit.
template <int NTH>
__device__ __forceinline__ void copy_chunk(const uint8_t* src, uint8_t* dst,
                                           int tid) {
  for (int i = tid; i < CHUNK_BYTES / 16; i += NTH)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

struct One {
  __device__ __forceinline__ float operator()(int) const { return 1.f; }
};

// A ring of S stages of UNIT_BYTES that TMA fills: unit j in stage j % S,
// completing on full[j % S].  Every thread that waits on a unit waits on
// every unit before it, in order, and unit j + S is issued only once all
// of them are past their reads of unit j (each fencing them against the
// async proxy first): an mbarrier parity wait cannot tell unit j from
// unit j - S.
template <int S = STAGES>
struct Ring {
  uint8_t* base;
  uint64_t* full;
  __device__ __forceinline__ uint8_t* stage(int j) const {
    return base + (j % S) * UNIT_BYTES;
  }
  __device__ __forceinline__ const uint8_t* arrived(int j) const {
    wg::bar_wait(&full[j % S], (j / S) & 1);
    return stage(j);
  }
};

// The thread's generic-proxy accesses of shared memory ordered before the
// async proxy's (wgmma reading what it wrote, TMA overwriting what it
// read); each thread issues it before the barrier or arrival they follow.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 256 threads of warpgroups 1 and 2 meet (named barrier 1;
// __syncthreads is barrier 0).
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Thread t of a warpgroup: the m64k16 A fragments of the 16-column steps
// of a 64 x NS fp32 tile read from global memory (rows `ld` floats apart,
// 8-byte aligned), each split into TERMS bf16 terms: register j of step st
// holds the pair at row r0 + 8 (j % 2), columns 16 st + 8 (j / 2) + 2 (t %
// 4) + {0, 1} (r0 = 16 (t / 32) + (t % 32) / 4; wgmma.cuh).
template <int NS>
__device__ __forceinline__ void a_fragments(const float* __restrict__ tile,
                                            size_t ld, int t,
                                            uint32_t (&f)[TERMS][NS / 16][4]) {
  const int r0 = 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
  for (int st = 0; st < NS / 16; ++st)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(
          tile + (r0 + 8 * (j % 2)) * ld + 16 * st + 8 * (j / 2) +
          2 * (t % 4)));
      uint32_t w[TERMS];
      split2(v.x, v.y, w);
#pragma unroll
      for (int tt = 0; tt < TERMS; ++tt) f[tt][st][j] = w[tt];
    }
}

// Descriptor of the 16-column step st of a K-major operand whose rows
// start at shared address `base` (chunks of 64 columns 8 KB apart).
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int st) {
  return wg::desc(base + (st / 4) * CHUNK_BYTES + (st % 4) * 32, 16, 1024,
                  128);
}

// Descriptor of the 16-row step kk of an MN-major operand (rows along
// the contracted axis) starting at shared address `base`.
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
  return wg::desc(base + kk * 16 * 128, CHUNK_BYTES, 1024, 128);
}
}  // namespace ssd_tc
