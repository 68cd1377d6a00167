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
// (through L2); sharing them is later work, as are the tensor cores.
#include "common.cuh"

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
