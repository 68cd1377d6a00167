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
// Bound: operations.  At b = 4, two chunks of 256, 24 heads, p 64, n 128
// the lower triangle of C B^T (once per group), its product with x and the
// state product are ~1.7 GFLOP of fp32 on the CUDA cores (67 TFLOP/s)
// against ~34 MB of inputs and outputs (3.35 TB/s).
//
// Design.  The TPU kernel holds a cell's whole (L, L) block in VMEM; the
// port runs one block per (batch, chunk, head) over the 64 x 64 tiles it
// shares with prefill_chunk.cu (common.cuh: ssd_tiles): C B^T and the
// decay one 64 x 64 score tile at a time, tiles above the diagonal never
// computed, y accumulated in registers, the state product over 64-row key
// tiles.  fp32 on the CUDA cores; wgmma is later work.
#include "common.cuh"

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
