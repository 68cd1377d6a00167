// Gated RMSNorm over whole rows: out = norm(y) * scale * SiLU(z), the
// prefill's epilogue.
//
// Replaces the epilogue of the TPU kernel
//   src/repro/kernels/prefill_chunk.py mamba2_prefill_pallas  (:278-283)
// (the decode step's, decode_step.py:196-199, is fused into
// decode_step.cu).  Its mean of squares spans all heads of a row, and the
// port splits the prefill over blocks that cannot share that sum, so the
// epilogue runs here as a second pass with one block per row.
//
// Bound: bytes.  Each row is read once (y and z in T) and written once;
// the arithmetic is a few operations per element.  The design keeps the
// row's sum in registers and shared memory and reads y twice from L1/L2
// (1536 values per row at full width).  The prefill hands y over in T (it
// is a T value already): half the bytes of fp32.
//
// The prefill's rounding (prefill_chunk.py:282-283): the normalised row is
// rounded to the stream dtype T, SiLU(z) is rounded to T, and so is their
// product.  Under ActiBA the gate's SiLU is the PWL table silu_tab (null
// for exact), as the TPU kernel's silu callable is.
#include "common.cuh"

template <typename T>
__global__ void gated_norm_kernel(const T* __restrict__ y,
                                  const T* __restrict__ z, int z_rs,
                                  const float* __restrict__ scale,
                                  T* __restrict__ out, int d, float eps,
                                  const float* silu_tab, int silu_nk) {
  __shared__ float part[32];
  const int row = blockIdx.x;
  const T* yr = y + static_cast<size_t>(row) * d;
  const T* zr = z + static_cast<size_t>(row) * z_rs;
  T* orow = out + static_cast<size_t>(row) * d;

  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float v = to_f(yr[c]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    float v = lane < nw ? part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(part[0] / static_cast<float>(d) + eps);

  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float yn = to_f(yr[c]) * inv * scale[c];
    const float gate = silu_act(to_f(zr[c]), silu_tab, silu_nk);
    orow[c] = from_f<T>(round_to<T>(yn) * round_to<T>(gate));
  }
}

// y (rows, d) T; z rows of d values at a row stride of z_rs elements;
// scale (d,) fp32; out (rows, d) T; silu_tab the gate's ActiBA table or
// null.  Returns the cudaError_t.
extern "C" int gated_norm_launch(int dtype, const void* y, const void* z,
                                 int z_rs, const void* scale, void* out,
                                 int rows, int d, float eps,
                                 const void* silu_tab, int silu_nk,
                                 void* stream) {
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH_T(dtype, gated_norm_kernel<T><<<rows, 256, 0, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(z), z_rs,
      static_cast<const float*>(scale), static_cast<T*>(out), d, eps,
      static_cast<const float*>(silu_tab), silu_nk));
  return static_cast<int>(cudaGetLastError());
}
