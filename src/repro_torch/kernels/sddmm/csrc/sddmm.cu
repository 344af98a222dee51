// SDDMM edge scores (row-pair dot products) for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/sddmm/sddmm.py:sddmm
// (body _kernel).
//
// Computes, for every edge e,
//   score[e] = sum over d of x[src[e], d] * y[dst[e], d]
// with x (Nx, D) and y (Ny, D) f32; the two may have different row
// counts.  An index i in [-N, 0) reads row i + N and an index outside
// [-N, N) makes its score NaN, as jnp.take does by default in the
// reference's oracle; the kernel never reads outside x or y.
//
// What bounds it on the H100: bytes.  Each edge reads two D-wide rows
// (8 * D bytes) for 2 * D flops, a quarter of a flop per byte, so the
// design moves each row once, coalesced, and keeps nothing else in memory:
//
// * one warp per edge, walking edges with a grid stride; lane l reads
//   columns l, l + 32, ... of both rows (neighbouring lanes on neighbouring
//   addresses), multiplies and sums in registers;
// * the warp's partial sums are reduced with shuffles and lane 0 writes the
//   score: no shared memory, no atomics.  The TPU's double-buffered row DMA
//   becomes the loads of the warps in flight on each SM;
// * row offsets are 64-bit (ogb_products: 2.4M rows of 100).
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int WARPS_PER_BLOCK = 8;

__device__ __forceinline__ int64_t wrap_row(int64_t i, int64_t n) {
  if (i < 0) i += n;
  return (i < 0 || i >= n) ? -1 : i;
}

__global__ void sddmm_kernel(const int32_t* __restrict__ src,
                             const int32_t* __restrict__ dst,
                             const float* __restrict__ x,
                             const float* __restrict__ y,
                             float* __restrict__ out, int64_t n_edges,
                             int64_t nx, int64_t ny, int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (int64_t)gridDim.x * WARPS_PER_BLOCK;
  for (int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       e < n_edges; e += n_warps) {
    const int64_t s = wrap_row(src[e], nx);
    const int64_t t = wrap_row(dst[e], ny);
    float acc = 0.f;
    if (s >= 0 && t >= 0) {
      const float* xr = x + s * dim;
      const float* yr = y + t * dim;
      for (int c = lane; c < dim; c += 32) acc += xr[c] * yr[c];
    } else {
      acc = __int_as_float(0x7fc00000);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[e] = acc;
  }
}

extern "C" int sddmm_launch(const void* src, const void* dst, const void* x,
                            const void* y, void* out, int64_t n_edges,
                            int64_t nx, int64_t ny, int dim, void* stream) {
  if (n_edges == 0) {
    return 0;
  }
  const int threads = 32 * WARPS_PER_BLOCK;
  int64_t blocks = (n_edges + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid stride past 64 per SM
  sddmm_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)src, (const int32_t*)dst, (const float*)x,
      (const float*)y, (float*)out, n_edges, nx, ny, dim);
  return (int)cudaGetLastError();
}
