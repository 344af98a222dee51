// EmbeddingBag sum lookup (DLRM's hot path) for Hopper.
//
// Replaces the Pallas TPU kernel
// repro/kernels/embedding_bag/embedding_bag.py:embedding_bag (body _kernel).
//
// Computes, for every bag (b, f) of ids (B, F, M) int32 over table (V, D)
// f32,
//   out[b, f*D:(f+1)*D] = sum over m = 0..M-1 of table[ids[b, f, m]]
// summed in f32 in m order from zero, which is the plain version's order.
// An id i in [-V, 0) reads row i + V and an id outside [-V, V) makes its
// bag NaN, as jnp.take does by default in the reference's oracle; the
// kernel never reads outside the table.
//
// What bounds it on the H100: bytes.  Every looked-up row is read once
// (D * 4 bytes per id) and every bag written once, against one add per
// element: there is nothing to reuse, so the design moves each byte once
// with wide, coalesced accesses and keeps the bag's sum in registers:
//
// * one warp per bag; lane l owns the VEC-wide column slices l, l + 32, ...
//   of the D-wide row (VEC = 4, 2 or 1, chosen by the launch function from
//   D and the pointers' alignment), so a warp reads one row as one
//   contiguous 256-byte (D = 64) or larger transaction;
// * the bag's M ids are read by every lane of the warp (one broadcast), the
//   rows summed in registers, and the bag written once: no atomics, and
//   the TPU's double-buffered row DMA becomes the warp's loads in flight;
// * row offsets are 64-bit: dlrm-rm2's fused table has 49,127,424 rows of
//   64, 3.1e9 elements, and row * D wraps a 32-bit int past row 33.5M.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int WARPS_PER_BLOCK = 8;

template <int VEC>
__device__ __forceinline__ void add_row(float* acc, const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    acc[0] += t.x;
    acc[1] += t.y;
    acc[2] += t.z;
    acc[3] += t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    acc[0] += t.x;
    acc[1] += t.y;
  } else {
    acc[0] += *p;
  }
}

template <int VEC>
__global__ void embedding_bag_kernel(const int32_t* __restrict__ ids,
                                     const float* __restrict__ table,
                                     float* __restrict__ out, int64_t n_bags,
                                     int bag, int64_t n_rows, int dim) {
  const int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_bags) return;
  const int32_t* bag_ids = ids + w * bag;
  float* dst = out + w * dim;  // bag (b, f) is row b * F + f of (B*F, D)
  const int n_vec = dim / VEC;
  for (int v = lane; v < n_vec; v += 32) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int m = 0; m < bag; ++m) {
      int64_t row = bag_ids[m];
      if (row < 0) row += n_rows;
      if (row < 0 || row >= n_rows) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += __int_as_float(0x7fc00000);
        continue;
      }
      add_row<VEC>(acc, table + row * dim + (int64_t)v * VEC);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[v * VEC + j] = acc[j];
  }
}

// ids (n_bags, bag) int32, table (n_rows, dim) f32, out (n_bags, dim) f32;
// vec in {1, 2, 4} divides dim and both pointers' float alignment.
extern "C" int embedding_bag_launch(const void* ids, const void* table,
                                    void* out, int64_t n_bags, int bag,
                                    int64_t n_rows, int dim, int vec,
                                    void* stream) {
  if (n_bags == 0 || dim == 0) {
    return 0;
  }
  const int threads = 32 * WARPS_PER_BLOCK;
  const int64_t blocks = (n_bags + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* i = (const int32_t*)ids;
  const float* t = (const float*)table;
  float* o = (float*)out;
  switch (vec) {
    case 4:
      embedding_bag_kernel<4><<<(unsigned)blocks, threads, 0, s>>>(
          i, t, o, n_bags, bag, n_rows, dim);
      break;
    case 2:
      embedding_bag_kernel<2><<<(unsigned)blocks, threads, 0, s>>>(
          i, t, o, n_bags, bag, n_rows, dim);
      break;
    case 1:
      embedding_bag_kernel<1><<<(unsigned)blocks, threads, 0, s>>>(
          i, t, o, n_bags, bag, n_rows, dim);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
