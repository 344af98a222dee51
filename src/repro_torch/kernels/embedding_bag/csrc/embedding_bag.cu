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
// element: there is nothing to reuse but the table rows that several bags
// name, so the design keeps many rows in flight with wide loads, and
// keeps the bags' output out of L2's way:
//
// * a bag gets `lanes` lanes, D / VEC rounded up to a power of two of at
//   most 32 (the wrapper's lane_layout): VEC = 4 where D % 4 == 0 and the
//   table and output are 16-byte aligned, else 2 or 1.  At D = 64 a warp
//   holds two bags of 16 lanes and reads each 256-byte row with 16-byte
//   loads; wider rows loop over 32 * VEC columns at a time;
// * each lane group sums BAGS bags together: the m-th rows of all BAGS
//   bags are loaded before any is added, so a warp keeps 8 rows in flight
//   at D = 64 and M = 1 (4 at D >= 128);
// * a fixed grid (the blocks that fit on the card at once) strides over
//   the bags, and a group reads its next bags' first ids ahead;
// * bags are written with streaming stores (st.global.cs): serve_bulk's
//   1.75 GB of output is written once and should not push the table's hot
//   rows out of L2;
// * each bag sums in m order from zero, so the kernel stays bitwise equal
//   to the plain version;
// * row offsets are 64-bit: dlrm-rm2's fused table has 49,127,424 rows of
//   64, 3.1e9 elements, and row * D wraps a 32-bit int past row 33.5M.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 256;
constexpr int BAGS = 4;          // bags a lane group sums together
constexpr int MAX_DEVICES = 64;

template <int VEC>
__device__ __forceinline__ void load_row(float (&r)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = t.x;
    r[1] = t.y;
    r[2] = t.z;
    r[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    r[0] = t.x;
    r[1] = t.y;
  } else {
    r[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_streaming(float* p,
                                                const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

// The first id of each bag of batch q (BAGS bags); 0 past the last bag.
__device__ __forceinline__ void first_ids(int32_t (&id)[BAGS],
                                          const int32_t* __restrict__ ids,
                                          int64_t q, int64_t n_bags,
                                          int bag) {
#pragma unroll
  for (int b = 0; b < BAGS; ++b) {
    const int64_t w = q * BAGS + b;
    id[b] = (bag > 0 && w < n_bags) ? ids[w * bag] : 0;
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS) embedding_bag_kernel(
    const int32_t* __restrict__ ids, const float* __restrict__ table,
    float* __restrict__ out, int64_t n_bags, int bag, int64_t n_rows,
    int dim, int lanes) {
  const int lane = threadIdx.x & (lanes - 1);
  const int groups_per_block = THREADS / lanes;
  const int64_t n_groups = (int64_t)gridDim.x * groups_per_block;
  const int64_t n_batches = (n_bags + BAGS - 1) / BAGS;
  const int n_vec = dim / VEC;
  int64_t q = (int64_t)blockIdx.x * groups_per_block + threadIdx.x / lanes;
  int32_t next[BAGS];
  if (q < n_batches) first_ids(next, ids, q, n_bags, bag);
  for (; q < n_batches; q += n_groups) {
    int32_t cur[BAGS];
#pragma unroll
    for (int b = 0; b < BAGS; ++b) cur[b] = next[b];
    if (q + n_groups < n_batches)
      first_ids(next, ids, q + n_groups, n_bags, bag);
    for (int v0 = 0; v0 < n_vec; v0 += lanes) {   // D > 32 * VEC: passes
      const int v = v0 + lane;
      const bool col = v < n_vec;
      float acc[BAGS][VEC];
#pragma unroll
      for (int b = 0; b < BAGS; ++b)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[b][j] = 0.f;
      for (int m = 0; m < bag; ++m) {
        int64_t row[BAGS];
        float r[BAGS][VEC];
#pragma unroll
        for (int b = 0; b < BAGS; ++b) {
          const int64_t w = q * BAGS + b;
          int64_t i = m == 0 ? cur[b] : (w < n_bags ? ids[w * bag + m] : 0);
          if (i < 0) i += n_rows;
          row[b] = (w < n_bags && i >= 0 && i < n_rows) ? i : -1;
#pragma unroll
          for (int j = 0; j < VEC; ++j) r[b][j] = __int_as_float(0x7fc00000);
          if (col && row[b] >= 0)
            load_row<VEC>(r[b], table + row[b] * dim + (int64_t)v * VEC);
        }
#pragma unroll
        for (int b = 0; b < BAGS; ++b)
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[b][j] += r[b][j];
      }
#pragma unroll
      for (int b = 0; b < BAGS; ++b) {
        const int64_t w = q * BAGS + b;
        if (col && w < n_bags)
          store_streaming<VEC>(out + w * dim + (int64_t)v * VEC, acc[b]);
      }
    }
  }
}

// Blocks of one instantiation that fit on the card at once, per device.
template <int VEC>
static cudaError_t resident_blocks(int64_t* blocks) {
  static int64_t cached[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, embedding_bag_kernel<VEC>, THREADS, 0);
    if (err != cudaSuccess) return err;
    cached[dev] = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

template <int VEC>
static int launch(const int32_t* ids, const float* table, float* out,
                  int64_t n_bags, int bag, int64_t n_rows, int dim, int lanes,
                  cudaStream_t s) {
  const int64_t per_block = (int64_t)(THREADS / lanes) * BAGS;
  int64_t blocks = (n_bags + per_block - 1) / per_block, resident = 0;
  const cudaError_t err = resident_blocks<VEC>(&resident);
  if (err != cudaSuccess) return (int)err;
  if (blocks > resident) blocks = resident;
  embedding_bag_kernel<VEC><<<(unsigned)blocks, THREADS, 0, s>>>(
      ids, table, out, n_bags, bag, n_rows, dim, lanes);
  return (int)cudaGetLastError();
}

// ids (n_bags, bag) int32, table (n_rows, dim) f32, out (n_bags, dim) f32;
// vec in {1, 2, 4} divides dim and both pointers' float alignment; lanes is
// a power of two up to 32.
extern "C" int embedding_bag_launch(const void* ids, const void* table,
                                    void* out, int64_t n_bags, int bag,
                                    int64_t n_rows, int dim, int vec,
                                    int lanes, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (n_bags == 0 || dim == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* i = (const int32_t*)ids;
  const float* t = (const float*)table;
  float* o = (float*)out;
  switch (vec) {
    case 4:
      return launch<4>(i, t, o, n_bags, bag, n_rows, dim, lanes, s);
    case 2:
      return launch<2>(i, t, o, n_bags, bag, n_rows, dim, lanes, s);
    case 1:
      return launch<1>(i, t, o, n_bags, bag, n_rows, dim, lanes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
