// Hash-pad numeric phase of sparse x sparse C = A @ B, for Hopper.
//
// Replaces the Pallas TPU kernel
// repro/kernels/spgemm_pad/spgemm_pad.py:spgemm_hashpad (body _kernel).
//
// Computes, for every output block b of block_rows rows,
//   c_pad[b] = sum over the block's chunks k of a[k] @ slab[k]
// where a[k] is chunk k's (block_rows, width) coefficient tile (A packed
// by pack_dedup_chunks) and slab[k] its (width, pad_width) slice of the
// hashed B slab: lane u of chunk k holds B row u_cols[k, u] with every
// value at the bucket its output column hashes to.  Only the first
// remaining[k] lanes of a chunk are live; the others are zero in both
// operands.  The chunks of block b are block_ptr[b] .. block_ptr[b+1]-1.
//
// What bounds it on the H100: bytes.  Each live slab row is read once
// (remaining * pad_width * 4 bytes per chunk; the dense slab of the
// gcn-cora A^2 plan has 12499 live rows of 4096 lanes, ~205 MB) and feeds
// 2 * block_rows flops per element: 4 flops per byte at block_rows = 8,
// far below the card's ridge point, so tensor cores would not help.  The
// design reads each byte once and keeps the pad out of device memory:
//
// * one thread block per (output block, h tile); each thread owns one pad
//   column h and keeps the block's block_rows pad rows in registers (the
//   hash pad, which the TPU held in VMEM scratch);
// * the block walks its chunk range in order (the TPU's sequential grid
//   axis becomes a loop) and, per chunk, lands the live columns of the
//   coefficient tile in shared memory, then folds
//   pad[r] += a[r, u] * slab[k*width + u, h]; slab rows are read row by
//   row, neighbouring threads on neighbouring addresses, and dead lanes
//   (u >= remaining[k]) are never read;
// * the pad is written once, after the block's last chunk (the rolling
//   eviction): no atomics, and the summation order is fixed (per chunk,
//   then chunk after chunk).  A block with an empty chunk range still
//   writes its (zero) pad, so every row of c_pad is written;
// * slab offsets are 64-bit: n_chunks * width * pad_width reaches ~1.3e9
//   at Pubmed scale.
//
// f32 only.  TMA streaming of the slab and fusing the slab scatter (so the
// dense slab is never built) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int BR = 8;  // block_rows: every plan of the repo packs 8-row blocks

__global__ void spgemm_hashpad_kernel(const int32_t* __restrict__ remaining,
                                      const int32_t* __restrict__ block_ptr,
                                      const float* __restrict__ a,
                                      const float* __restrict__ slab,
                                      float* __restrict__ c_pad, int width,
                                      int pad_width) {
  extern __shared__ float a_tile[];  // (BR, width): live columns only
  const int b = blockIdx.x;
  const int h = blockIdx.y * blockDim.x + threadIdx.x;
  const int tid = threadIdx.x;
  float pad[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) pad[r] = 0.f;
  const int k_end = block_ptr[b + 1];
  for (int k = block_ptr[b]; k < k_end; ++k) {
    const int n_u = min(remaining[k], width);  // never past the tile
    __syncthreads();  // the previous chunk's fold has read the tile
    for (int i = tid; i < BR * n_u; i += blockDim.x) {
      const int r = i / n_u;
      const int u = i - r * n_u;
      a_tile[r * width + u] = a[((int64_t)k * BR + r) * width + u];
    }
    __syncthreads();
    const float* s = slab + (int64_t)k * width * pad_width + h;
    float part[BR];
#pragma unroll
    for (int r = 0; r < BR; ++r) part[r] = 0.f;
#pragma unroll 4
    for (int u = 0; u < n_u; ++u) {
      const float v = s[(int64_t)u * pad_width];
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        part[r] = fmaf(a_tile[r * width + u], v, part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < BR; ++r) pad[r] += part[r];
  }
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    c_pad[((int64_t)b * BR + r) * pad_width + h] = pad[r];
  }
}

extern "C" int spgemm_hashpad_launch(const void* remaining,
                                     const void* block_ptr, const void* a,
                                     const void* slab, void* c_pad,
                                     int n_blocks, int block_rows, int width,
                                     int pad_width, int h_tile,
                                     void* stream) {
  if (block_rows != BR) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_blocks == 0 || pad_width == 0) {
    return 0;
  }
  const dim3 grid(n_blocks, pad_width / h_tile);
  const size_t smem = (size_t)BR * width * sizeof(float);
  spgemm_hashpad_kernel<<<grid, h_tile, smem, (cudaStream_t)stream>>>(
      (const int32_t*)remaining, (const int32_t*)block_ptr, (const float*)a,
      (const float*)slab, (float*)c_pad, width, pad_width);
  return (int)cudaGetLastError();
}
