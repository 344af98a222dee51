// Gustavson SpMM on the operand-deduplicated chunk layout, for Hopper.
//
// Replaces the Pallas TPU kernel
// repro/kernels/gustavson_spmm/gustavson_spmm.py:spmm_dedup_chunks
// (bodies _kernel_dma, _kernel_stream and _fold).
//
// Computes y = A @ x, with A packed by pack_dedup_chunks: chunk k holds
// remaining[k] distinct operand rows u_cols[k, u] and a dense
// (block_rows, width) coefficient tile a[k]; the chunks of output block b
// are block_ptr[b] .. block_ptr[b+1]-1, consecutive, at least one each.
//
// What bounds it on the H100: bytes.  A chunk gathers remaining[k] rows of
// x (sum over chunks of remaining*D*4 bytes), reads the live columns of its
// coefficient tile (block_rows*remaining*4 bytes; the padded lanes up to
// width are never read) and folds them with 2*block_rows*remaining*D
// flops: at block_rows = 8 that is under 4 flops per gathered byte, two
// orders of magnitude below the card's ridge point, so tensor cores would
// not help and the design only works on moving each byte once:
//
// * one thread block per (output block, D tile), threads (d_tile, rows):
//   each thread owns one output element and keeps it in a register;
// * the block walks its chunk range in order and, per chunk, lands the
//   live operand rows (u < remaining[k] only: a dead lane is never read,
//   so it needs no zeroing and cannot inject NaN) in shared memory with
//   row-contiguous loads; all block_rows rows of the tile then read the
//   landed operands from shared memory instead of from L2;
// * the tile is written once, at the end: no atomics, and the summation
//   order is the reference's (per chunk, then chunk after chunk);
// * d_tile is the smallest power of two >= D, capped at 32 (the serving
//   path has D = 16 and D = 7), and the ragged edge of D is masked.
//
// f32 only.  wgmma/TMA and a pipelined gather are later work.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void spmm_dedup_chunks_kernel(
    const int32_t* __restrict__ u_cols, const int32_t* __restrict__ remaining,
    const int32_t* __restrict__ block_ptr, const float* __restrict__ a,
    const float* __restrict__ x, float* __restrict__ y, int block_rows,
    int width, int d) {
  extern __shared__ float land[];  // (width, d_tile) landing buffer
  const int d_tile = blockDim.x;
  const int b = blockIdx.x;
  const int col0 = blockIdx.y * d_tile;
  const int r = threadIdx.y;
  const int dd = threadIdx.x;
  const int tid = r * d_tile + dd;
  const int n_threads = d_tile * block_rows;
  float acc = 0.f;
  const int k_end = block_ptr[b + 1];
  for (int k = block_ptr[b]; k < k_end; ++k) {
    const int n_u = min(remaining[k], width);  // never past the buffer
    const int32_t* cols_k = u_cols + (int64_t)k * width;
    __syncthreads();  // the previous chunk's fold has read the buffer
    for (int i = tid; i < n_u * d_tile; i += n_threads) {
      const int u = i / d_tile;
      const int c = col0 + (i - u * d_tile);
      land[i] = c < d ? x[(int64_t)cols_k[u] * d + c] : 0.f;
    }
    __syncthreads();
    const float* a_row = a + ((int64_t)k * block_rows + r) * width;
    float part = 0.f;
    for (int u = 0; u < n_u; ++u) {
      part = fmaf(a_row[u], land[u * d_tile + dd], part);
    }
    acc += part;
  }
  const int col = col0 + dd;
  if (col < d) {
    y[((int64_t)b * block_rows + r) * d + col] = acc;
  }
}

extern "C" int spmm_dedup_chunks_launch(
    const void* u_cols, const void* remaining, const void* block_ptr,
    const void* a, const void* x, void* y, int n_blocks, int block_rows,
    int width, int d, int d_tile, void* stream) {
  if (n_blocks == 0 || d == 0) {
    return 0;
  }
  const dim3 grid(n_blocks, (d + d_tile - 1) / d_tile);
  const dim3 block(d_tile, block_rows);
  const size_t smem = (size_t)width * d_tile * sizeof(float);
  spmm_dedup_chunks_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int32_t*)u_cols, (const int32_t*)remaining,
      (const int32_t*)block_ptr, (const float*)a, (const float*)x, (float*)y,
      block_rows, width, d);
  return (int)cudaGetLastError();
}
