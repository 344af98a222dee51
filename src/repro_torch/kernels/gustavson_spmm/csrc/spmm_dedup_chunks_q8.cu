// int8 Gustavson SpMM on the operand-deduplicated chunk layout, for Hopper.
//
// Replaces the Pallas TPU kernel
// repro/kernels/gustavson_spmm/gustavson_spmm.py:spmm_dedup_chunks_q8
// (bodies _kernel_dma_q8, _kernel_stream_q8 and _fold_q8).
//
// Computes, for output block b and column col,
//   y = sum over the block's chunks k of
//       a_scale[k] * x_scale[col / q_tile] * (a_q8[k] @ x_q8[live rows of k])
// where the live rows of chunk k are u_cols[k, :remaining[k]],
// A is packed by pack_dedup_chunks and quantized per chunk (a_q8 int8,
// a_scale f32), X quantized per scale tile of q_tile columns (x_q8 int8,
// x_scale f32).  The output is f32.  q_tile is the scale tile
// (auto_d_tile(D), up to 512 columns), not the thread block's column tile
// (d_tile, at most 32): a block's columns may straddle two scale tiles, so
// each thread reads its own column's scale.
//
// What bounds it on the H100: bytes, as for the f32 kernel, now a quarter
// of them for the operands: a chunk gathers remaining[k] int8 rows of x and
// reads the live int8 columns of its coefficient tile, and folds them with
// 2*block_rows*remaining*D integer operations: under 16 operations per
// gathered byte at block_rows = 8, far below the int8 tensor cores' ridge
// point, so plain integer multiply-adds do.  The design:
//
// * one thread block per (output block, column tile), threads (d_tile,
//   rows): each thread owns one output element, in a register;
// * the block walks its chunk range block_ptr[b] .. block_ptr[b+1]-1 in
//   order, lands only the live operand rows (u < remaining[k]; dead lanes
//   are never read) in shared memory, widened to int;
// * per chunk each thread sums a_q8 * x_q8 products in int32, which is
//   exact and equals the reference's f32 dot (|sum| <= 127*127*width <
//   2^24), then folds it as acc = fma(isum, a_scale[k] * x_scale[j], acc),
//   chunk after chunk.  The reference's fold (y + dot * s, compiled by
//   XLA) is contracted into exactly that FMA, one rounding per chunk, so
//   the kernel spells it out with __fmaf_rn, and __fmul_rn keeps the scale
//   product a separate rounding; the plain version emulates the same FMA;
// * the tile is written once, at the end: no atomics.
//
// __dp4a, wider loads and TMA are later work.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void spmm_dedup_chunks_q8_kernel(
    const int32_t* __restrict__ u_cols, const int32_t* __restrict__ remaining,
    const int32_t* __restrict__ block_ptr, const int8_t* __restrict__ a_q8,
    const float* __restrict__ a_scale, const int8_t* __restrict__ x_q8,
    const float* __restrict__ x_scale, float* __restrict__ y, int block_rows,
    int width, int d, int q_tile) {
  extern __shared__ int land_q[];  // (width, d_tile) landing buffer
  const int d_tile = blockDim.x;
  const int b = blockIdx.x;
  const int col0 = blockIdx.y * d_tile;
  const int r = threadIdx.y;
  const int dd = threadIdx.x;
  const int tid = r * d_tile + dd;
  const int n_threads = d_tile * block_rows;
  const int col = col0 + dd;
  const float xs = col < d ? x_scale[col / q_tile] : 0.f;
  float acc = 0.f;
  const int k_end = block_ptr[b + 1];
  for (int k = block_ptr[b]; k < k_end; ++k) {
    const int n_u = min(remaining[k], width);  // never past the buffer
    const int32_t* cols_k = u_cols + (int64_t)k * width;
    __syncthreads();  // the previous chunk's fold has read the buffer
    for (int i = tid; i < n_u * d_tile; i += n_threads) {
      const int u = i / d_tile;
      const int c = col0 + (i - u * d_tile);
      land_q[i] = c < d ? (int)x_q8[(int64_t)cols_k[u] * d + c] : 0;
    }
    __syncthreads();
    const int8_t* a_row = a_q8 + ((int64_t)k * block_rows + r) * width;
    int isum = 0;
    for (int u = 0; u < n_u; ++u) {
      isum += (int)a_row[u] * land_q[u * d_tile + dd];
    }
    acc = __fmaf_rn((float)isum, __fmul_rn(a_scale[k], xs), acc);
  }
  if (col < d) {
    y[((int64_t)b * block_rows + r) * d + col] = acc;
  }
}

extern "C" int spmm_dedup_chunks_q8_launch(
    const void* u_cols, const void* remaining, const void* block_ptr,
    const void* a_q8, const void* a_scale, const void* x_q8,
    const void* x_scale, void* y, int n_blocks, int block_rows, int width,
    int d, int d_tile, int q_tile, void* stream) {
  if (n_blocks == 0 || d == 0) {
    return 0;
  }
  if (q_tile <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(n_blocks, (d + d_tile - 1) / d_tile);
  const dim3 block(d_tile, block_rows);
  const size_t smem = (size_t)width * d_tile * sizeof(int);
  spmm_dedup_chunks_q8_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int32_t*)u_cols, (const int32_t*)remaining,
      (const int32_t*)block_ptr, (const int8_t*)a_q8, (const float*)a_scale,
      (const int8_t*)x_q8, (const float*)x_scale, (float*)y, block_rows,
      width, d, q_tile);
  return (int)cudaGetLastError();
}
