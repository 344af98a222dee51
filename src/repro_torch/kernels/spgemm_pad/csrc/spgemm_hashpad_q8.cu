// int8 hash-pad numeric phase of sparse x sparse C = A @ B, for Hopper.
//
// Replaces the Pallas TPU kernel
// repro/kernels/spgemm_pad/spgemm_pad.py:spgemm_hashpad_q8 (body
// _kernel_q8).
//
// Computes, for every output block b of 8 rows,
//   c_pad[b] = sum over the block's chunks k of
//              a_scale[k] * b_scale[k] * (a_q8[k] @ slab_q8[k])
// where a_q8[k] is chunk k's (8, width) int8 coefficient tile and
// slab_q8[k] its (width, pad_width) int8 slice of the hashed B slab, both
// quantized with one scale per chunk (repro_torch.sparse.quantize).  Only
// the first remaining[k] lanes of a chunk are live.  The chunks of block b
// are block_ptr[b] .. block_ptr[b+1]-1.  The pad is f32.
//
// What bounds it on the H100: bytes.  Each live slab row is read once, at
// one byte per pad lane (a quarter of the f32 kernel's slab traffic; the
// gcn-cora A^2 plan has 12499 live rows of 4096 lanes, ~51 MB), and feeds
// 2 * 8 integer operations per byte: far below the int8 tensor cores'
// ridge point.  The design is the f32 kernel's (spgemm_hashpad.cu):
//
// * one thread block per (output block, h tile of <= 256 lanes); each
//   thread owns one pad column and keeps its 8 pad rows in f32 registers;
// * the block walks its chunk range in order, lands the live columns of
//   the int8 coefficient tile in shared memory (widened to int), and reads
//   only the live slab rows (u < remaining[k]), neighbouring threads on
//   neighbouring bytes;
// * per chunk each thread sums int8 * int8 into int32 per row -- exact, and
//   equal to the reference's f32 dot since |sum| <= 127*127*width < 2^24 --
//   then folds pad[r] = fma(isum[r], a_scale[k] * b_scale[k], pad[r]): the
//   reference's pad + dot * s is contracted by XLA into that FMA, so the
//   kernel spells it out with __fmaf_rn (and __fmul_rn for the scale
//   product), and the plain version emulates the same FMA;
// * the pad is written once, after the block's last chunk (the rolling
//   eviction); a block with an empty chunk range writes its zero pad;
// * slab offsets are 64-bit (n_chunks * width * pad_width ~ 1.29e9 at
//   Pubmed scale).
//
// One byte per thread per slab row coalesces to 32 bytes per warp; char4
// loads per thread and TMA streaming of the slab are later work.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int BR_Q8 = 8;  // block_rows: every plan of the repo packs 8

__global__ void spgemm_hashpad_q8_kernel(
    const int32_t* __restrict__ remaining,
    const int32_t* __restrict__ block_ptr, const int8_t* __restrict__ a_q8,
    const float* __restrict__ a_scale, const int8_t* __restrict__ slab_q8,
    const float* __restrict__ slab_scale, float* __restrict__ c_pad,
    int width, int pad_width) {
  extern __shared__ int a_tile_q[];  // (BR_Q8, width): live columns only
  const int b = blockIdx.x;
  const int h = blockIdx.y * blockDim.x + threadIdx.x;
  const int tid = threadIdx.x;
  float pad[BR_Q8];
#pragma unroll
  for (int r = 0; r < BR_Q8; ++r) pad[r] = 0.f;
  const int k_end = block_ptr[b + 1];
  for (int k = block_ptr[b]; k < k_end; ++k) {
    const int n_u = min(remaining[k], width);  // never past the tile
    __syncthreads();  // the previous chunk's fold has read the tile
    for (int i = tid; i < BR_Q8 * n_u; i += blockDim.x) {
      const int r = i / n_u;
      const int u = i - r * n_u;
      a_tile_q[r * width + u] =
          (int)a_q8[((int64_t)k * BR_Q8 + r) * width + u];
    }
    __syncthreads();
    const int8_t* s = slab_q8 + (int64_t)k * width * pad_width + h;
    int isum[BR_Q8];
#pragma unroll
    for (int r = 0; r < BR_Q8; ++r) isum[r] = 0;
#pragma unroll 4
    for (int u = 0; u < n_u; ++u) {
      const int v = (int)s[(int64_t)u * pad_width];
#pragma unroll
      for (int r = 0; r < BR_Q8; ++r) {
        isum[r] += a_tile_q[r * width + u] * v;
      }
    }
    const float sc = __fmul_rn(a_scale[k], slab_scale[k]);
#pragma unroll
    for (int r = 0; r < BR_Q8; ++r) {
      pad[r] = __fmaf_rn((float)isum[r], sc, pad[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < BR_Q8; ++r) {
    c_pad[((int64_t)b * BR_Q8 + r) * pad_width + h] = pad[r];
  }
}

extern "C" int spgemm_hashpad_q8_launch(
    const void* remaining, const void* block_ptr, const void* a_q8,
    const void* a_scale, const void* slab_q8, const void* slab_scale,
    void* c_pad, int n_blocks, int block_rows, int width, int pad_width,
    int h_tile, void* stream) {
  if (block_rows != BR_Q8) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_blocks == 0 || pad_width == 0) {
    return 0;
  }
  const dim3 grid(n_blocks, pad_width / h_tile);
  const size_t smem = (size_t)BR_Q8 * width * sizeof(int);
  spgemm_hashpad_q8_kernel<<<grid, h_tile, smem, (cudaStream_t)stream>>>(
      (const int32_t*)remaining, (const int32_t*)block_ptr,
      (const int8_t*)a_q8, (const float*)a_scale, (const int8_t*)slab_q8,
      (const float*)slab_scale, (float*)c_pad, width, pad_width);
  return (int)cudaGetLastError();
}
