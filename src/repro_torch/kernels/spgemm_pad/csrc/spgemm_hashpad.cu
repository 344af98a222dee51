// Hash-pad numeric phase of sparse x sparse C = A @ B, f32 and int8, for
// Hopper.
//
// Replaces the Pallas TPU kernels
// repro/kernels/spgemm_pad/spgemm_pad.py:spgemm_hashpad (body _kernel) and
// spgemm_hashpad_q8 (body _kernel_q8): one walk, instantiated for each
// (Fold<float>, Fold<int8_t> below).
//
// Computes, for every output block b of BR = 8 rows and every chunk k of
// it in order (block_ptr[b] .. block_ptr[b+1]-1),
//   f32:  pad[r, h] += sum over lanes u of a[k][r, u] * slab[k][u, h]
//   int8: pad[r, h] += a_scale[k] * slab_scale[k] *
//                      sum over lanes u of a_q8[k][r, u] * slab_q8[k][u, h]
// then evicts row r's bucket out_bucket[i] as C's value i.  a[k] is chunk
// k's (BR, width) coefficient tile (A packed by pack_dedup_chunks; only
// its first remaining[k] lanes are live) and slab[k] the hashed B rows of
// those lanes: lane u holds B row u_cols[k, u], each value at the bucket
// its output column hashes to.  The slab arrives as its nonzero cells:
// chunk k's cells are cell_ptr[k] .. cell_ptr[k+1]-1, each a (lane,
// bucket, value), ordered by (bucket, lane).  int8 operands carry one
// scale per chunk (repro_torch.sparse.quantize); the pad is f32.
//
// What bounds it on the H100: neither bytes nor operations, but the
// latency of each block's short chain of dependent loads.  The function
// itself moves ~10 MB at Pubmed scale (A's live columns, ~0.4 M cells of
// 12 bytes, C's 0.4 M buckets read and values written) and does 2 flops
// per product of a nonzero coefficient with a cell of its lane: a few
// microseconds of HBM time.  The dense slab that the reference streams
// (5.2 GB f32 or 1.3 GB int8 at Pubmed scale, ~99% zeros) is never built
// or read.  The pad, though, is indexed by bucket and the per-block
// injective hash makes the pad width H 50-100x the longest row of C, so
// one block's pad (BR x H f32, 256 KB at H = 8192) fills most of an SM's
// shared memory while its work is a few hundred cells.  The design:
//
// * one thread block per (output block, tile of h_tile buckets); the pad
//   tile (BR, h_tile) f32 lives in shared memory, indexed by bucket - h0,
//   with the live columns of the current coefficient tile beside it (f32,
//   or int8 widened to int).  h_tile is chosen by the wrapper (1024:
//   32 KB, several blocks per SM, so one block's load latency hides behind
//   another's work); a wider pad is split over gridDim.y, and each tile's
//   block walks all of its block's cells and C entries and keeps those in
//   its bucket range (the lists are short and the repeated reads hit L2);
// * zeroing: the block zeroes only the pad columns it will evict (every
//   column that a cell of the block touches is one of them), not all
//   h_tile buckets, so its shared-memory stores scale with C's nonzeros;
// * accumulate per chunk, in order, without float atomics: a run of cells
//   with one bucket is one thread's work.  f32 sums fmaf(a[r, u], v,
//   part[r]) over the run's lanes in lane order for the BR rows, then adds
//   part into pad[.][h] -- the summation order of a dense fold over every
//   lane without its a * 0 terms.  int8 sums a_q8 * v into an int32 per
//   row -- exact in any order, and equal to the reference's f32 dot since
//   |sum| <= 127 * 127 * width < 2^24 -- then folds pad = fma(isum,
//   a_scale[k] * slab_scale[k], pad): XLA contracts the reference's
//   pad + dot * s into that FMA, so it is spelled __fmaf_rn (and __fmul_rn
//   for the scale product).  No other thread touches that column in that
//   chunk, and chunks follow one another behind a barrier, so the result
//   is the same from run to run, bit for bit;
// * A's coefficient tile is read from its live columns only
//   (u < remaining[k]); a cell on a dead lane is skipped unread;
// * each chunk's live-lane count and cell range are loaded before the
//   barrier ahead of it, with the previous phase's loads, which shortens
//   the chain;
// * eviction writes C directly: entry i of the block's rows
//   (c_indptr[8b] .. c_indptr[min(8b + 8, n_rows)]) reads pad[row - 8b]
//   [out_bucket[i]] into c_vals[i]; no (n_blocks * BR, H) array exists.
//
// Index data is trusted for values, never for memory: chunk, cell and C
// ranges are clamped to the arrays' lengths, lanes outside [0, remaining)
// and buckets outside the pad are skipped, and a C entry whose bucket lies
// outside [0, pad_width) -- or that no block's rows cover -- is written
// NaN, so a plan and pad width that disagree give NaN, never stale memory.
//
// Dynamic shared memory above 48 KB (h_tile > 1024) is opted into once per
// process and instantiation, before the first launch (not inside a
// captured call).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BR = 8;         // block_rows: every plan of the repo packs 8
constexpr int THREADS = 128;

// How a run's products are summed and folded into the pad, per element
// type of A's tiles and B's cells.  Acc is the run's partial sum and the
// type of the coefficient tile in shared memory.
template <typename T>
struct Fold;

template <>
struct Fold<float> {
  using Acc = float;
  static __device__ __forceinline__ float mad(float a, float v, float part) {
    return fmaf(a, v, part);
  }
  static __device__ __forceinline__ float into(float part, float /*scale*/,
                                               float pad) {
    return pad + part;
  }
};

template <>
struct Fold<int8_t> {
  using Acc = int;
  static __device__ __forceinline__ int mad(int a, int v, int isum) {
    return isum + a * v;
  }
  static __device__ __forceinline__ float into(int isum, float scale,
                                               float pad) {
    return __fmaf_rn((float)isum, scale, pad);
  }
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Row within the block of C entry i, from the block's BR + 1 row pointers.
__device__ __forceinline__ int row_in_block(const int* rp, int i) {
  int r = 0;
#pragma unroll
  for (int q = 1; q < BR; ++q) r += (i >= rp[q]);
  return r;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) spgemm_hashpad_kernel(
    const int32_t* __restrict__ remaining,
    const int32_t* __restrict__ block_ptr, const T* __restrict__ a,
    const float* __restrict__ a_scale, const int32_t* __restrict__ cell_ptr,
    const int32_t* __restrict__ cell_lane,
    const int32_t* __restrict__ cell_bucket, const T* __restrict__ cell_val,
    const float* __restrict__ cell_scale,
    const int32_t* __restrict__ c_indptr,
    const int32_t* __restrict__ out_bucket, float* __restrict__ c_vals,
    int n_chunks, int n_cells, int n_rows, int nnz, int width, int pad_width,
    int h_tile) {
  using F = Fold<T>;
  using Acc = typename F::Acc;
  extern __shared__ float smem[];
  float* pad = smem;                                       // (BR, h_tile)
  Acc* a_tile = reinterpret_cast<Acc*>(smem + BR * h_tile);  // (BR, width)
  __shared__ int rp[BR + 1];            // the block's row pointers into C
  const int b = blockIdx.x;
  const unsigned h0 = blockIdx.y * h_tile;
  const int tid = threadIdx.x;
  if (tid <= BR) rp[tid] = clampi(c_indptr[min(b * BR + tid, n_rows)], 0, nnz);
  const int k_begin = max(block_ptr[b], 0);
  const int k_end = min(block_ptr[b + 1], n_chunks);
  // the first chunk's live lanes and cell range, in flight with rp
  int n_u = 0;
  int c_begin = 0;
  int c_end = 0;
  if (k_begin < k_end) {
    n_u = clampi(remaining[k_begin], 0, width);
    c_begin = clampi(cell_ptr[k_begin], 0, n_cells);
    c_end = clampi(cell_ptr[k_begin + 1], c_begin, n_cells);
  }
  __syncthreads();
  const int e_begin = rp[0];
  const int e_end = rp[BR];

  // zero the pad columns this block evicts in this tile
  for (int i = e_begin + tid; i < e_end; i += THREADS) {
    const unsigned h = (unsigned)out_bucket[i] - h0;
    if (h < (unsigned)h_tile) {
#pragma unroll
      for (int r = 0; r < BR; ++r) pad[r * h_tile + h] = 0.f;
    }
  }

  for (int k = k_begin; k < k_end; ++k) {
    for (int i = tid; i < BR * n_u; i += THREADS) {
      const int r = i / n_u;
      const int u = i - r * n_u;
      a_tile[r * width + u] = (Acc)a[((int64_t)k * BR + r) * width + u];
    }
    float scale = 0.f;
    if constexpr (std::is_same<T, int8_t>::value) {
      scale = __fmul_rn(a_scale[k], cell_scale[k]);
    }
    __syncthreads();  // the tile has landed; the pad is zeroed or folded
    for (int i = c_begin + tid; i < c_end; i += THREADS) {
      const int h = cell_bucket[i];
      const unsigned col_h = (unsigned)h - h0;
      if (col_h >= (unsigned)h_tile) continue;
      if (i > c_begin && cell_bucket[i - 1] == h) continue;  // not a run head
      Acc part[BR];
#pragma unroll
      for (int r = 0; r < BR; ++r) part[r] = 0;
      int j = i;
      do {
        const int u = cell_lane[j];
        if ((unsigned)u < (unsigned)n_u) {
          const Acc v = (Acc)cell_val[j];
#pragma unroll
          for (int r = 0; r < BR; ++r) {
            part[r] = F::mad(a_tile[r * width + u], v, part[r]);
          }
        }
      } while (++j < c_end && cell_bucket[j] == h);
      float* col = pad + col_h;
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        col[r * h_tile] = F::into(part[r], scale, col[r * h_tile]);
      }
    }
    if (k + 1 < k_end) {  // the next chunk's, before the barrier
      n_u = clampi(remaining[k + 1], 0, width);
      c_begin = c_end;
      c_end = clampi(cell_ptr[k + 2], c_begin, n_cells);
    }
    __syncthreads();  // the chunk is folded before the tile is reused
  }
  if (k_begin >= k_end) __syncthreads();  // zeroing done (block-uniform)

  // rolling eviction: C's entries of this block, straight from the pad
  const float nan = __int_as_float(0x7fc00000);
  for (int i = e_begin + tid; i < e_end; i += THREADS) {
    const int ob = out_bucket[i];
    const unsigned h = (unsigned)ob - h0;
    if ((unsigned)ob >= (unsigned)pad_width) {
      if (blockIdx.y == 0) c_vals[i] = nan;   // no pad column holds it
    } else if (h < (unsigned)h_tile) {
      c_vals[i] = pad[row_in_block(rp, i) * h_tile + h];
    }
  }
  // C entries before the first row or past the last: NaN
  if (blockIdx.y == 0 && b == 0) {
    for (int i = tid; i < e_begin; i += THREADS) c_vals[i] = nan;
  }
  if (blockIdx.y == 0 && b == gridDim.x - 1) {
    for (int i = e_end + tid; i < nnz; i += THREADS) c_vals[i] = nan;
  }
}

// Opt in to all the dynamic shared memory a block may have beside the
// kernel's static rp[].
template <typename T>
cudaError_t allow_large_pad_tiles() {
  int dev = 0;
  int optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&fa, spgemm_hashpad_kernel<T>);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(spgemm_hashpad_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
  }
  return err;
}

template <typename T>
int launch(const void* remaining, const void* block_ptr, const void* a,
           const void* a_scale, const void* cell_ptr, const void* cell_lane,
           const void* cell_bucket, const void* cell_val,
           const void* cell_scale, const void* c_indptr,
           const void* out_bucket, void* c_vals, int n_blocks, int n_chunks,
           int n_cells, int n_rows, int nnz, int block_rows, int width,
           int pad_width, int h_tile, void* stream) {
  if (block_rows != BR || width <= 0 || h_tile <= 0 || pad_width <= 0 ||
      pad_width % h_tile != 0 || n_blocks < 0 || n_chunks < 0 ||
      n_cells < 0 || nnz < 0 || (n_blocks == 0 && nnz > 0)) {
    return (int)cudaErrorInvalidValue;
  }
  // set once, before any graph capture
  static const cudaError_t attr = allow_large_pad_tiles<T>();
  if (attr != cudaSuccess) return (int)attr;
  if (n_blocks == 0) return 0;
  const dim3 grid(n_blocks, pad_width / h_tile);
  const size_t smem = (size_t)BR * (h_tile + width) * sizeof(float);
  spgemm_hashpad_kernel<T><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)remaining, (const int32_t*)block_ptr, (const T*)a,
      (const float*)a_scale, (const int32_t*)cell_ptr,
      (const int32_t*)cell_lane, (const int32_t*)cell_bucket,
      (const T*)cell_val, (const float*)cell_scale, (const int32_t*)c_indptr,
      (const int32_t*)out_bucket, (float*)c_vals, n_chunks, n_cells, n_rows,
      nnz, width, pad_width, h_tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spgemm_hashpad_launch(
    const void* remaining, const void* block_ptr, const void* a,
    const void* cell_ptr, const void* cell_lane, const void* cell_bucket,
    const void* cell_val, const void* c_indptr, const void* out_bucket,
    void* c_vals, int n_blocks, int n_chunks, int n_cells, int n_rows,
    int nnz, int block_rows, int width, int pad_width, int h_tile,
    void* stream) {
  return launch<float>(remaining, block_ptr, a, nullptr, cell_ptr, cell_lane,
                       cell_bucket, cell_val, nullptr, c_indptr, out_bucket,
                       c_vals, n_blocks, n_chunks, n_cells, n_rows, nnz,
                       block_rows, width, pad_width, h_tile, stream);
}

extern "C" int spgemm_hashpad_q8_launch(
    const void* remaining, const void* block_ptr, const void* a_q8,
    const void* a_scale, const void* cell_ptr, const void* cell_lane,
    const void* cell_bucket, const void* cell_q8, const void* slab_scale,
    const void* c_indptr, const void* out_bucket, void* c_vals, int n_blocks,
    int n_chunks, int n_cells, int n_rows, int nnz, int block_rows, int width,
    int pad_width, int h_tile, void* stream) {
  return launch<int8_t>(remaining, block_ptr, a_q8, a_scale, cell_ptr,
                        cell_lane, cell_bucket, cell_q8, slab_scale, c_indptr,
                        out_bucket, c_vals, n_blocks, n_chunks, n_cells,
                        n_rows, nnz, block_rows, width, pad_width, h_tile,
                        stream);
}
