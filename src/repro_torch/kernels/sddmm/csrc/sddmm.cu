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
// What bounds it on the H100: bytes.  An edge does 2 * D flops on two
// D-wide rows.  In the caller's order every edge gathers two random rows,
// and at ogb_products (2.4M rows of 100 in each of x and y, 39x the 50 MB
// L2 together) each x row is fetched again for each of its ~25 edges.  So,
// when x takes more than twice the L2 (the wrapper decides, from the card's
// L2 size; below that the direct path is faster, as chip_smoke.py's B7
// path sweep measures):
//
// * the call groups the edges by source with its own kernels, a counting
//   sort: each edge's rank in its group from a count per source
//   (warp-aggregated atomics, so sorted or skewed sources do not serialize
//   on one counter); an exclusive scan of the counts in three passes (tile
//   sums, one block over the tile sums, tile scans) that also records the
//   source at the start of every chunk of the grouped edges; then the
//   scatter of each dst to its slot, start[source] + rank, in two steps
//   whose writes reach memory as whole sectors: a partition into buckets
//   of BUCKET slots through per-bucket cursors (their write fronts stay in
//   L2 until full), and one block per bucket placing its dsts in slot
//   order through shared memory.  Invalid sources form one group of their
//   own, key Nx.  No host sync: every size follows from E and Nx.  The
//   output doubles as staging, so the scratch is two int32 per edge and
//   one per source;
// * the dot kernel walks the grouped edges in fixed chunks, one chunk per
//   block, so a hub with 40K edges spans many blocks.  A block first labels
//   each position of its chunk with its source, searching the groups'
//   starts between the chunk's first source and the next chunk's;
// * a group of `lanes` lanes (a power of two, 8 at D = 100) computes one
//   edge at a time: lane l loads the VEC-wide column slices l, l + lanes,
//   ... (float4 where D % 4 == 0 and x and y are 16-byte aligned, scalar
//   otherwise), SLOTS of them per column tile.  Each group takes RUN
//   consecutive edges of the chunk and keeps the source's x slices in
//   registers while the source stays the same: an x row is read about once
//   per source, and the y rows are the traffic left;
// * IN_FLIGHT edges' y rows are loaded before any of them is summed;
// * each lane sums its columns in increasing order with fmaf, and the group
//   adds its lanes with a butterfly of shuffles, so an edge's score depends
//   only on D and the lane layout, never on the edge's position or the path
//   it took: scores are bitwise equal run to run, under any permutation of
//   the edges, and between the grouped and the direct path;
// * the scores, written in grouped order over the grouped dsts, are
//   gathered back to the caller's edge order (coalesced writes);
// * otherwise one launch of the same dot kernel in the caller's order,
//   two edges per group (RUN_DIRECT), with no grouping.  So does a call
//   whose edges the grouping's int32 ranks and slots cannot count.
//
// Every scattered 4-byte access (the count's and the cursors' atomics, the
// staging writes, the gather's reads) costs one L2 transaction, and the
// grouping makes about five per edge; that, not bytes, is what the grouping
// costs beside the dot kernel's y rows.
//
// Row offsets are 64-bit (ogb_products: 2.4M rows of 100).
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 256;      // every kernel's block
constexpr int RUN_GROUPED = 16;   // consecutive grouped edges per lane group
constexpr int RUN_DIRECT = 2;     // edges per lane group in caller order
constexpr int IN_FLIGHT = 2;      // edges whose y rows load together
constexpr int SLOTS = 4;          // VEC-wide loads per lane per column tile
constexpr int SCAN_ITEMS = 8;     // counters per thread in the tile scan
constexpr int SCAN_TILE = THREADS * SCAN_ITEMS;
constexpr int UNROLL = 4;         // edges per lane in the per-edge passes
constexpr int WARP_TILE = 32 * UNROLL;
constexpr int PASS_BLOCKS = 4096; // grid of the per-edge passes
constexpr int BUCKET = 4096;      // grouped slots placed by one block

__device__ __forceinline__ int64_t wrap_row(int64_t i, int64_t n) {
  if (i < 0) i += n;
  return (i < 0 || i >= n) ? -1 : i;
}

// An edge's source group: its wrapped row, or nx for an invalid source.
__device__ __forceinline__ int32_t group_key(int32_t s, int64_t nx) {
  const int64_t r = wrap_row(s, nx);
  return r < 0 ? (int32_t)nx : (int32_t)r;
}

// ---------------------------------------------------------------------------
// grouping: count and rank, scan, two-step scatter, and the gather back
// ---------------------------------------------------------------------------
//
// The per-edge passes walk the edges in warp tiles of 32 * UNROLL: lane l
// takes edges l, l + 32, ... of its warp's tile, so each load instruction
// is one coalesced 128-byte line and every lane has UNROLL loads in flight.
// All 32 lanes take every trip, so warp-wide intrinsics see the whole warp.
#define FOR_EACH_WARP_TILE(n_edges)                                          \
  const int lane = threadIdx.x & 31;                                         \
  const int64_t warps = (int64_t)gridDim.x * (THREADS / 32);                 \
  for (int64_t tile = (int64_t)blockIdx.x * (THREADS / 32) +                 \
                      (threadIdx.x >> 5);                                    \
       tile * WARP_TILE < (n_edges); tile += warps)

// rank[e] = the edge's place in its group, count[key] = the group's size.
// Lanes of one key in a warp take consecutive ranks from one atomic, so
// sorted or skewed sources do not serialize on one counter.
__global__ void __launch_bounds__(THREADS) group_count_kernel(
    const int32_t* __restrict__ src, int32_t* __restrict__ count,
    int32_t* __restrict__ rank, int64_t n_edges, int64_t nx) {
  FOR_EACH_WARP_TILE(n_edges) {
    int32_t key[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t e = tile * WARP_TILE + u * 32 + lane;
      key[u] = e < n_edges ? group_key(__ldcs(src + e), nx) : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t e = tile * WARP_TILE + u * 32 + lane;
      const unsigned peers = __match_any_sync(0xffffffffu, key[u]);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (key[u] >= 0 && lane == leader)
        base = atomicAdd(count + key[u], __popc(peers));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (e < n_edges) rank[e] = base + __popc(peers & ((1u << lane) - 1u));
    }
  }
}

// Inclusive scan of v over the block; *total gets the block's sum.  Every
// thread of the block calls it.
__device__ int block_inclusive_scan(int v, int* total) {
  __shared__ int warp_sum[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  if (lane == 31) warp_sum[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < THREADS / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += t;
    }
    if (lane < THREADS / 32) warp_sum[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sum[warp - 1];
  *total = warp_sum[THREADS / 32 - 1];
  __syncthreads();                       // warp_sum is reused by the caller
  return v;
}

// tile_sum[t] = sum of count over tile t (SCAN_TILE counters).
__global__ void __launch_bounds__(THREADS) scan_reduce_kernel(
    const int32_t* __restrict__ count, int32_t* __restrict__ tile_sum,
    int64_t n) {
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE;
  int s = 0;
  for (int i = threadIdx.x; i < SCAN_TILE; i += THREADS)
    if (base + i < n) s += count[base + i];
  int total;
  block_inclusive_scan(s, &total);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

// One block: tile_sum becomes its exclusive prefix sum, in place.
__global__ void __launch_bounds__(THREADS) scan_tile_sums_kernel(
    int32_t* __restrict__ tile_sum, int64_t n_tiles) {
  int carry = 0;
  for (int64_t base = 0; base < n_tiles; base += THREADS) {
    const int64_t i = base + threadIdx.x;
    const int v = i < n_tiles ? tile_sum[i] : 0;
    int total;
    const int incl = block_inclusive_scan(v, &total);
    if (i < n_tiles) tile_sum[i] = carry + incl - v;
    carry += total;
  }
}

// count becomes each group's start, in place, and first_key[q] the group
// that holds grouped position q * chunk.
__global__ void __launch_bounds__(THREADS) scan_apply_kernel(
    int32_t* __restrict__ count, const int32_t* __restrict__ tile_off,
    int32_t* __restrict__ first_key, int64_t n, int chunk) {
  const int64_t k0 = (int64_t)blockIdx.x * SCAN_TILE +
                     (int64_t)threadIdx.x * SCAN_ITEMS;
  int c[SCAN_ITEMS];
  int local = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    c[j] = k0 + j < n ? count[k0 + j] : 0;
    local += c[j];
  }
  int total;
  int start = tile_off[blockIdx.x] + block_inclusive_scan(local, &total) -
              local;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    if (k0 + j < n) {
      count[k0 + j] = start;
      const int64_t end = (int64_t)start + c[j];
      for (int64_t q = ((int64_t)start + chunk - 1) / chunk; q * chunk < end;
           ++q)
        first_key[q] = (int32_t)(k0 + j);
    }
    start += c[j];
  }
}

// The scatter into source order, in two steps whose writes all reach
// memory as whole sectors.  A grouped edge's slot is start[key] + rank; the
// slots fall in buckets of BUCKET consecutive slots.
//
// Step 1 (partition): each edge takes the next place in its bucket's
// region of the staging arrays (a per-bucket cursor, warp-aggregated
// atomics) and writes its slot and dst there.  The cursors of all buckets
// together touch only a few sectors each at a time, which L2 holds until
// they are full.  pos[e] = slot replaces rank[e] in place, for the gather
// back at the end.
__global__ void __launch_bounds__(THREADS) group_partition_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    int32_t* __restrict__ rank_pos, const int32_t* __restrict__ start,
    int32_t* __restrict__ cursor, int32_t* __restrict__ stage_slot,
    int32_t* __restrict__ stage_dst, int64_t n_edges, int64_t nx) {
  FOR_EACH_WARP_TILE(n_edges) {
    int32_t slot[UNROLL], d[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t e = tile * WARP_TILE + u * 32 + lane;
      slot[u] = -1;
      if (e < n_edges) {
        slot[u] = start[group_key(__ldcs(src + e), nx)] + rank_pos[e];
        d[u] = __ldcs(dst + e);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t e = tile * WARP_TILE + u * 32 + lane;
      const int32_t bucket = slot[u] < 0 ? -1 : slot[u] / BUCKET;
      const unsigned peers = __match_any_sync(0xffffffffu, bucket);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (bucket >= 0 && lane == leader)
        base = atomicAdd(cursor + bucket, __popc(peers));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (bucket >= 0) {
        const int64_t i = (int64_t)bucket * BUCKET + base +
                          __popc(peers & ((1u << lane) - 1u));
        rank_pos[e] = slot[u];
        stage_slot[i] = slot[u];
        stage_dst[i] = d[u];
      }
    }
  }
}

// Step 2 (place): one block per bucket holds the bucket's dsts in shared
// memory by slot, then writes them out in slot order.  grouped may be
// stage_slot itself: the block reads all of its bucket before it writes.
__global__ void __launch_bounds__(THREADS) group_place_kernel(
    const int32_t* stage_slot, const int32_t* __restrict__ stage_dst,
    int32_t* grouped, int64_t n_edges) {
  __shared__ int32_t s_dst[BUCKET];
  const int64_t base = (int64_t)blockIdx.x * BUCKET;
  const int n = (int)min((int64_t)BUCKET, n_edges - base);
  for (int i = threadIdx.x; i < n; i += THREADS)
    s_dst[stage_slot[base + i] - base] = stage_dst[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += THREADS) grouped[base + i] = s_dst[i];
}

// out[e] = score[pos[e]]: the grouped scores back in the caller's edge
// order, gathered so that every write is coalesced.
__global__ void __launch_bounds__(THREADS) gather_scores_kernel(
    const int32_t* __restrict__ pos, const float* __restrict__ score,
    float* __restrict__ out, int64_t n_edges) {
  FOR_EACH_WARP_TILE(n_edges) {
    int32_t slot[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t e = tile * WARP_TILE + u * 32 + lane;
      slot[u] = e < n_edges ? __ldcs(pos + e) : -1;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t e = tile * WARP_TILE + u * 32 + lane;
      if (slot[u] >= 0) __stcs(out + e, __ldcs(score + slot[u]));
    }
  }
}

// ---------------------------------------------------------------------------
// the dot kernel
// ---------------------------------------------------------------------------

template <int VEC>
__device__ __forceinline__ void load_slice(float (&r)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = t.x;
    r[1] = t.y;
    r[2] = t.z;
    r[3] = t.w;
  } else {
    r[0] = __ldg(p);
  }
}

// One block per chunk of RUN * (THREADS / lanes) edges.  GROUPED: grouped
// positions, whose dst grouped[p] holds and whose score replaces it there
// (read before written, by the same lane group); otherwise the caller's
// edge order, scores to out.
template <int VEC, int RUN, bool GROUPED>
__global__ void __launch_bounds__(THREADS) sddmm_dot_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    int32_t* grouped, const int32_t* __restrict__ start,
    const int32_t* __restrict__ first_key, const float* __restrict__ x,
    const float* __restrict__ y, float* __restrict__ out, int64_t n_edges,
    int64_t nx, int64_t ny, int dim, int lanes) {
  __shared__ int32_t s_key[GROUPED ? RUN * THREADS : 1];
  const int chunk = RUN * (THREADS / lanes);
  const int64_t p0 = (int64_t)blockIdx.x * chunk;
  const int64_t p1 = min(p0 + (int64_t)chunk, n_edges);
  if constexpr (GROUPED) {
    // the sources of [p0, p1) lie in [k0, k1]: label each position with
    // the last group in that range that starts at or before it (a search,
    // so runs of empty groups between sources cost nothing)
    const int32_t k0 = first_key[blockIdx.x];
    const int32_t k1 = blockIdx.x + 1 < gridDim.x
                           ? first_key[blockIdx.x + 1]
                           : (int32_t)nx;
    for (int64_t p = p0 + threadIdx.x; p < p1; p += THREADS) {
      int32_t lo = k0, hi = k1;
      while (lo < hi) {
        const int32_t mid = lo + ((hi - lo + 1) >> 1);
        if (start[mid] <= p) lo = mid; else hi = mid - 1;
      }
      s_key[p - p0] = lo;
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & (lanes - 1);
  const int64_t g0 = p0 + (int64_t)(threadIdx.x / lanes) * RUN;
  const int n_vec = dim / VEC;
  const int tile = lanes * SLOTS;
  const int n_tiles = (n_vec + tile - 1) / tile;
  const bool keep_x = n_tiles == 1;   // the whole row fits one tile
  float xr[SLOTS][VEC];
  int32_t x_row = -1;                 // the row whose slices xr holds
#pragma unroll
  for (int i = 0; i < RUN; i += IN_FLIGHT) {
    int32_t xs[IN_FLIGHT], ys[IN_FLIGHT];   // -1: an invalid index
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int64_t p = g0 + i + u;
      xs[u] = ys[u] = -1;
      if (p < p1) {
        if constexpr (GROUPED) {
          const int32_t k = s_key[p - p0];
          xs[u] = k == nx ? -1 : k;
          ys[u] = (int32_t)wrap_row(grouped[p], ny);
        } else {
          xs[u] = (int32_t)wrap_row(src[p], nx);
          ys[u] = (int32_t)wrap_row(dst[p], ny);
        }
      }
    }
    float acc[IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) acc[u] = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      float yr[IN_FLIGHT][SLOTS][VEC];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u)
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int v = (t * SLOTS + s) * lanes + lane;
#pragma unroll
          for (int c = 0; c < VEC; ++c) yr[u][s][c] = 0.f;
          if (xs[u] >= 0 && ys[u] >= 0 && v < n_vec)
            load_slice<VEC>(yr[u][s],
                            y + (int64_t)ys[u] * dim + (int64_t)v * VEC);
        }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        if (xs[u] < 0 || ys[u] < 0) continue;
        if (xs[u] != x_row || !keep_x) {
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            const int v = (t * SLOTS + s) * lanes + lane;
            if (v < n_vec)
              load_slice<VEC>(xr[s],
                              x + (int64_t)xs[u] * dim + (int64_t)v * VEC);
          }
          x_row = xs[u];
        }
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int v = (t * SLOTS + s) * lanes + lane;
          if (v < n_vec) {
#pragma unroll
            for (int c = 0; c < VEC; ++c)
              acc[u] = fmaf(xr[s][c], yr[u][s][c], acc[u]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      if (xs[u] < 0 || ys[u] < 0) acc[u] = __int_as_float(0x7fc00000);
      for (int off = lanes >> 1; off > 0; off >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      const int64_t p = g0 + i + u;
      if (lane == 0 && p < p1) {
        if constexpr (GROUPED)
          grouped[p] = __float_as_int(acc[u]);
        else
          out[p] = acc[u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch functions
// ---------------------------------------------------------------------------

static bool layout_ok(int vec, int lanes) {
  return (vec == 4 || vec == 1) && lanes >= 1 && lanes <= 32 &&
         (lanes & (lanes - 1)) == 0;
}

template <int RUN, bool GROUPED>
static void launch_dot(int vec, int64_t blocks, cudaStream_t s,
                       const int32_t* src, const int32_t* dst,
                       int32_t* grouped, const int32_t* start,
                       const int32_t* first_key, const float* x,
                       const float* y, float* out, int64_t n_edges,
                       int64_t nx, int64_t ny, int dim, int lanes) {
  if (vec == 4)
    sddmm_dot_kernel<4, RUN, GROUPED><<<(unsigned)blocks, THREADS, 0, s>>>(
        src, dst, grouped, start, first_key, x, y, out, n_edges, nx, ny,
        dim, lanes);
  else
    sddmm_dot_kernel<1, RUN, GROUPED><<<(unsigned)blocks, THREADS, 0, s>>>(
        src, dst, grouped, start, first_key, x, y, out, n_edges, nx, ny,
        dim, lanes);
}

static unsigned pass_blocks(int64_t n_edges) {
  const int64_t warp_tiles = (n_edges + WARP_TILE - 1) / WARP_TILE;
  const int64_t blocks = (warp_tiles + THREADS / 32 - 1) / (THREADS / 32);
  return (unsigned)(blocks < PASS_BLOCKS ? blocks : PASS_BLOCKS);
}

// The direct path: one launch in the caller's edge order.  vec in {4, 1} divides
// dim and both rows' alignment; lanes is a power of two up to 32; rows are
// indexed in int32.
extern "C" int sddmm_launch(const void* src, const void* dst, const void* x,
                            const void* y, void* out, int64_t n_edges,
                            int64_t nx, int64_t ny, int dim, int vec,
                            int lanes, void* stream) {
  if (!layout_ok(vec, lanes) || nx >= INT32_MAX || ny >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  const int chunk = RUN_DIRECT * (THREADS / lanes);
  launch_dot<RUN_DIRECT, false>(
      vec, (n_edges + chunk - 1) / chunk, (cudaStream_t)stream,
      (const int32_t*)src, (const int32_t*)dst, nullptr, nullptr, nullptr,
      (const float*)x, (const float*)y, (float*)out, n_edges, nx, ny, dim,
      lanes);
  return (int)cudaGetLastError();
}

// The grouped path's scratch, int32 words in this order: each edge's rank
// (then its slot) and the grouped dsts (then scores), n_edges each; each
// group's start (nx + 1: the sources and the invalid group); the scan's
// tile sums; the group at the start of each chunk of grouped edges; a
// cursor for each bucket of BUCKET slots.
struct GroupedScratch {
  int64_t n_keys, n_tiles, n_chunks, n_buckets, words;
  GroupedScratch(int64_t n_edges, int64_t nx, int lanes) {
    const int chunk = RUN_GROUPED * (THREADS / lanes);
    n_keys = nx + 1;
    n_tiles = (n_keys + SCAN_TILE - 1) / SCAN_TILE;
    n_chunks = (n_edges + chunk - 1) / chunk;
    n_buckets = (n_edges + BUCKET - 1) / BUCKET;
    words = 2 * n_edges + n_keys + n_tiles + n_chunks + n_buckets;
  }
};

// *words = the int32 words of scratch that sddmm_grouped_launch takes.
extern "C" int sddmm_grouped_scratch(int64_t n_edges, int64_t nx, int lanes,
                                     void* words) {
  if (!layout_ok(4, lanes) || n_edges < 0 || nx < 0)
    return (int)cudaErrorInvalidValue;
  *(int64_t*)words = GroupedScratch(n_edges, nx, lanes).words;
  return 0;
}

// The grouped path: group by source, the dot kernel over the groups, and the
// scores gathered back to edge order.  scratch holds scratch_words int32,
// at least what sddmm_grouped_scratch gives; out doubles as the staging
// dsts until the gather writes it.  Ranks and slots are int32, so
// n_edges < INT32_MAX.
extern "C" int sddmm_grouped_launch(
    const void* src, const void* dst, const void* x, const void* y,
    void* out, int64_t n_edges, int64_t nx, int64_t ny, int dim, int vec,
    int lanes, void* scratch, int64_t scratch_words, void* stream) {
  if (!layout_ok(vec, lanes) || n_edges >= INT32_MAX || nx >= INT32_MAX ||
      ny >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const GroupedScratch n(n_edges, nx, lanes);
  if (scratch_words < n.words) return (int)cudaErrorInvalidValue;
  if (n_edges == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  int32_t* ranks = (int32_t*)scratch;
  int32_t* grp = ranks + n_edges;
  int32_t* starts = grp + n_edges;
  int32_t* tiles = starts + n.n_keys;
  int32_t* firsts = tiles + n.n_tiles;
  int32_t* cursors = firsts + n.n_chunks;
  const int32_t* src_i = (const int32_t*)src;
  const int chunk = RUN_GROUPED * (THREADS / lanes);
  const unsigned blocks = pass_blocks(n_edges);
  cudaError_t err =
      cudaMemsetAsync(starts, 0, n.n_keys * sizeof(int32_t), s);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(cursors, 0, n.n_buckets * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  group_count_kernel<<<blocks, THREADS, 0, s>>>(src_i, starts, ranks,
                                                n_edges, nx);
  scan_reduce_kernel<<<(unsigned)n.n_tiles, THREADS, 0, s>>>(starts, tiles,
                                                              n.n_keys);
  scan_tile_sums_kernel<<<1, THREADS, 0, s>>>(tiles, n.n_tiles);
  scan_apply_kernel<<<(unsigned)n.n_tiles, THREADS, 0, s>>>(
      starts, tiles, firsts, n.n_keys, chunk);
  // staging: slots in grouped, dsts in out; placed in grouped in place
  group_partition_kernel<<<blocks, THREADS, 0, s>>>(
      src_i, (const int32_t*)dst, ranks, starts, cursors, grp,
      (int32_t*)out, n_edges, nx);
  group_place_kernel<<<(unsigned)n.n_buckets, THREADS, 0, s>>>(
      grp, (const int32_t*)out, grp, n_edges);
  launch_dot<RUN_GROUPED, true>(vec, n.n_chunks, s, nullptr, nullptr, grp,
                                starts, firsts, (const float*)x,
                                (const float*)y, nullptr, n_edges, nx, ny,
                                dim, lanes);
  gather_scores_kernel<<<blocks, THREADS, 0, s>>>(
      ranks, (const float*)grp, (float*)out, n_edges);
  return (int)cudaGetLastError();
}
