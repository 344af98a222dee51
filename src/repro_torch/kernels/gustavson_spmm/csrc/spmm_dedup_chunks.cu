// Gustavson SpMM on the operand-deduplicated chunk layout, f32, bf16 and
// int8, for Hopper.
//
// Replaces the Pallas TPU kernels
// repro/kernels/gustavson_spmm/gustavson_spmm.py:spmm_dedup_chunks (bodies
// _kernel_dma, _kernel_stream and _fold) and :spmm_dedup_chunks_q8 (bodies
// _kernel_dma_q8, _kernel_stream_q8 and _fold_q8).
//
// Computes y = A @ x, with A packed by pack_dedup_chunks: chunk k holds
// remaining[k] distinct operand rows u_cols[k, u] and a dense (8, width)
// coefficient tile a[k]; the chunks of output block b are block_ptr[b] ..
// block_ptr[b+1]-1, consecutive.  The int8 kernel takes a_q8 (int8 tiles,
// one f32 scale a_scale[k] per chunk) and x_q8 (int8, one f32 scale
// x_scale[col / q_tile] per scale tile of q_tile columns) and writes f32.
// The bf16 kernel takes the f32 tiles and a bf16 x and writes bf16 with the
// reference's rounding (_fold on a bf16 landing buffer): each coefficient is
// rounded to bf16 before its multiply, a chunk's sum is taken in f32 and
// rounded to bf16, and the block's first chunk sets the block while every
// later one is added in f32 and rounded back to bf16 -- a block is rounded
// once per chunk, not once at the store.  A product of two bf16 values is
// exact in f32, so a chunk's sum depends only on its order.
//
// What bounds them on the H100: bytes, and the latency of a block's chain
// of dependent loads.  A chunk gathers remaining[k] rows of x and folds
// each into 8 output rows: 2 * 8 flops per gathered f32 (4 bytes), under 4
// flops a byte, and 16 integer operations per gathered int8 byte, far below
// the ridge points of the CUDA cores and of the tensor cores (which would
// also need 64-row tiles: a block has 8).  So there are no tensor cores
// here; the design reads each gathered byte once, keeps many reads in
// flight and keeps a block's chain short:
//
// * a group of threads owns one output block (8 rows) and one stripe of
//   columns.  Each column thread holds one VEC-wide vector of the stripe
//   (VEC: f32 4, 2 or 1 floats, int8 4, 2 or 1 bytes, the widest that D
//   and the pointers allow: the wrapper's lane_layout) for all 8 rows, in
//   registers: 8 * VEC accumulators and 8 * VEC per-chunk partials.  A
//   gathered x vector is loaded once per block, straight into registers,
//   and used for all 8 rows; neighbouring threads load neighbouring vectors
//   of one x row.  A stripe has up to 256 column threads, so D = 1433
//   (4-byte rows) takes 6 stripes and D = 602 (8-byte rows) 2; bf16 loads
//   VEC = 4 columns as 8 bytes and widens them to f32 in registers;
// * rows of at most 16 vectors (D = 16, 7, 64) give each of 8 row threads
//   one row instead, so a narrow block spreads over a warp or more; the 8
//   row threads of a column sit in one warp and load their vector in one
//   transaction;
// * a group walks its block's chunks in slices of 64 lanes.  A slice's
//   live u_cols and live tile columns land in shared memory in one step, by
//   16-byte cp.async with zero fill: a dead lane (u >= remaining[k]) is
//   never read, so it needs no zeroing and cannot inject a NaN.  In bf16
//   each thread rounds the coefficients it staged to bf16 there, once a
//   slice (a conversion issues at a fraction of the FMA rate: rounding at
//   each use made the kernel twice as slow as f32).  Slices
//   are double-buffered: a hub's next chunk's metadata is in flight while
//   the current slice folds, and remaining[] is loaded one chunk ahead.  A
//   block's chain is block_ptr -> remaining -> chunk metadata -> x -> store,
//   and one step shorter where block b's first chunk is chunk b (every
//   serving plan): remaining[b] is loaded beside block_ptr[b] on that guess;
// * the fold issues the x loads of 4 to 16 lanes a stage, two stages deep,
//   before their first FMA, so a slice's gathers are in flight together; a
//   staged coefficient is read with one LDS.128 for 4 lanes of a row (int8:
//   16 lanes);
// * several groups share a thread block where the plan is small, so one
//   thread block per SM covers the serving plans (one short wave);
// * sums in a fixed order: per output element, the live lanes of a chunk
//   fold in ascending u into a per-chunk partial (f32: fmaf; int8: exact
//   int32 dot products, __dp4a over four lanes of one column after a
//   __byte_perm transpose, |sum| <= 127^2 * width < 2^24), and the partials
//   fold into the accumulator chunk after chunk: f32 acc += part, int8 acc =
//   __fmaf_rn(isum, __fmul_rn(a_scale[k], x_scale[col / q_tile]), acc), the
//   reference's XLA-contracted fold, which the plain version emulates; bf16
//   acc = bf16(acc + bf16(part)), the first chunk acc = bf16(part).  The
//   bits depend on neither the stripe width nor the groups per thread block,
//   and are the same from run to run;
// * each block's tile is written once, after its last chunk: no atomics.
//
// At wide D the time follows the gathers (PERF.md): the dedup layout reads
// an x row once for every chunk that names it (~4.6 times at Cora's D =
// 1433, from L2; ~2 times at minibatch_lg's D = 602, from HBM), where the
// bound counts it once.
//
// The tiles must have 8 rows, a width that is a multiple of 16 and 16-byte
// aligned rows (pack_dedup_chunks' default layout); the wrapper checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROWS = 8;           // output rows per block
constexpr int SLICE = 64;         // chunk lanes staged per step
constexpr int MAX_THREADS = 256;  // per thread block
constexpr int MAX_GROUPS = 8;     // output blocks (groups) per thread block

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  // copies `bytes` (0..16) and zero-fills the rest of the 16
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Args {
  const int32_t* u_cols;
  const int32_t* remaining;
  const int32_t* block_ptr;
  const void* a;           // float or int8_t tiles
  const float* a_scale;    // int8 only
  const void* x;           // float, __nv_bfloat16 or int8_t
  const float* x_scale;    // int8 only
  void* y;                 // float, or __nv_bfloat16 for a bf16 x
  int n_blocks, n_chunks, width, d, lanes, q_tile;
};

// One step of a group's walk: lanes off .. off+cnt-1 of chunk k; end_chunk
// / end_block say whether the chunk / the block ends with it.  A block
// without chunks is one empty step that stores zeros.
struct Slice {
  int k, off, cnt;
  float scale;
  bool valid, end_chunk, end_block;
};

// A group's walk over one output block's chunks, in slices of SLICE lanes,
// with remaining[] (and a_scale[]) loaded one chunk ahead.
struct Walk {
  const int32_t* remaining;
  const float* a_scale;
  int n_chunks, width;
  int k, kend, n, n_next, off;
  float sc, sc_next;
  bool done;

  __device__ void chunk(int kk, int& lanes, float& scale) const {
    lanes = 0;
    scale = 0.f;
    if (kk >= 0 && kk < n_chunks) {
      lanes = min(max(remaining[kk], 0), width);
      if (a_scale != nullptr) scale = a_scale[kk];
    }
  }

  __device__ void start(const Args& p, int b) {
    remaining = p.remaining;
    a_scale = p.a_scale;
    n_chunks = p.n_chunks;
    width = p.width;
    off = 0;
    k = kend = n = n_next = 0;
    sc = sc_next = 0.f;
    done = b >= p.n_blocks;
    if (done) return;
    // guess that block b's first chunk is chunk b (every block before it
    // has one chunk, as in every serving plan) and load its remaining[]
    // beside block_ptr[]: one dependent load fewer where the guess holds
    int g_n, g_n_next;
    float g_sc, g_sc_next;
    chunk(b, g_n, g_sc);
    chunk(b + 1, g_n_next, g_sc_next);
    k = p.block_ptr[b];
    kend = min(p.block_ptr[b + 1], n_chunks);
    if (k == b) {
      n = g_n;
      sc = g_sc;
      n_next = g_n_next;
      sc_next = g_sc_next;
    } else {
      chunk(k, n, sc);
      chunk(k + 1, n_next, sc_next);
    }
  }

  __device__ Slice slice() const {
    Slice s;
    s.valid = !done;
    const bool empty = k >= kend;
    s.k = k;
    s.off = off;
    s.scale = sc;
    s.cnt = empty ? 0 : min(SLICE, n - off);
    s.end_chunk = !empty && off + SLICE >= n;
    s.end_block = empty || (s.end_chunk && k + 1 >= kend);
    return s;
  }

  __device__ void advance(const Slice& s) {
    if (!s.valid) return;
    if (s.end_block) {
      done = true;
    } else if (s.end_chunk) {
      k += 1;
      off = 0;
      n = n_next;
      sc = sc_next;
      chunk(k + 1, n_next, sc_next);
    } else {
      off += SLICE;
    }
  }
};

template <int VEC>
__device__ __forceinline__ void load_vec(float (&v)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// VEC bf16 columns at p, widened to f32 (a bf16 is the high half of its f32)
template <int VEC>
__device__ __forceinline__ void load_vec(float (&v)[VEC],
                                         const __nv_bfloat16* p) {
  if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else if constexpr (VEC == 2) {
    const unsigned t = __ldg(reinterpret_cast<const unsigned*>(p));
    v[0] = __uint_as_float(t << 16);
    v[1] = __uint_as_float(t & 0xffff0000u);
  } else {
    const unsigned short t =
        __ldg(reinterpret_cast<const unsigned short*>(p));
    v[0] = __uint_as_float((unsigned)t << 16);
  }
}

// f32 -> the nearest bf16 (ties to even), back as f32.  A conversion issues
// at a fraction of the FMA rate, so the kernel rounds each staged
// coefficient once (round_tiles) and each chunk's sum once, never per use
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// VEC int8 columns at p, as the low VEC bytes of a word
template <int VEC>
__device__ __forceinline__ unsigned load_vec(const int8_t* p) {
  if constexpr (VEC == 4) {
    return __ldg(reinterpret_cast<const unsigned*>(p));
  } else if constexpr (VEC == 2) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    return __ldg(reinterpret_cast<const unsigned char*>(p));
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// VEC values already on the bf16 grid, stored as bf16 (exact)
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[VEC]) {
  unsigned short h[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    h[e] = __bfloat16_as_ushort(__float2bfloat16_rn(v[e]));
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(h[0] | ((unsigned)h[1] << 16), h[2] | ((unsigned)h[3] << 16));
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<unsigned*>(p) = h[0] | ((unsigned)h[1] << 16);
  } else {
    *reinterpret_cast<unsigned short*>(p) = h[0];
  }
}

// Four lanes' words (byte s = column s) -> four column words (byte t =
// lane t), the layout of a staged tile word (byte t = lane t of one row).
__device__ __forceinline__ void transpose4(const unsigned (&w)[4],
                                           int (&c)[4]) {
  const unsigned t0 = __byte_perm(w[0], w[1], 0x5140);
  const unsigned t1 = __byte_perm(w[2], w[3], 0x5140);
  const unsigned t2 = __byte_perm(w[0], w[1], 0x7362);
  const unsigned t3 = __byte_perm(w[2], w[3], 0x7362);
  c[0] = (int)__byte_perm(t0, t1, 0x5410);
  c[1] = (int)__byte_perm(t0, t1, 0x7632);
  c[2] = (int)__byte_perm(t2, t3, 0x5410);
  c[3] = (int)__byte_perm(t2, t3, 0x7632);
}

// T = float: f32 tiles and x; T = __nv_bfloat16: f32 tiles, bf16 x and y;
// T = int8_t: int8 tiles and x with scales.
// VEC: elements per load, one vector a thread per row.  RPT: output rows a
// thread holds, 8, or 1 for rows of at most 16 vectors (then ROWS row
// threads a column).
// At most 128 registers a thread (two 256-thread blocks an SM) unless a
// thread holds 8 rows of 4: more blocks in flight hide more of the chain.
template <typename T, int VEC, int RPT>
__global__ void __launch_bounds__(MAX_THREADS, RPT == ROWS && VEC == 4 ? 1
                                                                       : 2)
    spmm_dedup_chunks_kernel(const Args p) {
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  using TA = typename std::conditional<Q8, int8_t, float>::type;  // tiles
  using TY = typename std::conditional<BF16, __nv_bfloat16, float>::type;
  constexpr int A_ROW = SLICE * (int)sizeof(TA); // staged bytes per tile row
  constexpr int BUF = SLICE * 4 + ROWS * A_ROW;
  constexpr int COL_SEGS = SLICE * 4 / 16;      // 16-byte copies of u_cols
  constexpr int A_SEGS = A_ROW / 16;            // ... of one tile row
  constexpr int SEG_LANES = 16 / (int)sizeof(TA);
  // quads of lanes a stage, two stages in flight: 32 lanes where a thread
  // holds int8 words or one row of 1 or 2 floats, 24 where it holds one
  // row of 4, else 16 floats of x a stage
  constexpr int QUADS = Q8 || (RPT == 1 && VEC < 4) ? 4 : RPT == 1 ? 3
                                                                  : 4 / VEC;
  using Sum = typename std::conditional<Q8, int, float>::type;
  using XQuad = typename std::conditional<Q8, unsigned[4],
                                          float[4][VEC]>::type;
  extern __shared__ __align__(16) unsigned char smem[];

  const int lanes = p.lanes;
  const int group = RPT == 1 ? lanes * ROWS : lanes;
  const int g = threadIdx.x / group;
  const int tg = threadIdx.x - g * group;
  // row threads of a column are neighbours: one warp loads their vector once
  const int l = RPT == 1 ? tg / ROWS : tg;
  const int row0 = RPT == 1 ? tg % ROWS : 0;
  const int b = blockIdx.x * (blockDim.x / group) + g;
  Walk walk;
  walk.start(p, b);
  unsigned char* const buffers = smem + (size_t)g * 2 * BUF;

  const TA* __restrict__ a = static_cast<const TA*>(p.a);
  const int d = p.d;
  const int width = p.width;
  const int v = blockIdx.y * lanes + l;  // this thread's vector of a row
  const bool ok = v < d / VEC;
  // x's rows as bytes: a lane's vector is at xt + u_cols * row_bytes
  const char* const xt =
      static_cast<const char*>(p.x) + (int64_t)v * VEC * sizeof(T);
  const int row_bytes = d * (int)sizeof(T);
  float xs[VEC];  // int8: each column's feature scale
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    xs[e] = 0.f;
    if constexpr (Q8) {
      if (ok) xs[e] = p.x_scale[(v * VEC + e) / p.q_tile];
    }
  }

  Sum part[RPT][VEC];
  float acc[RPT][VEC];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      part[r][e] = 0;
      acc[r][e] = 0.f;
    }

  // one slice's live u_cols and tile columns -> buf; dead lanes unread
  auto fetch = [&](const Slice& sl, unsigned char* buf) {
    const int32_t* cols = p.u_cols + (int64_t)sl.k * width + sl.off;
    const TA* tile = a + (int64_t)sl.k * ROWS * width + sl.off;
    for (int i = tg; i < COL_SEGS + ROWS * A_SEGS; i += group) {
      if (i < COL_SEGS) {
        const int bytes = min(max(sl.cnt - i * 4, 0), 4) * 4;
        if (bytes > 0) cp_async16(buf + i * 16, cols + i * 4, bytes);
      } else {
        const int r = (i - COL_SEGS) / A_SEGS;
        const int seg = (i - COL_SEGS) % A_SEGS;
        const int live = min(max(sl.cnt - seg * SEG_LANES, 0), SEG_LANES);
        if (live > 0)
          cp_async16(buf + SLICE * 4 + r * A_ROW + seg * 16,
                     tile + (int64_t)r * width + seg * SEG_LANES,
                     live * (int)sizeof(TA));
      }
    }
  };

  // bf16: once a slice has landed, each thread rounds the tile segments it
  // copied (its own cp.async copies are visible to it after the wait) to
  // bf16 in place -- a.astype(bf16) once per staged coefficient, not once
  // per use; the barrier that follows publishes them to the group
  auto round_tiles = [&](const Slice& sl, unsigned char* buf) {
    if constexpr (BF16) {
      for (int i = tg; i < COL_SEGS + ROWS * A_SEGS; i += group) {
        if (i < COL_SEGS) continue;
        const int r = (i - COL_SEGS) / A_SEGS;
        const int seg = (i - COL_SEGS) % A_SEGS;
        if (sl.cnt - seg * SEG_LANES <= 0) continue;
        float4* q = reinterpret_cast<float4*>(buf + SLICE * 4 + r * A_ROW +
                                              seg * 16);
        float4 v = *q;
        v.x = round_bf16(v.x);
        v.y = round_bf16(v.y);
        v.z = round_bf16(v.z);
        v.w = round_bf16(v.w);
        *q = v;
      }
    }
  };

  // x of quad q's live lanes, this thread's vector; 0 for dead lanes,
  // which are not read
  auto load_quad = [&](XQuad& xq, const int* cols, int cnt, int q) {
    const int4 c = *reinterpret_cast<const int4*>(cols + 4 * q);
    const int cq[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const bool live = ok && 4 * q + t < cnt;
      const T* row = reinterpret_cast<const T*>(
          xt + (size_t)(unsigned)cq[t] * (unsigned)row_bytes);
      if constexpr (Q8) {
        xq[t] = live ? load_vec<VEC>(row) : 0u;
      } else if (live) {
        load_vec<VEC>(xq[t], row);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) xq[t][e] = 0.f;
      }
    }
  };

  // Fold QUADS quads from quad q, lanes in ascending u, into the partials.
  // A dead lane of the slice's last quad has x = 0 and a zero-filled
  // coefficient: its fmaf adds +0, which can only turn a partial of -0 into
  // +0, and partials are added to accumulators that start at +0, so the
  // sums are those of the live lanes alone (int8: exactly).  Quads past the
  // slice are skipped (f32) or add zeros (int8).
  auto fold = [&](const XQuad (&xq)[QUADS], const unsigned char* buf,
                  int quads, int q) {
    if (q >= quads) return;
    const unsigned char* tile = buf + SLICE * 4 + row0 * A_ROW;
    if constexpr (Q8) {
      static_assert(!Q8 || QUADS == 4, "one LDS.128 a row holds 4 quads");
      int4 w[RPT];  // every row's words first: the dp4a chains interleave
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        w[r] = *reinterpret_cast<const int4*>(tile + r * A_ROW + 4 * q);
#pragma unroll
      for (int i = 0; i < QUADS; ++i) {
        int c[4];
        transpose4(xq[i], c);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const int wi = i == 0 ? w[r].x : i == 1 ? w[r].y : i == 2 ? w[r].z
                                                                    : w[r].w;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            part[r][e] = __dp4a(wi, c[e], part[r][e]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < QUADS; ++i) {
        if (q + i >= quads) break;
        float4 ar[RPT];  // every row's coefficients first, then lane by
                         // lane: RPT * VEC independent fmaf chains
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          ar[r] = *reinterpret_cast<const float4*>(tile + r * A_ROW +
                                                   16 * (q + i));
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const float ak = t == 0   ? ar[r].x
                             : t == 1 ? ar[r].y
                             : t == 2 ? ar[r].z
                                      : ar[r].w;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              part[r][e] = fmaf(ak, xq[i][t][e], part[r][e]);
          }
      }
    }
  };

  bool first_chunk = true;  // bf16: the block's first chunk sets it
  Slice cur = walk.slice();
  if (cur.valid) fetch(cur, buffers);
  walk.advance(cur);
  int stage = 0;
  cp_async_wait_all();
  if (cur.valid) round_tiles(cur, buffers);
  // one barrier a step: this slice has landed for every thread, and every
  // thread is done with the buffer the next slice lands in
  while (__syncthreads_or(cur.valid)) {
    const Slice next = walk.slice();
    if (next.valid) fetch(next, buffers + (stage ^ 1) * BUF);
    walk.advance(next);
    if (cur.valid) {
      const unsigned char* buf = buffers + stage * BUF;
      const int* cols = reinterpret_cast<const int*>(buf);
      const int quads = (cur.cnt + 3) / 4;
      XQuad xa[QUADS], xb[QUADS];
#pragma unroll
      for (int i = 0; i < QUADS; ++i) load_quad(xa[i], cols, cur.cnt, i);
      for (int q0 = 0; q0 < quads; q0 += 2 * QUADS) {
#pragma unroll
        for (int i = 0; i < QUADS; ++i)
          load_quad(xb[i], cols, cur.cnt, q0 + QUADS + i);
        fold(xa, buf, quads, q0);
#pragma unroll
        for (int i = 0; i < QUADS; ++i)
          load_quad(xa[i], cols, cur.cnt, q0 + 2 * QUADS + i);
        fold(xb, buf, quads, q0 + QUADS);
      }
      if (cur.end_chunk) {
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            if constexpr (Q8) {
              acc[r][e] = __fmaf_rn((float)part[r][e],
                                    __fmul_rn(cur.scale, xs[e]), acc[r][e]);
            } else if constexpr (BF16) {
              const float pr = round_bf16(part[r][e]);
              acc[r][e] =
                  first_chunk ? pr : round_bf16(__fadd_rn(acc[r][e], pr));
            } else {
              acc[r][e] += part[r][e];
            }
            part[r][e] = 0;
          }
        first_chunk = false;
      }
      if (cur.end_block && ok) {
        TY* out = static_cast<TY*>(p.y) + ((int64_t)b * ROWS + row0) * d +
                  (int64_t)v * VEC;
#pragma unroll
        for (int r = 0; r < RPT; ++r) store_vec<VEC>(out + (int64_t)r * d,
                                                     acc[r]);
      }
    }
    cur = next;
    stage ^= 1;
    cp_async_wait_all();
    if (cur.valid) round_tiles(cur, buffers + stage * BUF);
  }
}

template <typename T, int VEC, int RPT>
int launch(const Args& p, int groups, cudaStream_t stream) {
  const int threads = groups * (RPT == 1 ? p.lanes * ROWS : p.lanes);
  const size_t smem =
      (size_t)groups * 2 *
      (SLICE * 4 + ROWS * SLICE * (std::is_same<T, int8_t>::value ? 1 : 4));
  const int stripes = (p.d / VEC + p.lanes - 1) / p.lanes;
  const int64_t blocks = (p.n_blocks + groups - 1) / groups;
  spmm_dedup_chunks_kernel<T, VEC, RPT>
      <<<dim3((unsigned)blocks, (unsigned)stripes), threads, smem, stream>>>(
          p);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_rows(const Args& p, int rows, int groups, cudaStream_t stream) {
  if (rows == ROWS) return launch<T, VEC, ROWS>(p, groups, stream);
  if (rows == 1) return launch<T, VEC, 1>(p, groups, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const Args& p, int vec, int rows, int groups, void* stream) {
  const int64_t group = (int64_t)p.lanes * (rows == 1 ? ROWS : 1);
  if (p.lanes < 1 || groups < 1 || groups > MAX_GROUPS ||
      groups * group > MAX_THREADS || p.width % 16 != 0 || vec < 1 ||
      p.d % vec != 0 || p.n_blocks < 0 || p.d >= (1 << 29) ||
      (int64_t)p.n_blocks / groups >= ((int64_t)1 << 31) - 1)
    return (int)cudaErrorInvalidValue;
  if (p.n_blocks == 0 || p.d == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (vec) {
    case 4:
      return launch_rows<T, 4>(p, rows, groups, s);
    case 2:
      return launch_rows<T, 2>(p, rows, groups, s);
    case 1:
      return launch_rows<T, 1>(p, rows, groups, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// u_cols (n_chunks, width) int32, remaining (n_chunks,) int32, block_ptr
// (n_blocks + 1,) int32, a (n_chunks * 8, width) f32, x (N, d) f32, y
// (n_blocks * 8, d) f32.  vec in {1, 2, 4} divides d and the float
// alignment of x and y; lanes: column threads per stripe, each holding one
// vec-wide vector; rows: rows a thread holds, 8, or 1 (then 8 row threads a
// column); groups: output blocks per thread block (at most 16, and 256
// threads).
extern "C" int spmm_dedup_chunks_launch(
    const void* u_cols, const void* remaining, const void* block_ptr,
    const void* a, const void* x, void* y, int n_blocks, int n_chunks,
    int width, int d, int vec, int lanes, int rows, int groups,
    void* stream) {
  const Args p{(const int32_t*)u_cols, (const int32_t*)remaining,
               (const int32_t*)block_ptr, a, nullptr, x, nullptr, y,
               n_blocks, n_chunks, width, d, lanes, 1};
  return dispatch<float>(p, vec, rows, groups, stream);
}

// As above with x (N, d) and y (n_blocks * 8, d) bf16; the tiles stay f32.
// vec divides d and the bf16 alignment of x and y (4: 8 bytes).
extern "C" int spmm_dedup_chunks_bf16_launch(
    const void* u_cols, const void* remaining, const void* block_ptr,
    const void* a, const void* x, void* y, int n_blocks, int n_chunks,
    int width, int d, int vec, int lanes, int rows, int groups,
    void* stream) {
  const Args p{(const int32_t*)u_cols, (const int32_t*)remaining,
               (const int32_t*)block_ptr, a, nullptr, x, nullptr, y,
               n_blocks, n_chunks, width, d, lanes, 1};
  return dispatch<__nv_bfloat16>(p, vec, rows, groups, stream);
}

// As above with int8 tiles a_q8 and scales a_scale (n_chunks,) f32, int8
// x_q8 (N, d) and x_scale (ceil(d / q_tile),) f32; vec bytes per load.
extern "C" int spmm_dedup_chunks_q8_launch(
    const void* u_cols, const void* remaining, const void* block_ptr,
    const void* a_q8, const void* a_scale, const void* x_q8,
    const void* x_scale, void* y, int n_blocks, int n_chunks, int width,
    int d, int q_tile, int vec, int lanes, int rows, int groups,
    void* stream) {
  if (q_tile <= 0) return (int)cudaErrorInvalidValue;
  const Args p{(const int32_t*)u_cols, (const int32_t*)remaining,
               (const int32_t*)block_ptr, a_q8, (const float*)a_scale, x_q8,
               (const float*)x_scale, y, n_blocks, n_chunks, width,
               d, lanes, q_tile};
  return dispatch<int8_t>(p, vec, rows, groups, stream);
}
