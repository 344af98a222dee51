// Causal flash attention (forward) for Hopper.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/flash_attention.py:flash_attention (body
// _kernel).
//
// Computes, for q, k, v (BH, S, d) with the kv heads already repeated,
//   o[b, i] = sum over j <= i of softmax_j(q[b, i] . k[b, j] / sqrt(d))
//             * v[b, j]
// with the reference's online softmax: per query row a running max m
// (from -1e30), sum l and accumulator acc, masked scores set to -1e30, and
// o = acc / max(l, 1e-30) in the input's type.  Scores are scaled by
// 1/sqrt(d) in f32 after the product and the exponentials are taken in
// base 2 (ex2 of s * scale * log2 e - m, one FFMA); every sum is f32.
//
// What bounds it on the H100: operations.  A (BH, S, d) causal pass does
// 2 * BH * d * S * (S + 1) flops on 4 * BH * S * d elements (S = 4096,
// d = 128: ~1000 flops per element), so every instantiation runs on the
// tensor cores and keeps every intermediate on chip.
//
// Head dims: up to 256 each dtype is compiled at a few widths DP, and the
// head dim is always one of them, known at compile time.  The wrapper pads
// any other d <= 256 with zero columns on the card to the next width (zero
// columns add nothing to q.k; the scale stays 1/sqrt(d) of the true d)
// and cuts the output back.  Past 256 the wrapper pads d to a multiple of
// 64 and one "wide" kernel a dtype family takes it with d read at run
// time; its shared memory does not grow with d (below).
//
// bf16 and f16 (flash_wgmma_kernel<T, DP>, DP = 64, 128 or 256; one
// template, T = __nv_bfloat16 or __half picks the wgmma type, the tensor
// map's type and P's and o's rounding): one block of three warpgroups per
// (bh, 128-row q tile), heaviest tiles first.  Warpgroup 2 is the
// producer: it gives up registers (setmaxnreg, which takes whole
// warpgroups) and one of its threads loads the q tile once and each K and
// V tile into a two-stage ring by TMA (128-byte swizzle, zero fill past
// S), with full and empty mbarriers for K and V apart.  A kv
// tile holds 128 keys up to DP = 128 and 64 at DP = 256, where the q tile
// (64 KB) and two stages of K and V (128 KB) fill 193 KB of the 227 KB a
// block may use.  Warpgroups 0 and 1 are the consumers, 64 q rows each:
// S = q.k^T is wgmma m64n{128,64}k16 with both operands in shared memory
// (K-major); the online softmax runs on the accumulator fragments (row max
// and sum across the 4 threads of a quad); P is rounded to T in registers
// and fed back as wgmma's A operand for O += P.V
// (m64n{64,128}k16, V an MN-major B operand; DP = 256 takes two n128
// products, its O accumulator 128 registers a thread): the reference
// keeps P in f32 there, so this product is less precise than the
// reference's (the row sums l add the f32 P; f16 keeps 3 more bits of P
// than bf16).  Each consumer issues q.K_t
// and P_{t-1}.V_{t-1} together and runs tile t's softmax while the second
// is in flight, and the two consumers take turns to issue (named barriers
// 1 and 2), so one's softmax overlaps the other's products.  Tiles above
// the block's last q row are never loaded; a tile is masked where its last
// key lies past a warp's first row (with 128-key tiles only the diagonal
// tile, with 64-key tiles the two that meet the 128-row q tile's
// diagonal, the second wholly masked for warpgroup 0's rows).
//
// bf16 and f16 past 256 (flash_wide_wgmma_kernel<T>): the grid gains a
// third factor, the chunks of 256 of v's columns (the last one may hold
// fewer: the TMA zero-fills the boxes past d and they are not stored).
// A block is (bh, 128-row q tile, chunk), laid out as DP = 256's block
// (three warpgroups, 64-key kv tiles, the 128-register O accumulator).
// For each kv tile it streams q and K through a four-stage ring in
// 64-column slices (a 16 KB q slice and an 8 KB K slice a stage, the
// TMA's 64-column boxes), accumulating S with four wgmma a slice, one
// slice's group in flight while the next lands; then it runs the softmax
// and P.V for its 256 columns from a two-stage V ring (32 KB a stage).
// Shared memory is 161 KB whatever d is.  Each chunk recomputes S and the
// softmax statistics in the same order, so every chunk's rows agree; the
// recomputed q.K is the kernel's own cost (ceil(d / 256) times its flops).
//
// f32 (flash_f32_kernel<DP>, DP = 16, 32, 64, 128 or 256): 3xTF32 on
// mma.sync.m16n8k8: each operand is split as hi = rna_tf32(x),
// lo = rna_tf32(x - hi) and every product is a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi, which keeps ~1e-6 where one TF32 pass would give ~1e-3
// (whatever torch's TF32 flags say).  The tensor cores' sums shrink
// toward zero, so the cross terms are summed apart from hi.hi, and P.V
// from zero for each 16 keys (mma_3xtf32).  One block of BM / 16 warps per
// (bh, BM-row q tile), 16 rows per warp; the q tile and a two-stage ring
// of BN-key K and V tiles are staged by cp.async as f32 (BM = 128 and
// BN = 64 up to DP = 128; 64 and 32 at DP = 256, 197 KB).  P stays f32 in
// registers: the S accumulator's columns (2c, 2c + 1) become the A
// fragment's (c, c + 4), and V's rows are read in the same permuted order.
//
// f32 past 256 (flash_wide_f32_kernel): a block is (bh, 64-row q tile,
// chunk of 128 of v's columns), 4 warps.  For each 64-key kv tile a
// two-stage cp.async ring brings q and K in 64-column slices, then the
// tile's V columns; S is summed a slice at a time (each slice's 3xTF32
// terms from zero, added to S with FADDs, so no tensor-core sum runs
// longer than 8 mma whatever d is), then the softmax and P.V as above.
// Shared memory is 72 KB whatever d is.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the
                   // runtime's driver entry point, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// the launcher's dtype codes (flash_attention.py DTYPE_CODES)
constexpr int FA_F32 = 0;
constexpr int FA_BF16 = 1;
constexpr int FA_F16 = 2;

// ---------------------------------------------------------------------------
// shared by every instantiation: the m16n8 accumulator layout
// ---------------------------------------------------------------------------
//
// A thread of quad g = lane / 4, position c = lane % 4 holds, for each
// 8-column block j, elements 4j + 2h + e at row g + 8h, column 8j + 2c + e.

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online-softmax update.  s holds the tile's raw scores and
// leaves holding the probabilities; corr is the factor by which the P.V
// accumulator is to be rescaled (rescale below).  key0 is the key of
// element 0 (tile start + 2c), row0 the query row of h = 0; diag asks for
// the causal mask.  m is kept in base 2 (scaled); l stays this thread's
// share of the row sum (the quad's four shares are added at the end).
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale_log2, bool diag,
                                             int key0, int row0) {
  if (diag) {
#pragma unroll
    for (int j = 0; j < NS / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (key0 + 8 * j + e > row0 + 8 * h) s[4 * j + 2 * h + e] = MASKED;
  }
  float mx[2] = {MASKED, MASKED};
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      mx[h] = fmaxf(mx[h], fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
  float neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * scale_log2);  // scale > 0
    corr[h] = ex2(m[h] - m_new);
    m[h] = m_new;
    neg_m[h] = -m_new;
  }
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p =
            ex2(fmaf(s[4 * j + 2 * h + e], scale_log2, neg_m[h]));
        s[4 * j + 2 * h + e] = p;
        sum[h] += p;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
}

template <int NO>
__device__ __forceinline__ void rescale(float (&acc)[NO],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < NO / 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      acc[4 * j + 2 * h] *= corr[h];
      acc[4 * j + 2 * h + 1] *= corr[h];
    }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// o_rows: this head's row 0 at the block's first column, ld the row pitch;
// writes the thread's two rows as acc / max(l, 1e-30), the columns below
// ncols of the NC the accumulator holds.
template <int NC, typename T, int NO>
__device__ __forceinline__ void store_rows(T* __restrict__ o_rows, int ld,
                                           int ncols, const float (&acc)[NO],
                                           float (&l)[2], int row0, int c,
                                           int seq_len) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = row0 + 8 * h;
    if (row >= seq_len) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    T* orow = o_rows + (int64_t)row * ld + 2 * c;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j)
      if (8 * j < ncols)
        store2(orow + 8 * j, acc[4 * j + 2 * h] / denom,
               acc[4 * j + 2 * h + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16: wgmma with a TMA-fed K/V ring
// ---------------------------------------------------------------------------

constexpr int B_BM = 128;          // q rows per block (2 consumer warpgroups)
constexpr int B_STAGES = 2;        // K/V ring depth
constexpr int B_THREADS = 384;     // warpgroups 0-1 consume, 2 produce
constexpr int B_CONSUMER_WARPS = 8;

template <typename T>
constexpr bool IS_F16 = std::is_same<T, __half>::value;

// DP: the head dim.  A TMA box is 64 columns (128 bytes, the swizzle
// span) by the tile's rows.
template <int DP>
struct Tiles16 {
  static_assert(DP == 64 || DP == 128 || DP == 256, "16-bit widths");
  static constexpr int BN = DP > 128 ? 64 : 128;  // keys per kv tile
  static constexpr int BOXES = DP / 64;
  static constexpr int Q_BOX = B_BM * 128;
  static constexpr int KV_BOX = BN * 128;
  static constexpr int Q_BYTES = BOXES * Q_BOX;
  static constexpr int KV_BYTES = BOXES * KV_BOX;     // a K or a V tile
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle, the
  // q tile, 2 x STAGES kv tiles, then the mbarriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * B_STAGES * KV_BYTES +
                              8 * (1 + 4 * B_STAGES);
};

// Past 256: 64-key kv tiles, q and K streamed in 64-column slices (a q
// slice and a K slice a stage), V in chunks of DV = 256 columns (BOXES
// boxes a stage).
struct WideTiles16 {
  static constexpr int BN = 64;
  static constexpr int DV = 256;
  static constexpr int BOXES = DV / 64;
  static constexpr int QK_STAGES = 4;
  static constexpr int V_STAGES = 2;
  static constexpr int Q_BOX = B_BM * 128;
  static constexpr int KV_BOX = BN * 128;
  static constexpr int QK_BYTES = Q_BOX + KV_BOX;     // a q and a K slice
  static constexpr int V_BYTES = BOXES * KV_BOX;      // a V tile's chunk
  static constexpr int SMEM = 1024 + QK_STAGES * QK_BYTES +
                              V_STAGES * V_BYTES +
                              8 * 2 * (QK_STAGES + V_STAGES);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of the (D, S, BH) tensor map at (column c0, row c1, head c2).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of the accumulators above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FA_ACC8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// Each wgmma below is written once for its operand type AB ("bf16" or
// "f16") and instantiated by T.
#define FA_WGMMA_SS_N128(AB)                                              \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %66, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " "        \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                          \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                          \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                          \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                          \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                         \
      "%64, %65, p, 1, 1, 0, 0;\n"                                        \
      "}\n"                                                               \
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24), FA_ACC8(32),    \
        FA_ACC8(40), FA_ACC8(48), FA_ACC8(56)                             \
      : "l"(da), "l"(db), "r"(accumulate))

#define FA_WGMMA_SS_N64(AB)                                               \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %34, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                         \
      "%32, %33, p, 1, 1, 0, 0;\n"                                        \
      "}\n"                                                               \
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24)                  \
      : "l"(da), "l"(db), "r"(accumulate))

#define FA_WGMMA_RS_N128(AB)                                              \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %69, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " "        \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                          \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                          \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                          \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                          \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                         \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"                          \
      "}\n"                                                               \
      : FA_ACC8(OFF + 0), FA_ACC8(OFF + 8), FA_ACC8(OFF + 16),            \
        FA_ACC8(OFF + 24), FA_ACC8(OFF + 32), FA_ACC8(OFF + 40),          \
        FA_ACC8(OFF + 48), FA_ACC8(OFF + 56)                              \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

#define FA_WGMMA_RS_N64(AB)                                               \
  asm volatile(                                                           \
      "{\n"                                                               \
      ".reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %37, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " "         \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                            \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                          \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                         \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"                          \
      "}\n"                                                               \
      : FA_ACC8(0), FA_ACC8(8), FA_ACC8(16), FA_ACC8(24)                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// d (64 x 128, f32) (+)= A (64 x 16, shared, K-major) . B (16 x 128,
// shared, K-major); accumulate = 0 overwrites d.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (IS_F16<T>)
    FA_WGMMA_SS_N128("f16");
  else
    FA_WGMMA_SS_N128("bf16");
}

// d (64 x 64, f32) (+)= A (64 x 16, shared, K-major) . B (16 x 64,
// shared, K-major).
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (IS_F16<T>)
    FA_WGMMA_SS_N64("f16");
  else
    FA_WGMMA_SS_N64("bf16");
}

// d[OFF .. OFF + 63] (64 x 128, f32) += A (64 x 16 of T, registers) .
// B (16 x 128, shared, MN-major).
template <typename T, int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  static_assert(OFF + 64 <= N, "accumulator slice");
  if constexpr (IS_F16<T>)
    FA_WGMMA_RS_N128("f16");
  else
    FA_WGMMA_RS_N128("bf16");
}

// d (64 x 64, f32) += A (64 x 16 of T, registers) . B (16 x 64, shared,
// MN-major).
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (IS_F16<T>)
    FA_WGMMA_RS_N64("f16");
  else
    FA_WGMMA_RS_N64("bf16");
}

// Two floats rounded to T, packed low then high.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (IS_F16<T>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// S = q . K^T for one kv tile (issued, not waited on): 16 columns of d
// per wgmma, 4 per 128-byte swizzle span (one TMA box).
template <typename T, typename L>
__device__ __forceinline__ void qk_tile(float (&s)[L::BN / 2], uint32_t sq_wg,
                                        uint32_t sk_st) {
#pragma unroll
  for (int kk = 0; kk < L::BOXES * 4; ++kk)
    wgmma_ss<T>(s,
                desc_sw128(sq_wg + (kk / 4) * L::Q_BOX + (kk % 4) * 32, 16,
                           1024),
                desc_sw128(sk_st + (kk / 4) * L::KV_BOX + (kk % 4) * 32, 16,
                           1024),
                kk > 0);
}

// acc += P . V for one kv tile (issued, not waited on): 16 keys per
// wgmma; V is MN-major (d contiguous), the next 64 columns of d one box
// on (LBO), the next 8 keys 1024 bytes on (SBO).  DP = 256 takes two n128
// products a 16 keys, the second from the third box on.
template <typename T, typename L>
__device__ __forceinline__ void pv_tile(float (&acc)[L::BOXES * 32],
                                        const uint32_t (&pa)[L::BN / 16][4],
                                        uint32_t sv_st) {
#pragma unroll
  for (int kt = 0; kt < L::BN / 16; ++kt) {
    const uint32_t at = sv_st + kt * 16 * 128;
    if constexpr (L::BOXES == 1) {
      wgmma_rs_n64<T>(acc, pa[kt], desc_sw128(at, L::KV_BOX, 1024));
    } else {
      wgmma_rs_n128<T, 0>(acc, pa[kt], desc_sw128(at, L::KV_BOX, 1024));
      if constexpr (L::BOXES == 4)
        wgmma_rs_n128<T, 64>(acc, pa[kt],
                             desc_sw128(at + 2 * L::KV_BOX, L::KV_BOX,
                                        1024));
    }
  }
}

// P (rounded to T) as wgmma's A operand: columns 16kt .. 16kt + 15 are
// blocks 2kt and 2kt + 1 of the S accumulator.
template <typename T, int NS>
__device__ __forceinline__ void to_operand(uint32_t (&pa)[NS / 8][4],
                                           const float (&s)[NS]) {
#pragma unroll
  for (int kt = 0; kt < NS / 8; ++kt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kt][i] = pack2<T>(s[8 * kt + 2 * i], s[8 * kt + 2 * i + 1]);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

template <typename T, int DP>
__global__ void __launch_bounds__(B_THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       T* __restrict__ o, int bh_count, int seq_len,
                       int n_q_tiles, float scale_log2) {
  using L = Tiles16<DP>;
  constexpr int BN = L::BN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + L::Q_BYTES;                 // + stage * KV_BYTES
  const uint32_t sv = sk + B_STAGES * L::KV_BYTES;     // + stage * KV_BYTES
  const uint32_t bar_q = sv + B_STAGES * L::KV_BYTES;
  const uint32_t k_full = bar_q + 8;                   // + 8 * stage
  const uint32_t v_full = k_full + 8 * B_STAGES;
  const uint32_t k_empty = v_full + 8 * B_STAGES;
  const uint32_t v_empty = k_empty + 8 * B_STAGES;

  const int qt = n_q_tiles - 1 - blockIdx.x / bh_count;  // heaviest first
  const int bh = blockIdx.x % bh_count;
  const int q0 = qt * B_BM;
  // kv tiles up to the block's last live q row
  const int n_kv = (min(q0 + B_BM, seq_len) - 1) / BN + 1;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < B_STAGES; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, B_CONSUMER_WARPS);
      mbar_init(v_empty + 8 * st, B_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load; the rest exit
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, L::Q_BYTES);
      for (int c = 0; c < L::BOXES; ++c)
        tma_load(sq + c * L::Q_BOX, &tm_q, 64 * c, q0, bh, bar_q);
      for (int t = 0; t < n_kv; ++t) {
        const int st = t % B_STAGES;
        const uint32_t ph = (t / B_STAGES) & 1;
        // a K slot frees when q.K is done, a V slot when P.V is: the next
        // K lands while the last P.V runs (first round passes at once)
        mbar_wait(k_empty + 8 * st, ph ^ 1);
        mbar_expect_tx(k_full + 8 * st, L::KV_BYTES);
        for (int c = 0; c < L::BOXES; ++c)
          tma_load(sk + st * L::KV_BYTES + c * L::KV_BOX, &tm_k, 64 * c,
                   t * BN, bh, k_full + 8 * st);
        mbar_wait(v_empty + 8 * st, ph ^ 1);
        mbar_expect_tx(v_full + 8 * st, L::KV_BYTES);
        for (int c = 0; c < L::BOXES; ++c)
          tma_load(sv + st * L::KV_BYTES + c * L::KV_BOX, &tm_v, 64 * c,
                   t * BN, bh, v_full + 8 * st);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int c = lane & 3;
    const int warp_row = q0 + wg * 64 + (tid >> 5) * 16;  // warp's first
    const int row0 = warp_row + (lane >> 2);
    const uint32_t sq_wg = sq + wg * 64 * 128;   // this warpgroup's rows

    float s[BN / 2], acc[DP / 2], corr[2];
    uint32_t pa[BN / 16][4];
    float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    // Software pipeline over kv tiles: q.K_t and P_{t-1}.V_{t-1} are
    // issued together, tile t's softmax runs while P_{t-1}.V_{t-1} does,
    // and acc is rescaled once that is done.  The two warpgroups take
    // turns to issue (each waits on barrier 1 + wg, then frees the
    // other's), so one's softmax overlaps the other's products; warpgroup
    // 0 goes first.  Tile t is masked where its last key lies past the
    // warp's first row; tile 0 holds key 0, so no row's first tile is
    // wholly masked.
    if (wg == 1) named_arrive(1);
    mbar_wait(bar_q, 0);
    mbar_wait(k_full, 0);
    named_sync(1 + wg);
    wgmma_fence();
    qk_tile<T, L>(s, sq_wg, sk);
    wgmma_commit();
    named_arrive(2 - wg);
    wgmma_wait<0>();
    fence_regs(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty);
    softmax_tile(s, m, l, corr, scale_log2, BN - 1 > warp_row, 2 * c, row0);
    to_operand<T>(pa, s);
    for (int t = 1; t < n_kv; ++t) {
      const int st = t % B_STAGES, prev = (t - 1) % B_STAGES;
      const uint32_t ph = (t / B_STAGES) & 1;
      const uint32_t ph_prev = ((t - 1) / B_STAGES) & 1;
      mbar_wait(k_full + 8 * st, ph);
      mbar_wait(v_full + 8 * prev, ph_prev);
      named_sync(1 + wg);
      wgmma_fence();
      qk_tile<T, L>(s, sq_wg, sk + st * L::KV_BYTES);
      wgmma_commit();
      pv_tile<T, L>(acc, pa, sv + prev * L::KV_BYTES);
      wgmma_commit();
      named_arrive(2 - wg);
      wgmma_wait<1>();                   // q.K_t done, P.V still running
      fence_regs(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty + 8 * st);
      softmax_tile(s, m, l, corr, scale_log2, t * BN + BN - 1 > warp_row,
                   t * BN + 2 * c, row0);
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty + 8 * prev);
      rescale(acc, corr);
      to_operand<T>(pa, s);
    }
    const int last = (n_kv - 1) % B_STAGES;
    mbar_wait(v_full + 8 * last, ((n_kv - 1) / B_STAGES) & 1);
    named_sync(1 + wg);
    wgmma_fence();
    pv_tile<T, L>(acc, pa, sv + last * L::KV_BYTES);
    wgmma_commit();
    if (wg == 0) named_arrive(2);     // the last turn: nobody waits after
    wgmma_wait<0>();
    fence_regs(acc);
    store_rows<DP>(o + (int64_t)bh * seq_len * DP, DP, DP, acc, l, row0, c,
                   seq_len);
  }
}

// Past 256 (head_dim a multiple of 64, read at run time): one block per
// (bh, 128-row q tile, chunk of DV columns of v), heaviest q tiles first.
// The producer streams, for each kv tile, its q and K slices and then its
// V chunk; the consumers sum S over the slices, keeping one slice's wgmma
// group in flight while they wait for the next, then run the softmax and
// P.V on their DV columns.  No turn-taking: each consumer waits for its
// own products.
template <typename T>
__global__ void __launch_bounds__(B_THREADS, 1)
    flash_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            T* __restrict__ o, int bh_count, int seq_len,
                            int head_dim, int n_q_tiles, int n_chunks,
                            float scale_log2) {
  using L = WideTiles16;
  constexpr int BN = L::BN, QS = L::QK_STAGES, VS = L::V_STAGES;
  extern __shared__ uint8_t smem_raw[];
  // stage st: its q slice at sqk + st * QK_BYTES, its K slice Q_BOX on
  const uint32_t sqk = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sv = sqk + QS * L::QK_BYTES;          // + stage * V_BYTES
  const uint32_t qk_full = sv + VS * L::V_BYTES;       // + 8 * stage
  const uint32_t qk_empty = qk_full + 8 * QS;
  const uint32_t v_full = qk_empty + 8 * QS;
  const uint32_t v_empty = v_full + 8 * VS;

  const int chunk = blockIdx.x % n_chunks;
  const int rest = blockIdx.x / n_chunks;
  const int qt = n_q_tiles - 1 - rest / bh_count;      // heaviest first
  const int bh = rest % bh_count;
  const int q0 = qt * B_BM;
  const int n_kv = (min(q0 + B_BM, seq_len) - 1) / BN + 1;
  const int n_slices = head_dim / 64;

  if (threadIdx.x == 0) {
    for (int st = 0; st < QS; ++st) {
      mbar_init(qk_full + 8 * st, 1);
      mbar_init(qk_empty + 8 * st, B_CONSUMER_WARPS);
    }
    for (int st = 0; st < VS; ++st) {
      mbar_init(v_full + 8 * st, 1);
      mbar_init(v_empty + 8 * st, B_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int i = 0;                                 // slices issued so far
      for (int t = 0; t < n_kv; ++t) {
        for (int sl = 0; sl < n_slices; ++sl, ++i) {
          const int st = i % QS;
          mbar_wait(qk_empty + 8 * st, ((i / QS) & 1) ^ 1);
          mbar_expect_tx(qk_full + 8 * st, L::QK_BYTES);
          const uint32_t dst = sqk + st * L::QK_BYTES;
          tma_load(dst, &tm_q, 64 * sl, q0, bh, qk_full + 8 * st);
          tma_load(dst + L::Q_BOX, &tm_k, 64 * sl, t * BN, bh,
                   qk_full + 8 * st);
        }
        const int vs = t % VS;
        mbar_wait(v_empty + 8 * vs, ((t / VS) & 1) ^ 1);
        mbar_expect_tx(v_full + 8 * vs, L::V_BYTES);
        // a box wholly past head_dim reads as zeros, counted in full
        for (int b = 0; b < L::BOXES; ++b)
          tma_load(sv + vs * L::V_BYTES + b * L::KV_BOX, &tm_v,
                   chunk * L::DV + 64 * b, t * BN, bh, v_full + 8 * vs);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x & 127;
    const int lane = tid & 31;
    const int c = lane & 3;
    const int warp_row = q0 + wg * 64 + (tid >> 5) * 16;
    const int row0 = warp_row + (lane >> 2);
    const uint32_t q_rows = wg * 64 * 128;   // this warpgroup's q rows

    float s[BN / 2], acc[L::DV / 2], corr[2];
    uint32_t pa[BN / 16][4];
    float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) s[j] = 0.f;
#pragma unroll
    for (int j = 0; j < L::DV / 2; ++j) acc[j] = 0.f;

    int i = 0;                                   // slices consumed so far
    for (int t = 0; t < n_kv; ++t) {
      for (int sl = 0; sl < n_slices; ++sl, ++i) {
        const int st = i % QS;
        mbar_wait(qk_full + 8 * st, (i / QS) & 1);
        const uint32_t base = sqk + st * L::QK_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<T>(s, desc_sw128(base + q_rows + kk * 32, 16, 1024),
                      desc_sw128(base + L::Q_BOX + kk * 32, 16, 1024),
                      sl > 0 || kk > 0);
        wgmma_commit();
        if (sl > 0) {                    // the slice before is done
          wgmma_wait<1>();
          __syncwarp();
          if (lane == 0) mbar_arrive(qk_empty + 8 * ((i - 1) % QS));
        }
      }
      wgmma_wait<0>();
      fence_regs(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(qk_empty + 8 * ((i - 1) % QS));
      softmax_tile(s, m, l, corr, scale_log2, t * BN + BN - 1 > warp_row,
                   t * BN + 2 * c, row0);
      rescale(acc, corr);
      to_operand<T>(pa, s);
      const int vs = t % VS;
      mbar_wait(v_full + 8 * vs, (t / VS) & 1);
      wgmma_fence();
      pv_tile<T, L>(acc, pa, sv + vs * L::V_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty + 8 * vs);
    }
    const int col0 = chunk * L::DV;
    store_rows<L::DV>(o + (int64_t)bh * seq_len * head_dim + col0, head_dim,
                      head_dim - col0, acc, l, row0, c, seq_len);
  }
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on mma.sync
// ---------------------------------------------------------------------------

// DP: the head dim.  Up to DP = 128 a block holds 128 q rows (8 warps)
// and kv tiles of 64 keys; at DP = 256 64 rows (4 warps) and 32 keys, to
// fit in shared memory.  Row pitches in floats:
// q and K rows padded to DP + 8 (conflict-free 8-byte fragment reads), V
// rows to DP + 4 (conflict-free 4-byte reads of rows 2c and 2c + 1).
template <int DP>
struct F32Tiles {
  static constexpr int BM = DP > 128 ? 64 : 128;   // q rows per block
  static constexpr int BN = DP > 128 ? 32 : 64;    // keys per kv tile
  static constexpr int THREADS = 2 * BM;           // 16 q rows a warp
  static constexpr int LDQK = DP + 8;
  static constexpr int LDV = DP + 4;
  static constexpr int STAGE = BN * (LDQK + LDV);   // K, then V
  static constexpr int SMEM = (BM * LDQK + 2 * STAGE) * 4;
};

// Past 256: 64 q rows (4 warps), 64-key kv tiles, q and K in 64-column
// slices (q's then K's rows a stage), V in chunks of DV = 128 columns.
struct WideF32Tiles {
  static constexpr int BM = 64;
  static constexpr int BN = 64;
  static constexpr int DV = 128;
  static constexpr int THREADS = 2 * BM;
  static constexpr int LDQK = 64 + 8;
  static constexpr int LDV = DV + 4;
  static constexpr int STAGE = (BM + BN) * LDQK > BN * LDV
                                   ? (BM + BN) * LDQK : BN * LDV;
  static constexpr int SMEM = 2 * STAGE * 4;
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a . b in 3xTF32: big += hi . hi, small += the two cross terms.  The
// tensor cores do not round their f32 sums to nearest: each mma shrinks
// the accumulator's magnitude by up to about an ulp.  So the cross terms
// (~2^-11 of hi . hi) are summed apart, where that loss is negligible, and
// the callers start big from zero for a short run of mma and add big +
// small into their running sums with rounded FADDs.
__device__ __forceinline__ void mma_3xtf32(float* big, float* small,
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

// Rows r0 .. r0 + rows - 1 of a (S, ld) matrix's NCOL columns from src
// into dst (row stride LD floats) by 16-byte cp.async; rows past S are
// zero, and with CLIP so are the columns from col_end on.
template <int NCOL, int LD, int THREADS, bool CLIP = false>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           int ld, int col_end, float* dst,
                                           int r0, int rows, int seq_len) {
  for (int i = threadIdx.x; i < rows * NCOL / 4; i += THREADS) {
    const int r = i / (NCOL / 4);
    const int col = (i % (NCOL / 4)) * 4;
    const bool live = r0 + r < seq_len && (!CLIP || col < col_end);
    const float* from = src + (int64_t)(live ? r0 + r : 0) * ld +
                        (CLIP && !live ? 0 : col);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_u32(dst + r * LD + col)),
                 "l"(from), "r"(live ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// S (+)= q . K^T over NCOL columns of d in 3xTF32 (s takes hi . hi,
// s_small the cross terms), 8 columns a step.  qw: the warp's q row g at
// column 2c, kw: K's row g at column 2c.  The sum over d does not care
// which column an mma k-slot carries, so slots c and c + 4 take columns
// 2c and 2c + 1 in both q and K: one float2 each.
template <int NCOL, int LDQK, int BN>
__device__ __forceinline__ void qk_3xtf32(float (&s)[BN / 2],
                                          float (&s_small)[BN / 2],
                                          const float* qw, const float* kw) {
#pragma unroll 2
  for (int kd = 0; kd < NCOL / 8; ++kd) {
    const float2 a0 = *reinterpret_cast<const float2*>(qw + kd * 8);
    const float2 a1 =
        *reinterpret_cast<const float2*>(qw + 8 * LDQK + kd * 8);
    uint32_t ah[4], al[4];
    split_tf32(a0.x, ah[0], al[0]);
    split_tf32(a1.x, ah[1], al[1]);
    split_tf32(a0.y, ah[2], al[2]);
    split_tf32(a1.y, ah[3], al[3]);
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const float2 b = *reinterpret_cast<const float2*>(
          kw + nb * 8 * LDQK + kd * 8);
      mma_3xtf32(&s[4 * nb], &s_small[4 * nb], ah, al, b.x, b.y);
    }
  }
}

// acc (NCOL columns) += P . V over BN keys, 8 a step: A's columns
// (c, c + 4) are the accumulator's keys (2c, 2c + 1), so V's rows 2c and
// 2c + 1 are B's rows c and c + 4.  The product over each 16 keys is
// summed from zero, NG blocks of 8 columns of d at a time (NG independent
// mma chains), and added to acc once.  (Longer runs of keys held more P
// fragments live and spilled; at NCOL = 256 the accumulator takes 128
// registers, so two chains.)
template <int NCOL, int LDV, int BN>
__device__ __forceinline__ void pv_3xtf32(float (&acc)[NCOL / 2],
                                          const float (&s)[BN / 2],
                                          const float* vs, int g, int c) {
  constexpr int KH = 2;                      // 8-key steps a run
  constexpr int NG = NCOL / 8 < 4 ? NCOL / 8 : NCOL > 128 ? 2 : 4;
#pragma unroll
  for (int k0h = 0; k0h < BN / 8; k0h += KH) {
    uint32_t ph[KH][4], pl[KH][4];
#pragma unroll
    for (int kb = 0; kb < KH; ++kb) {
      const float* p = &s[4 * (k0h + kb)];
      split_tf32(p[0], ph[kb][0], pl[kb][0]);
      split_tf32(p[2], ph[kb][1], pl[kb][1]);
      split_tf32(p[1], ph[kb][2], pl[kb][2]);
      split_tf32(p[3], ph[kb][3], pl[kb][3]);
    }
    const float* vr = vs + (k0h * 8 + 2 * c) * LDV + g;
#pragma unroll
    for (int nb0 = 0; nb0 < NCOL / 8; nb0 += NG) {
      float big[4 * NG], small[4 * NG];
#pragma unroll
      for (int i = 0; i < 4 * NG; ++i) big[i] = small[i] = 0.f;
#pragma unroll
      for (int kb = 0; kb < KH; ++kb)
#pragma unroll
        for (int n = 0; n < NG; ++n)
          mma_3xtf32(&big[4 * n], &small[4 * n], ph[kb], pl[kb],
                     vr[kb * 8 * LDV + (nb0 + n) * 8],
                     vr[(kb * 8 + 1) * LDV + (nb0 + n) * 8]);
#pragma unroll
      for (int i = 0; i < 4 * NG; ++i)
        acc[4 * nb0 + i] += big[i] + small[i];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(F32Tiles<DP>::THREADS, 1)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int bh_count, int seq_len, int n_q_tiles,
                     float scale_log2) {
  using L = F32Tiles<DP>;
  constexpr int BM = L::BM, BN = L::BN, THREADS = L::THREADS;
  constexpr int LDQK = L::LDQK, LDV = L::LDV;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);   // (BM, LDQK)
  float* kv = qs + BM * LDQK;   // stage t at t * STAGE: K, then V

  const int qt = n_q_tiles - 1 - blockIdx.x / bh_count;  // heaviest first
  const int bh = blockIdx.x % bh_count;
  const int q0 = qt * BM;
  const int64_t base = (int64_t)bh * seq_len * DP;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int w_first = q0 + warp * 16;     // the warp's first q row
  const int n_kv = (min(q0 + BM, seq_len) - 1) / BN + 1;

  stage_rows<DP, LDQK, THREADS>(q + base, DP, DP, qs, q0, BM, seq_len);
  cp_async_commit();
  stage_rows<DP, LDQK, THREADS>(k + base, DP, DP, kv, 0, BN, seq_len);
  stage_rows<DP, LDV, THREADS>(v + base, DP, DP, kv + BN * LDQK, 0, BN,
                               seq_len);
  cp_async_commit();

  float acc[DP / 2];
  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    if (t + 1 < n_kv) {
      float* next = kv + ((t + 1) & 1) * L::STAGE;
      stage_rows<DP, LDQK, THREADS>(k + base, DP, DP, next, (t + 1) * BN,
                                    BN, seq_len);
      stage_rows<DP, LDV, THREADS>(v + base, DP, DP, next + BN * LDQK,
                                   (t + 1) * BN, BN, seq_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = kv + (t & 1) * L::STAGE;
    const float* vs = ks + BN * LDQK;
    const int k0 = t * BN;
    if (k0 <= w_first + 15) {    // else every key is above the warp's rows
      float s[BN / 2], s_small[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = s_small[i] = 0.f;
      qk_3xtf32<DP, LDQK, BN>(s, s_small, qs + (warp * 16 + g) * LDQK + 2 * c,
                              ks + g * LDQK + 2 * c);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] += s_small[i];

      float corr[2];
      softmax_tile(s, m, l, corr, scale_log2, k0 + BN - 1 > w_first,
                   k0 + 2 * c, w_first + g);
      rescale(acc, corr);
      pv_3xtf32<DP, LDV, BN>(acc, s, vs, g, c);
    }
    __syncthreads();   // the stage is rewritten two tiles on
  }
  store_rows<DP>(o + base, DP, DP, acc, l, w_first + g, c, seq_len);
}

// Past 256 (head_dim a multiple of 64, read at run time): one block per
// (bh, 64-row q tile, chunk of DV columns of v), heaviest q tiles first.
// Step i of the two-stage ring is, for kv tile i / (slices + 1), a q and K
// slice or, last, the tile's V chunk (its columns past head_dim zero).
__global__ void __launch_bounds__(WideF32Tiles::THREADS, 1)
    flash_wide_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          int bh_count, int seq_len, int head_dim,
                          int n_q_tiles, int n_chunks, float scale_log2) {
  using L = WideF32Tiles;
  constexpr int BM = L::BM, BN = L::BN, DV = L::DV, THREADS = L::THREADS;
  constexpr int LDQK = L::LDQK, LDV = L::LDV;
  extern __shared__ float4 smem_f4[];
  float* ring = reinterpret_cast<float*>(smem_f4);   // step i at (i & 1)

  const int chunk = blockIdx.x % n_chunks;
  const int rest = blockIdx.x / n_chunks;
  const int qt = n_q_tiles - 1 - rest / bh_count;    // heaviest first
  const int bh = rest % bh_count;
  const int q0 = qt * BM;
  const int col0 = chunk * DV;
  const int64_t base = (int64_t)bh * seq_len * head_dim;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int w_first = q0 + warp * 16;
  const int n_kv = (min(q0 + BM, seq_len) - 1) / BN + 1;
  const int n_slices = head_dim / 64;
  const int n_steps = n_kv * (n_slices + 1);

  auto stage = [&](int i) {
    float* buf = ring + (i & 1) * L::STAGE;
    const int t = i / (n_slices + 1), p = i % (n_slices + 1);
    if (p < n_slices) {
      stage_rows<64, LDQK, THREADS>(q + base + 64 * p, head_dim, 0, buf, q0,
                                    BM, seq_len);
      stage_rows<64, LDQK, THREADS>(k + base + 64 * p, head_dim, 0,
                                    buf + BM * LDQK, t * BN, BN, seq_len);
    } else {
      stage_rows<DV, LDV, THREADS, true>(v + base + col0, head_dim,
                                         head_dim - col0, buf, t * BN, BN,
                                         seq_len);
    }
    cp_async_commit();
  };

  float s[BN / 2], acc[DV / 2];
  float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) s[j] = 0.f;
#pragma unroll
  for (int j = 0; j < DV / 2; ++j) acc[j] = 0.f;

  stage(0);
  for (int i = 0; i < n_steps; ++i) {
    if (i + 1 < n_steps) {
      stage(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = ring + (i & 1) * L::STAGE;
    const int t = i / (n_slices + 1), p = i % (n_slices + 1);
    const int k0 = t * BN;
    if (k0 <= w_first + 15) {    // else every key is above the warp's rows
      if (p < n_slices) {
        // this slice's products from zero, added to S once
        float big[BN / 2], small[BN / 2];
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) big[j] = small[j] = 0.f;
        qk_3xtf32<64, LDQK, BN>(big, small,
                                buf + (warp * 16 + g) * LDQK + 2 * c,
                                buf + (BM + g) * LDQK + 2 * c);
#pragma unroll
        for (int j = 0; j < BN / 2; ++j)
          s[j] = (p == 0 ? 0.f : s[j]) + (big[j] + small[j]);
      } else {
        float corr[2];
        softmax_tile(s, m, l, corr, scale_log2, k0 + BN - 1 > w_first,
                     k0 + 2 * c, w_first + g);
        rescale(acc, corr);
        pv_3xtf32<DV, LDV, BN>(acc, s, buf, g, c);
      }
    }
    __syncthreads();   // the stage is rewritten two steps on
  }
  store_rows<DV>(o + base + col0, head_dim, head_dim - col0, acc, l,
                 w_first + g, c, seq_len);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// (BH, S, d) of T (bf16 or f16) as a 3-d map (d, S, BH), box_rows x
// 64-column boxes with the 128-byte swizzle; rows and columns past the
// tensor read as zero.
template <typename T>
static int make_map(CUtensorMap* map, const void* ptr, int bh, int seq_len,
                    int head_dim, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)head_dim, (cuuint64_t)seq_len,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)head_dim * 2,
                                 (cuuint64_t)seq_len * head_dim * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      IS_F16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A grid of more blocks than one dimension holds is refused, not cut.
static bool grid_fits(int64_t blocks) { return blocks <= 0x7FFFFFFF; }

template <typename T, int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int bh, int seq_len, float scale, cudaStream_t stream) {
  using L = Tiles16<DP>;
  // set once per instantiation, before any graph capture
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = make_map<T>(&maps[i], ptrs[i], bh, seq_len, DP,
                                i == 0 ? B_BM : L::BN);
    if (err) return err;
  }
  const int n_q_tiles = (seq_len + B_BM - 1) / B_BM;
  const int64_t blocks = (int64_t)bh * n_q_tiles;
  if (!grid_fits(blocks)) return (int)cudaErrorInvalidConfiguration;
  flash_wgmma_kernel<T, DP><<<(unsigned)blocks, B_THREADS, L::SMEM,
                              stream>>>(maps[0], maps[1], maps[2], (T*)o,
                                        bh, seq_len, n_q_tiles,
                                        scale * LOG2E);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide_wgmma(const void* q, const void* k, const void* v, void* o,
                      int bh, int seq_len, int head_dim, float scale,
                      cudaStream_t stream) {
  using L = WideTiles16;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wide_wgmma_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = make_map<T>(&maps[i], ptrs[i], bh, seq_len, head_dim,
                                i == 0 ? B_BM : L::BN);
    if (err) return err;
  }
  const int n_q_tiles = (seq_len + B_BM - 1) / B_BM;
  const int n_chunks = (head_dim + L::DV - 1) / L::DV;
  const int64_t blocks = (int64_t)bh * n_q_tiles * n_chunks;
  if (!grid_fits(blocks)) return (int)cudaErrorInvalidConfiguration;
  flash_wide_wgmma_kernel<T><<<(unsigned)blocks, B_THREADS, L::SMEM,
                               stream>>>(maps[0], maps[1], maps[2], (T*)o,
                                         bh, seq_len, head_dim, n_q_tiles,
                                         n_chunks, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh,
               int seq_len, float scale, cudaStream_t stream) {
  using L = F32Tiles<DP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int n_q_tiles = (seq_len + L::BM - 1) / L::BM;
  const int64_t blocks = (int64_t)bh * n_q_tiles;
  if (!grid_fits(blocks)) return (int)cudaErrorInvalidConfiguration;
  flash_f32_kernel<DP><<<(unsigned)blocks, L::THREADS, L::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, bh,
      seq_len, n_q_tiles, scale * LOG2E);
  return (int)cudaGetLastError();
}

int launch_wide_f32(const void* q, const void* k, const void* v, void* o,
                    int bh, int seq_len, int head_dim, float scale,
                    cudaStream_t stream) {
  using L = WideF32Tiles;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wide_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int n_q_tiles = (seq_len + L::BM - 1) / L::BM;
  const int n_chunks = (head_dim + L::DV - 1) / L::DV;
  const int64_t blocks = (int64_t)bh * n_q_tiles * n_chunks;
  if (!grid_fits(blocks)) return (int)cudaErrorInvalidConfiguration;
  flash_wide_f32_kernel<<<(unsigned)blocks, L::THREADS, L::SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, bh,
      seq_len, head_dim, n_q_tiles, n_chunks, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_16(const void* q, const void* k, const void* v, void* o, int bh,
              int seq_len, int head_dim, float scale, cudaStream_t s) {
  switch (head_dim) {
    case 64:
      return launch_wgmma<T, 64>(q, k, v, o, bh, seq_len, scale, s);
    case 128:
      return launch_wgmma<T, 128>(q, k, v, o, bh, seq_len, scale, s);
    case 256:
      return launch_wgmma<T, 256>(q, k, v, o, bh, seq_len, scale, s);
  }
  if (head_dim > 256 && head_dim % 64 == 0)
    return launch_wide_wgmma<T>(q, k, v, o, bh, seq_len, head_dim, scale, s);
  return (int)cudaErrorInvalidValue;
}

// q, k, v, o: (bh, seq_len, head_dim), all f32 (dtype FA_F32), bf16
// (FA_BF16) or f16 (FA_F16), contiguous and 16-byte aligned; head_dim in
// {64, 128, 256} for bf16 and f16, {16, 32, 64, 128, 256} for f32, or any
// multiple of 64 past 256; scale = 1 / sqrt(the true head dim, which the
// caller may have padded).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh,
                                      int seq_len, int head_dim, int dtype,
                                      float scale, void* stream) {
  if (bh == 0 || seq_len == 0) {
    return 0;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == FA_BF16)
    return launch_16<__nv_bfloat16>(q, k, v, o, bh, seq_len, head_dim, scale,
                                    s);
  if (dtype == FA_F16)
    return launch_16<__half>(q, k, v, o, bh, seq_len, head_dim, scale, s);
  if (dtype != FA_F32) return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 16:
      return launch_f32<16>(q, k, v, o, bh, seq_len, scale, s);
    case 32:
      return launch_f32<32>(q, k, v, o, bh, seq_len, scale, s);
    case 64:
      return launch_f32<64>(q, k, v, o, bh, seq_len, scale, s);
    case 128:
      return launch_f32<128>(q, k, v, o, bh, seq_len, scale, s);
    case 256:
      return launch_f32<256>(q, k, v, o, bh, seq_len, scale, s);
  }
  if (head_dim > 256 && head_dim % 64 == 0)
    return launch_wide_f32(q, k, v, o, bh, seq_len, head_dim, scale, s);
  return (int)cudaErrorInvalidValue;
}
