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
// (from -1e30), sum l and accumulator acc, q scaled before the dot, masked
// scores set to -1e30, and o = acc / max(l, 1e-30) in the input's type.
// Inputs are f32 or bf16 (converted to f32 as they are staged); all
// arithmetic is f32.
//
// What bounds it on the H100: operations.  A (BH, S, d) causal pass does
// 2 * BH * d * S * (S + 1) flops on 4 * BH * S * d elements (S = 4096,
// d = 128: ~1000 flops per element).  This first kernel does them on the
// CUDA cores in f32, not on the tensor cores (wgmma is later work), and
// keeps every intermediate on chip:
//
// * one thread block of 8 warps per (bh, 64-row q tile), heaviest tiles
//   first; the scaled q tile and each 64-row K and V tile are staged in
//   shared memory as f32 (rows padded to d + 4 floats so that the lanes'
//   16-byte K reads fall in distinct banks); past 48 KB (d >= 64) the launch
//   function raises the kernel's dynamic shared memory limit;
// * kv tiles that lie wholly above the diagonal are never loaded (the
//   causal skip); with 64-row q and kv tiles every loaded tile holds at
//   least one unmasked key for each of the block's rows;
// * each warp owns 8 query rows: lane l scores keys l and l + 32 of the
//   tile against them, the row max and sum are warp shuffles, and the
//   probabilities go through shared memory to the P.V step, where lane l
//   owns columns l, l + 32, ... of each row's accumulator (a row split over
//   the warp: at d = 128 a lane holds 8 rows x 4 columns, no spills).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per kv tile
constexpr int WARPS = 8;
constexpr int ROWS = BQ / WARPS;  // query rows per warp
constexpr float MASKED = -1e30f;

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  f[0] = t.x;
  f[1] = t.y;
  f[2] = t.z;
  f[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage rows r0 .. r0+63 of one (S, D) matrix into dst (row stride ld),
// times mul, as f32; rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ src, float* dst,
                                      int ld, int r0, int seq_len,
                                      float mul) {
  for (int i = threadIdx.x; i < BQ * D / 4; i += blockDim.x) {
    const int r = i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < seq_len) load4(src + (int64_t)(r0 + r) * D + c, f);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[r * ld + c + j] = f[j] * mul;
  }
}

template <int D>
constexpr int smem_floats() {
  return 2 * BQ * (D + 4) + BK * D + WARPS * ROWS * BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(WARPS * 32)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int seq_len, int n_q_tiles, float scale) {
  constexpr int LD = D + 4;
  constexpr int NC = (D + 31) / 32;  // accumulator columns per lane
  extern __shared__ float4 smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // (BQ, LD), q * scale
  float* ks = qs + BQ * LD;                        // (BK, LD)
  float* vs = ks + BK * LD;                        // (BK, D)
  float* ps = vs + BK * D;                         // (WARPS, ROWS, BK)

  const int bh = blockIdx.x / n_q_tiles;
  const int q0 = (n_q_tiles - 1 - blockIdx.x % n_q_tiles) * BQ;
  const int64_t base = (int64_t)bh * seq_len * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* pw = ps + warp * ROWS * BK;

  stage<T, D>(q + base, qs, LD, q0, seq_len, scale);

  float m_i[ROWS], l_i[ROWS], acc[ROWS][NC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m_i[i] = MASKED;
    l_i[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  const int q_last = min(q0 + BQ, seq_len) - 1;
  for (int k0 = 0; k0 <= q_last; k0 += BK) {  // causal skip past q_last
    __syncthreads();                           // last tile fully consumed
    stage<T, D>(k + base, ks, LD, k0, seq_len, 1.f);
    stage<T, D>(v + base, vs, D, k0, seq_len, 1.f);
    __syncthreads();

    float s[ROWS][2];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i][0] = s[i][1] = 0.f;
    for (int c = 0; c < D; c += 4) {
      float ka[4], kb[4];
      load4(ks + lane * LD + c, ka);
      load4(ks + (lane + 32) * LD + c, kb);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        float qv[4];
        load4(qs + (warp * ROWS + i) * LD + c, qv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][0] += qv[j] * ka[j];
          s[i][1] += qv[j] * kb[j];
        }
      }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int q_pos = q0 + warp * ROWS + i;
      if (k0 + lane > q_pos) s[i][0] = MASKED;
      if (k0 + lane + 32 > q_pos) s[i][1] = MASKED;
      float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float p0 = expf(s[i][0] - m_new);
      const float p1 = expf(s[i][1] - m_new);
      const float corr = expf(m_i[i] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * corr + sum;
      m_i[i] = m_new;
      pw[i * BK + lane] = p0;
      pw[i * BK + lane + 32] = p1;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= corr;
    }
    __syncwarp();

    for (int j = 0; j < BK; ++j) {
      float vv[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = lane + 32 * n;
        vv[n] = c < D ? vs[j * D + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = pw[i * BK + j];
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] += p * vv[n];
      }
    }
    __syncwarp();  // pw is rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int q_pos = q0 + warp * ROWS + i;
    if (q_pos >= seq_len) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    T* orow = o + base + (int64_t)q_pos * D;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int c = lane + 32 * n;
      if (c < D) store1(orow + c, acc[i][n] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int seq_len, float scale, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  static bool attr_set = false;  // set once, before any graph capture
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int n_q_tiles = (seq_len + BQ - 1) / BQ;
  const int64_t blocks = (int64_t)bh * n_q_tiles;
  flash_attention_kernel<T, D><<<(unsigned)blocks, WARPS * 32, bytes,
                                 stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, seq_len, n_q_tiles,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int bh,
             int seq_len, int head_dim, float scale, cudaStream_t s) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(q, k, v, o, bh, seq_len, scale, s);
    case 32:
      return launch<T, 32>(q, k, v, o, bh, seq_len, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, bh, seq_len, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, seq_len, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q, k, v, o: (bh, seq_len, head_dim), f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1), contiguous and 16-byte aligned; head_dim in {16, 32, 64,
// 128}; scale = 1 / sqrt(head_dim).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bh,
                                      int seq_len, int head_dim, int is_bf16,
                                      float scale, void* stream) {
  if (bh == 0 || seq_len == 0) {
    return 0;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return launch_d<__nv_bfloat16>(q, k, v, o, bh, seq_len, head_dim, scale,
                                   s);
  }
  return launch_d<float>(q, k, v, o, bh, seq_len, head_dim, scale, s);
}
