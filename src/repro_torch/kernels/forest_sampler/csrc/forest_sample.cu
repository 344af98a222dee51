// A bucket's whole device forest sample in one launch, for Hopper.
//
// The fused form of the Pallas TPU kernel
// repro/kernels/forest_sampler/forest_sampler.py:hash_draws together with
// the CSR gathers around it in repro/serve/device_sampler.py:
// DeviceSamplerPlane.sample_bucket (which XLA fuses into one program).
// hash_draws.cu stays as the standalone counterpart of the Pallas call.
//
// Computes, for T trees (seed, tree_key * C1, live) and fanouts f_0..f_{L-1},
// the bucket's breadth-major tables: node_ids (sum of levels, int64) and
// hop_valid (sum of hop budgets, bool), level by level and tree-major
// inside a level.  The child j of parent lane p at hop h is lane p*f_h + j
// and draws
//   r = mix64(key_c ^ tkm ^ (h+1)*K_HOP ^ lane*K_LANE) mod max(deg, 1)
// from its parent's CSR row, exactly as the reference's eager loop does:
// the row is indptr[clamp(v, 0, N)] .. indptr[clamp(v+1, 0, N)], the
// neighbour indices[clamp(start + r, 0, E-1)], a child of an invalid
// parent or of a parent without neighbours is -1 and invalid, and a
// padding tree (live == 0) is -1 and invalid at every level.
//
// What bounds it on the H100: neither bytes nor operations (a bucket of 16
// trees at fanouts (5, 3) is 336 nodes, ~8 KB of CSR reads) but latency:
// one launch and, per hop, a chain of dependent loads (trees -> indptr x2
// -> indices).  So the design is one thread per output node, across all
// levels: a node at depth d recomputes its ancestors' draws (the hash is
// pure), no thread waits on another and no level needs a barrier, and the
// chain is the minimum, 1 + 2d loads deep.  The ancestors' reads of one
// tree hit the same lines, which L1 and L2 serve.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mix64.cuh"

#define FOREST_MAX_HOPS 6

namespace {

constexpr uint64_t kHop = 0x8CB92BA72F3D8DD7ull;   // sampler._K_HOP
constexpr uint64_t kLane = 0x2545F4914F6CDD1Dull;  // sampler._K_LANE
constexpr int kThreads = 128;

struct ForestShape {
  // node offset of level l in node_ids; level_off[n_hops + 1] = total
  int64_t level_off[FOREST_MAX_HOPS + 2];
  // nodes of one tree at level l: f_0 * ... * f_{l-1}
  uint32_t size[FOREST_MAX_HOPS + 1];
  int n_hops;
};

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo,
                                           int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
forest_sample_kernel(const int64_t* __restrict__ indptr,
                     const int64_t* __restrict__ indices,
                     const int64_t* __restrict__ trees,
                     int64_t* __restrict__ node_ids,
                     bool* __restrict__ hop_valid, int64_t total,
                     int64_t n_nodes, int64_t n_edges, int64_t n_trees,
                     uint64_t key_c, ForestShape shape) {
  // (the shape is indexed by constants only, or it moves to the stack)
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) {
    return;
  }
  // this node's level
  int level = 0;
  uint32_t size = 1;
  int64_t off = 0;
#pragma unroll
  for (int l = 1; l <= FOREST_MAX_HOPS; ++l) {
    if (l <= shape.n_hops && i >= shape.level_off[l]) {
      level = l;
      size = shape.size[l];
      off = shape.level_off[l];
    }
  }
  const int64_t within = i - off;
  const int64_t t = within / size;
  const uint32_t q = (uint32_t)(within - t * size);

  const int64_t seed = __ldg(trees + t);
  const uint64_t z_tree = key_c ^ (uint64_t)__ldg(trees + n_trees + t);
  bool valid = __ldg(trees + 2 * n_trees + t) != 0;
  int64_t node = valid ? seed : -1;

#pragma unroll
  for (int h = 0; h < FOREST_MAX_HOPS; ++h) {
    if (h >= level || !valid) {
      break;
    }
    // this node's ancestor lane at level h + 1
    const uint32_t lane = q / (size / shape.size[h + 1]);
    const int64_t start = __ldg(indptr + clamp64(node, 0, n_nodes));
    const int64_t stop = __ldg(
        indptr + clamp64((int64_t)((uint64_t)node + 1), 0, n_nodes));
    const int64_t deg = stop - start;
    const uint64_t z = z_tree ^ ((uint64_t)(h + 1) * kHop) ^
                       ((uint64_t)lane * kLane);
    // the reference's max(deg, 1) cast to int32, then the draw as int32
    const uint32_t modulus = (uint32_t)(int32_t)(deg > 1 ? deg : 1);
    const int64_t r = (int32_t)(uint32_t)(mix64(z) % modulus);
    valid = deg > 0;
    node = -1;
    if (valid) {
      // with E == 0, indices is never read (the reference's zeros)
      node = n_edges > 0
                 ? __ldg(indices + clamp64(start + r, 0, n_edges - 1))
                 : 0;
    }
  }
  node_ids[i] = node;
  if (level > 0) {
    hop_valid[i - n_trees] = valid;
  }
}

}  // namespace

extern "C" int forest_sample_launch(const void* indptr, const void* indices,
                                    const void* trees, void* node_ids,
                                    void* hop_valid, int64_t n_nodes,
                                    int64_t n_edges, int64_t n_trees,
                                    uint64_t key_c, const int64_t* fanouts,
                                    int64_t n_hops, void* stream) {
  if (n_hops < 1 || n_hops > FOREST_MAX_HOPS || n_trees < 0) {
    return (int)cudaErrorInvalidValue;
  }
  ForestShape shape = {};
  shape.n_hops = (int)n_hops;
  shape.size[0] = 1;
  shape.level_off[0] = 0;
  for (int l = 0; l <= n_hops; ++l) {
    if (l < n_hops) {
      shape.size[l + 1] = shape.size[l] * (uint32_t)fanouts[l];
    }
    shape.level_off[l + 1] = shape.level_off[l] + n_trees * shape.size[l];
  }
  const int64_t total = shape.level_off[n_hops + 1];
  if (total == 0) {
    return 0;
  }
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  forest_sample_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int64_t*)indptr, (const int64_t*)indices, (const int64_t*)trees,
      (int64_t*)node_ids, (bool*)hop_valid, total, n_nodes, n_edges,
      n_trees, key_c, shape);
  return (int)cudaGetLastError();
}
