// Counter-hash neighbor draws for the device forest sampler, for Hopper.
//
// Replaces the Pallas TPU kernel
// repro/kernels/forest_sampler/forest_sampler.py:hash_draws
// (body _draws_kernel, with mix64_pair and mod64_pair).
//
// Computes out[i] = splitmix64(z[i]) mod deg[i], element by element, bit
// for bit equal to repro.sparse.sampler._mix64(z) % deg.  The TPU kernel
// emulated uint64 with (hi, lo) uint32 pairs; CUDA has native 64-bit
// integers, so z arrives as one 64-bit word and the hash is four lines.
//
// What bounds it on the H100: bytes (8 in + 4 in + 4 out per draw against
// a few dozen integer operations), and at the serving path's sizes (a few
// hundred draws) the launch itself.  One thread per draw, nothing more.
// Precondition: deg[i] >= 1 (callers pass max(degree, 1)).
#include <cuda_runtime.h>
#include <stdint.h>

#include "mix64.cuh"

__global__ void hash_draws_kernel(const uint64_t* __restrict__ z,
                                  const int32_t* __restrict__ deg,
                                  int32_t* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    out[i] = (int32_t)(mix64(z[i]) % (uint64_t)(uint32_t)deg[i]);
  }
}

extern "C" int hash_draws_launch(const void* z, const void* deg, void* out,
                                 int64_t n, void* stream) {
  if (n == 0) {
    return 0;
  }
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  hash_draws_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)z, (const int32_t*)deg, (int32_t*)out, n);
  return (int)cudaGetLastError();
}
