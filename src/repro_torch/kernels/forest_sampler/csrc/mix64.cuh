// splitmix64's finalizer, shared by hash_draws.cu and forest_sample.cu so
// that both hash the same bits from one source.  Bit for bit equal to
// repro.sparse.sampler._mix64 (uint64, wrapping; shifts are logical).
#pragma once
#include <stdint.h>

static __device__ __forceinline__ uint64_t mix64(uint64_t z) {
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}
