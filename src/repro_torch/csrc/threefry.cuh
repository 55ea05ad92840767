// threefry2x32, bit-identical to jax.random's default generator (and to
// repro_torch/rng.py, which replays it in int64 PyTorch ops): 20 rounds,
// rotations 13/15/26/6 and 17/29/16/24, a key injection after every 4
// rounds. A key is two uint32 words; jax's partitionable draws hash a
// 64-bit counter (hi, lo) per element:
//
//   fold_in(key, d)    block(key, 0, (uint32)d)
//   split(key)[j]      block(key, 0, j), j = 0, 1
//   bits32(key)[i]     x0 ^ x1 of block(key, 0, i)         (i < 2^32)
//   bits64(key)[i]     x0 << 32 | x1 of block(key, 0, i)
#pragma once

#include <cuda_runtime.h>

namespace threefry {

__device__ __forceinline__ unsigned rotl(unsigned x, int r) { return __funnelshift_l(x, x, r); }

__device__ __forceinline__ void rounds(unsigned& x0, unsigned& x1, int r0, int r1, int r2,
                                       int r3) {
  x0 += x1; x1 = rotl(x1, r0) ^ x0;
  x0 += x1; x1 = rotl(x1, r1) ^ x0;
  x0 += x1; x1 = rotl(x1, r2) ^ x0;
  x0 += x1; x1 = rotl(x1, r3) ^ x0;
}

__device__ __forceinline__ uint2 block(uint2 key, unsigned x0, unsigned x1) {
  const unsigned k0 = key.x, k1 = key.y, k2 = key.x ^ key.y ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

__device__ __forceinline__ uint2 fold_in(uint2 key, unsigned d) { return block(key, 0u, d); }

__device__ __forceinline__ uint2 split(uint2 key, unsigned j) { return block(key, 0u, j); }

__device__ __forceinline__ unsigned bits32(uint2 key, unsigned i) {
  const uint2 y = block(key, 0u, i);
  return y.x ^ y.y;
}

__device__ __forceinline__ unsigned long long bits64(uint2 key, unsigned i) {
  const uint2 y = block(key, 0u, i);
  return ((unsigned long long)y.x << 32) | y.y;
}

// jax.random.uniform(key, (n,), float32)[i] on [0, 1): the top 23 bits as
// the mantissa of a float in [1, 2), minus 1 (exact).
__device__ __forceinline__ float uniform(uint2 key, unsigned i) {
  return __uint_as_float((bits32(key, i) >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace threefry
