// threefry2x32, the 20-round block cipher of jax.random's default generator
// (Salmon et al., SC'11), on native uint32 with rotations by
// __funnelshift_l.  The plain version is repro_torch/core/prng.py, which
// gives the Random123 known-answer vectors; the generator's words equal its
// words bitwise (chip_smoke.py phase 6).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int R>
__device__ __forceinline__ void threefry_round(uint32_t& x0, uint32_t& x1) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, R);  // rotate left by R
  x1 ^= x0;
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void threefry_group(uint32_t& x0, uint32_t& x1) {
  threefry_round<R0>(x0, x1);
  threefry_round<R1>(x0, x1);
  threefry_round<R2>(x0, x1);
  threefry_round<R3>(x0, x1);
}

// (x0, x1) under key (k0, k1): five groups of four rounds, a key injection
// after each.
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  threefry_group<13, 15, 26, 6>(x0, x1);
  x0 += k1;
  x1 += k2 + 1u;
  threefry_group<17, 29, 16, 24>(x0, x1);
  x0 += k2;
  x1 += k0 + 2u;
  threefry_group<13, 15, 26, 6>(x0, x1);
  x0 += k0;
  x1 += k1 + 3u;
  threefry_group<17, 29, 16, 24>(x0, x1);
  x0 += k1;
  x1 += k2 + 4u;
  threefry_group<13, 15, 26, 6>(x0, x1);
  x0 += k2;
  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

}  // namespace
