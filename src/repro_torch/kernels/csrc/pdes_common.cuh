// The PDES rules that every CUDA kernel of the port shares, in one place:
// the counter-stream hash, the site pick, the eta decode, the causality rule
// and the warp reductions.  pdes_multistep_counter.cu (B1) and pdes_step.cu
// (B2) include this header, so the two kernels cannot drift apart: the
// engine's `pallas` backend (B2) must equal `pallas_multistep` (B1) bit for
// bit in the exact window.  kernels/_build.py hashes every header in csrc/
// into each library's name, so an edit here rebuilds both.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// murmur3 fmix32 (core/events.py: _mix)
__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The first three absorb rounds of counter_words: constant along a row.
__device__ __forceinline__ uint32_t row_hash(uint32_t seed, uint32_t step,
                                             uint32_t trial) {
  uint32_t h = mix32(seed ^ 0x9E3779B9u);
  h = mix32(h ^ (step * 0x27D4EB2Fu));
  return mix32(h ^ (trial * 0x165667B1u));
}

// Site pick from word 0: site = w0 % n_v; sites 0 and n_v - 1 are the
// borders (both at once when n_v == 1).
__device__ __forceinline__ void site_pick(uint32_t w0, uint32_t n_v,
                                          bool& is_left, bool& is_right) {
  const uint32_t site = w0 % n_v;
  is_left = site == 0;
  is_right = site == n_v - 1;
}

// The port's decode rule (core/horizon.py).  The _rn intrinsics keep the
// compiler from contracting the multiply and add into one rounding.
__device__ __forceinline__ float eta_from_w1(uint32_t w1) {
  const float u = __fmul_rn(__uint2float_rn(w1 >> 8), 5.9604644775390625e-08f);
  const float x = __fadd_rn(u, 2.98023223876953125e-08f);
  return __double2float_rn(-log((double)x));
}

// Eq. (1) causality against the +-1 neighbours (callers skip it in
// rd_mode).  The window rule, Eq. (3), is `t <= __fadd_rn(delta, gvt)`.
__device__ __forceinline__ bool causal_ok(float t, float lft, float rgt,
                                          bool is_left, bool is_right,
                                          int border_both) {
  if (border_both)
    return !(is_left || is_right) || (t <= lft && t <= rgt);
  return (!is_left || t <= lft) && (!is_right || t <= rgt);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ unsigned warp_sum_u(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

}  // namespace
