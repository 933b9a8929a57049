// The PDES rules that every CUDA kernel of the port shares, in one place:
// the counter-stream hash, the site pick, the eta decode, the causality rule
// and the warp reductions.  pdes_step.cu (B2) includes this header, and so
// do pdes_multistep_counter.cu (B1) and pdes_multistep.cu (B3) through
// pdes_ring.cuh, so the kernels cannot drift apart: the engine's `pallas`
// backend (B2) must equal `pallas_multistep` (B1) bit for bit in the exact
// window.  kernels/_build.py hashes every header in csrc/ into each
// library's name, so an edit here rebuilds all three.
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
// borders (both at once when n_v == 1).  The remainder takes no division:
// n_v is fixed per launch, so a block computes its multiply-high reciprocal
// once (Granlund & Montgomery 1994, Fig. 4.1, with N = 32):
//   l = ceil(log2 n_v), m = floor(2^32 (2^l - n_v) / n_v) + 1,
//   q = (umulhi(w0, m) + ((w0 - umulhi(w0, m)) >> min(l, 1))) >> max(l - 1, 0)
// is w0 / n_v exactly for every uint32 w0 and 1 <= n_v < 2^32, and the site
// is w0 - q n_v: a multiply-high, two shifts, an add, a subtract and a
// multiply-add instead of the ~15 instructions of a runtime `%`.
// kernels/ref.py::site_divisor repeats the constants in Python.
struct SiteDivisor {
  uint32_t d, m;
  int sh1, sh2;
};

__device__ __forceinline__ SiteDivisor site_divisor(uint32_t d) {
  const int l = 32 - __clz((int)(d - 1u));
  const uint64_t m = ((((uint64_t)1 << l) - d) << 32) / d + 1;
  return {d, (uint32_t)m, l < 1 ? l : 1, l > 1 ? l - 1 : 0};
}

__device__ __forceinline__ uint32_t site_of(uint32_t w0,
                                            const SiteDivisor& div) {
  const uint32_t hi = __umulhi(w0, div.m);
  const uint32_t q = (hi + ((w0 - hi) >> div.sh1)) >> div.sh2;
  return w0 - q * div.d;
}

__device__ __forceinline__ void site_pick(uint32_t w0, const SiteDivisor& div,
                                          bool& is_left, bool& is_right) {
  const uint32_t site = site_of(w0, div);
  is_left = site == 0;
  is_right = site == div.d - 1;
}

// The port's decode rule (core/horizon.py):
//   eta = fp32(-log(fp64(fp32(fp32(w1 >> 8) * 2^-24) + 2^-25))).
// The _rn intrinsics keep the compiler from contracting the multiply and add
// into one rounding.  The fp64 library log (some 30 fp64 instructions with a
// reciprocal, and nearly every warp has an updating lane that pays it) was
// 0.23 ms of B1's 0.59 ms chunk, so neg_log_rn takes -log(x) in fp64 from a
// table instead and rounds it to fp32: the same float on every x the decode
// makes (x in [2^-25, 1]).  x = 2^e m is reduced to z = m or m / 2 in
// [0.75, 1.5) by the top 7 bits j of m; with the table's c_j (1 / z at the
// bucket centre, a multiple of 2^-9, so r = z c_j - 1 is exact and |r| <
// 2^-7) and -ln c_j,
//   -log(x) = -(e' ln 2 - ln c_j + log1p(r)),  log1p(r) to degree 7,
// within 2^-51 of the library's value.  A value that close to an fp32
// rounding midpoint could round apart from the plain rule; the decode's
// domain is finite, and it is checked whole: kernels/ref.py::
// neg_log_emulated repeats the arithmetic in numpy on all 2^24 inputs
// (tests/test_torch_tiling.py), and chip_smoke.py phase 1 and tests/
// test_torch_cuda.py hold this function to the plain rule on all 2^24
// inputs on the card.  Straight-line fp64 with no branch, so rows
// interleave; two conversions and a 16-byte table read a PE.
struct __align__(16) LogEntry {
  double c, neg_log_c;
};

// kernels/ref.py::neg_log_table (tests/test_torch_tiling.py holds these to it)
__device__ const LogEntry kNegLogTable[128] = {
    {0x1.0000000000000p+0, 0x0.0p+0}, {0x1.fa00000000000p-1, 0x1.82448a388a2aap-7},
    {0x1.f600000000000p-1, 0x1.432a925980cc1p-6}, {0x1.f200000000000p-1, 0x1.c63d2ec14aaf2p-6},
    {0x1.ef00000000000p-1, 0x1.149e3e4005a8dp-5}, {0x1.eb00000000000p-1, 0x1.5715c4c03ceefp-5},
    {0x1.e700000000000p-1, 0x1.9a187b573de7cp-5}, {0x1.e400000000000p-1, 0x1.ccb73cdddb2ccp-5},
    {0x1.e000000000000p-1, 0x1.08598b59e3a07p-4}, {0x1.dd00000000000p-1, 0x1.2207b5c78549ep-4},
    {0x1.d900000000000p-1, 0x1.4485e03dbdfadp-4}, {0x1.d600000000000p-1, 0x1.5e95a4d9791cbp-4},
    {0x1.d200000000000p-1, 0x1.8197e2f40e3f0p-4}, {0x1.cf00000000000p-1, 0x1.9c0c32d4d2548p-4},
    {0x1.cc00000000000p-1, 0x1.b6ac88dad5b1cp-4}, {0x1.c900000000000p-1, 0x1.d179788219364p-4},
    {0x1.c600000000000p-1, 0x1.ec739830a1120p-4}, {0x1.c200000000000p-1, 0x1.08598b59e3a07p-3},
    {0x1.bf00000000000p-1, 0x1.160c8024b27b1p-3}, {0x1.bc00000000000p-1, 0x1.23d712a49c202p-3},
    {0x1.b900000000000p-1, 0x1.31b994d3a4f85p-3}, {0x1.b600000000000p-1, 0x1.3fb45a59928ccp-3},
    {0x1.b300000000000p-1, 0x1.4dc7b897bc1c8p-3}, {0x1.b100000000000p-1, 0x1.5737cc9018cddp-3},
    {0x1.ae00000000000p-1, 0x1.6574ebe8c133ap-3}, {0x1.ab00000000000p-1, 0x1.73cb9074fd14dp-3},
    {0x1.a800000000000p-1, 0x1.823c16551a3c2p-3}, {0x1.a500000000000p-1, 0x1.90c6db9fcbcd9p-3},
    {0x1.a300000000000p-1, 0x1.9a8778debaa38p-3}, {0x1.a000000000000p-1, 0x1.a93ed3c8ad9e3p-3},
    {0x1.9d00000000000p-1, 0x1.b811730b823d2p-3}, {0x1.9b00000000000p-1, 0x1.c2028ab17f9b4p-3},
    {0x1.9800000000000p-1, 0x1.d1037f2655e7bp-3}, {0x1.9600000000000p-1, 0x1.db13db0d48940p-3},
    {0x1.9300000000000p-1, 0x1.ea4449f04aaf5p-3}, {0x1.9100000000000p-1, 0x1.f474b134df229p-3},
    {0x1.8e00000000000p-1, 0x1.01eae5626c691p-2}, {0x1.8c00000000000p-1, 0x1.07138604d5862p-2},
    {0x1.8a00000000000p-1, 0x1.0c42d676162e3p-2}, {0x1.8700000000000p-1, 0x1.14167ef367783p-2},
    {0x1.8500000000000p-1, 0x1.1956d3b9bc2fap-2}, {0x1.8300000000000p-1, 0x1.1e9e1678899f4p-2},
    {0x1.8000000000000p-1, 0x1.269621134db92p-2}, {0x1.7e00000000000p-1, 0x1.2bef07cdc9354p-2},
    {0x1.7c00000000000p-1, 0x1.314f1e1d35ce4p-2}, {0x1.7a00000000000p-1, 0x1.36b6776be1117p-2},
    {0x1.7800000000000p-1, 0x1.3c25277333184p-2}, {0x1.7500000000000p-1, 0x1.44591e0539f49p-2},
    {0x1.7300000000000p-1, 0x1.49da7f3bcc41fp-2}, {0x1.7100000000000p-1, 0x1.4f637ebba9810p-2},
    {0x1.6f00000000000p-1, 0x1.54f431b7be1a9p-2}, {0x1.6d00000000000p-1, 0x1.5a8cadbbedfa1p-2},
    {0x1.6b00000000000p-1, 0x1.602d08af091ecp-2}, {0x1.6900000000000p-1, 0x1.65d558d4ce00bp-2},
    {0x1.6700000000000p-1, 0x1.6b85b4cffa3fdp-2}, {0x1.6500000000000p-1, 0x1.713e33a46a17cp-2},
    {0x1.6300000000000p-1, 0x1.76feecb947175p-2}, {0x1.6100000000000p-1, 0x1.7cc7f7db46a0ep-2},
    {0x1.5f00000000000p-1, 0x1.82996d3ef8bcbp-2}, {0x1.5e00000000000p-1, 0x1.85855776dcbfbp-2},
    {0x1.5c00000000000p-1, 0x1.8b639a88b2df5p-2}, {0x1.5a00000000000p-1, 0x1.914a8635bf68ap-2},
    {0x1.5800000000000p-1, 0x1.973a3431356aep-2}, {0x1.5600000000000p-1, 0x1.9d32bea15ed3bp-2},
    {0x1.5480000000000p+0, -0x1.241558bfd1404p-2}, {0x1.5280000000000p+0, -0x1.1e0d0c33716bep-2},
    {0x1.5100000000000p+0, -0x1.1980d2dd4236fp-2}, {0x1.4f00000000000p+0, -0x1.136870293a8b0p-2},
    {0x1.4d80000000000p+0, -0x1.0ed005f657da4p-2}, {0x1.4c00000000000p+0, -0x1.0a324e27390e3p-2},
    {0x1.4a00000000000p+0, -0x1.0402594b4d041p-2}, {0x1.4880000000000p+0, -0x1.feb0233e607ccp-3},
    {0x1.4700000000000p+0, -0x1.f550a564b7b37p-3}, {0x1.4500000000000p+0, -0x1.e8c0252aa5a60p-3},
    {0x1.4380000000000p+0, -0x1.df46c0c722d2fp-3}, {0x1.4200000000000p+0, -0x1.d5c216b4fbb91p-3},
    {0x1.4080000000000p+0, -0x1.cc320c0176502p-3}, {0x1.3f00000000000p+0, -0x1.c2968558c18c1p-3},
    {0x1.3d80000000000p+0, -0x1.b8ef670420c3bp-3}, {0x1.3c00000000000p+0, -0x1.af3c94e80bff3p-3},
    {0x1.3a80000000000p+0, -0x1.a57df28244dcdp-3}, {0x1.3900000000000p+0, -0x1.9bb362e7dfb83p-3},
    {0x1.3780000000000p+0, -0x1.91dcc8c340bdep-3}, {0x1.3600000000000p+0, -0x1.87fa06520c911p-3},
    {0x1.3480000000000p+0, -0x1.7e0afd630c274p-3}, {0x1.3300000000000p+0, -0x1.740f8f54037a5p-3},
    {0x1.3180000000000p+0, -0x1.6a079d0f7aad2p-3}, {0x1.3000000000000p+0, -0x1.5ff3070a793d4p-3},
    {0x1.2e80000000000p+0, -0x1.55d1ad4232d6fp-3}, {0x1.2d80000000000p+0, -0x1.4f099f4a230b2p-3},
    {0x1.2c00000000000p+0, -0x1.44d2b6ccb7d1ep-3}, {0x1.2a80000000000p+0, -0x1.3a8eb2d31a376p-3},
    {0x1.2900000000000p+0, -0x1.303d718e47fd3p-3}, {0x1.2800000000000p+0, -0x1.29552f81ff523p-3},
    {0x1.2680000000000p+0, -0x1.1eed90e2dc2c3p-3}, {0x1.2500000000000p+0, -0x1.14785846742acp-3},
    {0x1.2400000000000p+0, -0x1.0d77e7cd08e59p-3}, {0x1.2280000000000p+0, -0x1.02ebb42bf3d4bp-3},
    {0x1.2180000000000p+0, -0x1.f7b79fec37ddfp-4}, {0x1.2000000000000p+0, -0x1.e27076e2af2e6p-4},
    {0x1.1f00000000000p+0, -0x1.d4313d66cb35dp-4}, {0x1.1d80000000000p+0, -0x1.beba818146765p-4},
    {0x1.1c80000000000p+0, -0x1.b05b49bee43fep-4}, {0x1.1b00000000000p+0, -0x1.9ab42462033adp-4},
    {0x1.1a00000000000p+0, -0x1.8c345d6319b21p-4}, {0x1.1880000000000p+0, -0x1.765bf23a6be13p-4},
    {0x1.1780000000000p+0, -0x1.67bb0726ec0fcp-4}, {0x1.1680000000000p+0, -0x1.590cafdf01c28p-4},
    {0x1.1500000000000p+0, -0x1.42edcbea646f0p-4}, {0x1.1400000000000p+0, -0x1.341d7961bd1d1p-4},
    {0x1.1300000000000p+0, -0x1.253f62f0a1417p-4}, {0x1.1180000000000p+0, -0x1.0ed839b5526fep-4},
    {0x1.1080000000000p+0, -0x1.ffae9119b9303p-5}, {0x1.0f80000000000p+0, -0x1.e19070c276016p-5},
    {0x1.0e80000000000p+0, -0x1.c355dd0921f2dp-5}, {0x1.0d00000000000p+0, -0x1.95c830ec8e3ebp-5},
    {0x1.0c00000000000p+0, -0x1.77458f632dcfcp-5}, {0x1.0b00000000000p+0, -0x1.58a5bafc8e4d5p-5},
    {0x1.0a00000000000p+0, -0x1.39e87b9febd60p-5}, {0x1.0900000000000p+0, -0x1.1b0d98923d980p-5},
    {0x1.0780000000000p+0, -0x1.d91a66c543cc4p-6}, {0x1.0680000000000p+0, -0x1.9ace7551cc514p-6},
    {0x1.0580000000000p+0, -0x1.5c45a51b8d389p-6}, {0x1.0480000000000p+0, -0x1.1d7f7eb9eebe7p-6},
    {0x1.0380000000000p+0, -0x1.bcf712c74384cp-7}, {0x1.0280000000000p+0, -0x1.3e7295d25a7d9p-7},
    {0x1.0180000000000p+0, -0x1.7ee11ebd82e94p-8}, {0x1.0000000000000p+0, 0x0.0p+0},
};

// log1p(r) = r + r^2 (-1/2 + r/3 - r^2/4 + r^3/5 - r^4/6 + r^5/7), in
// Horner order, then ln 2: in the constant bank, where the fp64 instructions
// read them as operands.
__constant__ double kLog1p[7] = {1.0 / 7.0,  -1.0 / 6.0, 1.0 / 5.0,
                                 -1.0 / 4.0, 1.0 / 3.0,  -1.0 / 2.0,
                                 0x1.62e42fefa39efp-1};

// A block's copy of the table in shared memory (2 KB): a warp's 32 lanes
// gather from it in a few wavefronts.  Call before the block's first barrier.
__device__ __forceinline__ void load_log_table(LogEntry* tab) {
  for (int j = threadIdx.x; j < 128; j += blockDim.x) tab[j] = kNegLogTable[j];
}

__device__ __forceinline__ float neg_log_rn(float x, const LogEntry* tab) {
  const uint32_t b = __float_as_uint(x);
  // 2^e' with e' = e, or e + 1 where the mantissa's top bit is set, and
  // z = x / 2^e' in [0.75, 1.5)
  const uint32_t p2 = (b + 0x400000u) & 0xFF800000u;
  const uint32_t zb = b - p2 + 0x3F800000u;
  const double z = (double)__uint_as_float(zb);
  const double e = (double)((int)(p2 >> 23) - 127);
  const LogEntry t = tab[(b >> 16) & 127u];
  const double r = __fma_rn(z, t.c, -1.0);
  double q = __fma_rn(r, kLog1p[0], kLog1p[1]);
  q = __fma_rn(q, r, kLog1p[2]);
  q = __fma_rn(q, r, kLog1p[3]);
  q = __fma_rn(q, r, kLog1p[4]);
  q = __fma_rn(q, r, kLog1p[5]);
  const double p = __fma_rn(__dmul_rn(r, r), q, r);
  const double y = -__fma_rn(e, kLog1p[6], __dadd_rn(t.neg_log_c, p));
  return __double2float_rn(y);
}

// The decode's argument x = fp32(fp32(w1 >> 8) * 2^-24) + 2^-25, in (0, 1].
__device__ __forceinline__ float decode_x(uint32_t w1) {
  const float u = __fmul_rn(__uint2float_rn(w1 >> 8), 5.9604644775390625e-08f);
  return __fadd_rn(u, 2.98023223876953125e-08f);
}

// eta by the table (the multistep kernels, B1 and B3)
__device__ __forceinline__ float eta_from_w1(uint32_t w1,
                                             const LogEntry* tab) {
  return neg_log_rn(decode_x(w1), tab);
}

// eta by the fp64 library log (B2, whose occupancy leaves no registers for
// the table's arithmetic); the same float on every input
__device__ __forceinline__ float eta_from_w1(uint32_t w1) {
  return __double2float_rn(-log((double)decode_x(w1)));
}

// Eq. (1) causality against the +-1 neighbours (callers skip it in
// rd_mode).  The window rule, Eq. (3), is `t <= __fadd_rn(delta, gvt)`.
__device__ __forceinline__ bool causal_ok(float t, float lft, float rgt,
                                          bool is_left, bool is_right,
                                          int border_both) {
  // a border PE waits for the neighbour across its border; with
  // border_both a PE on either border waits for both
  const bool wait_l = is_left || (border_both && is_right);
  const bool wait_r = is_right || (border_both && is_left);
  return (!wait_l || t <= lft) && (!wait_r || t <= rgt);
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
