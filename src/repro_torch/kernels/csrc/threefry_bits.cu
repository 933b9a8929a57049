// The event words of jax.random's threefry stream for K consecutive steps.
// CUDA C++ for Hopper (sm_90a), plain C interface, loaded with ctypes by
// repro_torch/kernels/threefry.py.
//
// Not a port of a TPU kernel: JAX computes these bits in XLA, outside
// Pallas (repro/core/horizon.py: event_bits).  It exists so that the GPU
// path of ops.simulate and of the horizon drivers does not run threefry as
// ~150 elementwise int64 launches over the whole chunk.
//
// For step k = 0..K-1 and pair p = 0..P-1 (P = B * L PEs a step):
//   fk     = threefry2x32(key, (0, step0 + k))       fold_in(key, step)
//   word j = x0 ^ x1 of threefry2x32(fk, (n >> 32, n & 0xFFFFFFFF)),
//            n = 2 p + j                             jax.random.bits
//   out[k * P + p] = (word 0, word 1)                (K, B, L, 2) uint32
// The key is read from device memory (two int64-carried uint32 values), so
// a launch needs no host round trip.  Each thread folds its step's key once
// and then strides over several pairs.
//
// Bound on the H100 SXM (published peaks), at the main path's chunk K = 16,
// B = 448, L = 10,000 (143.4M words):
//   bytes       the words written once: 8 bytes a PE-step, 573.4 MB, 0.171 ms
//               at 3.35 TB/s (the key and step are a few bytes).
//   operations  73 integer operations a word (two key adds, 20 rounds of
//               add, rotate and xor, ten injection adds, the final xor):
//               1.05e10 lane-instructions, 0.31 ms at the issue limit of
//               128 lanes a clock on each of 132 SMs at 1.98 GHz
//               (3.3e13 a second).  The guide's 67 T/s counts the two
//               FLOPs of an fp32 FMA; an integer operation is one issue.
// So instruction issue bounds it, not bytes. Measured on an H100 80GB HBM3
// at 700 W (chip_smoke.py phase 6), it runs at about 0.35 of the bytes
// bound and about 0.64 of the issue limit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPairsPerThread = 4;

__global__ void __launch_bounds__(kThreads)
threefry_bits_kernel(const long long* __restrict__ key, uint32_t step0,
                     long long n_pairs, uint2* __restrict__ out) {
  const uint32_t k = blockIdx.y;
  const uint2 fk = threefry2x32((uint32_t)key[0], (uint32_t)key[1], 0u,
                                step0 + k);
  uint2* dst = out + (size_t)k * n_pairs;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
       p < n_pairs; p += stride) {
    // n = 2p is even, so n + 1 never carries into the high word
    const unsigned long long n = 2ull * (unsigned long long)p;
    const uint32_t hi = (uint32_t)(n >> 32);
    const uint32_t lo = (uint32_t)n;
    const uint2 a = threefry2x32(fk.x, fk.y, hi, lo);
    const uint2 b = threefry2x32(fk.x, fk.y, hi, lo + 1u);
    dst[p] = make_uint2(a.x ^ a.y, b.x ^ b.y);
  }
}

}  // namespace

extern "C" int threefry_bits_launch(const long long* key, unsigned step0,
                                    int n_steps, long long n_pairs, void* out,
                                    void* stream) {
  if (n_steps < 1 || n_steps > 65535 || n_pairs < 1)
    return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)kThreads * kPairsPerThread;
  long long blocks = (n_pairs + per_block - 1) / per_block;
  if (blocks > 65535) blocks = 65535;
  const dim3 grid((unsigned)blocks, (unsigned)n_steps);
  threefry_bits_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      key, step0, n_pairs, (uint2*)out);
  return (int)cudaGetLastError();
}

