// K fused exact-GVT PDES steps on full periodic rings, with the event words
// read from device memory one step at a time.  CUDA C++ for Hopper
// (sm_90a), plain C interface, loaded with ctypes by
// repro_torch/kernels/pdes_multistep.py.
//
// Replaces the TPU kernel src/repro/kernels/pdes_multistep.py::
// pdes_multistep (body _kernel_bits, step _fused_step).  The TPU kernel
// walks a sequential K grid axis, revisits its tau tile and has Pallas bring
// in the (1, block_b, L, 2) bits block of each step; here one block owns one
// ring row for all K steps, with a `for k` loop inside the block, and its
// threads read the step's words straight from device memory, one 8-byte
// uint2 a PE, coalesced.
//
// The words of PE i of row r at step k are bits[k, r, i, 0:2] of the
// (K, B, L, 2) uint32 tensor (kernels/threefry.py writes them in this
// layout).  The window is a static delta (inf turns it off), as the TPU
// kernel takes it.  The step itself -- decode, GVT, Eq. (1) and Eq. (3),
// the moments, the ring double-buffered in shared memory (L <= 28,928; the
// wrapper raises above it) -- is the loop of pdes_ring.cuh, which B1
// shares, so the two kernels cannot drift apart.
//
// Bound on the H100 SXM (published peaks), at ops.simulate's chunk K = 16,
// B = 448 rings of L = 10,000 PEs (71.7M PE-steps):
//   bytes       the words read once (8 * K * B * L: 573.4 MB), tau read once
//               and written once (8 * B * L) and the six (K, B) moment
//               planes: 609.5 MB, 0.182 ms at 3.35 TB/s.
//   operations  per PE-step 14 (site pick, border compares, the rules, the
//               five moments, the sumabs pass); per PE that updates 6 more
//               (the decode, the fp64 log counted as one, the add): about
//               1.3e9, 0.02 ms at 67 T/s.
// So bytes bound it, by about nine times.  This first version is simple:
// the words are not prefetched, so each step's loads wait behind the
// previous step's barriers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pdes_ring.cuh"  // the K-step ring loop B1 and B3 share

namespace {

struct MemoryEvents {
  struct Event {
    uint32_t w0, y;
    __device__ uint32_t w1() const { return y; }
  };
  struct Step {
    const uint2* words;  // this step's row
    __device__ Event at(int i) const {
      const uint2 w = words[i];
      return {w.x, w.y};
    }
  };
  const uint2* bits;
  int B, L, row;
  __device__ Step step(int k) const {
    return {bits + ((size_t)k * B + row) * L};
  }
};

__global__ void __launch_bounds__(kRingThreads)
multistep_kernel(const float* __restrict__ tau_in,
                 const uint2* __restrict__ bits, float* __restrict__ tau_out,
                 float* __restrict__ stats, int B, int L, int K, uint32_t n_v,
                 float delta, int rd_mode, int border_both) {
  const int row = blockIdx.x;
  ring_steps(tau_in, tau_out, stats, row, B, L, K, n_v, delta, isinf(delta),
             rd_mode, border_both, MemoryEvents{bits, B, L, row});
}

}  // namespace

extern "C" int pdes_multistep_launch(const float* tau_in, const void* bits,
                                     float* tau_out, float* stats, int B,
                                     int L, int K, unsigned n_v, float delta,
                                     int rd_mode, int border_both,
                                     void* stream) {
  if (B < 1 || L < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int smem = 2 * L * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      multistep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  multistep_kernel<<<B, kRingThreads, smem, (cudaStream_t)stream>>>(
      tau_in, (const uint2*)bits, tau_out, stats, B, L, K, n_v, delta,
      rd_mode, border_both);
  return (int)cudaGetLastError();
}
