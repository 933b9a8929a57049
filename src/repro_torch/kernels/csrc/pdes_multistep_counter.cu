// K fused exact-GVT PDES steps on full periodic rings, with the event stream
// generated in the kernel.  CUDA C++ for Hopper (sm_90a), plain C interface,
// loaded with ctypes by repro_torch/kernels/pdes_multistep.py.
//
// Replaces the TPU kernel src/repro/kernels/pdes_multistep.py::
// pdes_multistep_counter (body _kernel_counter, step _fused_step).  It
// computes the same thing, not the same blocks: the TPU kernel walks a
// sequential K grid axis and revisits its tau tile; here one block owns one
// ring row for all K steps, with a `for k` loop inside the block.
//
// The words of PE i of row r at step k:
//   w0, w1 = counter_words(seed, step0 + k, trial_r, l0 + i)
//   trial_r = trial_col[r] if given, else b0 + r (uint32, wrapping)
// and its window width delta_col[r] if given, else the static delta (inf =
// off).  The step itself -- decode, GVT, Eq. (1) and Eq. (3), the moments,
// the ring double-buffered in shared memory (L <= 28,928; the wrapper
// raises above it) -- is the loop of pdes_ring.cuh, which B3 shares.
//
// Bound on the H100 SXM (published peaks; 132 SMs at 1.98 GHz), at the
// service's shape B = 448 rings of L = 10,000 PEs, K = 16 steps per launch
// (71.7M PE-steps):
//   bytes       tau read once and written once (8 * B * L), the six (K, B)
//               moment planes and the two (B, 1) columns: 36.0 MB, 0.011 ms
//               at 3.35 TB/s.  No event bits ever touch device memory.
//   operations  per PE-step 23 integer (the PE's absorb round and word 0:
//               two fmix32 rounds of eight plus four, the % n_v, two border
//               compares) and 11 fp32 (three rule compares, the moments,
//               the sumabs pass); per PE that updates 15 more (word 1: ten
//               integer; the decode and the add: four fp32; the fp64 log,
//               counted as one).  chip_smoke.py divides them by 67 T/s, the
//               fp32 rate outside the tensor cores: 0.047 ms at u = 0.64.
//   issue rates the int32 rate is half of that, 64 lanes per SM per clock
//               (16.7 T/s), and % by a runtime n_v takes ~15 instructions:
//               ~38 int32 instructions per PE-step give 0.16 ms.  The fp64
//               rate is also 64 lanes per SM per clock: a double log of ~25
//               instructions per update adds ~0.07 ms in its own pipe.
// So operations bound it -- the integer hash and the site pick -- and not
// bytes.  This first version is simple rather than fast: one ring per
// 512-thread block, three block barriers and six reductions per step, two
// blocks per SM at L = 10,000 (shared memory).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pdes_common.cuh"  // hash, decode
#include "pdes_ring.cuh"    // the K-step ring loop B1 and B3 share

namespace {

// The counter stream: the first three absorb rounds are constant along a
// row and step; a PE's word 1 is hashed only where the PE updates.
struct CounterEvents {
  struct Event {
    uint32_t h, w0;
    __device__ uint32_t w1() const { return mix32(h ^ 0xB5297A4Du); }
  };
  struct Step {
    uint32_t hrow, l0;
    __device__ Event at(int i) const {
      const uint32_t h = mix32(hrow ^ ((l0 + (uint32_t)i) * 0xD3A2646Cu));
      return {h, mix32(h ^ 0x68E31DA4u)};
    }
  };
  uint32_t seed, step0, trial, l0;
  __device__ Step step(int k) const {
    return {row_hash(seed, step0 + (uint32_t)k, trial), l0};
  }
};

__global__ void __launch_bounds__(kRingThreads)
multistep_counter_kernel(const float* __restrict__ tau_in,
                         float* __restrict__ tau_out,
                         float* __restrict__ stats,
                         const float* __restrict__ delta_col,
                         const uint32_t* __restrict__ trial_col,
                         int B, int L, int K,
                         uint32_t seed, uint32_t step0, uint32_t b0,
                         uint32_t l0, uint32_t n_v, float delta,
                         int rd_mode, int border_both) {
  const int row = blockIdx.x;
  const uint32_t trial = trial_col ? trial_col[row] : b0 + (uint32_t)row;
  const float dlt = delta_col ? delta_col[row] : delta;
  const bool window_off = delta_col == nullptr && isinf(delta);
  ring_steps(tau_in, tau_out, stats, row, B, L, K, n_v, dlt, window_off,
             rd_mode, border_both, CounterEvents{seed, step0, trial, l0});
}

__global__ void decode_eta_kernel(const uint32_t* __restrict__ w1,
                                  float* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = eta_from_w1(w1[i]);
}

}  // namespace

extern "C" int pdes_multistep_counter_launch(
    const float* tau_in, float* tau_out, float* stats, const float* delta_col,
    const uint32_t* trial_col, int B, int L, int K, unsigned seed,
    unsigned step0, unsigned b0, unsigned l0, unsigned n_v, float delta,
    int rd_mode, int border_both, void* stream) {
  const int smem = 2 * L * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      multistep_counter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  multistep_counter_kernel<<<B, kRingThreads, smem, (cudaStream_t)stream>>>(
      tau_in, tau_out, stats, delta_col, trial_col, B, L, K, seed, step0, b0,
      l0, n_v, delta, rd_mode, border_both);
  return (int)cudaGetLastError();
}

extern "C" int decode_eta_launch(const uint32_t* w1, float* out, long long n,
                                 void* stream) {
  long long blocks = (n + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  if (blocks < 1) blocks = 1;
  decode_eta_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(w1, out, n);
  return (int)cudaGetLastError();
}
