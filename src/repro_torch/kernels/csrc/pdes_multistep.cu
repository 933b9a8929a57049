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
// the moments, the ring held once in shared memory, in one block up to
// L = 57,344 and over up to 132 blocks of a cooperative grid up to
// L = 7,518,720 (kernels/tiling.py ring_plan; the wrapper raises above it)
// -- is the loop of pdes_ring.cuh, which B1 shares, so the two kernels
// cannot drift apart.
//
// Bound on the H100 SXM (published peaks), at ops.simulate's chunk K = 16,
// B = 448 rings of L = 10,000 PEs (71.7M PE-steps):
//   bytes       the words read once (8 * K * B * L: 573.4 MB), tau read once
//               and written once (8 * B * L) and the six (K, B) moment
//               planes: 609.5 MB, 0.182 ms at 3.35 TB/s.
//   operations  per PE-step 14 (site pick, border compares, the rules, the
//               five moments, sumabs); per PE that updates 6 more (the
//               decode, the log counted as one, the add): about 1.3e9,
//               0.02 ms at 67 T/s.
// So bytes bound it, by about nine times.  The words stream while the block
// computes and waits: each warp keeps the next group of kAhead rows' words
// in flight (a load issued a group ahead, across the step's barrier into
// the next step's first rows), 32 KB an SM at 32 warps, with the streaming
// hint, since each word is read once.  The step's own instructions (the
// table decode, the rules, the moments) then take about as long as the
// words (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pdes_ring.cuh"  // the K-step ring loop B1 and B3 share

namespace {

// The words of step k, row r are the (L, 2) uint32 block at
// bits[k, r]; a lane fetches its PE's 8-byte uint2 kAhead rows ahead, with
// the streaming hint (each word is read once).
struct MemoryEvents {
  static constexpr int kAhead = 4;
  using Word = uint2;
  struct Event {
    uint32_t w0, y;
    __device__ uint32_t w1() const { return y; }
  };
  struct Step {};
  const uint2* bits;
  int B, L, row;
  __device__ Word fetch(int k, int i) const {
    return __ldcs(bits + ((size_t)k * B + row) * L + i);
  }
  __device__ Step step(int) const { return {}; }
  __device__ Event at(const Step&, const Word& w, int) const {
    return {w.x, w.y};
  }
};

template <bool kRd, bool kBoth>
__global__ void __launch_bounds__(32 * kRingMaxWarps, kRingMinBlocks)
multistep_kernel(const float* __restrict__ tau_in,
                 const uint2* __restrict__ bits, float* __restrict__ tau_out,
                 float* __restrict__ stats, int B, int L, int K, uint32_t n_v,
                 float delta) {
  const int row = blockIdx.x;
  ring_steps<kRd, kBoth, RingTier::kBlock>(tau_in, tau_out, stats, row, B,
                                           L, K, n_v, delta,
                                           MemoryEvents{bits, B, L, row});
}

// The same on rings split over `grid` blocks of one cooperative launch,
// `seg` PEs a block: the gridDim.x / grid ring slots take the rows in
// waves, the blocks of a slot meeting through `work` (pdes_ring.cuh).
template <bool kRd, bool kBoth>
__global__ void __launch_bounds__(32 * kRingSplitWarps, 1)
multistep_grid_kernel(const float* __restrict__ tau_in,
                      const uint2* __restrict__ bits,
                      float* __restrict__ tau_out,
                      float* __restrict__ stats, int B, int L, int K,
                      uint32_t n_v, float delta, int grid, int seg,
                      unsigned* work) {
  for (int row = blockIdx.x / grid; row < B; row += gridDim.x / grid)
    ring_steps<kRd, kBoth, RingTier::kGrid>(
        tau_in, tau_out, stats, row, B, L, K, n_v, delta,
        MemoryEvents{bits, B, L, row}, grid, seg, work);
}

}  // namespace

// Launches B3 with kernels/tiling.py::ring_plan(L, stream=False): `grid`
// blocks a ring of `warps` warps and `seg` PEs each, all of them kept in
// shared memory (keep == seg).  One block (grid == 1, seg == L) takes the
// block instantiation; more take the grid one, as one cooperative launch
// of the rings the card holds at once, `work` the workspace (unread on one
// block).  Returns a CUDA error code: a plan this kernel cannot run returns
// cudaErrorInvalidValue, and a launch the card refuses its error
// (pdes_ring.cuh ring_block_launch, ring_grid_launch).
extern "C" int pdes_multistep_launch(const float* tau_in, const void* bits,
                                     float* tau_out, float* stats, int B,
                                     int L, int K, int warps, int grid,
                                     int seg, int keep, unsigned n_v,
                                     float delta, int rd_mode,
                                     int border_both, void* work,
                                     long long work_bytes, void* stream) {
  if (keep != seg) return (int)cudaErrorInvalidValue;  // no stream tier
  if (grid == 1)
    return ring_block_launch(
        ring_kernel(rd_mode, border_both, multistep_kernel<true, false>,
                    multistep_kernel<false, true>,
                    multistep_kernel<false, false>),
        B, L, K, warps, seg, keep, stream, tau_in, (const uint2*)bits,
        tau_out, stats, B, L, K, (uint32_t)n_v, delta);
  return ring_grid_launch(
      ring_kernel(rd_mode, border_both, multistep_grid_kernel<true, false>,
                  multistep_grid_kernel<false, true>,
                  multistep_grid_kernel<false, false>),
      B, L, K, warps, grid, seg, seg, work, work_bytes, stream, tau_in,
      (const uint2*)bits, tau_out, stats, B, L, K, (uint32_t)n_v, delta, grid,
      seg);
}

// The rings of B3's plan (`grid` blocks of `warps` warps, `seg` PEs each,
// all `keep` == seg in shared memory) that the card holds at once, on the
// instantiation pdes_multistep_launch takes for it, or minus a CUDA error
// code.
extern "C" int pdes_multistep_max_rings(int grid, int warps, int seg,
                                        int keep) {
  if (keep != seg) return -(int)cudaErrorInvalidValue;
  const int smem = keep * (int)sizeof(float);
  if (grid == 1)
    return ring_max_rings(multistep_kernel<false, false>, grid, warps, smem);
  return ring_max_rings(multistep_grid_kernel<false, false>, grid, warps,
                        smem);
}
