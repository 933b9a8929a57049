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
// the ring held once in shared memory, in one block up to L = 57,344,
// over up to 132 blocks of a cooperative grid up to L = 7,518,720, and over
// 132 such blocks that keep the rest of their segments in device memory up
// to L = 2,147,481,600 (kernels/tiling.py ring_plan; the wrapper raises
// above it) -- is the loop of pdes_ring.cuh, which B3 shares up to the
// grid tier.
//
// Bound on the H100 SXM (published peaks; 132 SMs at 1.98 GHz), at the
// service's shape B = 448 rings of L = 10,000 PEs, K = 16 steps per launch
// (71.7M PE-steps):
//   bytes       tau read once and written once (8 * B * L), the six (K, B)
//               moment planes and the two (B, 1) columns: 36.0 MB, 0.011 ms
//               at 3.35 TB/s.  No event bits ever touch device memory.
//   operations  per PE-step 23 integer (the PE's absorb round and word 0:
//               two fmix32 rounds of eight plus four, the site pick, two
//               border compares) and 11 fp32 (three rule compares, the
//               moments, sumabs); per PE that updates 15 more (word 1: ten
//               integer; the decode and the add: four fp32; the log,
//               counted as one).  chip_smoke.py divides them by 67 T/s, the
//               fp32 rate outside the tensor cores: 0.047 ms at u = 0.64.
// What holds it back is instruction issue, not either bound: the compiled
// step spends several instructions on each counted operation (the fp64
// decode, the hash's shifts and multiplies, addressing), many of them on
// the half-rate integer pipes, at 32 warps an SM (64 registers).  The
// design answers the costs of the earlier three-barrier loop (PERF.md, its
// ablation): one barrier a step and no second pass (pdes_ring.cuh); the
// table decode in place of the fp64 library log, its largest share; the
// site pick by a multiply-high; four rows of a warp stepped at once
// (kAhead); and 40 KB a ring, so all 448 rings are resident at once, four
// to an SM.
//
// A long ring, B = 448 rings of L = 131,072 PEs over 3 blocks of a
// cooperative grid (the service at the paper's large-L regime; 939.5M
// PE-steps a K = 16 chunk): bytes 470.0 MB (tau in and out), 0.140 ms;
// operations about 4.1e10 at u = 0.64, 0.61 ms at 67 T/s.  So the
// operations bound it, as at L = 10,000, and the same issue limit holds:
// one block of 32 warps an SM (a segment takes most of its shared memory)
// does the work of four one-block rings of 8, and one meeting a step over
// a segment of some 44,000 PEs costs little beside it (PERF.md).
//
// The paper's production ring, B = 8 rings of L = 2^20 PEs over 19 blocks
// of a cooperative grid (6 rings at once on 132 SMs, so two waves; 134.2M
// PE-steps a K = 16 chunk): bytes 67.1 MB, 0.020 ms; operations about
// 5.9e9 at u = 0.64, 0.087 ms at 67 T/s.  The operations bound it again;
// the blocks meet through L2 once a step, and 114 of 132 SMs work.
//
// A ring past shared memory, B = 14 rings of L = 2^23 PEs over the stream
// tier's 132 blocks of 63,552 PEs (one ring at a time, so 14 waves; 1.88e9
// PE-steps a K = 16 chunk): each block keeps 56,960 PEs in shared memory
// and 6,592 (10.4%) in device memory, which 4 of its 32 warps read and
// write each step: 8 bytes a PE-step there, 0.83 a PE-step of the ring,
// 1.56 GB a chunk that stays in L2 (the device rows of one ring are 3.5
// MB), against 0.94 GB of tau in and out a chunk.  Operations about 8.2e10
// at u = 0.64, 1.2 ms at 67 T/s: still the bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pdes_common.cuh"  // hash, decode
#include "pdes_ring.cuh"    // the K-step ring loop B1 and B3 share

namespace {

// The counter stream: the first three absorb rounds are constant along a
// row and step; a PE's word 1 is hashed only where the PE updates.  Nothing
// is fetched from memory.
struct CounterEvents {
  static constexpr int kAhead = 4;
  struct Word {};
  struct Event {
    uint32_t h, w0;
    __device__ uint32_t w1() const { return mix32(h ^ 0xB5297A4Du); }
  };
  struct Step {
    uint32_t hrow;
  };
  uint32_t seed, step0, trial, l0;
  __device__ Word fetch(int, int) const { return {}; }
  __device__ Step step(int k) const {
    return {row_hash(seed, step0 + (uint32_t)k, trial)};
  }
  __device__ Event at(const Step& st, const Word&, int i) const {
    const uint32_t h = mix32(st.hrow ^ ((l0 + (uint32_t)i) * 0xD3A2646Cu));
    return {h, mix32(h ^ 0x68E31DA4u)};
  }
};

template <bool kRd, bool kBoth>
__global__ void __launch_bounds__(32 * kRingMaxWarps, kRingMinBlocks)
multistep_counter_kernel(const float* __restrict__ tau_in,
                         float* __restrict__ tau_out,
                         float* __restrict__ stats,
                         const float* __restrict__ delta_col,
                         const uint32_t* __restrict__ trial_col,
                         int B, int L, int K,
                         uint32_t seed, uint32_t step0, uint32_t b0,
                         uint32_t l0, uint32_t n_v, float delta,
                         int rebase) {
  const int row = blockIdx.x;
  const uint32_t trial = trial_col ? trial_col[row] : b0 + (uint32_t)row;
  const float dlt = delta_col ? delta_col[row] : delta;
  ring_steps<kRd, kBoth, RingTier::kBlock>(
      tau_in, tau_out, stats, row, B, L, K, n_v, dlt,
      CounterEvents{seed, step0, trial, l0}, rebase);
}

// The same on rings split over `grid` blocks of one cooperative launch,
// `seg` PEs a block: the gridDim.x / grid ring slots take the rows in
// waves, the blocks of a slot meeting through `work` (pdes_ring.cuh).
template <bool kRd, bool kBoth>
__global__ void __launch_bounds__(32 * kRingSplitWarps, 1)
multistep_counter_grid_kernel(const float* __restrict__ tau_in,
                              float* __restrict__ tau_out,
                              float* __restrict__ stats,
                              const float* __restrict__ delta_col,
                              const uint32_t* __restrict__ trial_col,
                              int B, int L, int K,
                              uint32_t seed, uint32_t step0, uint32_t b0,
                              uint32_t l0, uint32_t n_v, float delta,
                              int rebase, int grid, int seg,
                              unsigned* work) {
  for (int row = blockIdx.x / grid; row < B; row += gridDim.x / grid) {
    const uint32_t trial = trial_col ? trial_col[row] : b0 + (uint32_t)row;
    const float dlt = delta_col ? delta_col[row] : delta;
    ring_steps<kRd, kBoth, RingTier::kGrid>(
        tau_in, tau_out, stats, row, B, L, K, n_v, dlt,
        CounterEvents{seed, step0, trial, l0}, rebase, grid, seg, work);
  }
}

// The same on rings of the stream tier: `grid` blocks of one cooperative
// launch, `seg` PEs a block, the first `keep` in shared memory and the rest
// in tau_out (pdes_ring.cuh).
template <bool kRd, bool kBoth>
__global__ void __launch_bounds__(32 * kRingSplitWarps, 1)
multistep_counter_stream_kernel(const float* __restrict__ tau_in,
                                float* __restrict__ tau_out,
                                float* __restrict__ stats,
                                const float* __restrict__ delta_col,
                                const uint32_t* __restrict__ trial_col,
                                int B, int L, int K,
                                uint32_t seed, uint32_t step0, uint32_t b0,
                                uint32_t l0, uint32_t n_v, float delta,
                                int rebase, int grid, int seg, int keep,
                                unsigned* work) {
  for (int row = blockIdx.x / grid; row < B; row += gridDim.x / grid) {
    const uint32_t trial = trial_col ? trial_col[row] : b0 + (uint32_t)row;
    const float dlt = delta_col ? delta_col[row] : delta;
    ring_steps<kRd, kBoth, RingTier::kStream>(
        tau_in, tau_out, stats, row, B, L, K, n_v, dlt,
        CounterEvents{seed, step0, trial, l0}, rebase, grid, seg, work,
        keep);
  }
}

// eta of every word by the kernels' table decode (`table`) or by the library
// log that B2 takes: a check of both on all inputs, not a path of the engine.
__global__ void decode_eta_kernel(const uint32_t* __restrict__ w1,
                                  float* __restrict__ out, long long n,
                                  int table) {
  __shared__ LogEntry tab[128];
  load_log_table(tab);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = table ? eta_from_w1(w1[i], tab) : eta_from_w1(w1[i]);
}

// The site of every word by the kernels' division-free pick: a check of it
// over many words on the card, not a path of the engine.
__global__ void site_pick_kernel(const uint32_t* __restrict__ w0,
                                 uint32_t* __restrict__ site, long long n,
                                 uint32_t n_v) {
  const SiteDivisor div = site_divisor(n_v);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    site[i] = site_of(w0[i], div);
}

}  // namespace

// Launches B1 with kernels/tiling.py::ring_plan(L): `grid` blocks a ring of
// `warps` warps and `seg` PEs each, of which a block keeps the first `keep`
// in shared memory.  One block (grid == 1, seg == keep == L) takes the
// block instantiation; more take one cooperative launch of the rings the
// card holds at once, `work` the workspace (pdes_ring.cuh ring_grid_bytes
// of them; unread on one block): the grid instantiation where keep == seg,
// else the stream one.  `rebase` writes tau out less each ring's minimum
// after the last step (the last `min` plane).  Returns a CUDA error code: a
// plan this kernel cannot run returns cudaErrorInvalidValue, and a launch
// the card refuses its error (pdes_ring.cuh ring_block_launch,
// ring_grid_launch).
extern "C" int pdes_multistep_counter_launch(
    const float* tau_in, float* tau_out, float* stats, const float* delta_col,
    const uint32_t* trial_col, int B, int L, int K, int warps, int grid,
    int seg, int keep, unsigned seed, unsigned step0, unsigned b0,
    unsigned l0, unsigned n_v, float delta, int rd_mode, int border_both,
    int rebase, void* work, long long work_bytes, void* stream) {
  if (grid == 1)
    return ring_block_launch(
        ring_kernel(rd_mode, border_both,
                    multistep_counter_kernel<true, false>,
                    multistep_counter_kernel<false, true>,
                    multistep_counter_kernel<false, false>),
        B, L, K, warps, seg, keep, stream, tau_in, tau_out, stats, delta_col,
        trial_col, B, L, K, (uint32_t)seed, (uint32_t)step0, (uint32_t)b0,
        (uint32_t)l0, (uint32_t)n_v, delta, rebase);
  if (keep == seg)
    return ring_grid_launch(
        ring_kernel(rd_mode, border_both,
                    multistep_counter_grid_kernel<true, false>,
                    multistep_counter_grid_kernel<false, true>,
                    multistep_counter_grid_kernel<false, false>),
        B, L, K, warps, grid, seg, seg, work, work_bytes, stream, tau_in,
        tau_out, stats, delta_col, trial_col, B, L, K, (uint32_t)seed,
        (uint32_t)step0, (uint32_t)b0, (uint32_t)l0, (uint32_t)n_v, delta,
        rebase, grid, seg);
  return ring_grid_launch(
      ring_kernel(rd_mode, border_both,
                  multistep_counter_stream_kernel<true, false>,
                  multistep_counter_stream_kernel<false, true>,
                  multistep_counter_stream_kernel<false, false>),
      B, L, K, warps, grid, seg, keep, work, work_bytes, stream, tau_in,
      tau_out, stats, delta_col, trial_col, B, L, K, (uint32_t)seed,
      (uint32_t)step0, (uint32_t)b0, (uint32_t)l0, (uint32_t)n_v, delta,
      rebase, grid, seg, keep);
}

// The rings of B1's plan (`grid` blocks of `warps` warps, `seg` PEs each,
// the first `keep` in shared memory) that the card holds at once, on the
// instantiation pdes_multistep_counter_launch takes for it, or minus a CUDA
// error code.
extern "C" int pdes_multistep_counter_max_rings(int grid, int warps, int seg,
                                                int keep) {
  const int smem = keep * (int)sizeof(float);
  if (grid == 1)
    return ring_max_rings(multistep_counter_kernel<false, false>, grid, warps,
                          smem);
  if (keep == seg)
    return ring_max_rings(multistep_counter_grid_kernel<false, false>, grid,
                          warps, smem);
  return ring_max_rings(multistep_counter_stream_kernel<false, false>, grid,
                        warps, smem);
}

extern "C" int decode_eta_launch(const uint32_t* w1, float* out, long long n,
                                 int table, void* stream) {
  long long blocks = (n + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  if (blocks < 1) blocks = 1;
  decode_eta_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(w1, out, n,
                                                                   table);
  return (int)cudaGetLastError();
}

extern "C" int site_pick_launch(const uint32_t* w0, uint32_t* site,
                                long long n, unsigned n_v, void* stream) {
  long long blocks = (n + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  if (blocks < 1) blocks = 1;
  site_pick_kernel<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(w0, site, n,
                                                                  n_v);
  return (int)cudaGetLastError();
}
