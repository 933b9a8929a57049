// One PDES step on a haloed chunk, with the window base given from outside.
// CUDA C++ for Hopper (sm_90a), plain C interface, loaded with ctypes by
// repro_torch/kernels/pdes_step.py.
//
// Replaces the TPU kernel src/repro/kernels/pdes_step.py::pdes_step (body
// _kernel).  The TPU kernel tiles rows into VMEM blocks of block_b rows with
// the whole haloed lane dimension per tile; here one block owns one row and
// its threads stride over the row, reading neighbours straight from the
// haloed row in device memory.  Nothing lives in shared memory but the
// reductions, so a row may be of any length (unlike B1's shared-memory ring).
//
// For every PE i of row r (tau_h is (B, Lc + 2), PE i at column i + 1):
//   words  w0, w1 = bits[r, i] (one 8-byte uint2, from counter_bits_block on
//          the host)
//   decode site = w0 % n_v (borders 0 and n_v - 1), by a multiply-high
//          with the block's reciprocal of n_v (pdes_common.cuh),
//          eta  = fp32(-log(fp64(fp32(fp32(w1 >> 8) * 2^-24) + 2^-25)))
//          by the library log (the multistep kernels' table decode would
//          take this kernel past the 32 registers its occupancy needs)
//   update Eq. (1) causality against tau_h[r, i] and tau_h[r, i + 2]
//          (unless rd_mode) and Eq. (3) window t <= (delta + gvt[r]), one
//          fp32 add; a static delta of inf turns the window rule off.  The
//          engine folds a per-row delta column into gvt and passes delta = 0.
//   moments ucount, min, max, sum, sumsq; then sumabs about sum / Lc in a
//          second pass that re-reads tau' (this thread's own writes, from
//          L2), as horizon.ring_moments does.
// Moment m of row r goes to stats[m * B + r].  The rules are those of B1,
// from pdes_common.cuh.
//
// Bound on the H100 SXM (published peaks), at the main path's shape B = 448
// rows of Lc = 10,000 PEs:
//   bytes       tau_h read once (4 * B * (Lc + 2)), the bits (8 * B * Lc),
//               tau' written once (4 * B * Lc), the gvt column and the six
//               moment rows: 71.7 MB, 0.0214 ms at 3.35 TB/s.
//   operations  per PE 14 (site pick, border compares, the rules, the five
//               moments, the sumabs pass); per PE that updates 6 more (the
//               decode, the fp64 log counted as one, the add).  At u = 0.64
//               that is 8.0e7, 0.0012 ms at 67 T/s.
// So bytes bound it, by about twenty times.  This first version is simple:
// 512 threads a row, plain coalesced loads (three of tau_h per PE, the two
// neighbours served by L1), two block barriers per reduction.  What the
// step costs end to end is the host-side work around it (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pdes_common.cuh"  // site pick, decode, causality, reductions

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
pdes_step_kernel(const float* __restrict__ tau_h,
                 const uint2* __restrict__ bits,
                 const float* __restrict__ gvt,
                 float* __restrict__ tau_out,
                 float* __restrict__ stats,
                 int B, int Lc, uint32_t n_v, float delta,
                 int rd_mode, int border_both) {
  __shared__ float red_min[kWarps], red_max[kWarps];
  __shared__ float red_sum[kWarps], red_sumsq[kWarps], red_abs[kWarps];
  __shared__ unsigned red_cnt[kWarps];
  __shared__ float row_sum;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* src = tau_h + (size_t)row * (Lc + 2);
  const uint2* words = bits + (size_t)row * Lc;
  float* dst = tau_out + (size_t)row * Lc;
  const bool window_off = isinf(delta);
  const float bound = __fadd_rn(delta, gvt[row]);
  const SiteDivisor div = site_divisor(n_v);

  unsigned cnt = 0;
  float lmn = INFINITY, lmx = -INFINITY, s = 0.f, ss = 0.f;
  for (int i = tid; i < Lc; i += kThreads) {
    const uint2 w = words[i];
    bool is_left, is_right;
    site_pick(w.x, div, is_left, is_right);
    const float t = src[i + 1];
    bool ok = true;
    if (!rd_mode) ok = causal_ok(t, src[i], src[i + 2], is_left, is_right,
                                 border_both);
    const bool upd = ok && (window_off || t <= bound);
    float tn = t;
    if (upd) tn = __fadd_rn(t, eta_from_w1(w.y));
    dst[i] = tn;
    cnt += upd ? 1u : 0u;
    lmn = fminf(lmn, tn);
    lmx = fmaxf(lmx, tn);
    s = __fadd_rn(s, tn);
    ss = __fmaf_rn(tn, tn, ss);
  }
  cnt = warp_sum_u(cnt);
  lmn = warp_min(lmn);
  lmx = warp_max(lmx);
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    red_cnt[warp] = cnt;
    red_min[warp] = lmn;
    red_max[warp] = lmx;
    red_sum[warp] = s;
    red_sumsq[warp] = ss;
  }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < kWarps;
    unsigned c = warp_sum_u(live ? red_cnt[lane] : 0u);
    float a = warp_min(live ? red_min[lane] : INFINITY);
    float b = warp_max(live ? red_max[lane] : -INFINITY);
    float d = warp_sum(live ? red_sum[lane] : 0.f);
    float e = warp_sum(live ? red_sumsq[lane] : 0.f);
    if (lane == 0) {
      row_sum = d;
      stats[0 * (size_t)B + row] = (float)c;
      stats[1 * (size_t)B + row] = a;
      stats[2 * (size_t)B + row] = b;
      stats[3 * (size_t)B + row] = d;
      stats[4 * (size_t)B + row] = e;
    }
  }
  __syncthreads();
  const float mean = __fdiv_rn(row_sum, (float)Lc);
  float sa = 0.f;
  for (int i = tid; i < Lc; i += kThreads)
    sa = __fadd_rn(sa, fabsf(__fsub_rn(dst[i], mean)));
  sa = warp_sum(sa);
  if (lane == 0) red_abs[warp] = sa;
  __syncthreads();
  if (warp == 0) {
    float v = warp_sum(lane < kWarps ? red_abs[lane] : 0.f);
    if (lane == 0) stats[5 * (size_t)B + row] = v;
  }
}

}  // namespace

extern "C" int pdes_step_launch(const float* tau_h, const void* bits,
                                const float* gvt, float* tau_out,
                                float* stats, int B, int Lc, unsigned n_v,
                                float delta, int rd_mode, int border_both,
                                void* stream) {
  if (B < 1 || Lc < 1) return (int)cudaErrorInvalidValue;
  pdes_step_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      tau_h, (const uint2*)bits, gvt, tau_out, stats, B, Lc, n_v, delta,
      rd_mode, border_both);
  return (int)cudaGetLastError();
}
