// The K-step exact-GVT loop on one full ring, shared by the two multistep
// kernels: pdes_multistep_counter.cu (B1, the counter stream hashed in the
// kernel) and pdes_multistep.cu (B3, the words read from device memory).
// They differ only in where a PE's two event words come from, which the
// `Events` template argument supplies:
//
//   struct Events {
//     // the per-step source of step k (k = 0 .. K-1)
//     __device__ Step step(int k) const;
//   };
//   struct Step {
//     // the event of PE i: `.w0` (site pick) and `.w1()` (eta), the second
//     // asked for only where the PE updates
//     __device__ Event at(int i) const;
//   };
//
// One block owns one ring row for all K steps; tau and tau' are
// double-buffered in dynamic shared memory (8 * L bytes, so L <= 28,928:
// kernels/tiling.py MAX_RING_L).  Per step, for every PE i:
//   decode site = w0 % n_v (borders 0 and n_v - 1),
//          eta  = fp32(-log(fp64(fp32(fp32(w1 >> 8) * 2^-24) + 2^-25)))
//   GVT    = min of the ring before the step (the previous step's `min`)
//   update Eq. (1) causality against the +-1 neighbours (unless rd_mode)
//          and Eq. (3) window tau <= (delta + GVT), one fp32 add
//   moments ucount, min, max, sum, sumsq; then sumabs about sum / L in a
//          second pass over shared memory, as horizon.ring_moments does.
// Moment m of step k, row r goes to stats[(m * K + k) * B + r].
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pdes_common.cuh"  // site pick, decode, causality, reductions

namespace {

constexpr int kRingThreads = 512;
constexpr int kRingWarps = kRingThreads / 32;

// Runs the K steps of block `row`.  `dlt` is the row's window width;
// `window_off` skips the window rule (a static delta of inf).
template <class Events>
__device__ __forceinline__ void ring_steps(const float* __restrict__ tau_in,
                                           float* __restrict__ tau_out,
                                           float* __restrict__ stats,
                                           int row, int B, int L, int K,
                                           uint32_t n_v, float dlt,
                                           bool window_off, int rd_mode,
                                           int border_both,
                                           const Events& events) {
  extern __shared__ float ring[];
  float* cur = ring;
  float* nxt = ring + L;
  __shared__ float red_min[kRingWarps], red_max[kRingWarps];
  __shared__ float red_sum[kRingWarps], red_sumsq[kRingWarps];
  __shared__ float red_abs[kRingWarps];
  __shared__ unsigned red_cnt[kRingWarps];
  __shared__ float bcast[2];  // ring min (next GVT), ring sum

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // load the ring and take its minimum: the first step's GVT
  const float* src = tau_in + (size_t)row * L;
  float mn = INFINITY;
  for (int i = tid; i < L; i += kRingThreads) {
    const float t = src[i];
    cur[i] = t;
    mn = fminf(mn, t);
  }
  mn = warp_min(mn);
  if (lane == 0) red_min[warp] = mn;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kRingWarps ? red_min[lane] : INFINITY;
    v = warp_min(v);
    if (lane == 0) bcast[0] = v;
  }
  __syncthreads();
  float gvt = bcast[0];
  const size_t plane = (size_t)K * B;

  for (int k = 0; k < K; ++k) {
    const auto step = events.step(k);
    const float bound = __fadd_rn(dlt, gvt);
    unsigned cnt = 0;
    float lmn = INFINITY, lmx = -INFINITY, s = 0.f, ss = 0.f;
    for (int i = tid; i < L; i += kRingThreads) {
      const auto ev = step.at(i);
      bool is_left, is_right;
      site_pick(ev.w0, n_v, is_left, is_right);
      const float t = cur[i];
      bool ok = true;
      if (!rd_mode) {
        const float lft = cur[i == 0 ? L - 1 : i - 1];
        const float rgt = cur[i == L - 1 ? 0 : i + 1];
        ok = causal_ok(t, lft, rgt, is_left, is_right, border_both);
      }
      const bool upd = ok && (window_off || t <= bound);
      float tn = t;
      if (upd) tn = __fadd_rn(t, eta_from_w1(ev.w1()));
      nxt[i] = tn;
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
      const bool live = lane < kRingWarps;
      unsigned c = warp_sum_u(live ? red_cnt[lane] : 0u);
      float a = warp_min(live ? red_min[lane] : INFINITY);
      float b = warp_max(live ? red_max[lane] : -INFINITY);
      float d = warp_sum(live ? red_sum[lane] : 0.f);
      float e = warp_sum(live ? red_sumsq[lane] : 0.f);
      if (lane == 0) {
        bcast[0] = a;
        bcast[1] = d;
        const size_t at = (size_t)k * B + row;
        stats[0 * plane + at] = (float)c;
        stats[1 * plane + at] = a;
        stats[2 * plane + at] = b;
        stats[3 * plane + at] = d;
        stats[4 * plane + at] = e;
      }
    }
    __syncthreads();
    gvt = bcast[0];
    const float mean = __fdiv_rn(bcast[1], (float)L);
    float sa = 0.f;
    for (int i = tid; i < L; i += kRingThreads)
      sa = __fadd_rn(sa, fabsf(__fsub_rn(nxt[i], mean)));
    sa = warp_sum(sa);
    if (lane == 0) red_abs[warp] = sa;
    __syncthreads();
    if (warp == 0) {
      float v = warp_sum(lane < kRingWarps ? red_abs[lane] : 0.f);
      if (lane == 0) stats[5 * plane + (size_t)k * B + row] = v;
    }
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  float* dst = tau_out + (size_t)row * L;
  for (int i = tid; i < L; i += kRingThreads) dst[i] = cur[i];
}

}  // namespace
