// The K-step exact-GVT loop on one full ring, shared by the two multistep
// kernels: pdes_multistep_counter.cu (B1, the counter stream hashed in the
// kernel) and pdes_multistep.cu (B3, the words read from device memory).
// They differ only in where a PE's two event words come from, which the
// `Events` template argument supplies:
//
//   struct Events {
//     static constexpr int kAhead;   // rows a warp steps at once, and
//                                    // keeps the words of in flight
//     struct Word;                   // what a lane fetches for one PE
//     // issue the fetch of PE i's word at step k (B3: a load; B1: nothing)
//     __device__ Word fetch(int k, int i) const;
//     // the per-step constants of step k (B1: the row hash)
//     __device__ Step step(int k) const;
//     // the event of PE i: `.w0` (site pick) and `.w1()` (eta), the second
//     // asked for only where the PE updates
//     __device__ Event at(const Step&, const Word&, int i) const;
//   };
//
// The step, for every PE i of the ring:
//   decode site = w0 % n_v (borders 0 and n_v - 1; pdes_common.cuh takes
//          it by a multiply-high),
//          eta  = fp32(-log(fp64(fp32(fp32(w1 >> 8) * 2^-24) + 2^-25)))
//          (pdes_common.cuh takes the log from a table, the same floats)
//   GVT    = min of the ring before the step (the previous step's `min`)
//   update Eq. (1) causality against the +-1 neighbours (unless rd_mode)
//          and Eq. (3) window tau <= (delta + GVT), one fp32 add
//   moments ucount, min, max, sum, sumsq, and sumabs about sum / L, as
//          horizon.ring_moments does.
// Moment m of step k, row r goes to stats[(m * K + k) * B + r].
//
// Layout.  One block owns one ring for all K steps, with W warps (a power of
// two from kernels/tiling.py::ring_warps, a function of L alone).  The ring
// is cut into rows of 32 PEs; warp w owns the consecutive rows
// [w R / W, (w + 1) R / W) of the R = ceil(L / 32), and lane l of row p is
// PE 32 p + l, so every shared or global access of a row is 32 consecutive
// words.  tau lives once in dynamic shared memory (4 L bytes; L <= 57,344,
// kernels/tiling.py MAX_RING_L) and is updated in place: a warp takes its
// rows in groups of kAhead, reads a group's tau and the +-1 neighbours
// from shared memory, and only then stores the previous group's new tau
// (one group late, behind a __syncwarp), so every read sees the step's old
// values.  Only the first and last PE of a warp's rows need another warp's
// old value; the warp publishes them after its update, and its neighbours
// read them in the next step.  The groups at a warp's two ends take those
// edge values and mask the lanes past the ring's end; the groups between
// them carry no test at all.
//
// One barrier a step.  Each warp writes its partials of step k (ucount, min,
// max, sum, sumsq, the sumabs of step k - 1 and its two edge PEs) into the
// slot of k's parity, then __syncthreads(); then every warp reduces the W
// partials itself (warp 0 all of them, the others the min and the sum), so
// all hold the next GVT and the ring mean without a second barrier, and
// lane 0 of warp 0 writes the stats.  A slot is written again two steps
// later, after the barrier that every reader of it has passed.  The sumabs
// of step k is summed in step k + 1's pass, whose first read of a PE is its
// tau after step k; one trailing pass after step K - 1, which also writes
// tau out, gives the last.  Sums are taken in row order per lane, then by a
// fixed xor tree over the lanes and over the W warps: the order depends on
// L alone (through W), never on B, the ring's row or its neighbours on the
// SM, so a ring's moments are the same whatever batch it runs in.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pdes_common.cuh"  // site pick, decode, causality, reductions

namespace {

// Most warps of a ring block (kernels/tiling.py RING_MAX_WARPS).
constexpr int kRingMaxWarps = 8;
// Blocks of 8 warps an SM should hold at once: 448 rings of L = 10,000 (40
// KB of shared memory each) then run in one wave on 132 SMs.
constexpr int kRingMinBlocks = 4;

// What warp w publishes at the end of a step, read by every warp after the
// step's barrier (parity slots: see above).
struct RingSlot {
  unsigned cnt[kRingMaxWarps];
  float mn[kRingMaxWarps], mx[kRingMaxWarps];
  float sum[kRingMaxWarps], sumsq[kRingMaxWarps], sumabs[kRingMaxWarps];
  float first[kRingMaxWarps], last[kRingMaxWarps];  // edge PEs' new tau
};

// The reduction of W (a power of two <= 32) warp partials by `op`, the
// same tree in every warp; every lane ends with the whole.
template <class T, class Op>
__device__ __forceinline__ T slot_reduce(const T* a, int W, int lane, Op op) {
  T v = a[lane & (W - 1)];
  for (int o = W >> 1; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

struct Add {
  template <class T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Min {
  __device__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Runs the K steps of block `row` (blockDim.x = 32 W).  `dlt` is the row's
// window width (inf turns the window off: tau <= inf + GVT holds).  kRd and
// kBoth are the rd_mode and border_both flags, fixed per instantiation so
// that the hot loop carries no test of them.
template <bool kRd, bool kBoth, class Events>
__device__ __forceinline__ void ring_steps(const float* __restrict__ tau_in,
                                           float* __restrict__ tau_out,
                                           float* __restrict__ stats,
                                           int row, int B, int L, int K,
                                           uint32_t n_v, float dlt,
                                           const Events& events) {
  constexpr int U = Events::kAhead;
  extern __shared__ float ring[];
  __shared__ RingSlot slot[2];
  __shared__ LogEntry tab[128];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  const int rows = (L + 31) >> 5;
  const int r0 = warp * rows / W;
  const int r1 = (warp + 1) * rows / W;
  const int first = 32 * r0;                      // this warp's PEs
  const int last = min(32 * r1, L) - 1;
  const int wl = warp == 0 ? W - 1 : warp - 1;    // the warps beside it
  const int wr = warp == W - 1 ? 0 : warp + 1;
  const SiteDivisor div = site_divisor(n_v);
  const size_t plane = (size_t)K * B;
  // Row slots per step, padded to whole groups of U: the word of slot s is
  // in buf[s % U], fetched U slots ahead across the step boundary.
  const int S = (r1 - r0 + U - 1) / U * U;

  // the words of step 0's first group (rows past the warp's, and lanes
  // past the ring's end, re-read a word in bounds)
  typename Events::Word buf[U];
#pragma unroll
  for (int j = 0; j < U; ++j)
    buf[j] = events.fetch(0, min(first + 32 * min(j, r1 - 1 - r0) + lane,
                                 L - 1));

  // load the decode's table and the ring, take the ring's minimum (the
  // first step's GVT) and publish the edge PEs, as a step -1 in slot 1
  load_log_table(tab);
  const float* src = tau_in + (size_t)row * L;
  float mn = INFINITY;
  for (int i = first + lane; i <= last; i += 32) {
    const float t = src[i];
    ring[i] = t;
    mn = fminf(mn, t);
    if (i == first) slot[1].first[warp] = t;
    if (i == last) slot[1].last[warp] = t;
  }
  mn = warp_min(mn);
  if (lane == 0) slot[1].mn[warp] = mn;
  __syncthreads();
  float gvt = slot_reduce(slot[1].mn, W, lane, Min{});
  float mean = 0.f;  // the ring mean after the previous step

  for (int k = 0; k < K; ++k) {
    const RingSlot& in = slot[(k + 1) & 1];
    RingSlot& out = slot[k & 1];
    const auto step = events.step(k);
    const float bound = __fadd_rn(dlt, gvt);
    const float lft_edge = in.last[wl];   // old tau left of PE `first`
    const float rgt_edge = in.first[wr];  // old tau right of PE `last`
    unsigned cnt = 0;
    float lmn = INFINITY, lmx = -INFINITY, s = 0.f, ss = 0.f, sa = 0.f;
    float pend[U];   // the previous group's new tau, stored one group late
    int pend_p = -1;

    // One PE's step from its old tau and its neighbours'; `live` masks the
    // lanes past the ring's end.
    auto pe_step = [&](float c, float l, float r, int i, bool live,
                       const typename Events::Word& w) {
      const auto ev = events.at(step, w, i);
      bool is_left, is_right;
      site_pick(ev.w0, div, is_left, is_right);
      const bool ok = kRd || causal_ok(c, l, r, is_left, is_right, kBoth);
      const bool upd = live && ok && c <= bound;
      const float tn = upd ? __fadd_rn(c, eta_from_w1(ev.w1(), tab)) : c;
      const float tl = live ? tn : 0.f;
      cnt += upd ? 1u : 0u;
      lmn = fminf(lmn, live ? tn : INFINITY);
      lmx = fmaxf(lmx, live ? tn : -INFINITY);
      s = __fadd_rn(s, tl);
      ss = __fmaf_rn(tl, tl, ss);
      // step k - 1's sumabs (discarded at k = 0)
      sa = __fadd_rn(sa, live ? fabsf(__fsub_rn(c, mean)) : 0.f);
      return tn;
    };

    for (int s0 = 0; s0 < S; s0 += U) {
      const int p0 = r0 + s0;
      float c[U], l[U], r[U];
      // The group's old tau and its neighbours', read from the ring before
      // the previous group's results are stored over them: in-place.
      const bool edge = s0 == 0 || p0 + U >= r1;  // warp-uniform
      if (edge) {  // the warp's first or last row, padding rows
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int i = 32 * (p0 + j) + lane;
          // no read leaves the warp's own PEs (another warp is updating
          // its own); the lanes past `last` read PE `last`
          const int ii = min(i, last);
          c[j] = ring[ii];
          l[j] = i == first ? lft_edge
                            : ring[i == first || i > last ? ii : ii - 1];
          r[j] = i == last ? rgt_edge : ring[i >= last ? ii : ii + 1];
        }
      } else {
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int i = 32 * (p0 + j) + lane;
          c[j] = ring[i];
          l[j] = ring[i - 1];
          r[j] = ring[i + 1];
        }
      }
      __syncwarp();  // every lane has read before any lane stores
      if (pend_p >= 0) {
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int i = 32 * (pend_p + j) + lane;
          if (i <= last) ring[i] = pend[j];
        }
      }
      // the next group's rows: later in this step, or the first of the next
      int q0 = s0 + U, kq = k;
      if (q0 >= S) q0 = 0, ++kq;
      // refill buf[j] with the word of the next group's row j, so the loads
      // stay in flight over this group's work and the barrier; past the
      // warp's rows or the last step they re-read a word in bounds
      const int kf = min(kq, K - 1);
      const int jmax = r1 - 1 - r0 - q0;
      const int i0 = 32 * (r0 + q0) + lane;
      auto refill = [&](int j) {
        buf[j] = events.fetch(kf, min(i0 + 32 * min(j, jmax), L - 1));
      };
      if (edge) {
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int i = 32 * (p0 + j) + lane;
          pend[j] = pe_step(c[j], l[j], r[j], i, i <= last, buf[j]);
          if (i == first) out.first[warp] = pend[j];
          if (i == last) out.last[warp] = pend[j];
          refill(j);
        }
      } else {  // interior rows: every lane live, no edge
#pragma unroll
        for (int j = 0; j < U; ++j) {
          pend[j] = pe_step(c[j], l[j], r[j], 32 * (p0 + j) + lane, true,
                            buf[j]);
          refill(j);
        }
      }
      pend_p = p0;
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int i = 32 * (pend_p + j) + lane;
      if (i <= last) ring[i] = pend[j];
    }
    cnt = warp_sum_u(cnt);
    lmn = warp_min(lmn);
    lmx = warp_max(lmx);
    s = warp_sum(s);
    ss = warp_sum(ss);
    sa = warp_sum(sa);
    if (lane == 0) {
      out.cnt[warp] = cnt;
      out.mn[warp] = lmn;
      out.mx[warp] = lmx;
      out.sum[warp] = s;
      out.sumsq[warp] = ss;
      out.sumabs[warp] = sa;
    }
    __syncthreads();
    gvt = slot_reduce(out.mn, W, lane, Min{});
    const float sum = slot_reduce(out.sum, W, lane, Add{});
    mean = __fdiv_rn(sum, (float)L);
    if (warp == 0) {
      const unsigned c = slot_reduce(out.cnt, W, lane, Add{});
      const float mx = slot_reduce(out.mx, W, lane, Max{});
      const float sq = slot_reduce(out.sumsq, W, lane, Add{});
      const float ab = slot_reduce(out.sumabs, W, lane, Add{});
      if (lane == 0) {
        const size_t at = (size_t)k * B + row;
        stats[0 * plane + at] = (float)c;
        stats[1 * plane + at] = gvt;
        stats[2 * plane + at] = mx;
        stats[3 * plane + at] = sum;
        stats[4 * plane + at] = sq;
        if (k > 0) stats[5 * plane + at - B] = ab;
      }
    }
  }

  // the last step's sumabs, and tau out
  float* dst = tau_out + (size_t)row * L;
  float sa = 0.f;
  for (int i = first + lane; i <= last; i += 32) {
    const float t = ring[i];
    dst[i] = t;
    sa = __fadd_rn(sa, fabsf(__fsub_rn(t, mean)));
  }
  sa = warp_sum(sa);
  RingSlot& out = slot[K & 1];
  if (lane == 0) out.sumabs[warp] = sa;
  __syncthreads();
  if (warp == 0) {
    const float ab = slot_reduce(out.sumabs, W, lane, Add{});
    if (lane == 0) stats[5 * plane + (size_t)(K - 1) * B + row] = ab;
  }
}

// The instantiation of a ring kernel for the runtime rule flags (rd_mode
// skips Eq. (1), so border_both does not matter there).
template <class Kernel>
Kernel ring_kernel(int rd_mode, int border_both, Kernel rd, Kernel both,
                   Kernel plain) {
  return rd_mode ? rd : border_both ? both : plain;
}

// Checks a ring kernel's launch shape (kernels/tiling.py::ring_warps gives
// `warps`) and sets its shared memory: the whole of it to shared memory, so
// that 4 L-byte rings pack an SM.  Returns the dynamic shared memory in
// bytes, or minus a CUDA error code (a ring too long for one block).
template <class Kernel>
int ring_launch_check(Kernel kernel, int B, int L, int K, int warps) {
  if (B < 1 || L < 1 || K < 1 || warps < 1 || warps > kRingMaxWarps ||
      (warps & (warps - 1)) != 0 || warps > (L + 31) / 32)
    return -(int)cudaErrorInvalidValue;
  const int smem = L * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) return smem;
  cudaGetLastError();  // leave no error behind for the next launch's check
  return -(int)err;
}

}  // namespace
