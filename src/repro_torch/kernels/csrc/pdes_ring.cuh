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
//          and Eq. (3) window tau <= (delta + GVT), one fp32 add; the
//          stale window (kStale, B1 only) takes the chunk's first GVT, the
//          minimum of the input ring, for all K steps
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
// A longer ring (up to kernels/tiling.py MAX_GRID_RING_L) is cut into g
// segments (RingTier::kGrid; tiling.ring_plan gives g, the segment `seg`, a
// multiple of 32, and W), one block each: block rank j owns PEs
// [j seg, min((j + 1) seg, L)) in its shared memory and lays them out as a
// one-block ring lays out its own, and the events keep their ring-wide PE
// index.  A split block takes most of an SM's shared memory, so it runs 32
// warps, the warps of four one-block rings.  The g blocks of a ring are
// ordinary blocks of one cooperative launch, all resident at once: `rings`
// = gridDim.x / g ring slots, slot q = blockIdx.x / g taking rows q,
// q + rings, ... in turn (the batch in waves).  They meet through a
// workspace in global memory (RingGrid, read and written through L2 with
// ld/st.cg): a block reduces its W warp partials by the xor tree above, and
// warp 0 publishes that one block partial and its segment's two edge PEs in
// the ring's parity slot [parity][rank], then meets the ring's other blocks
// at a barrier (grid_barrier: an arrival counter that only grows,
// atom.release to arrive, a spin on ld.acquire), takes the neighbours' edge
// PEs into the block's own shared slot (where the next step's warps 0 and
// W - 1 read an edge, so the step's loop is the one-block ring's) and folds
// the g partials in rank order 0 ... g - 1, which gives the next GVT and,
// on rank 0, the step's six moments; a second block barrier hands GVT and
// the mean to the other warps.  The exact window needs the ring's minimum
// every step, so no step skips the meeting (nor does the stale one: the
// moments, the edge PEs and the last minimum).  The parity argument below
// (one barrier a step) holds across the blocks: a block rewrites slot
// k & 1 only after meeting k + 1, which every reader of step k's slot
// reaches only after reading it; a last meeting after the last sums keeps
// the slots valid until rank 0 has read them where another row follows on
// the slot.  A block partial a step, not 32 warp partials, so a block reads
// g values a step.  The one-block kernels are separate instantiations,
// which the grid code does not reach (if constexpr).
//
// B1 takes a ring longer still (up to kernels/tiling.py MAX_STREAM_RING_L;
// RingTier::kStream, tiling.ring_plan's `stream` tier) over the grid's g =
// 132 blocks as above, but a segment no longer fits a block's shared
// memory: a block keeps its first `keep` PEs (tiling.MAX_RING_SEG, whole
// rows) there and the rest in device memory, in its part of the output
// ring, updated in place as the shared part is.  Its first wk warps own the
// kr = keep / 32 shared rows and the other W - wk warps the rows past them
// (stream_warps: as many as their share of the rows, rounded up, at least
// one and at most W - 1), each split as above, so every warp's rows lie in
// one memory, which it reads and writes through one pointer; the edge PEs,
// the meeting and the sums are the grid tier's.  A warp of device rows
// reads its group's tau from L2 (or L1) and stores it back one group late,
// as in shared memory: __syncwarp orders a warp's global accesses as it
// does its shared ones.  A segment no longer than `keep` (the last one may
// be) takes no device warps.
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
// tau out, gives the last.  With `rebase` (B1 for the engine's chunk loop)
// that pass writes tau - GVT, GVT the ring's minimum after step K - 1 (the
// last `min` plane, which every block holds), one fp32 subtraction a PE:
// the chunk's rebase, which the engine would otherwise take in two more
// passes over tau; the sumabs is still taken on the unshifted tau.  Sums are
// taken in row order per lane, then by a fixed xor tree over the lanes and
// over the W warps (and over the g blocks in rank order): the order depends
// on L alone (through the plan), never on B, the ring's row or its
// neighbours on the SM, so a ring's moments are the same whatever batch it
// runs in.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pdes_common.cuh"  // site pick, decode, causality, reductions

namespace {

// Most warps of a ring block (kernels/tiling.py RING_MAX_WARPS).
constexpr int kRingMaxWarps = 8;
// Most warps of a block of a ring split over blocks (tiling.py
// RING_SPLIT_WARPS): one such block an SM, so up to 1024 threads.
constexpr int kRingSplitWarps = 32;
// Blocks of 8 warps an SM should hold at once: 448 rings of L = 10,000 (40
// KB of shared memory each) then run in one wave on 132 SMs.
constexpr int kRingMinBlocks = 4;

// Where the blocks of a ring meet: one block, or the blocks of a
// cooperative grid that keep their segments in shared memory or, on the
// stream tier, part of them in device memory (tiling.ring_plan).
enum class RingTier { kBlock, kGrid, kStream };

// What warp w publishes at the end of a step, read by every warp after the
// step's barrier (parity slots: see above), for blocks of up to kW warps.
template <int kW>
struct RingSlot {
  unsigned cnt[kW];
  float mn[kW], mx[kW];
  float sum[kW], sumsq[kW], sumabs[kW];
  float first[kW], last[kW];  // edge PEs' new tau
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

// What block `rank` of a ring over the grid publishes at a meeting: its
// partials and its segment's edge PEs' new tau.
struct GridPart {
  unsigned cnt;
  float mn, mx, sum, sumsq, sumabs;
  float first, last;
};

// One ring slot of a cooperative launch's workspace: its arrival counter
// and its parts [parity][rank] (ring_grid lays them out).
struct RingGrid {
  unsigned* bar;
  GridPart* part;
  bool more;   // another row follows on this slot
};

// Bytes of the workspace of `rings` slots of `g` blocks: a counter a slot,
// each on its own 128-byte line, then the parts.
inline size_t ring_grid_bytes(int rings, int g) {
  return (size_t)rings * 128 + (size_t)rings * 2 * g * sizeof(GridPart);
}

// The slot of this block's ring `row` of B in workspace `work` of a launch
// of rings of `g` blocks.  Built from the kernel's parameters where a
// meeting needs it, so that nothing of it stays live over the step's loop.
__device__ __forceinline__ RingGrid ring_grid(unsigned* work, int g, int row,
                                              int B) {
  const int rings = gridDim.x / g;
  const int q = blockIdx.x / g;
  GridPart* parts = reinterpret_cast<GridPart*>(work + 32 * rings);
  return {work + 32 * q, parts + (size_t)q * 2 * g, row + rings < B};
}

// The barrier of a ring's g blocks, met by warp 0 of each: lane 0 arrives
// (atom.release, ordered after its own stores of the block's part), and
// every lane spins on ld.acquire until the ring's g blocks have arrived.
// The counter only grows (zeroed before each launch): arrival n is one of
// barrier n / g, which is complete at (n / g + 1) g.
__device__ __forceinline__ void grid_barrier(unsigned* bar, int g, int lane) {
  unsigned n = 0;
  if (lane == 0)
    asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;"
                 : "=r"(n) : "l"(bar), "r"(1u) : "memory");
  const unsigned done = (__shfl_sync(kFull, n, 0) / (unsigned)g + 1u) *
                        (unsigned)g;
  unsigned v;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(bar) : "memory");
  } while (v < done);
}

// The reduction by `op` of the values `get(part + r)` of a ring's g blocks
// in an order that does not matter (min, max, a count), every lane ending
// with the whole.
template <class T, class Get, class Op>
__device__ __forceinline__ T grid_tree(const GridPart* part, int g, int lane,
                                       T v, Get get, Op op) {
  for (int r = lane; r < g; r += 32) v = op(v, get(part + r));
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The fold by `op` of the values `get(part + r)` in rank order r = 0 ...
// g - 1 (a float sum), 32 ranks at a time: lane l loads rank 32 j + l,
// then every lane folds the 32 through shuffles, so all end with the same
// value.  One value a lane: the meeting runs beside the words B3 keeps in
// flight over it.
template <class Get, class Op>
__device__ __forceinline__ float grid_fold(const GridPart* part, int g,
                                           int lane, Get get, Op op) {
  float v = 0.f;
  for (int j = 0; 32 * j < g; ++j) {
    const float x = 32 * j + lane < g ? get(part + 32 * j + lane) : 0.f;
    for (int l = 0; l < 32 && 32 * j + l < g; ++l) {
      const float y = __shfl_sync(kFull, x, l);
      v = j == 0 && l == 0 ? y : op(v, y);
    }
  }
  return v;
}

// What a meeting of a ring over the grid exchanges: the first GVT and the
// edge PEs (kInit), a step's partials and edge PEs (kStep), the last
// step's sumabs (kLast).
enum class Meet { kInit, kStep, kLast };

// A meeting of ring `row` over the grid of `g` blocks a ring (workspace
// `work`), at the end of a step whose warp partials are in `out`, with
// parity `par`: warp 0 reduces the block's W
// partials, publishes them (and the edge PEs), meets the ring's blocks,
// takes the neighbours' edge PEs into `out` (the left one as the last
// warp's last PE, the right one as warp 0's first: what the next step's
// warps 0 and W - 1 read) and the ring's GVT and sum into out.mn[0] and
// out.sum[0]; rank 0 writes the stats from `st` (stats + k B + row: moment
// m at st[m plane], the previous step's sumabs at st[5 plane - B] where
// `prev`; at kLast the sumabs at st[5 plane]).  Every warp waits for it.
template <Meet kWhat, class Slot>
__device__ __forceinline__ void grid_meet(Slot& out, unsigned* work, int g,
                                          int row, int par, int W, int lane,
                                          int warp, int rank, float* st,
                                          size_t plane, int B, bool prev) {
  __syncthreads();
  if (warp == 0) {
    const RingGrid rg = ring_grid(work, g, row, B);
    GridPart* all = rg.part + (size_t)par * g;
    GridPart* mine = all + rank;
    if constexpr (kWhat == Meet::kLast) {
      const float a = slot_reduce(out.sumabs, W, lane, Add{});
      if (lane == 0) __stcg(&mine->sumabs, a);
    } else {
      // each partial stored as it is reduced, so few stay live
      const float m = slot_reduce(out.mn, W, lane, Min{});
      if (lane == 0) __stcg(&mine->mn, m);
      if constexpr (kWhat == Meet::kStep) {
        const unsigned c = slot_reduce(out.cnt, W, lane, Add{});
        if (lane == 0) __stcg(&mine->cnt, c);
        const float x = slot_reduce(out.mx, W, lane, Max{});
        if (lane == 0) __stcg(&mine->mx, x);
        const float s = slot_reduce(out.sum, W, lane, Add{});
        if (lane == 0) __stcg(&mine->sum, s);
        const float q = slot_reduce(out.sumsq, W, lane, Add{});
        if (lane == 0) __stcg(&mine->sumsq, q);
        const float a = slot_reduce(out.sumabs, W, lane, Add{});
        if (lane == 0) __stcg(&mine->sumabs, a);
      }
      if (lane == 0) {
        __stcg(&mine->first, out.first[0]);
        __stcg(&mine->last, out.last[W - 1]);
      }
    }
    grid_barrier(rg.bar, g, lane);
    const auto ld_sumabs = [](const GridPart* p) { return __ldcg(&p->sumabs); };
    if constexpr (kWhat == Meet::kLast) {
      if (rank == 0) {
        const float ab = grid_fold(all, g, lane, ld_sumabs, Add{});
        if (lane == 0) st[5 * plane] = ab;
      }
      if (rg.more) grid_barrier(rg.bar, g, lane);
    } else {
      const float mn = grid_tree(
          all, g, lane, INFINITY,
          [](const GridPart* p) { return __ldcg(&p->mn); }, Min{});
      float sum = 0.f;
      if constexpr (kWhat == Meet::kStep) {
        sum = grid_fold(all, g, lane,
                        [](const GridPart* p) { return __ldcg(&p->sum); },
                        Add{});
        if (rank == 0) {
          const unsigned c = grid_tree(
              all, g, lane, 0u,
              [](const GridPart* p) { return __ldcg(&p->cnt); }, Add{});
          const float mx = grid_tree(
              all, g, lane, -INFINITY,
              [](const GridPart* p) { return __ldcg(&p->mx); }, Max{});
          const float sq = grid_fold(
              all, g, lane,
              [](const GridPart* p) { return __ldcg(&p->sumsq); }, Add{});
          const float ab = grid_fold(all, g, lane, ld_sumabs, Add{});
          if (lane == 0) {
            st[0 * plane] = (float)c;
            st[1 * plane] = mn;
            st[2 * plane] = mx;
            st[3 * plane] = sum;
            st[4 * plane] = sq;
            if (prev) st[5 * plane - B] = ab;
          }
        }
      }
      if (lane == 0) {
        out.last[W - 1] = __ldcg(&all[rank == 0 ? g - 1 : rank - 1].last);
        out.first[0] = __ldcg(&all[rank == g - 1 ? 0 : rank + 1].first);
        out.mn[0] = mn;
        out.sum[0] = sum;
      }
    }
  }
  __syncthreads();
}

// Warps of a stream-tier block that own its kr shared rows of `rows`: all
// W where the segment fits shared memory; else W less the device rows'
// share of the warps, rounded up, at least one and at most W - 1.
__device__ __forceinline__ int stream_warps(int rows, int kr, int W) {
  if (kr >= rows) return W;
  return W - min(W - 1, max(1, (W * (rows - kr) + rows - 1) / rows));
}

// Runs the K steps of ring `row` (blockDim.x = 32 W).  `dlt` is the row's
// window width (inf turns the window off: tau <= inf + GVT holds).  kRd and
// kBoth are the rd_mode and border_both flags, fixed per instantiation so
// that the hot loop carries no test of them.  Over the grid (kTier) the
// block is rank blockIdx.x % g of the ring's g blocks, holds the segment of
// `seg` PEs from PE rank * seg and meets the others through the workspace
// `work`; in one block, the whole ring.
// On the stream tier the block keeps the first `keep` PEs of its segment in
// shared memory and the rest in tau_out.  `rebase` writes tau out less the
// ring's last minimum (B3 passes a literal false).  kStale bounds every
// step's window by dlt plus the ring's minimum of tau_in (the stale window,
// its base taken once a chunk) in place of the step's GVT; the moments, the
// meetings and the rebase are the exact window's.
template <bool kRd, bool kBoth, RingTier kTier, class Events,
          bool kStale = false>
__device__ __forceinline__ void ring_steps(const float* __restrict__ tau_in,
                                           float* __restrict__ tau_out,
                                           float* __restrict__ stats,
                                           int row, int B, int L, int K,
                                           uint32_t n_v, float dlt,
                                           const Events& events, bool rebase,
                                           int g = 1,
                                           int seg = 0,
                                           unsigned* work = nullptr,
                                           int keep = 0) {
  constexpr bool kStream = kTier == RingTier::kStream;
  constexpr bool kGrid = kTier == RingTier::kGrid || kStream;  // meets so
  constexpr int U = Events::kAhead;
  constexpr int kW = kGrid ? kRingSplitWarps : kRingMaxWarps;
  using Slot = RingSlot<kW>;
  extern __shared__ float ring_smem[];
  __shared__ Slot slot[2];
  __shared__ LogEntry tab[128];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  // this block's segment: PEs [base, base + n) of the ring, local index
  // i at ring-wide PE base + i
  const int rank = kGrid ? (int)(blockIdx.x % g) : 0;
  const int base = kGrid ? rank * seg : 0;
  const int n = kGrid ? min(seg, L - base) : L;
  const int rows = (n + 31) >> 5;
  // rows [0, kr) in shared memory, owned by warps [0, wk); on the stream
  // tier the rows past them in device memory, owned by the other warps
  const int kr = kStream ? min(rows, keep >> 5) : rows;
  const int wk = kStream ? stream_warps(rows, kr, W) : W;
  const bool dev_rows = kStream && warp >= wk;
  const int r0 = dev_rows ? kr + (warp - wk) * (rows - kr) / (W - wk)
                          : warp * kr / wk;
  const int r1 = dev_rows ? kr + (warp + 1 - wk) * (rows - kr) / (W - wk)
                          : (warp + 1) * kr / wk;
  float* const ring =
      dev_rows ? tau_out + (size_t)row * L + base : ring_smem;
  const int first = 32 * r0;                      // this warp's PEs
  const int last = min(32 * r1, n) - 1;
  const int wl = warp == 0 ? W - 1 : warp - 1;    // the warps beside it
  const int wr = warp == W - 1 ? 0 : warp + 1;
  const SiteDivisor div = site_divisor(n_v);
  const size_t plane = (size_t)K * B;
  // Row slots per step, padded to whole groups of U: the word of slot s is
  // in buf[s % U], fetched U slots ahead across the step boundary.
  const int S = (r1 - r0 + U - 1) / U * U;

  // the words of step 0's first group (rows past the warp's, and lanes
  // past the segment's end, re-read a word in bounds)
  typename Events::Word buf[U];
#pragma unroll
  for (int j = 0; j < U; ++j)
    buf[j] = events.fetch(0, base + min(first + 32 * min(j, r1 - 1 - r0)
                                        + lane, n - 1));

  // load the decode's table and the segment, take its minimum (the first
  // step's GVT) and publish the edge PEs, as a step -1 in slot 1
  load_log_table(tab);
  const float* src = tau_in + (size_t)row * L + base;
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
  float gvt;
  if constexpr (kGrid) {
    grid_meet<Meet::kInit>(slot[1], work, g, row, 1, W, lane, warp, rank,
                           stats, plane, B, false);
    gvt = slot[1].mn[0];
  } else {
    __syncthreads();
    gvt = slot_reduce(slot[1].mn, W, lane, Min{});
  }
  float mean = 0.f;  // the ring mean after the previous step
  // the stale window's bound, from the minimum of tau_in (dead code in the
  // exact window)
  const float stale_bound = __fadd_rn(dlt, gvt);

  for (int k = 0; k < K; ++k) {
    const int par = (k + 1) & 1;
    Slot& out = slot[k & 1];
    const auto step = events.step(k);
    const float bound = kStale ? stale_bound : __fadd_rn(dlt, gvt);
    // old tau beside this warp's ends (over the grid the meeting put the
    // neighbour blocks' edge PEs there)
    const float lft_edge = slot[par].last[wl];   // left of `first`
    const float rgt_edge = slot[par].first[wr];  // right of `last`
    unsigned cnt = 0;
    float lmn = INFINITY, lmx = -INFINITY, s = 0.f, ss = 0.f, sa = 0.f;
    float pend[U];   // the previous group's new tau, stored one group late
    int pend_p = -1;

    // One PE's step from its old tau and its neighbours'; `live` masks the
    // lanes past the ring's end.
    auto pe_step = [&](float c, float l, float r, int i, bool live,
                       const typename Events::Word& w) {
      const auto ev = events.at(step, w, base + i);
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
        buf[j] = events.fetch(kf, base + min(i0 + 32 * min(j, jmax), n - 1));
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
    if constexpr (kGrid) {
      grid_meet<Meet::kStep>(out, work, g, row, k & 1, W, lane, warp, rank,
                             stats + (size_t)k * B + row, plane, B, k > 0);
      gvt = out.mn[0];
      mean = __fdiv_rn(out.sum[0], (float)L);
      continue;
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

  // the last step's sumabs, and tau out.  Rebased, less gvt (the ring's
  // minimum after step K - 1), device rows rewritten in place.  Two loops,
  // not a test a PE: with one, the stream kernels spill.
  float* dst = tau_out + (size_t)row * L + base;
  float sa = 0.f;
  if (rebase) {
    for (int i = first + lane; i <= last; i += 32) {
      const float t = ring[i];
      dst[i] = __fsub_rn(t, gvt);
      sa = __fadd_rn(sa, fabsf(__fsub_rn(t, mean)));
    }
  } else {
    for (int i = first + lane; i <= last; i += 32) {
      const float t = ring[i];
      if (!dev_rows) dst[i] = t;   // device rows are in tau_out already
      sa = __fadd_rn(sa, fabsf(__fsub_rn(t, mean)));
    }
  }
  sa = warp_sum(sa);
  Slot& out = slot[K & 1];
  if (lane == 0) out.sumabs[warp] = sa;
  if constexpr (kGrid) {
    grid_meet<Meet::kLast>(out, work, g, row, K & 1, W, lane, warp, rank,
                           stats + (size_t)(K - 1) * B + row, plane, B,
                           false);
    return;
  }
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

// Sets a ring kernel's shared memory (the whole of the carveout to shared
// memory, so that 4 L-byte rings pack an SM).
template <class Kernel>
cudaError_t ring_allow(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) cudaGetLastError();  // leave no error behind
  return err;
}

// Whether `blocks` blocks a ring of `warps` warps (at most `max_warps`),
// each holding `seg` PEs, lay out a ring of L: the whole ring where
// blocks == 1; else segments of a multiple of 32, the last one shorter and
// at least a row a warp.
inline bool ring_shape_ok(int B, int L, int K, int warps, int max_warps,
                          int blocks, int seg) {
  return !(B < 1 || L < 1 || K < 1 || warps < 1 || warps > max_warps ||
           (warps & (warps - 1)) != 0 || blocks < 1 || seg < 1 ||
           (blocks == 1 ? seg != L
                        : seg % 32 != 0 || (long long)seg * blocks < L ||
                              (long long)seg * (blocks - 1) >= L) ||
           warps > (L - seg * (blocks - 1) + 31) / 32);
}

// Launches `kernel` (a block instantiation) on B rings of one block of
// `warps` warps, each holding its whole ring (seg == keep == L), `args` its
// arguments.  Returns a CUDA error code: cudaErrorInvalidValue for a shape
// that is not tiling.ring_plan's.
template <class Kernel, class... Args>
int ring_block_launch(Kernel kernel, int B, int L, int K, int warps, int seg,
                      int keep, void* stream, Args... args) {
  if (keep != seg || !ring_shape_ok(B, L, K, warps, kRingMaxWarps, 1, seg))
    return (int)cudaErrorInvalidValue;
  const int smem = seg * (int)sizeof(float);
  const cudaError_t err = ring_allow(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, 32 * warps, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// The rings of `grid` blocks of a ring kernel, `warps` warps and `smem`
// dynamic bytes each, that the card holds at once (its resident blocks
// over `grid`; a cooperative launch places all its blocks at once or not
// at all), or minus a CUDA error code.
template <class Kernel>
int ring_max_rings(Kernel kernel, int grid, int warps, int smem) {
  cudaError_t err = ring_allow(kernel, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        32 * warps, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return per_sm * sms / grid;
}

// Launches `kernel` (a grid or stream instantiation) on B rings of `grid`
// blocks of `warps` warps, each owning `seg` PEs and keeping the first
// `keep` of them in shared memory (all, keep == seg, but on the stream
// tier), as one cooperative launch of as many whole rings as the card holds
// at once (the kernel walks the batch in waves), its ring slots in `work`
// (`work_bytes` bytes, the counters zeroed here on `stream`), `args` its
// arguments up to the workspace.  Returns a CUDA error code:
// cudaErrorInvalidValue for a shape that is not tiling.ring_plan's kind or
// a workspace too small, cudaErrorCooperativeLaunchTooLarge where the card
// cannot hold one ring.
template <class Kernel, class... Args>
int ring_grid_launch(Kernel kernel, int B, int L, int K, int warps, int grid,
                     int seg, int keep, void* work, long long work_bytes,
                     void* stream, Args... args) {
  if (grid < 2 || !ring_shape_ok(B, L, K, warps, kRingSplitWarps, grid, seg)
      || keep > seg || keep < 32 * warps || (keep < seg && keep % 32 != 0))
    return (int)cudaErrorInvalidValue;
  const int smem = keep * (int)sizeof(float);
  int rings = ring_max_rings(kernel, grid, warps, smem);
  if (rings < 0) return -rings;
  if (rings < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (rings > B) rings = B;
  if (work == nullptr ||
      (size_t)work_bytes < ring_grid_bytes(rings, grid))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(work, 0, (size_t)rings * 128,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rings * grid), 1, 1);
  cfg.blockDim = dim3((unsigned)(32 * warps), 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args..., (unsigned*)work);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace
