// One PDES step on a haloed chunk, with the window base given from outside.
// CUDA C++ for Hopper (sm_90a), plain C interface, loaded with ctypes by
// repro_torch/kernels/pdes_step.py.
//
// Replaces the TPU kernel src/repro/kernels/pdes_step.py::pdes_step (body
// _kernel).  The TPU kernel tiles rows into VMEM blocks of block_b rows with
// the whole haloed lane dimension per tile.
//
// For every PE i of row r (tau_h is (B, Lc + 2), PE i at column i + 1):
//   words  w0, w1 = bits[r, i] (one 8-byte uint2, from counter_bits_block on
//          the host)
//   decode site = w0 % n_v (borders 0 and n_v - 1), by a multiply-high
//          with the block's reciprocal of n_v (pdes_common.cuh),
//          eta  = fp32(-log(fp64(fp32(fp32(w1 >> 8) * 2^-24) + 2^-25)))
//          from B1's table (the port's decode rule, ROADMAP C1)
//   update Eq. (1) causality against tau_h[r, i] and tau_h[r, i + 2]
//          (unless rd_mode) and Eq. (3) window t <= (delta + gvt[r]), one
//          fp32 add; a static delta of inf turns the window rule off.  The
//          engine folds a per-row delta column into gvt and passes delta = 0.
//   moments ucount, min, max, sum, sumsq; then sumabs about sum / Lc in a
//          second pass over tau', as horizon.ring_moments does.
// Moment m of row r goes to stats[m * B + r].  The rules are those of B1,
// from pdes_common.cuh.
//
// Bound on the H100 SXM (published peaks): tau_h read once
// (4 B (Lc + 2)), the words (8 B Lc), tau' written once (4 B Lc), the gvt
// column and the six moment rows.
//   B = 448 rows of Lc = 10,000 (the main path):  71.7 MB, 0.0214 ms
//   B = 32 rows of Lc = 65,536 (a --pdes-core shard): 33.6 MB, 0.0100 ms
// at 3.35 TB/s.  Operations: per PE 14 (site pick, border compares, the
// rules, the five moments, the sumabs pass), per PE that updates 6 more
// (the decode, the fp64 log counted as one, the add); at u = 0.64 and the
// first shape 8.0e7, 0.0012 ms at 67 T/s.  So bytes bound it at both.
//
// Design.  One 512-thread block a row left 100 of the 132 SMs idle at 32
// rows (0.12 of the bound at 32 x 65,536), and a 16-PE edge strip of the
// commavoid shard step idle in 496 of its 512 threads.  Here the work of a
// row is spread by kernels/tiling.py::step_plan(Lc), a function of the row
// length alone:
//   - A long row is cut into S <= 8 segments (the portable cluster size),
//     one block each, and the S blocks of a row are one thread block
//     cluster, launched with cudaLaunchKernelEx (S is known only at run
//     time, so no __cluster_dims__).  At 32 x 65,536 that is 256 blocks of
//     512 threads on 132 SMs instead of 32; at 448 x 10,000, 896 blocks of
//     256, all on the card at once (8 an SM).
//   - Short rows share a block: a row takes a group of one warp or a few,
//     so a (32, 18) edge strip launches 8 blocks of 128 threads.
//   - Two instantiations, picked by the block size.  The wide one (512
//     threads: long rows, a few blocks an SM) takes a pair of PEs a
//     thread, the pair's words one 16-byte load where the pair is
//     16-aligned (a row of words starts at byte 8 Lc r: every pair for
//     even Lc; two 8-byte loads where not) and its tau columns two 8-byte
//     loads, in 40 registers, so that each thread keeps more bytes in
//     flight.  The narrow one (smaller blocks: many rows) takes one PE a
//     lane in 32 registers, so that 8 blocks share an SM.  Neither spills.
//     Which thread takes which PE, and in what order it adds them, depends
//     on the plan and never on an address's alignment.
//   - tau is read straight from device memory, where L1 serves the
//     neighbour columns; staging it in shared memory with 16-byte cp.async
//     copies was measured slower (PERF.md, section 6).
//   - tau' stays in shared memory for the sumabs pass where the segment
//     is one tile (every Lc <= 81,920); a longer segment is walked tile by
//     tile, and its sumabs pass reads tau' back from device memory (each
//     thread its own writes, from L2).
//   - The eta decode is B1's and B3's table (pdes_common.cuh), in shared
//     memory: cheaper here than the library log, the same floats.
//   - The sums combine in a fixed order: each thread over its PEs in
//     order, the warp by a butterfly, the group's warps in order, then the
//     cluster's blocks in rank order 0 ... S - 1 through distributed shared
//     memory (cluster.map_shared_rank), which every block reads, so every
//     block derives the same row sum and mean __fdiv_rn(sum, Lc).  Each
//     block then takes sumabs over its own segment and writes it into
//     rank 0's shared memory; rank 0 adds them in rank order and writes
//     the six moments.  No atomics, no second launch; the order follows
//     the plan, so a row's six moments are the same bit for bit whatever
//     batch it runs in (a coalesced pass and a direct run must agree).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pdes_common.cuh"  // site pick, decode, causality, reductions

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;           // tiling.STEP_THREADS
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kPairs = 10;                 // tiling.STEP_PAIRS
constexpr int kMaxCluster = 16;            // slots; the plan keeps S <= 8

// A group's partial moments: ucount, min, max, sum, sumsq.
struct Part {
  unsigned c;
  float mn, mx, s, ss;
};

// Shared floats of one group (tiling.step_group_floats): the kept tau' of
// the segment, in whole 16-byte granules.
__host__ __device__ __forceinline__ int group_floats(int seg, int keep) {
  return keep ? (seg + 3) & ~3 : 0;
}

// One PE: the site pick, the rules and the update; counts an update.
__device__ __forceinline__ float advance(float t, float lft, float rgt,
                                         uint2 w, const SiteDivisor& div,
                                         const LogEntry* tab, float bound,
                                         bool window_off, int rd_mode,
                                         int border_both, unsigned& cnt) {
  bool is_left, is_right;
  site_pick(w.x, div, is_left, is_right);
  bool ok = true;
  if (!rd_mode) ok = causal_ok(t, lft, rgt, is_left, is_right, border_both);
  const bool upd = ok && (window_off || t <= bound);
  cnt += upd ? 1u : 0u;
  // straight-line: the decode of every PE, so a thread's PEs interleave
  return upd ? __fadd_rn(t, eta_from_w1(w.y, tab)) : t;
}

__device__ __forceinline__ void tally(float v, float& lmn, float& lmx,
                                      float& s, float& ss) {
  lmn = fminf(lmn, v);
  lmx = fmaxf(lmx, v);
  s = __fadd_rn(s, v);
  ss = __fmaf_rn(v, v, ss);
}

// Grid: S blocks a row (cluster (S, 1, 1), block rank = segment), or one
// block for R rows when S == 1; group g of the block's R takes row
// (blockIdx.x / S) R + g.  A wide kernel (512-thread blocks: long rows, a
// few blocks an SM) has thread j of a group take the pairs of PEs
// p = j + m G of each tile, m < kPairs, PE 2p before 2p + 1, each pair's
// words one 16-byte load, in 40 registers; a narrow one (smaller blocks:
// many rows, 8 blocks of 256 an SM) takes PE j + m G, m < 2 kPairs, one
// 8-byte load, in 32.  Tiles in order.
template <bool kWide>
__global__ void __launch_bounds__(kMaxThreads, kWide ? 3 : 4)
pdes_step_kernel(const float* __restrict__ tau_h,
                 const uint2* __restrict__ words,
                 const float* __restrict__ gvt,
                 float* __restrict__ tau_out,
                 float* __restrict__ stats,
                 int B, int Lc, uint32_t n_v, float delta,
                 int rd_mode, int border_both,
                 int S, int R, int seg, int tile, int keep) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned red_cnt[kMaxWarps];
  __shared__ float red_min[kMaxWarps], red_max[kMaxWarps];
  __shared__ float red_sum[kMaxWarps], red_sumsq[kMaxWarps];
  __shared__ float red_abs[kMaxWarps];
  __shared__ Part total[kMaxWarps];        // a group's row moments
  __shared__ Part part;                    // this block's, for the cluster
  __shared__ float abs_slot[kMaxCluster];  // rank 0's: each block's sumabs
  __shared__ LogEntry tab[128];            // the decode's log table

  const int G = blockDim.x / R;
  const int tid = threadIdx.x;
  const int g = tid / G;
  const int j = tid - g * G;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int W = G >> 5;                    // warps of a group
  const int w_first = g * W;               // the group's first warp
  const int rank = blockIdx.x % S;         // the segment; == cluster rank
  const int row = (blockIdx.x / S) * R + g;
  const bool live = row < B;
  const int s0 = rank * seg;
  const int len = live ? min(seg, Lc - s0) : 0;
  float* tn = smem + g * group_floats(seg, keep);  // the kept tau'

  const float* src = tau_h + (size_t)(live ? row : 0) * (Lc + 2) + s0;
  const uint2* wrow = words + (size_t)(live ? row : 0) * Lc + s0;
  float* dst = tau_out + (size_t)(live ? row : 0) * Lc + s0;
  const bool window_off = isinf(delta);
  const float bound = live ? __fadd_rn(delta, gvt[row]) : 0.f;
  const SiteDivisor div = site_divisor(n_v);
  load_log_table(tab);
  __syncthreads();

  unsigned cnt = 0;
  float lmn = INFINITY, lmx = -INFINITY, s = 0.f, ss = 0.f;
  for (int t0 = 0; t0 < seg; t0 += tile) {
    const int tlen = max(0, min(tile, len - t0));
    const float* th = src + t0;            // th[i + 1]: PE t0 + i
    const uint2* wt = wrow + t0;
    float* dt = dst + t0;
    if constexpr (!kWide) {
#pragma unroll 4
      for (int m = 0; m < 2 * kPairs; ++m) {
        const int i = j + m * G;
        if (i < tlen) {
          const float v = advance(th[i + 1], th[i], th[i + 2], __ldg(wt + i),
                                  div, tab, bound, window_off, rd_mode,
                                  border_both, cnt);
          tally(v, lmn, lmx, s, ss);
          dt[i] = v;
          if (keep) tn[t0 + i] = v;
        }
      }
    } else {
      const int tpairs = (tlen + 1) >> 1;
      // a row of words starts at byte 8 Lc r: 16-aligned pairs for even Lc
      const bool w16 = (reinterpret_cast<uintptr_t>(wt) & 15) == 0;
      const bool o8 = (reinterpret_cast<uintptr_t>(dt) & 7) == 0;
      // tau_h's rows start at byte 4 (Lc + 2) r: 8-aligned pairs for even Lc
      const bool t8 = (reinterpret_cast<uintptr_t>(th) & 7) == 0;
#pragma unroll 2
      for (int m = 0; m < kPairs; ++m) {
        const int p = j + m * G;
        if (p < tpairs) {
          const int i = 2 * p;             // the pair's first PE in the tile
          const bool two = i + 1 < tlen;
          uint2 wa, wb = make_uint2(0u, 0u);
          if (two && w16) {
            const uint4 w = __ldg(reinterpret_cast<const uint4*>(wt + i));
            wa = make_uint2(w.x, w.y);
            wb = make_uint2(w.z, w.w);
          } else {
            wa = __ldg(wt + i);
            if (two) wb = __ldg(wt + i + 1);
          }
          float tl, ta, tb, tr = 0.f;      // columns i .. i + 3
          if (two && t8) {
            const float2 lo = *reinterpret_cast<const float2*>(th + i);
            const float2 hi = *reinterpret_cast<const float2*>(th + i + 2);
            tl = lo.x, ta = lo.y, tb = hi.x, tr = hi.y;
          } else {
            tl = th[i], ta = th[i + 1], tb = th[i + 2];
            if (two) tr = th[i + 3];
          }
          const float va = advance(ta, tl, tb, wa, div, tab, bound,
                                   window_off, rd_mode, border_both, cnt);
          tally(va, lmn, lmx, s, ss);
          if (two) {
            const float vb = advance(tb, ta, tr, wb, div, tab, bound,
                                     window_off, rd_mode, border_both, cnt);
            tally(vb, lmn, lmx, s, ss);
            if (o8) {
              *reinterpret_cast<float2*>(dt + i) = make_float2(va, vb);
            } else {
              dt[i] = va;
              dt[i + 1] = vb;
            }
            if (keep)
              *reinterpret_cast<float2*>(tn + t0 + i) = make_float2(va, vb);
          } else {
            dt[i] = va;
            if (keep) tn[t0 + i] = va;
          }
        }
      }
    }
  }

  // the group's moments: each warp by a butterfly, then its warps in order
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
  if (j < 32) {
    const bool in = lane < W;
    const int q = w_first + lane;
    Part p;
    p.c = warp_sum_u(in ? red_cnt[q] : 0u);
    p.mn = warp_min(in ? red_min[q] : INFINITY);
    p.mx = warp_max(in ? red_max[q] : -INFINITY);
    p.s = warp_sum(in ? red_sum[q] : 0.f);
    p.ss = warp_sum(in ? red_sumsq[q] : 0.f);
    if (lane == 0) {
      if (S == 1) total[g] = p;
      else part = p;
    }
  }
  if (S > 1) {
    // every block reads the S partials in rank order: the same row sums
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (tid == 0) {
      Part t = {0u, INFINITY, -INFINITY, 0.f, 0.f};
      for (int r = 0; r < S; ++r) {
        const Part* q = cluster.map_shared_rank(&part, r);
        t.c += q->c;
        t.mn = fminf(t.mn, q->mn);
        t.mx = fmaxf(t.mx, q->mx);
        t.s = __fadd_rn(t.s, q->s);
        t.ss = __fadd_rn(t.ss, q->ss);
      }
      total[0] = t;
    }
  }
  __syncthreads();
  const Part tot = total[g];
  if (live && j == 0 && rank == 0) {
    stats[0 * (size_t)B + row] = (float)tot.c;
    stats[1 * (size_t)B + row] = tot.mn;
    stats[2 * (size_t)B + row] = tot.mx;
    stats[3 * (size_t)B + row] = tot.s;
    stats[4 * (size_t)B + row] = tot.ss;
  }

  // sumabs over this segment, in the first pass's order, from the kept
  // tau' (else this thread's own writes, from L2)
  const float mean = __fdiv_rn(tot.s, (float)Lc);
  const float* back = keep ? tn : dst;
  float sa = 0.f;
  for (int t0 = 0; t0 < seg; t0 += tile) {
    const int tlen = max(0, min(tile, len - t0));
    if constexpr (!kWide) {
#pragma unroll 4
      for (int m = 0; m < 2 * kPairs; ++m) {
        const int i = j + m * G;
        if (i < tlen)
          sa = __fadd_rn(sa, fabsf(__fsub_rn(back[t0 + i], mean)));
      }
    } else {
      const int tpairs = (tlen + 1) >> 1;
#pragma unroll 2
      for (int m = 0; m < kPairs; ++m) {
        const int p = j + m * G;
        if (p < tpairs) {
          const int i = t0 + 2 * p;
          if (2 * p + 1 < tlen) {
            const float2 v = keep ? *reinterpret_cast<const float2*>(tn + i)
                                  : make_float2(dst[i], dst[i + 1]);
            sa = __fadd_rn(sa, fabsf(__fsub_rn(v.x, mean)));
            sa = __fadd_rn(sa, fabsf(__fsub_rn(v.y, mean)));
          } else {
            sa = __fadd_rn(sa, fabsf(__fsub_rn(back[i], mean)));
          }
        }
      }
    }
  }
  sa = warp_sum(sa);
  if (lane == 0) red_abs[warp] = sa;
  __syncthreads();
  float v = 0.f;
  if (j < 32) {
    v = warp_sum(lane < W ? red_abs[w_first + lane] : 0.f);
    if (S == 1 && live && lane == 0) stats[5 * (size_t)B + row] = v;
  }
  if (S > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) *cluster.map_shared_rank(&abs_slot[rank], 0) = v;
    cluster.sync();
    if (rank == 0 && tid == 0) {
      float t = 0.f;
      for (int r = 0; r < S; ++r) t = __fadd_rn(t, abs_slot[r]);
      stats[5 * (size_t)B + row] = t;
    }
  }
}

// The kernel a plan launches: 512-thread blocks (long rows over a cluster,
// a few an SM) the wide one; smaller blocks (many rows) the narrow one, so
// that 8 blocks of 256 share an SM and a batch of the main path's rows
// sits on the card at once.
using Kernel = decltype(&pdes_step_kernel<true>);

Kernel kernel_for(int threads) {
  return threads == kMaxThreads ? pdes_step_kernel<true>
                                : pdes_step_kernel<false>;
}

// Allows `smem` dynamic bytes where that is above 48 KB.
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) cudaGetLastError();  // leave no error behind
  return err;
}

cudaLaunchConfig_t launch_config(int blocks, int cluster, int threads,
                                 int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The clusters of `cluster` blocks of `threads` threads and `smem` dynamic
// bytes that the card can hold at once (cudaOccupancyMaxActiveClusters),
// or minus a CUDA error code.
extern "C" int pdes_step_max_clusters(int cluster, int threads, int smem) {
  const Kernel kernel = kernel_for(threads);
  cudaError_t err = allow_smem(kernel, smem);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(cluster, cluster, threads, smem, nullptr, &attr);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -(int)err;
  }
  return n;
}

// Launches B2 with the plan of kernels/tiling.py::step_plan(Lc): `cluster`
// blocks a row as one cluster, or `rows` rows a block of `threads`; `smem`
// dynamic bytes a block.  Returns a CUDA error code: a plan this kernel
// cannot run returns cudaErrorInvalidValue, and a launch the card refuses
// (a cluster it cannot place, too much shared memory) returns its error.
extern "C" int pdes_step_launch(const float* tau_h, const void* bits,
                                const float* gvt, float* tau_out,
                                float* stats, int B, int Lc, unsigned n_v,
                                float delta, int rd_mode, int border_both,
                                int cluster, int threads, int rows, int seg,
                                int tile, int keep, int smem, void* stream) {
  if (B < 1 || Lc < 1 || cluster < 1 || cluster > kMaxCluster || rows < 1 ||
      threads < 32 || threads > kMaxThreads || threads % rows != 0)
    return (int)cudaErrorInvalidValue;
  const int G = threads / rows;
  if (G % 32 != 0 || rows > kMaxWarps || (cluster > 1 && rows > 1) ||
      seg < 2 || seg % 2 != 0 || tile < 2 || tile % 2 != 0 ||
      tile > seg || tile > 2 * kPairs * G ||
      (long long)seg * cluster < Lc || (long long)seg * (cluster - 1) >= Lc ||
      smem != 4 * rows * group_floats(seg, keep))
    return (int)cudaErrorInvalidValue;
  const Kernel kernel = kernel_for(threads);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      cluster * ((B + rows - 1) / rows), cluster, threads, smem,
      (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, tau_h, (const uint2*)bits, gvt,
                           tau_out, stats, B, Lc, (uint32_t)n_v, delta,
                           rd_mode, border_both, cluster, rows, seg, tile,
                           keep);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
