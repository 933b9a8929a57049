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
// Per step, for every PE i of row r:
//   words  w0, w1 = counter_words(seed, step0 + k, trial_r, l0 + i)
//          trial_r = trial_col[r] if given, else b0 + r (uint32, wrapping)
//   decode site = w0 % n_v (borders 0 and n_v - 1),
//          eta  = fp32(-log(fp64(fp32(fp32(w1 >> 8) * 2^-24) + 2^-25)))
//   GVT    = min of the ring before the step (the previous step's `min`)
//   update Eq. (1) causality against the +-1 neighbours (unless rd_mode)
//          and Eq. (3) window tau <= (delta + GVT), one fp32 add, with
//          delta = delta_col[r] if given, else the static delta (inf = off)
//   moments ucount, min, max, sum, sumsq; then sumabs about sum / L in a
//          second pass over shared memory, as horizon.ring_moments does.
// Moment m of step k, row r goes to stats[(m * K + k) * B + r].
//
// Storage: the ring is double-buffered in dynamic shared memory (tau, tau'),
// 8 * L bytes, so L <= 28,927 within the 227 KB a block may use
// (kernels/tiling.py: MAX_RING_L; the wrapper raises above it).
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

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The first three absorb rounds of counter_words: constant along a row.
__device__ __forceinline__ uint32_t row_hash(uint32_t seed, uint32_t step,
                                             uint32_t trial) {
  uint32_t h = mix32(seed ^ 0x9E3779B9u);
  h = mix32(h ^ (step * 0x27D4EB2Fu));
  return mix32(h ^ (trial * 0x165667B1u));
}

// The port's decode rule (core/horizon.py).  The _rn intrinsics keep the
// compiler from contracting the multiply and add into one rounding.
__device__ __forceinline__ float eta_from_w1(uint32_t w1) {
  const float u = __fmul_rn(__uint2float_rn(w1 >> 8), 5.9604644775390625e-08f);
  const float x = __fadd_rn(u, 2.98023223876953125e-08f);
  return __double2float_rn(-log((double)x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ unsigned warp_sum_u(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
multistep_counter_kernel(const float* __restrict__ tau_in,
                         float* __restrict__ tau_out,
                         float* __restrict__ stats,
                         const float* __restrict__ delta_col,
                         const uint32_t* __restrict__ trial_col,
                         int B, int L, int K,
                         uint32_t seed, uint32_t step0, uint32_t b0,
                         uint32_t l0, uint32_t n_v, float delta,
                         int rd_mode, int border_both) {
  extern __shared__ float ring[];
  float* cur = ring;
  float* nxt = ring + L;
  __shared__ float red_min[kWarps], red_max[kWarps];
  __shared__ float red_sum[kWarps], red_sumsq[kWarps], red_abs[kWarps];
  __shared__ unsigned red_cnt[kWarps];
  __shared__ float bcast[2];  // ring min (next GVT), ring sum

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // load the ring and take its minimum: the first step's GVT
  const float* src = tau_in + (size_t)row * L;
  float mn = INFINITY;
  for (int i = tid; i < L; i += kThreads) {
    const float t = src[i];
    cur[i] = t;
    mn = fminf(mn, t);
  }
  mn = warp_min(mn);
  if (lane == 0) red_min[warp] = mn;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kWarps ? red_min[lane] : INFINITY;
    v = warp_min(v);
    if (lane == 0) bcast[0] = v;
  }
  __syncthreads();
  float gvt = bcast[0];

  const uint32_t trial = trial_col ? trial_col[row] : b0 + (uint32_t)row;
  const float dlt = delta_col ? delta_col[row] : delta;
  const bool window_off = delta_col == nullptr && isinf(delta);
  const size_t plane = (size_t)K * B;

  for (int k = 0; k < K; ++k) {
    const uint32_t hrow = row_hash(seed, step0 + (uint32_t)k, trial);
    const float bound = __fadd_rn(dlt, gvt);
    unsigned cnt = 0;
    float lmn = INFINITY, lmx = -INFINITY, s = 0.f, ss = 0.f;
    for (int i = tid; i < L; i += kThreads) {
      const uint32_t h = mix32(hrow ^ ((l0 + (uint32_t)i) * 0xD3A2646Cu));
      const uint32_t w0 = mix32(h ^ 0x68E31DA4u);
      const uint32_t site = w0 % n_v;
      const bool is_left = site == 0;
      const bool is_right = site == n_v - 1;
      const float t = cur[i];
      bool ok = true;
      if (!rd_mode) {
        const float lft = cur[i == 0 ? L - 1 : i - 1];
        const float rgt = cur[i == L - 1 ? 0 : i + 1];
        if (border_both)
          ok = !(is_left || is_right) || (t <= lft && t <= rgt);
        else
          ok = (!is_left || t <= lft) && (!is_right || t <= rgt);
      }
      const bool upd = ok && (window_off || t <= bound);
      float tn = t;
      if (upd) tn = __fadd_rn(t, eta_from_w1(mix32(h ^ 0xB5297A4Du)));
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
      const bool live = lane < kWarps;
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
    for (int i = tid; i < L; i += kThreads)
      sa = __fadd_rn(sa, fabsf(__fsub_rn(nxt[i], mean)));
    sa = warp_sum(sa);
    if (lane == 0) red_abs[warp] = sa;
    __syncthreads();
    if (warp == 0) {
      float v = warp_sum(lane < kWarps ? red_abs[lane] : 0.f);
      if (lane == 0) stats[5 * plane + (size_t)k * B + row] = v;
    }
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  float* dst = tau_out + (size_t)row * L;
  for (int i = tid; i < L; i += kThreads) dst[i] = cur[i];
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
  multistep_counter_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
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
