// K1 — fused adaptive-threshold solver, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// meteor_scatter_tpu/ops/pallas/adaptive_kernel.py::_kernel.  One launch
// solves one chunk of the delta-dB series: positions [0, halo) are window
// history only, positions [halo, total) are solved.  It computes what the
// TPU kernel computes:
//   1. rolling mean/std over delta[i-W, i) from exclusive float prefix sums
//      (cs - shift(cs, W)), giving the windowed threshold m + k*std (0 at
//      absolute block 0);
//   2. the thresholds of the converged freeze recurrence: freeze horizon =
//      prefix max of max(i+fa, max(0, i-fb)) over above blocks, threshold =
//      windowed value of the last updatable block, else the carried one;
//   3. the run-start prefix count s_incl and the masked prefix sum csm.
//
// The kernel (`walk_kernel`) solves the recurrence directly, across the
// card.  The recurrence is a machine of two scalars: before block p the
// state is free (p > F) or frozen at horizon F with the threshold of key K.
// A free state carries no memory, so from a free block on the future
// depends on the block alone.  One cooperative launch of G = ceil(total /
// 1024) CTAs of 256 threads, one 1 024-block segment each (128 CTAs at a
// full chunk), phases separated by grid syncs:
//   1. stats: each CTA scans its segment's d and d*d, the G segment totals
//      are scanned by every CTA in the same order, cs / cs2 go to global
//      memory, and each CTA forms `windowed` (reading cs[i-W] from global
//      memory: W may exceed a segment) and a bit mask of the blocks that
//      are above when the state before them is free;
//   2. speculative walk: warp 0 of each CTA walks from `lead` blocks before
//      its segment (2*fa + 32, at most a segment), entering with the
//      chunk's carry (exact where that start is the chunk's first block).
//      Free, it jumps to the next bit of the mask, 1 024 blocks a ballot;
//      frozen, it ballots d > T 32 blocks at a time and extends F by a warp
//      prefix max.  It writes each block's key and free flag and its exit
//      state;
//   3. fix-up: a segment is trusted when its warm-up stretch is free at a
//      block where its predecessor's walk is free too (each CTA checks its
//      own seam once its predecessor has published).  CTA 0 re-walks from
//      the first untrusted seam under the true state, with all 256 threads
//      (a frozen step covers 1 024 blocks, a free step 8 192), up to a
//      block where the truth is free and that segment's speculation is free
//      too; from there the speculation stands and the walk jumps to the
//      segment's exit state.  Its cost is that of the disagreeing stretches;
//   4. outputs: thresholds from the keys, the above mask, run starts, and
//      the segment scans of starts and masked d with a scan of the totals.
// What bounds it now is latency, not bytes or operations: on ordinary data
// the slowest CTA's speculative walk (one warp deciding, ~40 % of the
// kernel at a full later chunk on an H100), the six grid syncs and the
// dependent global-memory round trips of the scans, and a fix-up walk per
// disagreeing seam; on dense data (a freeze that never lifts) CTA 0
// walking the whole chunk, ~2.5 cycles a block.  tools/torch_k1_phase_cycles.py
// measures each phase.  A grid that cannot be co-resident is refused: no
// fallback.
//
// Rounding: m, m2 - m*m and m + k*std use __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn / __fsqrt_rn, which the compiler never contracts
// into an FMA, so each step rounds as the PyTorch twin's separate ops do.
// Only the order of the float prefix sums differs from the twin.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

struct MaxI {
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct AddI {
  __device__ __forceinline__ int operator()(int a, int b) const { return a + b; }
};
struct AddF {
  __device__ __forceinline__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};

template <typename T, typename Op>
__device__ __forceinline__ T warp_inclusive(T x, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = op(y, x);
  }
  return x;
}

// Block-wide exclusive scan of one value per thread over a block of W warps,
// offset by `carry`, the aggregate of all earlier tiles.  Returns op(carry,
// values of the threads before this one) and advances `carry` by the whole
// tile.  `sm` holds W values.  Every thread of the block must call it.
template <int W, typename T, typename Op>
__device__ __forceinline__ T block_exclusive(T x, Op op, T identity, T& carry, T* sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T incl = warp_inclusive(x, op);
  if (lane == 31) sm[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T v = lane < W ? sm[lane] : identity;
    const T s = warp_inclusive(v, op);
    if (lane < W) sm[lane] = s;
  }
  __syncthreads();
  T excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = identity;
  if (warp > 0) excl = op(sm[warp - 1], excl);
  const T out = op(carry, excl);
  carry = op(carry, sm[W - 1]);
  __syncthreads();  // sm is reused by the next call
  return out;
}

// The windowed threshold of block i from its exclusive prefix sums.
__device__ __forceinline__ float windowed_at(float cs_i, float cs2_i, float lo1, float lo2,
                                             int iabs, int window, float k_std) {
  // callers pass halo == 0 (first chunk, i0 == 0) or halo == window, so
  // the shift by `window` covers exactly the absolute window
  const float cnt = static_cast<float>(min(iabs, window));
  const float safe = fmaxf(cnt, 1.f);
  const float m = __fdiv_rn(__fsub_rn(cs_i, lo1), safe);
  const float m2 = __fdiv_rn(__fsub_rn(cs2_i, lo2), safe);
  const float var = __fsub_rn(m2, __fmul_rn(m, m));
  const float sd = __fsqrt_rn(var < 0.f ? 0.f : var);  // NaN passes through
  // cnt == 0 only at absolute block 0: empty-window stats give 0 there
  return cnt > 0.f ? __fadd_rn(m, __fmul_rn(k_std, sd)) : 0.f;
}

// ---------------------------------------------------------------------------
// The kernel.

constexpr int kSeg = 1024;                  // blocks per CTA (SEGMENT in adaptive_kernel.py)
constexpr int kWalkThreads = 256;
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kPer = kSeg / kWalkThreads;   // consecutive blocks per thread
constexpr int kLeadMax = kSeg;              // the warm-up stretch lies in the previous segment
constexpr int kWin = kLeadMax + kSeg;       // staged window [s0 - kLeadMax, s0 + kSeg)
constexpr int kWinWords = kWin / 32;
constexpr int kSegWords = kSeg / 32;
constexpr int kMaxGrid = 2048;              // the fix-up's flags of trusted seams
constexpr int kErrGridTooLarge = -1;        // returned instead of a CUDA error code
constexpr int kErrNoCooperativeLaunch = -2;
constexpr int kErrBadLead = -3;
constexpr unsigned kFull = 0xffffffffu;

struct WalkParams {
  const float* delta;      // [total] halo then the chunk
  int total;
  int halo;                // 0 or window
  const int* carry_i;      // [2] i0 (absolute index of block `halo`), freeze_until_in
  const float* carry_f;    // [2] fixed_thr, thr_in
  int window;
  int freeze_before;
  int freeze_after;
  int fixed_blocks;
  float k_std;
  int lead;                // blocks of warm-up before a segment, <= kLeadMax
  int grid;                // G, the number of CTAs
  int words;               // ceil(total / 32)
  // scratch, laid out by WalkLayout
  int* stats;              // [3] untrusted seams, fix-up walks, blocks walked
  float* cs;               // [total] exclusive prefix sum of d
  float* cs2;              // [total] exclusive prefix sum of d*d
  float* windowed;         // [total] m + k*std
  int* keys;               // [total] last updatable block (-1: the carried threshold)
  unsigned* free_above;    // [words] bit i: block i is above if the state before it is free
  unsigned* spec_free;     // [words] bit i: the owning segment's speculation is free before i
  int* ready;              // [grid] 1 once the CTA's speculation is published
  int* trust;              // [grid] 1 when the seam before the CTA is trusted
  float* seg_f;            // [2 * grid] segment sums of d and d*d
  int* seg_starts;         // [grid] run starts per segment
  float* seg_masked;       // [grid] masked sum of d per segment
  int* exits;              // [2 * grid] (F, key) at each segment's end
  // outputs
  uint8_t* above;          // [total] valid & (d > thr), 0/1
  float* thr;              // [total - halo]
  int* s_incl;             // [total - halo]
  float* csm;              // [total - halo]
};

// Chunk constants every phase reads.
struct Chunk {
  int total, halo, i0, fixed_blocks, freeze_before, freeze_after;
  float fixed_thr, thr_in;

  __device__ __forceinline__ bool in_fixed(int i) const { return i - halo + i0 < fixed_blocks; }
  // chunk-local freeze horizon opened by an above block i, at most `total`:
  // the literal max(iabs + fa, max(0, iabs - fb)) of the reference
  __device__ __forceinline__ int freeze_from(int i) const {
    const long long iabs = static_cast<long long>(i) - halo + i0;
    const long long nf = max(iabs + freeze_after, max(0LL, iabs - freeze_before));
    return static_cast<int>(min(nf - i0 + halo, static_cast<long long>(total)));
  }
};

__device__ __forceinline__ bool bit_of(const unsigned* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

__device__ __forceinline__ int block_min(int v, int* sm) {
  v = __reduce_min_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) sm[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = sm[0];
#pragma unroll
  for (int w = 1; w < kWalkWarps; ++w) m = min(m, sm[w]);
  __syncthreads();  // sm is reused by the next call
  return m;
}

// The exclusive prefix, up to segment g, of the G values vals[stride * x]:
// every CTA scans all G values in the same order, so every CTA sees the same
// offsets.  `out` is a shared slot.
template <typename T, typename Op>
__device__ T prefix_before(const T* vals, int stride, int G, int g, Op op, T identity, T* sm,
                          T* out) {
  T carry = identity;
  for (int base = 0; base < G; base += kWalkThreads) {
    const int x = base + threadIdx.x;
    const T v = x < G ? vals[static_cast<long long>(stride) * x] : identity;
    const T excl = block_exclusive<kWalkWarps>(v, op, identity, carry, sm);
    if (x == g) *out = excl;
  }
  __syncthreads();
  const T r = *out;
  __syncthreads();
  return r;
}

// Warp 0's speculative walk of [a, e) from (F, key), over the CTA's staged
// window (position i - base).  Marks frozen blocks in f_win and writes the
// keys of frozen blocks of the own segment.  Returns the exit state.
__device__ __forceinline__ void speculate(const Chunk& c, int a, int e, int s0, int base, int& F,
                                          int& key, const float* d_win, const float* w_win,
                                          const unsigned* m_win, uint8_t* f_win, int* key_s) {
  const int lane = threadIdx.x & 31;
  int i = a;
  while (i < e) {
    if (i > F) {
      // free: the next block above its own windowed threshold, 1 024 a ballot
      const int wi = (i - base) >> 5;
      unsigned bits = wi + lane < kWinWords ? m_win[wi + lane] : 0u;
      if (lane == 0) bits &= kFull << ((i - base) & 31);
      const unsigned any = __ballot_sync(kFull, bits != 0u);
      if (any == 0u) {
        i = base + ((wi + 32) << 5);
        continue;
      }
      const int l = __ffs(any) - 1;
      const int j = base + ((wi + l) << 5) + __ffs(__shfl_sync(kFull, bits, l)) - 1;
      if (j >= e) break;
      // [i, j] are free (f_win and the keys say so already); j opens a freeze
      key = c.in_fixed(j) ? -1 : j;
      F = max(F, c.freeze_from(j));
      i = j + 1;
    } else {
      // frozen at (F, key): 32 blocks a ballot; the horizon before block r
      // is the prefix max of what the above blocks before it open
      const float T = key >= 0 ? w_win[key - base] : c.thr_in;
      const int r = i + lane;
      bool above = false;
      if (r < e) above = c.in_fixed(r) ? bit_of(m_win, r - base) : d_win[r - base] > T;
      int incl = INT_MIN, horizon = F;
      if (__any_sync(kFull, above)) {  // else no block of the ballot extends F
        incl = warp_inclusive(above ? c.freeze_from(r) : INT_MIN, MaxI());
        const int excl = __shfl_up_sync(kFull, incl, 1);
        if (lane > 0) horizon = max(F, excl);
      }
      const unsigned lifted = __ballot_sync(kFull, r < e && r > horizon);
      const int frozen = lifted ? __ffs(lifted) - 1 : 32;  // >= 1: block i is frozen
      if (lane < frozen && r < e) {
        f_win[r - base] = 0;
        if (r >= s0) key_s[r - s0] = key;
      }
      if (lifted) {
        F = __shfl_sync(kFull, horizon, frozen);
        i += frozen;
      } else {
        F = max(F, __shfl_sync(kFull, incl, 31));
        i += 32;
      }
    }
  }
}

// CTA 0's walk of the truth from block i in state (F, key), all threads:
// rewrites keys until the first block where the truth is free and the
// owning segment's speculation was free too (returned), or `total`.
__device__ __forceinline__ int fix_walk(const WalkParams& p, const Chunk& c, int i, int& F,
                                        int& key, int* smi, int* sh) {
  const int t = threadIdx.x;
  while (i < c.total) {
    if (i > F) {
      // free: the first block from i on that is above when free, or where
      // the speculation is free; 8 192 blocks a step.  `found` is that
      // block times 2, plus 1 unless the speculation is free there.
      int found = INT_MAX;
      for (int w0 = i >> 5; w0 < p.words; w0 += kWalkThreads) {
        const int w = w0 + t;
        unsigned above = 0u, spec = 0u;
        if (w < p.words) {
          above = p.free_above[w];
          spec = p.spec_free[w];
        }
        unsigned bits = above | spec;
        if (w == (i >> 5)) bits &= kFull << (i & 31);
        int here = INT_MAX;
        if (bits) {
          const int b = __ffs(bits) - 1;
          here = ((w << 5) + b) * 2 + static_cast<int>(((spec >> b) & 1u) ^ 1u);
        }
        found = block_min(here, smi);
        if (found != INT_MAX) break;
      }
      const int j = found == INT_MAX ? c.total : found >> 1;
      for (int r = i + t; r < j; r += kWalkThreads) p.keys[r] = r;
      if (j >= c.total) return c.total;
      if ((found & 1) == 0) return j;  // the speculation stands from j on
      if (t == 0) p.keys[j] = j;
      key = c.in_fixed(j) ? -1 : j;
      F = max(F, c.freeze_from(j));
      i = j + 1;
    } else {
      // frozen: 1 024 blocks a step, the horizon by a block-wide prefix max
      const float T = key >= 0 ? p.windowed[key] : c.thr_in;
      const int r0 = i + t * kPer;
      int before[kPer];
      int run = INT_MIN;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int r = r0 + j;
        bool above = false;
        if (r < c.total) above = c.in_fixed(r) ? bit_of(p.free_above, r) : p.delta[r] > T;
        before[j] = run;
        run = max(run, above ? c.freeze_from(r) : INT_MIN);
      }
      int step_max = INT_MIN;
      const int b = block_exclusive<kWalkWarps>(run, MaxI(), INT_MIN, step_max, smi);
      int first_free = INT_MAX, horizon_there = 0;
#pragma unroll
      for (int j = kPer - 1; j >= 0; --j) {
        const int r = r0 + j;
        const int horizon = max(F, max(b, before[j]));
        if (r < c.total && r > horizon) {
          first_free = r;
          horizon_there = horizon;
        }
      }
      const int lift = block_min(first_free, smi);
      const int end = min(lift, min(i + kSeg, c.total));
      for (int j = 0; j < kPer; ++j) {
        const int r = r0 + j;
        if (r < end) p.keys[r] = key;
      }
      if (lift != INT_MAX) {
        if (first_free == lift) *sh = horizon_there;
        __syncthreads();
        F = *sh;
        __syncthreads();
        i = lift;
      } else {
        F = max(F, step_max);
        i += kSeg;
      }
    }
  }
  return c.total;
}

__global__ void __launch_bounds__(kWalkThreads) walk_kernel(WalkParams p) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ float d_win[kWin];         // d over [s0 - kLeadMax, s0 + kSeg)
  __shared__ float w_win[kWin];         // windowed over the same
  __shared__ unsigned m_win[kWinWords];  // free_above over the same
  __shared__ uint8_t f_win[kWin];       // the speculation is free before the block
  __shared__ int key_s[kSeg];
  __shared__ unsigned warm_s[kLeadMax / 32];  // f_win over [s0 - kLeadMax, s0) as bits
  __shared__ uint8_t trusted[kMaxGrid];
  __shared__ float smf[kWalkWarps];
  __shared__ int smi[kWalkWarps];
  __shared__ float shf;
  __shared__ int shi[4];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = blockIdx.x, G = p.grid;
  const int s0 = g * kSeg, e = min(s0 + kSeg, p.total);
  const int base = s0 - kLeadMax;  // window position 0
  Chunk c;
  c.total = p.total;
  c.halo = p.halo;
  c.i0 = p.carry_i[0];
  c.fixed_blocks = p.fixed_blocks;
  c.freeze_before = p.freeze_before;
  c.freeze_after = p.freeze_after;
  c.fixed_thr = p.carry_f[0];
  c.thr_in = p.carry_f[1];
  const long long f_in = static_cast<long long>(p.carry_i[1]) - c.i0 + c.halo;
  const int freeze_in = static_cast<int>(min(max(f_in, static_cast<long long>(c.halo) - 1),
                                             static_cast<long long>(c.total)));

  // ---- stats: segment scans of d and d*d, as the TPU kernel forms cs / cs2
  float d[kPer], s1[kPer], s2[kPer];
  float r1 = 0.f, r2 = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = s0 + t * kPer + j;
    d[j] = i < e ? p.delta[i] : 0.f;
    d_win[kLeadMax + t * kPer + j] = d[j];
    r1 = __fadd_rn(r1, d[j]);
    r2 = __fadd_rn(r2, __fmul_rn(d[j], d[j]));
    s1[j] = r1;
    s2[j] = r2;
  }
  float tot1 = 0.f, tot2 = 0.f;
  const float b1 = block_exclusive<kWalkWarps>(r1, AddF(), 0.f, tot1, smf);
  const float b2 = block_exclusive<kWalkWarps>(r2, AddF(), 0.f, tot2, smf);
  if (t == 0) {
    p.seg_f[2 * g] = tot1;
    p.seg_f[2 * g + 1] = tot2;
    p.ready[g] = 0;
  }
  grid.sync();  // segment totals published

  const float o1 = prefix_before(p.seg_f, 2, G, g, AddF(), 0.f, smf, &shf);
  const float o2 = prefix_before(p.seg_f + 1, 2, G, g, AddF(), 0.f, smf, &shf);
  float cs[kPer], cs2[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = s0 + t * kPer + j;
    cs[j] = __fsub_rn(__fadd_rn(__fadd_rn(o1, b1), s1[j]), d[j]);
    cs2[j] = __fsub_rn(__fadd_rn(__fadd_rn(o2, b2), s2[j]), __fmul_rn(d[j], d[j]));
    if (i < e) {
      p.cs[i] = cs[j];
      p.cs2[i] = cs2[j];
    }
  }
  grid.sync();  // cs / cs2 published

#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = s0 + t * kPer + j;
    if (i < e) {
      const float lo1 = i >= p.window ? p.cs[i - p.window] : 0.f;
      const float lo2 = i >= p.window ? p.cs2[i - p.window] : 0.f;
      const float w = windowed_at(cs[j], cs2[j], lo1, lo2, i - c.halo + c.i0, p.window, p.k_std);
      w_win[kLeadMax + t * kPer + j] = w;
      p.windowed[i] = w;
    }
  }
  __syncthreads();
  // the free-above mask, 32 consecutive blocks a ballot
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int r = q * kWalkThreads + t;
    const int i = s0 + r;
    bool bit = false;
    if (i < e && i >= c.halo) {
      const float di = d_win[kLeadMax + r];
      bit = c.in_fixed(i) ? di > c.fixed_thr : di > w_win[kLeadMax + r];
    }
    const unsigned word = __ballot_sync(kFull, bit);
    if (lane == 0) {
      m_win[(kLeadMax + r) >> 5] = word;
      if (i < p.total) p.free_above[i >> 5] = word;
    }
  }
  grid.sync();  // windowed and the free-above mask published

  // ---- speculative walk of [a, e), warp 0
  const int a = max(c.halo, s0 - p.lead);
  for (int i = a + t; i < s0; i += kWalkThreads) {
    d_win[i - base] = p.delta[i];
    w_win[i - base] = p.windowed[i];
  }
  if (t < kLeadMax / 32) m_win[t] = base + 32 * t >= 0 ? p.free_above[(base >> 5) + t] : 0u;
  for (int r = t; r < kWin; r += kWalkThreads) {
    const int i = base + r;
    f_win[r] = i >= a && i < e;
  }
  for (int r = t; r < kSeg; r += kWalkThreads) key_s[r] = s0 + r;
  __syncthreads();
  if (warp == 0) {
    int F = freeze_in, key = -1;
    speculate(c, a, e, s0, base, F, key, d_win, w_win, m_win, f_win, key_s);
    if (lane == 0) {
      p.exits[2 * g] = F;
      p.exits[2 * g + 1] = key;
    }
  }
  __syncthreads();
  for (int r = t; r < e - s0; r += kWalkThreads) p.keys[s0 + r] = key_s[r];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int r = q * kWalkThreads + t;
    const unsigned own = __ballot_sync(kFull, f_win[kLeadMax + r] != 0);
    const unsigned warm = __ballot_sync(kFull, f_win[r] != 0);
    if (lane == 0) {
      if (s0 + r < p.total) p.spec_free[(s0 + r) >> 5] = own;
      warm_s[r >> 5] = warm;
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0) atomicExch(&p.ready[g], 1);
  // the seam before this segment is trusted when the warm-up stretch holds
  // a block where this speculation and the predecessor's are both free;
  // the predecessor publishes its speculation without waiting on anyone
  if (warp == 0) {
    bool trusted_here = a == c.halo;  // the walk started at the chunk's start
    if (!trusted_here) {
      if (lane == 0)
        while (atomicAdd(&p.ready[g - 1], 0) == 0) __nanosleep(32);
      __syncwarp();
      __threadfence();
      const unsigned pred = __ldcg(&p.spec_free[(g - 1) * kSegWords + lane]);
      trusted_here = __any_sync(kFull, (pred & warm_s[lane]) != 0u);
    }
    if (lane == 0) p.trust[g] = trusted_here;
  }
  grid.sync();  // speculation published

  // ---- fix-up, CTA 0
  if (g == 0) {
    if (t == 0) {
      shi[0] = G;
      shi[1] = 0;
    }
    __syncthreads();
    for (int x = t; x < G; x += kWalkThreads) {
      trusted[x] = p.trust[x];
      if (!trusted[x]) {
        atomicMin(&shi[0], x);
        atomicAdd(&shi[1], 1);
      }
    }
    __syncthreads();
    const int first = shi[0];
    int walks = 0, walked = 0;
    if (first < G) {
      int F = p.exits[2 * (first - 1)], key = p.exits[2 * (first - 1) + 1];
      int i = first * kSeg;
      while (i < c.total) {
        ++walks;
        const int stop = fix_walk(p, c, i, F, key, smi, &shi[2]);
        walked += stop - i;
        if (stop >= c.total) break;
        // truth and speculation agree from `stop` to the owner's end; jump
        // on over every later segment trusted against untouched blocks, to
        // the exit of the last of them
        int end = INT_MAX;
        for (int x0 = stop / kSeg + 1; x0 < G && end == INT_MAX; x0 += kWalkThreads) {
          const int x = x0 + t;
          const bool stands = x >= G || (trusted[x] && max(c.halo, x * kSeg - p.lead) >= stop);
          end = block_min(stands ? INT_MAX : x, smi);
        }
        const int o = min(end, G) - 1;
        F = p.exits[2 * o];
        key = p.exits[2 * o + 1];
        i = min((o + 1) * kSeg, c.total);
      }
    }
    if (t == 0) {
      p.stats[0] = shi[1];
      p.stats[1] = walks;
      p.stats[2] = walked;
    }
  }
  grid.sync();  // keys final

  // ---- outputs: thresholds, the above mask, run starts and masked sums
  uint8_t* ab_s = f_win;  // ab_s[0]: block s0 - 1; ab_s[1 + r]: block s0 + r
  int ab[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = t * kPer + j;
    const int i = s0 + r;
    ab[j] = 0;
    if (i >= c.halo && i < e) {
      const int k = p.keys[i];
      const float th = c.in_fixed(i) ? c.fixed_thr : (k >= 0 ? p.windowed[k] : c.thr_in);
      ab[j] = d[j] > th;
      p.thr[i - c.halo] = th;
    }
    if (i < e) p.above[i] = ab[j];
    ab_s[1 + r] = ab[j];
  }
  if (t == 0) {
    const int i = s0 - 1;
    uint8_t prev = 0;
    if (i >= c.halo) {
      const int k = p.keys[i];
      const float th = c.in_fixed(i) ? c.fixed_thr : (k >= 0 ? p.windowed[k] : c.thr_in);
      prev = p.delta[i] > th;
    }
    ab_s[0] = prev;
  }
  __syncthreads();
  int s_loc[kPer];
  float m_loc[kPer];
  int rs = 0;
  float rm = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int r = t * kPer + j;
    rs += ab[j] & (ab_s[r] ^ 1);
    rm = __fadd_rn(rm, ab[j] ? d[j] : 0.f);
    s_loc[j] = rs;
    m_loc[j] = rm;
  }
  int tot_s = 0;
  float tot_m = 0.f;
  const int bs = block_exclusive<kWalkWarps>(rs, AddI(), 0, tot_s, smi);
  const float bm = block_exclusive<kWalkWarps>(rm, AddF(), 0.f, tot_m, smf);
  if (t == 0) {
    p.seg_starts[g] = tot_s;
    p.seg_masked[g] = tot_m;
  }
  grid.sync();  // run totals published

  const int os = prefix_before(p.seg_starts, 1, G, g, AddI(), 0, smi, &shi[3]);
  const float om = prefix_before(p.seg_masked, 1, G, g, AddF(), 0.f, smf, &shf);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = s0 + t * kPer + j;
    if (i >= c.halo && i < e) {
      p.s_incl[i - c.halo] = os + bs + s_loc[j];
      p.csm[i - c.halo] = __fadd_rn(__fadd_rn(om, bm), m_loc[j]);
    }
  }
}

// Where each scratch array of the kernel lies, in 4-byte words.
struct WalkLayout {
  long long stats, cs, cs2, windowed, keys, free_above, spec_free, ready, trust, seg_f,
      seg_starts, seg_masked, exits, size;
  WalkLayout(int total) {
    const long long n = total, g = (n + kSeg - 1) / kSeg, words = (n + 31) / 32;
    long long at = 0;
    auto take = [&at](long long count) {
      const long long here = at;
      at += count;
      return here;
    };
    stats = take(3);
    cs = take(n);
    cs2 = take(n);
    windowed = take(n);
    keys = take(n);
    free_above = take(words);
    spec_free = take(words);
    ready = take(g);
    trust = take(g);
    seg_f = take(2 * g);
    seg_starts = take(g);
    seg_masked = take(g);
    exits = take(2 * g);
    size = at;
  }
};

}  // namespace

// Scratch words (4 bytes each) that the kernel needs for `total` blocks.
// The first three hold, after a launch: untrusted seams, the fix-up's walks,
// and the blocks it walked.
extern "C" long long ms_adaptive_walk_scratch_words(int total) { return WalkLayout(total).size; }

// Launches one chunk on `stream`: one cooperative launch
// of ceil(total / 1024) CTAs.  Pointers are device pointers; `scratch` holds
// ms_adaptive_walk_scratch_words(total) words.  Returns -1 when the grid
// cannot be co-resident, -2 when the device has no cooperative launch, -3
// for a warm-up longer than a segment, else the CUDA error of the launch.
extern "C" int ms_adaptive_walk(const float* delta, int total, int halo, const int* carry_i,
                                const float* carry_f, int window, int freeze_before,
                                int freeze_after, int fixed_blocks, float k_std, int lead,
                                int* scratch, uint8_t* above, float* thr, int* s_incl, float* csm,
                                void* stream) {
  if (lead < 0 || lead > kLeadMax) return kErrBadLead;
  const int grid = (total + kSeg - 1) / kSeg;
  // what the device allows, asked once per device
  struct Residency {
    bool asked;
    int cooperative, sms, per_sm;
  };
  static Residency known[16] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  Residency here = {};
  Residency& r = dev < 16 ? known[dev] : here;
  if (!r.asked) {
    err = cudaDeviceGetAttribute(&r.cooperative, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r.per_sm, walk_kernel, kWalkThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    r.asked = true;
  }
  if (!r.cooperative) return kErrNoCooperativeLaunch;
  if (grid > r.sms * r.per_sm || grid > kMaxGrid) return kErrGridTooLarge;

  const WalkLayout at(total);
  WalkParams p;
  p.delta = delta;
  p.total = total;
  p.halo = halo;
  p.carry_i = carry_i;
  p.carry_f = carry_f;
  p.window = window;
  p.freeze_before = freeze_before;
  p.freeze_after = freeze_after;
  p.fixed_blocks = fixed_blocks;
  p.k_std = k_std;
  p.lead = lead;
  p.grid = grid;
  p.words = (total + 31) / 32;
  p.stats = scratch + at.stats;
  p.cs = reinterpret_cast<float*>(scratch + at.cs);
  p.cs2 = reinterpret_cast<float*>(scratch + at.cs2);
  p.windowed = reinterpret_cast<float*>(scratch + at.windowed);
  p.keys = scratch + at.keys;
  p.free_above = reinterpret_cast<unsigned*>(scratch + at.free_above);
  p.spec_free = reinterpret_cast<unsigned*>(scratch + at.spec_free);
  p.ready = scratch + at.ready;
  p.trust = scratch + at.trust;
  p.seg_f = reinterpret_cast<float*>(scratch + at.seg_f);
  p.seg_starts = scratch + at.seg_starts;
  p.seg_masked = reinterpret_cast<float*>(scratch + at.seg_masked);
  p.exits = scratch + at.exits;
  p.above = above;
  p.thr = thr;
  p.s_incl = s_incl;
  p.csm = csm;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(walk_kernel), dim3(grid),
                                    dim3(kWalkThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
