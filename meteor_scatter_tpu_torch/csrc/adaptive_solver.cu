// K1 — fused adaptive-threshold solver, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// meteor_scatter_tpu/ops/pallas/adaptive_kernel.py::_kernel.  One launch
// solves one chunk of the delta-dB series: positions [0, halo) are window
// history only, positions [halo, total) are solved.  Three stages, with the
// semantics of the TPU kernel:
//   1. rolling mean/std over delta[i-W, i) from prefix sums, giving the
//      windowed threshold m + k*std (0 at absolute block 0);
//   2. the freeze-recurrence fixpoint: freeze horizon = prefix max of
//      max(i+fa, max(0, i-fb)) over above blocks, threshold = windowed
//      value of the last updatable block (a prefix max of indices and a
//      gather), iterated until the above mask is stable;
//   3. the run-start prefix count s_incl and the masked prefix sum csm.
//
// What bounds it: latency, not bytes.  A 1 h recording is 18 000 blocks
// (72 KB of f32) and a full chunk 131 072 blocks (512 KB); the series and
// its scratch stay in the 50 MB L2, and the time goes into the chain of
// dependent block-wide scans and barriers, repeated once per fixpoint round.
// Design: one CTA of 1024 threads walks the series in tiles of 8192 blocks
// (8 consecutive blocks per thread).  Each prefix scan is a thread-local scan,
// a warp-shuffle scan, a scan of the 32 warp totals in shared memory, and a
// running carry from tile to tile.  The fixpoint loop runs inside the
// kernel, with __syncthreads_or as the "mask changed" test, so a chunk is
// one launch however many rounds it takes.  One CTA occupies 1 of the 132
// SMs; a multi-CTA (decoupled look-back) or thread-block-cluster scan is
// the next step for speed.
//
// Rounding: m, m2 - m*m and m + k*std use __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn / __fsqrt_rn, which the compiler never contracts
// into an FMA, so each step rounds as the PyTorch twin's separate ops do.
// Only the order of the float prefix sums differs from the twin.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

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

// Block-wide exclusive scan of one value per thread, offset by `carry`, the
// aggregate of all earlier tiles.  Returns op(carry, values of the threads
// before this one) and advances `carry` by the whole tile.  `sm` holds
// kWarps values.  Every thread of the block must call it.
template <typename T, typename Op>
__device__ __forceinline__ T block_exclusive(T x, Op op, T identity, T& carry, T* sm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T incl = warp_inclusive(x, op);
  if (lane == 31) sm[warp] = incl;
  __syncthreads();
  if (warp == 0) sm[lane] = warp_inclusive(sm[lane], op);
  __syncthreads();
  T excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = identity;
  if (warp > 0) excl = op(sm[warp - 1], excl);
  const T out = op(carry, excl);
  carry = op(carry, sm[kWarps - 1]);
  __syncthreads();  // sm is reused by the next call
  return out;
}

struct Params {
  const float* delta;    // [total] halo then the chunk
  int total;
  int halo;              // 0 or window
  const int* carry_i;    // [2] i0 (absolute index of block `halo`), freeze_until_in
  const float* carry_f;  // [2] fixed_thr, thr_in
  int window;
  int freeze_before;
  int freeze_after;
  int fixed_blocks;
  float k_std;
  int max_rounds;
  float* cs;             // [total] scratch: exclusive prefix sum of d
  float* cs2;            // [total] scratch: exclusive prefix sum of d*d
  float* windowed;       // [total] scratch: m + k*std
  uint8_t* above;        // [total] valid & (d > thr), 0/1
  float* thr;            // [total - halo]
  int* s_incl;           // [total - halo]
  float* csm;            // [total - halo]
};

// Stage 1: cs = prefix_sum(d) - d and cs2 = prefix_sum(d*d) - d*d, as the
// TPU kernel forms its exclusive sums; then the windowed threshold.
__device__ void rolling_stats(const Params& p, int i0, int* smi, float* smf) {
  const int t0 = threadIdx.x * kItems;
  float c1 = 0.f, c2 = 0.f;
  for (int base = 0; base < p.total; base += kTile) {
    float d[kItems], s1[kItems], s2[kItems];
    float r1 = 0.f, r2 = 0.f;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + t0 + j;
      d[j] = i < p.total ? p.delta[i] : 0.f;
      r1 = __fadd_rn(r1, d[j]);
      r2 = __fadd_rn(r2, __fmul_rn(d[j], d[j]));
      s1[j] = r1;
      s2[j] = r2;
    }
    const float b1 = block_exclusive(r1, AddF(), 0.f, c1, smf);
    const float b2 = block_exclusive(r2, AddF(), 0.f, c2, smf);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + t0 + j;
      if (i < p.total) {
        p.cs[i] = __fsub_rn(__fadd_rn(b1, s1[j]), d[j]);
        p.cs2[i] = __fsub_rn(__fadd_rn(b2, s2[j]), __fmul_rn(d[j], d[j]));
      }
    }
  }
  __syncthreads();  // cs / cs2 of other threads are read below

  for (int i = threadIdx.x; i < p.total; i += kThreads) {
    const int iabs = i - p.halo + i0;
    // callers pass halo == 0 (first chunk, i0 == 0) or halo == window, so
    // the shift by `window` covers exactly the absolute window
    const float cnt = static_cast<float>(min(iabs, p.window));
    const float safe = fmaxf(cnt, 1.f);
    const float lo1 = i >= p.window ? p.cs[i - p.window] : 0.f;
    const float lo2 = i >= p.window ? p.cs2[i - p.window] : 0.f;
    const float m = __fdiv_rn(__fsub_rn(p.cs[i], lo1), safe);
    const float m2 = __fdiv_rn(__fsub_rn(p.cs2[i], lo2), safe);
    const float var = __fsub_rn(m2, __fmul_rn(m, m));
    const float sd = __fsqrt_rn(var < 0.f ? 0.f : var);  // NaN passes through
    // cnt == 0 only at absolute block 0: empty-window stats give 0 there
    p.windowed[i] = cnt > 0.f ? __fadd_rn(m, __fmul_rn(p.k_std, sd)) : 0.f;
    p.above[i] = 0;
  }
  __syncthreads();
}

// Stage 2, one round: thr = thresholds_from(above), then
// above = valid & (d > thr).  Returns (uniformly over the block) whether
// any bit of `above` changed.  Each thread reads and writes only its own
// positions of `above`, so the update is in place.
__device__ bool solve_round(const Params& p, int i0, int freeze_in, float fixed_thr,
                            float thr_in, int* smi) {
  const int t0 = threadIdx.x * kItems;
  int freeze_carry = freeze_in;  // the carried horizon seeds the prefix max
  int key_carry = INT_MIN;
  int changed = 0;
  for (int base = 0; base < p.total; base += kTile) {
    int f_excl[kItems], k_incl[kItems];
    uint8_t a_old[kItems];
    int run = INT_MIN;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + t0 + j;
      const int iabs = i - p.halo + i0;
      a_old[j] = i < p.total ? p.above[i] : 0;  // 0 outside the solved region
      f_excl[j] = run;
      const int nf = max(iabs + p.freeze_after, max(0, iabs - p.freeze_before));
      run = max(run, a_old[j] ? nf : -1);
    }
    const int f_base = block_exclusive(run, MaxI(), INT_MIN, freeze_carry, smi);

    int krun = INT_MIN;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + t0 + j;
      const int iabs = i - p.halo + i0;
      const bool valid = i >= p.halo && i < p.total;
      const int freeze_prev = max(f_base, f_excl[j]);
      const bool upd = valid && iabs > freeze_prev && iabs >= p.fixed_blocks;
      krun = max(krun, upd ? i : -1);
      k_incl[j] = krun;
    }
    const int k_base = block_exclusive(krun, MaxI(), INT_MIN, key_carry, smi);

#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + t0 + j;
      if (i < p.total) {
        const int iabs = i - p.halo + i0;
        const int last_upd = max(k_base, k_incl[j]);
        float t;
        if (iabs < p.fixed_blocks) {
          t = fixed_thr;
        } else if (last_upd >= 0) {
          t = p.windowed[last_upd];
        } else {
          t = thr_in;  // nothing updatable yet in this chunk
        }
        const uint8_t a = (i >= p.halo && p.delta[i] > t) ? 1 : 0;
        changed |= a != a_old[j];
        p.above[i] = a;
        if (i >= p.halo) p.thr[i - p.halo] = t;
      }
    }
  }
  return __syncthreads_or(changed) != 0;
}

// Stage 3: runs-started prefix count and masked prefix sum over the solved
// region.  The halo holds above == 0, so a run that starts at the chunk's
// first block counts as a start.
__device__ void run_sums(const Params& p, int* smi, float* smf) {
  const int t0 = threadIdx.x * kItems;
  int sc = 0;
  float mc = 0.f;
  for (int base = 0; base < p.total; base += kTile) {
    int s_loc[kItems];
    float m_loc[kItems];
    int rs = 0;
    float rm = 0.f;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + t0 + j;
      const int a = i < p.total ? p.above[i] : 0;
      const int prev = (i > 0 && i <= p.total) ? p.above[i - 1] : 0;
      rs += a & (prev ^ 1);
      rm = __fadd_rn(rm, a ? p.delta[i] : 0.f);
      s_loc[j] = rs;
      m_loc[j] = rm;
    }
    const int s_base = block_exclusive(rs, AddI(), 0, sc, smi);
    const float m_base = block_exclusive(rm, AddF(), 0.f, mc, smf);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = base + t0 + j;
      if (i >= p.halo && i < p.total) {
        p.s_incl[i - p.halo] = s_base + s_loc[j];
        p.csm[i - p.halo] = __fadd_rn(m_base, m_loc[j]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) adaptive_solver_kernel(Params p) {
  __shared__ int smi[kWarps];
  __shared__ float smf[kWarps];
  const int i0 = p.carry_i[0];
  const int freeze_in = p.carry_i[1];
  const float fixed_thr = p.carry_f[0];
  const float thr_in = p.carry_f[1];

  rolling_stats(p, i0, smi, smf);

  // above starts all-zero; round 1 is thresholds_from(zeros)
  bool changed = solve_round(p, i0, freeze_in, fixed_thr, thr_in, smi);
  int rounds = 1;
  while (changed && rounds < p.max_rounds) {
    changed = solve_round(p, i0, freeze_in, fixed_thr, thr_in, smi);
    ++rounds;
  }
  // A round that changed nothing already wrote thr = thresholds_from(above).
  // Stopped by the round cap instead: one more round evaluates it.
  if (changed) solve_round(p, i0, freeze_in, fixed_thr, thr_in, smi);

  run_sums(p, smi, smf);
}

}  // namespace

// Launches one chunk on `stream`.  Pointers are device pointers; `scratch`
// holds 3 * total floats.  Returns cudaGetLastError() after the launch.
extern "C" int ms_adaptive_solver(const float* delta, int total, int halo, const int* carry_i,
                                  const float* carry_f, int window, int freeze_before,
                                  int freeze_after, int fixed_blocks, float k_std,
                                  int max_rounds, float* scratch, uint8_t* above, float* thr,
                                  int* s_incl, float* csm, void* stream) {
  Params p;
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
  p.max_rounds = max_rounds;
  p.cs = scratch;
  p.cs2 = scratch + total;
  p.windowed = scratch + 2 * static_cast<long>(total);
  p.above = above;
  p.thr = thr;
  p.s_incl = s_incl;
  p.csm = csm;
  adaptive_solver_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
