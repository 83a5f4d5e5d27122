// K3 — the whole streaming solve of one chunk, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// meteor_scatter_tpu/ops/pallas/stream_kernel.py::_kernel together with the
// PyTorch ops that surrounded it.  One launch runs, for all C channels of a
// chunk of n blocks:
//   1. the rolling-window base-threshold prologue (mean + k*std over the
//      last w over-noise values, current block excluded);
//   2. the reference's 3-state live detector (Init -> Detect -> Track,
//      dsp/src/live/backend/processor.py:444-510);
//   3. the compaction of accepted tracks into fixed-capacity event buffers;
//   4. the carry out: every state leaf and the new ring.
// Its twin is meteor_scatter_tpu_torch/ops/kernels/stream_kernel.py::
// stream_solve_plain; the two are bit-exact on every output.
//
// What bounds it.  The bytes are ~3 series of C x n floats plus the event
// buffers (~2.4 MB + 1.8 MB at 3 000 x 64, cap 1 024: ~1.3 us at 3.35 TB/s);
// the prologue's 2*w adds a block are ~0.2 us of FP32 peak.  What is left is
// latency: each channel's decisions are sequential, one warp per SM.
//
// Design.
//   * One CTA of 256 threads per channel; series are (C, n) channel-major,
//     so a CTA reads two contiguous rows and writes one.
//   * The channel's over-noise row, with the w values before it (from the
//     carried ring, or the previous time tile), is staged in shared memory.
//     Rows that are 16-byte aligned (n a multiple of 4) arrive by Hopper's
//     1-D bulk copy (cp.async.bulk, completing on an mbarrier), the next
//     time tile's copy in flight while the current tile is worked on; other
//     rows by plain coalesced loads.  n past one tile loops over tiles with
//     the machine state carried in registers.
//   * Prologue, all threads: each thread sums the w ring slots of its blocks
//     in slot order j = 0 .. w-1, left to right, one rounding per add — the
//     order the twin's loop uses.  It writes the base threshold to the
//     threshold row, and each warp ballots a bit mask of the blocks that lie
//     above their base threshold.
//   * Decisions, warp 0.  A transition depends only on the over-noise level
//     against the base threshold or the locked one (never on the track
//     statistics), so a round tests up to 32 blocks of one state at once
//     (lane k: block b+k) and __ballot_sync + __ffs find the first block that
//     changes the state.  In Detect outside a lock the mask answers it: one
//     ballot over 32 mask words looks 1 024 blocks ahead.  Rounds inside a
//     track or a lock overwrite the threshold row with the locked value.
//   * The only sequential float chains — the Init PSD sum and a track's
//     running sums, min and max — are walked in block order, every lane
//     computing the same value.  The mean, std, duration and accept rule
//     (the divisions and the square root) run once per track exit, not once
//     per block.
//   * Accepted tracks go straight to their slot; slots at or past the
//     count are zeroed by the kernel (the wrapper allocates with
//     torch.empty).
//
// Exactness: every float op is an explicit round-to-nearest intrinsic
// (__fadd_rn, __fmul_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), which nvcc never
// contracts into an FMA, in the twin's order.  Float constants arrive
// rounded to float32, as the twin's are.  min/max propagate NaN as
// torch.minimum/maximum do (fminf/fmaxf would drop it); comparisons against
// a NaN threshold (empty ring) are false, as in the twin.

#include <algorithm>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kWaitCycles = 4000000000LL;  // ~2 s: a lost bulk copy traps, never hangs

enum : int { INIT = 0, DETECT = 1, TRACK = 2 };

// torch.minimum / torch.maximum on floats: a NaN input is returned as it is
// (a's first).  Selects only, no branches: the track walk runs them per block.
__device__ __forceinline__ float min_nan(float a, float b) {
  const float m = b < a ? b : a;
  return a != a ? a : (b != b ? b : m);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  const float m = b > a ? b : a;
  return a != a ? a : (b != b ? b : m);
}

struct Params {
  // inputs: series (C, n), state leaves (C,) in StreamState order, ring (C, w)
  const float* on;
  const float* pm;
  const int* st;
  const int* i0;
  const float* ring;
  const float* locked;
  const int* luntil;
  const float* tstart;
  const int* tsblk;
  const int* trc;
  const float* trs;
  const float* trss;
  const float* trmn;
  const float* trmx;
  const float* isum;
  const int* icnt;
  const float* pinit;
  // outputs: thresholds (C, n), seven event fields (C, cap), count, overflow
  float* thr;
  float* ev[7];  // time_start, time_stop, duration, db_min, db_max, db_mean, db_std
  int* count;
  bool* overflow;
  // outputs: the new state leaves, in StreamState order
  int* st_out;
  int* i_out;
  float* ring_out;
  float* locked_out;
  int* luntil_out;
  float* tstart_out;
  int* tsblk_out;
  int* trc_out;
  float* trs_out;
  float* trss_out;
  float* trmn_out;
  float* trmx_out;
  float* isum_out;
  int* icnt_out;
  float* pinit_out;
  int n, C, w, cap, tile;
  float k_std, block_sec, init_wait_sec, min_mean_db;
  int min_dur_b, lock_tail;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: expect `bytes` on `bar` and start the bulk copy gmem -> smem.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Every thread: wait until `bar` has left phase `parity`.
__device__ __forceinline__ void bulk_wait(unsigned long long* bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// The over-noise value at chunk-relative block x in [-w, n): the chunk for
// x >= 0, else the carried ring's slot for absolute block i0 + x.
__device__ __forceinline__ float ext_value(const float* on_row, const float* ring_row, int x,
                                           int i0, int w) {
  if (x >= 0) return on_row[x];
  int s = (i0 + x) % w;
  return ring_row[s < 0 ? s + w : s];
}

__global__ void __launch_bounds__(kThreads) stream_solve_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bar[2];
  __shared__ int s_count;

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n = p.n, w = p.w, T = p.tile, cap = p.cap;
  const int w_al = (w + 3) & ~3;  // the tile's first block sits 16-byte aligned
  // the two staged tiles, by arithmetic on smem so that every access stays
  // a shared-memory one (a pointer picked from an array would be generic)
  const auto ebuf = [&](int k) { return smem + (k & 1) * (w_al + T); };
  float* bbuf = smem + 2 * (w_al + T);
  unsigned* above = reinterpret_cast<unsigned*>(bbuf + T);  // bit q: e[q] > bbuf[q]

  const size_t row = static_cast<size_t>(c) * n;
  const float* on_row = p.on + row;
  const float* pm_row = p.pm + row;
  const float* ring_row = p.ring + static_cast<size_t>(c) * w;
  float* thr_row = p.thr + row;
  const int i0 = p.i0[c];
  const bool bulk = (reinterpret_cast<uintptr_t>(p.on) & 15) == 0 && (n & 3) == 0;

  // machine state: warp 0 keeps it, identical in every lane
  int st = p.st[c], luntil = p.luntil[c], tsblk = p.tsblk[c], trc = p.trc[c];
  int icnt = p.icnt[c], count = 0;
  float locked = p.locked[c], tstart = p.tstart[c], trs = p.trs[c], trss = p.trss[c];
  float trmn = p.trmn[c], trmx = p.trmx[c], isum = p.isum[c], pinit = p.pinit[c];

  const float inf = __int_as_float(0x7f800000);
  const float qnan = __int_as_float(0x7fc00000);  // torch.full_like(m, nan)

  if (bulk && tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&bar[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_addr(&bar[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (n > 0) bulk_load(ebuf(0) + w_al, on_row, 4u * min(T, n), &bar[0]);
  }
  __syncthreads();

  for (int t0 = 0, k = 0; t0 < n; t0 += T, ++k) {
    const int L = min(T, n - t0);
    float* e = ebuf(k) + w_al;  // e[q] = on[t0 + q] for q in [-w, L)
    for (int q = tid; q < w; q += kThreads) e[q - w] = ext_value(on_row, ring_row, t0 - w + q, i0, w);
    if (bulk) {
      bulk_wait(&bar[k & 1], (k >> 1) & 1);
    } else {
      for (int q = tid; q < L; q += kThreads) e[q] = on_row[t0 + q];
    }
    __syncthreads();
    // the next tile's copy runs behind this tile's work; its buffer was
    // last read in tile k - 1, which every thread has left
    if (bulk && tid == 0 && t0 + T < n) {
      bulk_load(ebuf(k + 1) + w_al, on_row + t0 + T, 4u * min(T, n - t0 - T),
                &bar[(k + 1) & 1]);
    }

    // ---- prologue: base threshold of every block of the tile ----
    // Whole warps run the loop: each ends with a ballot of which blocks lie
    // above their base threshold.  The base thresholds are also the
    // threshold row wherever the state does not lock it; the decision warp
    // overwrites the locked blocks after the barrier.
    for (int q = tid; q - lane < L; q += kThreads) {
      bool up = false;
      if (q < L) {
        const int i = i0 + t0 + q;
        const int cnt = min(i, w);
        // Ring slot j holds the last block before i that is j mod w: with
        // rho = i mod w, block i - rho + j for j < rho, else one window
        // earlier.  Slots j >= cnt are unwritten and add +0.0, which leaves
        // a sum that starts at +0.0 unchanged (it can never be -0.0), so
        // they are skipped.  Each slot's address is known up front, so the
        // unrolled loads are in flight together.
        const int rho = i % w;
        const int cur = q - rho;
        float s = 0.f, s2 = 0.f;
#pragma unroll 8
        for (int j = 0; j < cnt; ++j) {
          const float v = e[(j < rho ? cur : cur - w) + j];
          s = __fadd_rn(s, v);
          s2 = __fadd_rn(s2, __fmul_rn(v, v));
        }
        const float cnt_f = __int2float_rn(max(cnt, 1));
        const float mean = __fdiv_rn(s, cnt_f);
        const float m2 = __fdiv_rn(s2, cnt_f);
        const float sd = __fsqrt_rn(max_nan(__fsub_rn(m2, __fmul_rn(mean, mean)), 0.f));
        const float bt = cnt > 0 ? __fadd_rn(mean, __fmul_rn(p.k_std, sd)) : qnan;
        bbuf[q] = bt;
        thr_row[t0 + q] = bt;
        up = e[q] > bt;
      }
      const unsigned word = __ballot_sync(kFull, up);
      if (lane == 0) above[q >> 5] = word;
    }
    __syncthreads();

    // ---- decisions: warp 0, up to 32 blocks a round ----
    // Every lane holds the same state.  A round tests the blocks b, b+1, ...
    // of one state at once (lane k: block b+k) and ends at the first that
    // changes the state (__ballot_sync + __ffs).
    if (tid < 32) {
      const int words = (L + 31) >> 5;
      const int ib = i0 + t0;  // absolute index of the tile's block 0
      for (int b = 0; b < L;) {
        const int q = b + lane;
        if (st == INIT) {  // until t_start >= init_wait; thr is the base one
          const bool in = q < L;
          const bool hit = in && __fmul_rn(__int2float_rn(ib + q), p.block_sec) >= p.init_wait_sec;
          const unsigned ball = __ballot_sync(kFull, hit);
          const int last = ball ? __ffs(ball) - 1 : min(32, L - b) - 1;
          const float pmv = lane <= last ? pm_row[t0 + q] : 0.f;
          for (int u = 0; u <= last; ++u) {
            isum = __fadd_rn(isum, __shfl_sync(kFull, pmv, u));
            icnt += 1;
          }
          if (ball) {
            pinit = __fdiv_rn(isum, __int2float_rn(max(icnt, 1)));
            st = DETECT;
          }
          b += last + 1;
        } else if (st == DETECT && ib + b > luntil) {
          // Unlocked: thr is the base one, and the first block above it
          // enters a track.  Lane l reads mask word k + l, so one ballot
          // looks 1 024 blocks ahead.
          int f = L;
          unsigned skip = ~0u << (b & 31);  // the first word's blocks before b
          for (int k = b >> 5; k < words; k += 32) {
            unsigned wd = k + lane < words ? above[k + lane] : 0u;
            if (lane == 0) wd &= skip;
            skip = ~0u;
            const unsigned nz = __ballot_sync(kFull, wd != 0u);
            if (nz) {
              const int l = __ffs(nz) - 1;
              f = ((k + l) << 5) + __ffs(__shfl_sync(kFull, wd, l)) - 1;
              break;
            }
          }
          if (f < L) {  // enter a track: the entry block's level is not added
            locked = bbuf[f];
            tstart = __fmul_rn(__int2float_rn(ib + f), p.block_sec);
            tsblk = ib + f;
            trc = 0;
            trs = 0.f;
            trss = 0.f;
            trmn = inf;
            trmx = -inf;
            st = TRACK;
          }
          b = f + 1;
        } else if (st == DETECT) {
          // Inside the lock after a track: thr is the locked one through
          // block luntil; the first block above it enters a new track.
          const int end = min(L, luntil - ib + 1);
          const bool hit = q < end && e[q] > locked;
          const unsigned ball = __ballot_sync(kFull, hit);
          const int last = ball ? __ffs(ball) - 1 : min(32, end - b) - 1;
          if (lane <= last) thr_row[t0 + q] = locked;
          if (ball) {
            tstart = __fmul_rn(__int2float_rn(ib + b + last), p.block_sec);
            tsblk = ib + b + last;
            trc = 0;
            trs = 0.f;
            trss = 0.f;
            trmn = inf;
            trmx = -inf;
            st = TRACK;
          }
          b += last + 1;
        } else {  // TRACK: thr is the locked one; leave below it
          const bool hit = q < L && e[q] < locked;
          const unsigned ball = __ballot_sync(kFull, hit);
          const int last = ball ? __ffs(ball) - 1 : min(32, L - b) - 1;
          if (lane <= last) thr_row[t0 + q] = locked;
#pragma unroll 4
          for (int u = 0; u <= last; ++u) {  // the leave block is added too
            const float v = e[b + u];
            trc += 1;
            trs = __fadd_rn(trs, v);
            trss = __fadd_rn(trss, __fmul_rn(v, v));
            trmn = min_nan(trmn, v);
            trmx = max_nan(trmx, v);
          }
          if (ball) {
            const int il = ib + b + last;
            const float t_stop = __fmul_rn(__int2float_rn(il), p.block_sec);
            luntil = il + (p.lock_tail - 1);
            const float h_cnt = __int2float_rn(max(trc, 1));
            const float h_mean = __fdiv_rn(trs, h_cnt);
            const float var = __fsub_rn(__fdiv_rn(trss, h_cnt), __fmul_rn(h_mean, h_mean));
            if (h_mean >= p.min_mean_db && il - tsblk >= p.min_dur_b) {
              if (lane == 0 && count < cap) {
                const size_t at = static_cast<size_t>(c) * cap + count;
                p.ev[0][at] = tstart;
                p.ev[1][at] = t_stop;
                p.ev[2][at] = __fsub_rn(t_stop, tstart);
                p.ev[3][at] = trmn;
                p.ev[4][at] = trmx;
                p.ev[5][at] = h_mean;
                p.ev[6][at] = __fsqrt_rn(max_nan(var, 0.f));
              }
              count += 1;
            }
            st = DETECT;
          }
          b += last + 1;
        }
      }
    }
    __syncthreads();
  }

  // ---- carry out ----
  if (tid == 0) {
    s_count = count;
    p.count[c] = count;
    p.overflow[c] = count > cap;
    p.st_out[c] = st;
    p.i_out[c] = i0 + n;
    p.locked_out[c] = locked;
    p.luntil_out[c] = luntil;
    p.tstart_out[c] = tstart;
    p.tsblk_out[c] = tsblk;
    p.trc_out[c] = trc;
    p.trs_out[c] = trs;
    p.trss_out[c] = trss;
    p.trmn_out[c] = trmn;
    p.trmx_out[c] = trmx;
    p.isum_out[c] = isum;
    p.icnt_out[c] = icnt;
    p.pinit_out[c] = pinit;
  }
  // new ring: slot s holds the last written block k = s (mod w)
  const int i_end = i0 + n;
  for (int s = tid; s < w; s += kThreads) {
    int r = (s - i_end) % w;
    const int k_last = i_end - w + (r < 0 ? r + w : r);
    p.ring_out[static_cast<size_t>(c) * w + s] = ext_value(on_row, ring_row, k_last - i0, i0, w);
  }
  __syncthreads();
  const int used = min(s_count, cap);
  for (int q = used + tid; q < cap; q += kThreads) {
    const size_t at = static_cast<size_t>(c) * cap + q;
#pragma unroll
    for (int f = 0; f < 7; ++f) p.ev[f][at] = 0.f;
  }
}

// Shared memory a launch takes for window w and time tile `tile`: two
// staged tiles with their w-value prefix, the base thresholds, the bit mask.
int smem_bytes(int w, int tile) {
  const int w_al = (w + 3) & ~3;
  return static_cast<int>(sizeof(float)) * (2 * (w_al + tile) + tile + tile / 32);
}

}  // namespace

// Launches the solve on `stream`.  `ptrs` is a host array of 42 device
// pointers: on, pm, the 15 state leaves (StreamState order), thresholds,
// the 7 event fields, count, overflow, the 15 new state leaves.  Returns
// cudaGetLastError() after the launch.
extern "C" int ms_stream_solve(void* const* ptrs, int n, int C, int w, int cap, int tile,
                               float k_std, float block_sec, float init_wait_sec,
                               float min_mean_db, int min_dur_b, int lock_tail, void* stream) {
  Params p;
  int a = 0;
  p.on = static_cast<const float*>(ptrs[a++]);
  p.pm = static_cast<const float*>(ptrs[a++]);
  p.st = static_cast<const int*>(ptrs[a++]);
  p.i0 = static_cast<const int*>(ptrs[a++]);
  p.ring = static_cast<const float*>(ptrs[a++]);
  p.locked = static_cast<const float*>(ptrs[a++]);
  p.luntil = static_cast<const int*>(ptrs[a++]);
  p.tstart = static_cast<const float*>(ptrs[a++]);
  p.tsblk = static_cast<const int*>(ptrs[a++]);
  p.trc = static_cast<const int*>(ptrs[a++]);
  p.trs = static_cast<const float*>(ptrs[a++]);
  p.trss = static_cast<const float*>(ptrs[a++]);
  p.trmn = static_cast<const float*>(ptrs[a++]);
  p.trmx = static_cast<const float*>(ptrs[a++]);
  p.isum = static_cast<const float*>(ptrs[a++]);
  p.icnt = static_cast<const int*>(ptrs[a++]);
  p.pinit = static_cast<const float*>(ptrs[a++]);
  p.thr = static_cast<float*>(ptrs[a++]);
  for (int f = 0; f < 7; ++f) p.ev[f] = static_cast<float*>(ptrs[a++]);
  p.count = static_cast<int*>(ptrs[a++]);
  p.overflow = static_cast<bool*>(ptrs[a++]);
  p.st_out = static_cast<int*>(ptrs[a++]);
  p.i_out = static_cast<int*>(ptrs[a++]);
  p.ring_out = static_cast<float*>(ptrs[a++]);
  p.locked_out = static_cast<float*>(ptrs[a++]);
  p.luntil_out = static_cast<int*>(ptrs[a++]);
  p.tstart_out = static_cast<float*>(ptrs[a++]);
  p.tsblk_out = static_cast<int*>(ptrs[a++]);
  p.trc_out = static_cast<int*>(ptrs[a++]);
  p.trs_out = static_cast<float*>(ptrs[a++]);
  p.trss_out = static_cast<float*>(ptrs[a++]);
  p.trmn_out = static_cast<float*>(ptrs[a++]);
  p.trmx_out = static_cast<float*>(ptrs[a++]);
  p.isum_out = static_cast<float*>(ptrs[a++]);
  p.icnt_out = static_cast<int*>(ptrs[a++]);
  p.pinit_out = static_cast<float*>(ptrs[a++]);
  p.n = n;
  p.C = C;
  p.w = w;
  p.cap = cap;
  p.tile = std::min(tile, 32 * ((std::max(n, 1) + 31) / 32));  // a short chunk stages only itself
  p.k_std = k_std;
  p.block_sec = block_sec;
  p.init_wait_sec = init_wait_sec;
  p.min_mean_db = min_mean_db;
  p.min_dur_b = min_dur_b;
  p.lock_tail = lock_tail;

  // above the static 48 KB only with the attribute set; it refuses more
  // than the card has
  const int smem = smem_bytes(w, p.tile);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(stream_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  stream_solve_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
