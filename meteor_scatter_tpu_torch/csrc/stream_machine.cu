// K3 — fused streaming state machine, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// meteor_scatter_tpu/ops/pallas/stream_kernel.py::_kernel.  One launch runs
// the reference's 3-state live detector (Init -> Detect -> Track,
// dsp/src/live/backend/processor.py:444-510) over n blocks of C channels,
// step for step as the plain twin
// meteor_scatter_tpu_torch/ops/kernels/stream_kernel.py::stream_machine_plain.
//
// What bounds it: the serial chain, not bytes or operations.  Each step of
// a channel depends on the step before through the 13-field carry, so a
// channel is n dependent steps of ~50 instructions (two IEEE divisions and
// a square root among them).  The bytes (12 series of n x C floats, 9.2 MB
// at 3 000 x 64) would take ~3 us at 3.35 TB/s; the chain takes far longer.
// Design: one thread per channel, the carry in registers, one loop over
// all n blocks in a single launch.  Series are (n, C) time-major, so the 32
// threads of a warp read and write 32 neighbouring channels at each step
// (coalesced).  The inputs of kGroup steps are loaded together before they
// are used, so one load latency is paid per group rather than per step.
// Warps of 32 threads, one per block, spread the channels over the SMs;
// the TPU's 128-lane cap, 512-block grid chunks and (8, 128) tile walk do
// not carry over: any C and any n run in one launch.
//
// Exactness: the twin's float ops are separate PyTorch ops, each rounded
// once.  nvcc would contract a*b+c into an FMA, so every float op here is
// an explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn), which the compiler never contracts.  The
// float constants arrive rounded to float32, as the twin's are.  min/max
// propagate NaN as torch.minimum/maximum do (fminf/fmaxf would drop it);
// comparisons against a NaN base threshold (empty ring) are false.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
constexpr int kGroup = 8;

enum : int { INIT = 0, DETECT = 1, TRACK = 2 };

// torch.minimum / torch.maximum on floats: a NaN input is returned as it is.
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

struct Params {
  const float* on;       // (n, C)
  const float* pm;       // (n, C)
  const float* bt;       // (n, C)
  const float* carry_f;  // (8, C)
  const int* carry_i;    // (6, C)
  int n;
  int C;
  float block_sec;
  float init_wait_sec;
  float min_mean_db;
  int min_dur_b;
  int lock_tail;
  float* ys;             // (8, n, C): thr, tstart, t_stop, dur, trmn, trmx, h_mean, h_std
  int* emit;             // (n, C)
  float* carry_f_out;    // (8, C)
  int* carry_i_out;      // (6, C)
};

__global__ void __launch_bounds__(kThreads) stream_machine_kernel(Params p) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= p.C) return;
  const size_t C = static_cast<size_t>(p.C);
  const size_t plane = static_cast<size_t>(p.n) * C;

  float locked = p.carry_f[0 * C + c];
  float tstart = p.carry_f[1 * C + c];
  float trs = p.carry_f[2 * C + c];
  float trss = p.carry_f[3 * C + c];
  float trmn = p.carry_f[4 * C + c];
  float trmx = p.carry_f[5 * C + c];
  float isum = p.carry_f[6 * C + c];
  float pinit = p.carry_f[7 * C + c];
  int st = p.carry_i[0 * C + c];
  int luntil = p.carry_i[1 * C + c];
  int tsblk = p.carry_i[2 * C + c];
  int trc = p.carry_i[3 * C + c];
  int icnt = p.carry_i[4 * C + c];
  int i = p.carry_i[5 * C + c];

  const float inf = __int_as_float(0x7f800000);

  for (int base = 0; base < p.n; base += kGroup) {
    float on_g[kGroup], pm_g[kGroup], bt_g[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int t = base + k;
      const size_t at = static_cast<size_t>(t) * C + c;
      on_g[k] = t < p.n ? p.on[at] : 0.f;
      pm_g[k] = t < p.n ? p.pm[at] : 0.f;
      bt_g[k] = t < p.n ? p.bt[at] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int t = base + k;
      if (t >= p.n) break;
      const float on = on_g[k], pm = pm_g[k], bt = bt_g[k];
      const float t_start = __fmul_rn(__int2float_rn(i), p.block_sec);

      const float thr = st == TRACK ? locked : ((st == DETECT && i <= luntil) ? locked : bt);

      const float new_isum = __fadd_rn(isum, pm);
      const int new_icnt = icnt + 1;
      const bool init_done = t_start >= p.init_wait_sec;
      const float pinit_new = __fdiv_rn(new_isum, __int2float_rn(max(new_icnt, 1)));

      const bool enter_track = on > thr;
      const int n_trc = trc + 1;
      const float n_trs = __fadd_rn(trs, on);
      const float n_trss = __fadd_rn(trss, __fmul_rn(on, on));
      const float n_trmn = min_nan(trmn, on);
      const float n_trmx = max_nan(trmx, on);
      const bool leave_track = on < thr;

      const float dur = __fsub_rn(t_start, tstart);
      const float h_cnt = __int2float_rn(max(n_trc, 1));
      const float h_mean = __fdiv_rn(n_trs, h_cnt);
      const float var = __fsub_rn(__fdiv_rn(n_trss, h_cnt), __fmul_rn(h_mean, h_mean));
      const float h_std = __fsqrt_rn(max_nan(var, 0.f));
      const bool accept = h_mean >= p.min_mean_db && (i - tsblk) >= p.min_dur_b;

      const bool is_init = st == INIT;
      const bool is_detect = st == DETECT;
      const bool is_track = st == TRACK;
      const bool emit = is_track && leave_track && accept;

      const int next_state =
          is_init ? (init_done ? DETECT : INIT)
                  : (is_detect ? (enter_track ? TRACK : DETECT) : (leave_track ? DETECT : TRACK));
      const bool start_track = is_detect && enter_track;

      const size_t at = static_cast<size_t>(t) * C + c;
      p.ys[0 * plane + at] = thr;
      p.ys[1 * plane + at] = tstart;
      p.ys[2 * plane + at] = t_start;
      p.ys[3 * plane + at] = dur;
      p.ys[4 * plane + at] = n_trmn;
      p.ys[5 * plane + at] = n_trmx;
      p.ys[6 * plane + at] = h_mean;
      p.ys[7 * plane + at] = h_std;
      p.emit[at] = emit ? 1 : 0;

      if (start_track) locked = thr;
      if (is_track && leave_track) luntil = i + (p.lock_tail - 1);
      if (start_track) tstart = t_start;
      if (start_track) tsblk = i;
      trc = start_track ? 0 : (is_track ? n_trc : trc);
      trs = start_track ? 0.f : (is_track ? n_trs : trs);
      trss = start_track ? 0.f : (is_track ? n_trss : trss);
      trmn = start_track ? inf : (is_track ? n_trmn : trmn);
      trmx = start_track ? -inf : (is_track ? n_trmx : trmx);
      if (is_init) isum = new_isum;
      if (is_init) icnt = new_icnt;
      if (is_init && init_done) pinit = pinit_new;
      st = next_state;
      i += 1;
    }
  }

  p.carry_f_out[0 * C + c] = locked;
  p.carry_f_out[1 * C + c] = tstart;
  p.carry_f_out[2 * C + c] = trs;
  p.carry_f_out[3 * C + c] = trss;
  p.carry_f_out[4 * C + c] = trmn;
  p.carry_f_out[5 * C + c] = trmx;
  p.carry_f_out[6 * C + c] = isum;
  p.carry_f_out[7 * C + c] = pinit;
  p.carry_i_out[0 * C + c] = st;
  p.carry_i_out[1 * C + c] = luntil;
  p.carry_i_out[2 * C + c] = tsblk;
  p.carry_i_out[3 * C + c] = trc;
  p.carry_i_out[4 * C + c] = icnt;
  p.carry_i_out[5 * C + c] = i;
}

}  // namespace

// Launches the machine on `stream`.  Pointers are device pointers; `ys`
// holds 8 * n * C floats, `emit` n * C ints.  Returns cudaGetLastError()
// after the launch.
extern "C" int ms_stream_machine(const float* on, const float* pm, const float* bt,
                                 const float* carry_f, const int* carry_i, int n, int C,
                                 float block_sec, float init_wait_sec, float min_mean_db,
                                 int min_dur_b, int lock_tail, float* ys, int* emit,
                                 float* carry_f_out, int* carry_i_out, void* stream) {
  Params p;
  p.on = on;
  p.pm = pm;
  p.bt = bt;
  p.carry_f = carry_f;
  p.carry_i = carry_i;
  p.n = n;
  p.C = C;
  p.block_sec = block_sec;
  p.init_wait_sec = init_wait_sec;
  p.min_mean_db = min_mean_db;
  p.min_dur_b = min_dur_b;
  p.lock_tail = lock_tail;
  p.ys = ys;
  p.emit = emit;
  p.carry_f_out = carry_f_out;
  p.carry_i_out = carry_i_out;
  const int blocks = (C + kThreads - 1) / kThreads;
  stream_machine_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
