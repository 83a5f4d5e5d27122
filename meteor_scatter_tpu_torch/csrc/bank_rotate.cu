// The DDC channel bank's per-row phase rotation, hand-written for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package's bank
// (meteor_scatter_tpu/ops/fir.py::_bank_apply) leaves this rotation to
// XLA, which fuses its a-loop into the product's consumers.  In eager
// PyTorch the same loop is ~8 launches a tap column, each writing and
// re-reading a (C, n_out) temporary.  This kernel is that loop in one pass.
// Its twin is meteor_scatter_tpu_torch/ops/kernels/bank_kernel.py::
// bank_rotate_plain; the two are bit-exact.
//
// What it computes.  G is the bank's product laid out (B, 2, C, A, m),
// contiguous (B the flattened batch, 2 the cos / sin halves of the tap
// table, A the tap columns, m >= n_out + A - 1 frame rows); cr and sr are
// (C, >= n_out + A - 1) row phases with any row stride and unit column
// stride.  For every (b, c, n < n_out):
//   dc = sum_a cr[c, n+a] * G[b, 0, c, a, n+a] - sr[c, n+a] * G[b, 1, c, a, n+a]
//   ds = sum_a sr[c, n+a] * G[b, 0, c, a, n+a] + cr[c, n+a] * G[b, 1, c, a, n+a]
// written to dc and ds, each (B, C, n_out) contiguous.
//
// What bounds it: bytes.  6A flops an output against 8(A + 1) bytes, under
// one flop a byte where the card's FP32 peak has ~20 a byte.  At the I/Q
// cell's interior piece (C = 8, A = 3, n_out = 6.0e6) it reads G once
// (1.15 GB) and cr / sr once (0.38 GB) and writes dc / ds (0.38 GB):
// ~1.92 GB, 0.57 ms at 3.35 TB/s.
//
// Design.
//   * One block row (gridDim.y) per (b, c) output row; along it, each
//     block covers kThreads * kItems outputs, thread t taking outputs
//     t, t + kThreads, ...  Neighbouring threads take neighbouring n, so
//     each of the 2A rows of G and each row of cr / sr is read by a warp as
//     128 contiguous bytes; a row read at offset a (a > 0) straddles one
//     more 32-byte sector, which the next warp's read uses.
//   * Every tap column a reads cr / sr at n + a: the lines the a = 0 pass
//     brought in are in L1 for the later columns, so cr and sr come from
//     device memory about once.
//   * kItems outputs a thread: 4 * kItems independent loads are issued for
//     each tap column before its arithmetic, enough bytes in flight to
//     cover the memory latency at full occupancy.
//   * No shared memory and no synchronisation: nothing is reused across
//     threads but through L1.
//
// Exactness: the twin's eager order, one rounding per operation.  The
// accumulators start at +0.0f (the twin's zeros: +0 + -0 is +0), then for
// a = 0 .. A-1:
//   dc = (dc + cr*gc) - sr*gs ;  ds = (ds + sr*gc) + cr*gs
// each as __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts
// into an FMA.  No fast-math flag is used.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;

__global__ void __launch_bounds__(kThreads)
    rotate_kernel(const float* __restrict__ g, const float* __restrict__ cr, long long ld_cr,
                  const float* __restrict__ sr, long long ld_sr, float* __restrict__ dc,
                  float* __restrict__ ds, int c_n, int a_cols, long long m, int n_out) {
  const int row = blockIdx.y;  // b * C + c
  const int b = row / c_n;
  const int c = row - b * c_n;
  // G[b, 0, c, 0, 0] and G[b, 1, c, 0, 0]
  const float* gc_row = g + (static_cast<long long>(2 * b) * c_n + c) * a_cols * m;
  const float* gs_row = gc_row + static_cast<long long>(c_n) * a_cols * m;
  const float* cr_row = cr + static_cast<long long>(c) * ld_cr;
  const float* sr_row = sr + static_cast<long long>(c) * ld_sr;
  const int n0 = blockIdx.x * (kThreads * kItems) + threadIdx.x;

  float acc_c[kItems], acc_s[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) acc_c[k] = acc_s[k] = 0.f;

  for (int a = 0; a < a_cols; ++a) {
    const float* gca = gc_row + a * m + a;
    const float* gsa = gs_row + a * m + a;
    const float* cra = cr_row + a;
    const float* sra = sr_row + a;
    float vgc[kItems], vgs[kItems], vcr[kItems], vsr[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int n = n0 + k * kThreads;
      const bool in = n < n_out;
      vgc[k] = in ? gca[n] : 0.f;
      vgs[k] = in ? gsa[n] : 0.f;
      vcr[k] = in ? cra[n] : 0.f;
      vsr[k] = in ? sra[n] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      acc_c[k] = __fsub_rn(__fadd_rn(acc_c[k], __fmul_rn(vcr[k], vgc[k])),
                           __fmul_rn(vsr[k], vgs[k]));
      acc_s[k] = __fadd_rn(__fadd_rn(acc_s[k], __fmul_rn(vsr[k], vgc[k])),
                           __fmul_rn(vcr[k], vgs[k]));
    }
  }

  float* dc_row = dc + static_cast<long long>(row) * n_out;
  float* ds_row = ds + static_cast<long long>(row) * n_out;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int n = n0 + k * kThreads;
    if (n < n_out) {
      dc_row[n] = acc_c[k];
      ds_row[n] = acc_s[k];
    }
  }
}

}  // namespace

// Launches the rotation on `stream` for `rows` = B * C output rows of
// n_out outputs (shapes and layouts above).  The caller checks shapes,
// strides and the grid's limits (rows <= 65535).  Returns
// cudaGetLastError() after the launch.
extern "C" int ms_bank_rotate(const float* g, const float* cr, long long ld_cr, const float* sr,
                              long long ld_sr, float* dc, float* ds, int rows, int c_n,
                              int a_cols, long long m, int n_out, void* stream) {
  const int per_block = kThreads * kItems;
  const dim3 grid((n_out + per_block - 1) / per_block, rows);
  rotate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, cr, ld_cr, sr, ld_sr, dc, ds, c_n, a_cols, m, n_out);
  return static_cast<int>(cudaGetLastError());
}
