// K2 — fused band power, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// meteor_scatter_tpu/ops/pallas/bandpower_kernel.py::_kernel.  Per frame:
// p = frame[0:L] @ M (M: L x ncols windowed DFT selectors, signal columns
// first), then band_e = sum(p^2 over the signal columns) + floor, noise_e
// likewise over the rest, and 10*log10 of each; writes band dB, noise dB
// and their difference.  The twin is
// meteor_scatter_tpu_torch/ops/kernels/bandpower_kernel.py::band_power_db_plain.
//
// What bounds it: the frame read.  At the 24 h analyzer shape (432 000
// frames, L = 1024 of each 1200-sample block, 14 columns) the kernel must
// read 1.77 GB, ~0.53 ms at 3.35 TB/s, while its 12.4 GFLOP of FP32 FMAs
// take ~0.19 ms at 67 TFLOP/s.  Design, to stay on the memory side:
//   * M sits in shared memory for the whole launch, column-major
//     (sm[k*L + s]) and zero-padded to KMAX columns, so the 32 lanes of a
//     warp read 32 consecutive words of a column: no bank conflicts.  At
//     L = 1024, KMAX = 16 that is 64 KB of dynamic shared memory.
//   * Frames are read in place from the flat samples with any row stride
//     (1200 for the analyzer's blocks): no framed copy.  A warp takes F
//     frames at once, lane j reading samples j, j+32, ... of each (128-byte
//     coalesced loads), so one shared-memory read of M feeds F FMAs.
//   * The grid is persistent (as many blocks as fit on the SMs); each block
//     loads M once and walks frame groups, so M's load is paid per block
//     and not per frame.
//   * A butterfly of warp shuffles sums each column over the lanes; lane 0
//     does the per-band sums, the floor and the logs.
// The product runs in full FP32 on the CUDA cores (no TF32, no tensor
// cores, no library call); only the order of its sums differs from the
// twin's cuBLAS product.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <int KMAX, int F>
__global__ void __launch_bounds__(kThreads, 2)
    bandpower_kernel(const float* __restrict__ frames, long long stride, int nf, int L,
                     const float* __restrict__ proj, int ncols, int n_band, float floor_,
                     float* __restrict__ out) {
  extern __shared__ float sm[];  // KMAX * L, column-major
  for (int idx = threadIdx.x; idx < KMAX * L; idx += kThreads) {
    const int k = idx / L;
    const int s = idx - k * L;
    sm[idx] = k < ncols ? proj[static_cast<long long>(s) * ncols + k] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ngroups = (nf + F - 1) / F;
  for (int g = blockIdx.x * kWarps + warp; g < ngroups; g += gridDim.x * kWarps) {
    const int f0 = g * F;
    const float* rows[F];
    bool valid[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      valid[f] = f0 + f < nf;
      rows[f] = frames + static_cast<long long>(valid[f] ? f0 + f : f0) * stride;
    }
    float acc[F][KMAX];
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int k = 0; k < KMAX; ++k) acc[f][k] = 0.f;

#pragma unroll 4
    for (int s = lane; s < L; s += 32) {
      float xv[F];
#pragma unroll
      for (int f = 0; f < F; ++f) xv[f] = valid[f] ? rows[f][s] : 0.f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const float m = sm[k * L + s];
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f][k] = fmaf(xv[f], m, acc[f][k]);
      }
    }

#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < ncols) {  // uniform over the warp
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) acc[f][k] += __shfl_xor_sync(0xffffffffu, acc[f][k], o);
        }
      }

    if (lane == 0) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if (!valid[f]) continue;
        float be = 0.f, ne = 0.f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          const float p2 = acc[f][k] * acc[f][k];
          if (k < n_band) {
            be += p2;
          } else if (k < ncols) {
            ne += p2;
          }
        }
        const float band_db = 10.f * log10f(be + floor_);
        const float noise_db = 10.f * log10f(ne + floor_);
        out[f0 + f] = band_db;
        out[static_cast<long long>(nf) + f0 + f] = noise_db;
        out[2 * static_cast<long long>(nf) + f0 + f] = band_db - noise_db;
      }
    }
  }
}

template <int KMAX, int F>
int launch(const float* frames, long long stride, int nf, int L, const float* proj, int ncols,
           int n_band, float floor_, float* out, cudaStream_t stream) {
  auto kernel = bandpower_kernel<KMAX, F>;
  const int smem = KMAX * L * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  const long long groups = (static_cast<long long>(nf) + F - 1) / F;
  const long long want = (groups + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(want < cap ? want : cap);
  kernel<<<blocks, kThreads, smem, stream>>>(frames, stride, nf, L, proj, ncols, n_band, floor_,
                                             out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`.  `frames` is nf rows of at least L
// floats, `stride` floats apart; `proj` is L x ncols row-major (ncols <=
// 32); `out` holds 3 * nf floats: band dB, noise dB, delta.  Returns the
// first CUDA error of the set-up or cudaGetLastError() after the launch.
extern "C" int ms_bandpower(const float* frames, long long stride, int nf, int L,
                            const float* proj, int ncols, int n_band, float floor_, float* out,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ncols <= 16) return launch<16, 4>(frames, stride, nf, L, proj, ncols, n_band, floor_, out, s);
  return launch<32, 2>(frames, stride, nf, L, proj, ncols, n_band, floor_, out, s);
}
