"""The card's published peaks and the work each measured kernel has to do.

Peaks of one NVIDIA H100 SXM (data sheet, dense): 3.35 TB/s of HBM and
67 TFLOP/s in float32 outside the tensor cores, at the full 700 W; a card
set to a lower ``power.limit`` reads lower shares.  A kernel's least time
is the larger of its bytes over the memory rate and its operations over
the float32 rate (``torch_bench.py::bound``): each input byte read once,
each output byte written once, whatever the kernel reads again.

The work is a property of the problem (shapes, bands, block counts), not
of the code that does it, so a kernel that is replaced is held to the same.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from bench_h100.reference.fronts import band_bin_indices

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_s(bytes_moved: float, flops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def bandpower_gemm(n_blocks: int, fs: float, n_fft: int, block: int, bands) -> tuple:
    """(bytes, flops) of the batch band projection: the (n_blocks, L)
    frames (L = min(block, n_fft)) against the (L, 2K) cos / sin rows of
    the K band bins, and the (n_blocks, 2K) product written."""
    L = min(block, n_fft)
    cols = 2 * sum(len(band_bin_indices(fs, n_fft, b)) for b in bands)
    return 4.0 * (n_blocks * L + L * cols + n_blocks * cols), 2.0 * n_blocks * L * cols


def k1(n_blocks: int) -> tuple:
    """(bytes, flops) of the adaptive solver on one series without halo
    (``chip_smoke.py``'s count): the series in; thresholds, the above mask,
    run sums and scalars out; ~16 operations a block for the rolling
    statistics and run sums and one for the freeze recurrence."""
    return 4.0 * n_blocks + 16 + 13.0 * n_blocks, 16.0 * n_blocks + n_blocks


def k3(channels: int, n_blocks: int, avg_win: int, cap: int) -> tuple:
    """(bytes, flops) of the streaming solve (``chip_smoke.py::k3_bound``):
    the level and PSD-mean series and the thresholds, the event buffers,
    count and overflow, the state's 14 leaves and ring in and out; 2·w
    operations a block for the window sums."""
    return (3.0 * 4 * n_blocks * channels + 7.0 * 4 * channels * cap + 5.0 * channels
            + 2.0 * (14 * 4 + 4 * avg_win) * channels,
            2.0 * avg_win * n_blocks * channels)


@lru_cache(maxsize=4)
def welch_band_rank(fs: float, n_fft: int, nperseg: int, block: int, bands: tuple,
                    rtol: float = 1e-10) -> int:
    """The fewest directions that hold each band's Welch level of a block
    to ``rtol`` of its largest eigenvalue: the summed numerical rank of the
    bands' (block, block) quadratic forms (framing, window, detrend, DFT
    bins and segment mean in one)."""
    hop = nperseg - nperseg // 2
    offsets = range(0, block - nperseg + 1, hop)
    n = np.arange(nperseg)
    win = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / nperseg)
    rank = 0
    for band in bands:
        k = band_bin_indices(fs, n_fft, band)
        ang = 2.0 * math.pi * np.outer(n, k) / n_fft
        V = np.concatenate([np.cos(ang), np.sin(ang)], 1) * win[:, None]
        V -= V.mean(0, keepdims=True)
        M = np.zeros((block, block))
        for o in offsets:
            M[o: o + nperseg, o: o + nperseg] += V @ V.T
        lam = np.linalg.eigvalsh(M)
        rank += int((lam > rtol * lam[-1]).sum())
    return rank


def bins_front_gemm(rows: int, fs: float, n_fft: int, nperseg: int, block: int, bands) -> tuple:
    """(bytes, flops) of the bins front's projection: ``rows`` blocks of
    ``block`` samples read once against a factor of the bands' rank, the
    projections written once."""
    K = welch_band_rank(fs, n_fft, nperseg, block, tuple(tuple(b) for b in bands))
    return 4.0 * (rows * block + block * K + rows * K), 2.0 * rows * block * K
