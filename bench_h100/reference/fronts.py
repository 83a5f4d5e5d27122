"""Plain reference of the two spectral fronts, written from the reference
program's documented semantics.  It imports torch and numpy only.

* Batch band power (``dsp/src/main.py:376-388``): per block of
  ``block`` samples, ``X = rfft(block * hanning(block), n=n_fft)`` (the
  windowed block cropped to ``n_fft`` samples when it is longer), and per
  band ``10 log10(sum_{k in band} |X_k|^2 + 1e-12)``; the detection series
  is the signal band's dB less the noise band's.
* Welch band levels (``dsp/src/live/backend/processor.py:206,349-393``):
  ``scipy.signal.welch(block, fs, nfft=n_fft)`` with scipy's defaults
  (256-sample periodic Hann segments at half overlap, constant detrend,
  density scaling, one-sided), summed over each band's bins; the over-noise
  level is the signal band's dB less the mean of the two noise bands' dB.

Only the bins inside the bands are needed, so each is computed as the DFT
sum at that bin: a product of the windowed segments with cos / sin rows.

``precision`` is ``"float64"`` (the reference) or ``"tf32"`` (the control:
the products' operands rounded to TF32's 10 mantissa bits, as tensor cores
take float32 operands when TF32 is on, and everything else in float32).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

PRECISIONS = ("float64", "tf32")
STEP = 32768  # blocks a product at a time, so that float64 copies fit beside the window's data


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest (ties to even) at 10 mantissa
    bits, the operand precision of a TF32 product."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def _dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return torch.float64 if precision == "float64" else torch.float32


def _product(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def band_bin_indices(fs: float, n_fft: int, band: Tuple[float, float]) -> np.ndarray:
    """rfft bins whose frequency lies in [lo, hi], edges included."""
    k = np.arange(n_fft // 2 + 1)
    f = k * (fs / n_fft)
    return k[(f >= band[0]) & (f <= band[1])]


def _dft_rows(n: int, n_fft: int, bins: np.ndarray) -> np.ndarray:
    """(n, 2·len(bins)) float64: cos and sin of the DFT at ``bins`` over n
    samples of an ``n_fft``-point transform."""
    ang = 2.0 * math.pi * np.outer(np.arange(n), bins) / n_fft
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=1)


def batch_band_db(x: torch.Tensor, fs: float, n_fft: int, block: int,
                  bands: Sequence[Tuple[float, float]], precision: str = "float64") -> list:
    """Per-block dB power of each band for a 1-D series ``x`` (any real
    dtype, on any device); returns one float64 numpy array per band."""
    dt = _dtype(precision)
    nb = x.shape[-1] // block
    L = min(block, n_fft)
    n = np.arange(block)
    win = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / (block - 1))  # np.hanning(block)
    bins = [band_bin_indices(fs, n_fft, b) for b in bands]
    rows = torch.from_numpy(_dft_rows(L, n_fft, np.concatenate(bins))).to(x.device, dt)
    w = torch.from_numpy(win[:L]).to(x.device, dt)
    out = [np.empty(nb) for _ in bands]
    for r0 in range(0, nb, STEP):
        r1 = min(nb, r0 + STEP)
        frames = x[r0 * block: r1 * block].reshape(r1 - r0, block)[:, :L].to(dt) * w
        p = _product(frames, rows, precision)
        p2 = p * p
        half = p.shape[1] // 2
        power = p2[:, :half] + p2[:, half:]  # |X_k|^2 a bin
        c0 = 0
        for b, kb in enumerate(bins):
            s = power[:, c0: c0 + len(kb)].sum(1)
            out[b][r0:r1] = (10.0 * torch.log10(s + 1e-12)).double().cpu().numpy()
            c0 += len(kb)
    return out


def welch_band_db(x: torch.Tensor, fs: float, n_fft: int, block: int,
                  bands: Sequence[Tuple[float, float]], nperseg: int = 256,
                  precision: str = "float64") -> list:
    """Per-block Welch band levels in dB for ``x`` (..., n) cut into whole
    blocks; returns one float64 numpy array (..., n_blocks) per band."""
    dt = _dtype(precision)
    lead = x.shape[:-1]
    nb = x.shape[-1] // block
    xb = x[..., : nb * block].reshape(-1, block)
    nper = min(nperseg, block)
    hop = nper - nper // 2
    offsets = range(0, block - nper + 1, hop)
    nseg = len(offsets)
    n = np.arange(nper)
    win = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / nper)  # periodic Hann
    scale = 1.0 / (fs * float(np.sum(win ** 2)))
    bins = [band_bin_indices(fs, n_fft, b) for b in bands]
    allb = np.concatenate(bins)
    onesided = np.where((allb == 0) | ((n_fft % 2 == 0) & (allb == n_fft // 2)), 1.0, 2.0)
    rows = torch.from_numpy(_dft_rows(nper, n_fft, allb)).to(x.device, dt)
    w = torch.from_numpy(win).to(x.device, dt)
    weight = torch.from_numpy(onesided * scale / nseg).to(x.device, dt)
    total = xb.shape[0]
    out = [np.empty(total) for _ in bands]
    for r0 in range(0, total, STEP):
        r1 = min(total, r0 + STEP)
        blk = xb[r0:r1].to(dt)
        acc = None
        for o in offsets:
            seg = blk[:, o: o + nper]
            seg = (seg - seg.mean(1, keepdim=True)) * w
            p = _product(seg, rows, precision)
            p2 = p * p
            half = p.shape[1] // 2
            pw = p2[:, :half] + p2[:, half:]
            acc = pw if acc is None else acc + pw
        psd = acc * weight  # the mean over segments of the scaled |X_k|^2
        c0 = 0
        for b, kb in enumerate(bins):
            s = psd[:, c0: c0 + len(kb)].sum(1)
            out[b][r0:r1] = (10.0 * torch.log10(s)).double().cpu().numpy()
            c0 += len(kb)
    return [o.reshape(tuple(lead) + (nb,)) for o in out]


def over_noise_db(x: torch.Tensor, fs: float, n_fft: int, block: int, signal_band, noise_band_1,
                  noise_band_2, nperseg: int = 256, precision: str = "float64") -> np.ndarray:
    """The live detector's per-block level over noise (``processor.py:393``)."""
    ms, n1, n2 = welch_band_db(x, fs, n_fft, block, (signal_band, noise_band_1, noise_band_2),
                               nperseg, precision)
    return ms - (n1 + n2) / 2.0
