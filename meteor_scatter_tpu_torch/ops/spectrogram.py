"""Spectrograms as batched rFFTs.

Counterpart of `meteor_scatter_tpu/ops/spectrogram.py`.  Two compatibility
modes cover both reference conventions:

* :func:`spectrogram_scipy` — ``scipy.signal.spectrogram(x, fs,
  window='hann', nperseg=N, noverlap=N//2, nfft=N, scaling='density',
  mode='psd')`` used by the batch analyzer's plots (`dsp/src/main.py:52`).
  Periodic Hann, detrend='constant'.

* :func:`spectrogram_mpl` — ``plt.specgram(x, Fs=fs, NFFT=N,
  noverlap=N//2)`` used by the live ML path (`meteor_detect_class/
  prime_detection.py:66`): *symmetric* Hann (matplotlib's
  ``window_hanning``), no detrend, scale_by_freq density scaling.

Both return (freqs, times, Sxx) with Sxx shaped (..., n_bins, n_frames)
like their originals, on the device of ``x``; freqs and times are numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from meteor_scatter_tpu_torch.device import constant_on
from meteor_scatter_tpu_torch.ops.framing import frame_signal
from meteor_scatter_tpu_torch.ops.window import hann_periodic, hann_symmetric


def _stft_psd(
    x: torch.Tensor,
    fs: float,
    nperseg: int,
    noverlap: int,
    nfft: int,
    win: np.ndarray,
    detrend_constant: bool,
) -> torch.Tensor:
    hop = nperseg - noverlap
    seg = frame_signal(x.to(torch.float32), nperseg, hop)
    if detrend_constant:
        seg = seg - seg.mean(dim=-1, keepdim=True)
    X = torch.fft.rfft(seg * constant_on(win.astype(np.float32), x.device), n=nfft, dim=-1)
    p = (X.real * X.real + X.imag * X.imag) / (fs * float(np.sum(win.astype(np.float64) ** 2)))
    nbins = nfft // 2 + 1
    scale = np.ones(nbins, dtype=np.float32) * 2.0
    scale[0] = 1.0
    if nfft % 2 == 0:
        scale[-1] = 1.0
    return p * constant_on(scale, x.device)


def spectrogram_scipy(
    x: torch.Tensor,
    fs: float,
    nperseg: int,
    noverlap: int | None = None,
    nfft: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """scipy.signal.spectrogram parity (psd mode, density scaling)."""
    if noverlap is None:
        noverlap = nperseg // 2
    if nfft is None:
        nfft = nperseg
    win = hann_periodic(nperseg)
    p = _stft_psd(x, fs, nperseg, noverlap, nfft, win, detrend_constant=True)
    hop = nperseg - noverlap
    nf = p.shape[-2]
    freqs = np.fft.rfftfreq(nfft, d=1.0 / fs)
    # scipy centers each segment: t = (start + nperseg/2) / fs
    times = (np.arange(nf) * hop + nperseg / 2.0) / fs
    return freqs, times, p.transpose(-1, -2)


def spectrogram_mpl(
    x: torch.Tensor,
    fs: float,
    nfft: int,
    noverlap: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """matplotlib ``plt.specgram`` parity (default mode='psd',
    scale_by_freq=True, window_hanning, detrend_none)."""
    if noverlap is None:
        noverlap = 128  # matplotlib default
    win = hann_symmetric(nfft)
    p = _stft_psd(x, fs, nfft, noverlap, nfft, win, detrend_constant=False)
    hop = nfft - noverlap
    nf = p.shape[-2]
    freqs = np.fft.rfftfreq(nfft, d=1.0 / fs)
    times = (np.arange(nf) * hop + nfft / 2.0) / fs
    return freqs, times, p.transpose(-1, -2)


def spectrogram_db(Sxx: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """10*log10(Sxx + eps), the reference's display transform
    (`main.py:61,153`)."""
    return 10.0 * torch.log10(Sxx + eps)
