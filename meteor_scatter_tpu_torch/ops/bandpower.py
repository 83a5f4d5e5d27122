"""Band power extraction as one matrix product.

Counterpart of `meteor_scatter_tpu/ops/bandpower.py`.  The reference
computes, per 0.2 s block (`dsp/src/main.py:376-388`)::

    X = rfft(block * hanning(block_size), n=n_fft)
    band_db  = 10*log10( sum_{k in band}  |X_k|^2 + 1e-12 )
    noise_db = 10*log10( sum_{k in noise} |X_k|^2 + 1e-12 )

Only a handful of bins matter, so the needed bins are inner products with
windowed cos/sin rows: ``frames[num_blocks, L] @ M[L, 2K]``, then square and
per-band sums.  ``band_bins`` and ``band_projection_matrix`` are the
reference's numpy constructors, copied so that this module imports without JAX;
they give the same bits.  The product is a plain ``torch.matmul`` in full
float32 (TF32 is off, :mod:`meteor_scatter_tpu_torch.device`), as the JAX
path leaves it to XLA outside any kernel.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from meteor_scatter_tpu_torch.device import constant_on
from meteor_scatter_tpu_torch.ops.framing import frame_signal
from meteor_scatter_tpu_torch.ops.window import hann_symmetric


def band_bins(fs: float, n_fft: int, band: Tuple[float, float]) -> np.ndarray:
    """Indices of rfft bins inside [lo, hi] (inclusive), matching the
    reference's ``(freqs >= lo) & (freqs <= hi)`` masks."""
    freqs = np.fft.rfftfreq(n_fft, d=1.0 / fs)
    return np.nonzero((freqs >= band[0]) & (freqs <= band[1]))[0]


def band_projection_matrix(
    fs: float,
    n_fft: int,
    frame_len: int,
    bands: Sequence[Tuple[float, float]],
    dtype=np.float32,
) -> Tuple[np.ndarray, list]:
    """Build the windowed DFT-selector matrix.

    Returns ``(M, slices)`` where ``M`` has shape ``(L, 2*K_total)`` with
    L = min(frame_len, n_fft), and ``slices[b]`` selects the column range of
    band *b* such that::

        p = frames[:, :L] @ M            # (num_frames, 2*K_total)
        e_b = (p[:, slices[b]] ** 2).sum(-1)   ==  sum |rfft(w*frame, n_fft)[k]|^2

    The Hann window is folded into the matrix, so ``frames`` holds the *raw*
    signal.
    """
    L = min(frame_len, n_fft)
    win = hann_symmetric(frame_len)[:L]  # crop AFTER windowing, like rfft(y,n)
    n = np.arange(L, dtype=np.float64)

    cols = []
    slices = []
    start = 0
    for band in bands:
        ks = band_bins(fs, n_fft, band)
        for k in ks:
            phase = 2.0 * np.pi * k * n / n_fft
            cols.append(win * np.cos(phase))
            cols.append(win * np.sin(phase))
        slices.append(slice(start, start + 2 * len(ks)))
        start += 2 * len(ks)

    M = np.stack(cols, axis=1).astype(dtype) if cols else np.zeros((L, 0), dtype)
    return M, slices


def band_power_db(
    frames: torch.Tensor,
    projection: torch.Tensor,
    slices: Sequence[slice],
    power_floor: float = 1e-12,
) -> Tuple[torch.Tensor, ...]:
    """dB band powers for each band.

    frames: (..., num_frames, frame_len) raw signal frames.
    projection: (L, 2K) matrix from :func:`band_projection_matrix`, on the
    frames' device.

    Returns one ``(..., num_frames)`` dB tensor per band.
    """
    L = projection.shape[0]
    p = torch.matmul(frames[..., :L], projection)
    p2 = p * p
    return tuple(10.0 * torch.log10(p2[..., s].sum(-1) + power_floor) for s in slices)


def delta_power_db(
    x: torch.Tensor,
    fs: float,
    n_fft: int,
    block_size: int,
    freq_band: Tuple[float, float],
    noise_band: Tuple[float, float],
    power_floor: float = 1e-12,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """End-to-end reference hot loop: raw signal -> (band_db, noise_db, delta),
    on ``x``'s device.

    Equivalent to `dsp/src/main.py:373-393` for the whole file at once.
    """
    M, slices = band_projection_matrix(fs, n_fft, block_size, [freq_band, noise_band])
    frames = frame_signal(x.to(torch.float32), block_size, block_size)
    proj = constant_on(M, x.device)
    band_db, noise_db = band_power_db(frames, proj, slices, power_floor)
    return band_db, noise_db, band_db - noise_db
