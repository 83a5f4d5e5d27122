"""Per-event spectrogram image export.

Counterpart of `meteor_scatter_tpu/io/spec_export.py`: array-native
replacement for the reference's matplotlib figure exports — the batch
analyzer's ±3 s context crop around each detection (`dsp/src/main.py:721-790`)
and the live pipeline's waterfall-window export (`processor.py:294-343`,
frequency-limited to signal_freq ± limit_freq_offset_wf2_and_export, dB
range auto-gained from the initialization PSD mean ± wf_offset_vmin/vmax).

The spectrogram and the Welch PSD of a detection's cut run on the chosen
device; colorizing and PNG writing are numpy on the host.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from meteor_scatter_tpu_torch.device import DeviceLike, resolve_device
from meteor_scatter_tpu_torch.io.events_csv import OutputDetection
from meteor_scatter_tpu_torch.io.png import colorize, stamp_text, upscale_to, write_png
from meteor_scatter_tpu_torch.ops.spectrogram import spectrogram_scipy
from meteor_scatter_tpu_torch.ops.welch import welch_psd

_MARKER_RGB = (255, 80, 80)


def _dash_row(img: np.ndarray, row: int, rgb=_MARKER_RGB, period: int = 8) -> None:
    """Dashed horizontal marker line (the reference's axhline band edges,
    main.py:68-77) drawn in place."""
    if 0 <= row < img.shape[0]:
        cols = np.arange(img.shape[1])
        img[row, (cols % period) < period // 2] = rgb


def render_psd_panel(
    freqs: np.ndarray,
    pxx_db: np.ndarray,
    height: int,
    width: int,
    band: Optional[Tuple[float, float]] = None,
) -> np.ndarray:
    """Rasterize the reference's right-hand PSD panel
    (`internal_print_spec_and_psd_mod`, main.py:84-111): PSD dB as a
    polyline over frequency, dashed vertical lines at the band edges, and
    the dB range stamped as text."""
    img = np.full((height, width, 3), (18, 18, 28), np.uint8)
    f = np.asarray(freqs, np.float64)
    p = np.asarray(pxx_db, np.float64)
    good = np.isfinite(p)
    if f.size < 2 or not good.any():
        stamp_text(img, "no psd", 8, height // 2, scale=2)
        return img

    pad_t, pad_b, pad_x = 24, 16, 6
    lo, hi = float(p[good].min()), float(p[good].max())
    if hi <= lo:
        hi = lo + 1.0
    xs = np.linspace(f[0], f[-1], width - 2 * pad_x)
    ys = np.interp(xs, f, np.where(good, p, lo))
    yy = (pad_t + (hi - ys) / (hi - lo) * (height - pad_t - pad_b)).astype(int)
    yy = np.clip(yy, 0, height - 1)
    for i, x in enumerate(range(pad_x, width - pad_x)):
        y0, y1 = (yy[i], yy[i]) if i == 0 else (min(yy[i - 1], yy[i]), max(yy[i - 1], yy[i]))
        img[y0 : y1 + 1, x] = (240, 230, 120)

    if band is not None:
        rows = np.arange(height)
        for edge in band:
            if f[0] <= edge <= f[-1]:
                col = pad_x + int((edge - f[0]) / (f[-1] - f[0]) * (width - 2 * pad_x - 1))
                img[(rows % 8) < 4, col] = _MARKER_RGB

    stamp_text(img, "psd db", 6, 4, scale=2)
    stamp_text(img, f"{hi:.0f}", width - 50, pad_t, scale=2, color=(180, 180, 180))
    stamp_text(img, f"{lo:.0f}", width - 50, height - pad_b - 14, scale=2,
               color=(180, 180, 180))
    return img


def export_detection_spec(
    out_dir: str,
    det: OutputDetection,
    wav_data: np.ndarray,
    fs: float,
    n_fft: int = 1024,
    context_before_sec: float = 3.0,
    context_after_sec: float = 3.0,
    freq_band: Optional[Tuple[float, float]] = None,
    eps: float = 1e-10,
    device: DeviceLike = "cuda",
) -> str:
    """Crop ±context seconds around one detection and write
    ``spec_and_psd_{t0:.2f}_{t1:.2f}.png`` with both panels of the
    reference's `internal_print_spec_and_psd_mod` (main.py:40-124): the
    spectrogram waterfall (scipy convention, 70% width, dashed band-edge
    markers) and the Welch PSD of the whole cut (30% width, nperseg 4096
    like main.py:85-90).  Both transforms run on ``device``.

    Larger windows get the doubled n_fft the reference picks
    (`main.py:749-752`).
    """
    dev = resolve_device(device)
    t0 = max(det.t_start - context_before_sec, 0.0)
    t1 = min(det.t_stop + context_after_sec, len(wav_data) / fs)
    cut = np.asarray(wav_data[int(t0 * fs) : int(t1 * fs)], dtype=np.float32)
    dur = len(cut) / fs
    if dur > context_before_sec + context_after_sec + 2:
        n_fft = n_fft * 2
    cut_t = torch.from_numpy(cut).to(dev)

    freqs, times, sxx = spectrogram_scipy(cut_t, fs, nperseg=n_fft)
    sxx_db = 10.0 * np.log10(sxx.cpu().numpy() + eps)
    fvec = np.asarray(freqs)
    if freq_band is not None:
        mask = (fvec >= freq_band[0] - 50) & (fvec <= freq_band[1] + 50)
        sxx_db = sxx_db[mask]
        fvec = fvec[mask]
    # time on x, low frequencies at the bottom (origin='lower')
    spec_rgb = colorize(sxx_db[::-1, :])
    if freq_band is not None and len(fvec):
        for edge in freq_band:  # axhline markers at the band edges
            row = int(np.argmin(np.abs(fvec - edge)))
            _dash_row(spec_rgb, len(fvec) - 1 - row)
    spec_img = upscale_to(spec_rgb)

    # Welch PSD of the whole cut (reference fixes nperseg = nfft = 4096)
    psd_nfft = 4096
    nperseg = min(psd_nfft, len(cut))
    pxx = welch_psd(cut_t, fs, psd_nfft, nperseg=nperseg).cpu().numpy()
    f_psd = np.fft.rfftfreq(psd_nfft, d=1.0 / fs)
    if freq_band is not None:
        pmask = (f_psd >= freq_band[0] - 50) & (f_psd <= freq_band[1] + 50)
        f_psd, pxx = f_psd[pmask], pxx[pmask]
    pxx_db = 10.0 * np.log10(pxx + eps)
    psd_img = render_psd_panel(
        f_psd, pxx_db,
        height=spec_img.shape[0],
        width=max(spec_img.shape[1] * 3 // 7, 120),
        band=freq_band,
    )

    img = np.concatenate([spec_img, psd_img], axis=1)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"spec_and_psd_{det.t_start:.2f}_{det.t_stop:.2f}.png")
    write_png(path, img)
    return path


def export_waterfall_window(
    out_dir: str,
    waterfall_db: np.ndarray,  # (n_blocks, n_bins), most recent last
    freqs: np.ndarray,
    block_times: Sequence[float],
    time_start: float,
    time_stop: float,
    signal_freq: float,
    limit_freq_offset: float = 100.0,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    time_before_sec: float = 3.0,
    time_after_sec: float = 3.0,
) -> Optional[str]:
    """Live-path export: once [time_start - before, time_stop + after] fits
    inside the waterfall ring (`processor.py:304`), crop it in time and to
    signal_freq ± limit_freq_offset in frequency, and write
    ``spec_{t0:.2f}_{t1:.2f}.png``.  Returns None while the window has not
    fully entered the buffer yet.  Host-side: the ring is numpy."""
    t_lo = time_start - time_before_sec
    t_hi = time_stop + time_after_sec
    times = np.asarray(block_times)
    if len(times) == 0 or not (times[0] <= t_lo and t_hi <= times[-1]):
        return None
    tmask = (times >= t_lo) & (times <= t_hi)
    fmask = (freqs >= signal_freq - limit_freq_offset) & (freqs <= signal_freq + limit_freq_offset)
    crop = np.asarray(waterfall_db)[tmask][:, fmask]
    img = upscale_to(colorize(crop.T[::-1, :], vmin=vmin, vmax=vmax))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"spec_{time_start:.2f}_{time_stop:.2f}.png")
    write_png(path, img)
    return path
