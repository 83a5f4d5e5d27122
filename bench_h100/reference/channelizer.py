"""Plain reference of the wideband I/Q front end (BASELINE.json config 4:
a 2 MS/s complex capture, a channel bank, then per-channel detection),
written from its equations.  It imports torch and numpy only.

For a complex capture ``x[s] = xr[s] + j·xi[s]`` at ``fs`` samples/s (an
integer) and a channel centred at ``f_c`` Hz (an integer, negative allowed):

1. Mix at the input rate: ``z_c[s] = x[s]·exp(-j·φ_c(s))`` with the exact
   phase ``φ_c(s) = 2π·((s·f_c) mod fs)/fs``, the residue taken in int64,
   the angle and its cosine and sine in float64.
2. Low-pass ``z_c`` with the ``numtaps``-tap Hamming windowed sinc whose
   cut-off is ``bandwidth/2``, scaled to unit gain at DC
   (``scipy.signal.firwin``'s default), and
3. keep every ``decim``-th sample, centred as an odd filter's 'same'
   convolution: ``y_c[k] = Σ_j h[j]·z_c[k·decim + (numtaps − 1)/2 − j]``,
   ``z_c`` zero outside the capture, ``(n − 1)//decim + 1`` samples.
4. Take ``Re y_c``: a complex exponential carries its whole amplitude in
   one sideband, so the real part is the channel's audio at ``fs/decim``.
5. Resample by ``up/down``: ``up − 1`` zeros after each sample but the
   last, the ``2·20·max(up, down) + 1``-tap Hamming low-pass with cut-off
   ``1/max(up, down)`` of the stuffed rate's Nyquist and gain ``up``, every
   ``down``-th sample kept, centred as in step 3, ``ceil(n·up/down)``
   samples: ``scipy.signal.resample_poly(y, up, down, window=taps)``.

The channel centres are the stations' frequencies less the beacon's audio
tone, so each beacon lands on the tone in its channel's audio.  The stages
(:func:`stages`) are one decimation when ``fs`` is a multiple of the audio
rate, else a decimation to about four channel widths and then ``up/down``
to the audio rate: 2 MS/s → /200 → 10 kHz → ×3/5 → 6 kHz.

Steps 2-5 are computed directly: each output is its window of inputs times
the taps, one block of outputs at a time so that float64 copies fit beside
a run's captures.  Since the taps are real, ``Re y_c`` needs only
``Re z_c = xr·cos φ_c + xi·sin φ_c``, and only that is formed.

``precision`` is ``"float64"`` (the reference) or ``"tf32"`` (the
control: everything in float32, the channel filter's product with both
operands rounded to TF32's 10 mantissa bits, as tensor cores take float32
operands when TF32 is on; the resampler's product is not rounded).

Departures from the documented semantics: none in the arithmetic.  The
reference program has no wideband front end: steps 1-5 are the semantics
that the front end's documentation gives (its CLI defaults and docstrings),
written here without its polyphase fold of the mixer into the taps.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bench_h100.reference.fronts import _dtype, tf32_round

BLOCK_BYTES = 1 << 28  # the windows of one block of outputs, as one copy
TAPS_PER_PHASE = 20


def lowpass(numtaps: int, cutoff: float, fs: float) -> np.ndarray:
    """The Hamming windowed sinc of ``numtaps`` (odd) taps with its cut-off
    at ``cutoff`` Hz for the rate ``fs``, scaled to unit gain at DC."""
    f = 2.0 * cutoff / fs  # the cut-off as a fraction of the Nyquist rate
    n = np.arange(numtaps, dtype=np.float64)
    window = 0.54 - 0.46 * np.cos(2.0 * math.pi * n / (numtaps - 1))
    h = f * np.sinc(f * (n - (numtaps - 1) / 2.0)) * window
    return h / h.sum()


def stages(fs: int, audio_rate: int, bandwidth: float) -> Tuple[int, int, int]:
    """(decimation, up, down) from ``fs`` to ``audio_rate``."""
    if fs % audio_rate == 0:
        return fs // audio_rate, 1, 1
    decim = max(int(fs // (4 * bandwidth)), 1)
    r = Fraction(audio_rate * decim, fs)
    return decim, r.numerator, r.denominator


def iq_station_freqs(stations: int, spacing: float) -> list:
    """Stations of an I/Q capture: centred on 0 Hz in steps of
    ``spacing``, the one that would sit at 0 moved half a step up."""
    return [spacing * (i - stations // 2) or spacing / 2 for i in range(stations)]


def _window_product(u: torch.Tensor, taps: np.ndarray, step: int, k: int,
                    rounded: bool) -> torch.Tensor:
    """``out[..., i] = Σ_t u[..., i·step + t]·taps[T − 1 − t]`` for i < k:
    each window of ``u`` against the taps reversed (a convolution)."""
    w = torch.from_numpy(np.ascontiguousarray(taps[::-1])).to(u.device, u.dtype)
    win = u.unfold(-1, len(taps), step)[..., :k, :]
    if rounded:
        win, w = tf32_round(win), tf32_round(w)
    return win @ w


def _rows(k: int, width: int, channels: int, itemsize: int) -> int:
    return max(1, min(k, BLOCK_BYTES // (channels * width * itemsize)))


def channel_audio(x: torch.Tensor, fs: int, centers: Sequence[int], bandwidth: float,
                  decim: int, numtaps: int, precision: str = "float64") -> torch.Tensor:
    """Steps 1-4: ``x`` (n, 2) holds I and Q (a complex64 capture viewed as
    float32 pairs) on any device; returns (C, (n − 1)//decim + 1) audio at
    ``fs/decim`` on that device, in float64 (float32 for ``"tf32"``)."""
    dt = _dtype(precision)
    fs = int(fs)
    n = x.shape[0]
    half = (numtaps - 1) // 2
    n_out = (n - 1) // decim + 1
    h = lowpass(numtaps, bandwidth / 2.0, fs)
    dev = x.device
    ang = 2.0 * math.pi * torch.arange(fs, dtype=torch.float64, device=dev) / fs
    cos, sin = torch.cos(ang).to(dt), torch.sin(ang).to(dt)  # at each residue of fs
    fc = torch.tensor([int(f) % fs for f in centers], dtype=torch.int64, device=dev)[:, None]
    out = torch.empty((len(centers), n_out), dtype=dt, device=dev)
    rows = _rows(n_out, numtaps, len(centers), torch.finfo(dt).bits // 8)
    for k0 in range(0, n_out, rows):
        k = min(rows, n_out - k0)
        lo = k0 * decim - half  # the first input of the block's first window
        hi = lo + (k - 1) * decim + numtaps  # one past the last window's last
        seg = x[max(lo, 0):min(hi, n)].to(dt)
        seg = F.pad(seg.t(), (max(0, -lo), max(0, hi - n)))  # (2, hi - lo), zeros off the capture
        s = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        p = torch.remainder(torch.remainder(s, fs) * fc, fs)  # (C, hi - lo)
        re = seg[0] * cos[p] + seg[1] * sin[p]  # Re(x·exp(-jφ))
        out[:, k0:k0 + k] = _window_product(re, h, decim, k, precision == "tf32")
    return out


def resample(y: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Step 5 on ``y`` (C, n), in its dtype."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == down == 1:
        return y
    numtaps = 2 * TAPS_PER_PHASE * max(up, down) + 1
    taps = lowpass(numtaps, 1.0 / max(up, down), 2.0) * up
    half = (numtaps - 1) // 2
    c, n = y.shape
    n_out = -(-n * up // down)
    out = torch.empty((c, n_out), dtype=y.dtype, device=y.device)
    rows = _rows(n_out, numtaps, c, y.element_size())
    for o0 in range(0, n_out, rows):
        k = min(rows, n_out - o0)
        lo = o0 * down - half  # stuffed index of the block's first window's first tap
        width = (k - 1) * down + numtaps
        u = y.new_zeros((c, width))
        t0 = max(0, -(-lo // up))  # the first input sample inside the block
        t1 = min(n, (lo + width - 1) // up + 1)
        if t1 > t0:
            u[:, t0 * up - lo: (t1 - 1) * up - lo + 1: up] = y[:, t0:t1]
        out[:, o0:o0 + k] = _window_product(u, taps, down, k, False)
    return out


def iq_audio(x: torch.Tensor, fs: int, station_freqs: Sequence[float], audio_rate: int,
             tone_freq: float, channel_bandwidth: float, numtaps: int,
             precision: str = "float64") -> torch.Tensor:
    """Each station's audio at ``audio_rate``: (C, n_audio), steps 1-5."""
    decim, up, down = stages(int(fs), int(audio_rate), channel_bandwidth)
    centers = [int(round(f - tone_freq)) for f in station_freqs]
    audio = channel_audio(x, fs, centers, channel_bandwidth, decim, numtaps, precision)
    return resample(audio, up, down)
