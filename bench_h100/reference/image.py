"""Plain reference of the segment monitor's image path and its hourly
ledger, written from the deployed loop's documented semantics
(th-nuernberg/meteor-scatter ``meteor_detect_class/prime_detection.py:61-98,
128-247`` and ``detector_and_classification.py:7-88``).  It imports torch
and numpy only, and computes in float64.

* The spectrogram is matplotlib's ``specgram(x, Fs=fs, NFFT=n_fft,
  noverlap=n_fft // 2)`` in its default PSD mode: frames of ``n_fft``
  samples every ``n_fft / 2``, no detrend, the symmetric Hann window
  (``window_hanning``), ``|rfft|^2 / (fs * sum(w^2))`` (density scaling),
  doubled on every bin but DC and Nyquist (one-sided).
* The noise floor: the PSD summed over the bins of ``noise_band`` (edges
  included) and over every frame, over the band's width (bins x bin width),
  in dB; the display cut is ``vmin = density_db / (40 / 23) + cut``.
* The image is the PSD's dB over the bins of ``display_band``; its
  keypoints are the pixels above ``vmin`` (the threshold keypoints).
* DBSCAN at pixel resolution in the reference's rendered pixel scale (496
  px for 25 s, 365 px for 400 Hz): two keypoints are neighbours when
  ``(df * px_f)^2 + (dt * px_t)^2 <= eps^2``; a keypoint is core when it has
  ``min_samples`` neighbours, itself counted; clusters are the connected
  components of the cores under that relation (breadth-first, over the
  explicit list of neighbour offsets); a keypoint that is not core joins a
  cluster when a core of it is its neighbour, else it is noise.
* A cluster is critical when its bounding box lasts at least ``crit_px``
  reference pixels (0.5 s at the published 5 px).

**Where this departs from the reference code.**  sklearn's DBSCAN gives a
border keypoint (not core, a neighbour of cores of two clusters) to the
cluster that reached it first, which depends on the order its keypoints
come in (the ORB detector's order).  Here, as ``models/image.py``'s
docstring states for the port, it joins the cluster whose lowest core
pixel comes first in row-major (frequency, time) order.  The reference
renders a JPEG and finds ORB keypoints on it; the threshold keypoints are
the above-cut pixels of the array itself (no rendering, no ORB).

``precision="tf32"`` (the control) rounds the windowed frames to TF32's 10
mantissa bits before the FFT; everything else stays float64.

The ledger (``prime_detection.py:206-247``): each segment's counts are
added; when ``save_interval_min`` has passed since the hour's start, the
row ``hour start;critical + non-critical;critical`` is written, the counts
reset and the hour restarts at that moment; when the calendar day changes,
the counts reset without a row (the daily rotation).  The journal of the
hour in progress (the port's ``.inprogress.json``, which the reference
lacks) holds the hour's start, its counts so far and the day of the last
add.

The PNG copy of a segment with detections (``prime_detection.py:198-203``
saves the rendered figure): the display-band dB image, highest bin on top,
each pixel the colour of ``(dB - vmin) / (40 - vmin)`` clipped to [0, 1]
on a table of 21 viridis anchors, linear between anchors and truncated to
8 bits, blown up to blocks of ``ceil(320 / bins)`` x ``ceil(640 / frames)``
pixels.  **Departure**: matplotlib's figure (axes, the 256-entry viridis,
its size) is not reproduced; these are the port's documented PNG pixels.
"""

from __future__ import annotations

import math
import struct
import zlib
from collections import deque
from datetime import datetime, timedelta
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from bench_h100.reference.fronts import tf32_round

REF_PX_PER_SEC = 496.0 / 25.0
REF_PX_PER_HZ = 365.0 / 400.0
STEP = 64  # segments an FFT at a time
VMAX_DB = 40.0  # the PNG's top of scale
VIRIDIS = np.array(
    [[68, 1, 84], [71, 19, 101], [72, 36, 117], [70, 52, 128], [65, 68, 135], [59, 82, 139],
     [53, 95, 141], [47, 108, 142], [42, 120, 142], [37, 132, 142], [33, 145, 140],
     [30, 156, 137], [34, 168, 132], [47, 180, 124], [68, 191, 112], [94, 201, 98],
     [122, 209, 81], [155, 217, 60], [189, 223, 38], [223, 227, 24], [253, 231, 37]],
    dtype=np.float64)


class Cluster(NamedTuple):
    t_min: int
    t_max: int
    f_min: int
    f_max: int
    n_points: int
    critical: bool


def band_bins(fs: float, n_fft: int, band: Tuple[float, float]) -> np.ndarray:
    f = np.arange(n_fft // 2 + 1) * (fs / n_fft)
    return np.nonzero((f >= band[0]) & (f <= band[1]))[0]


def specgram_psd(x: torch.Tensor, fs: float, n_fft: int, precision: str = "float64"
                 ) -> torch.Tensor:
    """(S, n) audio -> (S, n_fft // 2 + 1, frames) float64 PSD."""
    hop = n_fft // 2
    n = np.arange(n_fft)
    w = torch.from_numpy(0.5 - 0.5 * np.cos(2.0 * math.pi * n / (n_fft - 1))).to(x.device)
    out = []
    for s0 in range(0, x.shape[0], STEP):
        frames = x[s0: s0 + STEP].to(torch.float64).unfold(-1, n_fft, hop) * w
        if precision == "tf32":
            frames = tf32_round(frames.to(torch.float32)).to(torch.float64)
        elif precision != "float64":
            raise ValueError(f"precision must be float64 or tf32, got {precision!r}")
        X = torch.fft.rfft(frames, dim=-1)
        p = (X.real ** 2 + X.imag ** 2) / (fs * float((w ** 2).sum()))
        p[..., 1: n_fft // 2] *= 2.0  # one-sided: every bin but DC and Nyquist
        out.append(p.transpose(-1, -2))
    return torch.cat(out)


def image(x: torch.Tensor, fs: float, n_fft: int, cut: float, noise_band, display_band,
          precision: str = "float64") -> Tuple[np.ndarray, np.ndarray]:
    """(S, n) audio -> the display-band dB images (S, bins, frames) and the
    cuts ``vmin`` (S,), float64 numpy."""
    p = specgram_psd(x, fs, n_fft, precision)
    nb = band_bins(fs, n_fft, noise_band)
    density = p[:, nb, :].sum(dim=(1, 2)) / (len(nb) * fs / n_fft)
    vmin = 10.0 * torch.log10(density) / (40.0 / 23.0) + cut
    db = 10.0 * torch.log10(p[:, band_bins(fs, n_fft, display_band), :])
    return db.cpu().numpy(), vmin.cpu().numpy()


def pixel_scale(fs: float, n_fft: int) -> Tuple[float, float]:
    """(px_f, px_t): reference pixels a frequency bin and a frame span."""
    return (fs / n_fft) * REF_PX_PER_HZ, (n_fft // 2) / fs * REF_PX_PER_SEC


def neighbour_offsets(eps: float, px_f: float, px_t: float) -> np.ndarray:
    """(m, 2) grid offsets (d bins, d frames) within ``eps`` reference px,
    (0, 0) included."""
    rf, rt = int(eps // px_f) + 1, int(eps // px_t) + 1
    df, dt = np.meshgrid(np.arange(-rf, rf + 1), np.arange(-rt, rt + 1), indexing="ij")
    keep = (df * px_f) ** 2 + (dt * px_t) ** 2 <= eps * eps
    return np.stack([df[keep], dt[keep]], axis=1)


def clusters(mask: np.ndarray, offsets: np.ndarray, min_samples: int, px_t: float,
             crit_px: float) -> List[Cluster]:
    """DBSCAN over the keypoints of the (bins, frames) bool ``mask``."""
    h, w = mask.shape
    f, t = np.nonzero(mask)  # row-major: keypoint k comes before k + 1
    k = len(f)
    if k == 0:
        return []
    index = np.full((h, w), -1, dtype=np.int64)
    index[f, t] = np.arange(k)
    nf = f[:, None] + offsets[None, :, 0]
    nt = t[:, None] + offsets[None, :, 1]
    inside = (nf >= 0) & (nf < h) & (nt >= 0) & (nt < w)
    nbr = np.where(inside, index[np.clip(nf, 0, h - 1), np.clip(nt, 0, w - 1)], -1)
    core = (nbr >= 0).sum(axis=1) >= min_samples
    label = np.full(k, -1, dtype=np.int64)
    n_clusters = 0
    for start in range(k):  # a cluster's id is the order of its first core
        if not core[start] or label[start] >= 0:
            continue
        label[start] = n_clusters
        queue = deque([start])
        while queue:
            for j in nbr[queue.popleft()]:
                if j >= 0 and core[j] and label[j] < 0:
                    label[j] = n_clusters
                    queue.append(j)
        n_clusters += 1
    member = label.copy()
    for i in np.nonzero(~core)[0]:
        reach = [label[j] for j in nbr[i] if j >= 0 and core[j]]
        if reach:
            member[i] = min(reach)
    out = []
    for c in range(n_clusters):
        sel = member == c
        t_lo, t_hi = int(t[sel].min()), int(t[sel].max())
        out.append(Cluster(t_lo, t_hi, int(f[sel].min()), int(f[sel].max()), int(sel.sum()),
                           bool((t_hi - t_lo) * px_t >= crit_px)))
    return out


def tied(db: np.ndarray, vmin: float, tie_db: float, found: Sequence[Cluster], offsets, min_samples,
         px_t, crit_px) -> bool:
    """Whether a pixel within ``tie_db`` of ``vmin`` changes the clusters
    when it goes to the other side of the cut."""
    mask = db > vmin
    want = sorted(found)
    for f, t in zip(*np.nonzero(np.abs(db - vmin) < tie_db)):
        flipped = mask.copy()
        flipped[f, t] = not flipped[f, t]
        if sorted(clusters(flipped, offsets, min_samples, px_t, crit_px)) != want:
            return True
    return False


def ledger(counts: Sequence[Tuple[int, int]], clocks: Sequence[datetime], start: datetime,
           save_interval_min: float) -> Tuple[List[Tuple[str, int, int]], dict]:
    """The rows ``(timestamp, Anzahl, Kritisch)`` a ledger started at
    ``start`` writes for segments with (critical, non-critical) ``counts``
    added at ``clocks``, and its journal after the last add."""
    interval = timedelta(minutes=save_interval_min)
    hour_start, day = start, start.date()
    crit = non = 0
    rows = []
    for (c, n), now in zip(counts, clocks):
        crit += int(c)
        non += int(n)
        if now - hour_start >= interval:
            rows.append((hour_start.strftime("%Y-%m-%d %H:%M:%S"), crit + non, crit))
            crit = non = 0
            hour_start = now
        if now.date() != day:
            day = now.date()
            crit = non = 0
    journal = {"hour_start": hour_start.isoformat(), "critical": crit, "non_critical": non,
               "date": day.isoformat()}
    return rows, journal


def png_bounds(db: np.ndarray, vmin: float, db_gap: float, vmin_gap: float
               ) -> Tuple[np.ndarray, np.ndarray]:
    """The PNG pixels (H, W, 3) that an image within ``db_gap`` of ``db``
    with a cut within ``vmin_gap`` of ``vmin`` renders to: the lowest and
    the highest 8-bit value of each channel."""
    # the colour coordinate rises with the dB and, below the top of scale,
    # falls with the cut; clipped, the same bounds hold above it
    lo_v, hi_v = vmin + vmin_gap, vmin - vmin_gap
    x_lo = np.clip((db - db_gap - lo_v) / (VMAX_DB - lo_v), 0.0, 1.0)
    x_hi = np.clip((db + db_gap - hi_v) / (VMAX_DB - hi_v), 0.0, 1.0)
    x_lo = np.where(np.isfinite(db), x_lo, 0.0)
    x_hi = np.where(np.isfinite(db), x_hi, 0.0)
    n = len(VIRIDIS) - 1

    def colour(x):
        pos = x * n
        lo = np.minimum(np.floor(pos).astype(np.int64), n - 1)
        frac = (pos - lo)[..., None]
        return VIRIDIS[lo] * (1.0 - frac) + VIRIDIS[lo + 1] * frac

    c_lo, c_hi = colour(x_lo), colour(x_hi)
    low, high = np.minimum(c_lo, c_hi), np.maximum(c_lo, c_hi)
    for k in range(1, n):  # an anchor between the two ends
        inside = ((x_lo < k / n) & (k / n < x_hi))[..., None]
        low = np.where(inside, np.minimum(low, VIRIDIS[k]), low)
        high = np.where(inside, np.maximum(high, VIRIDIS[k]), high)
    flip = slice(None, None, -1)
    fy, fx = -(-320 // db.shape[0]), -(-640 // db.shape[1])
    up = lambda a: np.repeat(np.repeat(a[flip], fy, axis=0), fx, axis=1)
    return up(np.floor(low - 1e-6)), up(np.floor(high + 1e-6))


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG without interlace as (H, W, 3) uint8; every
    scanline filter of the PNG specification is undone."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos: pos + 4])
        tag, body = data[pos + 4: pos + 8], data[pos + 8: pos + 8 + ln]
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + ln
    if head is None or head[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not 8-bit RGB without interlace: {head}")
    w, h = head[:2]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    out = np.zeros((h + 1, 3 * w), dtype=np.int64)  # row 0: the zero row above the first
    for y in range(h):
        f, line, up = int(raw[y, 0]), raw[y, 1:].astype(np.int64), out[y]
        if f == 0:
            row = line
        elif f == 2:
            row = (line + up) % 256
        elif f == 1:
            row = np.cumsum(line.reshape(w, 3), axis=0).reshape(-1) % 256
        elif f in (3, 4):
            row = np.zeros(3 * w, dtype=np.int64)
            for i in range(3 * w):
                a = row[i - 3] if i >= 3 else 0
                c = up[i - 3] if i >= 3 else 0
                if f == 3:
                    pred = (a + up[i]) // 2
                else:
                    p = a + up[i] - c
                    pa, pb, pc = abs(p - a), abs(p - up[i]), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (up[i] if pb <= pc else c)
                row[i] = (line[i] + pred) % 256
        else:
            raise ValueError(f"{path}: scanline filter {f}")
        out[y + 1] = row
    return out[1:].reshape(h, w, 3).astype(np.uint8)
