"""Seeded inputs of the golden outputs in ``tests/data/golden/``.

The JAX package makes the golden outputs on the CPU
(``tools/make_golden.py``); ``chip_smoke.py`` runs the PyTorch port on the
same inputs on the card and holds it against them
(``tools/golden_compare.py``).  Both build the inputs here, from seeds, with
numpy and the standard library only: this module imports neither torch nor
JAX, so the card needs no JAX and the generator no torch.

Configurations (BASELINE.md's numbering):

* ``G1`` (config 1) -- a 24 h, 6 kHz int16 day: noise of std 0.5, a 1 s
  1003 Hz tone of amplitude 2 every 47 s from 10 s, scaled by 3000, and one
  more tone straddling each seam of the fused adaptive solver's chunks.
  ``G1_CUT`` is its first hour as a WAV of its own.
* ``G2`` (config 2) -- a 24 h, 4 kHz int16 day: noise of std 0.05, a 1 s
  1000 Hz tone of amplitude 0.6 every 47 s from 20 s, scaled by 32768.
* ``G3`` (config 5) -- 64 stations x 600 s at 4 kHz, float32 (seed 7).
* ``G4`` (configs 3 and 4) -- ``apps.frontend.main``'s own synthesis at
  :data:`G4_ARGV`, real and ``--iq``; only its argument vector lives here.
* ``G5`` (the monitor) -- a 6 h, 5 kHz int16 day: noise of std 300, a 1 s
  1000 Hz burst of amplitude 3000 in each 30 s segment but every fifth.

Each day is made hour by hour from child seeds
(``np.random.SeedSequence(seed).spawn(hours)``), so hours are made in
parallel and one hour can be rebuilt alone.  A tone's samples come from a
table of ``sin(2 pi k / fs)``, indexed by ``(sample * freq) mod fs``: the
same integers on every machine, so only the table's ``np.sin`` could differ
by an ulp between machines, and rounding to int16 hides that unless a
value lies on a rounding boundary.  The SHA-256 of each hour's int16 bytes
(:func:`sha256`) says which: a mismatch reads "fixture differs", not "port
differs".
"""

from __future__ import annotations

import hashlib
import os
import wave
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

BLOCK_SEC = 0.2
# The fused adaptive solver's chunk (MAX_FUSED_BLOCKS of both packages'
# adaptive kernels) and the analyzer's 120 s window at 0.2 s blocks: a day
# longer than one chunk runs as chunks starting every CHUNK - WINDOW blocks.
K1_CHUNK_BLOCKS = 131072
ANALYZER_WINDOW_BLOCKS = 600

G1_FS, G1_HOURS, G1_SEED = 6000, 24, 2026
G1_NOISE, G1_AMP, G1_SCALE, G1_TONE_HZ, G1_FIRST_SEC = 0.5, 2.0, 3000.0, 1003, 10.0
# the gqrx-style name gives the analyzer its UTC columns
G1_WAV = "brams_gqrx_20260817_000000_49969000.wav"
G1_CUT_HOURS = 1

G2_FS, G2_HOURS, G2_SEED = 4000, 24, 47
G2_NOISE, G2_AMP, G2_SCALE, G2_TONE_HZ, G2_FIRST_SEC = 0.05, 0.6, 32768.0, 1000, 20.0
G2_WAV = "live_4khz_24h.wav"
G2_ARGS = ["--min-dur", "0.5", "--min-mean-db", "1"]

G3_FS, G3_STATIONS, G3_SECONDS, G3_SEED = 4000, 64, 600.0, 7
G3_NOISE, G3_AMP, G3_TONE_HZ = 0.3, 1.5, 1000.0

G4_ARGV = ["--fs", "2000000.0", "--seconds", "60.0", "--stations", "8",
           "--base-freq", "100000.0", "--spacing", "50000.0"]

G5_FS, G5_HOURS, G5_SEED, G5_SEG_SEC = 5000, 6, 5, 30
G5_NOISE, G5_AMP, G5_TONE_HZ = 300.0, 3000.0, 1000
G5_WAV = "monitor_5khz.wav"
# The replay's audio clock (``--start-time``): fixed, so the CSVs' names and
# rows are the same on every day the golden outputs are read.
G5_START = "2026-08-16T21:00:00"

TONE_EVERY_SEC = 47.0


class Day(NamedTuple):
    """A synthetic recording: rate, int16 samples, the tones' start times in
    seconds, and the SHA-256 of each hour's int16 bytes."""

    fs: int
    pcm: np.ndarray
    tones: List[float]
    hour_sha256: List[str]


def sha256(a: np.ndarray) -> str:
    """SHA-256 of an array's bytes (C order)."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def k1_seam_blocks(n_blocks: int, chunk: int = K1_CHUNK_BLOCKS,
                   window: int = ANALYZER_WINDOW_BLOCKS) -> List[int]:
    """The first block of every chunk but the first, when a series of
    ``n_blocks`` runs through the fused adaptive solver in chunks."""
    if n_blocks <= chunk:
        return []
    return list(range(chunk - window, n_blocks, chunk - window))


def g1_tones() -> List[float]:
    """Tone starts: every 47 s from 10 s, and one 1 s tone centred on each
    chunk seam of the day."""
    seconds = G1_HOURS * 3600
    regular = np.arange(G1_FIRST_SEC, seconds - 5.0, TONE_EVERY_SEC).tolist()
    seams = [b * BLOCK_SEC - 0.5 for b in k1_seam_blocks(int(seconds / BLOCK_SEC))]
    return sorted(regular + seams)


def g2_tones() -> List[float]:
    seconds = G2_HOURS * 3600
    return np.arange(G2_FIRST_SEC, seconds - 5.0, TONE_EVERY_SEC).tolist()


def g5_bursts() -> List[bool]:
    """Which 30 s segments hold a burst: all but every fifth."""
    return [k % 5 != 4 for k in range(G5_HOURS * 3600 // G5_SEG_SEC)]


def g5_tones() -> List[float]:
    """A burst at 5 + (k mod 20) s into each burst segment k."""
    return [k * G5_SEG_SEC + 5.0 + k % 20 for k, b in enumerate(g5_bursts()) if b]


def _hour(seed: np.random.SeedSequence, fs: int, h: int, noise: float, tone_amp: float,
          tone_hz: int, tones: Sequence[float], table: np.ndarray) -> np.ndarray:
    """One hour as int16: float32 noise of std ``noise`` plus the 1 s tones
    of amplitude ``tone_amp`` that overlap it, rounded to the nearest
    integer and clipped."""
    n = fs * 3600
    lo = h * n
    x = np.random.default_rng(seed).standard_normal(n, dtype=np.float32)
    x *= np.float32(noise)
    for s in tones:
        a = int(round(s * fs))
        b = min(a + fs, lo + n)
        a0 = max(a, lo)
        if a0 >= b:
            continue
        j = np.arange(a0, b, dtype=np.int64)
        x[a0 - lo : b - lo] += np.float32(tone_amp) * table[(j * tone_hz) % fs]
    return np.clip(np.rint(x), -32768, 32767).astype(np.int16)


def _day(fs: int, hours: int, seed: int, noise: float, tone_amp: float, tone_hz: int,
         tones: List[float], workers: Optional[int], first_hours: Optional[int] = None) -> Day:
    """The day of ``hours`` hours, or its first ``first_hours`` (the same
    child seeds, so the same samples)."""
    made = hours if first_hours is None else first_hours
    table = np.sin(2.0 * np.pi * np.arange(fs) / fs).astype(np.float32)
    children = np.random.SeedSequence(seed).spawn(hours)
    with ThreadPoolExecutor(max_workers=workers or min(8, os.cpu_count() or 1)) as ex:
        parts = list(ex.map(lambda h: _hour(children[h], fs, h, noise, tone_amp, tone_hz,
                                            tones, table), range(made)))
        hashes = list(ex.map(sha256, parts))
    return Day(fs, np.concatenate(parts), [s for s in tones if s + 1.0 <= made * 3600], hashes)


def g1_day(first_hours: Optional[int] = None, workers: Optional[int] = None) -> Day:
    """G1, or its first ``first_hours`` hours."""
    return _day(G1_FS, G1_HOURS, G1_SEED, G1_NOISE * G1_SCALE, G1_AMP * G1_SCALE, G1_TONE_HZ,
                g1_tones(), workers, first_hours)


def g2_day(workers: Optional[int] = None) -> Day:
    return _day(G2_FS, G2_HOURS, G2_SEED, G2_NOISE * G2_SCALE, G2_AMP * G2_SCALE, G2_TONE_HZ,
                g2_tones(), workers)


def g5_day(workers: Optional[int] = None) -> Day:
    return _day(G5_FS, G5_HOURS, G5_SEED, G5_NOISE, G5_AMP, G5_TONE_HZ, g5_tones(), workers)


def g1_hour(h: int) -> np.ndarray:
    """Hour ``h`` of G1 alone, as int16."""
    table = np.sin(2.0 * np.pi * np.arange(G1_FS) / G1_FS).astype(np.float32)
    children = np.random.SeedSequence(G1_SEED).spawn(G1_HOURS)
    return _hour(children[h], G1_FS, h, G1_NOISE * G1_SCALE, G1_AMP * G1_SCALE, G1_TONE_HZ,
                 g1_tones(), table)


def g3_stations(stations: int = G3_STATIONS):
    """BASELINE config 5: 64 stations x 600 s at 4 kHz (the fixture of the
    JAX package's stations benchmark, seed 7), a 1 s tone a station at
    20 + 7 c (mod 570) s; or its first ``stations`` stations (the same
    rows: the noise is drawn row after row).  Returns (x (stations, n)
    float32, the tones' starts)."""
    block = int(round(BLOCK_SEC * G3_FS))
    n = int(G3_FS * G3_SECONDS) // block * block
    rng = np.random.default_rng(G3_SEED)
    x = rng.standard_normal((stations, n)).astype(np.float32) * G3_NOISE
    t = np.arange(n) / G3_FS
    tones = []
    for c in range(stations):
        s0 = 20.0 + (7.0 * c) % max(G3_SECONDS - 30.0, 1.0)
        m = (t >= s0) & (t < s0 + 1.0)
        x[c, m] += G3_AMP * np.sin(2 * np.pi * G3_TONE_HZ * t[m]).astype(np.float32)
        tones.append(s0)
    return x, tones


def station_hashes(x: np.ndarray) -> List[str]:
    """The SHA-256 of each station's (row's) float32 samples."""
    return [sha256(row) for row in x]


def write_wav(path: str, fs: int, pcm: np.ndarray) -> None:
    """A mono int16 PCM WAV (the ``wave`` module's header, as both
    packages' ``write_wav`` write it)."""
    if pcm.dtype != np.int16 or pcm.ndim != 1:
        raise ValueError(f"mono int16 samples expected, got {pcm.dtype} {pcm.shape}")
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(fs)
        wf.writeframes(pcm.tobytes())
