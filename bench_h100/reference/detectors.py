"""Plain reference of the two detectors, written from the reference
program's documented semantics, in float64 with numpy and Python floats.

* The batch analyzer's adaptive threshold (``dsp/src/main.py:450-522``):
  for the first ``fixed_blocks`` blocks the whole series' mean + k·std;
  afterwards, unless frozen, mean + k·std of the trailing ``window_blocks``
  values (the current one excluded); a block above its threshold freezes
  the threshold until ``max(i + freeze_after, max(0, i - freeze_before))``.
  Events are the maximal runs of blocks above threshold, with the mean of
  the series over each run.
* The live detector's three-state machine
  (``dsp/src/live/backend/processor.py:176-510``): Initialization until a
  block starts at or after ``init_wait_sec``; Detection enters Tracking on
  a level above the rolling threshold (mean + k·std of the last ``avg_win``
  levels, the current one excluded), locking the threshold; Tracking adds
  each level to the track and leaves on a level below the locked value,
  emitting the track when its mean and length pass the minimums; the locked
  value stays in force in Detection for ``after_wait_sec`` after leaving.
  Lock window and minimum length are whole blocks, as the port takes them
  (``lock_tail_blocks``, ``min_duration_blocks``).

Besides its answers, each detector returns its *ties*: the blocks at which
a decision compared two values less than ``tie_db`` apart.  A program that
rounds in float32 can decide such a block the other way and still be right.

The live detector also marks its *fragile* thresholds: those that come from
a rolling window whose variance is under :data:`FRAGILE` float32 epsilons
of its mean square, as where the first two or three levels of a stream lie
within a thousandth of a dB of each other.  There ``mean_sq - mean^2``
cancels, so a program that takes the statistics in float32, as the
configuration states, computes that threshold only to about
``k * sqrt(eps * mean_sq)``, up to ~1e-3 dB, however it rounds.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np


class AdaptiveResult(NamedTuple):
    thresholds: np.ndarray  # float64 (n,)
    events: list  # [(start_block, stop_block_exclusive, mean_db)]
    ties: np.ndarray  # block indices of near-ties


def adaptive_detect(delta: np.ndarray, k: float, window_blocks: int, freeze_before: int,
                    freeze_after: int, fixed_blocks: int, tie_db: float) -> AdaptiveResult:
    d = np.asarray(delta, dtype=np.float64)
    n = len(d)
    g_thr = float(d.mean() + k * d.std())
    c1 = np.concatenate([[0.0], np.cumsum(d)]).tolist()
    c2 = np.concatenate([[0.0], np.cumsum(d * d)]).tolist()
    dl = d.tolist()
    thr = [0.0] * n
    above = [False] * n
    ties = []
    t = g_thr
    freeze_until = -1
    for i in range(n):
        if i < fixed_blocks:
            t = g_thr
        elif i > freeze_until:
            lo = max(0, i - window_blocks)
            m = (c1[i] - c1[lo]) / (i - lo)
            v = (c2[i] - c2[lo]) / (i - lo) - m * m
            t = m + k * math.sqrt(v if v > 0.0 else 0.0)
        thr[i] = t
        if abs(dl[i] - t) < tie_db:
            ties.append(i)
        if dl[i] > t:
            above[i] = True
            freeze_until = max(i + freeze_after, max(0, i - freeze_before))
    events = []
    i = 0
    while i < n:
        if above[i]:
            j = i
            while j < n and above[j]:
                j += 1
            events.append((i, j, float(d[i:j].mean())))
            i = j
        else:
            i += 1
    return AdaptiveResult(np.asarray(thr), events, np.asarray(ties, dtype=np.int64))


class StreamEvent(NamedTuple):
    start_block: int  # absolute block that entered Tracking
    stop_block: int  # absolute block that left it (the event is emitted there)
    db_min: float
    db_max: float
    db_mean: float
    db_std: float


FRAGILE = 1e4  # float32 epsilons of a window's mean square, under which its variance is fragile
F32_EPS = 2.0 ** -24


class StreamResult(NamedTuple):
    thresholds: np.ndarray  # float64 (n,), NaN before the first level
    events: List[StreamEvent]
    ties: np.ndarray  # block indices of near-ties
    fragile: np.ndarray  # bool (n,): the threshold in force comes from a fragile window


def rolling_moments(on: np.ndarray, avg_win: int) -> tuple:
    """Mean, population variance and mean square of the last ``avg_win``
    levels before each block, NaN at block 0; ``on`` (..., n) float64."""
    n = on.shape[-1]
    c1 = np.concatenate([np.zeros(on.shape[:-1] + (1,)), np.cumsum(on, -1)], -1)
    c2 = np.concatenate([np.zeros(on.shape[:-1] + (1,)), np.cumsum(on * on, -1)], -1)
    i = np.arange(n)
    lo = np.maximum(0, i - avg_win)
    cnt = (i - lo).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        m = (c1[..., i] - c1[..., lo]) / cnt
        m2 = (c2[..., i] - c2[..., lo]) / cnt
        return m, m2 - m * m, m2


def rolling_thresholds(on: np.ndarray, avg_win: int, k: float) -> np.ndarray:
    """mean + k·std (population) of the last ``avg_win`` levels before each
    block, NaN at block 0; ``on`` (..., n) float64."""
    m, v, _ = rolling_moments(on, avg_win)
    return m + k * np.sqrt(np.maximum(v, 0.0))


def fragile_windows(on: np.ndarray, avg_win: int) -> np.ndarray:
    """Blocks whose rolling window's variance is under :data:`FRAGILE`
    float32 epsilons of its mean square (bool, (..., n))."""
    _, v, m2 = rolling_moments(on, avg_win)
    with np.errstate(invalid="ignore"):
        return v < FRAGILE * F32_EPS * m2


def stream_detect(on: np.ndarray, block_sec: float, avg_win: int, init_wait_sec: float,
                  after_wait_sec: float, k: float, min_mean_db: float, min_dur_sec: float,
                  tie_db: float) -> StreamResult:
    """One station's stream from its first block (a fresh state)."""
    on = np.asarray(on, dtype=np.float64)
    base = rolling_thresholds(on, avg_win, k).tolist()
    weak = fragile_windows(on, avg_win).tolist()
    lock_tail = int(math.ceil(after_wait_sec / block_sec - 1e-9)) - 1
    min_dur_blocks = int(math.ceil(min_dur_sec / block_sec - 1e-9))
    vals = on.tolist()
    n = len(vals)
    thr_out = [math.nan] * n
    fragile = [False] * n
    ties = []
    events = []
    state = "init"
    locked = -1.0
    locked_weak = False
    locked_until = -1
    t0 = 0
    track: list = []
    for i in range(n):
        v = vals[i]
        thr, w = base[i], weak[i]
        if state == "track" or (state == "detect" and i <= locked_until):
            thr, w = locked, locked_weak
        thr_out[i], fragile[i] = thr, w
        if state == "init":
            if i * block_sec >= init_wait_sec:
                state = "detect"
            continue
        if abs(v - thr) < tie_db:
            ties.append(i)
        if state == "detect":
            if v > thr:
                locked, locked_weak, t0, track, state = thr, w, i, [], "track"
        else:
            track.append(v)
            if v < thr:
                h = np.asarray(track)
                mean = float(h.mean())
                if abs(mean - min_mean_db) < tie_db:
                    ties.append(i)
                if mean >= min_mean_db and i - t0 >= min_dur_blocks:
                    events.append(StreamEvent(t0, i, float(h.min()), float(h.max()), mean,
                                              float(h.std())))
                locked_until = i + (lock_tail - 1)
                state = "detect"
    return StreamResult(np.asarray(thr_out), events, np.asarray(ties, dtype=np.int64),
                        np.asarray(fragile, dtype=bool))
