"""The comparison that decides ``correct``: the program's answers against
the plain reference's, as four numbers, each held to a limit of its own.

* ``front_db_gap``: the widest gap, in dB, between a per-block level the
  program produced (the batch detection series, or the live detector's
  level over noise) and the reference's.
* ``threshold_db_gap``: the widest gap between the program's per-block
  thresholds and the reference's; of the live detector's, those the
  reference marks fragile are left out (float32 cannot give them to better
  than ~1e-3 dB; :mod:`bench_h100.reference.detectors`).
* ``event_mismatches``: events that one side reports and the other does
  not, matched by their first and last block.  Exact: its limit is 0.
* ``event_db_gap``: the widest gap between the dB statistics of matched
  events.

A decision that compared two values less than the tie band apart in the
reference (:mod:`bench_h100.reference.detectors`) may go the other way in
float32 and stay right, and the two detectors then run apart until their
state meets again.  So the blocks from such a tie to ``horizon`` blocks
after it are excused: events that touch them are not matched, and
thresholds there are not compared.  ``ties_excused`` counts those ties; it
is reported and not limited.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Iterable, Sequence

import numpy as np

NUMBERS = ("front_db_gap", "threshold_db_gap", "event_mismatches", "event_db_gap")


def excused_blocks(n: int, ties: Iterable[int], horizon: int) -> np.ndarray:
    """Boolean (n,): true from each tie to ``horizon`` blocks after it."""
    mask = np.zeros(n + 1, dtype=np.int64)
    for t in ties:
        mask[t] += 1
        mask[min(n, t + horizon + 1)] -= 1
    return np.cumsum(mask)[:n] > 0


def series_gap(got: np.ndarray, ref: np.ndarray, skip: np.ndarray | None = None) -> float:
    """Widest absolute gap; a shape that differs, or a NaN on one side
    only, reads as infinite."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if got.shape != ref.shape:
        return math.inf
    keep = np.ones(got.shape, dtype=bool) if skip is None else ~skip
    g, r = got[keep], ref[keep]
    both_nan = np.isnan(g) & np.isnan(r)
    d = np.abs(g - r)
    d[both_nan] = 0.0
    if np.isnan(d).any():
        return math.inf
    return float(d.max()) if d.size else 0.0


class Comparison:
    """Accumulates the four numbers over the answers of a run, and each
    answer's own readings, so that the answers judged wrong can be
    counted."""

    def __init__(self):
        self.ties = 0
        self._series: list = []  # (front gap, threshold gap)
        self._events: list = []  # (mismatches, dB gap, times)

    def series(self, got_front, ref_front, got_thr, ref_thr, excused: np.ndarray | None) -> None:
        self._series.append((series_gap(got_front, ref_front),
                             series_gap(got_thr, ref_thr, excused)))

    def dropped(self, n: int) -> None:
        """Events the program found but could not keep."""
        self._events.append((n, 0.0, 1))

    def events(self, got: Sequence[tuple], ref: Sequence[tuple],
               excused: np.ndarray | None = None, times: int = 1) -> None:
        """Events as (first block, stop block, dB values...); ``excused``
        indexes blocks as the events do; ``times`` counts answers that
        were the same bytes."""

        def kept(evs):
            if excused is None:
                return list(evs)
            n = len(excused)
            return [e for e in evs
                    if not excused[max(0, min(e[0], n - 1)): max(0, min(e[1], n - 1)) + 1].any()]

        got, ref = kept(got), kept(ref)
        g = Counter((int(e[0]), int(e[1])) for e in got)
        r = Counter((int(e[0]), int(e[1])) for e in ref)
        mismatches = sum(((g - r) + (r - g)).values())
        ref_by_key = {(int(e[0]), int(e[1])): e for e in ref}
        db = 0.0
        for e in got:
            m = ref_by_key.get((int(e[0]), int(e[1])))
            if m is not None:
                for a, b in zip(e[2:], m[2:]):
                    gap = abs(float(a) - float(b))
                    db = max(db, math.inf if math.isnan(gap) else gap)
        self._events.append((mismatches, db, times))

    def numbers(self) -> Dict[str, float]:
        return {"front_db_gap": max((s[0] for s in self._series), default=0.0),
                "threshold_db_gap": max((s[1] for s in self._series), default=0.0),
                "event_mismatches": float(sum(m * t for m, _, t in self._events)),
                "event_db_gap": max((e[1] for e in self._events), default=0.0)}

    def failed_answers(self, limits: Dict[str, float]) -> int:
        """Answers with a reading past its limit (an answer's mismatches
        against the run's limit, which is 0)."""
        bad = sum(t for m, db, t in self._events
                  if m > limits["event_mismatches"] or db > limits["event_db_gap"])
        return bad + sum(f > limits["front_db_gap"] or th > limits["threshold_db_gap"]
                         for f, th in self._series)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, checked): ``checked`` maps each number to its value and
    limit; a number passes when it is at most its limit."""
    checked = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(numbers[k] <= limits[k] for k in NUMBERS)
    return ok, checked
