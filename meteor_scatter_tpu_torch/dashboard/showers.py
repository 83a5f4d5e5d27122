"""Annual meteor-shower calendar for the month-chart overlays.

Equivalent of the reference's `LocalData.py`: each shower is a ±2-day
window around its annual peak (template year 2000, mapped to the current
year at query time; 1999/2001 mark previous/next year).  Peak dates follow
the public IMO working-list calendar, matching the reference's 37 entries
(`LocalData.py:39-186`).

The port's copy of `meteor_scatter_tpu/dashboard/showers.py` (the port
imports nothing of the JAX package); it touches no device.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import List

LOCAL_DELTA = 2  # days either side of the peak (LocalData.py:6)

# (template-year month, day, label) — template year 2000 = "current year"
_PEAKS = [
    (1, 3, "Quadrantiden"),
    (1, 18, "γ-Ursae Minoriden"),
    (2, 8, "α-Centauriden"),
    (4, 22, "April Lyriden"),
    (4, 23, "π-Puppiden"),
    (5, 6, "η-Aquariden"),
    (5, 10, "η-Lyriden"),
    (6, 7, "Tages-Arietiden"),
    (6, 27, "Juni Bootiden"),
    (7, 10, "Juli Pegasiden"),
    (7, 28, "Juli-γ-Draconiden"),
    (7, 31, "S. δ-Aquariden"),
    (7, 31, "α-Capricorniden"),
    (8, 7, "η-Eridaniden"),
    (8, 12, "Perseiden"),
    (8, 16, "κ-Cygniden"),
    (9, 1, "Aurigiden"),
    (9, 9, "Sep-ε-Perseiden"),
    (9, 27, "Tages-Sextantiden"),
    (10, 5, "Okt. Camelopard."),
    (10, 8, "Okt. Draconiden"),
    (10, 11, "δ-Aurigiden"),
    (10, 18, "ε-Geminiden"),
    (10, 21, "Orioniden"),
    (10, 24, "Leonis Minoriden"),
    (11, 5, "S. Tauriden"),
    (11, 12, "N. Tauriden"),
    (11, 17, "Leoniden"),
    (11, 21, "α-Monocerotiden"),
    (11, 28, "Nov. Orioniden"),
    (12, 1, "Phoeniciden"),
    (12, 7, "Puppid-Veliden"),
    (12, 9, "Monocerotiden"),
    (12, 9, "α-Hydriden"),
    (12, 14, "Geminiden"),
    (12, 16, "Comae Bereniciden"),
    (12, 22, "Ursiden"),
]


@dataclass
class ShowerWindow:
    start: datetime.date
    end: datetime.date
    label: str


def shower_windows(year: int | None = None) -> List[ShowerWindow]:
    """All shower windows with the template year replaced by ``year``
    (default: current year), ±LOCAL_DELTA days around the peak.  Windows
    whose delta crosses a year boundary spill into the adjacent year
    naturally via date arithmetic."""
    if year is None:
        year = datetime.date.today().year
    out = []
    for month, day, label in _PEAKS:
        peak = datetime.date(year, month, day)
        out.append(
            ShowerWindow(
                start=peak - datetime.timedelta(days=LOCAL_DELTA),
                end=peak + datetime.timedelta(days=LOCAL_DELTA),
                label=label,
            )
        )
    return out


def showers_in_range(start: datetime.date, end: datetime.date) -> List[ShowerWindow]:
    """Shower windows intersecting [start, end]; checks the surrounding
    years too so December/January windows appear in cross-year ranges."""
    out = []
    for y in (start.year - 1, start.year, end.year, end.year + 1):
        for w in shower_windows(y):
            if w.end >= start and w.start <= end:
                if not any(o.label == w.label and o.start == w.start for o in out):
                    out.append(w)
    return out
