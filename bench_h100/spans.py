"""Reading the program's own spans out of a traced window.

The port opens a ``record_function`` range ``ms.<step>`` around each host
step of its request paths while a profiler records
(``meteor_scatter_tpu_torch/utils/timing.py::span``), and ``ms.wait.<cause>``
around each host read of device data.  They sit on the host thread that
made the request, inside the driver's request range (``run.request_span``),
on the clock of the device's records.  From :class:`bench_h100.trace.Trace`
this module reads only ``ranges``, ``main_tid`` and ``idle_gaps()``:

* :func:`per_request`: for each traced request, the summed host duration
  and the count of the spans a name selects;
* :func:`idle_by_span`: the device's idle time inside the requests, split
  by the innermost ``ms.*`` span the host thread was in (:data:`NONE` where
  it was in none).

A program without such spans gives readers nothing to read: they return
None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

PREFIX = "ms."
WAIT = PREFIX + "wait."
NONE = "(no ms span)"


def _end(e: dict) -> float:
    return e["ts"] + e.get("dur", 0)


def _main_ranges(run) -> List[dict]:
    tr = run.trace
    return [e for e in tr.ranges if e.get("tid") == tr.main_tid]


def requests(run) -> List[dict]:
    """The request ranges of the traced window, in time order."""
    if run.trace is None:
        return []
    return sorted((e for e in _main_ranges(run) if e.get("name") == run.request_span),
                  key=lambda e: e["ts"])


def port_spans(run) -> List[dict]:
    """The program's ``ms.*`` ranges on the requests' thread, in time order."""
    if run.trace is None:
        return []
    return sorted((e for e in _main_ranges(run) if e.get("name", "").startswith(PREFIX)),
                  key=lambda e: (e["ts"], -e.get("dur", 0)))  # a parent before a child it starts with


def _inside(spans: List[dict], starts: List[float], r: dict) -> List[dict]:
    lo = bisect.bisect_left(starts, r["ts"])
    hi = bisect.bisect_right(starts, _end(r))
    return [s for s in spans[lo:hi] if _end(s) <= _end(r)]


def per_request(run, select: Callable[[str], bool]) -> Optional[List[Tuple[float, int]]]:
    """For each traced request, ``(ms, n)``: the summed host milliseconds
    and the count of the ``ms.*`` spans inside it whose name ``select``
    takes.  None where the window traced no request or the program opened
    no ``ms.*`` span."""
    reqs = requests(run)
    spans = port_spans(run)
    if not reqs or not spans:
        return None
    starts = [s["ts"] for s in spans]
    out = []
    for r in reqs:
        mine = [s for s in _inside(spans, starts, r) if select(s["name"])]
        out.append((sum(s.get("dur", 0) for s in mine) / 1e3, len(mine)))
    return out


def waits(n: str) -> bool:
    return n.startswith(WAIT)


def step_ms(run, name: str) -> Optional[List[float]]:
    """Host ms a request of the span ``name`` (``ms.`` included); None
    where no traced request holds one."""
    rows = per_request(run, lambda n: n == name)
    if rows is None or not any(n for _, n in rows):
        return None
    return [ms for ms, _ in rows]


def _segments(r: dict, spans: List[dict]) -> List[Tuple[float, float, str]]:
    """Request ``r`` cut into pieces, each with the name of the innermost of
    ``spans`` (nested, in time order, all inside ``r``) open over it."""
    out, stack, t = [], [], r["ts"]

    def close(before: float) -> None:
        nonlocal t
        while stack and _end(stack[-1]) <= before:
            top = stack.pop()
            if _end(top) > t:
                out.append((t, _end(top), top["name"]))
                t = _end(top)

    for s in spans:
        close(s["ts"])
        if s["ts"] > t:
            out.append((t, s["ts"], stack[-1]["name"] if stack else NONE))
            t = s["ts"]
        stack.append(s)
    close(float("inf"))
    if _end(r) > t:
        out.append((t, _end(r), NONE))
    return out


def idle_by_span(run) -> Optional[Dict[str, float]]:
    """Seconds of the device's idle time inside the traced requests, by the
    innermost ``ms.*`` span the host thread was in (:data:`NONE` for none).
    None where the window traced no request."""
    reqs = requests(run)
    if not reqs:
        return None
    spans = port_spans(run)
    starts = [s["ts"] for s in spans]
    gaps = run.trace.idle_gaps()
    gap_starts = [a for a, _ in gaps]
    out: Dict[str, float] = defaultdict(float)
    for r in reqs:
        for a, b, name in _segments(r, _inside(spans, starts, r)):
            i = max(0, bisect.bisect_right(gap_starts, a) - 1)
            while i < len(gaps) and gaps[i][0] < b:
                lo, hi = max(a, gaps[i][0]), min(b, gaps[i][1])
                if hi > lo:
                    out[name] += (hi - lo) / 1e6
                i += 1
    return dict(out)
