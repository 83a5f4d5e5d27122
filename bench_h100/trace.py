"""Reading a ``torch.profiler`` chrome trace of the traced part of a window.

The harness opens a ``record_function`` range named :data:`WINDOW` around
the traced requests, and the drivers open ``bench.*`` ranges around their
calls into each layer.  From the trace this module takes:

* the device's busy time: the union of kernel, copy and fill intervals
  inside the window, and the idle gaps between them, each named by the
  innermost range or operator the host thread was in at the gap's middle;
* launches: host API calls whose name holds ``Launch``, a call inside
  another counted once; host waits: ``cudaStreamSynchronize`` and
  ``cudaDeviceSynchronize`` calls (``torch_bench.py --profile``'s count);
* copies by direction, and each kernel's launching operator: the innermost
  ``cpu_op`` or range on the launching thread around its launch call,
  matched by the CUPTI correlation id.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Optional

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
API_CATS = ("cuda_runtime", "cuda_driver")
OP_CATS = ("cpu_op", "user_annotation")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
TOP = 10


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


class _Nesting:
    """Innermost enclosing interval of a time on one thread (intervals of a
    thread nest, as ranges and operators do)."""

    def __init__(self, spans: List[dict]):
        self.spans = sorted(spans, key=lambda e: (e["ts"], -e.get("dur", 0)))
        self.starts = [e["ts"] for e in self.spans]
        self.parent = [-1] * len(self.spans)
        open_: List[int] = []
        for i, e in enumerate(self.spans):
            while open_ and _end(self.spans[open_[-1]]) < e["ts"]:
                open_.pop()
            self.parent[i] = open_[-1] if open_ else -1
            open_.append(i)

    def at(self, t: float) -> List[dict]:
        """Every interval containing ``t``, outermost first: the innermost
        is the latest started one that has not ended, an ancestor of the
        latest started one."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and _end(self.spans[i]) < t:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.spans[i])
            i = self.parent[i]
        return out[::-1]


def _end(e: dict) -> float:
    return e["ts"] + e.get("dur", 0)


class Trace:
    def __init__(self, events: List[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        wins = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        if not wins:
            raise ValueError(f"no {WINDOW!r} range in the trace")
        w = wins[0]
        self.w0, self.w1 = float(w["ts"]), float(w["ts"]) + float(w.get("dur", 0))
        self.main_tid = w.get("tid")

        def inside(e):
            return self.w0 <= e["ts"] <= self.w1

        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS
                       and e["ts"] + e.get("dur", 0) >= self.w0 and e["ts"] <= self.w1]
        self.api = [e for e in xs if e.get("cat") in API_CATS and inside(e)]
        self.ranges = [e for e in xs if e.get("cat") == "user_annotation" and inside(e)]
        ops_by_tid = defaultdict(list)
        for e in xs:
            if e.get("cat") in OP_CATS:
                ops_by_tid[e.get("tid")].append(e)
        self._ops = {tid: _Nesting(v) for tid, v in ops_by_tid.items()}
        self._launch_by_corr = {}
        for e in self.api:
            corr = e.get("args", {}).get("correlation")
            if corr is not None and "Launch" in e.get("name", ""):
                self._launch_by_corr[corr] = e

    # -- device time ---------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def busy_intervals(self) -> List[tuple]:
        return _union([(max(e["ts"], self.w0), min(e["ts"] + e.get("dur", 0), self.w1))
                       for e in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> List[tuple]:
        gaps, t = [], self.w0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.w1 > t:
            gaps.append((t, self.w1))
        return gaps

    # -- host calls ----------------------------------------------------
    @property
    def launches(self) -> int:
        calls = sorted((e for e in self.api if "Launch" in e.get("name", "")),
                       key=lambda e: (e.get("tid"), e["ts"]))
        n, end = 0, {}
        for e in calls:
            tid = e.get("tid")
            if e["ts"] < end.get(tid, -1.0):
                continue  # inside a launch already counted
            n += 1
            end[tid] = e["ts"] + e.get("dur", 0)
        return n

    @property
    def host_waits(self) -> int:
        return sum(e.get("name") in SYNC_CALLS for e in self.api)

    def copy_s(self, direction: str) -> float:
        """Device seconds of copies whose name holds ``direction`` (HtoD,
        DtoH, DtoD)."""
        return sum(e.get("dur", 0) for e in self.device
                   if e.get("cat") == "gpu_memcpy" and direction in e.get("name", "")) / 1e6

    def count_ranges(self, name: str) -> int:
        return sum(e.get("name") == name for e in self.ranges)

    # -- attribution -----------------------------------------------------
    def host_stack(self, e: dict) -> List[dict]:
        """The ranges and operators around kernel ``e``'s launch call,
        outermost first; empty when its launch is not in the trace."""
        call = self._launch_by_corr.get(e.get("args", {}).get("correlation"))
        if call is None or call.get("tid") not in self._ops:
            return []
        return self._ops[call["tid"]].at(call["ts"])

    def kernels(self, name_has: Optional[str] = None, op_in: tuple = (),
                range_name: Optional[str] = None) -> List[dict]:
        """Kernel records inside the window whose name holds ``name_has``,
        whose innermost launching operator is in ``op_in`` and that were
        launched inside the range ``range_name``."""
        out = []
        for e in self.device:
            if e.get("cat") != "kernel" or (name_has and name_has not in e.get("name", "")):
                continue
            if op_in or range_name:
                stack = self.host_stack(e)
                ops = [s for s in stack if s.get("cat") == "cpu_op"]
                if op_in and not (ops and ops[-1].get("name") in op_in):
                    continue
                if range_name and not any(s.get("name") == range_name for s in stack):
                    continue
            out.append(e)
        return out

    @staticmethod
    def seconds(events: List[dict]) -> float:
        return sum(e.get("dur", 0) for e in events) / 1e6

    def breakdown(self) -> Dict[str, list]:
        """The device operations that took most time, and the idle time by
        what the host thread was doing, each at most :data:`TOP`."""
        ops: Dict[str, float] = defaultdict(float)
        for e in self.device:
            a, b = max(e["ts"], self.w0), min(e["ts"] + e.get("dur", 0), self.w1)
            ops[e.get("name", "?")[:160]] += max(0.0, b - a) / 1e6
        idle: Dict[str, float] = defaultdict(float)
        nest = self._ops.get(self.main_tid)
        for a, b in self.idle_gaps():
            stack = nest.at((a + b) / 2) if nest else []
            names = [s["name"] for s in stack if s.get("name") != WINDOW]
            ranges = [n for n in names if n.startswith("bench.")]
            key = ranges[-1] if ranges else "host"
            if names and names[-1] != key:
                key += " > " + names[-1]
            idle[key[:160]] += (b - a) / 1e6
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def load(path: str) -> Trace:
    with open(path) as fh:
        return Trace(json.load(fh)["traceEvents"])
