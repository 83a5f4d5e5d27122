"""Kernel launch calls on the host inside the request a segment (the
driver's copies of the answers, outside it, are left out), in the traced
part of the window."""

from bench_h100 import spans


def read(run):
    reqs = spans.requests(run)
    if not reqs or not run.trace.api:  # no device API calls traced: no card
        return None
    tid = run.trace.main_tid
    calls = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in run.trace.api
                   if e.get("tid") == tid and "Launch" in e.get("name", ""))
    n, end, i = 0, -1.0, 0
    for r in reqs:
        r0, r1 = r["ts"], r["ts"] + r.get("dur", 0)
        while i < len(calls) and calls[i][0] < r0:
            i += 1
        while i < len(calls) and calls[i][0] <= r1:
            if calls[i][0] >= end:  # a launch inside another counts once
                n += 1
                end = calls[i][1]
            i += 1
    return n / len(reqs)
