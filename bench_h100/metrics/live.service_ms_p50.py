"""Median of ``LiveSession.feed``'s own duration over the window's feeds
(host clock)."""

import statistics


def read(run):
    if not run.records:
        return None
    return statistics.median(r["end"] - r["start"] for r in run.records) * 1e3
