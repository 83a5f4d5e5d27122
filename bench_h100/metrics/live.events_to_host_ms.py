"""Host ms of ``LiveSession.feed``'s ``ms.events_to_host`` span (the event
count and the events' fields copied to the host, and made into records) a
feed, median over the traced feeds."""

import statistics

from bench_h100 import spans


def read(run):
    ms = spans.step_ms(run, "ms.events_to_host")
    return statistics.median(ms) if ms else None
