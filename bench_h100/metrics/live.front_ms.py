"""Host ms of the ``ms.front`` span inside ``LiveSession.feed`` (the Welch
front's operators enqueued by ``stream_process``) a feed, median over the
traced feeds."""

import statistics

from bench_h100 import spans


def read(run):
    ms = spans.step_ms(run, "ms.front")
    return statistics.median(ms) if ms else None
