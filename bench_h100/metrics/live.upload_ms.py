"""Host ms of ``LiveSession.feed``'s ``ms.upload`` span (the feed's samples
to the card, their float32 conversion on the host included) a feed, median
over the traced feeds."""

import statistics

from bench_h100 import spans


def read(run):
    ms = spans.step_ms(run, "ms.upload")
    return statistics.median(ms) if ms else None
