"""Host ms of the ``ms.ledger`` span (the offset journal, the ledger's
journal and, once an hour, its row) a segment, mean over the traced
segments."""

import statistics

from bench_h100 import spans


def read(run):
    ms = spans.step_ms(run, "ms.ledger")
    return statistics.fmean(ms) if ms else None
