"""Host ms of the ``ms.write_png`` span (the image to the host, colouring,
upscaling, the PNG's encoding and its write) a segment, mean over every
traced segment, those without a detection (and so without a PNG)
included."""

import statistics

from bench_h100 import spans


def read(run):
    rows = spans.per_request(run, lambda n: n == "ms.write_png")
    if rows is None or not any(n for _, n in rows):
        return None
    return statistics.fmean(ms for ms, _ in rows)
