"""``ms.wait.*`` spans (host reads of device data and pageable uploads:
the segment, the image path's constants, one test a label round, the
counts, the PNG's image) inside the request, a segment: mean over the
traced segments."""

from bench_h100 import spans


def read(run):
    rows = spans.per_request(run, spans.waits)
    if rows is None:
        return None
    return sum(n for _, n in rows) / len(rows)
