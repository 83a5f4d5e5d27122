"""``ms.wait.*`` spans (host reads of device data and pageable constant
uploads) inside the request, a capture: mean over the traced captures."""

from bench_h100 import spans


def read(run):
    rows = spans.per_request(run, spans.waits)
    if rows is None:
        return None
    return sum(n for _, n in rows) / len(rows)
