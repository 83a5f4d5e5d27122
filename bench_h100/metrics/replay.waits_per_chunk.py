"""``ms.wait.*`` spans (host reads of device data) inside
``stream_process`` a chunk, mean over the traced chunks."""

from bench_h100 import spans


def read(run):
    rows = spans.per_request(run, spans.waits)
    if rows is None:
        return None
    return sum(n for _, n in rows) / len(rows)
