"""Host ms a file inside ``proc_wav_file``'s ``ms.wait.*`` spans (each a
host read of device data), mean over the traced files."""

from bench_h100 import spans


def read(run):
    rows = spans.per_request(run, spans.waits)
    if rows is None or not any(n for _, n in rows):
        return None
    return sum(ms for ms, _ in rows) / len(rows)
