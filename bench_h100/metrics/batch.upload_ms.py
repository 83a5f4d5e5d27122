"""Host ms of ``proc_wav_file``'s ``ms.upload`` span (the int16 samples to
the card and their conversion there) a file, mean over the traced files."""

from bench_h100 import spans


def read(run):
    ms = spans.step_ms(run, "ms.upload")
    return sum(ms) / len(ms) if ms else None
