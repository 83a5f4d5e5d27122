"""Host ms of the ``ms.detect`` span inside ``SegmentMonitor.step`` (the
spectrogram image, keypoints, the label rounds and the boxes enqueued, with
the rounds' host tests) a segment, mean over the traced segments."""

import statistics

from bench_h100 import spans


def read(run):
    ms = spans.step_ms(run, "ms.detect")
    return statistics.fmean(ms) if ms else None
