"""Phase timing, throughput counters and profiler spans.

The port's own copy of `meteor_scatter_tpu/utils/timing.py` (the port
imports nothing of the JAX package): accumulating per-phase wall-clock
stats, samples/s counters, and an optional ``torch.profiler`` trace in
place of the reference's ``jax.profiler`` one.

:func:`span` and :func:`wait` name the port's host steps in a
``torch.profiler`` trace, as ``record_function`` ranges ``ms.<name>`` on
the clock of the device's kernel and copy records.  They exist only while
a profiler records; otherwise each returns one shared no-op context after
a check of about 0.1 us, and no range is entered.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

PREFIX = "ms."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range ``ms.<name>`` around a host step while a profiler
    records, else a shared no-op context.  Entering it reads nothing of
    the device and allocates nothing there."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def wait(name: str):
    """:func:`span` ``wait.<name>``: wraps one host read of device data
    (a copy to the host, a ``bool`` / ``int`` of a device tensor, a
    synchronise) or one pageable copy to the device, each of which waits for
    the device's queue, and nothing else; so the ``ms.wait.*`` ranges count
    the host's waits for the device by cause."""
    return span("wait." + name)


def spanned(name: str):
    """Decorator: each call of the function is :func:`span` ``name``, so a
    trace groups a request's steps under the port's entry point."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


class PhaseTimer:
    def __init__(self, log: bool = False):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._open: Dict[str, float] = {}
        self.log = log

    def start(self, phase: str) -> None:
        self._open[phase] = time.perf_counter()

    def end(self, phase: str) -> float:
        dt = time.perf_counter() - self._open.pop(phase)
        self.totals[phase] += dt
        self.counts[phase] += 1
        if self.log:
            print(f"Time for {phase}: {dt:.6f} seconds")
        return dt

    @contextlib.contextmanager
    def phase(self, name: str):
        """Times ``name`` on the host clock, and is :func:`span` ``name`` in
        a profiler's trace."""
        with span(name):
            self.start(name)
            try:
                yield
            finally:
                self.end(name)

    def summary(self) -> str:
        lines = []
        for k in self.totals:
            n = self.counts[k]
            lines.append(
                f"{k}: total {self.totals[k]:.3f}s over {n} calls "
                f"(avg {self.totals[k] / max(n, 1):.4f}s)"
            )
        return "\n".join(lines)


class Throughput:
    """samples/s accounting for the benchmark harness."""

    def __init__(self):
        self.samples = 0
        self.seconds = 0.0

    def add(self, n_samples: int, seconds: float) -> None:
        self.samples += n_samples
        self.seconds += seconds

    @property
    def samples_per_sec(self) -> float:
        return self.samples / self.seconds if self.seconds > 0 else 0.0


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str] = None):
    """``torch.profiler`` trace (CPU, plus CUDA when a GPU is present) written
    to ``<trace_dir>/trace.json`` when a directory is given, no-op otherwise."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
