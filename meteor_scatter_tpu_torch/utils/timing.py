"""Phase timing + throughput counters.

The port's own copy of `meteor_scatter_tpu/utils/timing.py` (the port
imports nothing of the JAX package): accumulating per-phase wall-clock
stats, samples/s counters, and an optional ``torch.profiler`` trace in
place of the reference's ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional


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
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
