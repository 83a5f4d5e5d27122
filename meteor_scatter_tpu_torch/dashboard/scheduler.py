"""Minimal background interval scheduler.

Replaces the reference's APScheduler usage (`app.py:48-63`) with a
daemon-thread loop: fixed interval, max one concurrent run, survives job
exceptions.

The port's copy of `meteor_scatter_tpu/dashboard/scheduler.py` (the port
imports nothing of the JAX package); it touches no device.
"""

from __future__ import annotations

import threading
import time
from typing import Callable


class IntervalScheduler:
    def __init__(self, func: Callable[[], None], interval_minutes: float, job_id: str = "csv_update"):
        self.func = func
        self.interval = interval_minutes * 60.0
        self.job_id = job_id
        self._stop = threading.Event()
        self._running = threading.Lock()  # max_instances=1 (app.py:62)
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, name=self.job_id, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def trigger(self) -> None:
        """Run the job once, now (skipped if already running)."""
        if self._running.acquire(blocking=False):
            try:
                self.func()
            except Exception as e:  # noqa: BLE001 — the scheduler must survive
                print(f"[scheduler:{self.job_id}] job error: {e}")
            finally:
                self._running.release()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.trigger()
