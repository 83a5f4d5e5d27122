"""Cells of BENCHMARK.json cut to a size a CPU test holds: their traffic
and station count shrunk, every other setting as committed."""

from __future__ import annotations

import os
import time

from bench_h100 import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL = {
    "archive_hour_files": dict(archive_hours=2 / 60, file_seconds=60),
    "network64_replay": dict(chunk_seconds=30, ring_chunks=2),
    "network64_live_capacity": dict(feed_seconds=20, ring_feeds=2),
}
STATIONS = 3


def bench() -> dict:
    return harness.read_json(ROOT, "BENCHMARK.json")


def cell(workload: str, seed: int = 2 ** 40 + 7, seconds: float = 1.0,
         trace: bool = False) -> harness.Cell:
    c = harness.load_cell(bench(), workload, seed, seconds, trace, "cpu")
    c.traffic.update(SMALL[workload])
    c.config["stations"] = min(c.config["stations"], STATIONS)
    return c


def run(c: harness.Cell) -> dict:
    return harness.run_cell(c, time.perf_counter())
