"""One run of one cell: set-up, the measured window, the comparison with
the reference, the metrics and the result line.

Everything about a cell is found by name under the benchmark's folder:
``configs/<config>.json`` (the deployment), ``traffic/<traffic>.json``
(the mix, naming the driver in ``drivers/`` that plays it),
``limits/<workload>.json`` (the limits of the compared numbers) and one
reader ``metrics/<metric>.py`` per metric that ``BENCHMARK.json`` gives
the cell.  A new cell of an existing kind is data files and entries only.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from bench_h100 import check
from bench_h100 import trace as trace_mod

ROOT = os.path.dirname(os.path.abspath(__file__))
TRACE_SECONDS = 4.0  # the traced part of a window, from its start
FORBIDDEN = ("jax", "jaxlib", "flax", "meteor_scatter_tpu")
HUGE = 1e30  # a compared number that is infinite (a shape or a NaN that differs)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    metrics: List[dict]  # BENCHMARK.json entries the run reports
    seed: int
    seconds: float
    trace: bool
    device: str
    workdir: str = ""


@dataclass
class Run:
    """What a metric reader sees."""

    cell: Cell
    records: List[dict]
    setup_s: float
    window_s: float
    trace: Optional[trace_mod.Trace] = None
    request_span: str = ""

    @property
    def traced_requests(self) -> int:
        return self.trace.count_ranges(self.request_span) if self.trace else 0


def read_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device: str,
              root: str = ROOT) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = read_json(os.path.dirname(root), cfg_entry["file"])
    traffic = read_json(root, "traffic", entry["traffic"] + ".json")
    limits = read_json(root, "limits", workload + ".json")
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"] if applies(m, workload)]
    return Cell(workload, config, traffic, limits, metrics, seed, seconds, trace, device)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(run: Run, name: str, root: str = ROOT):
    reader = load_module(os.path.join(root, "metrics", name + ".py"), "bench_h100_metric_" + name)
    return reader.read(run)


def sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Tracer:
    """``torch.profiler`` over the first :data:`TRACE_SECONDS` of the window
    of a traced run, with the window's range around it; the drivers' ranges
    are opened only while it runs."""

    def __init__(self, on: bool, device: str, path: str):
        self.on, self.device, self.path = on, device, path
        self.active = False

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.win = torch.profiler.record_function(trace_mod.WINDOW)
        self.win.__enter__()
        self.t0 = time.perf_counter()
        self.active = True

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.active else contextlib.nullcontext()

    def tick(self) -> None:
        if self.active and time.perf_counter() - self.t0 >= TRACE_SECONDS:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        sync(self.device)
        self.win.__exit__(None, None, None)
        self.prof.stop()
        self.active = False

    def read(self) -> Optional[trace_mod.Trace]:
        if not self.on:
            return None
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        return trace_mod.load(self.path)


def forbidden_modules() -> List[str]:
    import sys

    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, process_start: float) -> dict:
    """One run: the result line's object.  ``process_start`` is the
    ``time.perf_counter()`` reading of the process's start."""
    t_harness = time.perf_counter()
    cell.workdir = os.path.join(tempfile.gettempdir(), "bench_h100", cell.name)
    os.makedirs(cell.workdir, exist_ok=True)
    driver_mod = importlib.import_module("bench_h100.drivers." + cell.traffic["driver"])
    drv = driver_mod.Driver(cell)
    drv.setup()
    sync(cell.device)
    is_cuda = torch.device(cell.device).type == "cuda"
    if is_cuda:  # the peak reported is the window's own, not what set-up made its inputs with
        torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    tracer = Tracer(cell.trace, cell.device, cell.workdir + ".trace.json")
    tracer.start()
    t_first = time.perf_counter()
    records = drv.window(cell.seconds, tracer)
    tracer.stop()
    sync(cell.device)
    window_s = max(r["end"] for r in records) - t_first if records else cell.seconds
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    drv.free()
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    cmp, answers = drv.judge()
    shutil.rmtree(cell.workdir, ignore_errors=True)  # the inputs and outputs of the window
    numbers = {k: (HUGE if v == float("inf") else v) for k, v in cmp.numbers().items()}
    correct, checked = check.verdict(numbers, cell.limits)
    run = Run(cell, records, t_first - process_start, window_s, tracer.read(),
              driver_mod.REQUEST)
    metrics = {}
    for m in cell.metrics:
        v = read_metric(run, m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if is_cuda else "cpu",
              "kind": torch.cuda.get_device_name() if is_cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(records),
           "failed": int(cmp.failed_answers(cell.limits)), "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["info"] = {"answers_compared": answers, "ties_excused": cmp.ties, "window_s": window_s,
                   "setup_s": run.setup_s, "setup_to_harness_s": t_harness - process_start,
                   "setup_driver_s": t_setup - t_harness}
    out["checked"] = checked
    return out


