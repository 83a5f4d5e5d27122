"""The segment monitor's cell, ``monitor_segments``, at a CPU size: a
quarter of an hour of the day instead of 24 h, a ledger interval of 2 min
instead of 59.8 and the clock started 4 min before midnight, so that a run
of a few seconds writes hourly rows and rotates its daily file; every other
setting as committed.  A sound run is correct; a run whose detector drops a
cluster, whose ledger writes an altered row, which skips a PNG copy or
writes one upside down, or which leaves a journal unwritten or behind, is
not; the control fails the limits; a program without the monitor's step
ends the run in set-up; a traced run reads the port's spans."""

import functools
import importlib
import json
import os

import pytest
import torch

from bench_h100 import check, harness
from bench_h100.tests import tiny_cells
from meteor_scatter_tpu_torch.apps import monitor
from meteor_scatter_tpu_torch.io import ledger

WORKLOAD = "monitor_segments"
SMALL_CONFIG = dict(stream_hours=0.25, save_interval_min=2.0, clock_start="2026-10-01T23:56:00")


def cell(seed: int = 2 ** 40 + 7, seconds: float = 2.0, trace_on: bool = False) -> harness.Cell:
    c = harness.load_cell(tiny_cells.bench(), WORKLOAD, seed, seconds, trace_on, "cpu")
    c.config.update(SMALL_CONFIG)
    return c


CALLS = 8  # after the warm-up: past midnight, the hour in progress holding counts


def driver(c: harness.Cell, workdir) -> object:
    c.workdir = str(workdir)
    return importlib.import_module("bench_h100.drivers." + c.traffic["driver"]).Driver(c)


def run_calls(workdir, calls: int = CALLS):
    """The driver of a tiny cell after set-up and ``calls`` calls."""
    drv = driver(cell(), workdir)
    drv.setup()
    for _ in range(calls):
        drv._keep(*drv._call())
    drv.free()
    return drv


def test_sound_run_is_correct():
    out = tiny_cells.run(cell())
    assert out["correct"], out["checked"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["info"]["answers_compared"] == out["attempted"] + 3  # and the warm-up calls
    assert set(out["metrics"]) == {"batch_samples_per_s", "setup_s"}
    assert list(out)[-1] == "checked"


def test_run_writes_rows_rotates_and_finds_clusters(tmp_path):
    drv = run_calls(tmp_path)
    n, rows, segs = drv._answers()
    assert n == CALLS + 3
    assert drv.judge()[0].numbers()["event_mismatches"] == 0
    d = drv.mcfg.csv_out_dir
    days = sorted(f for f in os.listdir(d) if f.endswith(".csv"))
    assert days == ["20261001.csv", "20261002.csv"]
    rows_written = 0
    for name in days:
        with open(os.path.join(d, name)) as fh:
            rows_written += len(fh.readlines()) - 1
    assert rows_written >= 2
    counts = rows[:, 6 * 64 + 1: 6 * 64 + 3].sum(axis=1)
    assert (counts > 0).sum() >= 2  # segments with clusters, so PNG copies
    assert any(counts[k] for k in drv.sampled)  # one of them a sampled call's
    with open(os.path.join(d, ".inprogress.json")) as fh:
        journal = json.load(fh)
    assert journal["critical"] + journal["non_critical"] > 0  # the hour in progress has counts


def _drop_cluster(orig):
    @functools.wraps(orig)
    def f(*a, **k):
        img, b = orig(*a, **k)
        drop = (b.count > 0).to(torch.int32)
        crit = drop * b.critical[..., 0].to(torch.int32)
        shifted = {n: torch.roll(getattr(b, n), -1, -1)  # slot 0 gone, the rest move up
                   for n in ("t_min", "t_max", "f_min", "f_max", "n_points", "critical")}
        return img, b._replace(count=b.count - drop, n_critical=b.n_critical - crit,
                               n_non_critical=b.n_non_critical - drop + crit, **shifted)
    return f


def _altered_row(orig):
    @functools.wraps(orig)
    def f(self, *a, **k):
        self.n_critical += 1
        return orig(self, *a, **k)
    return f


def _skipped_png(orig):
    @functools.wraps(orig)
    def f(path, rgb):
        f.calls += 1
        if f.calls != 2:
            orig(path, rgb)
    f.calls = 0
    return f


def _upside_down_png(orig):
    @functools.wraps(orig)
    def f(path, rgb):
        orig(path, rgb[::-1])
    return f


def _unsaved(orig):
    @functools.wraps(orig)
    def f(*a, **k):
        pass
    return f


def _journal_at_flush_only(orig):
    """The add without its journal: the hour's counts reach the journal
    only when a flush or the day's rotation writes it."""
    @functools.wraps(orig)
    def f(self, critical, non_critical, now=None):
        self.n_critical += int(critical)
        self.n_non_critical += int(non_critical)
        self.maybe_flush(now)
    return f


FAULTS = [("dropped cluster", monitor, "detect_and_cluster_bursts", _drop_cluster),
          ("altered ledger row", ledger.HourlyLedger, "flush", _altered_row),
          ("skipped PNG", monitor, "write_png", _skipped_png),
          ("offset journal not written", monitor.OffsetJournal, "save", _unsaved)]
FILE_FAULTS = [("upside-down PNG", monitor, "write_png", _upside_down_png),
               ("ledger journal at a flush only", ledger.HourlyLedger, "add",
                _journal_at_flush_only)]


@pytest.mark.parametrize("fault,owner,name,wrap", FAULTS, ids=[f for f, *_ in FAULTS])
def test_fault_is_not_correct(fault, owner, name, wrap, monkeypatch):
    monkeypatch.setattr(owner, name, wrap(getattr(owner, name)))
    out = tiny_cells.run(cell())
    assert not out["correct"], (fault, out["checked"])
    assert out["checked"]["event_mismatches"]["value"] > 0 and out["failed"] > 0


@pytest.mark.parametrize("fault,owner,name,wrap", FILE_FAULTS, ids=[f for f, *_ in FILE_FAULTS])
def test_file_fault_is_not_correct(fault, owner, name, wrap, monkeypatch, tmp_path):
    """Faults that show only in some calls' files, after the calls of
    :func:`test_run_writes_rows_rotates_and_finds_clusters`."""
    monkeypatch.setattr(owner, name, wrap(getattr(owner, name)))
    drv = run_calls(tmp_path)
    cmp, _ = drv.judge()
    assert cmp.numbers()["event_mismatches"] > 0, fault
    assert cmp.failed_answers(drv.cell.limits) > 0


def test_control_fails_the_limits(tmp_path):
    c = cell()
    drv = driver(c, tmp_path)
    drv.setup()
    drv.window(1.0, harness.Tracer(False, "cpu", ""))
    sound, _ = drv.judge()
    control, answers = drv.judge(control=True)
    assert answers > 0
    assert check.verdict(sound.numbers(), c.limits)[0]
    numbers = control.numbers()
    assert not check.verdict(numbers, c.limits)[0], numbers
    # a run holds a few images here; 64 on the card, where the gap is wider
    assert numbers["front_db_gap"] >= 10 * sound.numbers()["front_db_gap"]


def test_program_without_the_step_ends_in_setup(monkeypatch, tmp_path):
    monkeypatch.delattr(monitor, "SegmentMonitor")
    with pytest.raises(SystemExit, match="SegmentMonitor"):
        driver(cell(), tmp_path).setup()


def test_traced_run_reads_the_port_spans():
    out = tiny_cells.run(cell(trace_on=True))
    assert out["correct"]
    per_layer = {m["name"] for m in tiny_cells.bench()["per_layer"]
                 if WORKLOAD in m.get("workloads", [])}
    assert set(out["metrics"]) <= per_layer
    got = {k: v["value"] for k, v in out["metrics"].items()}
    # the host spans read on the CPU too; the launches find no device API call
    assert {"monitor.detect_ms", "monitor.waits_per_segment", "monitor.ledger_ms",
            "batch.wait_ms", "batch.upload_ms"} <= set(got)
    assert "monitor.launches_per_segment" not in got
    # the segment, five constants, one count copy and at least one label round
    assert got["monitor.waits_per_segment"] >= 8
