"""A run whose timed path is broken underneath comes out not correct: once
for each fault a cell can have (a step that returns its state unchanged;
half of the batch left out; an answer altered where it is produced; no
cell spans several chips, so none leaves out an exchange between them),
and the control, the reference with its products in TF32, fails the
committed limits.  The look for a chip is skipped: these runs are on the
CPU, at a size a test holds."""

import functools

import pytest

from bench_h100 import check
from bench_h100.tests import tiny_cells
from meteor_scatter_tpu_torch.apps import analyze, live
from meteor_scatter_tpu_torch.models import streaming


def _keep_state(orig):
    @functools.wraps(orig)
    def f(cfg, state, *a, **k):
        _, events, diags = orig(cfg, state, *a, **k)
        return state, events, diags
    return f


def _alter_threshold(orig):
    @functools.wraps(orig)
    def f(*a, **k):
        state, events, diags = orig(*a, **k)
        thr = diags["threshold"].clone()
        thr[..., -1] += 0.01
        return state, events, dict(diags, threshold=thr)
    return f


def _half_stations(orig):
    @functools.wraps(orig)
    def f(cfg, state, samples, *a, **k):
        x = samples.clone()
        x[x.shape[0] // 2:] = 0.0  # the second half never reaches the front
        return orig(cfg, state, x, *a, **k)
    return f


def _half_file(orig):
    @functools.wraps(orig)
    def f(path, **k):
        fs, data = orig(path, **k)
        return fs, data[: len(data) // 2]
    return f


def _moved_event(orig):
    @functools.wraps(orig)
    def f(events, block_sec, *a, **k):
        dets = orig(events, block_sec, *a, **k)
        if dets:
            dets[0].t_stop += block_sec
        return dets
    return f


def _half_feed(orig):
    @functools.wraps(orig)
    def f(self, samples):
        return orig(self, samples[: len(samples) // 2])
    return f


FAULTS = [
    ("archive_hour_files", "half of the batch", analyze, "read_wav", _half_file),
    ("archive_hour_files", "answer altered", analyze, "events_to_detections", _moved_event),
    ("network64_replay", "state unchanged", streaming, "stream_process", _keep_state),
    ("network64_replay", "half of the batch", streaming, "stream_process", _half_stations),
    ("network64_replay", "answer altered", streaming, "stream_process", _alter_threshold),
    ("network64_live_capacity", "state unchanged", live, "stream_process", _keep_state),
    ("network64_live_capacity", "half of the batch", live.LiveSession, "feed", _half_feed),
    ("network64_live_capacity", "answer altered", live, "stream_process", _alter_threshold),
]


@pytest.mark.parametrize("workload,fault,owner,name,wrap", FAULTS,
                         ids=[f"{w}-{f}" for w, f, *_ in FAULTS])
def test_fault_is_not_correct(workload, fault, owner, name, wrap, monkeypatch):
    monkeypatch.setattr(owner, name, wrap(getattr(owner, name)))
    out = tiny_cells.run(tiny_cells.cell(workload, seconds=1.5))
    assert not out["correct"], (fault, out["checked"])
    assert out["failed"] > 0


@pytest.mark.parametrize("workload", tiny_cells.SMALL)
def test_control_fails_the_limits(workload):
    import importlib

    c = tiny_cells.cell(workload)
    c.workdir = tiny_cells.harness.tempfile.gettempdir()
    drv = importlib.import_module("bench_h100.drivers." + c.traffic["driver"]).Driver(c)
    drv.setup()
    drv.window(1.0, tiny_cells.harness.Tracer(False, "cpu", ""))
    sound, _ = drv.judge()
    control, _ = drv.judge(control=True)
    assert check.verdict(sound.numbers(), c.limits)[0]
    assert not check.verdict(control.numbers(), c.limits)[0], control.numbers()
