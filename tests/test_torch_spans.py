"""The port's profiler spans (``utils/timing.py::span`` / ``wait``) on the CPU.

Each request path runs once with a CPU ``torch.profiler`` recording and a
caller's range open, and once with no profiler and ``record_function``
made to raise: the outputs must be the same bit for bit (no span is entered
without a profiler, and a span changes nothing), and the exported trace
must hold each of the path's ``ms.*`` spans inside the caller's range, each
wait span inside its step.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from meteor_scatter_tpu_torch.apps import analyze, live
from meteor_scatter_tpu_torch.config import DetectionConfig, SpecExportConfig
from meteor_scatter_tpu_torch.io import wavio
from meteor_scatter_tpu_torch.models import events as mevents
from meteor_scatter_tpu_torch.models import streaming
from meteor_scatter_tpu_torch.ops.kernels import _build
from meteor_scatter_tpu_torch.utils import timing

CALLER = "caller"
LIVE = DetectionConfig(signal_freq=1000.0, detection_db_over_noise_mean_min=1.0,
                       detection_dur_min_sec=0.5)
FS_LIVE = 4000
FS_BATCH = 6000

BATCH_SPANS = {"proc_wav_file", "read_wav", "band_power+detect", "upload", "band_power", "detect",
               "wait.fixpoint_round", "events_to_host", "wait.event_count",
               "wait.event_fields", "wait.overflow", "write_labels", "write_csv",
               "series_to_host", "wait.series", "wait.constant_upload", "free_samples"}
FEED_SPANS = {"feed", "upload", "stream_process", "front", "wait.constant_upload", "solve", "events_to_host",
              "wait.event_count", "wait.event_fields", "wait.overflow", "exports"}
# (path, its spans, (child, parent) pairs that must nest)
CASES = {
    "batch_parallel": (BATCH_SPANS, [("read_wav", "proc_wav_file"), ("upload", "band_power+detect"), ("detect", "band_power+detect"),
                                     ("wait.fixpoint_round", "detect"),
                                     ("wait.event_count", "events_to_host"),
                                     ("wait.event_fields", "events_to_host"),
                                     ("wait.overflow", "events_to_host"),
                                     ("wait.series", "series_to_host"),
                                     ("wait.constant_upload", "band_power")]),
    "batch_fused": (BATCH_SPANS, [("wait.fixpoint_round", "detect"),
                                  ("wait.event_count", "events_to_host")]),
    "replay_fused": ({"stream_process", "front", "solve", "bins_projection"},
                     [("front", "stream_process"), ("solve", "stream_process"),
                      ("bins_projection", "front")]),
    "replay_hop": ({"stream_process", "front", "solve", "bins_projection", "wait.fixpoint_round"},
                   [("bins_projection", "front"), ("wait.fixpoint_round", "solve")]),
    "feed": (FEED_SPANS, [("upload", "feed"), ("stream_process", "feed"),
                          ("front", "stream_process"), ("exports", "feed"),
                          ("wait.event_count", "events_to_host"),
                          ("wait.event_fields", "events_to_host"),
                          ("wait.constant_upload", "front")]),
    "feed_spec": (FEED_SPANS | {"spec_ring", "wait.psd", "wait.psd_mean"},
                  [("wait.psd", "spec_ring"), ("wait.psd_mean", "exports"),
                   ("wait.event_count", "events_to_host")]),
    "fixed_point": ({"wait.fixed_point_range"}, []),
}


def _audio(fs, seconds, seed, freq):
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    x = rng.standard_normal(len(t)) * 0.05
    for s in np.arange(15.0, seconds - 3.0, 23.0):
        m = (t >= s) & (t < s + 1.5)
        x[m] += 0.6 * np.sin(2 * np.pi * freq * t[m])
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("spans") / "station.wav")
    x = _audio(FS_BATCH, 150.0, 7, 1003.0)
    wavio.write_wav(path, FS_BATCH, np.round(x * 20000).astype(np.int16))
    return path


def _run(case, wav, out_dir):
    """The path's outputs, as tensors, arrays, numbers and strings."""
    if case.startswith("batch"):
        csv, lbl = os.path.join(out_dir, "ev.csv"), os.path.join(out_dir, "ev.txt")
        res = analyze.proc_wav_file(wav, out_csv_file=csv, out_audacity_lbl_file=lbl,
                                    impl=case.split("_")[1], verbose=False, device="cpu")
        with open(csv) as a, open(lbl) as b:
            files = a.read() + b.read()
        return ([(d.t_start, d.t_stop, d.dB) for d in res.detections], res.delta_power,
                res.thresholds, res.band_power, files, dict(res.timer.counts))
    if case.startswith("replay"):
        streaming._headless_projection_on.cache_clear()  # its span shows on a miss
        scfg = streaming.StreamConfig.from_config(LIVE)
        x = torch.from_numpy(np.stack([_audio(FS_LIVE, 60.0, s, 1000.0) for s in (1, 2, 3)]))
        state, ev, diags = streaming.stream_process(
            LIVE, streaming.stream_init_batch(scfg, 3, device="cpu"), x, FS_LIVE, front="bins",
            impl=case.split("_")[1])
        return list(state), list(ev), diags["threshold"], diags["over_noise"]
    if case.startswith("feed"):
        spec = SpecExportConfig(output_dir=out_dir) if case == "feed_spec" else None
        sess = live.LiveSession(LIVE, FS_LIVE, spec=spec, device="cpu")
        x = _audio(FS_LIVE, 90.0, 11, 1000.0)
        new = [sess.feed(x[i:i + 30 * FS_LIVE]) for i in range(0, len(x), 30 * FS_LIVE)]
        assert sess.events, "the feeds hold no event"
        return new, list(sess.state), sess.last_diags["threshold"], sorted(os.listdir(out_dir))
    q, scale = mevents.to_fixed_point(torch.linspace(-3.0, 5.0, 97, dtype=torch.float64))
    return q, scale


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _ranges(path):
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _within(e, outer):
    return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


@pytest.fixture(scope="module")
def traced(wav, tmp_path_factory):
    """Per case: the outputs with a profiler on, and its trace's ranges."""
    out = {}
    for case in CASES:
        d = str(tmp_path_factory.mktemp(case))
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.profiler.record_function(CALLER):
                got = _run(case, wav, d)
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        out[case] = (got, _ranges(path))
    return out


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler recording")


@pytest.mark.parametrize("case", list(CASES))
def test_no_span_without_profiler_and_same_outputs(case, wav, traced, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    assert not torch.autograd._profiler_enabled()
    _same(_run(case, wav, str(tmp_path)), traced[case][0])


@pytest.mark.parametrize("case", list(CASES))
def test_spans_nest_in_the_callers_range(case, traced):
    want, pairs = CASES[case]
    ranges = traced[case][1]
    (caller,) = [e for e in ranges if e["name"] == CALLER]
    mine = [e for e in ranges if e["name"].startswith(timing.PREFIX)]
    assert {e["name"][len(timing.PREFIX):] for e in mine} == want
    assert all(_within(e, caller) for e in mine)
    by = {}
    for e in mine:
        by.setdefault(e["name"][len(timing.PREFIX):], []).append(e)
    for child, parent in pairs:
        for e in by[child]:
            assert any(_within(e, p) for p in by[parent]), (child, parent)


def test_fixpoint_rounds_are_wait_spans(wav, tmp_path):
    """One ``wait.fixpoint_round`` a round of the plain fixpoint."""
    from meteor_scatter_tpu_torch.models import adaptive

    delta = torch.from_numpy(_audio(100, 300.0, 3, 20.0) * 10.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, rounds = adaptive._fixpoint(delta, 4.0, 100, 15, 100, 50)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    n = sum(e["name"] == "ms.wait.fixpoint_round" for e in _ranges(path))
    assert rounds >= 2 and n == rounds


def test_phase_timer_reads_as_before_and_shows_its_phases(tmp_path):
    def timed():
        timer = timing.PhaseTimer()
        for name in ("read", "detect", "read"):
            with timer.phase(name):
                pass
        timer.start("manual")
        timer.end("manual")
        return timer

    off = timed()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = timed()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    for timer in (off, on):
        assert dict(timer.counts) == {"read": 2, "detect": 1, "manual": 1}
        assert list(timer.totals) == ["read", "detect", "manual"]
        lines = timer.summary().splitlines()
        assert [ln.split(":")[0] for ln in lines] == ["read", "detect", "manual"]
        assert lines[0].startswith("read: total ") and " over 2 calls (avg " in lines[0]
    names = [e["name"] for e in _ranges(path)]
    assert sorted(n for n in names if n.startswith("ms.")) == ["ms.detect", "ms.read", "ms.read"]


def test_span_is_one_shared_no_op_without_profiler():
    a, b = timing.span("x"), timing.wait("y")
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing.span("x") is not a


def test_build_and_first_load_are_spans(tmp_path, monkeypatch):
    """A library compiled and loaded inside a window shows by name; one
    already loaded shows nothing."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    out = []
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _build.load("ms_native")
        path = str(tmp_path / f"trace{len(out)}.json")
        prof.export_chrome_trace(path)
        out.append(sorted(e["name"] for e in _ranges(path) if e["name"].startswith("ms.")))
    assert out == [["ms.build.ms_native", "ms.load.ms_native"], []]
