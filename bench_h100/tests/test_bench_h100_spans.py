"""The readers of the program's ``ms.*`` spans on a small hand-made Kineto
trace: two requests, each with its upload, front and events' copies, the
device busy in part of the first."""

import pytest

from bench_h100 import harness, spans, trace

REQ = "bench.feed"
READERS = ("batch.upload_ms", "batch.wait_ms", "replay.waits_per_chunk", "live.upload_ms",
           "live.front_ms", "live.events_to_host_ms")


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def _r(name, a, b):
    return _x("user_annotation", name, a, b - a)


BASE = [
    _r(trace.WINDOW, 0, 10000),
    _r(REQ, 100, 2100),
    _r(REQ, 3000, 5000),
    _x("cpu_op", "aten::copy_", 200, 100),
    _x("kernel", "front_kernel", 400, 600, tid=7, correlation=3),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1850, 50, tid=7, correlation=4),
]
PORT = [
    _r("ms.upload", 150, 350),  # holds aten::copy_ at 200-300
    _r("ms.front", 400, 1400),
    _r("ms.events_to_host", 1700, 1900),
    _r("ms.wait.event_count", 1710, 1750),
    _r("ms.wait.event_fields", 1760, 1860),
    _r("ms.wait.overflow", 1950, 1980),
    _r("ms.upload", 3100, 3500),
    _r("ms.front", 3600, 4000),
    _r("ms.events_to_host", 4100, 4300),
    _r("ms.wait.event_count", 4110, 4200),
    _r("ms.front", 6000, 6500),  # outside every request
    _x("user_annotation", "ms.upload", 150, 200, tid=2),  # another thread
]


def _run(events, request=REQ):
    return harness.Run(None, [], 0.0, 0.01, trace.Trace(events) if events else None, request)


@pytest.mark.parametrize("name,want", [
    ("batch.upload_ms", (0.2 + 0.4) / 2),
    ("batch.wait_ms", ((0.04 + 0.1 + 0.03) + 0.09) / 2),
    ("replay.waits_per_chunk", (3 + 1) / 2),
    ("live.upload_ms", (0.2 + 0.4) / 2),
    ("live.front_ms", (1.0 + 0.4) / 2),
    ("live.events_to_host_ms", 0.2),
])
def test_readers(name, want):
    assert harness.read_metric(_run(BASE + PORT), name) == pytest.approx(want, abs=1e-12)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("events", ["untraced", "no_request", "no_port_span"])
def test_readers_find_nothing(name, events):
    """No trace, a trace with no request, and a program that opens no
    ``ms.*`` span (the program before its spans) read None."""
    run = {"untraced": _run(None),
           "no_request": _run(BASE + PORT, request="bench.other"),
           "no_port_span": _run(BASE)}[events]
    assert harness.read_metric(run, name) is None


def test_idle_time_by_innermost_span():
    got = spans.idle_by_span(_run(BASE + PORT))
    want = {  # us; the idle under aten::copy_ at 200-300 stays under ms.upload
        spans.NONE: (50 + 50 + 300 + 50 + 120) + (100 + 100 + 100 + 700),
        "ms.upload": 200 + 400,
        "ms.front": 400 + 400,
        "ms.events_to_host": 10 + 10 + 10 + 100,
        "ms.wait.event_count": 40 + 90,
        "ms.wait.event_fields": 90,
        "ms.wait.overflow": 30,
    }
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-6, abs=1e-12), k
    assert spans.idle_by_span(_run(None)) is None


def test_idle_gap_inside_a_copy_is_named_by_its_span():
    events = [_r(trace.WINDOW, 0, 1000), _r(REQ, 0, 1000), _r("ms.upload", 100, 900),
              _x("cpu_op", "aten::copy_", 200, 600),
              _x("kernel", "k", 0, 100, tid=7, correlation=1),
              _x("kernel", "k", 900, 100, tid=7, correlation=2)]
    assert spans.idle_by_span(_run(events)) == pytest.approx({"ms.upload": 800e-6})


def test_per_request_counts_and_sums():
    rows = spans.per_request(_run(BASE + PORT), spans.waits)
    assert [n for _, n in rows] == [3, 1]
    assert [ms for ms, _ in rows] == pytest.approx([0.17, 0.09])
    assert spans.step_ms(_run(BASE + PORT), "ms.solve") is None
