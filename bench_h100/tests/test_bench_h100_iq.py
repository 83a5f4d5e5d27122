"""The I/Q front end's cell, ``frontend_iq_2msps``, at a CPU size: 4
channels at 250 kHz in 30 s captures (the same two stages as 2 MS/s, /25 →
10 kHz → ×3/5), every other setting as committed.  A sound run is correct;
a run whose bank drops a rotation term, whose bank takes TF32 operands, or
whose answer is altered is not; the control fails the limits; the inputs
follow the seed; the work counts and the five readers on a hand-made
trace."""

import functools
import importlib

import pytest
import torch

from bench_h100 import check, harness, iq_work, trace
from bench_h100.reference import fronts
from bench_h100.tests import tiny_cells
from meteor_scatter_tpu_torch.apps import frontend
from meteor_scatter_tpu_torch.ops import fir

WORKLOAD = "frontend_iq_2msps"
SMALL_CONFIG = dict(sample_rate=250_000, stations=4)
SMALL_TRAFFIC = dict(capture_seconds=30)


def cell(seed: int = 2 ** 40 + 7, seconds: float = 1.0, trace_on: bool = False) -> harness.Cell:
    c = harness.load_cell(tiny_cells.bench(), WORKLOAD, seed, seconds, trace_on, "cpu")
    c.config.update(SMALL_CONFIG)
    c.traffic.update(SMALL_TRAFFIC)
    return c


def driver(c: harness.Cell):
    c.workdir = harness.tempfile.gettempdir()
    return importlib.import_module("bench_h100.drivers." + c.traffic["driver"]).Driver(c)


def test_sound_run_is_correct():
    out = tiny_cells.run(cell())
    assert out["correct"], out["checked"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["info"]["answers_compared"] == out["attempted"]
    assert set(out["metrics"]) == {"network_samples_per_s", "setup_s"}
    assert list(out)[-1] == "checked"


def test_traced_run_reads_the_port_spans():
    out = tiny_cells.run(cell(trace_on=True))
    assert out["correct"]
    per_layer = {m["name"] for m in tiny_cells.bench()["per_layer"]
                 if WORKLOAD in m.get("workloads", [])}
    assert set(out["metrics"]) <= per_layer
    # the waits are the port's spans, on the CPU too: the band matrix's
    # upload and one a fixpoint round
    assert out["metrics"]["iq.waits_per_capture"]["value"] >= 2
    # on the CPU the device metrics find no kernel and stay out of the line
    assert not {"iq.bank_roofline", "iq.resample_roofline", "iq.bank_elementwise_ms"} & set(
        out["metrics"])


def test_inputs_follow_the_seed():
    def inputs(seed):
        drv = driver(cell(seed=seed))
        drv.setup()
        return drv.iq

    a, b, c = inputs(2 ** 33 + 1), inputs(2 ** 33 + 1), inputs(2 ** 33 + 2)
    assert a.dtype == torch.complex64 and a.shape == (2, 30 * 250_000)
    assert torch.equal(a, b) and not torch.equal(a, c)


def _dropped_rotation_term(orig):
    """The bank without its middle tap column: one term of the rotation's sum."""
    @functools.wraps(orig)
    def bank(f, hh, cr, sr, c_n, a_cols, n_out):
        cut = hh.clone().view(hh.shape[0], 2, c_n, a_cols)
        cut[..., a_cols // 2] = 0.0
        return orig(f, cut.view(hh.shape), cr, sr, c_n, a_cols, n_out)
    return bank


def _tf32_bank(orig):
    @functools.wraps(orig)
    def bank(f, hh, *rest):
        return orig(fronts.tf32_round(f), fronts.tf32_round(hh), *rest)
    return bank


def _altered_series(orig):
    @functools.wraps(orig)
    def f(*a, **k):
        events, delta = orig(*a, **k)
        delta = delta.clone()
        delta[..., -1] += 0.01
        return events, delta
    return f


FAULTS = [
    ("dropped rotation term", fir, "_bank_apply", _dropped_rotation_term),
    ("bank in TF32", fir, "_bank_apply", _tf32_bank),
    ("answer altered", frontend, "detect_channels", _altered_series),
]


@pytest.mark.parametrize("owner,name,wrap", [f[1:] for f in FAULTS], ids=[f[0] for f in FAULTS])
def test_fault_is_not_correct(owner, name, wrap, monkeypatch):
    monkeypatch.setattr(owner, name, wrap(getattr(owner, name)))
    out = tiny_cells.run(cell())
    assert not out["correct"], out["checked"]
    assert out["failed"] > 0


def test_a_program_that_rebuilds_the_bank_plan_is_refused(monkeypatch):
    """A program without the kept plan ends the run in set-up, before any
    capture is made, with a message and a non-zero exit."""
    fresh = fir._bank_plan_on.__wrapped__
    monkeypatch.setattr(fir, "_bank_plan_on", fresh)
    made = []
    monkeypatch.setattr(importlib.import_module("bench_h100.drivers.iq_captures"),
                        "iq_capture", lambda *a, **k: made.append(a))
    drv = driver(cell())
    with pytest.raises(SystemExit, match="kept across captures") as ended:
        drv.setup()
    assert ended.value.code != 0 and not made


def test_the_kept_plan_serves_the_window():
    """The plan that set-up checks is the one the calls use: no miss after set-up."""
    drv = driver(cell())
    drv.setup()
    misses = fir._bank_plan_on.cache_info().misses
    drv.window(0.5, harness.Tracer(False, "cpu", ""))
    assert fir._bank_plan_on.cache_info().misses == misses


def test_control_fails_the_limits():
    c = cell()
    drv = driver(c)
    drv.setup()
    drv.window(1.0, harness.Tracer(False, "cpu", ""))
    sound, _ = drv.judge()
    control, _ = drv.judge(control=True)
    assert check.verdict(sound.numbers(), c.limits)[0]
    assert not check.verdict(control.numbers(), c.limits)[0], control.numbers()


def test_work_counts_at_the_committed_size():
    full = harness.load_cell(tiny_cells.bench(), WORKLOAD, 1, 1.0, False, "cpu")
    b, f = iq_work.bank_gemm(1_200_000_000, 8, 200, 513)
    m = 6_000_002  # 6 000 000 outputs and the 2 rows of the third tap column
    assert b == 4.0 * (2 * m * 200 + 200 * 48 + 2 * 48 * m) and f == 2.0 * 2 * m * 200 * 48
    assert iq_work.bank_bound_s(full) == pytest.approx(b / 3.35e12)  # bytes bound it: 3.55 ms
    b, f = iq_work.resample_conv(6_000_000, 8, 3, 5)
    assert f == 2.0 * 8 * 3_600_000 * 67 and b == 4.0 * (8 * 9_600_000 + 201)
    assert iq_work.resample_bound_s(full) == pytest.approx(b / 3.35e12)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def _launched(op, ts, corr, kernel, kernel_ts, kernel_dur):
    return [_x("cpu_op", op, ts, 20), _x("cuda_runtime", "cudaLaunchKernel", ts + 5, 5,
                                          correlation=corr),
            _x("kernel", kernel, kernel_ts, kernel_dur, tid=7, correlation=corr)]


EVENTS = [
    _x("user_annotation", trace.WINDOW, 0, 10_000),
    _x("user_annotation", "bench.iq_capture", 100, 5_000),
    _x("user_annotation", "ms.channelize", 200, 1_000),
    *_launched("aten::bmm", 300, 1, "sm80_xmma_gemm", 1_000, 2_000),
    *_launched("aten::copy_", 400, 2, "elementwise_kernel", 3_000, 500),
    _x("user_annotation", "ms.resample", 1_300, 500),
    *_launched("aten::cudnn_convolution", 1_400, 3, "conv_kernel", 3_500, 100),
    *_launched("aten::fill_", 1_500, 4, "fill_kernel", 3_600, 50),
    _x("user_annotation", "ms.wait.fixpoint_round", 2_000, 100),
    _x("user_annotation", "ms.wait.fixpoint_round", 2_200, 100),
]


@pytest.mark.parametrize("name,want", [
    ("iq.bank_roofline", lambda c: 100.0 * iq_work.bank_bound_s(c) / 2_000e-6),
    ("iq.bank_elementwise_ms", lambda c: 0.5),
    ("iq.resample_roofline", lambda c: 100.0 * iq_work.resample_bound_s(c) / 100e-6),
    ("iq.waits_per_capture", lambda c: 2.0),
    ("iq.device_idle_pct", lambda c: 100.0 * (1.0 - 2_650e-6 / 10_000e-6)),
])
def test_readers_on_a_hand_made_trace(name, want):
    full = harness.load_cell(tiny_cells.bench(), WORKLOAD, 1, 1.0, True, "cpu")
    run = harness.Run(full, [], 0.0, 0.01, trace.Trace(EVENTS), "bench.iq_capture")
    assert harness.read_metric(run, name) == pytest.approx(want(full), rel=1e-12)
    no_spans = [e for e in EVENTS if not e["name"].startswith("ms.")]
    bare = harness.Run(full, [], 0.0, 0.01, trace.Trace(no_spans), "bench.iq_capture")
    if name != "iq.device_idle_pct":  # a program without the spans gives nothing to read
        assert harness.read_metric(bare, name) is None


def test_reference_and_work_counts_load_nothing_of_the_port():
    import json
    import subprocess
    import sys

    code = ("import json, sys; sys.path.insert(0, %r); "
            "from bench_h100.reference import channelizer; from bench_h100 import iq_work; "
            "import bench_h100.drivers.iq_captures; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % tiny_cells.ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not loaded & {"meteor_scatter_tpu_torch", "meteor_scatter_tpu", "jax", "jaxlib"}
