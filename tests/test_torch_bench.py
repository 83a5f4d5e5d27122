"""The port's measurement programs on the CPU: ``torch_bench.py`` (the
counterpart of the JAX package's ``bench.py``) and the four timing tools
``tools/torch_{streaming_bench,stations_bench,stations_breakdown,
iq_breakdown}.py``, at the tests' own small sizes (the programs' sizes stay
``bench.py``'s).

(a) every fixture equals its JAX-side counterpart's array bit for bit:
top-level numpy functions called directly, G3 through
``tools/golden_fixtures.py``, and the arrays that ``bench.py`` and the JAX
tools build inside functions that also run JAX taken from a subprocess (it
stops each at the upload of its input); (b) each pipeline and tool passes
its gate on ``device="cpu"``; (c) ``torch_bench.main`` with every metric and
the four tools run where ``import jax`` fails, load no module of JAX, of the
JAX package or of ``bench.py``, and the artifact has every key asked for;
(d) a gate forced false makes ``torch_bench.main`` exit 1.
"""

import contextlib
import importlib
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
sys.path.insert(0, TOOLS)

import bench  # noqa: E402  (numpy only at its top)
import golden_fixtures as gf  # noqa: E402
import streaming_bench  # noqa: E402  (numpy only at its top)
import torch_bench as tb  # noqa: E402
import torch_streaming_bench  # noqa: E402
from meteor_scatter_tpu.apps import frontend as jax_frontend  # noqa: E402
from meteor_scatter_tpu_torch.apps.frontend import synth_wideband_iq  # noqa: E402
from meteor_scatter_tpu_torch.ops import fir  # noqa: E402

CPU = torch.device("cpu")
ONCE = tb.Timing(reps=1, warmup=0)
# the tests' sizes: seconds of each metric, a few stations and segments
SMALL = dict(batch_seconds=60.0, baseline_seconds=5.0, multi_seconds=30.0, stations=4,
             stations_seconds=60.0, image_segments=2, image_seconds=30.0, frontend_seconds=1.0,
             frontend_iq_seconds=2.0, frontend_stations=8)
ALL_METRICS = ["--multi", "--stations", "--image", "--frontend", "--frontend-iq"]
METRIC_KEYS = ("metric", "value", "unit", "vs_baseline", "date", *tb.METRIC_BYTES_PER_SAMPLE)
# the tools where JAX cannot load: smaller still, every module imported
TOOL_ARGV_TINY = {
    "torch_streaming_bench": ["--hours", "0.01", "--reps", "1", "--combos", "bins:fused"],
    "torch_stations_bench": ["--stations", "2", "--seconds", "30", "--reps", "1",
                             "--impls", "jump,fused"],
    "torch_stations_breakdown": ["--stations", "2", "--seconds", "30", "--reps", "1"],
    "torch_iq_breakdown": ["--seconds", "1", "--stations", "2", "--reps", "1"],
}
TOOL_ARGV = {
    "torch_streaming_bench": ["--hours", "0.05", "--reps", "1",
                              "--combos", "welch:scan,bins:scan,bins:jump,bins:hop,bins:fused"],
    "torch_stations_bench": ["--stations", "4", "--seconds", "60", "--reps", "1",
                             "--impls", "scan,jump,hop,fused"],
    "torch_stations_breakdown": ["--stations", "4", "--seconds", "60", "--reps", "1"],
    "torch_iq_breakdown": ["--seconds", "2", "--reps", "1"],
}


# ---------------------------------------------------------------------------
# (a) fixtures
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seconds, seed", [(300.0, 2), (20.0, 1), (30.0, 10), (30.0, 17)])
def test_synth_audio_is_bench_py(seconds, seed):
    a, b = tb.synth_audio(seconds, seed), bench.synth_audio(seconds, seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_synth_hour_is_streaming_bench():
    a = torch_streaming_bench.synth_hour(4000, 900.0)
    b = streaming_bench.synth_hour(4000, 900.0)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("stations", [1, 3])
def test_stations_fixture_is_g3(stations):
    """At 600 s the stations fixture is G3's (its first rows)."""
    x, tones = tb.stations_fixture(stations, tb.G3_SECONDS)
    g, g_tones = gf.g3_stations(stations)
    assert x.dtype == g.dtype and np.array_equal(x, g) and tones == g_tones


def test_iq_capture_is_the_jax_package_synthesis():
    freqs = tb.iq_station_freqs(8)
    for a, b in zip(synth_wideband_iq(2_000_000, 1.0, freqs, seed=3)[:2],
                    jax_frontend.synth_wideband_iq(2_000_000, 1.0, freqs, seed=3)[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# each JAX-side function that builds its input next to JAX code, with the
# arguments it is run with and the input's shape at those arguments
JAX_SIDE = {
    "stations_pipeline": ("bench.stations_pipeline(n_stations=4, seconds=60.0)", (4, 300, 800)),
    "image_pipeline": ("bench.image_pipeline(n_segments=2, seconds=30.0)", (2, 150000)),
    "frontend_pipeline": ("bench.frontend_pipeline(seconds=1.0)", (6026, 166)),
    "frontend_iq_pipeline": ("bench.frontend_iq_pipeline(seconds=2.0)", (2, 8004, 500)),
    "stations_bench": ("stations_bench.main(['--stations', '4', '--seconds', '60'])",
                       (4, 300, 800)),
    "stations_breakdown": ("stations_breakdown.main(['--stations', '4', '--seconds', '60'])",
                           (4, 300, 800)),
    "iq_breakdown": ("iq_breakdown.main(['--seconds', '2'])", (2, 8004, 500)),
}


@pytest.fixture(scope="module")
def jax_side_inputs(tmp_path_factory):
    """The input each of :data:`JAX_SIDE` uploads, taken in a fresh process
    (JAX x64 off): ``jax.numpy.asarray`` is wrapped so that the first array
    of the input's shape is kept and the function stops there."""
    out = str(tmp_path_factory.mktemp("jax_side") / "inputs.npz")
    code = textwrap.dedent(
        """
        import json, sys
        import numpy as np
        import jax.numpy as jnp
        sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tools"]
        import bench, iq_breakdown, stations_bench, stations_breakdown
        calls = json.loads(sys.argv[3])

        class Taken(Exception):
            pass

        real, kept, want = jnp.asarray, {}, None

        def asarray(a, *args, **kw):
            if np.shape(a) == want[1]:
                kept[want[0]] = np.array(a)
                raise Taken
            return real(a, *args, **kw)

        jnp.asarray = asarray
        for name, (call, shape) in calls.items():
            want = (name, tuple(shape))
            try:
                eval(call)
            except Taken:
                pass
            assert name in kept, name
        np.savez(sys.argv[2], **kept)
        """
    )
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code, ROOT, out, json.dumps(JAX_SIDE)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


def port_side_input(name: str) -> np.ndarray:
    """The port's input for the same function at the same arguments."""
    if name in ("stations_pipeline", "stations_bench", "stations_breakdown"):
        return tb.stations_fixture(4, 60.0)[0].reshape(4, 300, 800)
    if name == "image_pipeline":
        return tb.image_fixture(2, 30.0, 5000)
    if name == "frontend_pipeline":
        x, centers = tb.channelizer_fixture(1.0, 8)
        plan, _ = fir.channel_bank_plan(x.size, 1_000_000, centers, bandwidth=200.0, decim=166,
                                        numtaps=257, device="cpu")
        return fir.frame_capture_host(x, plan)
    freqs = tb.iq_station_freqs(8)
    x_re, x_im, _ = synth_wideband_iq(2_000_000, 2.0, freqs, seed=3)
    centers = np.asarray([f - tb.STATIONS_TONE_HZ for f in freqs])
    plan, _ = fir.channel_bank_plan(x_re.size, 2_000_000, centers, bandwidth=1500.0, decim=500,
                                    numtaps=2001, device="cpu")
    return fir.frame_capture_host(np.stack([x_re, x_im]), plan)


@pytest.mark.parametrize("name", sorted(JAX_SIDE))
def test_fixture_is_the_jax_side_input(jax_side_inputs, name):
    a, b = port_side_input(name), jax_side_inputs[name]
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# (b) the gates on the CPU
# ---------------------------------------------------------------------------
def test_batch_and_fused_equals_parallel():
    x = tb.synth_audio(300.0, seed=2)
    gate = tb.verify_fused_vs_parallel(x, CPU)
    head = tb.batch_pipeline(x, CPU, tb.Timing(2, 0))
    assert gate["fused_equals_parallel"] and gate["verify_events"] == head["events"] > 0
    multi = tb.multi_channel_pipeline(2, 60.0, CPU, ONCE)
    assert multi["multi8_events"] > 0 and multi["multi8_n_calls"] == 1


def test_stations_fused_equals_scan():
    got = tb.stations_pipeline(4, 60.0, CPU, tb.Timing(2, 0))
    assert got["stations_fused_equals_scan"] and got["stations_events"] == 4
    assert "stations_golden_G3" not in got  # 60 s is not G3's fixture


def test_stations_against_golden_g3():
    """At 600 s the first call's events are G3's (2 of its 64 stations)."""
    got = tb.stations_pipeline(2, tb.G3_SECONDS, CPU, ONCE)
    assert got["stations_fused_equals_scan"] and got["stations_golden_G3"], got
    assert got["stations_golden_fixture_hashes_matched"] == 2
    assert got["stations_golden_events_jax"] == got["stations_golden_identical"] == 2


def test_frontend_iq_framed_equals_flat():
    got = tb.frontend_iq_pipeline(20.0, 8, CPU, ONCE)
    assert got["frontend_iq_framed_equals_flat"] and got["frontend_iq_events"] > 0
    assert tb.frontend_pipeline(1.0, 8, CPU, ONCE)["channelizer_n_calls"] == 1


def test_image_pipeline_finds_the_bursts():
    got = tb.image_pipeline(2, 30.0, CPU, timing=ONCE)
    assert got["image_critical"] == 4 and got["image_n_calls"] == 1


@pytest.mark.parametrize("tool", sorted(TOOL_ARGV))
def test_tool_passes_its_check(tool):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = importlib.import_module(tool).main(TOOL_ARGV[tool] + ["--device", "cpu"])
    assert rc == 0, out.getvalue()[-2000:]
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["tool"] == tool and result["card"] is None


def test_timing_summary():
    s = tb.summary([float(v) for v in range(100, 0, -1)], "x")
    assert s == {"x_median_ms": 50.5, "x_p90_ms": 90.0, "x_n_calls": 100}
    # 4 and 8 bytes a sample against 3.35e12 bytes/s
    assert tb.implausible_metrics({"value": 8e11, "frontend_iq_2msps_samples_per_sec": 5e11}) == [
        "frontend_iq_2msps_samples_per_sec"]


def test_profile_summary(tmp_path):
    """``--profile``'s summary: device time and records from the trace's
    device events, launches, copies and waits from the host's calls (less
    the synchronise that closes the window)."""
    trace = {"traceEvents": [
        {"cat": "kernel", "name": "k", "dur": 30.0}, {"cat": "kernel", "name": "k", "dur": 10.0},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 20.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel"},
        {"cat": "cuda_runtime", "name": "cudaLaunchCooperativeKernel"},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync"},
        {"cat": "cuda_runtime", "name": "cudaStreamSynchronize"},
        {"cat": "cuda_runtime", "name": "cudaDeviceSynchronize"},
        {"cat": "cpu_op", "name": "aten::mm", "dur": 99.0}]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    assert tb.trace_summary(str(path), 2, "x") == {
        "x_profiled_calls": 2, "x_device_ms_per_call": 0.03, "x_kernel_records_per_call": 1.0,
        "x_launches_per_call_traced": 1.0, "x_memcpy_per_call": 0.5, "x_host_waits_per_call": 0.5}
    got = tb.Timing(reps=2, warmup=0, profile_dir=str(tmp_path)).measure(
        lambda: torch.ones(8).sum(), CPU, "y")
    assert got["y_n_calls"] == 2 and got["y_profiled_calls"] == tb.PROFILED_CALLS
    assert (tmp_path / "y" / "trace.json").exists()


# ---------------------------------------------------------------------------
# (c) the whole program, with no JAX
# ---------------------------------------------------------------------------
def test_jax_free_main_and_tools():
    code = textwrap.dedent(
        f"""
        import contextlib, importlib, io, json, sys
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
        sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tools"]
        import torch_bench
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = torch_bench.main({ALL_METRICS!r} + ["--device", "cpu"], sizes={SMALL!r}, reps=2,
                                  warmup=0)
        assert rc == 0, out.getvalue()[-2000:]
        artifact = json.loads(out.getvalue().strip().splitlines()[-1])
        for tool, argv in {TOOL_ARGV_TINY!r}.items():
            with contextlib.redirect_stdout(io.StringIO()):
                assert importlib.import_module(tool).main(argv + ["--device", "cpu"]) == 0, tool
        loaded = [k for k, v in sys.modules.items() if v is not None and (
            k.split(".")[0] in ("jax", "bench") or k.split(".")[0] == "meteor_scatter_tpu")]
        print(json.dumps({{"artifact": artifact, "loaded": loaded}}))
        """
    )
    proc = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    art = got["artifact"]
    assert got["loaded"] == []
    assert [k for k in METRIC_KEYS if k not in art] == []
    assert "implausible" not in art and art["clock"] == "host"
    assert art["device"]["platform"] == "cpu"
    assert all(art[g] for g in ("fused_equals_parallel", "stations_fused_equals_scan",
                                "frontend_iq_framed_equals_flat"))
    for p in ("", "multi8_", "stations64_", "image_", "channelizer_", "frontend_iq_"):
        assert art[f"{p}n_calls"] == 2 and art[f"{p}p90_ms"] >= art[f"{p}median_ms"] > 0
        assert f"{p}upload_ms" in art


# ---------------------------------------------------------------------------
# (d) a gate forced false
# ---------------------------------------------------------------------------
def _drop_events(real):
    def parallel(*args, **kw):
        thr, above = real(*args, **kw)
        return thr, torch.zeros_like(above)
    return parallel


def _shift_thresholds(real):
    def scan(*args, **kw):
        state, events, thr = real(*args, **kw)
        return state, events, thr + 1.0
    return scan


def _louder_flat(real):
    def channelize_iq(*args, **kw):
        re, im = real(*args, **kw)
        return re * 2.0, im
    return channelize_iq


def _other_fixture(real):
    def fixture(*args, **kw):
        x, tones = real(*args, **kw)
        return x + np.float32(1e-3), tones
    return fixture


# gate, the flags that reach it, the sizes' change, what to break
FORCED = {
    "fused_equals_parallel": ([], {}, ("meteor_scatter_tpu_torch.models.adaptive",
                                       "adaptive_thresholds_parallel", _drop_events)),
    "stations_fused_equals_scan": (["--stations"], {}, ("meteor_scatter_tpu_torch.models.streaming",
                                                        "stream_scan", _shift_thresholds)),
    "stations_golden_G3": (["--stations"], {"stations": 1, "stations_seconds": tb.G3_SECONDS},
                           ("torch_bench", "stations_fixture", _other_fixture)),
    "frontend_iq_framed_equals_flat": (["--frontend-iq"], {}, ("meteor_scatter_tpu_torch.ops.fir",
                                                              "channelize_iq", _louder_flat)),
}


@pytest.mark.parametrize("gate", sorted(FORCED))
def test_gate_forced_false_exits_1(gate, monkeypatch):
    flags, sizes, (module, name, wrap) = FORCED[gate]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tb.main(flags + ["--device", "cpu"], sizes={**SMALL, **sizes}, reps=1, warmup=0)
    artifact = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 1 and artifact[gate] is False
    assert [g for g in tb.GATES if artifact.get(g) is False] == [gate]
