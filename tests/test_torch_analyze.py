"""The batch analyzer of the PyTorch port against the JAX package, on the CPU.

Both ``main``s run on the same generated WAV (the JAX one on its CPU
default, the parallel solver).  The Audacity label files must be
byte-identical and the event CSVs equal on t_start, t_stop, dur_s,
utc_start and utc_stop; the ``dB`` column agrees to ``DB_ATOL``, since the
two frameworks' float32 band-power products sum in different orders
(~2e-5 dB per block at these levels).

The import guard runs the port in a subprocess where ``import jax`` fails,
as on a GPU machine without JAX.
"""

import csv
import datetime
import os
import re
import struct
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from meteor_scatter_tpu.apps import analyze as jan
from meteor_scatter_tpu.io import wavio as jwav
from meteor_scatter_tpu_torch.apps import analyze as tan
from meteor_scatter_tpu_torch.io import wavio as twav
from meteor_scatter_tpu_torch.io.ingest import read_wav_to_device
from tests import test_torch_wav_ingest as wav_kinds

DB_ATOL = 1e-4
FS = 6000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_wav(path, minutes, seed):
    """int16 noise with a 1 s 1003 Hz tone every 47 s from 10 s on."""
    rng = np.random.default_rng(seed)
    n = FS * 60 * minutes
    x = rng.standard_normal(n) * 0.5
    j = np.arange(FS)
    for s in np.arange(10.0, n / FS - 5.0, 47.0):
        a = int(round(s * FS))
        x[a : a + FS] += 2.0 * np.sin(2 * np.pi * 1003.0 * (a + j) / FS)
    twav.write_wav(path, FS, np.round(x * 3000).astype(np.int16))
    return path


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    d = tmp_path_factory.mktemp("wav")
    return make_wav(str(d / "station_gqrx_20260817_120000_49969000.wav"), 10, 2026)


def read_rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


@pytest.mark.parametrize("mode", ["adaptive", "fixed"])
def test_main_matches_jax(wav, tmp_path, mode, capsys):
    out = {k: str(tmp_path / k) for k in ("t.csv", "t.txt", "j.csv", "j.txt")}
    extra = ["--fixed-threshold"] if mode == "fixed" else []
    assert tan.main([wav, "--out-csv", out["t.csv"], "--out-audacity", out["t.txt"],
                     "--device", "cpu", *extra]) == 0
    assert jan.main([wav, "--out-csv", out["j.csv"], "--out-audacity", out["j.txt"], *extra]) == 0
    capsys.readouterr()

    with open(out["t.txt"], "rb") as a, open(out["j.txt"], "rb") as b:
        lbl = a.read()
        assert lbl == b.read()
    rows_t, rows_j = read_rows(out["t.csv"]), read_rows(out["j.csv"])
    assert len(rows_t) == len(rows_j) >= 10  # ~12 tones in 10 minutes
    keys = ("t_start", "t_stop", "dur_s", "utc_start", "utc_stop")
    for r_t, r_j in zip(rows_t, rows_j):
        assert tuple(r_t[k] for k in keys) == tuple(r_j[k] for k in keys)
        assert abs(float(r_t["dB"]) - float(r_j["dB"])) <= DB_ATOL
    assert rows_t[0]["utc_start"].startswith("2026-08-17T12:00:")


def test_fused_twin_equals_parallel(wav):
    kw = dict(device="cpu", verbose=False, expected_sample_rate=None)
    res_f = tan.proc_wav_file(wav, impl="fused", **kw)
    res_p = tan.proc_wav_file(wav, impl="parallel", **kw)
    assert [(d.t_start, d.t_stop) for d in res_f.detections] == [
        (d.t_start, d.t_stop) for d in res_p.detections
    ]
    np.testing.assert_allclose(
        [d.dB for d in res_f.detections], [d.dB for d in res_p.detections], atol=1e-4
    )
    np.testing.assert_allclose(res_f.thresholds, res_p.thresholds, rtol=1e-4)
    for arr in (res_f.band_power, res_f.noise_power, res_f.delta_power, res_f.thresholds):
        assert arr.shape == (3000,) and np.isfinite(arr).all()


def test_unported_outputs_raise(wav, tmp_path, capsys):
    # every output is ported now: one run writes the spectrogram PNGs and the
    # debug plots (tests/test_torch_monitor.py and tests/test_torch_host_apps.py
    # hold them against JAX)
    spec, plots = tmp_path / "spec", tmp_path / "plots"
    assert tan.main([wav, "--device", "cpu", "--out-spec-dir", str(spec),
                     "--plot-dir", str(plots)]) == 0
    out = capsys.readouterr().out
    n = int(re.search(r"^Found (\d+) detections$", out, re.M).group(1))
    assert n >= 10 and len(os.listdir(spec)) == n
    assert sorted(os.listdir(plots)) == ["delta_threshold.png", "hist_db.png",
                                         "hist_duration.png", "per_hour.png"]


def test_cuda_requested_without_gpu_raises(wav, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tan.proc_wav_file(wav, device="cuda", verbose=False)


def write_extensible_pcm16(path, fs, x):
    """WAVE_FORMAT_EXTENSIBLE (0xFFFE) header around PCM16 data."""
    data = x.astype("<i2").tobytes()
    sub_guid = struct.pack("<H", 1) + b"\x00\x00" + bytes(
        [0x00, 0x00, 0x10, 0x00, 0x80, 0x00, 0x00, 0xAA, 0x00, 0x38, 0x9B, 0x71]
    )
    fmt = struct.pack("<HHIIHH", 0xFFFE, 1, fs, fs * 2, 2, 16)
    fmt += struct.pack("<HHI", 22, 16, 0x4) + sub_guid
    riff = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    riff += b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as fh:
        fh.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)


@pytest.mark.parametrize("kind", ["int16", "float32", "stereo", "extensible", "odd_length"])
def test_read_wav_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(0)
    p = str(tmp_path / f"{kind}.wav")
    if kind == "extensible":
        write_extensible_pcm16(p, 4000, (rng.standard_normal(4000) * 3000).astype(np.int16))
    else:
        x = {
            "int16": (rng.standard_normal(4000) * 3000).astype(np.int16),
            "float32": rng.standard_normal(4000).astype(np.float32),
            "stereo": (rng.standard_normal((4000, 2)) * 3000).astype(np.int16),
            "odd_length": (rng.standard_normal(4001) * 3000).astype(np.int16)[:, None][:, 0],
        }[kind]
        jwav.write_wav(p, 4000, x)
    for mono in (False, True):
        fs_t, x_t = twav.read_wav(p, mono=mono)
        fs_j, x_j = jwav.read_wav(p, mono=mono)
        assert fs_t == fs_j == 4000 and x_t.dtype == x_j.dtype
        np.testing.assert_array_equal(x_t, x_j)
        assert torch.from_numpy(x_t).numel() == x_t.size  # writable: no copy, no warning


@pytest.mark.parametrize("mono", [False, True])
@pytest.mark.parametrize("kind", wav_kinds.KINDS + wav_kinds.FAULTS)
def test_read_wav_kinds_match_jax(tmp_path, kind, mono):
    """The file kinds of the card ingest's tests (sample types, channels,
    chunk layouts, truncation, malformed files): the port's ``read_wav``
    and the ingest's piece loop (7-byte pieces on the CPU) give the JAX
    ``read_wav``'s samples and dtype, or its error."""
    p = str(tmp_path / f"{kind}.wav")
    wav_kinds.make(kind, p)
    want = wav_kinds.outcome(lambda: jwav.read_wav(p, mono=mono))
    wav_kinds.assert_same_outcome(wav_kinds.outcome(lambda: twav.read_wav(p, mono=mono)), want)
    ring = wav_kinds.cpu_ring(7)
    wav_kinds.assert_same_outcome(
        wav_kinds.outcome(lambda: read_wav_to_device(p, torch.device("cpu"), mono, ring=ring)),
        want)


def read_through_fifo(fifo, payload, reader):
    """``reader(fifo)``'s outcome while a thread writes ``payload`` into the
    named pipe ``fifo``."""
    def feed():
        try:
            with open(fifo, "wb") as fh:
                fh.write(payload)
        except BrokenPipeError:  # the reader stopped early, on an error
            pass

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    try:
        return wav_kinds.outcome(lambda: reader(fifo))
    finally:
        t.join(10)
        assert not t.is_alive()


@pytest.mark.parametrize("kind", wav_kinds.KINDS + wav_kinds.FAULTS)
def test_read_wav_from_a_pipe_matches_jax(tmp_path, kind):
    """``read_wav`` reads a stream as the JAX one does: the same samples
    through a named pipe, or the same error where the walk has to seek
    (a chunk it skips, an odd size's pad byte)."""
    p = str(tmp_path / f"{kind}.wav")
    wav_kinds.make(kind, p)
    with open(p, "rb") as fh:
        payload = fh.read()
    fifo = str(tmp_path / "pipe.wav")
    os.mkfifo(fifo)
    want = read_through_fifo(fifo, payload, lambda f: jwav.read_wav(f, mono=True))
    got = read_through_fifo(fifo, payload, lambda f: twav.read_wav(f, mono=True))
    wav_kinds.assert_same_outcome(got, want)
    if kind in wav_kinds.KINDS and kind not in ("uint8", "list_chunk"):  # no seek needed
        assert want[0] == "ok"


@pytest.mark.parametrize(
    "name", ["a_gqrx_20260817_120000_49969000.wav", "/x/rec_20251231_235959.wav", "plain.wav"]
)
def test_parse_gqrx_start_time_matches_jax(name):
    assert tan.parse_gqrx_start_time(name) == jan.parse_gqrx_start_time(name)


def test_jax_free_import_and_run(tmp_path):
    """Every module of the port imports with ``import jax`` failing, the
    analyzer (both adaptive solvers, and its spectrogram PNGs), the live
    detector (welch and headless, its waterfall PNGs, and the episode-jump
    solvers ``--impl hop`` / ``jump``), the wideband front end (real and
    I/Q), the segment monitor and the multi-device dryrun (a virtual mesh of
    8 CPU positions) run end to end on the CPU, and so do the host slice's
    paths: the monitor's ``--pump``, the analyzer's ``--plot-dir``, the live
    ``--ui`` (Agg), the merge and one dashboard request; afterwards no
    module of JAX or of the JAX package ``meteor_scatter_tpu`` is loaded."""
    code = textwrap.dedent(
        """
        import contextlib, importlib, io, os, pkgutil, sys
        sys.modules["jax"] = None  # any `import jax` now raises ImportError
        import numpy as np
        import meteor_scatter_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        from meteor_scatter_tpu_torch.apps import live
        from meteor_scatter_tpu_torch.apps.analyze import proc_wav_file
        from meteor_scatter_tpu_torch.io.wavio import write_wav
        rng = np.random.default_rng(1)
        x = rng.standard_normal(6000 * 90) * 0.5
        x[6000 * 40 : 6000 * 41] += 2.0 * np.sin(2 * np.pi * 1003.0 * np.arange(6000) / 6000)
        path = sys.argv[1] + "/tiny.wav"
        write_wav(path, 6000, np.round(x * 3000).astype(np.int16))
        for impl in ("parallel", "fused"):
            res = proc_wav_file(path, device="cpu", impl=impl, verbose=False)
            assert [(d.t_start, d.t_stop) for d in res.detections] == [(40.0, 41.0)], res.detections
        spec = sys.argv[1] + "/spec"
        proc_wav_file(path, device="cpu", verbose=False, outfile_path=spec)
        assert os.listdir(spec) == ["spec_and_psd_40.00_41.00.png"], os.listdir(spec)
        from meteor_scatter_tpu_torch.apps import analyze, merge
        with contextlib.redirect_stdout(io.StringIO()):
            assert analyze.main([path, "--device", "cpu", "--plot-dir", sys.argv[1] + "/plots",
                                 "--out-csv", sys.argv[1] + "/ev.csv"]) == 0
            assert merge.main([sys.argv[1] + "/ev.csv", "--out-dir", sys.argv[1] + "/merged"]) == 0
        assert sorted(os.listdir(sys.argv[1] + "/plots")) == [
            "delta_threshold.png", "hist_db.png", "hist_duration.png"], os.listdir(sys.argv[1] + "/plots")
        y = rng.standard_normal(4000 * 40) * 0.05
        y[4000 * 20 : 4000 * 21] += 0.6 * np.sin(2 * np.pi * 1000.0 * np.arange(4000) / 4000)
        path = sys.argv[1] + "/live.wav"
        write_wav(path, 4000, np.round(y * 32768).astype(np.int16))
        wf = sys.argv[1] + "/wf"
        for extra in ([], ["--headless"], ["--spec-export-dir", wf], ["--impl", "hop"],
                      ["--impl", "jump"], ["--ui", "--realtime-factor", "1e9", "--n-fft", "1024",
                                           "--stop-sec", "24"]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert live.main([path, "--device", "cpu", "--min-dur", "0.5", *extra]) == 0
            assert "start=20.00s" in out.getvalue() and "Total detected meteors: 1" in out.getvalue()
        assert len(os.listdir(wf)) == 1 and os.listdir(wf)[0].startswith("spec_20.00_"), os.listdir(wf)
        from meteor_scatter_tpu_torch.apps import frontend
        for extra in ([], ["--iq"]):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert frontend.main(["--fs", "48000", "--stations", "2", "--seconds", "60",
                                      "--base-freq", "10000", "--spacing", "6000",
                                      "--device", "cpu", *extra]) == 0
            stations = [ln for ln in out.getvalue().splitlines() if ln.startswith("station ")]
            # the second burst of each station starts past the 10 s fixed start
            assert len(stations) == 2 and all(": 2 events" in ln for ln in stations), out.getvalue()
        from meteor_scatter_tpu_torch.apps import monitor
        z = rng.standard_normal(5000 * 60) * 0.3
        z[5000 * 10 : 5000 * 11] += 3.0 * np.sin(2 * np.pi * 1000.0 * np.arange(5000) / 5000)
        path = sys.argv[1] + "/mon.wav"
        write_wav(path, 5000, np.round(z * 3000).astype(np.int16))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert monitor.main(["--wav", path, "--device", "cpu", "--csv-out", sys.argv[1] + "/csv",
                                 "--spec-out", sys.argv[1] + "/png",
                                 "--start-time", "2026-08-17T12:00:00"]) == 0
        assert out.getvalue().count("Critical bursts this segment") == 2, out.getvalue()
        assert len(os.listdir(sys.argv[1] + "/png")) >= 1
        assert "20260817.csv" in os.listdir(sys.argv[1] + "/csv")
        pump_out = io.StringIO()
        with contextlib.redirect_stdout(pump_out):  # on the wall clock, as the JAX CLI's pump
            assert monitor.main(["--wav", path, "--pump", "--device", "cpu",
                                 "--csv-out", sys.argv[1] + "/csv_pump", "--spec-out",
                                 sys.argv[1] + "/png_pump"]) == 0
        counts = [ln for ln in out.getvalue().splitlines() if "bursts this segment" in ln]
        assert counts == [ln for ln in pump_out.getvalue().splitlines() if "bursts this segment" in ln]
        assert len(os.listdir(sys.argv[1] + "/png_pump")) == len(os.listdir(sys.argv[1] + "/png"))
        assert ".offset.json" not in os.listdir(sys.argv[1] + "/csv_pump")  # no position, no journal
        from meteor_scatter_tpu_torch.config import DashboardConfig
        from meteor_scatter_tpu_torch.dashboard.app import DashboardApp
        app = DashboardApp(DashboardConfig(csv_folder=sys.argv[1] + "/csv",
                                           csv_storage_path=sys.argv[1] + "/final.csv"),
                           static_dir=sys.argv[1] + "/static")
        got = {}
        body = b"".join(app({"REQUEST_METHOD": "GET", "PATH_INFO": "/api/dynamischer_inhalt"},
                            lambda status, headers: got.update(status=status)))
        assert got["status"] == "200 OK" and b"missing_days" in body, body
        from meteor_scatter_tpu_torch.parallel.dryrun import dryrun_multichip
        with contextlib.redirect_stdout(io.StringIO()):
            line = dryrun_multichip(8, devices=["cpu"] * 8)
        assert "events per channel: [3, 3]" in line, line
        loaded = [k for k, v in sys.modules.items() if v is not None and (
            k.split(".")[0] == "jax" or k == "meteor_scatter_tpu"
            or k.startswith("meteor_scatter_tpu."))]
        assert not loaded, loaded
        print("JAX-FREE OK")
        """
    )
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               MPLBACKEND="Agg")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX-FREE OK" in proc.stdout


def test_events_to_detections_block_offset():
    from meteor_scatter_tpu_torch.io.events_csv import events_to_detections
    from meteor_scatter_tpu_torch.models.events import events_from_mask

    above = torch.tensor([False, True, True, False, True])
    ev = events_from_mask(above, torch.arange(5.0), cap=4)
    start = datetime.datetime(2026, 8, 17)
    dets = events_to_detections(ev, 0.2, start, block_offset=10)
    assert [(d.t_start, d.t_stop) for d in dets] == [(11 * 0.2, 13 * 0.2), (14 * 0.2, 15 * 0.2)]
    assert dets[0].utc_start == start + datetime.timedelta(seconds=11 * 0.2)
    assert dets[1].dB == 4.0


def test_timing_copy_matches_jax(tmp_path):
    """The port's own ``PhaseTimer`` / ``Throughput`` report as the JAX
    package's do; ``maybe_profile`` writes a ``torch.profiler`` trace."""
    from meteor_scatter_tpu.utils import timing as jt
    from meteor_scatter_tpu_torch.utils import timing as tt

    timers = []
    for mod in (tt, jt):
        timer = mod.PhaseTimer()
        for phase, dt in (("read", 0.25), ("detect", 0.5), ("read", 0.125)):
            timer.totals[phase] += dt
            timer.counts[phase] += 1
        timers.append(timer)
        with timer.phase("tiny"):
            pass
        assert timer.counts["tiny"] == 1 and timer.totals["tiny"] >= 0.0
        timer.totals["tiny"] = 0.0
    assert timers[0].summary() == timers[1].summary()
    thr = tt.Throughput()
    assert thr.samples_per_sec == 0.0
    thr.add(6000, 0.5)
    assert thr.samples_per_sec == 12000.0
    with tt.maybe_profile(None):
        pass
    with tt.maybe_profile(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
