"""The port's host apps against the JAX package's, on the CPU: the monitor's
``--pump`` ingest, the analyzer's ``--plot-dir`` plots, the live view and
``live --ui`` (matplotlib's Agg backend, pacing off), and the multi-day
merge.  Every comparison is exact: file bytes, event lines and the view's
series.
"""

import datetime
import io
import os
import re
import sys

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from meteor_scatter_tpu.apps import analyze as janalyze  # noqa: E402
from meteor_scatter_tpu.apps import live_view as jview  # noqa: E402
from meteor_scatter_tpu.apps import merge as jmerge  # noqa: E402
from meteor_scatter_tpu.apps import monitor as jmon  # noqa: E402
from meteor_scatter_tpu.config import DetectionConfig as JDetectionConfig  # noqa: E402
from meteor_scatter_tpu.config import VisualizationConfig as JVisualizationConfig  # noqa: E402
from meteor_scatter_tpu_torch.apps import analyze as tanalyze  # noqa: E402
from meteor_scatter_tpu_torch.apps import live as tlive  # noqa: E402
from meteor_scatter_tpu_torch.apps import live_view as tview  # noqa: E402
from meteor_scatter_tpu_torch.apps import merge as tmerge  # noqa: E402
from meteor_scatter_tpu_torch.apps import monitor as tmon  # noqa: E402
from meteor_scatter_tpu_torch.config import DetectionConfig, VisualizationConfig  # noqa: E402
from meteor_scatter_tpu_torch.io.events_csv import OutputDetection, write_event_csv  # noqa: E402
from meteor_scatter_tpu_torch.io.wavio import write_wav  # noqa: E402
from meteor_scatter_tpu_torch.models.streaming import (  # noqa: E402
    StreamConfig,
    stream_init,
    stream_process,
)

from test_streaming_headless import make_audio  # noqa: E402
from test_torch_monitor import FS as MON_FS  # noqa: E402
from test_torch_monitor import assert_same_bytes, dir_files, monitor_audio, quiet  # noqa: E402

LIVE_FS = 4000
LIVE = dict(signal_freq=1000.0, detection_db_over_noise_mean_min=1.0, detection_dur_min_sec=0.5)
EVENT_LINE = re.compile(r"^Detected Meteor: .*$", re.M)


def read_bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


# --- monitor --pump ------------------------------------------------------------


@pytest.fixture(scope="module")
def mon_wav(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("pump") / "mon.wav")
    write_wav(p, MON_FS, monitor_audio(6, seed=4))
    return p


def stepping_clock(monkeypatch, module):
    """``module.datetime`` with a ``now()`` that moves 30 s a call from one
    start: two runs that read the clock in the same order read the same
    times."""
    calls = []

    class Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            calls.append(None)
            return cls(2026, 8, 17, 12, 58) + datetime.timedelta(seconds=30 * len(calls))

    monkeypatch.setattr(module, "datetime", Clock)


def run_monitor_cli(mod, wav, out, extra):
    csv, spec = str(out / "csv"), str(out / "spec")
    dev = ["--device", "cpu"] if mod is tmon else []
    rc, text = quiet(mod.main, ["--wav", wav, "--csv-out", csv, "--spec-out", spec, *extra, *dev])
    assert rc == 0
    return csv, spec, text


def test_pump_matches_jax_pump(mon_wav, tmp_path, monkeypatch):
    """``--pump`` on both packages' wall clocks, each stepped alike."""
    dirs = {}
    for name, mod in (("t", tmon), ("j", jmon)):
        stepping_clock(monkeypatch, mod)
        dirs[name] = run_monitor_cli(mod, mon_wav, tmp_path / name, ["--pump"])
    (csv_t, spec_t, out_t), (csv_j, spec_j, out_j) = dirs["t"], dirs["j"]
    counts = re.compile(r"^(?:Non-c|C)ritical bursts this segment: \d+$", re.M)
    assert counts.findall(out_t) == counts.findall(out_j) and len(counts.findall(out_t)) == 12
    # the JAX pump source has no position, so it keeps no offset journal
    ledger = [n for n in dir_files(csv_j)]
    assert ledger == [n for n in dir_files(csv_t) if n != ".offset.json"]
    for n in ledger:
        assert read_bytes(os.path.join(csv_t, n)) == read_bytes(os.path.join(csv_j, n)), n
    assert_same_bytes(spec_t, spec_j)
    assert len(dir_files(spec_t)) == 6


def test_pump_equals_wav_source(mon_wav, tmp_path):
    """On the audio timeline (``--start-time``, 40 simulated seconds a
    second: hourly flushes and a midnight rotation) the pump gives the WAV
    source's segments bit for bit: the same ledger, journals and PNGs byte
    for byte."""
    extra = ["--start-time", "2026-08-16T23:57:00", "--time-scale", "40"]
    csv_p, spec_p, _ = run_monitor_cli(tmon, mon_wav, tmp_path / "pump", ["--pump", *extra])
    csv_w, spec_w, _ = run_monitor_cli(tmon, mon_wav, tmp_path / "wav", extra)
    assert_same_bytes(csv_p, csv_w)
    assert_same_bytes(spec_p, spec_w)
    for day in ("20260816", "20260817"):
        with open(os.path.join(csv_p, day + ".csv")) as fh:
            assert len(fh.read().splitlines()) == 2  # the header and one hour
    assert len(dir_files(spec_p)) == 6


def test_pump_source_segments_and_resume_refused(mon_wav, tmp_path):
    cfg = tmon.MonitorConfig()
    pump = tmon.PumpSegmentSource(mon_wav, cfg)
    wav = tmon.WavSegmentSource(mon_wav, cfg)
    try:
        assert pump.ring.native and pump.pump.native
        for k in range(6):
            a, b = pump.grab(), wav.grab()
            assert a.dtype == np.float32 and np.array_equal(a, b.astype(np.float32)), k
            assert pump.pos == wav.pos == (k + 1) * MON_FS * 30
        assert pump.grab() is None and wav.grab() is None
        assert pump.ring.dropped() == 0
    finally:
        pump.close()
    with pytest.raises(SystemExit):  # argparse error, as in the JAX CLI
        quiet(tmon.main, ["--wav", mon_wav, "--pump", "--resume", "--device", "cpu",
                          "--csv-out", str(tmp_path / "c")])
    with pytest.raises(ValueError, match="expected 6000 Hz"):
        tmon.PumpSegmentSource(mon_wav, tmon.MonitorConfig(sample_rate=6000))


# --- analyze --plot-dir --------------------------------------------------------


@pytest.fixture(scope="module")
def analyze_wav(tmp_path_factory):
    """4 minutes at 6 kHz, a 1 s 1003 Hz tone every 47 s, gqrx-named."""
    rng = np.random.default_rng(12)
    fs = 6000
    x = rng.standard_normal(fs * 240) * 0.5
    j = np.arange(fs)
    for s in (10.0, 57.0, 104.0, 151.0, 198.0):
        a = int(s * fs)
        x[a : a + fs] += 2.0 * np.sin(2 * np.pi * 1003.0 * (a + j) / fs)
    p = str(tmp_path_factory.mktemp("plot") / "st_gqrx_20260817_115800_49969000.wav")
    write_wav(p, fs, np.round(x * 3000).astype(np.int16))
    return p


def test_export_debug_plots_matches_jax(analyze_wav, tmp_path):
    res = tanalyze.proc_wav_file(analyze_wav, device="cpu", verbose=False,
                                 wav_start_date_time=datetime.datetime(2026, 8, 17, 11, 58))
    assert len(res.detections) == 5
    paths_t = tanalyze.export_debug_plots(res, str(tmp_path / "t"))
    paths_j = janalyze.export_debug_plots(res, str(tmp_path / "j"))
    names = [os.path.basename(p) for p in paths_t]
    assert names == [os.path.basename(p) for p in paths_j] == [
        "delta_threshold.png", "hist_duration.png", "hist_db.png", "per_hour.png"]
    for a, b in zip(paths_t, paths_j):
        assert read_bytes(a) == read_bytes(b), a


def test_plot_dir_cli_matches_jax(analyze_wav, tmp_path):
    rc_t, out_t = quiet(tanalyze.main, [analyze_wav, "--plot-dir", str(tmp_path / "t"),
                                        "--device", "cpu"])
    rc_j, out_j = quiet(janalyze.main, [analyze_wav, "--plot-dir", str(tmp_path / "j")])
    assert rc_t == rc_j == 0
    assert dir_files(str(tmp_path / "t")) == dir_files(str(tmp_path / "j")) == [
        "delta_threshold.png", "hist_db.png", "hist_duration.png", "per_hour.png"]
    wrote = re.compile(r"^wrote .*/(\S+)$", re.M)
    assert wrote.findall(out_t) == wrote.findall(out_j)


# --- the live view and live --ui -----------------------------------------------


def two_feeds():
    """Two 12 s feeds of the port's stream_process (welch front, scan) on
    audio with a burst at 15 s: per feed (diags on the CPU, first block,
    events)."""
    cfg = DetectionConfig(n_fft=1024, **LIVE)
    x = torch.from_numpy(make_audio(LIVE_FS, dur=24.0))
    state = stream_init(StreamConfig.from_config(cfg), "cpu")
    feeds, block = [], 0
    for part in x.split(12 * LIVE_FS):
        state, ev, diags = stream_process(cfg, state, part, LIVE_FS, impl="scan")
        events = [dict(time_start=float(ev.time_start[i]), time_stop=float(ev.time_stop[i]))
                  for i in range(int(ev.count))]
        feeds.append((diags, block, events))
        block += part.numel() // 800
    return cfg, feeds, float(state.psd_db_mean_from_init)


def test_live_view_matches_jax():
    cfg, feeds, psd_mean = two_feeds()
    assert [len(f[2]) for f in feeds] == [0, 1]
    views = []
    for mod, dcls, vcls in ((tview, DetectionConfig, VisualizationConfig),
                            (jview, JDetectionConfig, JVisualizationConfig)):
        c = dcls(n_fft=1024, **LIVE)
        view = mod.LiveView(c, vcls(flag_realtime_animation=False), LIVE_FS,
                            np.fft.rfftfreq(1024, 1.0 / LIVE_FS))
        for k, (diags, block, events) in enumerate(feeds):
            if mod is jview:  # the JAX view takes host arrays
                diags = {key: v.numpy() if torch.is_tensor(v) else v for key, v in diags.items()}
            if k:
                view.psd_mean_from_init = psd_mean
            view.update(diags, block, events)
        buf = io.BytesIO()
        view.fig.savefig(buf, format="png", dpi=40)
        plt.close(view.fig)
        views.append((view, buf.getvalue()))
    (vt, png_t), (vj, png_j) = views
    for name in ("t", "ms_db", "n1_db", "n2_db", "over", "thr", "wf_t", "det_marks"):
        a, b = np.asarray(getattr(vt, name)), np.asarray(getattr(vj, name))
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), name
    assert np.array_equal(np.asarray(vt.wf), np.asarray(vj.wf))
    assert len(vt.t) == 120 and len(vt.det_marks) == 1
    assert png_t == png_j


@pytest.fixture(scope="module")
def ui_wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ui") / "burst.wav")
    x = np.clip(np.round(make_audio(LIVE_FS, dur=20.0) * 32768.0), -32768, 32767)
    write_wav(path, LIVE_FS, x.astype(np.int16))
    return path


@pytest.mark.parametrize("impl", ["scan", "hop"])
def test_live_ui_prints_the_same_events(ui_wav, impl):
    args = [ui_wav, "--device", "cpu", "--impl", impl, "--n-fft", "1024",
            "--min-dur", "0.5", "--min-mean-db", "1"]
    _, plain = quiet(tlive.main, args)
    _, ui = quiet(tlive.main, [*args, "--ui", "--realtime-factor", "1e9"])
    plt.close("all")
    assert EVENT_LINE.findall(ui) == EVENT_LINE.findall(plain)
    assert len(EVENT_LINE.findall(ui)) == 1 and "Total detected meteors: 1" in ui


def test_live_session_keeps_feed_diags(ui_wav):
    sess = tlive.LiveSession(DetectionConfig(**LIVE), LIVE_FS,
                             vis=VisualizationConfig(enable_ui_plots=True), headless=True,
                             impl="hop", device="cpu")
    assert not sess.headless  # the view needs the Welch front's PSD
    sess.feed(np.zeros(LIVE_FS * 3, np.float32))
    sess.feed(np.zeros(LIVE_FS * 2, np.float32))
    assert sess.block_offset_before_feed == 15
    assert sess.last_diags["psd_db"].shape == (10, 2049)
    assert sess.last_diags["thr_degraded"].ndim == 0  # hop's scalar, not a series


# --- merge ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def event_csvs(tmp_path_factory):
    """Two days of event CSVs from the port's writer."""
    d = tmp_path_factory.mktemp("merge")
    paths = []
    rng = np.random.default_rng(8)
    for day, hours in ((datetime.date(2026, 8, 11), (0, 5, 23)), (datetime.date(2026, 8, 12),
                                                                  (5, 6, 13))):
        dets = []
        for h in hours:
            for i in range(int(rng.integers(1, 6))):
                t0 = datetime.datetime.combine(day, datetime.time(h, i * 7, 3))
                dets.append(OutputDetection(t_start=h * 3600.0 + i, t_stop=h * 3600.0 + i + 1,
                                            dur_s=1.0, dB=float(rng.uniform(3, 30)), utc_start=t0,
                                            utc_stop=t0 + datetime.timedelta(seconds=1)))
        paths.append(str(d / f"out_{day:%Y%m%d}.csv"))
        write_event_csv(paths[-1], dets)
    return paths


@pytest.mark.parametrize("matplotlib_present", [True, False])
def test_merge_main_matches_jax(event_csvs, tmp_path, monkeypatch, matplotlib_present):
    """Report, PNGs and the heatmap PDF (``SOURCE_DATE_EPOCH`` pins its
    date), or without matplotlib the CSV tables."""
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    if not matplotlib_present:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    pattern = os.path.join(os.path.dirname(event_csvs[0]), "out_*.csv")
    outs = {}
    for name, mod in (("t", tmerge), ("j", jmerge)):
        rc, outs[name] = quiet(mod.main, [pattern, "--out-dir", str(tmp_path / name)])
        assert rc == 0
    assert outs["t"].replace(str(tmp_path / "t"), "") == outs["j"].replace(str(tmp_path / "j"), "")
    assert_same_bytes(str(tmp_path / "t"), str(tmp_path / "j"))
    want = ({"per_hour.png", "per_day.png", "heatmap.pdf"} if matplotlib_present
            else {"per_hour.csv", "per_day.csv", "heatmap.csv"})
    assert set(dir_files(str(tmp_path / "t"))) == want | {"report.html"}


def test_merge_tables_match_jax(event_csvs):
    df_t, df_j = tmerge.merge_event_csvs(event_csvs), jmerge.merge_event_csvs(event_csvs)
    assert df_t.equals(df_j) and len(df_t) > 10
    assert tmerge.detections_per_hour(df_t).equals(jmerge.detections_per_hour(df_j))
    assert tmerge.detections_per_day(df_t).equals(jmerge.detections_per_day(df_j))
    assert tmerge.hour_day_matrix(df_t).equals(jmerge.hour_day_matrix(df_j))
    with pytest.raises(ValueError, match="no event CSVs"):
        quiet(tmerge.merge_event_csvs, ["/nonexistent.csv"])
