"""The segment monitor, its host I/O and the spectrogram PNG exports of the
PyTorch port against the JAX package, on the CPU.

* ``io/png.py`` and ``io/ledger.py`` are copies: the same arrays and the
  same add / flush / rotation / crash sequences give byte-identical files.
* ``apps.monitor.main --wav --start-time`` on a 5-minute 5 kHz WAV with
  bursts: byte-identical CSVs and journals, the same PNG names, and PNGs
  byte-identical or, where a display-dB value sits on a colour-level
  boundary, within ``png_close``'s rule (the frameworks' float32 FFTs round
  differently, and ``colorize`` truncates to uint8: one channel may move by
  1 on at most 0.1 % of pixels).
* the analyzer's ``--out-spec-dir`` and the live CLI's ``--spec-export-dir``
  give the JAX CLIs' PNG names with pixels under the same rule.
"""

import contextlib
import datetime
import io
import os
import sys

import numpy as np
import pytest
import torch

from meteor_scatter_tpu.apps import analyze as janalyze
from meteor_scatter_tpu.apps import live as jlive
from meteor_scatter_tpu.apps import monitor as jmon
from meteor_scatter_tpu.io import ledger as jledger
from meteor_scatter_tpu.io import png as jpng
from meteor_scatter_tpu.io import spec_export as jexport
from meteor_scatter_tpu_torch.apps import analyze as tanalyze
from meteor_scatter_tpu_torch.apps import live as tlive
from meteor_scatter_tpu_torch.apps import monitor as tmon
from meteor_scatter_tpu_torch.config import MonitorConfig
from meteor_scatter_tpu_torch.io import ledger as tledger
from meteor_scatter_tpu_torch.io import png as tpng
from meteor_scatter_tpu_torch.io import spec_export as texport
from meteor_scatter_tpu_torch.io.events_csv import OutputDetection
from meteor_scatter_tpu_torch.io.wavio import write_wav

FS = 5000
SEG = 30
T0 = datetime.datetime(2026, 8, 17, 9, 0, 0)
PNG_MAX_SHARE = 1e-3  # of pixels that may differ, each by 1 in one channel


def png_close(path_a, path_b):
    """Equal bytes, or decoded pixels that differ by at most 1 in one
    channel on at most ``PNG_MAX_SHARE`` of the pixels."""
    with open(path_a, "rb") as fa, open(path_b, "rb") as fb:
        if fa.read() == fb.read():
            return True
    a = tpng.read_png(path_a).astype(int)
    b = tpng.read_png(path_b).astype(int)
    if a.shape != b.shape:
        return False
    d = np.abs(a - b)
    differ = d.max(-1) > 0
    return d.max() <= 1 and ((d > 0).sum(-1) <= 1).all() and differ.mean() <= PNG_MAX_SHARE


def dir_files(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def assert_same_bytes(dir_a, dir_b):
    assert dir_files(dir_a) == dir_files(dir_b)
    for name in dir_files(dir_a):
        with open(os.path.join(dir_a, name), "rb") as fa, open(os.path.join(dir_b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def quiet(fn, *args, **kw):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = fn(*args, **kw)
    return rc, out.getvalue()


# --- png ---------------------------------------------------------------------


def test_png_copy_writes_the_same_bytes(tmp_path):
    rng = np.random.default_rng(0)
    v = rng.standard_normal((20, 30)) * 10.0
    v[3, 4] = np.nan
    for kw in (dict(), dict(vmin=-5.0, vmax=5.0), dict(cmap="gray"), dict(vmin=3.0, vmax=3.0)):
        np.testing.assert_array_equal(tpng.colorize(v, **kw), jpng.colorize(v, **kw))
    img = tpng.upscale_to(tpng.colorize(v))
    np.testing.assert_array_equal(img, jpng.upscale_to(jpng.colorize(v)))
    np.testing.assert_array_equal(tpng.render_text("avg 12.5 db ?"), jpng.render_text("avg 12.5 db ?"))
    a, b = img.copy(), img.copy()
    tpng.stamp_text(a, "x: 1-2", 600, 300, scale=3, color=(0, 255, 0))
    jpng.stamp_text(b, "x: 1-2", 600, 300, scale=3, color=(0, 255, 0))
    np.testing.assert_array_equal(a, b)
    tpng.write_png(str(tmp_path / "t.png"), a)
    jpng.write_png(str(tmp_path / "j.png"), a)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    np.testing.assert_array_equal(tpng.read_png(str(tmp_path / "j.png")), a)
    assert tpng.read_png_size(str(tmp_path / "t.png")) == (a.shape[1], a.shape[0])


# --- ledger ------------------------------------------------------------------

M = datetime.timedelta(minutes=1)
H = datetime.timedelta(hours=1)
# (new ledger at t) / (add crit, non, at t) / (append a torn-flush row):
# the sequences of tests/test_io_apps.py::TestLedger
LEDGER_SEQS = {
    "hourly_flush": (T0, [("add", 2, 3, T0 + 10 * M), ("add", 1, 0, T0 + 61 * M)]),
    "daily_rotation": (T0.replace(hour=23, minute=30),
                       [("add", 1, 1, T0.replace(hour=23, minute=30)),
                        ("add", 1, 0, T0.replace(hour=23, minute=30) + H)]),
    "crash_resume": (T0.replace(hour=12), [("add", 4, 2, T0.replace(hour=12) + 5 * M),
                                           ("new", T0.replace(hour=12) + 6 * M),
                                           ("add", 1, 1, T0.replace(hour=12) + 70 * M)]),
    "stale_journal": (T0.replace(hour=12), [("add", 4, 2, T0.replace(hour=12) + 5 * M),
                                            ("new", T0.replace(hour=14))]),
    "torn_flush": (T0.replace(hour=12), [("add", 4, 2, T0.replace(hour=12) + 5 * M),
                                         ("row", "2026-08-17 12:00:00;6;4\n"),
                                         ("new", T0.replace(hour=14))]),
    "stale_previous_day": (T0.replace(hour=22, minute=30),
                           [("add", 1, 1, T0.replace(hour=22, minute=35)),
                            ("new", T0.replace(hour=22, minute=30) + 4 * H)]),
    "stale_across_rotation": (T0.replace(hour=23, minute=40),
                              [("add", 3, 2, T0.replace(hour=23, minute=55)),
                               ("new", T0.replace(hour=23, minute=40) + 80 * M),
                               ("new", T0.replace(hour=23, minute=40) + 2 * H)]),
    "open_journal_across_midnight": (T0.replace(hour=23, minute=40),
                                     [("add", 3, 2, T0.replace(hour=23, minute=55)),
                                      ("new", T0.replace(hour=23, minute=40) + 25 * M),
                                      ("add", 1, 1, T0.replace(hour=23, minute=40) + 26 * M),
                                      ("add", 1, 0, T0.replace(hour=23, minute=40) + 61 * M)]),
}


def drive_ledger(mod, out_dir, start, ops):
    led = mod.HourlyLedger(out_dir, now=start)
    for op in ops:
        if op[0] == "add":
            led.add(op[1], op[2], now=op[3])
        elif op[0] == "new":
            led = mod.HourlyLedger(out_dir, now=op[1])
        else:
            with open(os.path.join(out_dir, "20260817.csv"), "a") as fh:
                fh.write(op[1])
    return led


@pytest.mark.parametrize("name", sorted(LEDGER_SEQS))
def test_ledger_copy_writes_the_same_bytes(tmp_path, name):
    start, ops = LEDGER_SEQS[name]
    lt = drive_ledger(tledger, str(tmp_path / "t"), start, ops)
    lj = drive_ledger(jledger, str(tmp_path / "j"), start, ops)
    assert_same_bytes(str(tmp_path / "t"), str(tmp_path / "j"))
    assert (lt.n_critical, lt.n_non_critical, lt.hour_start, lt.previous_date) == (
        lj.n_critical, lj.n_non_critical, lj.hour_start, lj.previous_date)


# --- monitor -----------------------------------------------------------------


def monitor_audio(n_seg, seed=2):
    """Noise std 900 (int16 scale) with a 1 s 1000 Hz burst in every segment
    but each fifth, at 5 + 3k mod 20 s, and a 0.3 s 1100 Hz one in each
    third."""
    rng = np.random.default_rng(seed)
    t = np.arange(FS * SEG * n_seg) / FS
    x = rng.standard_normal(t.size) * 0.3
    for k in range(n_seg):
        if k % 5 == 4:
            continue
        for s, dur, f, a in ((k * SEG + 5 + (3 * k) % 20, 1.0, 1000.0, 3.0),) + (
                ((k * SEG + 26, 0.3, 1100.0, 6.0),) if k % 3 == 0 else ()):
            m = (t >= s) & (t < s + dur)
            x[m] += a * np.sin(2 * np.pi * f * t[m])
    return (x * 3000).astype(np.int16)


@pytest.fixture(scope="module")
def mon_wav(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("mon") / "mon.wav")
    write_wav(p, FS, monitor_audio(10))
    return p


def run_both(wav, out, extra):
    dirs = {}
    for name, mod, dev in (("t", tmon, ["--device", "cpu"]), ("j", jmon, [])):
        csv, spec = str(out / name / "csv"), str(out / name / "spec")
        rc, _ = quiet(mod.main, ["--wav", wav, "--csv-out", csv, "--spec-out", spec, *extra, *dev])
        assert rc == 0
        dirs[name] = (csv, spec)
    return dirs


def test_monitor_main_matches_jax(mon_wav, tmp_path):
    """Six segments from 23:57 at 40 simulated seconds a second: a midnight
    rotation between two hourly flushes.  (Both keypoint modes are held
    against JAX at count level in tests/test_torch_image.py.)"""
    extra = ["--start-time", "2026-08-16T23:57:00", "--time-scale", "40", "--max-segments", "6"]
    dirs = run_both(mon_wav, tmp_path, extra)
    assert_same_bytes(dirs["t"][0], dirs["j"][0])
    assert {".offset.json", ".inprogress.json", "20260816.csv", "20260817.csv"} <= set(
        dir_files(dirs["t"][0]))
    names = dir_files(dirs["t"][1])
    assert names == dir_files(dirs["j"][1]) and len(names) >= 4
    for n in names:
        assert png_close(os.path.join(dirs["t"][1], n), os.path.join(dirs["j"][1], n)), n
    for day in ("20260816", "20260817"):
        with open(os.path.join(dirs["t"][0], day + ".csv")) as fh:
            rows = fh.read().splitlines()
        assert rows[0] == "Timestamp;Anzahl;Kritisch" and len(rows) == 2, rows


def test_monitor_resume_continues_from_the_journal(mon_wav, tmp_path):
    csv, spec = str(tmp_path / "csv"), str(tmp_path / "spec")
    base = ["--wav", mon_wav, "--csv-out", csv, "--spec-out", spec, "--device", "cpu",
            "--start-time", "2026-08-17T09:00:00"]
    assert quiet(tmon.main, base + ["--max-segments", "3"])[0] == 0
    journal = tmon.OffsetJournal(csv, os.path.abspath(mon_wav))
    assert journal.load() == 3 * FS * SEG
    _, out = quiet(tmon.main, base + ["--resume"])
    assert f"Resuming {mon_wav} at sample {3 * FS * SEG}" in out
    assert out.count("Critical bursts this segment") == 7
    assert journal.load() == 10 * FS * SEG
    assert tmon.OffsetJournal(csv, "/elsewhere.wav").load() == 0
    # one uninterrupted run writes the same ledger and PNG names
    ref = tmp_path / "ref"
    quiet(tmon.main, ["--wav", mon_wav, "--csv-out", str(ref / "csv"), "--spec-out",
                      str(ref / "spec"), "--device", "cpu", "--start-time", "2026-08-17T09:00:00"])
    assert_same_bytes(csv, str(ref / "csv"))
    assert dir_files(spec) == dir_files(str(ref / "spec"))


def test_float_wav_matches_int16_scale(tmp_path):
    xi = (np.random.default_rng(5).standard_normal(FS * SEG) * 3000).astype(np.int16)
    write_wav(str(tmp_path / "i.wav"), FS, xi)
    write_wav(str(tmp_path / "f.wav"), FS, xi.astype(np.float32) / 32768.0)
    cfg = MonitorConfig()
    gi = tmon.WavSegmentSource(str(tmp_path / "i.wav"), cfg).grab()
    gf = tmon.WavSegmentSource(str(tmp_path / "f.wav"), cfg).grab()
    np.testing.assert_array_equal(gf, np.asarray(xi, np.float32))
    assert gi.dtype == np.int16 and gf.dtype == np.float32
    with pytest.raises(ValueError, match="expected 4000 Hz, got 5000"):
        tmon.WavSegmentSource(str(tmp_path / "i.wav"), MonitorConfig(sample_rate=4000))


def test_short_segment_triggers_rebuild(tmp_path):
    cfg = MonitorConfig(csv_out_dir=str(tmp_path / "csv"), spec_out_dir=str(tmp_path / "spec"))
    expected = cfg.sample_rate * cfg.segment_len_sec
    rng = np.random.default_rng(0)

    class FlakySource:
        calls = rebuilds = 0

        def grab(self):
            self.calls += 1
            if self.calls == 1:
                return np.zeros(100, np.int16)  # short: must rebuild
            if self.calls <= 3:
                return (rng.standard_normal(expected) * 100).astype(np.int16)
            return None

        def rebuild(self):
            self.rebuilds += 1

    src = FlakySource()
    quiet(tmon.run_monitor, src, cfg, now_fn=lambda: T0, device="cpu")
    assert (src.rebuilds, src.calls) == (1, 4)  # short, 2 good, exhausted


def test_grab_exception_backoff(tmp_path, monkeypatch):
    sleeps = []
    monkeypatch.setattr(tmon.time, "sleep", sleeps.append)
    cfg = MonitorConfig(csv_out_dir=str(tmp_path / "csv"), spec_out_dir=str(tmp_path / "spec"))

    class ErrorThenDone:
        calls = 0

        def grab(self):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("stream hiccup")
            return None

    src = ErrorThenDone()
    _, out = quiet(tmon.run_monitor, src, cfg, device="cpu")
    assert src.calls == 2 and sleeps == [5] and "Audio grab error: stream hiccup" in out


def test_command_source_reads_pcm_segments(tmp_path, monkeypatch):
    """Two segments of s16le from a child process, then a short read: the
    source rebuilds (sleep monkeypatched) and the run stops at the cap."""
    x = monitor_audio(2, seed=9)
    raw = tmp_path / "pcm.raw"
    raw.write_bytes(x.tobytes())
    monkeypatch.setattr(tmon.time, "sleep", lambda s: None)
    cfg = MonitorConfig(csv_out_dir=str(tmp_path / "csv"), spec_out_dir=str(tmp_path / "spec"))
    cmd = f"{sys.executable} -c \"import sys; sys.stdout.buffer.write(open(r'{raw}', 'rb').read())\""
    src = tmon.CommandSegmentSource(cmd, cfg)
    try:
        first = src.grab()
        np.testing.assert_array_equal(first, x[: FS * SEG])
        _, out = quiet(tmon.run_monitor, src, cfg, max_segments=1, now_fn=lambda: T0,
                       device="cpu")
        assert "Critical bursts this segment: " in out and len(dir_files(cfg.spec_out_dir)) == 1
        assert src.grab().size == 0  # the stream ended
        src.rebuild()
        np.testing.assert_array_equal(src.grab(), x[: FS * SEG])
    finally:
        src.terminate()
    assert src.proc.poll() is not None


def test_unported_and_missing_gpu_raise(mon_wav, tmp_path, monkeypatch):
    # --pump is ported (tests/test_torch_host_apps.py); as in the JAX CLI it
    # excludes --resume
    with pytest.raises(SystemExit):
        quiet(tmon.main, ["--wav", mon_wav, "--pump", "--resume", "--device", "cpu",
                          "--csv-out", str(tmp_path / "p")])
    with pytest.raises(SystemExit):  # argparse: --start-time needs a WAV replay
        quiet(tmon.main, ["--command", "true", "--start-time", "2026-08-17T00:00:00",
                          "--device", "cpu", "--csv-out", str(tmp_path / "c")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        quiet(tmon.main, ["--wav", mon_wav, "--csv-out", str(tmp_path / "csv"),
                          "--spec-out", str(tmp_path / "spec")])


# --- spectrogram exports -------------------------------------------------------


def test_render_psd_panel_and_waterfall_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    f = np.linspace(900.0, 1100.0, 140)
    p = rng.standard_normal(140) * 3.0 - 40.0
    p[7] = -np.inf
    for band in (None, (993.0, 1013.0)):
        np.testing.assert_array_equal(texport.render_psd_panel(f, p, 320, 280, band),
                                      jexport.render_psd_panel(f, p, 320, 280, band))
    np.testing.assert_array_equal(texport.render_psd_panel(f[:1], p[:1], 50, 120),
                                  jexport.render_psd_panel(f[:1], p[:1], 50, 120))
    wf = rng.standard_normal((300, 2049)).astype(np.float32) - 60.0
    freqs = np.fft.rfftfreq(4096, 1.0 / 4000)
    times = list(np.arange(1, 301) * 0.2)
    args = (wf, freqs, times, 20.0, 21.0, 1000.0)
    kw = dict(vmin=-80.0, vmax=-40.0)
    pt = texport.export_waterfall_window(str(tmp_path / "t"), *args, **kw)
    pj = jexport.export_waterfall_window(str(tmp_path / "j"), *args, **kw)
    assert os.path.basename(pt) == os.path.basename(pj) == "spec_20.00_21.00.png"
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    assert texport.export_waterfall_window(str(tmp_path / "t"), wf, freqs, times, 58.0, 59.0,
                                           1000.0) is None


@pytest.mark.parametrize("band", [None, (993.0, 1013.0)])
def test_export_detection_spec_matches_jax(tmp_path, band):
    fs = 6000
    rng = np.random.default_rng(5)
    x = rng.standard_normal(fs * 16).astype(np.float32) * 0.3
    t = np.arange(x.size) / fs
    m = (t >= 5.0) & (t < 6.0)
    x[m] += 2.0 * np.sin(2 * np.pi * 1003.0 * t[m]).astype(np.float32)
    for det in (OutputDetection(t_start=5.0, t_stop=6.0, dur_s=1.0, dB=10.0),
                OutputDetection(t_start=4.0, t_stop=9.4, dur_s=5.4, dB=3.0)):
        pt = texport.export_detection_spec(str(tmp_path / "t"), det, x, fs, freq_band=band,
                                           device="cpu")
        pj = jexport.export_detection_spec(str(tmp_path / "j"), det, x, fs, freq_band=band)
        assert os.path.basename(pt) == os.path.basename(pj)
        assert png_close(pt, pj)


def detection_wav(path, fs, seconds, tone_hz, starts, amp, noise, scale):
    rng = np.random.default_rng(7)
    t = np.arange(fs * seconds) / fs
    x = rng.standard_normal(t.size) * noise
    for s in starts:
        m = (t >= s) & (t < s + 1.0)
        x[m] += amp * np.sin(2 * np.pi * tone_hz * t[m])
    write_wav(path, fs, np.round(x * scale).astype(np.int16))
    return path


def test_analyze_out_spec_dir_matches_jax(tmp_path):
    wav = detection_wav(str(tmp_path / "a.wav"), 6000, 120, 1003.0, (30.0, 77.0, 117.5),
                        2.0, 0.5, 3000)
    quiet(tanalyze.main, [wav, "--out-spec-dir", str(tmp_path / "t"), "--device", "cpu"])
    quiet(janalyze.main, [wav, "--out-spec-dir", str(tmp_path / "j")])
    names = dir_files(str(tmp_path / "t"))
    assert names == dir_files(str(tmp_path / "j")) and len(names) == 3
    assert sorted(float(n.split("_")[3]) for n in names)[0] == pytest.approx(30.0, abs=0.4)
    for n in names:
        assert png_close(str(tmp_path / "t" / n), str(tmp_path / "j" / n)), n


def test_live_spec_export_dir_matches_jax(tmp_path):
    """Events whose ±3 s window closed before the end are exported; the
    last, at 117 s of 120, is not (its window runs past the audio)."""
    wav = detection_wav(str(tmp_path / "l.wav"), 4000, 120, 1000.0, (30.0, 77.0, 117.0),
                        0.6, 0.05, 32768)
    args = ["--min-dur", "0.5", "--min-mean-db", "1"]
    _, out_t = quiet(tlive.main, [wav, "--spec-export-dir", str(tmp_path / "t"), "--device",
                                  "cpu", *args])
    _, out_j = quiet(jlive.main, [wav, "--spec-export-dir", str(tmp_path / "j"), *args])
    assert "Total detected meteors: 3" in out_t and "Total detected meteors: 3" in out_j
    names = dir_files(str(tmp_path / "t"))
    assert names == dir_files(str(tmp_path / "j")) and len(names) == 2
    for n in names:
        assert png_close(str(tmp_path / "t" / n), str(tmp_path / "j" / n)), n
