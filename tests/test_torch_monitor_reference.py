"""The segment monitor of the PyTorch port against the benchmark's plain
float64 reference (``bench_h100/reference/image.py``), on the CPU, without
JAX, at the published widths: 30 s segments at 5 kHz, n_fft 2 048, a 164 x
145 display image, eps 30 px, ``min_samples`` 5.

Tolerances, each with its reason:

* ``DB_TOL``: the display-band dB image.  The port's float32 FFT errs by
  ~1e-7 of a frame's energy on every bin, which in dB grows as a pixel's
  power falls: the weakest pixels of a noise image (~1e-6 of the mean)
  read ~6e-4 dB here.  With its windowed frames in TF32 the reference reads
  past 0.1 dB there.
* ``VMIN_TOL``: the display cut, a float32 sum over ~33 000 PSD values of
  the noise band: ~2e-6 dB here.
* Clusters (the whole box, the member count, the critical flag) are equal:
  no pixel of these segments lies within ``TIE_DB`` of its cut, where a
  pixel's power is high and the port errs by ~1e-6 dB.

The replay runs ``SegmentMonitor.step`` over 10 minutes from 00:55, resuming
an hour the ledger's journal left open at 00:00: the hourly row written at
01:00 holds the journal's counts and the reference's counts of the
segments up to it, the offset journal holds each segment's position
before its counts reach the ledger, and the ledger's journal ends as the
reference's.  The step's PNG copies render the reference's image within
``DB_TOL`` and ``VMIN_TOL``, and the same image upside down does not.
Under a CPU profiler the step's spans nest as named.
"""

import json
import os
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_h100.reference import image as ref
from meteor_scatter_tpu_torch.apps import monitor
from meteor_scatter_tpu_torch.config import MonitorConfig
from meteor_scatter_tpu_torch.io import ledger as ledger_mod
from meteor_scatter_tpu_torch.models import image

FS, SEG_SEC, N_FFT = 5000, 30, 2048
SEG = FS * SEG_SEC
DB_TOL = 1e-2
VMIN_TOL = 1e-5
TIE_DB = 1e-3  # the benchmark's tie band: near the cut the port errs by ~1e-6 dB
NOISE_RMS, TONE_HZ = 300.0, 1000.0


def segment(seed: int, echoes) -> np.ndarray:
    """int16 noise of ``NOISE_RMS`` with decaying tone echoes, each
    (start s, duration s, peak, Doppler Hz)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SEG) * NOISE_RMS
    t = np.arange(SEG) / FS
    for t0, dur, peak, dop in echoes:
        m = (t >= t0) & (t < t0 + dur)
        tt = t[m] - t0
        env = np.minimum(tt / 0.02, 1.0) * np.exp(-3.0 * tt / dur)
        x[m] += peak * env * np.sin(2 * np.pi * (TONE_HZ + dop) * tt)
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


SEGMENTS = [
    (1, [(4.0, 1.0, 3000.0, 0.0)]),
    (2, [(3.0, 4.0, 1500.0, 2.5), (20.0, 0.15, 900.0, -3.0)]),
    (3, [(10.0, 8.0, 400.0, 1.0), (25.0, 0.5, 250.0, -1.5)]),
    (4, []),
]


def reference(x: np.ndarray, precision: str = "float64"):
    """(dB images, vmins, clusters a segment) of the reference."""
    db, vmin = ref.image(torch.from_numpy(np.atleast_2d(x)), FS, N_FFT, 8.0, (250.0, 800.0),
                         (800.0, 1200.0), precision)
    px_f, px_t = ref.pixel_scale(FS, N_FFT)
    offsets = ref.neighbour_offsets(30.0, px_f, px_t)
    found = [ref.clusters(d > v, offsets, 5, px_t, 5.0) for d, v in zip(db, vmin)]
    return db, vmin, found


def port_clusters(b) -> list:
    c = int(b.count)
    fields = [f.tolist() for f in (b.t_min, b.t_max, b.f_min, b.f_max, b.n_points, b.critical)]
    return sorted(ref.Cluster(*(int(fields[j][i]) for j in range(5)), bool(fields[5][i]))
                  for i in range(c))


@pytest.fixture(scope="module")
def four():
    x = np.stack([segment(s, e) for s, e in SEGMENTS])
    imgs = [image.detect_and_cluster_bursts(torch.from_numpy(s.astype(np.float32)), FS)
            for s in x]
    return x, imgs, reference(x)


def test_detector_matches_the_float64_reference(four):
    x, imgs, (db, vmin, found) = four
    assert sum(map(len, found)) >= 3 and any(c.critical for f in found for c in f)
    for (img, b), d, v, f in zip(imgs, db, vmin, found):
        assert img.db.shape == (164, 145)
        assert np.abs(img.db.numpy().astype(np.float64) - d).max() <= DB_TOL
        assert abs(float(img.vmin) - v) <= VMIN_TOL
        assert not (np.abs(d - v) < TIE_DB).any()  # no pixel on the cut: clusters are exact
        assert port_clusters(b) == sorted(f)
        assert not bool(b.overflow)


def test_tf32_control_fails_a_tolerance(four):
    x, _, (db, vmin, _) = four
    cdb, cvmin, _ = reference(x, "tf32")
    assert np.abs(cdb - db).max() > 3 * DB_TOL


def test_reference_offsets_are_the_ports_neighbourhood():
    """The reference lists its neighbour offsets from the L2 rule; the
    port's stencil comes from row spans.  They are one set, and no grid
    offset lies within 0.05 px of eps (the nearest, 0.08 px), so rounding
    never decides the rule's edge."""
    px_f, px_t = ref.pixel_scale(FS, N_FFT)
    off = ref.neighbour_offsets(30.0, px_f, px_t)
    k = image._ellipse_kernel(30.0, px_f, px_t)
    ry, rx = k.shape[0] // 2, k.shape[1] // 2
    assert {(int(a) - ry, int(b) - rx) for a, b in zip(*np.nonzero(k))} == set(map(tuple, off))
    r = np.hypot(off[:, 0] * px_f, off[:, 1] * px_t)
    rf, rt = int(30.0 // px_f) + 2, int(30.0 // px_t) + 2
    grid = np.hypot(*np.meshgrid(np.arange(rf) * px_f, np.arange(rt) * px_t))
    assert np.abs(grid - 30.0).min() > 0.05 and r.max() <= 30.0


def test_ten_minute_replay_rows_and_journal_order(tmp_path, monkeypatch):
    """20 segments from 00:55, resuming the hour a journal left open at
    00:00 with 3 critical and 2 other clusters: the row written at 01:00
    holds those and the reference's counts of the 10 segments to it; the
    offset journal leads every ledger add."""
    rng = np.random.default_rng(9)
    day = np.concatenate([segment(100 + k, [(rng.uniform(2, 20), rng.uniform(0.2, 6.0),
                                              rng.uniform(500, 3000), 0.0)] if k % 3 else [])
                          for k in range(20)])
    wav = str(tmp_path / "day.wav")
    from meteor_scatter_tpu_torch.io.wavio import write_wav

    write_wav(wav, FS, day)
    cfg = MonitorConfig(csv_out_dir=str(tmp_path / "csv"), spec_out_dir=str(tmp_path / "png"))
    os.makedirs(cfg.csv_out_dir)
    t0 = datetime(2026, 10, 1, 0, 55)
    hour = datetime(2026, 10, 1)
    with open(os.path.join(cfg.csv_out_dir, ".inprogress.json"), "w") as fh:
        json.dump({"hour_start": hour.isoformat(), "critical": 3, "non_critical": 2,
                   "date": "2026-10-01"}, fh)
    src = monitor.WavSegmentSource(wav, cfg)
    mon = monitor.SegmentMonitor(cfg, now_fn=lambda: t0 + timedelta(seconds=src.pos / FS),
                                 device="cpu", source_id=src.source_id)
    journal = monitor.OffsetJournal(cfg.csv_out_dir, src.source_id)
    seen = []
    add = ledger_mod.HourlyLedger.add
    monkeypatch.setattr(ledger_mod.HourlyLedger, "add",
                        lambda self, *a, **k: (seen.append(journal.load()), add(self, *a, **k)))
    counts = []
    while (seg := src.grab()) is not None:
        _, b = mon.step(seg, src.pos)
        counts.append((int(b.n_critical), int(b.n_non_critical)))
    assert seen == [SEG * (k + 1) for k in range(20)]

    _, _, found = reference(day.reshape(20, SEG))
    want = [(sum(c.critical for c in f), sum(not c.critical for c in f)) for f in found]
    assert counts == want
    clocks = [t0 + timedelta(seconds=SEG_SEC * (k + 1)) for k in range(20)]
    rows, state = ref.ledger([(3, 2)] + want, [t0] + clocks, hour, cfg.save_interval_min)
    with open(os.path.join(cfg.csv_out_dir, "20261001.csv")) as fh:
        got = [tuple(line.strip().split(";")) for line in fh.readlines()[1:]]
    assert got == [(ts, str(a), str(k)) for ts, a, k in rows]
    assert len(got) == 1 and got[0][0] == "2026-10-01 00:00:00"
    with open(os.path.join(cfg.csv_out_dir, ".inprogress.json")) as fh:
        assert json.load(fh) == state
    assert mon.pngs_written == sum(1 for c in counts if sum(c)) == len(os.listdir(cfg.spec_out_dir))


def test_png_copies_render_the_reference_image(tmp_path, four):
    x, _, (db, vmin, found) = four
    cfg = MonitorConfig(csv_out_dir=str(tmp_path / "csv"), spec_out_dir=str(tmp_path / "png"))
    clock = [datetime(2026, 10, 1)]
    mon = monitor.SegmentMonitor(cfg, now_fn=lambda: clock[0], device="cpu", source_id=None)
    for k, seg in enumerate(x):
        clock[0] = datetime(2026, 10, 1) + timedelta(seconds=SEG_SEC * (k + 1))
        mon.step(seg)
    want = [(k, f"{datetime(2026, 10, 1) + timedelta(seconds=SEG_SEC * (k + 1)):%Y%m%d-%H%M%S}"
                f"-{sum(c.critical for c in f)}-{sum(not c.critical for c in f)}.png")
            for k, f in enumerate(found) if f]
    assert sorted(os.listdir(cfg.spec_out_dir)) == [name for _, name in want] and len(want) == 3
    for k, name in want:
        d, v = db[k], float(vmin[k])
        png = ref.read_png(os.path.join(cfg.spec_out_dir, name)).astype(np.int64)
        lo, hi = ref.png_bounds(d, v, DB_TOL, VMIN_TOL)
        assert png.shape == lo.shape == (328, 725, 3)
        assert ((lo <= png) & (png <= hi)).all()
        assert not ((lo <= png[::-1]) & (png[::-1] <= hi)).all()


# (span, the spans it may lie in)
STEP_SPANS = [("upload", "segment"), ("wait.segment_upload", "upload"), ("detect", "segment"),
              ("spectrogram", "detect"), ("wait.constant_upload", "spectrogram core_count"),
              ("keypoints", "detect"), ("core_count", "detect"), ("core_labels", "detect"),
              ("wait.label_round", "core_labels"), ("border", "detect"), ("boxes", "detect"),
              ("counts_to_host", "segment"), ("wait.counts", "counts_to_host"),
              ("write_png", "segment"), ("wait.image", "write_png"), ("encode", "write_png"),
              ("ledger", "segment"), ("offsets", "ledger"), ("journal", "ledger"),
              ("flush", "ledger")]


def test_step_spans_nest_as_named(tmp_path):
    """One step at a flush under a CPU profiler: each span inside its
    parent; without a profiler the step opens none."""
    cfg = MonitorConfig(csv_out_dir=str(tmp_path / "csv"), spec_out_dir=str(tmp_path / "png"))
    clock = [datetime(2026, 10, 1)]
    mon = monitor.SegmentMonitor(cfg, now_fn=lambda: clock[0], device="cpu", source_id="x")
    clock[0] += timedelta(hours=1)  # the first add flushes the hour
    seg = segment(1, SEGMENTS[0][1])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mon.step(seg, SEG)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        ranges = [e for e in json.load(fh)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    by = {}
    for e in ranges:
        by.setdefault(e["name"], []).append(e)
    assert len(by["ms.segment"]) == 1 and len(by["ms.wait.counts"]) == 1
    for child, parents in STEP_SPANS:
        outer = [p for name in parents.split() for p in by["ms." + name]]
        for e in by["ms." + child]:
            assert any(p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
                       for p in outer), (child, parents)
    assert len(by["ms.wait.constant_upload"]) == 5  # window, scale, two band indices, stencil
    assert mon.pngs_written == 1
