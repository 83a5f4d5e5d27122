"""Closed loop of one client over one station's day of audio through the
segment monitor: each call grabs the next 30 s segment from the monitor's
own WAV source and runs it through ``apps/monitor.py::SegmentMonitor.step``
(the upload, the spectrogram image and its clusters on the device, the
counts to the host, a PNG copy of a segment with detections, the offset
journal, the hourly ledger), as the CLI's loop does; its prints go to the
null device.

The day (the configuration's ``stream_hours``) is made from the seed in
set-up and written as one int16 WAV; it is cycled, the audio clock
(``clock_start`` plus 30 s a segment) running on, so the ledger flushes an
hourly row and rotates its daily file as a deployment's does.  On a card the
ledger, the journals and the PNGs go to a directory of their own on the
tmpfs ``/dev/shm``, removed when the process ends; elsewhere (the CPU tests)
to the run's work directory, emptied of any earlier run's first.  The
monitor never fsyncs, so on a deployment's local disk its writes land in the
page cache, as they do on a tmpfs; where the work directory lies on a
user-space or network file system instead, every small file's creation and
rename is a round trip whose time follows the host's load (three of them a
segment with a PNG), which spreads the runs.

Traffic keys: ``warmup_calls``; ``sample_images``, how many calls keep
their dB image for the comparison (the first eight and the rest drawn from
the seed among the first day's calls).

Answers are kept in host buffers made in set-up (pinned on a card), each
call's by one copy that does not wait, so that the check grows nothing on
the device.  The comparison, after the window, for each distinct segment
once (calls of the same segment and the same answer bytes judged together):

* ``threshold_db_gap``: every call's display cut ``vmin``;
* ``front_db_gap``: the sampled calls' display-band dB images;
* ``event_mismatches``: every call's clusters (the whole box, the member
  count and the critical flag) and its counts against the reference's,
  except where a pixel within ``tie_db`` of the cut changes the reference's
  clusters when it flips (counted in ``ties_excused``); and, never
  excused, each of the monitor's files that departs from what the program's
  own per-call counts make (:func:`reference.image.ledger`): every hourly
  row read back from the CSVs, the ledger's journal of the hour in progress
  and the offset journal after the last call, the name of every PNG copy
  (the audio clock's time, the two counts), and each sampled call's PNG
  whose pixels lie outside what an image within the ``front_db_gap`` and
  ``threshold_db_gap`` limits of the reference's renders to
  (:func:`reference.image.png_bounds`);
* ``event_db_gap``: each matched cluster's peak dB over its box, on the
  sampled calls.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import shutil
import tempfile
import time
import zlib
from datetime import datetime, timedelta

import numpy as np
import torch

from bench_h100 import signals
from bench_h100.check import Comparison
from bench_h100.drivers.wav_files import write_wav_int16
from bench_h100.reference import image as ref_image

REQUEST = "bench.segment"
CAP = 64  # the port's clusters a segment
ROW = 6 * CAP + 5  # t_min, t_max, f_min, f_max, n_points, critical; count, counts, overflow, vmin
BLOCK = 4096  # answer rows a host buffer


class Driver:
    def __init__(self, cell):
        self.cell = cell
        cfg = cell.config
        self.fs = int(cfg["sample_rate"])
        self.seg_sec = int(cfg["segment_len_sec"])
        self.seg = self.fs * self.seg_sec
        self.n_segs = int(round(float(cfg["stream_hours"]) * 3600 / self.seg_sec))
        self.start = datetime.fromisoformat(cfg["clock_start"])
        self.calls = 0
        self.pinned = torch.device(cell.device).type == "cuda"

    def now(self) -> datetime:
        """The audio clock: the start plus the audio handed out so far."""
        return self.start + timedelta(seconds=self.seg_sec * self.calls)

    def _monitor_config(self):
        from meteor_scatter_tpu_torch.config import MonitorConfig

        c, d = self.cell.config, self.out
        return MonitorConfig(
            sample_rate=self.fs, segment_len_sec=self.seg_sec, n_fft=int(c["n_fft"]),
            spec_cut_factor=float(c["spec_cut_factor"]),
            cluster_epsilon=float(c["cluster_epsilon"]),
            cluster_min_samples=int(c["cluster_min_samples"]),
            critical_min_width_px=float(c["critical_min_width_px"]),
            keypoint_mode=c["keypoint_mode"], noise_floor_band=tuple(c["noise_floor_band"]),
            display_band=tuple(c["display_band"]), csv_out_dir=os.path.join(d, "csv"),
            spec_out_dir=os.path.join(d, "png"), save_interval_min=float(c["save_interval_min"]))

    def setup(self) -> None:
        from meteor_scatter_tpu_torch.apps import monitor

        if not hasattr(monitor, "SegmentMonitor"):
            raise SystemExit("monitor_segments needs apps/monitor.py's SegmentMonitor, the "
                             "monitor loop's body as one step; this program has none")
        cell = self.cell
        x = signals.echo_audio(cell.seed, 1, 1, self.n_segs * self.seg, self.fs,
                               cell.config["signal"], cell.device)
        self.audio = signals.to_int16(x)[0].cpu().numpy()
        del x
        wav = os.path.join(cell.workdir, "day.wav")
        write_wav_int16(wav, self.fs, self.audio)
        self.out = cell.workdir
        if self.pinned and os.path.isdir("/dev/shm"):  # on a card: the outputs on a tmpfs
            self.out = tempfile.mkdtemp(prefix=cell.name + ".", dir="/dev/shm")
            atexit.register(shutil.rmtree, self.out, True)
        self.mcfg = self._monitor_config()
        for d in (self.mcfg.csv_out_dir, self.mcfg.spec_out_dir):  # no ledger to resume
            shutil.rmtree(d, ignore_errors=True)
        self.source = monitor.WavSegmentSource(wav, self.mcfg)
        self.source_id, self.pos = self.source.source_id, 0
        self.monitor = monitor.SegmentMonitor(self.mcfg, now_fn=self.now, device=cell.device,
                                              source_id=self.source.source_id)
        self.quiet = open(os.devnull, "w")  # the step's prints: a deployment logs them
        self.rows = [self._block()]
        self.seg_of = [np.zeros(BLOCK, dtype=np.int64)]
        warm = int(cell.traffic["warmup_calls"])
        rng = np.random.default_rng([int(cell.seed) % (2 ** 64), 53])
        n_img = int(cell.traffic["sample_images"])
        pool = np.arange(warm + 8, warm + max(8, self.n_segs))
        drawn = rng.choice(pool, size=min(len(pool), max(0, n_img - 8)), replace=False)
        self.sampled = {k: i for i, k in enumerate(sorted({*range(warm, warm + 8), *drawn}))}
        bins = len(ref_image.band_bins(self.fs, int(cell.config["n_fft"]),
                                       cell.config["display_band"]))
        frames = (self.seg - int(cell.config["n_fft"])) // (int(cell.config["n_fft"]) // 2) + 1
        self.images = torch.empty((len(self.sampled), bins, frames), dtype=torch.float32,
                                  pin_memory=self.pinned)
        for _ in range(warm):
            self._keep(*self._call())

    def _block(self) -> torch.Tensor:
        return torch.empty((BLOCK, ROW), dtype=torch.int32, pin_memory=self.pinned)

    def _call(self):
        seg = self.source.grab()
        if seg is None:  # the day cycled; the clock runs on
            self.source.pos = 0
            seg = self.source.grab()
        k = self.calls
        self.calls += 1
        self.pos = self.source.pos
        with contextlib.redirect_stdout(self.quiet):
            img, b = self.monitor.step(seg, self.pos)
        return k, img, b

    def _keep(self, k: int, img, b) -> None:
        """Call ``k``'s answers into the host buffers, by copies that do
        not wait."""
        if k // BLOCK == len(self.rows):
            self.rows.append(self._block())
            self.seg_of.append(np.zeros(BLOCK, dtype=np.int64))
        self.seg_of[k // BLOCK][k % BLOCK] = self.pos // self.seg - 1
        row = torch.cat([torch.stack([b.t_min, b.t_max, b.f_min, b.f_max, b.n_points,
                                      b.critical.to(torch.int32)]).reshape(-1),
                         torch.stack([b.count, b.n_critical, b.n_non_critical,
                                      b.overflow.to(torch.int32), img.vmin.view(torch.int32)])])
        self.rows[k // BLOCK][k % BLOCK].copy_(row, non_blocking=True)
        if k in self.sampled:
            self.images[self.sampled[k]].copy_(img.db, non_blocking=True)

    def window(self, seconds: float, tracer) -> list:
        records = []
        t_end = time.perf_counter() + seconds
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                break
            with tracer.span(REQUEST):
                answer = self._call()
            self._keep(*answer)
            records.append({"start": t0, "end": time.perf_counter(), "samples": self.seg})
            tracer.tick()
        return records

    def free(self) -> None:
        self.monitor = self.source = None
        self.quiet.close()

    # -- the comparison ---------------------------------------------------

    def _answers(self):
        n = self.calls
        rows = torch.cat(self.rows).numpy()[:n]
        segs = np.concatenate(self.seg_of)[:n]
        return n, rows, segs

    def _reference(self, segs, precision: str):
        """For each segment in ``segs``: (dB image, vmin, clusters, tied)."""
        c = self.cell.config
        px_f, px_t = ref_image.pixel_scale(self.fs, int(c["n_fft"]))
        offsets = ref_image.neighbour_offsets(float(c["cluster_epsilon"]), px_f, px_t)
        args = (offsets, int(c["cluster_min_samples"]), px_t, float(c["critical_min_width_px"]))
        out = {}
        segs = sorted(segs)
        for i in range(0, len(segs), 256):
            part = segs[i: i + 256]
            x = torch.from_numpy(np.stack([self.audio[s * self.seg:(s + 1) * self.seg]
                                           for s in part])).to(self.cell.device)
            db, vmin = ref_image.image(x, self.fs, int(c["n_fft"]), float(c["spec_cut_factor"]),
                                       c["noise_floor_band"], c["display_band"], precision)
            for j, s in enumerate(part):
                found = ref_image.clusters(db[j] > vmin[j], *args)
                out[s] = (db[j], float(vmin[j]), found,
                          ref_image.tied(db[j], vmin[j], float(c["tie_db"]), found, *args))
        return out

    @staticmethod
    def _keyed(clusters, db=None):
        """Clusters as ``check.Comparison`` events: the box and the member
        count with the critical flag as the two keys, the peak dB over the
        box (where the image is compared) after them."""
        out = []
        for t0, t1, f0, f1, n, crit in clusters:
            peak = () if db is None else (float(db[f0:f1 + 1, t0:t1 + 1].max()),)
            out.append((((t0 * 256 + t1) * 256 + f0) * 256 + f1, 2 * n + int(crit), *peak))
        return out

    def _clock(self, k: int) -> datetime:
        """The audio clock during call ``k``."""
        return self.start + timedelta(seconds=self.seg_sec * (k + 1))

    def _files(self, rows, ref, segs) -> tuple:
        """(what the monitor's files hold, what the program's own per-call
        counts make), as events that match where they are equal: each
        hourly row, the two journals, each PNG's name, and a sampled PNG
        whose pixels depart from the reference's image."""
        d, n = self.mcfg.csv_out_dir, len(rows)
        got = []
        for name in sorted(os.listdir(d)):
            if name.endswith(".csv"):
                with open(os.path.join(d, name)) as fh:
                    got += [("row", *line.rstrip("\n").split(";")) for line in fh.readlines()[1:]]
        counts = rows[:, 6 * CAP + 1: 6 * CAP + 3]
        want, journal = ref_image.ledger(counts, [self._clock(k) for k in range(n)], self.start,
                                         self.mcfg.save_interval_min)
        want = [("row", ts, str(a), str(c)) for ts, a, c in want]
        for name, keys, value in ((".inprogress.json", tuple(journal), tuple(journal.values())),
                                  (".offset.json", ("source", "pos"), (self.source_id, self.pos))):
            try:
                with open(os.path.join(d, name)) as fh:
                    j = json.load(fh)
                got.append((name, *(j.get(key) for key in keys)))
            except (OSError, ValueError, AttributeError) as e:
                got.append((name, repr(e)))
            want.append((name, *value))
        pngs = self.mcfg.spec_out_dir
        got += [("png", name) for name in os.listdir(pngs)]
        names = {k: f"{self._clock(k):%Y%m%d-%H%M%S}-{c}-{m}.png"
                 for k, (c, m) in enumerate(counts) if c + m}
        want += [("png", name) for name in names.values()]
        lim = self.cell.limits
        for k in sorted(set(names) & set(self.sampled)):
            path = os.path.join(pngs, names[k])
            if not os.path.exists(path):
                continue  # its name is a mismatch already
            rdb, rvmin = ref[int(segs[k])][:2]
            lo, hi = ref_image.png_bounds(rdb, rvmin, lim["front_db_gap"], lim["threshold_db_gap"])
            try:
                png = ref_image.read_png(path).astype(np.int64)
                ok = png.shape == lo.shape and bool(((lo <= png) & (png <= hi)).all())
            except (ValueError, zlib.error):
                ok = False
            if not ok:
                got.append(("pixels", names[k]))
        ids = {e: i for i, e in enumerate(sorted(set(got) | set(want), key=repr))}
        return [(ids[e], 0) for e in got], [(ids[e], 0) for e in want]

    def judge(self, control: bool = False) -> tuple:
        """The four numbers of the window's answers against the reference,
        or with ``control`` of the reference with its windowed frames in
        TF32 put in the program's place for the same segments."""
        n, rows, segs = self._answers()
        ref = self._reference(set(segs.tolist()), "float64")
        cmp = Comparison()
        cmp.ties = sum(r[3] for r in ref.values())
        sampled_seg = {int(segs[k]): i for k, i in self.sampled.items() if k < n}
        if control:
            ctl = self._reference(set(ref), "tf32")
            for s, (db, vmin, found, _) in ctl.items():
                rdb, rvmin, rfound, tie = ref[s]
                img = s in sampled_seg
                cmp.series(db if img else [], rdb if img else [], [vmin], [rvmin], None)
                if not tie:
                    cmp.events(self._keyed(found, db if img else None),
                               self._keyed(rfound, rdb if img else None))
            return cmp, len(ctl)
        images = self.images.numpy()
        groups = {}
        for k in range(n):
            img = k in self.sampled
            key = (int(segs[k]), rows[k].tobytes(), self.sampled[k] if img else -1)
            groups[key] = groups.get(key, 0) + 1
        for (s, raw, i), times in groups.items():
            row = np.frombuffer(raw, dtype=np.int32)
            rdb, rvmin, rfound, tie = ref[s]
            db = images[i] if i >= 0 else None
            vmin = float(row[6 * CAP + 4:].view(np.float32)[0])
            cmp.series(db if i >= 0 else [], rdb if i >= 0 else [], [vmin], [rvmin], None)
            count, n_crit, n_non, overflow = (int(v) for v in row[6 * CAP: 6 * CAP + 4])
            if overflow or count > CAP:
                cmp.dropped(times)
                count = min(count, CAP)
            if tie:
                continue
            f = row[:6 * CAP].reshape(6, CAP)[:, :count].T
            got = self._keyed([tuple(int(v) for v in c) for c in f], db)
            want = self._keyed(rfound, rdb if db is not None else None)
            r_crit = sum(c.critical for c in rfound)
            got.append((-1, n_crit * 1000 + n_non))
            want.append((-1, r_crit * 1000 + len(rfound) - r_crit))
            cmp.events(got, want, times=times)
        cmp.events(*self._files(rows, ref, segs))
        return cmp, n
