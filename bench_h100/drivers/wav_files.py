"""Closed loop of one client over a station's archive of WAV files:
``apps/analyze.py::proc_wav_file`` on each file in turn, with the event
CSV and the Audacity labels written, the files cycled.

Traffic keys: ``archive_hours`` (the archive made in set-up from the
seed, one continuous recording), ``file_seconds`` (the length it is cut
into), ``impl`` (the adaptive solver, as ``proc_wav_file`` takes it),
``warmup_calls``.

Every answer due in the window is compared: each file's detection series,
thresholds and events against the reference's for that file.
"""

from __future__ import annotations

import os
import time
import wave

import numpy as np
import torch

from bench_h100 import signals
from bench_h100.check import Comparison, excused_blocks
from bench_h100.reference import detectors, fronts

REQUEST = "bench.proc_wav_file"


def write_wav_int16(path: str, fs: int, data: np.ndarray) -> None:
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(fs)
        wf.writeframes(np.ascontiguousarray(data, dtype="<i2").tobytes())


class Driver:
    def __init__(self, cell):
        self.cell = cell
        cfg, tr = cell.config, cell.traffic
        self.fs = int(cfg["sample_rate"])
        self.bd = float(cfg["block_duration_sec"])
        self.block = int(self.fs * self.bd)
        self.file_samples = int(tr["file_seconds"] * self.fs)
        self.n_files = int(round(tr["archive_hours"] * 3600 / tr["file_seconds"]))
        self.kw = dict(
            block_duration_sec=self.bd, freq_band=tuple(cfg["freq_band"]),
            noise_band=tuple(cfg["noise_band"]), n_fft=int(cfg["n_fft"]),
            threshold_std_factor=float(cfg["threshold_std_factor"]),
            threshold_estimation_window_sec=float(cfg["threshold_estimation_window_sec"]),
            threshold_freeze_before_detection_sec=float(cfg["threshold_freeze_before_detection_sec"]),
            threshold_freeze_after_detection_sec=float(cfg["threshold_freeze_after_detection_sec"]),
            threshold_fixed_init_duration_sec=float(cfg["threshold_fixed_init_duration_sec"]),
            max_events=int(cfg["max_events"]), expected_sample_rate=self.fs,
            impl=tr["impl"], verbose=False, device=cell.device)
        self.answers = []

    def setup(self) -> None:
        from meteor_scatter_tpu_torch.apps import analyze

        self.analyze = analyze
        x = signals.echo_audio(self.cell.seed, 1, 1, self.n_files * self.file_samples, self.fs,
                               self.cell.config["signal"], self.cell.device)
        self.audio = signals.to_int16(x)[0].cpu().numpy()
        del x
        d = self.cell.workdir
        self.paths = [os.path.join(d, f"in_{i:04d}.wav") for i in range(self.n_files)]
        for i, p in enumerate(self.paths):
            write_wav_int16(p, self.fs, self.audio[i * self.file_samples:(i + 1) * self.file_samples])
        self.csv = os.path.join(d, "events.csv")
        self.lbl = os.path.join(d, "labels.txt")
        for _ in range(int(self.cell.traffic["warmup_calls"])):
            self._call(0)

    def _call(self, f: int):
        return self.analyze.proc_wav_file(self.paths[f], out_csv_file=self.csv,
                                          out_audacity_lbl_file=self.lbl, **self.kw)

    def window(self, seconds: float, tracer) -> list:
        records = []
        t_end = time.perf_counter() + seconds
        i = 0
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                break
            f = i % self.n_files
            with tracer.span(REQUEST):
                res = self._call(f)
            t1 = time.perf_counter()
            records.append({"start": t0, "end": t1, "samples": self.file_samples,
                            "read_wav_s": res.timer.totals["read_wav"]})
            self.answers.append((f, res.delta_power, res.thresholds,
                                 [(int(round(d.t_start / self.bd)), int(round(d.t_stop / self.bd)),
                                   d.dB) for d in res.detections]))
            i += 1
            tracer.tick()
        return records

    def free(self) -> None:
        self.analyze = None

    def _reference(self, f: int, precision: str):
        cfg = self.cell.config
        x = torch.from_numpy(self.audio[f * self.file_samples:(f + 1) * self.file_samples])
        band, noise = fronts.batch_band_db(x.to(self.cell.device), self.fs, 2 * int(cfg["n_fft"]),
                                           self.block, [cfg["freq_band"], cfg["noise_band"]],
                                           precision)
        delta = band - noise
        bd = self.bd
        r = detectors.adaptive_detect(
            delta, float(cfg["threshold_std_factor"]),
            int(cfg["threshold_estimation_window_sec"] / bd),
            int(cfg["threshold_freeze_before_detection_sec"] / bd),
            int(cfg["threshold_freeze_after_detection_sec"] / bd),
            int(cfg["threshold_fixed_init_duration_sec"] / bd), float(cfg["tie_db"]))
        return delta, r

    def judge(self, control: bool = False) -> tuple:
        """The four numbers of the window's answers against the reference,
        or with ``control`` of the reference in TF32 put in the program's
        place for the same files."""
        ref = {f: self._reference(f, "float64") for f in sorted({a[0] for a in self.answers})}
        horizon = int(self.cell.config["resync_blocks"])
        answers = self.answers
        if control:
            answers = []
            for f in ref:
                delta, r = self._reference(f, "tf32")
                answers.append((f, delta, r.thresholds, [(s, e, m) for s, e, m in r.events]))
        cmp = Comparison()
        for f, delta, thr, events in answers:
            rdelta, r = ref[f]
            exc = excused_blocks(len(rdelta), r.ties, horizon)
            cmp.series(delta, rdelta, thr, r.thresholds, exc)
            cmp.events(events, r.events, exc)
        cmp.ties = sum(len(r.ties) for _, r in ref.values())
        return cmp, len(answers)
