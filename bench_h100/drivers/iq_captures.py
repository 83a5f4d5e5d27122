"""Closed loop of one client over an archive of wideband I/Q captures held
on the card: each call is one capture through the front end's app entries
as its CLI composes them, ``apps/frontend.py::iq_frontend`` (the channel
bank and the resampler) and then ``detect_channels`` (band power, the
adaptive detector, events), each sent when the last returns; then the
events and counts to the host.

Traffic keys: ``capture_seconds``; ``ring_captures``, the distinct
captures made on the card in set-up from the seed and cycled;
``sample_series``, how many calls past the first cycle keep their series
for the comparison (drawn from the seed); ``warmup_calls``.

A capture is complex64, as a GQRX raw I/Q recording holds it (:func:`iq_capture`),
and the call takes its (n, 2) float32 view: I and Q as ``x[:, 0]`` and
``x[:, 1]``.

Every call's events are compared, answers of the same bytes judged once;
the detection series of the first cycle's calls and of the sampled ones.
``detect_channels`` returns the series and the events, so the thresholds
compared are those the port's ``adaptive_thresholds_parallel`` takes from
the returned series with ``detect_channels``' settings, after the window.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from bench_h100 import signals
from bench_h100.check import Comparison, excused_blocks
from bench_h100.reference import channelizer, detectors, fronts

REQUEST = "bench.iq_capture"
TO_HOST = "bench.events_to_host"


def iq_capture(seed: int, stream: int, n: int, fs: int, station_freqs, signal: dict,
               bandwidth: float, out: torch.Tensor) -> None:
    """Fills ``out`` (n, 2) float32 with a complex capture: white noise of
    ``noise_rms`` in I and in Q, and each station's meteor echoes as
    complex exponentials at its frequency plus a Doppler offset within
    ``doppler_hz``.  The echoes follow :func:`bench_h100.signals.echo_plan`
    (the same set for every seed, its count, durations, envelope and
    peaks); a peak is given against the noise rms that a channel of
    ``bandwidth`` Hz passes into the real audio, ``noise_rms·√(bandwidth/fs)``."""
    gen = torch.Generator(device=out.device).manual_seed(signals._seeds(seed, stream)[0])
    out.normal_(generator=gen)
    out *= float(signal["noise_rms"])
    sig = dict(signal, tone_hz=0.0,
               noise_rms=float(signal["noise_rms"]) * math.sqrt(bandwidth / fs))
    plan = signals.echo_plan(seed, stream, len(station_freqs), n, fs, sig)
    for f, echoes in zip(station_freqs, plan):
        for s0, length, peak, doppler, phase, dur in echoes:
            t = torch.arange(length, device=out.device, dtype=torch.float64) / fs
            env = peak * torch.clamp(t / signals.RISE_S, max=1.0) * torch.exp(-3.0 * t / dur)
            ang = 2.0 * math.pi * (f + doppler) * t + phase
            out[s0: s0 + length, 0] += (env * torch.cos(ang)).to(torch.float32)
            out[s0: s0 + length, 1] += (env * torch.sin(ang)).to(torch.float32)


class Driver:
    def __init__(self, cell):
        self.cell = cell
        cfg, tr = cell.config, cell.traffic
        self.fs = int(cfg["sample_rate"])
        self.n = int(round(tr["capture_seconds"] * self.fs))
        self.ring = int(tr["ring_captures"])
        self.fe = cfg["frontend"]
        self.det = cfg["detection"]
        self.freqs = channelizer.iq_station_freqs(int(cfg["stations"]), float(cfg["spacing_hz"]))
        self.events = []  # (k, counts (C,), fields (3, C, m) numpy: start, stop, mean dB)
        self.series = {}  # k -> delta (C, B), then (delta, thresholds) on the host

    def setup(self) -> None:
        from meteor_scatter_tpu_torch.apps import frontend

        self.frontend = frontend
        cfg = self.cell.config
        self.call_freqs = frontend.station_freqs(int(cfg["stations"]), 0.0,
                                                 float(cfg["spacing_hz"]), iq=True)
        self.iq = torch.empty((self.ring, self.n), dtype=torch.complex64, device=self.cell.device)
        self._require_kept_plan()
        for p in range(self.ring):
            iq_capture(self.cell.seed, 100 + p, self.n, self.fs, self.freqs, cfg["signal"],
                       float(self.fe["channel_bandwidth"]), torch.view_as_real(self.iq[p]))
        rng = np.random.default_rng([int(self.cell.seed) % (2 ** 64), 37])
        extra = int(self.cell.traffic["sample_series"])
        self.sampled = set(range(self.ring)) | set(
            int(k) for k in rng.integers(self.ring, 100 * self.ring + 1000, extra))
        for _ in range(int(self.cell.traffic["warmup_calls"])):
            self._to_host(self._call(0)[0])

    def _require_kept_plan(self) -> None:
        """Ends the run at once where the program builds the channel bank's
        tables anew for every capture.  The deployment is an archive of
        captures of one length: building its 2 x 8 x 6e6 float32 cosines and
        sines on the host for each call would time the host's trigonometry
        and upload, seconds a capture, and not the front end on the card.
        The key is the one ``iq_frontend`` gives ``channel_bank_plan`` for
        the cell's captures; kept tables come back as the same storage."""
        from meteor_scatter_tpu_torch.ops import fir

        fe = self.fe
        centers = np.asarray(self.call_freqs, dtype=np.float64) - float(fe["tone_freq"])
        bandwidth = float(fe["channel_bandwidth"])
        decim = self.frontend._stages(self.fs, int(fe["audio_rate"]), bandwidth)[0]
        key = (self.n, self.fs, centers, bandwidth, decim, int(fe["numtaps"]))
        first = fir.channel_bank_plan(*key, device=self.iq.device)[1]
        again = fir.channel_bank_plan(*key, device=self.iq.device)[1]
        if any(a.data_ptr() != b.data_ptr() for a, b in zip(first, again)):
            raise SystemExit("frontend_iq_2msps needs the channel bank's tables kept across "
                             "captures of one length: this program's channel_bank_plan builds "
                             "them anew on every call")

    def _call(self, p: int):
        x = torch.view_as_real(self.iq[p])
        audio = self.frontend.iq_frontend(x[:, 0], self.fs, self.call_freqs, x_im=x[:, 1],
                                          device=self.cell.device, **self.fe)
        return self.frontend.detect_channels(audio, tone_freq=self.fe["tone_freq"], **self.det)

    @staticmethod
    def _to_host(ev):
        """Counts and overflow flags in one copy, then the fields of as
        many events as the fullest channel has."""
        counts, overflow = torch.stack([ev.count, ev.overflow.to(torch.int32)]).cpu().numpy()
        m = int(min(counts.max(initial=0), ev.start.shape[-1]))
        fields = torch.stack([ev.start.to(torch.float32), ev.stop.to(torch.float32),
                              ev.db_mean])[..., :m].cpu().numpy()
        return counts, fields, overflow.astype(bool)

    def window(self, seconds: float, tracer) -> list:
        records = []
        t_end = time.perf_counter() + seconds
        k = 0
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                break
            with tracer.span(REQUEST):
                ev, delta = self._call(k % self.ring)
            with tracer.span(TO_HOST):
                counts, fields, overflow = self._to_host(ev)
            t1 = time.perf_counter()
            records.append({"start": t0, "end": t1, "samples": self.n})
            self.events.append((k, counts, fields, overflow))
            if k in self.sampled:
                self.series[k] = delta
            k += 1
            tracer.tick()
        from meteor_scatter_tpu_torch.models.adaptive import adaptive_thresholds_parallel

        kw = self._blocks()
        self.series = {
            k: (d.cpu().numpy(), adaptive_thresholds_parallel(
                d, self.det["threshold_std_factor"], kw["window"], kw["freeze_before"],
                kw["freeze_after"], kw["fixed"])[0].cpu().numpy())
            for k, d in self.series.items()}
        return records

    def free(self) -> None:
        self.frontend = None

    def _blocks(self) -> dict:
        """The detector's spans in blocks, as ``detect_channels`` takes them."""
        d = self.det
        bd = float(d["block_duration_sec"])
        return {"window": int(d["threshold_estimation_window_sec"] / bd),
                "freeze_before": int(d["threshold_freeze_before_sec"] / bd),
                "freeze_after": int(d["threshold_freeze_after_sec"] / bd),
                "fixed": int(d["threshold_fixed_init_sec"] / bd)}

    def _reference(self, p: int, bank: str = "float64", band: str = "float64"):
        """Ring capture ``p`` through the plain reference: per channel its
        detection series (float64 numpy), the detector's result and the
        blocks excused after its ties.  ``bank`` and ``band`` are the
        precisions of the channel filter's and the band power's products."""
        fe, d = self.fe, self.det
        audio = channelizer.iq_audio(torch.view_as_real(self.iq[p]), self.fs, self.freqs,
                                     fe["audio_rate"], fe["tone_freq"], fe["channel_bandwidth"],
                                     fe["numtaps"], bank)
        rate = int(fe["audio_rate"])
        block = int(rate * d["block_duration_sec"])
        bands = [(fe["tone_freq"] - d["bandwidth"], fe["tone_freq"] + d["bandwidth"]),
                 (d["noise_freq"] - d["bandwidth"], d["noise_freq"] + d["bandwidth"])]
        kw = self._blocks()
        horizon = int(self.cell.config["resync_blocks"])
        out = []
        for c in range(audio.shape[0]):
            sig, noise = fronts.batch_band_db(audio[c], rate, int(d["n_fft"]), block, bands, band)
            delta = sig - noise
            r = detectors.adaptive_detect(delta, float(d["threshold_std_factor"]), kw["window"],
                                          kw["freeze_before"], kw["freeze_after"], kw["fixed"],
                                          float(self.cell.config["tie_db"]))
            out.append((delta, r, excused_blocks(len(delta), r.ties, horizon)))
        return out

    def judge(self, control=False) -> tuple:
        """The four numbers of the window's answers against the reference,
        or with ``control`` those of the reference with its channel filter
        and band products in TF32 (``"bank"``: the filter's alone) put in
        the program's place for each ring capture."""
        ref = [self._reference(p) for p in range(self.ring)]
        cmp = Comparison()
        cmp.ties = sum(len(r.ties) for chans in ref for _, r, _ in chans)
        if control:
            band = "float64" if control == "bank" else "tf32"
            for p in range(self.ring):
                ctl = self._reference(p, "tf32", band)
                for (delta, r, _), (rdelta, rr, exc) in zip(ctl, ref[p]):
                    cmp.series(delta, rdelta, r.thresholds, rr.thresholds, exc)
                    cmp.events(r.events, rr.events, exc)
            return cmp, self.ring
        distinct = {}  # the ring repeats, so calls whose bytes agree are judged once
        for k, counts, fields, overflow in self.events:
            key = (k % self.ring, counts.tobytes(), fields.tobytes(), overflow.tobytes())
            if key in distinct:
                distinct[key][1] += 1
            else:
                distinct[key] = [(k, counts, fields, overflow), 1]
        for (k, counts, fields, overflow), times in distinct.values():
            for c, (_, rr, exc) in enumerate(ref[k % self.ring]):
                n = int(counts[c])
                if n > fields.shape[2] or overflow[c]:
                    cmp.dropped(times)
                    n = min(n, fields.shape[2])
                got = [(int(fields[0, c, i]), int(fields[1, c, i]), float(fields[2, c, i]))
                       for i in range(n)]
                cmp.events(got, rr.events, exc, times)
        for k, (delta, thr) in self.series.items():
            for c, (rdelta, rr, exc) in enumerate(ref[k % self.ring]):
                cmp.series(delta[c], rdelta, thr[c], rr.thresholds, exc)
        return cmp, len(self.events)
