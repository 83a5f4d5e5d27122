"""Closed loop over the live sessions of a network: one
``apps/live.py::LiveSession`` a station, fed its recording in feeds round
robin over the stations, each feed issued as soon as the one before it
has returned.  It stops issuing when the window closes, so what it
measures is the feeds the card completes a second, with no cap.

Traffic keys: ``feed_seconds``; ``ring_feeds``, each station's distinct
feeds, made in set-up and fed in order, over and over; ``headless`` and
``impl`` as ``LiveSession`` takes them; ``warmup_calls`` (feeds to a
scratch session).

Each feed's call and return are recorded.  Every feed's events
and thresholds are compared: each station's stream runs through the
reference from its first feed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100 import signals
from bench_h100.check import Comparison, excused_blocks
from bench_h100.drivers import stream_common as sc

REQUEST = "bench.feed"


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.fs = float(cell.config["sample_rate"])
        self.stations = int(cell.config["stations"])
        self.block = int(round(cell.config["detection"]["proc_block_sec"] * self.fs))
        self.feed = int(cell.traffic["feed_seconds"] * self.fs) // self.block * self.block
        self.ring = int(cell.traffic["ring_feeds"])
        self.nb = self.feed // self.block
        self.fed = []  # (station, feed number, events, over_noise, thresholds)

    def _session(self):
        tr = self.cell.traffic
        return self.live.LiveSession(self.cfg, self.fs, headless=bool(tr["headless"]),
                                     impl=tr["impl"], device=self.cell.device)

    def setup(self) -> None:
        from meteor_scatter_tpu_torch.apps import live

        self.live = live
        self.cfg = sc.detection_config(self.cell.config)
        x = signals.echo_audio(self.cell.seed, 2, self.stations, self.ring * self.feed, self.fs,
                               self.cell.config["signal"], self.cell.device)
        self.audio = x.cpu().numpy().reshape(self.stations, self.ring, self.feed)
        del x
        scratch = self._session()
        for f in range(int(self.cell.traffic["warmup_calls"])):
            scratch.feed(self.audio[0, f % self.ring])
        self.sessions = [self._session() for _ in range(self.stations)]

    def window(self, seconds: float, tracer) -> list:
        records = []
        t_end = time.perf_counter() + seconds
        j = 0
        while True:
            t_call = time.perf_counter()
            if t_call >= t_end:
                break
            s, f = j % self.stations, j // self.stations
            sess = self.sessions[s]
            with tracer.span(REQUEST):
                new = sess.feed(self.audio[s, f % self.ring])
            records.append({"start": t_call, "end": time.perf_counter()})
            self.fed.append((s, f, new, sess.last_diags["over_noise"], sess.last_diags["threshold"]))
            j += 1
            tracer.tick()
        self.fed = [(s, f, new, on.cpu().numpy(), thr.cpu().numpy())
                    for s, f, new, on, thr in self.fed]
        return records

    def free(self) -> None:
        self.sessions = None
        self.live = None

    def _reference(self, precision: str, feeds: np.ndarray):
        """Per station, the reference over its first ``feeds[s]`` feeds."""
        ring_on = sc.over_noise(self.cell.config, torch.from_numpy(self.audio).to(self.cell.device),
                                self.fs, precision)  # (stations, ring, nb)
        out = []
        horizon = int(self.cell.config["resync_blocks"])
        for s in range(self.stations):
            on = np.concatenate([ring_on[s, f % self.ring] for f in range(int(feeds[s]))])
            r = sc.stream_reference(self.cell.config, on)
            out.append((on, r, excused_blocks(len(on), r.ties, horizon)))
        return out

    def judge(self, control: bool = False) -> tuple:
        feeds = np.zeros(self.stations, dtype=np.int64)
        for s, f, *_ in self.fed:
            feeds[s] = max(feeds[s], f + 1)
        ref = self._reference("float64", feeds)
        nb = self.nb
        bs = float(self.cell.config["detection"]["proc_block_sec"])

        def by_feed(events):
            out = {}
            for e in events:
                out.setdefault(e.stop_block // nb, []).append(sc.event_tuple(e))
            return out

        ref_events = [by_feed(r.events) for _, r, _ in ref]
        if control:
            answers = []
            for s, (on, r, _) in enumerate(self._reference("tf32", feeds)):
                evs = by_feed(r.events)
                for f in range(int(feeds[s])):
                    blk = slice(f * nb, (f + 1) * nb)
                    answers.append((s, f, evs.get(f, []), on[blk], r.thresholds[blk]))
        else:
            answers = [(s, f, [(int(round(e["time_start"] / bs)), int(round(e["time_stop"] / bs)),
                                e["db_min"], e["db_max"], e["db_mean"], e["db_std"]) for e in new],
                        on, thr) for s, f, new, on, thr in self.fed]
        cmp = Comparison()
        for s, f, events, on, thr in answers:
            ron, r, exc = ref[s]
            blk = slice(f * nb, (f + 1) * nb)
            cmp.series(on, ron[blk], thr, r.thresholds[blk], exc[blk] | r.fragile[blk])
            cmp.events(events, ref_events[s].get(f, []), exc)
        cmp.ties = sum(len(r.ties) for _, r, _ in ref)
        return cmp, len(answers)
