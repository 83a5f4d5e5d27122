"""Closed loop of a network's captures already on the card:
``models/streaming.py::stream_process`` on (stations, samples) chunks
with the stations' state carried from chunk to chunk, each chunk's events
and counts brought to the host after it.

Traffic keys: ``chunk_seconds``; ``ring_chunks``, the chunks of one
capture, made on the card in set-up and cycled, each cycle a capture of
its own that starts from a fresh state; ``front`` and ``impl`` as
``stream_process`` takes them; ``sample_series``, how many chunks past the
first capture keep their series for the comparison (drawn from the seed);
``warmup_calls``.

Every chunk's events are compared; the level and threshold series of the
first capture's chunks and of the sampled ones.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100 import signals
from bench_h100.check import Comparison, excused_blocks
from bench_h100.drivers import stream_common as sc

REQUEST = "bench.stream_process"
TO_HOST = "bench.events_to_host"
FRESH = "bench.fresh_state"


def chunk_major_(x: torch.Tensor, ring: int) -> torch.Tensor:
    """``x`` (stations, ring·chunk) rearranged in its own storage to
    (ring, stations, chunk), each chunk contiguous: ``out[p, c] ==
    x[c, p·chunk:(p + 1)·chunk]`` as it was.  The (stations, ring) grid of
    rows is transposed by following its cycles, with one row held aside,
    so no second copy of the capture is made."""
    stations, n = x.shape
    chunk = n // ring
    rows = x.view(stations * ring, chunk)
    held = torch.empty_like(rows[0])
    placed = bytearray(stations * ring)
    for start in range(stations * ring):
        if placed[start]:
            continue
        held.copy_(rows[start])
        d = start
        while True:
            placed[d] = 1
            s = (d % stations) * ring + d // stations  # the row that belongs at d
            if s == start:
                rows[d].copy_(held)
                break
            rows[d].copy_(rows[s])
            d = s
    return x.view(ring, stations, chunk)


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.fs = float(cell.config["sample_rate"])
        self.stations = int(cell.config["stations"])
        self.block = int(round(cell.config["detection"]["proc_block_sec"] * self.fs))
        self.chunk = int(cell.traffic["chunk_seconds"] * self.fs) // self.block * self.block
        self.ring = int(cell.traffic["ring_chunks"])
        self.nb = self.chunk // self.block
        self.events = []  # (k, counts (C,), fields (7, C, m) numpy)
        self.series = {}  # k -> (over_noise, thresholds) on the device

    def setup(self) -> None:
        from meteor_scatter_tpu_torch.models import streaming

        self.st = streaming
        self.cfg = sc.detection_config(self.cell.config)
        self.scfg = streaming.StreamConfig.from_config(self.cfg)
        x = signals.echo_audio(self.cell.seed, 3, self.stations, self.ring * self.chunk, self.fs,
                               self.cell.config["signal"], self.cell.device)
        self.audio = chunk_major_(x, self.ring)
        del x
        rng = np.random.default_rng([int(self.cell.seed) % (2 ** 64), 31])
        extra = int(self.cell.traffic["sample_series"])
        self.sampled = set(range(self.ring)) | set(
            int(k) for k in rng.integers(self.ring, 100 * self.ring + 1000, extra))
        state = self._fresh()
        for _ in range(int(self.cell.traffic["warmup_calls"])):
            state, ev, _ = self._process(state, 0)
            self._to_host(ev)

    def _fresh(self):
        return self.st.stream_init_batch(self.scfg, self.stations, device=self.cell.device)

    def _process(self, state, p: int):
        tr = self.cell.traffic
        return self.st.stream_process(self.cfg, state, self.audio[p], self.fs,
                                      front=tr["front"], impl=tr["impl"])

    @staticmethod
    def _to_host(ev):
        """Counts and overflow flags in one copy, then the fields of as
        many events as the fullest station has."""
        counts, overflow = torch.stack([ev.count, ev.overflow.to(torch.int32)]).cpu().numpy()
        m = int(min(counts.max(initial=0), ev.time_start.shape[-1]))
        fields = torch.stack([getattr(ev, f)[:, :m] for f in sc.EVENT_FIELDS]).cpu().numpy()
        return counts, fields, overflow.astype(bool)

    def window(self, seconds: float, tracer) -> list:
        records = []
        samples = self.stations * self.chunk
        t_end = time.perf_counter() + seconds
        k = 0
        state = None
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                break
            p = k % self.ring
            if p == 0:
                with tracer.span(FRESH):
                    state = self._fresh()
            with tracer.span(REQUEST):
                state, ev, diags = self._process(state, p)
            with tracer.span(TO_HOST):
                counts, fields, overflow = self._to_host(ev)
            t1 = time.perf_counter()
            records.append({"start": t0, "end": t1, "samples": samples})
            self.events.append((k, counts, fields, overflow))
            if k in self.sampled:
                self.series[k] = (diags["over_noise"], diags["threshold"])
            k += 1
            tracer.tick()
        self.series = {k: (a.cpu().numpy(), b.cpu().numpy()) for k, (a, b) in self.series.items()}
        return records

    def free(self) -> None:
        self.st = None

    def _reference(self, precision: str):
        """Per station the capture's levels (stations, ring·nb), detector
        results, and excused blocks."""
        on = np.concatenate([sc.over_noise(self.cell.config, self.audio[p], self.fs, precision)
                             for p in range(self.ring)], axis=1)
        res = [sc.stream_reference(self.cell.config, on[c]) for c in range(self.stations)]
        horizon = int(self.cell.config["resync_blocks"])
        exc = [excused_blocks(on.shape[1], r.ties, horizon) for r in res]
        return on, res, exc

    def judge(self, control: bool = False) -> tuple:
        on, res, exc = self._reference("float64")
        nb = self.nb
        ref_by_pos = [[[] for _ in range(self.stations)] for _ in range(self.ring)]
        for c, r in enumerate(res):
            for e in r.events:
                ref_by_pos[e.stop_block // nb][c].append(sc.event_tuple(e))
        cmp = Comparison()
        if control:
            con, cres, _ = self._reference("tf32")
            thr = np.stack([r.thresholds for r in cres])
            for p in range(self.ring):
                s = slice(p * nb, (p + 1) * nb)
                for c in range(self.stations):
                    cmp.series(con[c, s], on[c, s], thr[c, s], res[c].thresholds[s],
                               exc[c][s] | res[c].fragile[s])
                    got = [sc.event_tuple(e) for e in cres[c].events if e.stop_block // nb == p]
                    cmp.events(got, ref_by_pos[p][c], exc[c])
            cmp.ties = sum(len(r.ties) for r in res)
            return cmp, self.ring
        bs = float(self.cell.config["detection"]["proc_block_sec"])
        # each capture repeats, so chunks whose bytes agree are judged once
        # and counted as often as they came
        distinct = {}
        for k, counts, fields, overflow in self.events:
            key = (k % self.ring, counts.tobytes(), fields.tobytes(), overflow.tobytes())
            if key in distinct:
                distinct[key][1] += 1
            else:
                distinct[key] = [(k, counts, fields, overflow), 1]
        for (k, counts, fields, overflow), times in distinct.values():
            p = k % self.ring
            for c in range(self.stations):
                n = int(counts[c])
                if n > fields.shape[2] or overflow[c]:
                    cmp.dropped(times)
                    n = min(n, fields.shape[2])
                got = sc.host_events(fields[:, c, :n], bs)
                cmp.events(got, ref_by_pos[p][c], exc[c], times)
        for k, (son, sthr) in self.series.items():
            p = k % self.ring
            s = slice(p * nb, (p + 1) * nb)
            for c in range(self.stations):
                cmp.series(son[c], on[c, s], sthr[c], res[c].thresholds[s],
                           exc[c][s] | res[c].fragile[s])
        cmp.ties = sum(len(r.ties) for r in res)
        return cmp, len(self.events)
