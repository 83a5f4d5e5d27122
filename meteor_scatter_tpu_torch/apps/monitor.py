"""Continuous segment monitor on PyTorch — counterpart of
`meteor_scatter_tpu/apps/monitor.py` (reference:
`meteor_detect_class/prime_detection.py`, the deployed 24/7 loop).

Every 30 s audio segment flows: source → spectrogram + noise-floor cut →
cluster detection + critical classification (on the chosen device) →
hourly ``Timestamp;Anzahl;Kritisch`` ledger with daily rotation (host),
plus a spectrogram PNG copy for any segment with detections
(`prime_detection.py:198-203`).

Audio sources: a WAV file consumed in segment-sized chunks (testing /
reprocessing), the same file streamed by the native runtime's background
pump thread into a lock-free ring (``--pump``, the deployment-shaped
ingest), or an external command producing raw PCM on stdout (the
deployment path, e.g. ffmpeg pulling the stream the reference grabs).
Failure handling mirrors the reference: segment-length check with source
rebuild (`prime_detection.py:150-173`) and sleep-backoff on grab errors
(`:145-147`).

Usage::

    python -m meteor_scatter_tpu_torch.apps.monitor --wav day.wav \\
        --csv-out csv-out --spec-out spec-out --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from datetime import datetime, timedelta
from typing import Optional

import numpy as np
import torch

from meteor_scatter_tpu_torch.config import MonitorConfig
from meteor_scatter_tpu_torch.device import DeviceLike, resolve_device
from meteor_scatter_tpu_torch.io.ledger import HourlyLedger
from meteor_scatter_tpu_torch.io.native import NativeWavReader, PcmRing, WavPump
from meteor_scatter_tpu_torch.io.png import colorize, upscale_to, write_png
from meteor_scatter_tpu_torch.io.wavio import read_wav
from meteor_scatter_tpu_torch.models.image import detect_and_cluster_bursts
from meteor_scatter_tpu_torch.utils.timing import PhaseTimer

class OffsetJournal:
    """Persisted stream offset for replayable sources: journaling the
    consumed sample position next to the CSV ledger lets a restarted
    monitor continue exactly where it stopped instead of re-counting (or
    skipping) segments.  Keyed on the source identity so a different input
    file starts fresh."""

    def __init__(self, out_dir: str, source_id: Optional[str]):
        self.path = os.path.join(out_dir, ".offset.json") if source_id else None
        self.source_id = source_id

    def load(self) -> int:
        if not self.path or not os.path.exists(self.path):
            return 0
        try:
            with open(self.path) as fh:
                j = json.load(fh)
            return int(j["pos"]) if j.get("source") == self.source_id else 0
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            # any unreadable/malformed journal degrades to a fresh start
            return 0

    def save(self, pos: int) -> None:
        if not self.path:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"source": self.source_id, "pos": int(pos)}, fh)
        os.replace(tmp, self.path)


class WavSegmentSource:
    """Replays a WAV file as consecutive segments (real-time optional)."""

    def __init__(
        self, path: str, cfg: MonitorConfig, realtime: bool = False, start_pos: int = 0
    ):
        fs, data = read_wav(path, mono=True)
        if fs != cfg.sample_rate:
            raise ValueError(f"expected {cfg.sample_rate} Hz, got {fs}")
        if np.issubdtype(data.dtype, np.floating):
            # float WAVs decode to [-1, 1]; the detection dB windows are
            # calibrated to raw int16 PCM amplitude (the reference grabber's
            # scale), which the command source already delivers
            data = np.asarray(data, np.float32) * 32768.0
        self.data = data
        self.seg = cfg.sample_rate * cfg.segment_len_sec
        self.pos = min(int(start_pos), len(data))
        self.realtime = realtime
        self.seg_sec = cfg.segment_len_sec
        self.source_id = os.path.abspath(path)

    def grab(self) -> Optional[np.ndarray]:
        if self.pos + self.seg > len(self.data):
            return None
        out = self.data[self.pos : self.pos + self.seg]
        self.pos += self.seg
        if self.realtime:
            time.sleep(self.seg_sec)
        return out


class PumpSegmentSource:
    """Deployment-shaped WAV ingest: a background producer thread (the
    native runtime's C++ pump when available, `io/native.py::WavPump`)
    streams the file into a lock-free SPSC ring while this thread pops
    fixed segments — the same producer/consumer split as the reference's
    TwitchAudioGrabber thread + detection loop (prime_detection.py:49-57,
    :128), with file IO overlapping device compute.  It has no position,
    as in the reference: nothing is journaled, and ``--start-time`` is
    refused with it.
    """

    def __init__(self, path: str, cfg: MonitorConfig, realtime: bool = False):
        probe = NativeWavReader(path)
        if probe.fs != cfg.sample_rate:
            probe.close()
            raise ValueError(f"expected {cfg.sample_rate} Hz, got {probe.fs}")
        probe.close()
        self.seg = cfg.sample_rate * cfg.segment_len_sec
        # ring holds a few segments: enough prefetch to hide IO, small
        # enough to bound memory like the reference's one-segment grabs
        self.ring = PcmRing(4 * self.seg)
        self.pump = WavPump(
            path, self.ring, chunk_frames=self.seg,
            pace_factor=1.0 if realtime else 0.0,
        )
        self.source_id = os.path.abspath(path)

    def grab(self) -> Optional[np.ndarray]:
        while True:
            seg = self.ring.pop_segment(self.seg)
            if seg is not None:
                # back to int16 amplitude scale: the spectrogram dB windows
                # are calibrated to raw PCM like the reference's grabber
                # output (exact inverse of the ring's /32768 pop scaling,
                # so a PCM16 file gives the WAV source's samples bit for bit)
                return seg * np.float32(32768.0)
            if not self.pump.running() and self.ring.available() < self.seg:
                return None  # EOF: trailing partial segment is discarded
            time.sleep(0.005)

    def close(self) -> None:
        self.pump.stop()


class CommandSegmentSource:
    """Reads int16 mono PCM from a subprocess (ffmpeg/streamlink/...).

    The command must write raw s16le at the configured rate to stdout,
    e.g.::

        ffmpeg -loglevel quiet -i <stream-url> -f s16le -ac 1 -ar 5000 -
    """

    def __init__(self, command: str, cfg: MonitorConfig):
        self.command = command
        self.cfg = cfg
        self.proc: Optional[subprocess.Popen] = None
        self._start()

    def _start(self) -> None:
        self.proc = subprocess.Popen(
            self.command, shell=True, stdout=subprocess.PIPE, bufsize=0
        )

    def grab(self) -> Optional[np.ndarray]:
        n_bytes = self.cfg.sample_rate * self.cfg.segment_len_sec * 2
        buf = b""
        if self.proc is None or self.proc.stdout is None:
            raise RuntimeError("the source command is not running")
        while len(buf) < n_bytes:
            chunk = self.proc.stdout.read(n_bytes - len(buf))
            if not chunk:
                break
            buf += chunk
        # a short read (stream died) returns a short segment, which the
        # monitor loop's length check turns into a rebuild
        return np.frombuffer(buf, np.int16)

    def terminate(self) -> None:
        if self.proc:
            self.proc.kill()
            self.proc.wait()

    def rebuild(self) -> None:
        """Stream recovery (prime_detection.py:150-173)."""
        try:
            self.terminate()
        except Exception as e:  # noqa: BLE001 — keep the loop alive like the reference
            print(f"Error terminating old stream: {e}")
        time.sleep(5)
        self._start()


def run_monitor(
    source,
    cfg: MonitorConfig,
    max_segments: Optional[int] = None,
    now_fn=datetime.now,
    device: DeviceLike = "cuda",
) -> HourlyLedger:
    """The reference main loop (`prime_detection.py:128-247`) with the
    detection step on ``device`` ("cuda" raises when no GPU is usable).
    Besides the reference's phases, the timer splits out the PNG writes
    and the ledger's journal and flushes."""
    dev = resolve_device(device)
    os.makedirs(cfg.spec_out_dir, exist_ok=True)
    ledger = HourlyLedger(
        cfg.csv_out_dir, save_interval_min=cfg.save_interval_min, now=now_fn()
    )
    offsets = OffsetJournal(cfg.csv_out_dir, getattr(source, "source_id", None))
    timer = PhaseTimer(log=True)
    expected = cfg.sample_rate * cfg.segment_len_sec
    n = 0

    while max_segments is None or n < max_segments:
        print("\n[INFO] Starting new pass...")
        timer.start("grab_audio")
        try:
            segment = source.grab()
        except Exception as e:  # noqa: BLE001 — reference behavior (:145-147)
            print(f"Audio grab error: {e}")
            time.sleep(5)
            continue
        if segment is None:
            print("[INFO] Source exhausted.")
            break
        if segment.shape[0] != expected:
            print("Error: short segment. Restarting stream...")
            if hasattr(source, "rebuild"):
                source.rebuild()
                continue
            break
        timer.end("grab_audio")

        timer.start("plot_spectrogram+detect")
        audio = torch.from_numpy(np.asarray(segment, dtype=np.float32)).to(dev)
        img, bursts = detect_and_cluster_bursts(
            audio,
            cfg.sample_rate,
            n_fft=cfg.n_fft,
            spec_cut_factor=cfg.spec_cut_factor,
            eps_px=cfg.cluster_epsilon,
            min_samples=cfg.cluster_min_samples,
            keypoint_mode=cfg.keypoint_mode,
        )
        n_crit = int(bursts.n_critical)
        n_non = int(bursts.n_non_critical)
        timer.end("plot_spectrogram+detect")

        print(f"Critical bursts this segment: {n_crit}")
        print(f"Non-critical bursts this segment: {n_non}")

        if n_crit + n_non > 0:
            # copy of the detection spectrogram (prime_detection.py:198-203)
            timer.start("write_png")
            ts = now_fn().strftime("%Y%m%d-%H%M%S")
            path = os.path.join(cfg.spec_out_dir, f"{ts}-{n_crit}-{n_non}.png")
            db = img.db.cpu().numpy()
            write_png(
                path,
                upscale_to(colorize(db[::-1, :], vmin=float(img.vmin), vmax=40.0)),
            )
            timer.end("write_png")

        # at-most-once accounting: the offset journals BEFORE the counts
        # become durable, so a kill between the two loses at most this one
        # segment's counts on resume (the reverse order would re-process
        # and double-count it); the ledger's own journal makes the add
        # crash-safe
        timer.start("ledger")
        if hasattr(source, "pos"):
            offsets.save(source.pos)
        ledger.add(n_crit, n_non, now=now_fn())
        timer.end("ledger")
        n += 1

    print(timer.summary())
    return ledger


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--wav", help="replay a WAV file as segments")
    src.add_argument("--command", help="shell command producing s16le PCM on stdout")
    p.add_argument("--csv-out", default="csv-out")
    p.add_argument("--spec-out", default="spec-out")
    p.add_argument("--sample-rate", type=int, default=5000)
    p.add_argument("--segment-len", type=int, default=30)
    p.add_argument("--max-segments", type=int, default=None)
    p.add_argument("--realtime", action="store_true")
    p.add_argument("--pump", action="store_true",
                   help="WAV only: ingest via the native runtime's background "
                        "pump thread + SPSC ring (IO overlaps compute); "
                        "excludes --resume (the pump streams from the start)")
    p.add_argument("--resume", action="store_true",
                   help="continue a WAV replay from the journaled offset")
    p.add_argument("--keypoint-mode", choices=["threshold", "corner"],
                   default="threshold",
                   help="burst keypoints: above-cut pixels or Harris corners (ORB-like)")
    p.add_argument("--start-time", default=None,
                   help="WAV replay only: ISO timestamp of the recording's "
                        "start; ledger rows then follow the AUDIO timeline "
                        "(start + consumed samples / rate) instead of the "
                        "wall clock, so reprocessing a historical capture "
                        "produces correctly-dated CSVs and a --resume "
                        "restart continues the same simulated clock")
    p.add_argument("--time-scale", type=float, default=1.0,
                   help="with --start-time: simulated seconds per second of "
                        "audio (accelerated-day replay / soak testing)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.start_time is not None and (not args.wav or args.pump):
        p.error("--start-time requires a positioned (WAV replay) source")

    cfg = MonitorConfig(
        sample_rate=args.sample_rate,
        segment_len_sec=args.segment_len,
        csv_out_dir=args.csv_out,
        spec_out_dir=args.spec_out,
        keypoint_mode=args.keypoint_mode,
    )
    if args.wav and args.pump:
        if args.resume:
            p.error("--pump excludes --resume")
        source = PumpSegmentSource(args.wav, cfg, realtime=args.realtime)
    elif args.wav:
        start = 0
        if args.resume:
            start = OffsetJournal(args.csv_out, os.path.abspath(args.wav)).load()
            if start:
                print(f"[INFO] Resuming {args.wav} at sample {start}")
        source = WavSegmentSource(args.wav, cfg, realtime=args.realtime, start_pos=start)
    else:
        source = CommandSegmentSource(args.command, cfg)

    now_fn = datetime.now
    if args.start_time is not None:
        t_start = datetime.fromisoformat(args.start_time)
        scale = args.time_scale

        def now_fn():
            # derived from the consumed-sample position, so the clock is
            # deterministic and survives --resume restarts
            return t_start + timedelta(seconds=(source.pos / cfg.sample_rate) * scale)

    try:
        run_monitor(source, cfg, max_segments=args.max_segments, now_fn=now_fn,
                    device=args.device)
    finally:
        if isinstance(source, CommandSegmentSource):
            source.terminate()
        elif isinstance(source, PumpSegmentSource):
            source.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
