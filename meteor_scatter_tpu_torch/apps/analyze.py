"""Batch WAV analyzer on PyTorch — counterpart of
`meteor_scatter_tpu/apps/analyze.py` (reference: `dsp/src/main.py:207-806`,
``proc_wav_file``) with the same outputs: console detections, Audacity
pre-labels, the event CSV and per-detection spectrogram PNGs.

The whole file is one tensor program on the chosen device: framing → band
projection matmul → adaptive (or fixed) detection → fixed-capacity events.
On a GPU the adaptive detector runs the hand-written CUDA kernel
``csrc/adaptive_solver.cu``.

Usage::

    python -m meteor_scatter_tpu_torch.apps.analyze recording.wav \\
        --signal-freq 1003 --noise-freq 700 --bandwidth 10 \\
        --out-csv events.csv --out-audacity prelbl.txt --device cuda

Filename → UTC start-time parsing supports the reference's gqrx pattern
``*_gqrx_YYYYMMDD_HHMMSS_<freq>.wav`` (`main.py:858-863`).  ``--plot-dir``
writes the debug plots (delta power against the threshold, histograms,
detections per hour; needs matplotlib).
"""

from __future__ import annotations

import argparse
import datetime
import os
import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from meteor_scatter_tpu_torch.device import DeviceLike, resolve_device
from meteor_scatter_tpu_torch.io.events_csv import (
    OutputDetection,
    events_to_detections,
    write_audacity_labels,
    write_event_csv,
)
from meteor_scatter_tpu_torch.io.spec_export import export_detection_spec
from meteor_scatter_tpu_torch.io.ingest import read_wav_to_device
from meteor_scatter_tpu_torch.io.wavio import read_wav
from meteor_scatter_tpu_torch.models.adaptive import detect_adaptive
from meteor_scatter_tpu_torch.models.fixed import detect_fixed
from meteor_scatter_tpu_torch.ops.bandpower import delta_power_db
from meteor_scatter_tpu_torch.utils.timing import PhaseTimer, span, spanned, wait

@dataclass
class AnalyzeResult:
    detections: List[OutputDetection]
    band_power: np.ndarray
    noise_power: np.ndarray
    delta_power: np.ndarray
    thresholds: np.ndarray  # scalar-broadcast for fixed, per-block for adaptive
    sample_rate: int
    block_duration_sec: float
    timer: PhaseTimer = field(default_factory=PhaseTimer)


def export_debug_plots(res: "AnalyzeResult", out_dir: str) -> List[str]:
    """Static result plots mirroring the reference's debug_plot_output set
    (`main.py:531-565,660-719`): delta power vs adaptive threshold with
    detection spans, duration / dB histograms, and detections per hour.
    Requires matplotlib (optional dependency)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []
    times = np.arange(len(res.delta_power)) * res.block_duration_sec

    fig, ax = plt.subplots(figsize=(10, 5))
    ax.plot(times, res.delta_power, label="Delta Power")
    ax.plot(times, res.thresholds, label="Adaptive Threshold", linestyle="--", color="red")
    for det in res.detections:
        ax.axvspan(det.t_start, det.t_stop, color="orange", alpha=0.5)
    ax.set_xlabel("Zeit (s)")
    ax.set_ylabel("Leistung (dB)")
    ax.legend()
    ax.grid(True)
    fig.tight_layout()
    p = os.path.join(out_dir, "delta_threshold.png")
    fig.savefig(p, dpi=150)
    plt.close(fig)
    written.append(p)

    for name, vals, xlabel in [
        ("hist_duration", [d.dur_s for d in res.detections], "Duration (s)"),
        ("hist_db", [d.dB for d in res.detections], "dB"),
    ]:
        fig, ax = plt.subplots(figsize=(10, 5))
        ax.hist(vals, bins=30, alpha=0.7)
        ax.set_xlabel(xlabel)
        ax.set_ylabel("Count")
        ax.grid(True)
        fig.tight_layout()
        p = os.path.join(out_dir, f"{name}.png")
        fig.savefig(p, dpi=150)
        plt.close(fig)
        written.append(p)

    hours = {}
    for det in res.detections:
        if det.utc_start is not None:
            h = det.utc_start.replace(minute=0, second=0, microsecond=0)
            hours[h] = hours.get(h, 0) + 1
    if hours:
        keys = sorted(hours)
        fig, ax = plt.subplots(figsize=(12, 6))
        ax.bar([k.strftime("%Y-%m-%d %H:%M") for k in keys], [hours[k] for k in keys],
               color="skyblue")
        ax.set_xlabel("UTC Zeit (Datum + Stunde)")
        ax.set_ylabel("Anzahl der Detektionen")
        ax.set_title("Detektionen pro Stunde")
        plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
        fig.tight_layout()
        p = os.path.join(out_dir, "per_hour.png")
        fig.savefig(p, dpi=150)
        plt.close(fig)
        written.append(p)
    return written


def parse_gqrx_start_time(file_path: str) -> Optional[datetime.datetime]:
    """UTC start time from gqrx-style filenames (`main.py:858-863`)."""
    name = os.path.basename(file_path)
    m = re.search(r"(\d{8})_(\d{6})", name)
    if m:
        return datetime.datetime.strptime(m.group(1) + "-" + m.group(2), "%Y%m%d-%H%M%S")
    return None


def _frame_range(
    fs: int, n: int, start_sec: Optional[float], end_sec: Optional[float]
) -> Tuple[Optional[int], Optional[int]]:
    """The frames ``[s, e)`` of the reference's ``wav_start_sec`` /
    ``wav_end_sec`` cut of ``n`` frames at ``fs`` (None, None: no cut)."""
    if start_sec is None and end_sec is None:
        return None, None
    s = int((start_sec or 0) * fs)
    e = int((end_sec if end_sec is not None else n / fs) * fs)
    return s, e


@spanned("proc_wav_file")
def proc_wav_file(
    file_path: str,
    block_duration_sec: float = 0.2,
    freq_band: Tuple[float, float] = (993.0, 1013.0),
    noise_band: Tuple[float, float] = (690.0, 710.0),
    n_fft: int = 512,
    threshold_std_factor: float = 4.0,
    wav_start_sec: Optional[float] = None,
    wav_end_sec: Optional[float] = None,
    out_audacity_lbl_file: Optional[str] = None,
    out_csv_file: Optional[str] = None,
    outfile_path: Optional[str] = None,
    wav_start_date_time: Optional[datetime.datetime] = None,
    flag_adaptive_threshold: bool = True,
    threshold_estimation_window_sec: float = 120.0,
    threshold_freeze_before_detection_sec: float = 3.0,
    threshold_freeze_after_detection_sec: float = 20.0,
    threshold_fixed_init_duration_sec: float = 10.0,
    expected_sample_rate: Optional[int] = 6000,
    max_events: int = 4096,
    verbose: bool = True,
    impl: str = "auto",
    device: DeviceLike = "cuda",
) -> AnalyzeResult:
    """Same signature family as the reference ``proc_wav_file``
    (`main.py:207-229`), including the n_fft doubling (`main.py:353`), plus
    the ``device`` to run on ("cuda" raises when no GPU is usable).

    ``impl`` selects the adaptive solver (:func:`detect_adaptive`):
    "parallel" (plain PyTorch fixpoint), "fused" (the CUDA kernel on a
    GPU), or "auto" (fused on a GPU, parallel on the CPU).
    ``outfile_path`` is the directory of the per-detection spectrogram PNGs
    (``io/spec_export.py``, transforms on ``device``)."""
    dev = resolve_device(device)
    timer = PhaseTimer(log=False)

    # on a GPU the samples of a regular file go from it to the card through
    # the pinned ring (io/ingest.py), unless the spectrogram export needs them
    # on the host; a pipe is read by read_wav, which reads a stream
    on_card = dev.type == "cuda" and outfile_path is None and os.path.isfile(file_path)
    with timer.phase("read_wav"):
        if on_card:
            with span("ingest_pinned"):
                fs, data = read_wav_to_device(
                    file_path, dev, True,
                    lambda fs, n: _frame_range(fs, n, wav_start_sec, wav_end_sec),
                )
        else:
            fs, data = read_wav(file_path, mono=True)
            data = data[slice(*_frame_range(fs, len(data), wav_start_sec, wav_end_sec))]
    if expected_sample_rate is not None and fs != expected_sample_rate:
        raise ValueError(f"Sample rate must be {expected_sample_rate} Hz, got {fs}")

    n_fft_eff = n_fft * 2  # reference doubles the user n_fft (main.py:353)
    block_size = int(fs * block_duration_sec)
    if verbose:
        print(f"Wav duration [sec]: {len(data) / fs}")
        print(f"n_fft [real]: {n_fft}  ->  effective {n_fft_eff}")
        print(f"Wav block size in samples: {block_size}")
        print(f"Number of wav blocks: {len(data) // block_size}")

    with timer.phase("band_power+detect"):
        # the samples cross to the device in their file dtype (int16 is half
        # the bytes of float32) and are converted there; the conversion is
        # exact as on the host
        with span("upload"):
            if on_card:
                x = data.to(torch.float32)
                del data
            else:
                x = torch.from_numpy(data).to(dev).to(torch.float32)
        with span("band_power"):
            band_db, noise_db, delta = delta_power_db(
                x, fs, n_fft_eff, block_size, freq_band, noise_band
            )
        del x
        with span("detect"):
            if flag_adaptive_threshold:
                events, thresholds = detect_adaptive(
                    delta,
                    threshold_std_factor,
                    block_duration_sec,
                    threshold_estimation_window_sec,
                    threshold_freeze_before_detection_sec,
                    threshold_freeze_after_detection_sec,
                    threshold_fixed_init_duration_sec,
                    cap=max_events,
                    impl=impl,
                )
            else:
                events, thr = detect_fixed(delta, threshold_std_factor, cap=max_events)
                thresholds = thr.expand(delta.shape)
        if dev.type == "cuda":
            with wait("detect_phase"):
                torch.cuda.synchronize(dev)

    with span("events_to_host"):
        dets = events_to_detections(events, block_duration_sec, wav_start_date_time)
        with wait("overflow"):
            overflow = bool(events.overflow)
    if overflow:
        print(f"WARNING: event buffer overflow — more than {max_events} events, extras dropped")

    if verbose:
        for det in dets:
            print(
                f"Detection from {det.t_start:.2f} to {det.t_stop:.2f} seconds, "
                f"dB: {det.dB:.2f} dB, duration: {det.dur_s:.2f} seconds "
                f"UTC_START: {det.utc_start}, UTC_STOP: {det.utc_stop}"
            )

    if out_audacity_lbl_file:
        with span("write_labels"):
            write_audacity_labels(out_audacity_lbl_file, dets)
            print("Wrote Items", len(dets), "to Audacity LBL file")
    if out_csv_file:
        with span("write_csv"):
            write_event_csv(out_csv_file, dets)
            print("Wrote Items", len(dets), "to CSV file:", out_csv_file)
    if outfile_path:
        with timer.phase("spec_export"):
            wav_np = np.asarray(data, dtype=np.float32)
            for det in dets:
                export_detection_spec(
                    outfile_path, det, wav_np, fs, n_fft=1024, freq_band=freq_band, device=dev
                )

    with span("series_to_host"), wait("series"):
        series = [v.cpu().numpy() for v in (band_db, noise_db, delta, thresholds)]
    if not on_card:
        with span("free_samples"):  # an hour's buffer goes back to the OS in milliseconds
            del data
    return AnalyzeResult(
        detections=dets,
        band_power=series[0],
        noise_power=series[1],
        delta_power=series[2],
        thresholds=series[3],
        sample_rate=fs,
        block_duration_sec=block_duration_sec,
        timer=timer,
    )


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("wav")
    p.add_argument("--signal-freq", type=float, default=1003.0)
    p.add_argument("--noise-freq", type=float, default=700.0)
    p.add_argument("--bandwidth", type=float, default=10.0)
    p.add_argument("--block-duration", type=float, default=0.2)
    p.add_argument("--n-fft", type=int, default=512)
    p.add_argument("--threshold-std-factor", type=float, default=4.0)
    p.add_argument("--fixed-threshold", action="store_true", help="disable adaptive threshold")
    p.add_argument("--start-sec", type=float, default=None)
    p.add_argument("--end-sec", type=float, default=None)
    p.add_argument("--sample-rate", type=int, default=None, help="expected rate (default: accept any)")
    p.add_argument("--out-csv", default=None)
    p.add_argument("--out-audacity", default=None)
    p.add_argument("--out-spec-dir", default=None)
    p.add_argument("--plot-dir", default=None, help="write delta/threshold + histogram plots")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    bw = args.bandwidth
    res = proc_wav_file(
        args.wav,
        block_duration_sec=args.block_duration,
        freq_band=(args.signal_freq - bw, args.signal_freq + bw),
        noise_band=(args.noise_freq - bw, args.noise_freq + bw),
        n_fft=args.n_fft,
        threshold_std_factor=args.threshold_std_factor,
        wav_start_sec=args.start_sec,
        wav_end_sec=args.end_sec,
        out_csv_file=args.out_csv,
        out_audacity_lbl_file=args.out_audacity,
        outfile_path=args.out_spec_dir,
        wav_start_date_time=parse_gqrx_start_time(args.wav),
        flag_adaptive_threshold=not args.fixed_threshold,
        expected_sample_rate=args.sample_rate,
        device=args.device,
    )
    if args.plot_dir:
        for w in export_debug_plots(res, args.plot_dir):
            print("wrote", w)
    print(f"Found {len(res.detections)} detections")
    print(res.timer.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
