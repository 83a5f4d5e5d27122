"""Batch WAV analyzer on PyTorch — counterpart of
`meteor_scatter_tpu/apps/analyze.py` (reference: `dsp/src/main.py:207-806`,
``proc_wav_file``) with the same outputs: console detections, Audacity
pre-labels and the event CSV.

The whole file is one tensor program on the chosen device: framing → band
projection matmul → adaptive (or fixed) detection → fixed-capacity events.
On a GPU the adaptive detector runs the hand-written CUDA kernel
``csrc/adaptive_solver.cu``.

Usage::

    python -m meteor_scatter_tpu_torch.apps.analyze recording.wav \\
        --signal-freq 1003 --noise-freq 700 --bandwidth 10 \\
        --out-csv events.csv --out-audacity prelbl.txt --device cuda

Filename → UTC start-time parsing supports the reference's gqrx pattern
``*_gqrx_YYYYMMDD_HHMMSS_<freq>.wav`` (`main.py:858-863`).

Not yet ported: ``--out-spec-dir`` (per-detection spectrogram images) and
``--plot-dir`` (debug plots); both raise.
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
from meteor_scatter_tpu_torch.io.wavio import read_wav
from meteor_scatter_tpu_torch.models.adaptive import detect_adaptive
from meteor_scatter_tpu_torch.models.fixed import detect_fixed
from meteor_scatter_tpu_torch.ops.bandpower import delta_power_db
from meteor_scatter_tpu_torch.utils.timing import PhaseTimer

NOT_PORTED = "is not yet ported to meteor_scatter_tpu_torch (use meteor_scatter_tpu.apps.analyze)"


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


def parse_gqrx_start_time(file_path: str) -> Optional[datetime.datetime]:
    """UTC start time from gqrx-style filenames (`main.py:858-863`)."""
    name = os.path.basename(file_path)
    m = re.search(r"(\d{8})_(\d{6})", name)
    if m:
        return datetime.datetime.strptime(m.group(1) + "-" + m.group(2), "%Y%m%d-%H%M%S")
    return None


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
    ``outfile_path`` (spectrogram export) is not yet ported and raises."""
    if outfile_path:
        raise NotImplementedError(f"spectrogram export (outfile_path / --out-spec-dir) {NOT_PORTED}")
    dev = resolve_device(device)
    timer = PhaseTimer(log=False)

    with timer.phase("read_wav"):
        fs, data = read_wav(file_path, mono=True)
    if expected_sample_rate is not None and fs != expected_sample_rate:
        raise ValueError(f"Sample rate must be {expected_sample_rate} Hz, got {fs}")

    if wav_start_sec is not None or wav_end_sec is not None:
        s = int((wav_start_sec or 0) * fs)
        e = int((wav_end_sec if wav_end_sec is not None else len(data) / fs) * fs)
        data = data[s:e]

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
        x = torch.from_numpy(data).to(dev).to(torch.float32)
        band_db, noise_db, delta = delta_power_db(
            x, fs, n_fft_eff, block_size, freq_band, noise_band
        )
        del x
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
            torch.cuda.synchronize(dev)

    dets = events_to_detections(events, block_duration_sec, wav_start_date_time)
    if bool(events.overflow):
        print(f"WARNING: event buffer overflow — more than {max_events} events, extras dropped")

    if verbose:
        for det in dets:
            print(
                f"Detection from {det.t_start:.2f} to {det.t_stop:.2f} seconds, "
                f"dB: {det.dB:.2f} dB, duration: {det.dur_s:.2f} seconds "
                f"UTC_START: {det.utc_start}, UTC_STOP: {det.utc_stop}"
            )

    if out_audacity_lbl_file:
        write_audacity_labels(out_audacity_lbl_file, dets)
        print("Wrote Items", len(dets), "to Audacity LBL file")
    if out_csv_file:
        write_event_csv(out_csv_file, dets)
        print("Wrote Items", len(dets), "to CSV file:", out_csv_file)

    return AnalyzeResult(
        detections=dets,
        band_power=band_db.cpu().numpy(),
        noise_power=noise_db.cpu().numpy(),
        delta_power=delta.cpu().numpy(),
        thresholds=thresholds.cpu().numpy(),
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
    p.add_argument("--out-spec-dir", default=None, help="not yet ported; raises")
    p.add_argument("--plot-dir", default=None, help="not yet ported; raises")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.plot_dir:
        raise NotImplementedError(f"--plot-dir (debug plots) {NOT_PORTED}")

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
    print(f"Found {len(res.detections)} detections")
    print(res.timer.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
