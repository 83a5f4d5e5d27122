"""What the two drivers of the live detector share: the port's
``DetectionConfig`` from a configuration file, the events' fields on the
host, and the reference run over one station's levels."""

from __future__ import annotations

import numpy as np

from bench_h100.reference import detectors, fronts

EVENT_FIELDS = ("time_start", "time_stop", "duration", "db_min", "db_max", "db_mean", "db_std")


def detection_config(config: dict):
    from meteor_scatter_tpu_torch.config import DetectionConfig

    return DetectionConfig(**config["detection"])


def bands(det: dict) -> tuple:
    half = det["channel_width"] / 2.0
    f, off = det["signal_freq"], det["noise_channel_offset"]
    return ((f - half, f + half), (f - off - half, f - off + half), (f + off - half, f + off + half))


def over_noise(config: dict, x, fs: float, precision: str) -> np.ndarray:
    """The reference's level over noise of audio ``x`` (..., n)."""
    det = config["detection"]
    block = int(round(det["proc_block_sec"] * fs))
    return fronts.over_noise_db(x, fs, det["n_fft"], block, *bands(det), nperseg=det["welch_nperseg"],
                                precision=precision)


def stream_reference(config: dict, on: np.ndarray):
    det = config["detection"]
    return detectors.stream_detect(
        on, det["proc_block_sec"], int(det["avg_win_sec"] / det["proc_block_sec"]),
        det["init_detection_wait_sec"], det["after_tracking_wait_sec"],
        det["threshold_std_factor"], det["detection_db_over_noise_mean_min"],
        det["detection_dur_min_sec"], config["tie_db"])


def event_tuple(e) -> tuple:
    """A reference event as the comparison takes it: first and stop block,
    then minimum, maximum, mean and std in dB."""
    return (e.start_block, e.stop_block, e.db_min, e.db_max, e.db_mean, e.db_std)


def host_events(fields: np.ndarray, block_sec: float) -> list:
    """The program's events, (7, n) in :data:`EVENT_FIELDS` order, as the
    comparison takes them: times become block indices."""
    return [(int(round(fields[0, i] / block_sec)), int(round(fields[1, i] / block_sec)),
             *(float(v) for v in fields[3:7, i])) for i in range(fields.shape[1])]
