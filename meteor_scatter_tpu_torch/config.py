"""Configuration of the port's detectors and segment monitor.

The port's own copy of the dataclasses it uses from
`meteor_scatter_tpu/config.py` (the port imports nothing of the JAX
package): same names, fields, defaults and band properties, so one
configuration drives both packages.  Parameter names mirror the reference
(`dsp/src/live/backend/aggregates.py:33-63`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DetectionConfig:
    """Streaming detector (reference: dsp/src/live/backend/aggregates.py:33-44).

    Field names and defaults match ``ConfigDetection`` one-to-one.
    """

    proc_block_sec: float = 0.2
    n_fft: int = 4096
    signal_freq: float = 1000.0
    channel_width: float = 100.0
    noise_channel_offset: float = 300.0
    avg_win_sec: float = 8.0
    init_detection_wait_sec: float = 8.0
    after_tracking_wait_sec: float = 12.0
    threshold_std_factor: float = 4.0
    detection_db_over_noise_mean_min: float = -1.0
    detection_dur_min_sec: float = -1.0
    # capacity of the on-device event buffer per processed chunk
    max_events: int = 1024
    # Welch segment length; scipy's default nperseg=256 is what the reference
    # implicitly uses (`processor.py:206` passes only nfft).
    welch_nperseg: int = 256

    @property
    def signal_band(self) -> Tuple[float, float]:
        half = self.channel_width / 2.0
        return (self.signal_freq - half, self.signal_freq + half)

    @property
    def noise_band_1(self) -> Tuple[float, float]:
        half = self.channel_width / 2.0
        c = self.signal_freq - self.noise_channel_offset
        return (c - half, c + half)

    @property
    def noise_band_2(self) -> Tuple[float, float]:
        half = self.channel_width / 2.0
        c = self.signal_freq + self.noise_channel_offset
        return (c - half, c + half)


@dataclass(frozen=True)
class VisualizationConfig:
    """Waterfall / UI parameters (reference: aggregates.py:48-56)."""

    enable_ui_plots: bool = False
    realtime_factor: float = 16.0
    flag_realtime_animation: bool = True
    max_range_sec: int = 60
    limit_freq_offset_wf2_and_export: int = 100
    wf_offset_vmin: int = 20
    wf_offset_vmax: int = 20
    enable_debug_logs: bool = False


@dataclass(frozen=True)
class SpecExportConfig:
    """Per-event spectrogram export (reference: aggregates.py:60-63)."""

    output_dir: str = ""
    time_before_meteor_sec: int = 3
    time_after_meteor_sec: int = 3


@dataclass(frozen=True)
class MonitorConfig:
    """Live segment monitor (reference: meteor_detect_class/prime_detection.py:17-28)."""

    sample_rate: int = 5000
    segment_len_sec: int = 30
    n_fft: int = 2048
    spec_cut_factor: float = 8.0  # C_MS_SPEC_CUT_FACTOR
    cluster_epsilon: float = 30.0  # C_MS_CLUSTER_EPSILON (px)
    cluster_min_samples: int = 5  # C_MS_CLUSTER_MIN_SAMPLES
    critical_min_width_px: float = 5.0  # detector_and_classification.py:50
    keypoint_mode: str = "threshold"  # or "corner" (ORB-like Harris keypoints)
    noise_floor_band: Tuple[float, float] = (250.0, 800.0)  # prime_detection.py:69-71
    display_band: Tuple[float, float] = (800.0, 1200.0)  # prime_detection.py:89
    csv_out_dir: str = "csv-out"
    spec_out_dir: str = "spec-out"
    save_interval_min: float = 59.8  # prime_detection.py:109
