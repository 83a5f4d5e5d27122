"""Configuration of the port's streaming detector.

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
