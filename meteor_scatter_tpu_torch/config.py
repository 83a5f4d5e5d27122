"""Typed configuration tree of the port.

The port's own copy of `meteor_scatter_tpu/config.py` (the port imports
nothing of the JAX package): the same dataclasses with the same names,
fields, defaults and band properties, and the same flat INI round trip
(`to_ini` / `from_ini`), so one configuration file drives both packages
and `to_ini` writes the same text.  Parameter names and defaults mirror the
reference (`config.ini` + `config.py:31-58` for the webserver,
`dsp/src/live/backend/aggregates.py:27-63` for the streaming pipeline,
`meteor_detect_class/prime_detection.py:17-28` for the monitor): block
0.2 s, sigma-factor 4, 120 s estimation window, 8 s averaging window, ...
"""

from __future__ import annotations

import configparser
import dataclasses
import io as _io
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class BandPowerConfig:
    """Framed band-power extraction (reference: dsp/src/main.py:353-393).

    ``n_fft`` here is the *effective* FFT length.  The reference CLI doubles
    the user-supplied n_fft (`main.py:353`); the app layer in
    :mod:`meteor_scatter_tpu_torch.apps.analyze` reproduces that doubling so that
    configs written for the reference behave identically.
    """

    sample_rate: int = 6000
    block_duration_sec: float = 0.2
    n_fft: int = 1024
    # (f_lo, f_hi) in Hz, inclusive on both ends like the reference masks
    # (`main.py:382,386`:  freqs >= lo  &  freqs <= hi).
    freq_band: Tuple[float, float] = (993.0, 1013.0)
    noise_band: Tuple[float, float] = (690.0, 710.0)
    # Power floor added before log10 (`main.py:383,387`).
    power_floor: float = 1e-12

    @property
    def block_size(self) -> int:
        return int(self.sample_rate * self.block_duration_sec)


@dataclass(frozen=True)
class AnalyzeConfig:
    """Batch analyzer parameters (reference: dsp/src/main.py:207-229).

    Same knobs as ``proc_wav_file`` keyword arguments.
    """

    band: BandPowerConfig = field(default_factory=BandPowerConfig)
    threshold_std_factor: float = 4.0
    flag_adaptive_threshold: bool = True
    threshold_estimation_window_sec: float = 120.0
    threshold_freeze_before_detection_sec: float = 3.0
    threshold_freeze_after_detection_sec: float = 20.0
    threshold_fixed_init_duration_sec: float = 10.0
    # Fixed capacity of the on-device event buffer (the reference grows a
    # Python list; static shapes require a cap — overflow is reported).
    max_events: int = 4096


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
class ShardingConfig:
    """Mesh layout for multi-chip execution (new; no reference equivalent —
    the reference is single-process CPU, see SURVEY.md §2.6)."""

    # Mesh axis names: stations/channels are purely data parallel; time
    # shards a single long stream with halo exchange at the seams.
    station_axis: str = "station"
    time_axis: str = "time"
    n_station_shards: int = 1
    n_time_shards: int = 1
    # Warm-up halo carried into each time shard so the adaptive threshold's
    # rolling statistics converge before the shard's own samples begin
    # (threshold_estimation_window_sec + freeze_after covers the reach of
    # the reference's sequential recurrence, main.py:450-522).
    warmup_halo_sec: float = 140.0


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


@dataclass(frozen=True)
class DashboardConfig:
    """Web dashboard (reference: config.py:31-58 + config.ini)."""

    debug: bool = False
    schedule_interval_min: float = 2.0
    csv_folder: str = "csv_files"
    csv_storage_path: str = "final_dataframe.csv"
    gauge_lower: float = 0.0
    gauge_upper: float = 100.0
    reload_interval_ms: int = 150000
    slideshow_interval_ms: int = 10000
    host: str = "0.0.0.0"
    port: int = 5000


# ---------------------------------------------------------------------------
# INI round-trip
# ---------------------------------------------------------------------------

_SECTIONS = {
    "bandpower": BandPowerConfig,
    "analyze": AnalyzeConfig,
    "detection": DetectionConfig,
    "visualization": VisualizationConfig,
    "spec_export": SpecExportConfig,
    "sharding": ShardingConfig,
    "monitor": MonitorConfig,
    "dashboard": DashboardConfig,
}


@dataclass(frozen=True)
class FrameworkConfig:
    """Top-level config tree; one INI file covers every subsystem."""

    bandpower: BandPowerConfig = field(default_factory=BandPowerConfig)
    analyze: AnalyzeConfig = field(default_factory=AnalyzeConfig)
    detection: DetectionConfig = field(default_factory=DetectionConfig)
    visualization: VisualizationConfig = field(default_factory=VisualizationConfig)
    spec_export: SpecExportConfig = field(default_factory=SpecExportConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    monitor: MonitorConfig = field(default_factory=MonitorConfig)
    dashboard: DashboardConfig = field(default_factory=DashboardConfig)


def _coerce(value: str, target):
    """Typed coercion driven by the field's current value, mirroring the
    fallback-driven coercion of the reference's `config.py:92-117`."""
    if isinstance(target, bool):
        return value.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(target, int) and not isinstance(target, bool):
        return int(float(value))
    if isinstance(target, float):
        return float(value)
    if isinstance(target, tuple):
        parts = [p for p in value.replace("(", "").replace(")", "").split(",") if p.strip()]
        return tuple(type(t)(float(p)) for p, t in zip(parts, target))
    return value


def to_ini(cfg: FrameworkConfig) -> str:
    parser = configparser.ConfigParser()
    for section in _SECTIONS:
        sub = getattr(cfg, section)
        parser[section] = {}
        for f in dataclasses.fields(sub):
            v = getattr(sub, f.name)
            if isinstance(v, tuple):
                v = ",".join(str(x) for x in v)
            elif dataclasses.is_dataclass(v):
                continue  # nested configs serialize via their own section
            parser[section][f.name] = str(v)
    buf = _io.StringIO()
    parser.write(buf)
    return buf.getvalue()


def from_ini(text: str) -> FrameworkConfig:
    parser = configparser.ConfigParser()
    parser.read_string(text)
    kwargs = {}
    for section, cls in _SECTIONS.items():
        defaults = cls() if cls is not AnalyzeConfig else AnalyzeConfig()
        if section not in parser:
            kwargs[section] = defaults
            continue
        sub_kwargs = {}
        for f in dataclasses.fields(cls):
            cur = getattr(defaults, f.name)
            if dataclasses.is_dataclass(cur):
                continue
            if f.name in parser[section]:
                sub_kwargs[f.name] = _coerce(parser[section][f.name], cur)
        if cls is AnalyzeConfig and "bandpower" in parser:
            sub_kwargs["band"] = kwargs.get("bandpower", BandPowerConfig())
        kwargs[section] = cls(**sub_kwargs)
    # analyze.band shares the [bandpower] section
    if "bandpower" in kwargs and "analyze" in kwargs:
        kwargs["analyze"] = dataclasses.replace(kwargs["analyze"], band=kwargs["bandpower"])
    return FrameworkConfig(**kwargs)


def load_config(path: str) -> FrameworkConfig:
    with open(path, "r") as fh:
        return from_ini(fh.read())


def save_config(cfg: FrameworkConfig, path: str) -> None:
    with open(path, "w") as fh:
        fh.write(to_ini(cfg))
