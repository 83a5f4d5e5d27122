"""Streaming detector CLI on PyTorch — counterpart of
`meteor_scatter_tpu/apps/live.py` (reference: `dsp/src/live/main.py` and
`processor.py:14`, ``wav_file_process``).

Audio is consumed in chunks (bounded memory, like the reference's block
loop); each chunk's band levels are computed as one batched tensor program
on the chosen device and the 3-state decision machine runs over the
chunk's blocks — on a GPU as one launch of the hand-written CUDA kernel
``csrc/stream_machine.cu``.

Usage::

    python -m meteor_scatter_tpu_torch.apps.live recording.wav \\
        --signal-freq 1020 --min-dur 0.5 --min-mean-db 1 --device cuda

Not yet ported: ``--ui`` (the live matplotlib dashboard) and
``--spec-export-dir`` (per-event waterfall PNGs); both raise, and so do the
episode-jump solvers ``--impl jump|hop``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from meteor_scatter_tpu_torch.config import DetectionConfig, SpecExportConfig, VisualizationConfig
from meteor_scatter_tpu_torch.device import DeviceLike, resolve_device
from meteor_scatter_tpu_torch.io.wavio import read_wav
from meteor_scatter_tpu_torch.models.streaming import (
    StreamConfig,
    StreamEvents,
    stream_init,
    stream_process,
)

NOT_PORTED = "is not yet ported to meteor_scatter_tpu_torch (use meteor_scatter_tpu.apps.live)"
EVENT_FIELDS = StreamEvents._fields[:7]


class LiveSession:
    """Stateful wrapper: feed audio chunks, collect DetectedMeteor dicts.

    The detection state stays on ``device`` between chunks; only each
    chunk's completed events cross to the host.  The reference package's
    waterfall ring and export queue serve the UI and the spectrogram
    export, which are not yet ported: asking for either raises.
    """

    def __init__(
        self,
        cfg: DetectionConfig,
        fs: float,
        vis: Optional[VisualizationConfig] = None,
        spec: Optional[SpecExportConfig] = None,
        headless: bool = False,
        impl: str = "auto",
        device: DeviceLike = "cuda",
    ):
        if vis is not None and vis.enable_ui_plots:
            raise NotImplementedError(f"the live UI (--ui) {NOT_PORTED}")
        if spec is not None and spec.output_dir:
            raise NotImplementedError(f"spectrogram export (--spec-export-dir) {NOT_PORTED}")
        self.cfg = cfg
        self.fs = fs
        self.device = resolve_device(device)
        # bins-only front half (no PSD waterfall), an opt-in throughput mode
        # (models/streaming.py stream_front_headless)
        self.headless = headless
        # block-rate solver: "auto" (fused on a GPU, scan on the CPU, see
        # models/streaming.py resolve_stream_auto), "scan" or "fused"
        self.impl = impl
        self.state = stream_init(StreamConfig.from_config(cfg), self.device)
        self.block_samples = int(round(cfg.proc_block_sec * fs))
        self.events: List[dict] = []

    def feed(self, samples: np.ndarray) -> List[dict]:
        """Process a chunk (any whole number of blocks).  Returns events
        completed within this chunk."""
        n_blocks = len(samples) // self.block_samples
        if n_blocks == 0:
            return []
        usable = n_blocks * self.block_samples
        x = torch.as_tensor(np.asarray(samples[:usable], dtype=np.float32)).to(self.device)
        self.state, events, _ = stream_process(
            self.cfg, self.state, x, self.fs,
            front="bins" if self.headless else "welch",
            impl=self.impl,
        )

        cnt = int(events.count)
        host = {f: getattr(events, f)[:cnt].cpu().numpy() for f in EVENT_FIELDS}
        new = [{f: float(host[f][i]) for f in EVENT_FIELDS} for i in range(cnt)]
        self.events.extend(new)
        if bool(events.overflow):
            print("WARNING: per-chunk event buffer overflow")
        return new


def wav_file_process(
    wav_file_path: str,
    config_detection: DetectionConfig,
    config_visualization: Optional[VisualizationConfig] = None,
    config_spec_export: Optional[SpecExportConfig] = None,
    wav_file_start_sec: float = 0,
    wav_file_stop_sec: float = -1,
    chunk_sec: float = 60.0,
    expected_sample_rate: Optional[int] = 4000,
    headless: bool = False,
    impl: str = "auto",
    device: DeviceLike = "cuda",
) -> List[dict]:
    """Reference-compatible entry point (`processor.py:14-21`), plus the
    ``device`` to run on ("cuda" raises when no GPU is usable)."""
    fs, data = read_wav(wav_file_path, mono=True)
    if expected_sample_rate is not None and fs != expected_sample_rate:
        raise ValueError(f"Invalid Sample Rate: {fs}")
    s = int(wav_file_start_sec * fs)
    e = len(data) if wav_file_stop_sec == -1 else int(wav_file_stop_sec * fs)
    data = data[s:e]
    if data.dtype == np.int16:
        # match soundfile.read's float scaling for PCM input (exact: a
        # power-of-two divisor)
        data = data.astype(np.float32) / 32768.0
    data = np.asarray(data, dtype=np.float32)

    sess = LiveSession(config_detection, fs, config_visualization, config_spec_export,
                       headless=headless, impl=impl, device=device)
    chunk = int(chunk_sec * fs)
    chunk -= chunk % sess.block_samples
    # a chunk_sec below one processing block would round to zero — feed at
    # least one whole block per chunk
    chunk = max(chunk, sess.block_samples)
    for i in range(0, len(data), chunk):
        for ev in sess.feed(data[i : i + chunk]):
            print(
                f"Detected Meteor: start={ev['time_start']:.2f}s stop={ev['time_stop']:.2f}s "
                f"dur={ev['duration']:.2f}s dB mean={ev['db_mean']:.2f} "
                f"min={ev['db_min']:.2f} max={ev['db_max']:.2f} std={ev['db_std']:.2f} "
                f"// total {len(sess.events)}"
            )
    return sess.events


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("wav")
    p.add_argument("--signal-freq", type=float, default=1000.0)
    p.add_argument("--channel-width", type=float, default=100.0)
    p.add_argument("--noise-offset", type=float, default=300.0)
    p.add_argument("--block-sec", type=float, default=0.2)
    p.add_argument("--n-fft", type=int, default=4096)
    p.add_argument("--min-dur", type=float, default=-1.0)
    p.add_argument("--min-mean-db", type=float, default=-1.0)
    p.add_argument("--start-sec", type=float, default=0.0)
    p.add_argument("--stop-sec", type=float, default=-1.0)
    p.add_argument("--sample-rate", type=int, default=None)
    p.add_argument("--spec-export-dir", default="", help="not yet ported; raises")
    p.add_argument("--ui", action="store_true", help="not yet ported; raises")
    p.add_argument("--realtime-factor", type=float, default=16.0,
                   help="pace of the live UI (not yet ported)")
    p.add_argument("--headless", action="store_true",
                   help="bins-only front half (no PSD waterfall); band numerics "
                        "within f32 noise of the Welch path")
    p.add_argument("--impl", choices=("auto", "scan", "jump", "hop", "fused"), default="auto",
                   help="block-rate solver: 'scan' (the plain PyTorch machine), "
                        "'fused' (the CUDA kernel on a GPU, bit-exact vs scan), or "
                        "'auto' (fused on a GPU, scan on the CPU); 'jump' and 'hop' "
                        "are not yet ported and raise")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.headless and (args.ui or args.spec_export_dir):
        p.error("--headless excludes --ui and --spec-export-dir (both need the PSD waterfall)")
    if args.ui:
        raise NotImplementedError(f"--ui (the live dashboard) {NOT_PORTED}")
    if args.spec_export_dir:
        raise NotImplementedError(f"--spec-export-dir (per-event waterfall PNGs) {NOT_PORTED}")
    if args.impl in ("jump", "hop"):
        raise NotImplementedError(f"--impl {args.impl} (episode-jump solver) {NOT_PORTED}")

    cfg = DetectionConfig(
        proc_block_sec=args.block_sec,
        n_fft=args.n_fft,
        signal_freq=args.signal_freq,
        channel_width=args.channel_width,
        noise_channel_offset=args.noise_offset,
        detection_dur_min_sec=args.min_dur,
        detection_db_over_noise_mean_min=args.min_mean_db,
    )
    events = wav_file_process(
        args.wav,
        cfg,
        config_visualization=VisualizationConfig(realtime_factor=args.realtime_factor),
        wav_file_start_sec=args.start_sec,
        wav_file_stop_sec=args.stop_sec,
        expected_sample_rate=args.sample_rate,
        headless=args.headless,
        impl=args.impl,
        device=args.device,
    )
    print(f"Total detected meteors: {len(events)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
