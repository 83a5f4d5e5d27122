"""High-rate SDR front end on PyTorch: wideband capture → channelizer →
per-channel band-power detection (BASELINE configs 3 and 4) — counterpart
of `meteor_scatter_tpu/apps/frontend.py`.

A multi-MS/s real or complex (I/Q) capture is mixed against each beacon
channel and polyphase-decimated to the analysis rate on the device
(:func:`meteor_scatter_tpu_torch.ops.fir.channelize`: one float32 product
for all channels), resampled to the exact audio rate where the rates are
not an integer ratio, and pushed through band power and the adaptive
detector, all channels at once.

Synthetic demo::

    python -m meteor_scatter_tpu_torch.apps.frontend --stations 8 --seconds 30 [--iq] --device cuda

``detect_channels(mesh=...)`` runs the detection over a (station, time)
mesh (:mod:`meteor_scatter_tpu_torch.parallel`).
"""

from __future__ import annotations

import argparse
from fractions import Fraction
from typing import Sequence, Tuple

import numpy as np
import torch

from meteor_scatter_tpu_torch.device import DeviceLike, constant_on, resolve_device
from meteor_scatter_tpu_torch.models.adaptive import adaptive_thresholds_parallel
from meteor_scatter_tpu_torch.models.events import Events, events_from_mask
from meteor_scatter_tpu_torch.ops.bandpower import band_power_db, band_projection_matrix
from meteor_scatter_tpu_torch.ops.fir import (
    channel_bank_plan,
    channelize_frames,
    channelize_iq_frames,
    channelize_iq_interleaved,
    frame_capture,
    frame_capture_host,
    is_interleaved_iq,
    resample_poly,
)
from meteor_scatter_tpu_torch.ops.framing import frame_signal
from meteor_scatter_tpu_torch.parallel.sharded import sharded_delta_power, sharded_detect_adaptive
from meteor_scatter_tpu_torch.utils.timing import span, spanned

TONE_FREQ = 1003.0  # audio-domain beacon tone (main.py:827)


def _stages(fs_i: int, audio_rate: int, channel_bandwidth: float) -> Tuple[int, int, int]:
    """(channelizer decimation, resample up, resample down).  One stage when
    ``fs`` is a multiple of ``audio_rate``; otherwise an integer decimation
    to an intermediate rate comfortably above the channel bandwidth, then a
    rational polyphase resample to the exact audio rate (2 MS/s → /200 →
    10 kHz → ×3/5 → 6 kHz)."""
    if fs_i % audio_rate == 0:
        return fs_i // audio_rate, 1, 1
    decim1 = max(int(fs_i // (4 * channel_bandwidth)), 1)
    frac = Fraction(audio_rate * decim1, fs_i)
    return decim1, frac.numerator, frac.denominator


def _bank(x, x_im, fs, centers, channel_bandwidth, decim, numtaps, device) -> torch.Tensor:
    """The channelizer stage of :func:`iq_frontend`: (C, S / decim) real
    channel audio.  A numpy capture is framed on the host (a free copy) and
    uploaded framed to ``device``; a tensor capture is framed on its own
    device.  Both give the bits of ``channelize`` / ``channelize_iq`` on
    the capture, but for a tensor I/Q capture whose I and Q interleave in
    one complex64 buffer: that one is read in place, I and Q in one product
    (``channelize_iq_interleaved``), and agrees with them to float32
    rounding."""
    host = isinstance(x, np.ndarray) and (x_im is None or isinstance(x_im, np.ndarray))
    dev = resolve_device(device) if host else x.device
    plan, tables = channel_bank_plan(
        x.shape[-1], fs, centers, bandwidth=channel_bandwidth, decim=decim, numtaps=numtaps,
        device=dev,
    )
    with span("channelize"):
        if is_interleaved_iq(x, x_im):
            return channelize_iq_interleaved(x, tables, plan)[0]
        if x_im is not None:
            x = np.stack([x, x_im]) if host else torch.stack([x, x_im])
        if host:
            f = torch.from_numpy(frame_capture_host(x, plan)).to(dev)
        else:
            f = frame_capture(x, plan)
        if x_im is None:
            return 2.0 * channelize_frames(f, tables, plan)[0]
        return channelize_iq_frames(f, tables, plan)[0]


@spanned("iq_frontend")
def iq_frontend(
    x,  # (S,) real wideband capture, or I of a complex capture when x_im given
    fs: float,
    station_freqs: Sequence[float],
    audio_rate: int = 6000,
    tone_freq: float = TONE_FREQ,
    channel_bandwidth: float = 2500.0,
    numtaps: int = 513,
    x_im=None,  # (S,) Q component of a complex capture (optional)
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Wideband capture → (n_stations, S_audio) audio-rate channels.

    ``x`` (and ``x_im``) are numpy arrays, framed on the host and uploaded
    to ``device``, or tensors, which stay on their device.

    Each station's carrier is mixed so its beacon lands at ``tone_freq``
    in the channel's audio output, matching the rates/frequencies the
    detectors are configured for.

    Real capture (``x_im is None``): mixing to ``f_c - tone_freq`` and
    taking 2·Re of the filtered complex baseband keeps the single remaining
    sideband as a real tone at ``tone_freq`` (2× because the real tone
    splits its amplitude across ±f_c).

    Complex I/Q capture (``x_im`` given): the same chain through
    :func:`channelize_iq`; station offsets may be negative (the lower half
    of the captured span), and Re alone suffices — a complex exponential
    carries full amplitude in one sideband.
    """
    centers = np.asarray(station_freqs, dtype=np.float64) - tone_freq
    decim, up, down = _stages(int(round(fs)), audio_rate, channel_bandwidth)
    audio = _bank(x, x_im, fs, centers, channel_bandwidth, decim, numtaps, device)
    with span("resample"):
        return resample_poly(audio, up, down)


@spanned("detect_channels")
def detect_channels(
    audio: torch.Tensor,  # (C, S) at audio_rate
    audio_rate: int = 6000,
    n_fft: int = 1024,
    block_duration_sec: float = 0.2,
    tone_freq: float = TONE_FREQ,
    bandwidth: float = 10.0,
    noise_freq: float = 700.0,
    threshold_std_factor: float = 4.0,
    threshold_estimation_window_sec: float = 120.0,
    threshold_freeze_before_sec: float = 3.0,
    threshold_freeze_after_sec: float = 20.0,
    threshold_fixed_init_sec: float = 10.0,
    mesh=None,
    cap: int = 512,
) -> Tuple[Events, torch.Tensor]:
    """Per-channel adaptive detection, every channel at once: band power as
    one product, the adaptive detector over the (C, B) delta series, events
    row by row.  Without a mesh it runs on ``audio``'s device with the
    fixpoint solver; with a (station, time) mesh
    (:func:`~meteor_scatter_tpu_torch.parallel.mesh.make_mesh`) through
    ``sharded_delta_power`` and the warm-started ``sharded_detect_adaptive``,
    with the results on the mesh's first device.  Returns (events with
    fields (C, cap) and count / overflow (C,), delta (C, B))."""
    block = int(audio_rate * block_duration_sec)
    fb = (tone_freq - bandwidth, tone_freq + bandwidth)
    nb = (noise_freq - bandwidth, noise_freq + bandwidth)
    kw = dict(
        threshold_std_factor=threshold_std_factor,
        window_blocks=int(threshold_estimation_window_sec / block_duration_sec),
        freeze_blocks_before=int(threshold_freeze_before_sec / block_duration_sec),
        freeze_blocks_after=int(threshold_freeze_after_sec / block_duration_sec),
        fixed_threshold_blocks=int(threshold_fixed_init_sec / block_duration_sec),
    )
    if mesh is not None:
        with span("band_power"):
            _, _, delta = sharded_delta_power(audio, mesh, audio_rate, n_fft, block, fb, nb)
        with span("detect"):
            _, above = sharded_detect_adaptive(delta, mesh, **kw)
    else:
        with span("band_power"):
            M, slices = band_projection_matrix(audio_rate, n_fft, block, [fb, nb])
            frames = frame_signal(audio.to(torch.float32), block, block)
            band, noise = band_power_db(frames, constant_on(M, audio.device), slices)
            delta = band - noise
        with span("detect"):
            _, above = adaptive_thresholds_parallel(delta, **kw)
    with span("events"):
        return events_from_mask(above, delta, cap=cap), delta


def _burst_span(t: np.ndarray, t0: float, dur: float) -> slice:
    """The samples with ``t0 <= t < t0 + dur``: one contiguous run, since
    ``t`` is increasing — the reference's boolean mask as a slice."""
    return slice(int(np.searchsorted(t, t0, "left")), int(np.searchsorted(t, t0 + dur, "left")))


def synth_wideband(
    fs: float,
    seconds: float,
    station_freqs: Sequence[float],
    bursts_per_station: int = 2,
    seed: int = 0,
) -> Tuple[np.ndarray, list]:
    """Synthetic 2 MS/s-style capture: broadband noise + per-station beacon
    bursts.  Returns (capture, truth) with truth[(c)] = list of (t0, dur).
    The same bits as the reference package's."""
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    x = rng.standard_normal(n).astype(np.float32) * 0.1
    t = np.arange(n) / fs
    truth = []
    for c, fc in enumerate(station_freqs):
        events = []
        for b in range(bursts_per_station):
            t0 = 1.0 + (seconds - 3.0) * (b + 0.3 * (c + 1) / len(station_freqs)) / bursts_per_station
            dur = 0.6 + 0.4 * b
            m = _burst_span(t, t0, dur)
            x[m] += 0.5 * np.sin(2 * np.pi * fc * t[m]).astype(np.float32)
            events.append((t0, dur))
        truth.append(events)
    return x, truth


def synth_wideband_iq(
    fs: float,
    seconds: float,
    station_freqs: Sequence[float],
    bursts_per_station: int = 2,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, list]:
    """Complex (I/Q) variant of :func:`synth_wideband`: station offsets span
    the full ±fs/2 capture (negative offsets allowed), beacons are complex
    exponentials.  Returns (x_re, x_im, truth)."""
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    x_re = rng.standard_normal(n).astype(np.float32) * 0.1
    x_im = rng.standard_normal(n).astype(np.float32) * 0.1
    t = np.arange(n) / fs
    truth = []
    for c, fc in enumerate(station_freqs):
        events = []
        for b in range(bursts_per_station):
            t0 = 1.0 + (seconds - 3.0) * (b + 0.3 * (c + 1) / len(station_freqs)) / bursts_per_station
            dur = 0.6 + 0.4 * b
            m = _burst_span(t, t0, dur)
            ph = 2 * np.pi * fc * t[m]
            x_re[m] += 0.5 * np.cos(ph).astype(np.float32)
            x_im[m] += 0.5 * np.sin(ph).astype(np.float32)
            events.append((t0, dur))
        truth.append(events)
    return x_re, x_im, truth


def station_freqs(stations: int, base_freq: float, spacing: float, iq: bool) -> list:
    """The CLI's station layout: a real capture's stations from
    ``base_freq`` up in steps of ``spacing``; an I/Q capture's centered on
    0 Hz, with half a step for the one that would sit at 0."""
    if iq:
        half = stations // 2
        return [spacing * (i - half) or spacing / 2 for i in range(stations)]
    return [base_freq + i * spacing for i in range(stations)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--fs", type=float, default=2_000_000.0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--stations", type=int, default=8)
    p.add_argument("--base-freq", type=float, default=100_000.0)
    p.add_argument("--spacing", type=float, default=50_000.0)
    p.add_argument("--iq", action="store_true",
                   help="complex I/Q capture; stations centered on 0 Hz "
                        "(negative offsets use the lower half of the span)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    freqs = station_freqs(args.stations, args.base_freq, args.spacing, args.iq)
    if args.iq:
        print(f"Synthesizing IQ {args.seconds}s @ {args.fs / 1e6:.1f} MS/s, "
              f"{args.stations} stations at {[f / 1e3 for f in freqs]} kHz")
        x_re, x_im, truth = synth_wideband_iq(args.fs, args.seconds, freqs)
        audio = iq_frontend(x_re, args.fs, freqs, x_im=x_im, device=args.device)
    else:
        print(f"Synthesizing {args.seconds}s @ {args.fs / 1e6:.1f} MS/s, {args.stations} stations")
        x, truth = synth_wideband(args.fs, args.seconds, freqs)
        audio = iq_frontend(x, args.fs, freqs, device=args.device)
    print(f"Channelized to {tuple(audio.shape)} @ 6 kHz")
    events, _ = detect_channels(audio)
    ev = Events(*(f.cpu() for f in events))
    for c in range(args.stations):
        cnt = int(ev.count[c])
        spans = [
            f"[{float(ev.start[c, i]) * 0.2:.1f},{float(ev.stop[c, i]) * 0.2:.1f}]s"
            for i in range(cnt)
        ]
        print(f"station {c} ({freqs[c] / 1e3:.0f} kHz): {cnt} events {spans} "
              f"(truth: {[(round(t0, 1), round(d, 1)) for t0, d in truth[c]]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
