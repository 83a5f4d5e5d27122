"""Audio made from the seed: receiver noise with meteor echoes of the
beacon tone, the same on every call with the same seed and device.

Every seed gets the same set of echoes: each channel has the same number,
spread one to each equal slot of its stream, and the same grids of
durations and peak amplitudes, only paired and placed in another order.
So the work a run does is the same from seed to seed, and only where the
echoes fall changes.

An echo rises over 20 ms and decays exponentially, falling to e^-3 of its
peak at the end of its duration, at the beacon tone shifted by a Doppler
offset drawn within ``doppler_hz``.  Its peak is given against the noise's
rms.  Noise comes from ``torch.randn`` with a generator on ``device``, the
placements from numpy, both seeded from ``seed`` and ``stream`` (a number
that keeps two inputs of one run apart).
"""

from __future__ import annotations

import math

import numpy as np
import torch

RISE_S = 0.02


def _seeds(seed: int, stream: int) -> tuple:
    mixed = (int(seed) * 1_000_003 + int(stream)) % (2 ** 63)
    return mixed, np.random.default_rng([int(seed) % (2 ** 64), int(stream)])


def echo_plan(seed: int, stream: int, n_channels: int, n_samples: int, fs: float,
              signal: dict) -> list:
    """Per channel, its echoes as (first sample, samples, peak, Hz, phase,
    duration in s) tuples.  ``signal`` holds ``noise_rms``,
    ``echoes_per_hour``, ``tone_hz``, ``doppler_hz``, ``duration_s``
    [shortest, longest] and ``peak_over_noise`` [least, most]."""
    rng = _seeds(seed, stream)[1]
    count = max(1, int(round(signal["echoes_per_hour"] * n_samples / fs / 3600.0)))
    durations = np.geomspace(*signal["duration_s"], count)
    peaks = np.geomspace(*signal["peak_over_noise"], count) * float(signal["noise_rms"])
    slot = n_samples // count
    plan = []
    for _ in range(n_channels):
        dur = durations[rng.permutation(count)]
        peak = peaks[rng.permutation(count)]
        freq = signal["tone_hz"] + rng.uniform(-1.0, 1.0, count) * signal["doppler_hz"]
        phase = rng.uniform(0.0, 2.0 * math.pi, count)
        offset = rng.uniform(0.0, 1.0, count)
        echoes = []
        for e in range(count):
            length = min(int(dur[e] * fs), slot)
            s0 = e * slot + int(offset[e] * (slot - length))
            echoes.append((s0, length, peak[e], freq[e], phase[e], dur[e]))
        plan.append(echoes)
    return plan


def echo_audio(seed: int, stream: int, n_channels: int, n_samples: int, fs: float,
               signal: dict, device) -> torch.Tensor:
    """(n_channels, n_samples) float32 on ``device``: noise, then the echoes
    of :func:`echo_plan`."""
    gen = torch.Generator(device=device).manual_seed(_seeds(seed, stream)[0])
    x = torch.randn((n_channels, n_samples), generator=gen, device=device, dtype=torch.float32)
    x *= float(signal["noise_rms"])
    for c, echoes in enumerate(echo_plan(seed, stream, n_channels, n_samples, fs, signal)):
        for s0, length, peak, freq, phase, dur in echoes:
            t = torch.arange(length, device=device, dtype=torch.float64) / fs
            env = torch.clamp(t / RISE_S, max=1.0) * torch.exp(-3.0 * t / dur)
            wave = peak * env * torch.sin(2.0 * math.pi * freq * t + phase)
            x[c, s0: s0 + length] += wave.to(torch.float32)
    return x


def to_int16(x: torch.Tensor) -> torch.Tensor:
    """Rounded and clipped to int16, as a recorder stores it."""
    return torch.clamp(torch.round(x), -32768, 32767).to(torch.int16)
