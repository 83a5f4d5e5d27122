"""One step of every sharded pipeline on a small (station, time) mesh, with
exact assertions: the port's counterpart of ``dryrun_multichip`` in the
JAX package's ``__graft_entry__.py``, with the same fixtures.

On the CPU (a virtual mesh of 8 CPU positions)::

    python -m meteor_scatter_tpu_torch.parallel.dryrun --device cpu

and on one card (``cuda:0`` repeated 8 times)::

    python -m meteor_scatter_tpu_torch.parallel.dryrun

Across processes the 8 positions split over the group (every process
checks the global results), e.g. two gloo processes on the CPU::

    torchrun --nproc-per-node 2 -m meteor_scatter_tpu_torch.parallel.dryrun --device cpu

(``torchrun`` sets ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
``RANK``; the group is NCCL for ``--device cuda``, gloo for the CPU).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from meteor_scatter_tpu_torch.config import DetectionConfig
from meteor_scatter_tpu_torch.device import DeviceLike
from meteor_scatter_tpu_torch.models.events import (
    events_from_mask,
    merge_adjacent,
    truncate_events,
)
from meteor_scatter_tpu_torch.models.streaming import StreamConfig, stream_init, stream_process
from meteor_scatter_tpu_torch.ops.fir import (
    channel_bank_plan,
    channelize_iq,
    firwin_bandpass,
    frame_capture_sharded_host,
)
from meteor_scatter_tpu_torch.parallel.distributed import (
    init_multihost,
    process_count,
    process_device,
)
from meteor_scatter_tpu_torch.parallel.mesh import make_mesh
from meteor_scatter_tpu_torch.parallel.sharded import (
    sharded_channelize_iq,
    sharded_channelize_iq_frames,
    sharded_delta_power,
    sharded_detect_adaptive,
    sharded_detect_adaptive_exact,
    sharded_detect_fixed,
    sharded_fir_filter,
    sharded_spectrogram_psd,
    sharded_stream_process,
)

FS = 6000
BLOCK = 1200
N_FFT = 1024
FREQ_BAND = (993.0, 1013.0)
NOISE_BAND = (690.0, 710.0)
# (front, impl) of the streaming cases, the JAX dryrun's three
STREAM_CASES = (("welch", "scan"), ("bins", "hop"), ("bins", "fused"))
IQ_ATOL = 2e-5


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def dryrun_multichip(n_devices: int, devices: Optional[Sequence[DeviceLike]] = None) -> str:
    """Run the full sharded pipeline over an n-device (station, time) mesh
    on tiny shapes, with injected tone bursts (one spanning a time-shard
    seam per channel), so event extraction, the per-shard event buffers and
    the seam merge see real detections, and assert the exact per-channel
    event lists; then the time-sharded streaming machine and the sharded
    IQ bank against their unsharded forms.  ``devices`` (default: every
    CUDA device) may repeat a device; under a process group they are this
    process's, ``n_devices`` counts the whole group's, and every process
    checks the global results.  Prints and returns one summary line; any
    mismatch raises."""
    n_station = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_time = n_devices // n_station
    mesh = make_mesh(n_station=n_station, n_time=n_time, devices=devices)
    dev = mesh.device

    # tiny shapes: 2 channels, enough blocks per time shard for a small
    # rolling window
    window_blocks = 10
    bps = 3 * window_blocks  # blocks per time shard
    n_blocks = bps * n_time
    n_samples = n_blocks * BLOCK
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal((2, n_samples)).astype(np.float32) * 0.5

    # injected 1003 Hz tone bursts as [start, stop) block extents: each
    # channel gets one straddling a time-shard seam (block k*bps), spaced
    # so every burst's trailing rolling window is clean and the adaptive
    # detector finds every one
    if n_time == 1:  # no seams on a 1-device time axis
        bursts = {0: [(10, 13), (27, 30)], 1: [(15, 18), (28, 30)]}
    else:
        seam1 = bps
        seam2 = min(2, n_time - 1) * bps  # second seam when it exists
        bursts = {
            0: [(10, 13), (seam1 - 1, seam1 + 2), (seam1 + 12, seam1 + 15)],
            1: [(15, 18), (seam2 - 2, seam2 + 1), (seam2 + 11, seam2 + 14)],
        }
    t = np.arange(n_samples) / FS
    tone = np.sin(2 * np.pi * 1003.0 * t).astype(np.float32)
    for ch, spans in bursts.items():
        for b0, b1 in spans:
            x_np[ch, b0 * BLOCK : b1 * BLOCK] += 3.0 * tone[b0 * BLOCK : b1 * BLOCK]
    x = torch.from_numpy(x_np).to(dev)

    taps = firwin_bandpass(31, 900.0, 1100.0, FS)
    cap = 8
    filtered = sharded_fir_filter(x, mesh, taps)
    _, _, delta = sharded_delta_power(filtered, mesh, FS, N_FFT, BLOCK, FREQ_BAND, NOISE_BAND)
    _, thr_f = sharded_detect_fixed(delta, mesh, 4.0)
    kw = dict(
        threshold_std_factor=4.0,
        window_blocks=window_blocks,
        freeze_blocks_before=2,
        freeze_blocks_after=5,
        fixed_threshold_blocks=5,
    )
    # the warm-up-halo variant runs for coverage; the exact variant drives
    # the asserted event lists
    thr_h, _ = sharded_detect_adaptive(delta, mesh, **kw)
    _, above_a = sharded_detect_adaptive_exact(delta, mesh, **kw)

    # the global extraction (the unsharded formulation) ...
    ev_global = events_from_mask(above_a, delta, cap=cap)

    # ... and the distributed one: per-time-shard event buffers folded
    # with the seam merge
    def fold(a_ch, d_ch):
        ev = events_from_mask(a_ch[:bps], d_ch[:bps], cap=cap)
        for k in range(1, n_time):
            sl = slice(k * bps, (k + 1) * bps)
            ev = merge_adjacent(ev, events_from_mask(a_ch[sl], d_ch[sl], cap=cap), k * bps)
        return truncate_events(ev, cap)

    merged = [fold(above_a[c], delta[c]) for c in range(2)]

    # an overlapped STFT whose hop does NOT divide the shard size
    psd = sharded_spectrogram_psd(x, mesh, FS, nperseg=510, noverlap=255)
    if thr_f.shape != (2,) or not bool(torch.isfinite(thr_f).all()):
        raise AssertionError(f"fixed thresholds {thr_f}")
    if not (bool(torch.isfinite(psd.sum())) and bool(torch.isfinite(thr_h.sum()))):
        raise AssertionError("non-finite spectrogram or halo-variant thresholds")

    counts = [int(ev.count) for ev in merged]
    for ch, spans in bursts.items():
        exp = sorted(spans)
        ev, c = merged[ch], counts[ch]
        got = list(zip(ev.start[:c].tolist(), ev.stop[:c].tolist()))
        if got != exp:
            raise AssertionError(f"ch{ch}: expected {exp}, got {got}")
        # the seam-merge path must agree with the global extraction exactly
        if int(ev_global.count[ch]) != c or not (
            torch.equal(ev_global.start[ch, :c], ev.start[:c])
            and torch.equal(ev_global.stop[ch, :c], ev.stop[:c])
        ):
            raise AssertionError(f"ch{ch}: seam merge differs from the global extraction")

    # --- the time-sharded streaming state machine (processor.py:444-510)
    # against the unsharded run, on the injected bursts ---
    fs_s = 4000
    cfg_s = DetectionConfig(
        signal_freq=1000.0,
        detection_db_over_noise_mean_min=1.0,
        detection_dur_min_sec=0.5,
    )
    dur_s = 64.0
    rng_s = np.random.default_rng(1)
    ts = np.arange(int(fs_s * dur_s)) / fs_s
    xs = rng_s.standard_normal((2, len(ts))).astype(np.float32) * 0.05
    # one burst per channel straddling a time-shard seam; the second is
    # clamped fully inside the capture (at n_time <= 2 its seam-relative
    # position would clip it below the 0.5 s minimum duration)
    seam_sec = dur_s / max(n_time, 2)
    sbursts = {
        0: [(seam_sec - 0.6, 1.4)],
        1: [(min(2 * seam_sec - 0.5, dur_s - 1.4), 1.2)],
    }
    for ch, spans in sbursts.items():
        for s0, sl in spans:
            m = (ts >= s0) & (ts < s0 + sl)
            xs[ch, m] += 0.6 * np.sin(2 * np.pi * 1000.0 * ts[m]).astype(np.float32)
    xs_t = torch.from_numpy(xs).to(dev)

    stream_counts = {}
    scfg = StreamConfig.from_config(cfg_s)
    for front_i, impl_i in STREAM_CASES:
        _, ev_sh, _ = sharded_stream_process(cfg_s, None, xs_t, fs_s, mesh,
                                             front=front_i, impl=impl_i)
        sc = ev_sh.count.tolist()
        stream_counts[f"{front_i}:{impl_i}"] = sc
        for ch in range(2):
            _, ev_u, _ = stream_process(cfg_s, stream_init(scfg, device=dev), xs_t[ch], fs_s,
                                        front=front_i, impl=impl_i)
            c = int(ev_u.count)
            if sc[ch] != c or c < 1:
                raise AssertionError(
                    f"stream {front_i}:{impl_i} ch{ch}: sharded {sc[ch]} vs unsharded {c}")
            if not (torch.equal(ev_sh.time_start[ch, :c], ev_u.time_start[:c])
                    and torch.equal(ev_sh.time_stop[ch, :c], ev_u.time_stop[:c])):
                raise AssertionError(f"stream {front_i}:{impl_i} ch{ch}: event times differ")

    # --- the time-sharded wideband IQ bank (BASELINE config 4's front):
    # the per-shard rotation bookkeeping against the unsharded bank ---
    fs_w = 64_000
    q_w = 16
    iq_freqs = np.asarray([-7001.0, 6997.0])
    n_w = (fs_w // q_w) * q_w * max(n_time, 1)  # whole frames per shard
    rng_w = np.random.default_rng(2)
    w_re = rng_w.standard_normal(n_w).astype(np.float32) * 0.1
    w_im = rng_w.standard_normal(n_w).astype(np.float32) * 0.1
    kw_w = dict(bandwidth=1500.0, decim=q_w, numtaps=65)
    wr, wi = torch.from_numpy(w_re).to(dev), torch.from_numpy(w_im).to(dev)
    yr_s, yi_s = sharded_channelize_iq(wr, wi, mesh, fs_w, iq_freqs, **kw_w)
    yr_u, yi_u = channelize_iq(wr, wi, fs_w, iq_freqs, **kw_w)
    n_cmp = min(yr_s.shape[-1], yr_u.shape[-1])
    iq_err = max(float((yr_s[:, :n_cmp] - yr_u[:, :n_cmp]).abs().max()),
                 float((yi_s[:, :n_cmp] - yi_u[:, :n_cmp]).abs().max()))
    if iq_err > IQ_ATOL:
        raise AssertionError(f"sharded IQ bank differs from the unsharded one by {iq_err}")

    # the pre-framed form (host-baked per-shard frames with their halos)
    # must be BIT-identical to the flat sharded bank
    plan_w, _ = channel_bank_plan(n_w, fs_w, iq_freqs, device="cpu", **kw_w)
    f_sh = torch.from_numpy(
        frame_capture_sharded_host(np.stack([w_re, w_im]), plan_w, max(n_time, 1))
    ).to(dev)
    yr_p, yi_p = sharded_channelize_iq_frames(f_sh, mesh, fs_w, iq_freqs, **kw_w)
    if not (_bits_equal(yr_p, yr_s) and _bits_equal(yi_p, yi_s)):
        raise AssertionError("pre-framed sharded IQ bank is not bit-identical to the flat one")

    line = (
        f"dryrun_multichip ok: mesh=({n_station}x{n_time}), "
        f"{n_samples} samples/channel, events per channel: {counts} "
        f"(expected {[len(v) for v in bursts.values()]}, "
        f"seam-spanning bursts merged exactly); "
        f"streaming machine time-sharded == unsharded for "
        + ", ".join(f"{k} ({v} events)" for k, v in stream_counts.items())
        + "; sharded IQ channelizer == unsharded (flat AND pre-framed forms)"
    )
    print(line)
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="the device each of the 8 mesh positions repeats: cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = process_device(args.device)
    init_multihost(device=dev)
    try:
        per = 8 // process_count()
        dryrun_multichip(per * process_count(), devices=[dev] * per)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
