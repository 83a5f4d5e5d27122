"""The child side of ``tests/test_torch_multiproc.py``.

:func:`run` is one process of a gloo group on the CPU: it builds a
(station, time) mesh over every process's CPU positions, runs each sharded
entry point of the port on inputs made from seeds (:func:`compute_cases`),
and the row operations on small rows (:func:`compute_row_ops`), and saves
its global results with ``np.savez``.  The parent runs the same functions
on one process driving the whole mesh and compares.

This module imports neither JAX nor the JAX package, so a spawned child
starts with torch and the port alone.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from meteor_scatter_tpu_torch.config import DetectionConfig
from meteor_scatter_tpu_torch.ops import bandpower as tbp
from meteor_scatter_tpu_torch.ops import fir as tfir
from meteor_scatter_tpu_torch.parallel import distributed as tdist
from meteor_scatter_tpu_torch.parallel import halo as thalo
from meteor_scatter_tpu_torch.parallel import mesh as tmesh
from meteor_scatter_tpu_torch.parallel import sharded as tsh
from meteor_scatter_tpu_torch.parallel.dryrun import dryrun_multichip

FS, BLOCK, NFFT = 6000, 1200, 1024
FB, NB = (993.0, 1013.0), (690.0, 710.0)
KW = dict(threshold_std_factor=4.0, window_blocks=25, freeze_blocks_before=3,
          freeze_blocks_after=10, fixed_threshold_blocks=10)
CFG = DetectionConfig(signal_freq=1000, detection_db_over_noise_mean_min=1, detection_dur_min_sec=0.5)
STREAM_FS = 4000
STREAM_CASES = (("welch", "scan", 11), ("bins", "fused", 13))
IQ_FS, IQ_TONE = 64_000, 1000.0
IQ_CENTERS = np.asarray([-17003.0, -7001.0, 6997.0, 15013.0]) - IQ_TONE
IQ_KW = dict(bandwidth=1500.0, decim=16, numtaps=65)
ST = (tmesh.STATION_AXIS, tmesh.TIME_AXIS)


def audio(channels: int, seconds: float, seed: int) -> np.ndarray:
    """6 kHz noise with a 1 s 1003 Hz burst a channel (``tests/test_parallel.py``'s)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(FS * seconds)) / FS
    x = rng.standard_normal((channels, len(t))) * 0.5
    for c in range(channels):
        m = (t >= 3.0 + 5 * c) & (t < 4.0 + 5 * c)
        x[c, m] += 2.0 * np.sin(2 * np.pi * 1003.0 * t[m])
    return x.astype(np.float32)


def stream_audio(seed: int) -> np.ndarray:
    """64 s at 4 kHz, 2 channels: ch0's burst straddles the 16 s seam of 4
    time shards, ch1 has one on the 32 s seam and one inside a shard."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(STREAM_FS * 64.0)) / STREAM_FS
    x = rng.standard_normal((2, len(t))).astype(np.float32) * 0.05
    for c, spans in {0: [(15.5, 1.5)], 1: [(31.4, 1.2), (50.0, 1.0)]}.items():
        for s0, dur in spans:
            m = (t >= s0) & (t < s0 + dur)
            x[c, m] += 0.6 * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)
    return x


def iq_capture(seconds: float, seed: int = 21):
    """A 64 kS/s I/Q capture with one 1.5 s tone per channel of the bank."""
    rng = np.random.default_rng(seed)
    n = int(IQ_FS * seconds)
    t = np.arange(n) / IQ_FS
    x_re = rng.standard_normal(n).astype(np.float32) * 0.1
    x_im = rng.standard_normal(n).astype(np.float32) * 0.1
    for c, fc in enumerate(IQ_CENTERS + IQ_TONE):
        m = (t >= 9.5 + 1.3 * c) & (t < 11.0 + 1.3 * c)
        x_re[m] += 0.5 * np.cos(2 * np.pi * fc * t[m]).astype(np.float32)
        x_im[m] += 0.5 * np.sin(2 * np.pi * fc * t[m]).astype(np.float32)
    return x_re, x_im


def delta(seconds: float, seed: int) -> np.ndarray:
    """A (2, B) delta-dB series from :func:`audio` through the unsharded port."""
    return tbp.delta_power_db(torch.from_numpy(audio(2, seconds, seed)), FS, NFFT, BLOCK, FB,
                              NB)[2].numpy()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _named(prefix: str, value) -> dict:
    """Flatten tensors, named tuples and dicts into ``{name: array}``."""
    if isinstance(value, torch.Tensor):
        return {prefix: value.numpy()}
    if isinstance(value, np.ndarray):
        return {prefix: value}
    items = value.items() if isinstance(value, dict) else (
        zip(value._fields, value) if hasattr(value, "_fields") else enumerate(value))
    out = {}
    for k, v in items:
        out.update(_named(f"{prefix}.{k}", v))
    return out


def _stream(mesh):
    out = {}
    for front, impl, seed in STREAM_CASES:
        got = tsh.sharded_stream_process(CFG, None, _t(stream_audio(seed)), STREAM_FS, mesh,
                                         front=front, impl=impl)
        out.update(_named(f"{front}_{impl}", got))
    return out


def _iq_frames(mesh):
    x_re, x_im = iq_capture(4.0)
    n_time = mesh.shape[tmesh.TIME_AXIS]
    plan, _ = tfir.channel_bank_plan(x_re.size, IQ_FS, IQ_CENTERS, device="cpu", **IQ_KW)
    f_sh = tfir.frame_capture_sharded_host(np.stack([x_re, x_im]), plan, n_time)
    return _named("y", tsh.sharded_channelize_iq_frames(_t(f_sh), mesh, IQ_FS, IQ_CENTERS, **IQ_KW))


# the ten entry points: name -> mesh -> {result name: array}
CASES = {
    "delta_power": lambda m: _named("y", tsh.sharded_delta_power(
        _t(audio(2, 16.0, 0)), m, FS, NFFT, BLOCK, FB, NB)),
    "detect_fixed": lambda m: _named("y", tsh.sharded_detect_fixed(_t(delta(16.0, 1)), m, 4.0)),
    "detect_adaptive": lambda m: _named("y", tsh.sharded_detect_adaptive(
        _t(delta(32.0, 3)), m, **KW)),
    "detect_adaptive_exact": lambda m: _named("y", tsh.sharded_detect_adaptive_exact(
        _t(delta(32.0, 8)), m, **KW)),
    "spectrogram_psd": lambda m: _named("y", tsh.sharded_spectrogram_psd(
        _t(audio(2, 16.0, 4)), m, FS, 511, noverlap=256)),
    "fir_filter": lambda m: _named("y", tsh.sharded_fir_filter(
        _t(audio(2, 8.0, 2)), m, tfir.firwin_bandpass(101, 950.0, 1050.0, FS))),
    "stream_process": _stream,
    "channelize_iq": lambda m: _named("y", tsh.sharded_channelize_iq(
        *(_t(a) for a in iq_capture(4.0)), m, IQ_FS, IQ_CENTERS, **IQ_KW)),
    "channelize_iq_frames": _iq_frames,
    "welch_blocks": lambda m: _named("y", tsh.sharded_welch_blocks(
        _t(audio(2, 8.0, 6)), m, FS, BLOCK, NFFT)),
}


def compute_cases(mesh) -> dict:
    """Every entry point's global results on ``mesh``, as ``{case/name: array}``."""
    out = {}
    for case, fn in CASES.items():
        out.update({f"{case}/{k}": v for k, v in fn(mesh).items()})
    return out


def psum_values(n_ch: int, n_time: int) -> np.ndarray:
    """(n_ch, n_time) float32 values whose float32 sum depends on the order:
    large terms that cancel beside small ones."""
    rng = np.random.default_rng(5)
    big = rng.choice([-1.0, 1.0], (n_ch, n_time)) * 10.0 ** rng.integers(6, 9, (n_ch, n_time))
    return (big + rng.standard_normal((n_ch, n_time))).astype(np.float32)


def compute_row_ops(mesh) -> dict:
    """The three row operations on every row of ``mesh``, assembled by
    ``unshard``: a halo of 2 left and 3 right samples on 6-sample shards;
    the row sum of one value a channel and shard; the gather of a bool
    mask."""
    n_time = mesh.shape[tmesh.TIME_AXIS]
    x = _t(np.random.default_rng(4).standard_normal((2, 6 * n_time)).astype(np.float32))
    vals = _t(psum_values(2, n_time))
    mask = _t(np.random.default_rng(6).random((2, 5 * n_time)) > 0.5)
    halo_grid, psum_grid, gather_grid = [], [], []
    for s, (xr, vr, mr) in enumerate(zip(tmesh.shard(x, mesh, ST), tmesh.shard(vals, mesh, ST),
                                          tmesh.shard(mask, mesh, ST))):
        halo_grid.append(thalo.halo_exchange(xr, 2, 3, mesh, s))
        psum_grid.append(thalo.time_psum([None if v is None else v[:, 0] for v in vr], mesh, s))
        gather_grid.append(thalo.time_all_gather(mr, 1, mesh, s))
    return {
        "halo": tmesh.unshard(halo_grid, mesh, ST).numpy(),
        "psum": tmesh.unshard(psum_grid, mesh, (tmesh.STATION_AXIS,)).numpy(),
        "gather": tmesh.unshard(gather_grid, mesh, (tmesh.STATION_AXIS, None)).numpy(),
    }


def compute_idle(devices_per_process: int) -> dict:
    """A 1 x 2 mesh over the first two CPU positions of the group: the
    processes past them own none and still get every global result (two
    positions a process: the second process of two; one: the last two of
    four)."""
    mesh = tmesh.make_mesh(1, 2, ["cpu"] * devices_per_process)
    out = _named("delta_power", tsh.sharded_delta_power(_t(audio(2, 16.0, 0)), mesh, FS, NFFT,
                                                        BLOCK, FB, NB))
    out.update(_named("detect_fixed", tsh.sharded_detect_fixed(_t(delta(16.0, 1)), mesh, 4.0)))
    return out


def compute_all(mesh, devices_per_process: int) -> dict:
    """The cases, the row operations and the idle-process case."""
    out = {f"cases/{k}": v for k, v in compute_cases(mesh).items()}
    out.update({f"row_ops/{k}": v for k, v in compute_row_ops(mesh).items()})
    out.update({f"idle/{k}": v for k, v in compute_idle(devices_per_process).items()})
    return out


def run(rank: int, world: int, store: str, out_dir: str, n_station: int, n_time: int) -> None:
    """One process of a group of ``world``: everything of :func:`compute_all`
    on an ``n_station x n_time`` mesh split evenly over the processes.
    Rank 0 first computes the same on one process driving the whole mesh
    (``reference.npz``), so both run with this process's thread settings:
    the bins front's projection (numpy ``eigh``) rounds differently with
    the BLAS thread count."""
    torch.set_num_threads(1)
    if rank == 0:
        n = n_station * n_time
        np.savez(os.path.join(out_dir, "reference.npz"),
                 **compute_all(tmesh.make_mesh(n_station, n_time, ["cpu"] * n), 2))
        with open(os.path.join(out_dir, "reference.json"), "w") as f:
            json.dump({"dryrun": dryrun_multichip(4, ["cpu"] * 4)}, f)
    assert tdist.init_multihost(f"file://{store}", world, rank, device="cpu")
    try:
        try:
            tmesh.make_mesh(1, None, ["cpu"] * (1 + rank))
            unequal = "no error"
        except ValueError as e:
            unequal = str(e)
        per = n_station * n_time // world
        mesh = tmesh.make_mesh(n_station, n_time, ["cpu"] * per)
        results = compute_all(mesh, 2 if world == 2 else 1)
        info = {
            "process_index": tdist.process_index(), "process_count": tdist.process_count(),
            "owners": mesh.owners, "transport": mesh.transport,
            "staged_bytes": mesh.link.staged_bytes, "wire_bytes": mesh.link.wire_bytes,
            "unequal_counts": unequal,
            "dryrun": dryrun_multichip(4, ["cpu"] * (4 // world)),
            "jax_modules": sorted(m for m in sys.modules if m.split(".")[0] in (
                "jax", "meteor_scatter_tpu")),
        }
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(info, f)
    finally:
        dist.destroy_process_group()
