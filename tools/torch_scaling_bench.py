"""Multi-device / multi-process weak-scaling harness of the PyTorch port
(``meteor_scatter_tpu_torch``): the counterpart of ``tools/scaling_bench.py``.

Every mesh position gets an identical workload, so perfect scaling keeps
the step time flat as positions are added and aggregate samples/s grows
linearly.  Efficiency(N) = t(smallest mesh) / t(N positions).

* ``batch``: channels x seconds of synthetic 6 kHz audio through the
  sharded band power and the warm-started adaptive detection on a
  (station=1, time=N) mesh;
* ``stations``: BASELINE config 5's streaming path,
  ``sharded_stream_process`` with pre-blocked input on a (station=N,
  time=1) mesh, ``stations_per_device`` stations a position (front and
  solver ``"auto"``: the bins front and the fused kernel on a card, the
  scan on the CPU).

Run modes:

* one process, every local device (default: every CUDA device)::

    python tools/torch_scaling_bench.py --devices 1 2 4

  ``--local-devices 8`` repeats the devices into 8 positions (a virtual
  mesh; ``--device cpu`` for the CPU);
* several processes: one copy each, with ``--coordinator host0:1234
  --num-processes N --process-id i`` (or ``torchrun``'s environment);
  every process passes the same arguments, the mesh takes every process's
  positions in rank order, and only rank 0 prints.  ``--backend gloo``
  lets several processes share one card (NCCL refuses that), staging
  every transfer through the host.

Output: one JSON line per pipeline and mesh size, with aggregate samples/s
and the efficiency against the smallest measured mesh.  A step is timed
on the host clock after the device finishes: ``chain`` steps against one,
the best of ``reps``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


FS = 6000
BLOCK = 1200
N_FFT = 1024
FREQ_BAND = (993.0, 1013.0)
NOISE_BAND = (690.0, 710.0)
WINDOW_BLOCKS = 600
FREEZE_BEFORE, FREEZE_AFTER, FIXED_INIT = 15, 100, 50


def per_device_audio(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    x = rng.standard_normal(n).astype(np.float32) * 0.5
    t = np.arange(n) / FS
    for s in np.arange(5.0, seconds - 2.0, 37.0):
        m = (t >= s) & (t < s + 1.0)
        x[m] += 2.0 * np.sin(2 * np.pi * 1003.0 * t[m]).astype(np.float32)
    return x


def step_seconds(step, device, reps: int, chain: int) -> float:
    """Seconds a step: ``chain`` steps against one, on the host clock after
    the device finishes, the best of ``reps`` (the fixed cost of a timing
    cancels)."""
    import torch

    def chained(k):
        t0 = time.perf_counter()
        for _ in range(k):
            out = step()
        out.item()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    chained(1)  # warm
    t1 = min(chained(1) for _ in range(reps))
    tk = min(chained(chain) for _ in range(reps))
    return max((tk - t1) / (chain - 1), 1e-9)


def run_mesh(n_devices: int, devices, seconds_per_device: float, window_blocks: int,
             reps: int, chain: int):
    """Weak-scaling step time of the batch pipeline on a (station=1,
    time=n) mesh.  Returns (seconds per step, samples per step)."""
    import torch

    from meteor_scatter_tpu_torch.parallel.mesh import make_mesh
    from meteor_scatter_tpu_torch.parallel.sharded import (
        sharded_delta_power,
        sharded_detect_adaptive,
    )

    mesh = make_mesh(n_station=1, n_time=n_devices, devices=devices)
    n_samples = int(FS * seconds_per_device) // BLOCK * BLOCK * n_devices
    x = np.concatenate(
        [per_device_audio(seconds_per_device, seed=10 + d) for d in range(n_devices)]
    )[:n_samples][None, :]
    xt = torch.from_numpy(x).to(mesh.device)

    def step():
        _, _, delta = sharded_delta_power(xt, mesh, FS, N_FFT, BLOCK, FREQ_BAND, NOISE_BAND)
        _, above = sharded_detect_adaptive(
            delta, mesh, threshold_std_factor=4.0, window_blocks=window_blocks,
            freeze_blocks_before=FREEZE_BEFORE, freeze_blocks_after=FREEZE_AFTER,
            fixed_threshold_blocks=FIXED_INIT,
        )
        return above.sum()

    return step_seconds(step, mesh.device, reps, chain), n_samples, mesh.transport


def run_mesh_stations(n_devices: int, devices, seconds: float, stations_per_device: int,
                      reps: int, chain: int):
    """Weak-scaling step time of BASELINE config 5's streaming path:
    ``sharded_stream_process`` on pre-blocked input, stations over the
    mesh, each position solving its station group.  Returns (seconds per
    step, samples per step)."""
    import torch

    from meteor_scatter_tpu_torch.config import DetectionConfig
    from meteor_scatter_tpu_torch.parallel.mesh import make_mesh
    from meteor_scatter_tpu_torch.parallel.sharded import sharded_stream_process

    fs = 4000
    cfg = DetectionConfig(signal_freq=1000.0, detection_db_over_noise_mean_min=1.0,
                          detection_dur_min_sec=0.5)
    block = int(round(cfg.proc_block_sec * fs))
    C = stations_per_device * n_devices
    n = int(fs * seconds) // block * block
    rng = np.random.default_rng(3)
    x = rng.standard_normal((C, n)).astype(np.float32) * 0.3
    t = np.arange(n) / fs
    for c in range(C):
        s0 = 15.0 + (5.0 * c) % max(seconds - 20.0, 1.0)
        m = (t >= s0) & (t < s0 + 1.0)
        x[c, m] += 1.5 * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)

    mesh = make_mesh(n_station=n_devices, n_time=1, devices=devices)
    xb = torch.from_numpy(x.reshape(C, n // block, block)).to(mesh.device)

    def step():
        _, ev, _ = sharded_stream_process(cfg, None, xb, fs, mesh, front="auto", impl="auto")
        return ev.count.sum()

    return step_seconds(step, mesh.device, reps, chain), C * n, mesh.transport


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, nargs="+", default=None,
                   help="mesh sizes to measure (default: 1..all powers of 2)")
    p.add_argument("--seconds-per-device", type=float, default=600.0)
    p.add_argument("--window-blocks", type=int, default=WINDOW_BLOCKS,
                   help="adaptive rolling window; must be <= blocks per shard")
    p.add_argument("--pipeline", choices=("batch", "stations", "both"), default="batch",
                   help="batch = time-sharded band power + adaptive detect; stations = "
                        "station-sharded streaming machine with pre-blocked input")
    p.add_argument("--stations-per-device", type=int, default=8)
    p.add_argument("--stations-seconds", type=float, default=600.0,
                   help="stream length per station for --pipeline stations")
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--chain", type=int, default=6, help="chained steps per timing")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the device type of this process's mesh positions")
    p.add_argument("--local-devices", type=int, default=None,
                   help="mesh positions this process contributes (default: every CUDA "
                        "device, or 1 on the CPU); more than the cards repeats them")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="process-group backend (default: nccl for cuda, gloo for cpu)")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from meteor_scatter_tpu_torch.parallel.distributed import (
        init_multihost,
        process_count,
        process_index,
    )

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch.cuda.is_available() is False; pass --device cpu")
        cards = torch.cuda.device_count()
        local = args.local_devices or cards
        devices = [f"cuda:{k % cards}" for k in range(local)]
        torch.cuda.set_device(devices[0])
        device_name = torch.cuda.get_device_name(0)
    else:
        devices = ["cpu"] * (args.local_devices or 1)
        device_name = "cpu"
    init_multihost(args.coordinator, args.num_processes, args.process_id, device=args.device,
                   backend=args.backend)
    try:
        total = len(devices) * process_count()
        sizes = sorted(set(args.devices or [d for d in (1, 2, 4, 8, 16, 32) if d <= total]))
        pipelines = ("batch", "stations") if args.pipeline == "both" else (args.pipeline,)
        lead = process_index() == 0
        for pipeline in pipelines:
            results = []
            for n in sizes:
                if pipeline == "batch":
                    dt, n_samples, transport = run_mesh(
                        n, devices, args.seconds_per_device, args.window_blocks, args.reps,
                        args.chain)
                else:
                    dt, n_samples, transport = run_mesh_stations(
                        n, devices, args.stations_seconds, args.stations_per_device, args.reps,
                        args.chain)
                results.append({"pipeline": pipeline, "devices": n, "sec_per_step": dt,
                                "samples_per_sec": n_samples / dt,
                                "weak_scaling_efficiency": round(results[0]["sec_per_step"] / dt
                                                                 if results else 1.0, 4),
                                "processes": process_count(), "transport": transport,
                                "device": device_name})
                if lead:
                    print(json.dumps(results[-1]), flush=True)
            if lead and len(results) > 1:
                worst = min(r["weak_scaling_efficiency"] for r in results[1:])
                print(f"# {pipeline}: worst weak-scaling efficiency: {worst:.1%} "
                      f"(target >= 80%)", file=sys.stderr)
        shared = args.device == "cpu" or len(devices) > len(set(devices)) or (
            args.backend == "gloo" and process_count() > 1)
        if lead and shared:
            print("# NOTE: positions share a card (or the CPU's cores): this run measures "
                  "the sharding's bookkeeping and transport, not scaling", file=sys.stderr)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
