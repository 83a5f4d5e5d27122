#!/usr/bin/env python3
"""How close the port's streaming decisions come to ties on the card,
against the numerical gaps between its formulations and devices.

The port's counterpart of ``tools/tie_margin_study.py`` (whose JAX numbers
are in ``PARITY.md``), on the same numpy fixtures: noise plus bursts of
random strength and duration, some below the 0.5 s and 1 dB accept bounds.
The streaming machine decides three ways: threshold crossings (over-noise
against the rolling or locked threshold), duration acceptance (integer
blocks) and dB-mean acceptance (``h_mean >= min_mean_db``).  Over
``--fixtures`` fixtures of ``--seconds`` at 4 kHz this measures, on the
card:

* the front delta, ``|on_welch - on_bins|`` (the Welch front against the
  bins front's GEMM);
* the crossing margins ``|on - thr|`` at the events' boundary blocks, and
  the accept margins ``|h_mean - min_mean_db|``, of K3's solve of the Welch
  series;
* the ``h_mean`` delta of K3 on the card against the scan (K3's plain twin)
  on the CPU, on the card's series;
* events at exactly the minimum duration;
* end-to-end event-list mismatches, welch:fused (K3, bit-exact to the scan)
  against bins:hop, boundary tolerance one block, as the JAX tool counts
  them;
* card-against-CPU event-list mismatches: the Welch front and scan on the
  CPU against the Welch front and K3 on the card (any difference).

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 tools/torch_tie_margin_study.py [--fixtures 60] [--seconds 300]

``--device cpu`` runs every step on the CPU (a rehearsal: no card number).
The last line is one JSON object with the numbers, the device and the
``nvidia-smi`` name and power-limit line.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from meteor_scatter_tpu_torch.config import DetectionConfig  # noqa: E402
from meteor_scatter_tpu_torch.models import streaming as st  # noqa: E402

FS = 4000


def synth(fs: int, seconds: float, seed: int) -> np.ndarray:
    """Noise + a few bursts with randomized strength/duration, including
    marginal ones near the accept bounds (``tools/tie_margin_study.py``'s
    fixture, number for number)."""
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    x = rng.standard_normal(n).astype(np.float32) * 0.05
    s = 12.0
    while s < seconds - 5.0:
        dur = float(rng.uniform(0.2, 2.0))  # some below the 0.5 s minimum
        amp = float(rng.uniform(0.012, 0.25))  # spans the 1 dB mean minimum
        m = (t >= s) & (t < s + dur)
        x[m] += amp * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)
        s += float(rng.uniform(20.0, 45.0))
    return x


def events(ev) -> np.ndarray:
    """(count, 3): time_start, time_stop, db_mean of an unbatched solve."""
    c = int(ev.count)
    return np.stack([ev.time_start[:c].cpu().numpy(), ev.time_stop[:c].cpu().numpy(),
                     ev.db_mean[:c].cpu().numpy()], -1)


def card_line(device: str):
    if device != "cuda":
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--fixtures", type=int, default=60)
    p.add_argument("--seconds", type=float, default=300.0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        print("no CUDA device (use --device cpu for a rehearsal)", file=sys.stderr)
        return 1

    cfg = DetectionConfig(signal_freq=1000.0, detection_db_over_noise_mean_min=1.0,
                          detection_dur_min_sec=0.5)
    scfg = st.StreamConfig.from_config(cfg)
    min_dur_b = st.min_duration_blocks(scfg.min_dur_sec, scfg.block_sec)

    def solve(solver, on, device):
        return solver(scfg, st.stream_init(scfg, device=device), on, torch.zeros_like(on))

    front_deltas, crossing, accept, hmean_deltas = [], [], [], []
    at_min = total = e2e_mismatches = cpu_mismatches = 0
    for f in range(args.fixtures):
        x_np = synth(FS, args.seconds, seed=1000 + f)
        x = torch.from_numpy(x_np).to(dev)
        on_w = st.stream_front(cfg, x, FS)[0]
        on_b = st.stream_front_headless(cfg, x, FS)[0]
        front_deltas.append(float((on_w - on_b).abs().max()))

        _, ev_k, thr_k = solve(st.stream_scan_fused, on_w, dev)  # K3 on the card
        e_k = events(ev_k)
        total += len(e_k)
        thr = thr_k.cpu().numpy()
        on = on_w.cpu().numpy()
        durs = np.rint((e_k[:, 1] - e_k[:, 0]) / scfg.block_sec).astype(int)
        at_min += int((durs == min_dur_b).sum())
        accept += np.abs(e_k[:, 2] - scfg.min_mean_db).tolist()
        for tb in e_k[:, :2].reshape(-1):
            i = int(round(tb / scfg.block_sec))
            if 0 <= i < len(on) and np.isfinite(thr[i]):
                crossing.append(abs(float(on[i]) - float(thr[i])))

        # the scan on the CPU, on the card's series: the h_mean delta
        _, ev_s, _ = solve(st.stream_scan, on_w.cpu(), "cpu")
        e_s = events(ev_s)
        if len(e_s) == len(e_k) and np.array_equal(e_s[:, :2], e_k[:, :2]):
            hmean_deltas += np.abs(e_s[:, 2] - e_k[:, 2]).tolist()
        else:
            hmean_deltas.append(float("inf"))  # a flip on the same series

        # end to end: welch:fused against bins:hop, one block of tolerance
        _, ev_h, _ = solve(st.stream_scan_jump_batch, on_b, dev)
        e_h = events(ev_h)
        if len(e_h) != len(e_k) or not np.allclose(e_h[:, 0], e_k[:, 0], atol=scfg.block_sec):
            e2e_mismatches += 1

        # the card against the CPU: front and solve each on its device
        on_cpu = st.stream_front(cfg, torch.from_numpy(x_np), FS)[0]
        e_c = events(solve(st.stream_scan, on_cpu, "cpu")[1])
        if len(e_c) != len(e_k) or not np.array_equal(e_c[:, :2], e_k[:, :2]):
            cpu_mismatches += 1

    def stats(a):
        a = np.asarray(a, np.float64)
        if not a.size:
            return {"min": None, "p5": None, "median": None, "max": None}
        return {"min": float(a.min()), "p5": float(np.percentile(a, 5)),
                "median": float(np.median(a)), "max": float(a.max())}

    front = stats(front_deltas)
    cross, acc, hmd = stats(crossing), stats(accept), stats(hmean_deltas)
    out = {
        "fixtures": args.fixtures, "seconds": args.seconds, "events": total,
        "device": torch.cuda.get_device_name(0) if dev == "cuda" else "cpu",
        "nvidia_smi": card_line(dev),
        "front_delta_db": front, "crossing_margin_db": cross, "accept_margin_db": acc,
        "hmean_delta_card_vs_cpu_db": hmd, "events_at_min_duration": at_min,
        "e2e_mismatches_welch_fused_vs_bins_hop": e2e_mismatches,
        "card_vs_cpu_mismatches": cpu_mismatches,
        "crossing_floor_over_front_delta": (cross["min"] / max(front["max"], 1e-12)
                                            if cross["min"] is not None else None),
        "accept_floor_over_hmean_delta": (acc["min"] / max(hmd["max"], 1e-12)
                                          if acc["min"] is not None else None),
    }
    print(f"fixtures={args.fixtures} x {args.seconds:.0f}s  events={total}  device={out['device']}")
    print(f"front delta |on_bins - on_welch|: max {front['max']:.3e} dB, "
          f"median {front['median']:.3e} dB")
    print(f"crossing-block margin |on - thr|: min {cross['min']:.3e} dB, p5 {cross['p5']:.3e}, "
          f"median {cross['median']:.3e}")
    print(f"accept margin |h_mean - {scfg.min_mean_db}|: min {acc['min']:.3e} dB, "
          f"p5 {acc['p5']:.3e}, median {acc['median']:.3e}")
    print(f"h_mean delta (K3 on {dev} vs the scan on the CPU): max {hmd['max']:.3e} dB")
    print(f"events at exact minimum duration: {at_min}/{total}")
    print(f"end-to-end event-list mismatches (welch:fused vs bins:hop, 1 block): {e2e_mismatches}")
    print(f"{dev}-against-CPU event-list mismatches (front and solve): {cpu_mismatches}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
