"""Streaming-pipeline timing of the PyTorch/CUDA port on one card.

The port's counterpart of ``tools/streaming_bench.py``: one hour of 4 kHz
audio (``synth_hour``, seed 9) through ``stream_process`` for each requested
``front:impl`` pair (fronts ``welch`` / ``bins``; solvers ``scan``,
``jump``, ``hop`` and ``fused``, K3 on a card).  Before any time is printed,
every pair's events on the hour are held against the reference formulation
(``welch:scan``, the plain machine): equal count, start and stop times, bit
for bit; a pair that differs ends the run with exit code 1 and no timing.

Each pair is then timed as ``--reps`` calls of ``stream_process`` on the
hour, the state carried from call to call as the JAX tool's chain does,
each call between CUDA events after warm-up (the host clock with
``--device cpu``).  The JAX tool's ``--chain`` belonged to the TPU's
in-graph chained timing and is not ported.  On a card the scan is K3's
plain twin (a loop over the hour's blocks), so it takes seconds a call; the
default ``--reps`` is kept small for it.  This is the live detector's layer
view: the ``live_day`` cell's feeds are 60 s chunks of the same path.

    python3 tools/torch_streaming_bench.py [--combos welch:scan,bins:scan,bins:jump]
        [--hours 1.0] [--reps 5] [--device cuda]

Prints a table line a pair, the ``nvidia-smi`` name and power limit, and
one JSON line with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FS = 4000
REFERENCE = "welch:scan"


def synth_hour(fs: int, seconds: float, seed: int = 9) -> np.ndarray:
    """``tools/streaming_bench.py::synth_hour``: noise of std 0.05 with a
    1000 Hz tone of amplitude 0.6 every 120 s from 15 s, 0.8-2.3 s long."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    x = rng.standard_normal(len(t)).astype(np.float32) * 0.05
    s = 15.0
    while s < seconds - 10.0:
        dur = 0.8 + (s % 3.0) / 2.0
        m = (t >= s) & (t < s + dur)
        x[m] += 0.6 * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)
        s += 120.0
    return x


def boundaries(ev) -> tuple:
    """A single-channel chunk's event count, start and stop times."""
    c = int(ev.count)
    return c, ev.time_start[:c].cpu().numpy(), ev.time_stop[:c].cpu().numpy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--combos", default="welch:scan,bins:scan,bins:jump",
                   help="front:impl pairs; impl scan, jump, hop or fused")
    p.add_argument("--hours", type=float, default=1.0)
    p.add_argument("--reps", type=int, default=5, help="timed calls a pair")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch_bench as tb
    from meteor_scatter_tpu_torch.device import resolve_device
    from meteor_scatter_tpu_torch.models import streaming as st

    device = resolve_device(args.device)
    cfg = tb.stations_config()
    scfg = st.StreamConfig.from_config(cfg)
    seconds = 3600.0 * args.hours
    x = torch.from_numpy(synth_hour(FS, seconds)).to(device)
    combos = args.combos.split(",")
    print(f"# device={device} samples={x.shape[-1]:,}", file=sys.stderr)

    def run(combo, state):
        front, impl = combo.split(":")
        return st.stream_process(cfg, state, x, FS, front=front, impl=impl)

    st0 = st.stream_init(scfg, device=device)
    ref = boundaries(run(REFERENCE, st0)[1])
    found = {}
    for combo in combos:
        (_, ev, _), launches = tb.launches_of(lambda: run(combo, st0), device)
        got = boundaries(ev)
        same = got[0] == ref[0] and all(np.array_equal(a, b) for a, b in zip(got[1:], ref[1:]))
        found[combo] = {"events": got[0], f"events_equal_to_{REFERENCE}": same,
                        "launches_per_call": launches}
        print(f"# {combo}: {got[0]} events, events_equal_to_{REFERENCE}={same}", file=sys.stderr)
    mismatched = [c for c, f in found.items() if not f[f"events_equal_to_{REFERENCE}"]]
    if mismatched:
        print(json.dumps({"combos": found, "mismatched": mismatched}))
        return 1

    rows = {}
    for combo in combos:
        state = [st0]

        def call(combo=combo):
            state[0], ev, _ = run(combo, state[0])
            return ev

        s = tb.summary(tb.time_calls(call, device, args.reps, warmup=1))
        per_hour = s["median_ms"] / args.hours
        rows[combo] = {**found[combo], **s, "ms_per_hour_of_audio": per_hour,
                       "x_realtime": seconds / (s["median_ms"] / 1e3)}
        print(f"{combo}: {per_hour:.3f} ms/hour-of-audio (median of {s['n_calls']}, "
              f"p90 {s['p90_ms'] / args.hours:.3f}), {rows[combo]['x_realtime']:,.0f}x realtime, "
              f"{found[combo]['events']} events, "
              f"launches a call {found[combo]['launches_per_call']}")
    card = tb.nvidia_smi_line() if device.type == "cuda" else None
    print(card or "cpu (host clock)")
    print(json.dumps({"tool": "torch_streaming_bench", "device": str(device), "card": card,
                      "hours": args.hours, "combos": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
