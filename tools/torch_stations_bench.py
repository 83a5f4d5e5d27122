"""Wide-station-batch solver comparison of the PyTorch/CUDA port on one card
(BASELINE config 5).

The port's counterpart of ``tools/stations_bench.py``: ``bench.py``'s
stations fixture (``torch_bench.stations_fixture``, seed 7; G3 at 64 x
600 s) uploaded pre-blocked, the bins front (``stream_front_headless``)
once, then each solver on the same series: the scan (``stream_scan``, K3's
plain twin, a loop over the blocks), the episode jump (``stream_scan_jump``)
and the windowed jump (``stream_scan_jump_batch``, ``hop``) -- on a card
each one K3 launch, on the CPU the lockstep loops -- and
``fused`` (``stream_scan_fused_batch``, K3).  Before any time is printed,
every solver's events are held against the scan's: count, start and stop
times bit for bit, and a mismatch ends the run with exit code 1.

Then each solver is timed twice, each call between CUDA events after
warm-up (the host clock with ``--device cpu``): the solve alone on the
front's series from a fresh state, and the pipeline (front + solve) with
the state carried from call to call as ``bench.py`` chains it.  K3's own
call (``stream_scan_fused_batch``'s solve) stands beside every row, so the
table reads jump's and hop's cost against the kernel they run.  The JAX
tool's ``--chain`` belonged to the TPU's in-graph chained timing and is not
ported.

    python3 tools/torch_stations_bench.py [--stations 64] [--seconds 600]
        [--impls scan,jump,hop] [--reps 10] [--device cuda]

Prints a table line a solver, the ``nvidia-smi`` name and power limit, and
one JSON line with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stations", type=int, default=64)
    p.add_argument("--seconds", type=float, default=600.0)
    p.add_argument("--impls", default="scan,jump,hop", help="scan, jump, hop or fused")
    p.add_argument("--reps", type=int, default=10, help="timed calls a solver and measure")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch_bench as tb
    from meteor_scatter_tpu_torch.device import resolve_device
    from meteor_scatter_tpu_torch.models import streaming as st

    device = resolve_device(args.device)
    solvers = {"scan": st.stream_scan, "jump": st.stream_scan_jump,
               "hop": st.stream_scan_jump_batch, "fused": st.stream_scan_fused_batch}
    impls = args.impls.split(",")
    unknown = [i for i in impls if i not in solvers]
    if unknown:
        p.error(f"unknown --impls {unknown} (scan, jump, hop or fused)")
    cfg = tb.stations_config()
    scfg = st.StreamConfig.from_config(cfg)
    fs = tb.STATIONS_FS
    x_np, _ = tb.stations_fixture(args.stations, args.seconds)
    block = int(round(cfg.proc_block_sec * fs))
    x = torch.from_numpy(x_np.reshape(args.stations, -1, block)).to(device)
    st0 = st.stream_init_batch(scfg, args.stations, device=device)
    on, pm, _ = st.stream_front_headless(cfg, x, fs)
    print(f"# device={device} stations={args.stations} samples/ch={x_np.shape[1]:,}",
          file=sys.stderr)

    ref = st.stream_scan(scfg, st0, on, pm)[1]
    checked = {}
    for impl in impls:
        (_, ev, _), launches = tb.launches_of(lambda: solvers[impl](scfg, st0, on, pm), device)
        same = all(tb.bits_equal(getattr(ev, f), getattr(ref, f))
                   for f in ("count", "time_start", "time_stop"))
        checked[impl] = {"events": int(ev.count.sum()), "events_equal_to_scan": same,
                         "launches_per_call": launches}
        print(f"# {impl}: {int(ev.count.sum())} events, events_equal_to_scan={same}",
              file=sys.stderr)
    mismatched = [i for i, c in checked.items() if not c["events_equal_to_scan"]]
    if mismatched:
        print(json.dumps({"impls": checked, "mismatched": mismatched}))
        return 1

    def solve_ms(solver):
        return tb.summary(tb.time_calls(lambda: solver(scfg, st0, on, pm), device, args.reps,
                                        warmup=1), "solve")

    k3 = solve_ms(st.stream_scan_fused_batch)
    rows = {}
    for impl in impls:
        state = [st0]

        def pipeline(solver=solvers[impl]):
            o, p_, _ = st.stream_front_headless(cfg, x, fs)
            state[0], ev, _ = solver(scfg, state[0], o, p_)
            return ev

        s = tb.summary(tb.time_calls(pipeline, device, args.reps, warmup=1))
        agg = x_np.size / (s["median_ms"] / 1e3)
        rows[impl] = {**checked[impl], **s, **solve_ms(solvers[impl]), "agg_samples_per_s": agg,
                      "x_realtime": agg / (fs * args.stations)}
        r = rows[impl]
        print(f"{impl}: pipeline {s['median_ms']:.3f} ms (p90 {s['p90_ms']:.3f}, n {s['n_calls']}) "
              f"per {args.seconds:.0f} s x {args.stations} ch, {agg / 1e9:.3f} G agg samples/s, "
              f"{r['x_realtime']:,.0f}x realtime; solve {r['solve_median_ms']:.3f} ms beside K3's "
              f"call {k3['solve_median_ms']:.3f} ms; launches a solve {r['launches_per_call']}")
    card = tb.nvidia_smi_line() if device.type == "cuda" else None
    print(card or "cpu (host clock)")
    print(json.dumps({"tool": "torch_stations_bench", "device": str(device), "card": card,
                      "stations": args.stations, "seconds": args.seconds,
                      "k3_call": k3, "impls": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
