"""Stage-by-stage cost of the port's 64-station streaming pipeline on one
card (BASELINE config 5).

The port's counterpart of ``tools/stations_breakdown.py``.  ``bench.py``'s
stations fixture (``torch_bench.stations_fixture``, seed 7; G3 at 64 x
600 s), uploaded pre-blocked, timed cumulatively, each stage ``--reps``
calls between CUDA events after warm-up (the host clock with
``--device cpu``):

  S1  the bins front (``stream_front_headless``: one FP32 GEMM on the
      blocks, the three band levels in dB, sanitised)
  S2  S1 + the base-threshold prologue as plain PyTorch
      (``stream_kernel.ring_base_thresholds``, K3's twin's first step: the
      rolling mean + k.std of the last ``avg_win`` values, one gather and
      add a window slot).  On a card K3 computes it inside its launch, so
      the card's pipeline never runs this stage; S2 - S1 is what that
      saves.
  S3  S1 + K3's launch in the kernel's layout (``stream_kernel.
      stream_solve``: prologue, state machine, compaction and ring in one
      launch; on the CPU its twin)
  S4  S1 + ``stream_scan_fused_batch``, the full solve as ``torch_bench.py
      --stations`` times it.  K3 compacts inside its launch, so S4 - S3 is
      the wrapper's host work only (the JAX kernel left the compaction to a
      separate epilogue).

The JAX tool's S5 timed its own harness: threading the chained timing's
dependency through ``x + eps`` re-materialised the 614 MB input every
iteration (``stations_breakdown.py:14-19``), a cost the pipeline never
pays.  The port times single calls on inputs already on the device, with
no chain and no ``eps``, so there is nothing to measure and S5 is not
ported; nor is the JAX tool's ``--chain``.

Before timing, S3's and S4's solve (state, events, thresholds) must equal
the scan twin's (``stream_scan``) bit for bit; a mismatch ends the run with
exit code 1.

    python3 tools/torch_stations_breakdown.py [--stations 64] [--seconds 600]
        [--stages S1,S2,S3,S4] [--reps 100] [--device cuda]

Prints a line a stage with its increment over the stage it extends, the
``nvidia-smi`` name and power limit, and one JSON line with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ORDER = ("S1", "S2", "S3", "S4")
# the stage each one extends: S2 and S3 both add to the front
BASE = {"S2": "S1", "S3": "S1", "S4": "S3"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stations", type=int, default=64)
    p.add_argument("--seconds", type=float, default=600.0)
    p.add_argument("--stages", default=",".join(ORDER))
    p.add_argument("--reps", type=int, default=100, help="timed calls a stage")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch_bench as tb
    from meteor_scatter_tpu_torch.device import resolve_device
    from meteor_scatter_tpu_torch.models import streaming as st
    from meteor_scatter_tpu_torch.ops.kernels import stream_kernel as sk

    device = resolve_device(args.device)
    stages = args.stages.split(",")
    unknown = [s for s in stages if s not in ORDER]
    if unknown:
        p.error(f"unknown --stages {unknown} (of {','.join(ORDER)})")
    cfg = tb.stations_config()
    scfg = st.StreamConfig.from_config(cfg)
    fs = tb.STATIONS_FS
    x_np, _ = tb.stations_fixture(args.stations, args.seconds)
    block = int(round(cfg.proc_block_sec * fs))
    x = torch.from_numpy(x_np.reshape(args.stations, -1, block)).to(device)
    st0 = st.stream_init_batch(scfg, args.stations, device=device)
    params = st.solve_params(scfg)
    print(f"# device={device} C={args.stations} n_blocks={x.shape[1]} w={scfg.avg_win}",
          file=sys.stderr)

    def front():
        return st.stream_front_headless(cfg, x, fs)[:2]

    def k3(on, pm):
        s, ev, thr = sk.stream_solve(on, pm, tuple(st0), **params)
        return st.StreamState(*s), st.StreamEvents(*ev), thr

    bodies = {
        "S1": front,
        "S2": lambda: sk.ring_base_thresholds(st0.ring, st0.block_idx, front()[0], scfg.avg_win,
                                              scfg.k_std),
        "S3": lambda: k3(*front()),
        "S4": lambda: st.stream_scan_fused_batch(scfg, st0, *front()),
    }

    on, pm = front()
    ref = st.stream_scan(scfg, st0, on, pm)
    equal = {"S3": tb.solves_equal(bodies["S3"](), ref), "S4": tb.solves_equal(bodies["S4"](), ref)}
    print(f"# S3 and S4 equal to the scan twin: {equal}", file=sys.stderr)
    if not all(equal.values()):
        print(json.dumps({"equal_to_scan": equal}))
        return 1
    del on, pm, ref

    rows = {}
    for name in stages:
        _, launches = tb.launches_of(bodies[name], device)
        s = tb.summary(tb.time_calls(bodies[name], device, args.reps))
        base = rows.get(BASE.get(name))
        inc = s["median_ms"] - base["median_ms"] if base else None
        rows[name] = {**s, "launches_per_call": launches, "increment_ms": inc}
        note = f"  ({inc:+.3f} ms over {BASE[name]})" if inc is not None else ""
        print(f"{name}: {s['median_ms']:.3f} ms (p90 {s['p90_ms']:.3f}, n {s['n_calls']}){note}"
              f"; launches a call {launches}")
    card = tb.nvidia_smi_line() if device.type == "cuda" else None
    print(card or "cpu (host clock)")
    print(json.dumps({"tool": "torch_stations_breakdown", "device": str(device), "card": card,
                      "stations": args.stations, "seconds": args.seconds,
                      "equal_to_scan": equal, "stages": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
