"""Stage-by-stage cost of the port's at-spec I/Q front-end chain on one card
(BASELINE config 4).

The port's counterpart of ``tools/iq_breakdown.py``.  ``bench.py``'s I/Q
fixture (``synth_wideband_iq``, seed 3: 2 MS/s, stations 50 kHz apart
around 0 Hz, 2 001 taps, decimation 500 to 4 kHz audio), each stage
``--reps`` calls between CUDA events after warm-up (the host clock with
``--device cpu``), every call from the fresh state:

  P1  the bank GEMM from the capture uploaded pre-framed
      (``frame_capture_host``): ``hh^T @ frames^T``, one FP32
      ``torch.matmul``, as ``ops/fir.py::_bank_apply`` takes it
  P2  P1 + the per-row rotation = ``channelize_iq_frames``
  P3  P2 + the headless bins front (``stream_front_headless``)
  P4  P3 + K3 (``stream_scan_fused_batch``) = the full chain from the
      pre-framed capture, as ``torch_bench.py --frontend-iq`` times it
  S1  the flat capture framed on the device (``torch.stack`` of re and im,
      then ``ops/fir.py::_polyphase_frames``: one padded copy, then a view)
      + the bank GEMM
  S4  the full chain from the flat capture framed on the device

On the TPU, S1 - P1 measured the tiled-layout relayout of an in-graph
pad + reshape.  No layout work is ported: on the card the framed view is
free and S1 - P1 is the two copies of the capture that framing it on the
device makes (the stack and the pad), memory traffic a pre-framed upload
avoids.  The JAX tool's S5 (the chained timing's ``x + eps`` harness
artifact) is not ported: single calls on inputs already on the device have
no chain and no ``eps``; nor is its ``--chain``.

Before timing, S4's solve (state, events, thresholds) must equal P4's bit
for bit (framed on the host == framed on the device); a mismatch ends the
run with exit code 1.

    python3 tools/torch_iq_breakdown.py [--seconds 10] [--stations 8]
        [--stages S1,P1,P2,P3,P4,S4] [--reps 100] [--device cuda]

Prints a line a stage with its rate, the differences between stages, the
bank GEMM's bound, the ``nvidia-smi`` name and power limit, and one JSON
line with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("S1", "P1", "P2", "P3", "P4", "S4")
# (label, later stage, earlier stage)
DIFFERENCES = (
    ("framing on the device: stack + padded copy (S1-P1)", "S1", "P1"),
    ("bank rotation (P2-P1)", "P2", "P1"),
    ("front + solver (P4-P2)", "P4", "P2"),
    ("framing inside the full chain (S4-P4)", "S4", "P4"),
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--stations", type=int, default=8)
    p.add_argument("--stages", default=",".join(STAGES))
    p.add_argument("--reps", type=int, default=100, help="timed calls a stage")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import torch_bench as tb
    from meteor_scatter_tpu_torch.apps.frontend import synth_wideband_iq
    from meteor_scatter_tpu_torch.device import resolve_device
    from meteor_scatter_tpu_torch.models import streaming as st
    from meteor_scatter_tpu_torch.ops import fir

    device = resolve_device(args.device)
    stages = args.stages.split(",")
    unknown = [s for s in stages if s not in STAGES]
    if unknown:
        p.error(f"unknown --stages {unknown} (of {','.join(STAGES)})")
    fs, audio_rate = 2_000_000, tb.STATIONS_FS
    decim = fs // audio_rate
    freqs = tb.iq_station_freqs(args.stations)
    centers = np.asarray([f - tb.STATIONS_TONE_HZ for f in freqs])
    x_re, x_im, _ = synth_wideband_iq(fs, args.seconds, freqs, seed=3)
    n = x_re.size
    cfg = tb.stations_config()
    scfg = st.StreamConfig.from_config(cfg)
    plan, tables = fir.channel_bank_plan(n, fs, centers, bandwidth=1500.0, decim=decim,
                                         numtaps=2001, device=device)
    hh = tables[0]
    pl, m, q = plan["pl"], plan["m"], plan["q"]
    f = torch.from_numpy(fir.frame_capture_host(np.stack([x_re, x_im]), plan)).to(device)
    xr = torch.from_numpy(x_re).to(device)
    xi = torch.from_numpy(x_im).to(device)
    st0 = st.stream_init_batch(scfg, args.stations, device=device)
    print(f"# device={device} n={n} m={m} q={q} a_cols={plan['a_cols']} "
          f"n_out={plan['n_out']} C={plan['c_n']}", file=sys.stderr)

    def framed_on_device():
        return fir._polyphase_frames(torch.stack([xr, xi]), pl, m, q)

    def gemm(frames):
        return torch.matmul(hh.t(), frames.transpose(-1, -2))

    def audio(frames):
        return fir.channelize_iq_frames(frames, tables, plan)[0]

    def chain(frames):
        on, pm, _ = st.stream_front_headless(cfg, audio(frames), audio_rate)
        return st.stream_scan_fused_batch(scfg, st0, on, pm)

    bodies = {
        "P1": lambda: gemm(f),
        "P2": lambda: fir.channelize_iq_frames(f, tables, plan),
        "P3": lambda: st.stream_front_headless(cfg, audio(f), audio_rate),
        "P4": lambda: chain(f),
        "S1": lambda: gemm(framed_on_device()),
        "S4": lambda: chain(framed_on_device()),
    }

    equal = tb.solves_equal(bodies["S4"](), bodies["P4"]())
    print(f"# S4 (framed on the device) equal to P4 (framed on the host): {equal}",
          file=sys.stderr)
    if not equal:
        print(json.dumps({"framed_equals_flat": False}))
        return 1

    rows = {}
    for name in stages:
        _, launches = tb.launches_of(bodies[name], device)
        s = tb.summary(tb.time_calls(bodies[name], device, args.reps))
        rows[name] = {**s, "complex_samples_per_s": n / (s["median_ms"] / 1e3),
                      "launches_per_call": launches}
        print(f"{name}: {s['median_ms']:.3f} ms (p90 {s['p90_ms']:.3f}, n {s['n_calls']}), "
              f"{rows[name]['complex_samples_per_s'] / 1e9:.2f} G complex samples/s; "
              f"launches a call {launches}")
    diffs = {}
    for label, a, b in DIFFERENCES:
        if a in rows and b in rows:
            diffs[label] = rows[a]["median_ms"] - rows[b]["median_ms"]
            print(f"{label}: {diffs[label]:.3f} ms")
    # the GEMM as the bank takes it: (2·C·A, q) @ (q, m), twice, FP32
    rows_m, cols = 2 * m, hh.shape[1]
    gemm_bound = tb.bound(4 * (rows_m * q + q * cols + rows_m * cols), 2.0 * rows_m * q * cols)
    print(f"bank GEMM bound: {gemm_bound['bound_ms']:.4f} ms ({gemm_bound['bound_by']})")
    card = tb.nvidia_smi_line() if device.type == "cuda" else None
    print(card or "cpu (host clock)")
    print(json.dumps({"tool": "torch_iq_breakdown", "device": str(device), "card": card,
                      "seconds": args.seconds, "stations": args.stations,
                      "framed_equals_flat": equal, "stages": rows, "differences_ms": diffs,
                      "bank_gemm_bound": gemm_bound}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
