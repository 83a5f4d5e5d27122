"""Readings that the limits of ``limits/<workload>.json`` are set from: the
compared numbers of sound runs of the program over many seeds, and of the
control, the reference computed with its products in TF32, put in the
program's place for the same answers, over a few.

    python3 bench_h100/calibrate.py --workload network64_replay --seconds 3 \\
        --seeds 101 102 ... --control-seeds 101 102 103

One process: each seed makes its own inputs and runs a short window of
the cell's own traffic at its own size, so the comparison covers as many
answers of each kind as a run does.  Prints one JSON line a seed and run.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import importlib

    import torch

    from bench_h100 import harness

    bench = harness.read_json(ROOT, "BENCHMARK.json")
    for seed in args.seeds:
        cell = harness.load_cell(bench, args.workload, seed, args.seconds, False, args.device)
        cell.workdir = os.path.join(tempfile.gettempdir(), "bench_h100", cell.name)
        os.makedirs(cell.workdir, exist_ok=True)
        drv = importlib.import_module("bench_h100.drivers." + cell.traffic["driver"]).Driver(cell)
        t0 = time.perf_counter()
        drv.setup()
        recs = drv.window(args.seconds, harness.Tracer(False, args.device, ""))
        drv.free()
        gc.collect()
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
        runs = [("program", False)] + ([("control", True)] if seed in args.control_seeds else [])
        for kind, control in runs:
            cmp, answers = drv.judge(control=control)
            print(json.dumps({"workload": args.workload, "seed": seed, "run": kind,
                              "requests": len(recs), "answers": answers, "ties_excused": cmp.ties,
                              **cmp.numbers(), "wall_s": time.perf_counter() - t0}), flush=True)
        del drv
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
