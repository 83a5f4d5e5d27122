"""Benchmark of the PyTorch and CUDA port (``meteor_scatter_tpu_torch``) on
NVIDIA GPUs: one run of one cell of ``BENCHMARK.json``.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The run makes its inputs from the seed,
warms up, measures for ``--seconds``, then compares what the timed path
produced with the plain reference under ``bench_h100/reference/`` and
prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics, read from a ``torch.profiler``
trace of the window's first seconds), ``device``, with ``--trace 1``
``breakdown``, and last ``checked``, each compared number with its limit,
which also end standard error.

Without a CUDA device, with fewer devices than the cell asks for, or with
JAX or the JAX package loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_age_s() -> float:
    """Seconds from the process's start to ``_STARTED`` (interpreter start-up
    and imports before this module ran), from ``/proc``; 0 where there is
    none."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
    except (OSError, IndexError, ValueError):
        return 0.0
    age_now = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return max(0.0, age_now - (time.perf_counter() - _STARTED))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    process_start = _STARTED - process_age_s()

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    import meteor_scatter_tpu_torch  # noqa: F401  (the program under test)
    from bench_h100 import harness

    bench = harness.read_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 1
    cell = harness.load_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                             "cuda")
    result = harness.run_cell(cell, process_start)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, v in result["checked"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
