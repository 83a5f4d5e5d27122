#!/usr/bin/env python3
"""Where K1's time goes on the card: clock64 stamps by phase.

Builds an instrumented copy of ``meteor_scatter_tpu_torch/csrc/adaptive_solver.cu``
(stamps inserted at the phase boundaries by text substitution; the kernel's
arithmetic is untouched) into ``build/torch_kernels/`` and runs it at the
``chip_smoke.py`` K1 cases.  Prints one JSON line per case: per CTA the
cycles of each phase and of the wait at each grid sync after it, as medians
over the CTAs, the slowest CTA's speculative walk, CTA 0's fix-up, and the
fix-up's counts (untrusted seams, walks, blocks walked), with the device
time of the uninstrumented kernel (the profiler's, mean of 20 launches);
and the SM clock at the end.  Run from the root of a checkout on a machine
with an NVIDIA GPU::

    python3 tools/torch_k1_phase_cycles.py

It imports nothing of JAX.  The stamps cost cycles of their own, so phase
sums exceed the uninstrumented kernel's time a little.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from meteor_scatter_tpu_torch.ops.kernels import _build  # noqa: E402
from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as ak  # noqa: E402

WALK_SLOTS = 16  # stamps per CTA
MAX_GRID = 2048

# The kernel's grid syncs, in order, and the phase each one ends.
WALK_SYNCS = [
    ("stats_scan", "segment totals published"),
    ("stats_offsets", "cs / cs2 published"),
    ("windowed_mask", "windowed and the free-above mask published"),
    ("speculative_walk", "speculation published"),
    ("fixup", "keys final"),
    ("run_scan", "run totals published"),
]
WALK_END = ("      p.csm[i - c.halo] = __fadd_rn(__fadd_rn(om, bm), m_loc[j]);\n    }\n  }\n}\n")


def stamp(slot: int) -> str:
    return "if (threadIdx.x == 0) g_walk_stamps[%d * blockIdx.x + %d] = clock64();" % (
        WALK_SLOTS, slot)


def instrument(src: str) -> str:
    """The kernel source with cycle counters in ``g_walk_stamps`` (per CTA:
    the start, then the clock before and after each grid sync, then the
    end)."""
    edits = [
        ("namespace {\n", "namespace {\n__device__ long long g_walk_stamps[%d];\n"
         % (WALK_SLOTS * MAX_GRID)),
        ("  const int g = blockIdx.x, G = p.grid;\n",
         "  const int g = blockIdx.x, G = p.grid;\n  %s\n" % stamp(0)),
        (WALK_END, WALK_END[:-2] + "  __syncthreads();\n  %s\n}\n" % stamp(2 * len(WALK_SYNCS) + 1)),
    ]
    for k, (_, note) in enumerate(WALK_SYNCS):
        edits.append(("  grid.sync();  // %s\n" % note,
                      "  %s\n  grid.sync();  // %s\n  %s\n" % (stamp(2 * k + 1), note, stamp(2 * k + 2))))
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found once in the kernel source: {old!r}")
        src = src.replace(old, new)
    return src + (
        '\nextern "C" int ms_read_walk_stamps(long long* out, int n) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_walk_stamps, n * sizeof(long long));\n}\n")


def build() -> ctypes.CDLL:
    src = (_build.CSRC / "adaptive_solver.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / "adaptive_solver_stamps.cu"
    lib = _build.BUILD_DIR / "libadaptive_solver_stamps.so"
    path.write_text(instrument(src))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(lib))


def stamped_run(stamped: ctypes.CDLL, plain: ctypes.CDLL, args: tuple) -> None:
    _build._libs["adaptive_solver"] = stamped
    try:
        ak._launch(*args)
        torch.cuda.synchronize()
    finally:
        _build._libs["adaptive_solver"] = plain


def read(fn, n: int) -> np.ndarray:
    buf = (ctypes.c_longlong * n)()
    if fn(buf, n):
        raise RuntimeError("reading the stamps failed")
    return np.array(buf[:], dtype=np.int64)


def walk_record(stamped, plain, label: str, args: tuple) -> dict:
    total, halo = args[0].shape[0], args[3]
    G = -(-total // ak.SEGMENT)
    ms = cs.kernel_device_ms(lambda: ak._launch(*args), "walk_kernel")
    stamped_run(stamped, plain, args)
    fixup = ak.last_fixup.tolist()
    t = read(stamped.ms_read_walk_stamps, WALK_SLOTS * G).reshape(G, WALK_SLOTS)
    phases, waits = {}, {}
    for k, (name, _) in enumerate(WALK_SYNCS):
        phases[name] = t[:, 2 * k + 1] - t[:, 2 * k]
        waits[name] = t[:, 2 * k + 2] - t[:, 2 * k + 1]
    end = 2 * len(WALK_SYNCS)
    phases["run_offsets_write"] = t[:, end + 1] - t[:, end]
    return {
        "case": label, "n": total, "halo": halo, "ctas": G, "kernel_ms": ms,
        "untrusted_seams": fixup[0], "fixup_walks": fixup[1], "fixup_blocks": fixup[2],
        "cycles_total_median": float(np.median(t[:, end + 1] - t[:, 0])),
        "phase_cycles_median": {k: float(np.median(v)) for k, v in phases.items()},
        "sync_wait_cycles_median": {k: float(np.median(v)) for k, v in waits.items()},
        "speculative_walk_cycles_max": int(phases["speculative_walk"].max()),
        "fixup_cycles_cta0": int(phases["fixup"][0]),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k1_phase_cycles.py: needs a CUDA device", file=sys.stderr)
        return 1
    cs.DEVICE = "cuda"
    stamped = build()
    plain = _build.load("adaptive_solver")
    for label in cs.K1_CASES:
        args = cs.k1_args(label)
        print(json.dumps(walk_record(stamped, plain, label, args)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
