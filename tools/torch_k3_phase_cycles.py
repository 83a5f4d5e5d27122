#!/usr/bin/env python3
"""Where K3's time goes on the card: clock64 stamps per CTA, by phase.

Builds an instrumented copy of ``meteor_scatter_tpu_torch/csrc/stream_machine.cu``
(stamps inserted at the phase boundaries by text substitution; the kernel's
arithmetic is untouched) into ``build/torch_kernels/`` and runs it at the
``chip_smoke.py`` K3 shapes: 64 x 3 000 fresh (stations) and 1 x 300 carried
(live feed).  Prints one JSON line per shape with the median over channels
of the cycles spent in each phase — staging (bulk-copy wait), prologue,
decisions, and inside the decisions each kind of round (Init, Detect
unlocked, Detect locked, Track) with its count — the device time of the
uninstrumented kernel, and the SM clock.  Run from the root of a checkout
on a machine with an NVIDIA GPU::

    python3 tools/torch_k3_phase_cycles.py

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
from meteor_scatter_tpu_torch.models import streaming as st  # noqa: E402
from meteor_scatter_tpu_torch.ops.kernels import _build  # noqa: E402
from meteor_scatter_tpu_torch.ops.kernels import stream_kernel as sk  # noqa: E402

SLOTS = 16  # stamps per channel
BRANCH = "st == INIT ? 0 : (st == DETECT && ib + b > luntil ? 1 : (st == DETECT ? 2 : 3))"


def instrument(src: str) -> str:
    """The kernel source with per-CTA cycle counters written to ``g_stamps``:
    [total, staging, prologue, decisions, cycles of the four kinds of
    round, rounds of each kind]."""
    edits = [
        ("namespace {\n", "namespace {\n__device__ long long g_stamps[%d];\n" % (SLOTS * 65536)),
        ("  const bool bulk = (reinterpret_cast",
         "  long long t_all = clock64(), t_stage = 0, t_pro = 0, t_dec = 0, t_mark = 0;\n"
         "  long long t_kind[4] = {0, 0, 0, 0}, n_kind[4] = {0, 0, 0, 0};\n"
         "  const bool bulk = (reinterpret_cast"),
        ("    if (bulk) {\n      bulk_wait(", "    t_mark = clock64();\n    if (bulk) {\n      bulk_wait("),
        ("    // ---- prologue", "    t_stage += clock64() - t_mark;\n    t_mark = clock64();\n    // ---- prologue"),
        ("    // ---- decisions", "    t_pro += clock64() - t_mark;\n    t_mark = clock64();\n    // ---- decisions"),
        ("      for (int b = 0; b < L;) {\n        const int q = b + lane;\n",
         "      for (int b = 0; b < L;) {\n        const int q = b + lane;\n"
         "        const long long t_round = clock64();\n        const int kind = %s;\n" % BRANCH),
        ("          b += last + 1;\n        }\n      }\n    }\n    __syncthreads();\n",
         "          b += last + 1;\n        }\n"
         "        switch (kind) {\n"
         + "".join("          case %d: t_kind[%d] += clock64() - t_round; n_kind[%d] += 1; break;\n" % (k, k, k)
                   for k in range(4))
         + "        }\n      }\n    }\n    __syncthreads();\n    t_dec += clock64() - t_mark;\n"),
        ("#pragma unroll\n    for (int f = 0; f < 7; ++f) p.ev[f][at] = 0.f;\n  }\n}\n",
         "#pragma unroll\n    for (int f = 0; f < 7; ++f) p.ev[f][at] = 0.f;\n  }\n"
         "  if (tid == 0) {\n    long long* g = g_stamps + %d * c;\n"
         "    g[0] = clock64() - t_all; g[1] = t_stage; g[2] = t_pro; g[3] = t_dec;\n"
         "    for (int k = 0; k < 4; ++k) { g[4 + k] = t_kind[k]; g[8 + k] = n_kind[k]; }\n  }\n}\n" % SLOTS),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found once in the kernel source: {old!r}")
        src = src.replace(old, new)
    return src + (
        '\nextern "C" int ms_read_stamps(long long* out, int n) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_stamps, n * sizeof(long long));\n}\n")


def build() -> ctypes.CDLL:
    src = (_build.CSRC / "stream_machine.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / "stream_machine_stamps.cu"
    lib = _build.BUILD_DIR / "libstream_machine_stamps.so"
    path.write_text(instrument(src))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k3_phase_cycles.py: needs a CUDA device", file=sys.stderr)
        return 1
    cs.DEVICE = "cuda"
    scfg = st.StreamConfig.from_config(cs.live_config())
    stamped = build()
    for label, C, n, carried in (("stations", 64, 3000, False), ("live_feed", 1, 300, True)):
        on, pm = cs.stream_series(C, 2 * n if carried else n, seed=C * n)
        state = st.stream_init_batch(scfg, C, device="cuda")
        if carried:
            state = st.stream_scan(scfg, state, on[:, :n], pm[:, :n])[0]
            on, pm = on[:, n:].contiguous(), pm[:, n:].contiguous()
        args, kw = (on, pm, tuple(state)), st.solve_params(scfg)
        plain_lib = _build.load("stream_machine")
        ms = cs.kernel_device_ms(lambda: sk._launch(*args, **kw), "stream_solve_kernel")
        _build._libs["stream_machine"] = stamped
        try:
            sk._launch(*args, **kw)
            torch.cuda.synchronize()
        finally:
            _build._libs["stream_machine"] = plain_lib
        buf = (ctypes.c_longlong * (SLOTS * C))()
        if stamped.ms_read_stamps(buf, SLOTS * C):
            raise RuntimeError("reading the stamps failed")
        g = np.array(buf[:], dtype=np.int64).reshape(C, SLOTS)
        med = np.median(g, axis=0)
        print(json.dumps({
            "case": label, "C": C, "n": n, "kernel_ms": ms,
            "cycles": {"total": med[0], "staging": med[1], "prologue": med[2], "decisions": med[3]},
            "round_cycles": dict(zip(("init", "detect", "detect_locked", "track"), med[4:8].tolist())),
            "rounds": dict(zip(("init", "detect", "detect_locked", "track"), med[8:12].tolist())),
        }), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
