#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``meteor_scatter_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero (there is no CPU fallback):

1. device  — ``torch.cuda`` must be available; the card's name and the
   ``nvidia-smi`` name / power-limit line.
2. build   — compiles every kernel of the main path from ``csrc/`` with nvcc.
3. kernels — each kernel against its plain PyTorch twin on the card at the
   main path's shapes, with stated tolerances, and both timed with CUDA
   events.
4. e2e     — synthesizes a 24 h, 6 kHz, int16 mono WAV with a 1 s 1003 Hz
   tone every 47 s, runs ``meteor_scatter_tpu_torch.apps.analyze.main`` on
   it on the card (fused adaptive solver), checks that the kernel was
   launched once per chunk, that every tone overlaps a detected event, and
   that the plain-PyTorch solver (``impl="parallel"``) gives the same events.

The last three lines are the ``nvidia-smi`` line, one JSON object with a
record per kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

DEVICE = "cuda"  # one card: the current CUDA device
FS = 6000
HOURS = 24
BLOCK_SEC = 0.2
TONE_HZ = 1003.0
TONE_EVERY_SEC = 47.0
# main-path solver parameters: k = 4, 120 s window, 3 s / 20 s freeze,
# 10 s fixed start, at 0.2 s blocks
SOLVER = dict(
    threshold_std_factor=4.0,
    window_blocks=600,
    freeze_blocks_before=15,
    freeze_blocks_after=100,
    fixed_threshold_blocks=50,
)
# Kernel vs twin: the two take their float prefix sums in different orders.
# At 131 072 blocks of a delta series with a 3 dB spread and 30 dB bursts,
# the prefix sum of d*d reaches ~4e6 (f32 ulp 0.25-0.5); over the W = 600
# window that moves m2 by ~1e-3 and the threshold m + 4*std by ~1e-3 dB.
THR_TOL_DB = 1e-2
CSM_RTOL = 1e-5  # of max|csm|: ~160 f32 ulps
# Event means, fused vs parallel: the fused path reads a run's sum as the
# difference of a float32 prefix sum that reaches ~1e5 within a 131 072-block
# chunk (ulp 2**-7); over a 5-block run that is ~2e-3 dB of the mean.
EVENT_DB_TOL = 1e-2

KERNELS = {
    "adaptive_solver": dict(
        route="cuda",
        source="meteor_scatter_tpu_torch/csrc/adaptive_solver.cu",
        replaces="meteor_scatter_tpu/ops/pallas/adaptive_kernel.py:143",
    ),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def phase_device() -> dict:
    import torch

    info = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": nvidia_smi_line(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    emit(info)
    return info


def phase_build() -> None:
    from meteor_scatter_tpu_torch.ops.kernels import _build

    for name in KERNELS:
        t0 = time.perf_counter()
        _build.load(name)
        ptxas = [ln.strip() for ln in _build.build_log(name).splitlines() if "ptxas info" in ln]
        emit({
            "phase": "build", "kernel": name,
            "seconds": time.perf_counter() - t0,
            "ptxas": ptxas[-3:],
        })


def cuda_ms(fn, warmup: int = 2, reps: int = 7) -> float:
    """Median over ``reps`` of one call, by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def delta_series(n: int, seed: int) -> np.ndarray:
    """A delta-dB-like series: 3 dB noise with 5-block 30 dB bursts."""
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal(n) * 3.0).astype(np.float32)
    for s in rng.integers(10, n - 10, size=max(n // 235, 1)):
        d[s : s + 5] += 30.0
    return d


def phase_kernels() -> dict:
    """K1 (kernel) against its twin on the card, at the main path's shapes."""
    import torch

    from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as ak

    dev = torch.device(DEVICE)
    w = SOLVER["window_blocks"]
    k = SOLVER["threshold_std_factor"]
    cases = []
    for label, n, halo in (("1h", 18000, 0), ("chunk_first", ak.MAX_FUSED_BLOCKS, 0),
                           ("chunk_haloed", ak.MAX_FUSED_BLOCKS, w)):
        d = torch.from_numpy(delta_series(n, seed=n + halo)).to(dev)
        fixed_thr = d.mean() + k * d.std(correction=0)
        if halo:  # a later chunk: i0 past the first chunk, frozen on entry
            i0 = ak.MAX_FUSED_BLOCKS - w
            carry_i = torch.tensor([i0, i0 + 40], dtype=torch.int32, device=dev)
            carry_f = torch.stack([fixed_thr, fixed_thr + 1.5]).float()
        else:
            carry_i = torch.tensor([0, -1], dtype=torch.int32, device=dev)
            carry_f = torch.stack([fixed_thr, fixed_thr]).float()
        args = (d, carry_i, carry_f, halo, k, w, SOLVER["freeze_blocks_before"],
                SOLVER["freeze_blocks_after"], SOLVER["fixed_threshold_blocks"], n)
        thr_k, ab_k, s_k, c_k = ak._launch(*args)
        thr_p, ab_p, s_p, c_p = ak.adaptive_solver_plain(*args)
        torch.cuda.synchronize()
        case = {
            "case": label, "n": n, "halo": halo,
            "above_equal": bool(torch.equal(ab_k, ab_p)),
            "s_incl_equal": bool(torch.equal(s_k, s_p)),
            "n_above": int(ab_p.sum()),
            "runs": int(s_p[-1]),
            "thr_max_abs_err": float((thr_k - thr_p).abs().max()),
            "csm_max_abs_err": float((c_k - c_p).abs().max()),
            "csm_tol": CSM_RTOL * max(1.0, float(c_p.abs().max())),
            "ms": cuda_ms(lambda: ak._launch(*args)),
            "plain_ms": cuda_ms(lambda: ak.adaptive_solver_plain(*args)),
        }
        case["ok"] = (
            case["above_equal"] and case["s_incl_equal"]
            and case["thr_max_abs_err"] <= THR_TOL_DB
            and case["csm_max_abs_err"] <= case["csm_tol"]
        )
        emit({"phase": "kernel_check", "kernel": "adaptive_solver", **case})
        cases.append(case)
    bad = [c["case"] for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"adaptive_solver kernel disagrees with its twin in {bad}")
    main_shape = next(c for c in cases if c["case"] == "chunk_haloed")
    return {
        "max_abs_err": max(c["thr_max_abs_err"] for c in cases),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
    }


def synth_wav(path: str, hours: int, seed: int) -> np.ndarray:
    """Noise (std 0.5) plus a 1 s tone of amplitude 2 every 47 s from 10 s on,
    as ``bench.py::synth_audio``, made on the card and written as int16.
    Returns the tone start times in seconds."""
    import torch

    from meteor_scatter_tpu_torch.io.wavio import write_wav

    dev = torch.device(DEVICE)
    seconds = hours * 3600
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(FS * seconds, generator=g, device=dev) * 0.5
    starts = np.arange(10.0, seconds - 5.0, TONE_EVERY_SEC)
    j = torch.arange(FS, dtype=torch.float64, device=dev)
    for s in starts:
        a = int(round(s * FS))
        tone = 2.0 * torch.sin(2 * math.pi * TONE_HZ * (a + j) / FS)
        x[a : a + FS] += tone.float()
    pcm = torch.clamp(torch.round(x * 3000.0), -32768, 32767).to(torch.int16).cpu().numpy()
    del x
    write_wav(path, FS, pcm)
    return starts


def read_rows(path: str) -> list:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def timer_totals(text: str) -> dict:
    """Phase totals from a ``PhaseTimer.summary()`` printed by ``main``."""
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^(\S[^:\n]*): total ([0-9.]+)s", text, re.M)}


def phase_e2e(tmp: str) -> dict:
    import torch

    from meteor_scatter_tpu_torch.apps import analyze
    from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as ak

    wav = os.path.join(tmp, "brams_gqrx_20260817_000000_49969000.wav")
    t0 = time.perf_counter()
    starts = synth_wav(wav, HOURS, seed=2026)
    synth_s = time.perf_counter() - t0
    n_blocks = FS * HOURS * 3600 // int(FS * BLOCK_SEC)
    chunk = ak.MAX_FUSED_BLOCKS - SOLVER["window_blocks"]
    want_launches = 1 if n_blocks <= ak.MAX_FUSED_BLOCKS else math.ceil(n_blocks / chunk)

    out = {k: os.path.join(tmp, k) for k in ("fused.csv", "fused.txt", "par.csv", "par.txt")}
    # --- the main path, through the CLI entry point; counted launches ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ak.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = analyze.main([wav, "--out-csv", out["fused.csv"], "--out-audacity", out["fused.txt"],
                           "--device", DEVICE])
    main_wall = time.perf_counter() - t0
    launches = ak.launches
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"analyze.main returned {rc}")
    if launches != want_launches:
        raise AssertionError(f"adaptive_solver launched {launches} times, expected {want_launches}")
    phases = timer_totals(log.getvalue())

    fused = read_rows(out["fused.csv"])
    t_start = np.array([float(r["t_start"]) for r in fused])
    t_stop = np.array([float(r["t_stop"]) for r in fused])
    missed = [float(s) for s in starts
              if not np.any((t_start < s + 1.0) & (t_stop > s))]
    if missed:
        raise AssertionError(f"{len(missed)} of {len(starts)} tones not detected, first {missed[:5]}")
    if not fused[0]["utc_start"]:
        raise AssertionError("gqrx file name gave no UTC start time")
    if len(fused) >= 4096:
        raise AssertionError(f"{len(fused)} events fill the 4096-event buffer")

    # --- plain PyTorch solver on the card: same events ---
    res_par = analyze.proc_wav_file(
        wav, out_csv_file=out["par.csv"], out_audacity_lbl_file=out["par.txt"],
        wav_start_date_time=analyze.parse_gqrx_start_time(wav), expected_sample_rate=None,
        impl="parallel", device=DEVICE, verbose=False,
    )
    par = read_rows(out["par.csv"])
    keys = ("t_start", "t_stop", "dur_s", "utc_start", "utc_stop")
    if len(par) != len(fused) or any(
        tuple(a[k] for k in keys) != tuple(b[k] for k in keys) for a, b in zip(fused, par)
    ):
        raise AssertionError("fused and parallel event lists differ")
    db_err = max(abs(float(a["dB"]) - float(b["dB"])) for a, b in zip(fused, par))
    if db_err > EVENT_DB_TOL:
        raise AssertionError(f"event dB differs by {db_err} between fused and parallel")
    with open(out["fused.txt"], "rb") as fa, open(out["par.txt"], "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError("Audacity label files differ between fused and parallel")
    for name in ("band_power", "noise_power", "delta_power", "thresholds"):
        arr = getattr(res_par, name)
        if arr.shape != (n_blocks,) or not np.isfinite(arr).all():
            raise AssertionError(f"{name}: shape {arr.shape} or non-finite values")

    # --- warm repeat of the fused path for steady-state phase times ---
    res_warm = analyze.proc_wav_file(
        wav, expected_sample_rate=None, impl="fused", device=DEVICE, verbose=False,
    )
    if len(res_warm.detections) != len(fused):
        raise AssertionError("warm fused run found a different number of events")

    e2e = {
        "phase": "e2e", "hours": HOURS, "samples": FS * HOURS * 3600, "blocks": n_blocks,
        "synth_write_s": synth_s, "launches": launches, "want_launches": want_launches,
        "events": len(fused), "tones": len(starts), "tones_missed": 0,
        "fused_equals_parallel": True, "event_db_max_abs_err": db_err,
        "main_wall_s": main_wall, "main_phases_s": phases,
        "warm_fused_phases_s": dict(res_warm.timer.totals),
        "parallel_phases_s": dict(res_par.timer.totals),
        "peak_device_bytes": peak,
    }
    emit(e2e)
    return e2e


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 1
    try:
        import meteor_scatter_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke.py: run it from the root of a checkout ({e})", file=sys.stderr)
        return 1

    info = phase_device()
    phase_build()
    k1 = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        e2e = phase_e2e(tmp)
    if "jax" in sys.modules:
        raise AssertionError("the port imported JAX")

    print(nvidia_smi_line())
    emit({"kernels": [{
        "name": "adaptive_solver", **KERNELS["adaptive_solver"],
        "launches": e2e["launches"], **k1,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"], "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
