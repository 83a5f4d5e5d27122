#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``meteor_scatter_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA GPU::

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and the script exits
non-zero (there is no CPU fallback):

1. device        — ``torch.cuda`` must be available; the card's name and
   the ``nvidia-smi`` name / power-limit line.
2. build         — compiles every kernel from ``csrc/`` with nvcc, one
   process per source, all started together.
3. kernel_check  — each kernel against its plain PyTorch twin on the card at
   the main paths' shapes, with stated tolerances, both timed with CUDA
   events: K1 (adaptive solver), K3 (streaming state machine, bit-exact at
   3 000 x 64 fresh, 300 x 1 carried mid-track, 1 100 x 130) and K2 (band
   power at the 24 h analyzer shape, with ``torch.matmul`` plus the same
   epilogue as a yardstick the port never calls).
4. e2e           — a 24 h, 6 kHz, int16 WAV with a 1 s 1003 Hz tone every
   47 s through ``apps.analyze.main`` (K1 launched once per chunk, every
   tone detected, fused == parallel events).
5. e2e_bandpower — the same day through ``fused_bandpower_delta`` (one K2
   launch), against the analyzer's band power.
6. e2e_live      — a 24 h, 4 kHz, int16 WAV with a 1 s 1000 Hz tone every
   47 s through ``apps.live.main`` (welch front, impl auto = fused: K3
   launched once per 60 s feed, every tone detected, no overflow); fused
   == scan events on the first hour; the headless (bins) front over the
   day; a profiled hour.
7. e2e_stations  — 64 stations x 600 s at 4 kHz, pre-blocked, through
   ``stream_front_headless`` + ``stream_scan_fused_batch`` (one K3
   launch), events bit-equal to the scan twin's, every station's tone
   found, aggregate samples/s.

Each main path is driven with every launch count set to 0 just before it
and read just after.  The last three lines are the ``nvidia-smi`` line, one
JSON object with a record per kernel, and ``{"ok": true, "device": {...}}``.
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
from concurrent.futures import ThreadPoolExecutor

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

# The live / stations configuration (BASELINE config 5): 4 kHz, 0.2 s blocks,
# n_fft 4096, 1000 Hz signal band, accept mean >= 1 dB and duration >= 0.5 s.
ANALYZE_WAV = "brams_gqrx_20260817_000000_49969000.wav"
LIVE_FS = 4000
LIVE_HOURS = 24
LIVE_TONE_HZ = 1000.0
LIVE_ARGS = ["--min-dur", "0.5", "--min-mean-db", "1"]
STATIONS, STATION_SECONDS = 64, 600.0
# K2 against its twin: the JAX package's own kernel tolerances in dB
# (tests/test_pallas_kernels.py): band, noise, delta.
K2_ATOL = (2e-3, 2e-3, 4e-3)
# Card peaks for the bound (H100 SXM data sheet): HBM bytes/s, FP32 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

KERNELS = {
    "adaptive_solver": dict(
        route="cuda",
        source="meteor_scatter_tpu_torch/csrc/adaptive_solver.cu",
        replaces="meteor_scatter_tpu/ops/pallas/adaptive_kernel.py:143",
    ),
    "bandpower": dict(
        route="cuda",
        source="meteor_scatter_tpu_torch/csrc/bandpower.cu",
        replaces="meteor_scatter_tpu/ops/pallas/bandpower_kernel.py:36",
    ),
    "stream_machine": dict(
        route="cuda",
        source="meteor_scatter_tpu_torch/csrc/stream_machine.cu",
        replaces="meteor_scatter_tpu/ops/pallas/stream_kernel.py:56",
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
    """One nvcc per source, all started together."""
    from meteor_scatter_tpu_torch.ops.kernels import _build

    def build(name):
        t0 = time.perf_counter()
        _build.load(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        seconds = dict(zip(KERNELS, pool.map(build, KERNELS)))
    for name in KERNELS:
        log = _build.build_log(name).splitlines()
        emit({
            "phase": "build", "kernel": name, "seconds": seconds[name],
            "ptxas": [ln.strip() for ln in log if "registers" in ln or "spill" in ln],
        })


def bound(bytes_moved: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the FP32 operations over the FP32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "flops": flops}


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


def phase_kernel_k1() -> dict:
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
    total, n = main_shape["n"], main_shape["n"] - main_shape["halo"]
    # the wrapper's inputs (series, two 2-word carries) and outputs (thr,
    # above as bytes, s_incl, csm); operations: the one-pass rolling stats
    # and run sums (~16 per block) and one fixpoint round (the least work)
    return {
        "max_abs_err": max(c["thr_max_abs_err"] for c in cases),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        **bound(4 * total + 16 + 13 * n, 16 * total + n),
        "library_ms": None,
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

    wav = os.path.join(tmp, ANALYZE_WAV)
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


def bits_equal(a, b) -> bool:
    """Equal bit for bit (NaN payloads included)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def stream_series(C: int, n: int, seed: int):
    """Over-noise-like series on the card: 0.3 dB noise with 2-30 block
    bursts of 2-10 dB (some rejected as short), and PSD means."""
    import torch

    rng = np.random.default_rng(seed)
    on = (rng.standard_normal((C, n)) * 0.3).astype(np.float32)
    for c in range(C):
        for b in rng.integers(50, max(n - 50, 51), size=max(n // 150, 1)):
            on[c, b : b + int(rng.integers(2, 30))] += rng.uniform(2.0, 10.0)
    pm = (-80.0 + rng.standard_normal((C, n))).astype(np.float32)
    return torch.from_numpy(on).to(DEVICE), torch.from_numpy(pm).to(DEVICE)


def live_config():
    from meteor_scatter_tpu_torch.config import DetectionConfig

    return DetectionConfig(signal_freq=LIVE_TONE_HZ, detection_db_over_noise_mean_min=1.0,
                           detection_dur_min_sec=0.5)


def phase_kernel_k3() -> dict:
    """K3 (kernel) against its twin on the card, bit for bit on all nine
    output series and both carries: the stations shape from a fresh state,
    the live feed shape from a carried mid-track state, and a ragged warp
    with more than 128 channels."""
    import torch

    from meteor_scatter_tpu_torch.models import streaming as st
    from meteor_scatter_tpu_torch.ops.kernels import stream_kernel as sk

    scfg = st.StreamConfig.from_config(live_config())
    cases = []
    for label, C, n, carried in (("stations", 64, 3000, False), ("live_feed", 1, 300, True),
                                 ("ragged", 130, 1100, False)):
        if carried:  # a burst over the seam: the second feed starts inside a track
            on, pm = stream_series(C, 2 * n, seed=11)
            on[:, n - 20 : n + 30] += 12.0
            state, _, _ = st.stream_scan(scfg, st.stream_init_batch(scfg, C, DEVICE),
                                         on[:, :n], pm[:, :n])
            if not bool((state.state == st.TRACK).all()):
                raise AssertionError("the carried live-feed state is not mid-track")
            on, pm = on[:, n:], pm[:, n:]
        else:
            on, pm = stream_series(C, n, seed=C * n)
            state = st.stream_init_batch(scfg, C, DEVICE)
        args, kw, _ = st.machine_inputs(scfg, state, on, pm)
        ys_k, cf_k, ci_k = sk._launch(*args, **kw)
        ys_p, cf_p, ci_p = sk.stream_machine_plain(*args, **kw)
        torch.cuda.synchronize()
        outs = list(zip(ys_k, ys_p)) + [(cf_k, cf_p), (ci_k, ci_p)]
        unequal = [k for k, (a, b) in enumerate(outs) if not bits_equal(a, b)]
        finite = [(a.float() - b.float())[torch.isfinite(b.float())].abs() for a, b in outs]
        case = {
            "case": label, "C": C, "n": n, "carried": carried,
            "bit_exact": not unequal, "unequal_outputs": unequal,
            "max_abs_err": max(float(e.max()) if e.numel() else 0.0 for e in finite),
            "emitted": int(ys_p[1].sum()), "nan_base_thr_blocks": int(torch.isnan(args[2]).sum()),
            "ms": cuda_ms(lambda: sk._launch(*args, **kw)),
            "plain_ms": cuda_ms(lambda: sk.stream_machine_plain(*args, **kw), warmup=1, reps=3),
            # in: on, pm, base thr + the carry; out: nine series + the carry;
            # ~20 float operations per block and channel
            **bound(12 * 4 * n * C + 2 * 14 * 4 * C, 20 * n * C),
        }
        emit({"phase": "kernel_check", "kernel": "stream_machine", **case})
        cases.append(case)
    bad = [c["case"] for c in cases if not c["bit_exact"]]
    if bad:
        raise AssertionError(f"stream_machine kernel is not bit-exact against its twin in {bad}")
    main_shape = cases[0]
    return {
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": None,
    }


def analyzer_day(tmp: str):
    """The 24 h, 6 kHz day of the analyzer phase, on the card as float32."""
    import torch

    from meteor_scatter_tpu_torch.io.wavio import read_wav

    fs, pcm = read_wav(os.path.join(tmp, ANALYZE_WAV), mono=True)
    return torch.from_numpy(pcm).to(DEVICE).to(torch.float32)


def phase_kernel_k2(x) -> dict:
    """K2 (kernel) against its twin on the card at the 24 h analyzer shape:
    432 000 frames read in place (row stride 1200, L = 1024), the 14-column
    projection of bands (993, 1013) / (690, 710) at n_fft 1024."""
    import torch

    from meteor_scatter_tpu_torch.ops import bandpower as bp
    from meteor_scatter_tpu_torch.ops.kernels import bandpower_kernel as bk

    block = int(FS * BLOCK_SEC)
    M, slices = bp.band_projection_matrix(FS, 1024, block, [(993.0, 1013.0), (690.0, 710.0)])
    proj = torch.from_numpy(M).to(DEVICE)
    L, ncols = M.shape
    nb = slices[0].stop
    nf = x.shape[0] // block
    frames = x[: nf * block].reshape(nf, block)

    def library():  # one cuBLAS FP32 product plus the same epilogue
        p2 = torch.matmul(frames[:, :L], proj).square_()
        b = 10.0 * torch.log10(p2[:, :nb].sum(1) + 1e-12)
        nz = 10.0 * torch.log10(p2[:, nb:].sum(1) + 1e-12)
        return b, nz, b - nz

    got = bk._launch(frames, proj, nb, 1e-12)
    want = bk.band_power_db_plain(frames, proj, nb, 1e-12)
    lib = library()
    torch.cuda.synchronize()
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    lib_errs = [float((g - w).abs().max()) for g, w in zip(lib, want)]
    case = {
        "case": "24h", "frames": nf, "L": L, "columns": ncols, "row_stride": block,
        "max_abs_err_db": errs, "tol_db": list(K2_ATOL), "library_max_abs_err_db": lib_errs,
        "ms": cuda_ms(lambda: bk._launch(frames, proj, nb, 1e-12)),
        "plain_ms": cuda_ms(lambda: bk.band_power_db_plain(frames, proj, nb, 1e-12)),
        "library_ms": cuda_ms(library),
        # frames' first L samples, the projection, three outputs; 2 flops
        # per multiply-add of the product
        **bound(4 * nf * L + 4 * L * ncols + 3 * 4 * nf, 2.0 * nf * L * ncols),
    }
    emit({"phase": "kernel_check", "kernel": "bandpower", **case})
    if any(e > t for e, t in zip(errs, K2_ATOL)):
        raise AssertionError(f"bandpower kernel differs from its twin by {errs} dB")
    return {k: case[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} | {
        "max_abs_err": max(errs)}


def phase_e2e_bandpower(x) -> dict:
    """The fused band-power entry point over the analyzer's day: one K2
    launch, against the analyzer's ``torch.matmul`` band power."""
    import torch

    from meteor_scatter_tpu_torch.ops import bandpower as bp
    from meteor_scatter_tpu_torch.ops.kernels import bandpower_kernel as bk

    args = (FS, 1024, int(FS * BLOCK_SEC), (993.0, 1013.0), (690.0, 710.0))
    torch.cuda.synchronize()
    bk.launches = 0
    t0 = time.perf_counter()
    got = bk.fused_bandpower_delta(x, *args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bk.launches
    if launches != 1:
        raise AssertionError(f"bandpower launched {launches} times, expected 1")
    want = bp.delta_power_db(x, *args)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    if any(e > t for e, t in zip(errs, K2_ATOL)) or not all(bool(torch.isfinite(g).all()) for g in got):
        raise AssertionError(f"fused_bandpower_delta differs from delta_power_db by {errs} dB")
    out = {"phase": "e2e_bandpower", "frames": int(got[0].shape[0]), "launches": launches,
           "wall_s": wall, "max_abs_err_db_vs_analyzer": errs}
    emit(out)
    return out


def synth_live_wav(path: str, hours: float, seed: int) -> np.ndarray:
    """Noise (std 0.05) plus a 1 s 1000 Hz tone of amplitude 0.6 every 47 s
    from 20 s on, at 4 kHz, made on the card and written as int16 (levels of
    tests/test_streaming_headless.py).  Returns the tone start times."""
    import torch

    from meteor_scatter_tpu_torch.io.wavio import write_wav

    seconds = int(hours * 3600)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(LIVE_FS * seconds, generator=g, device=DEVICE) * 0.05
    starts = np.arange(20.0, seconds - 5.0, TONE_EVERY_SEC)
    j = torch.arange(LIVE_FS, dtype=torch.float64, device=DEVICE)
    for s in starts:
        a = int(round(s * LIVE_FS))
        x[a : a + LIVE_FS] += (0.6 * torch.sin(2 * math.pi * LIVE_TONE_HZ * (a + j) / LIVE_FS)).float()
    pcm = torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(torch.int16).cpu().numpy()
    del x
    write_wav(path, LIVE_FS, pcm)
    return starts


EVENT_LINE = re.compile(r"^Detected Meteor: start=([0-9.]+)s stop=([0-9.]+)s", re.M)


def missed_tones(starts, events) -> list:
    """Tones (1 s from each start) that no (start, stop) event overlaps."""
    if not events:
        return [float(s) for s in starts]
    t0 = np.array([e[0] for e in events])
    t1 = np.array([e[1] for e in events])
    return [float(s) for s in starts if not np.any((t0 < s + 1.0) & (t1 > s))]


def run_live_main(argv: list):
    """``apps.live.main`` with its stdout captured: (events from the printed
    lines, stdout, wall seconds, K3 launches, peak device bytes)."""
    import torch

    from meteor_scatter_tpu_torch.apps import live
    from meteor_scatter_tpu_torch.ops.kernels import stream_kernel as sk

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = live.main(argv)
    wall = time.perf_counter() - t0
    launches = sk.launches
    if rc != 0:
        raise RuntimeError(f"live.main returned {rc}")
    text = log.getvalue()
    events = [(float(a), float(b)) for a, b in EVENT_LINE.findall(text)]
    return events, text, wall, launches, torch.cuda.max_memory_allocated()


def device_rows(prof) -> list:
    """(name, device ms, calls) of each kernel and copy in a profile, the
    largest first; device-side rows only (the CPU ops that launch them
    carry the same time again)."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def phase_e2e_live(tmp: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from meteor_scatter_tpu_torch.apps import live
    from meteor_scatter_tpu_torch.io.wavio import read_wav

    wav = os.path.join(tmp, "live_4khz_24h.wav")
    t0 = time.perf_counter()
    starts = synth_live_wav(wav, LIVE_HOURS, seed=47)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    read_wav(wav, mono=True)
    read_s = time.perf_counter() - t0
    seconds = LIVE_HOURS * 3600
    feeds = math.ceil(seconds / 60.0)

    # --- the main path: the CLI, welch front, impl auto (fused on the card) ---
    welch, text, wall, launches, peak = run_live_main([wav, "--device", DEVICE, *LIVE_ARGS])
    if launches != feeds:
        raise AssertionError(f"stream_machine launched {launches} times, expected {feeds}")
    if "overflow" in text:
        raise AssertionError("a per-chunk event buffer overflowed")
    missed = missed_tones(starts, welch)
    if missed:
        raise AssertionError(f"{len(missed)} of {len(starts)} tones not detected, first {missed[:5]}")

    # --- fused == scan on the first hour (the scan is K3's twin on the card) ---
    cfg = live_config()
    hour = {}
    for impl in ("fused", "scan"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            hour[impl] = live.wav_file_process(wav, cfg, wav_file_stop_sec=3600,
                                               expected_sample_rate=None, impl=impl, device=DEVICE)
        hour[impl + "_s"] = time.perf_counter() - t0
    if hour["fused"] != hour["scan"]:
        raise AssertionError("fused and scan event lists differ on the first hour")

    # --- the headless (bins) front over the whole day ---
    bins, text_b, wall_b, launches_b, peak_b = run_live_main(
        [wav, "--device", DEVICE, "--headless", *LIVE_ARGS])
    missed_b = missed_tones(starts, bins)
    if missed_b or launches_b != feeds:
        raise AssertionError(f"headless: {len(missed_b)} tones missed, {launches_b} launches")
    differ = len(set(welch) ^ set(bins))

    # --- one hour of the main path under the profiler: device busy share ---
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            live.wav_file_process(wav, cfg, wav_file_stop_sec=3600, expected_sample_rate=None,
                                  device=DEVICE)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_ms = sum(r[1] for r in rows)

    out = {
        "phase": "e2e_live", "hours": LIVE_HOURS, "samples": LIVE_FS * seconds,
        "blocks": seconds * 5, "synth_write_s": synth_s, "read_wav_s": read_s,
        "feeds": feeds, "launches": launches, "tones": len(starts), "tones_missed": 0,
        "events_welch": len(welch), "main_wall_s": wall, "peak_device_bytes": peak,
        "hour_fused_equals_scan": True, "hour_events": len(hour["fused"]),
        "hour_fused_s": hour["fused_s"], "hour_scan_s": hour["scan_s"],
        "events_headless": len(bins), "headless_wall_s": wall_b,
        "headless_peak_device_bytes": peak_b, "headless_tones_missed": 0,
        "boundaries_differing_welch_vs_headless": differ,
        "profiled_hour_wall_s": prof_wall, "profiled_hour_device_busy_ms": busy_ms,
        "profiled_hour_device_top": [[k, round(ms, 3), n] for k, ms, n in rows[:8]],
    }
    emit(out)
    return out


def phase_e2e_stations() -> dict:
    """64 stations x 600 s (the fixture of the reference package's stations
    benchmark, seed 7), uploaded pre-blocked; one K3 launch for the batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from meteor_scatter_tpu_torch.models import streaming as st
    from meteor_scatter_tpu_torch.ops.kernels import stream_kernel as sk

    cfg = live_config()
    scfg = st.StreamConfig.from_config(cfg)
    block = int(round(cfg.proc_block_sec * LIVE_FS))
    n = int(LIVE_FS * STATION_SECONDS) // block * block
    rng = np.random.default_rng(7)
    x_np = rng.standard_normal((STATIONS, n)).astype(np.float32) * 0.3
    t = np.arange(n) / LIVE_FS
    tones = []
    for c in range(STATIONS):
        s0 = 20.0 + (7.0 * c) % max(STATION_SECONDS - 30.0, 1.0)
        m = (t >= s0) & (t < s0 + 1.0)
        x_np[c, m] += 1.5 * np.sin(2 * np.pi * LIVE_TONE_HZ * t[m]).astype(np.float32)
        tones.append(s0)
    x = torch.from_numpy(x_np.reshape(STATIONS, n // block, block)).to(DEVICE)
    del x_np
    st0 = st.stream_init_batch(scfg, STATIONS, DEVICE)

    # --- the main path: bins front, then one fused launch for all stations ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.launches = 0
    on, pm, _ = st.stream_front_headless(cfg, x, LIVE_FS)
    st_f, ev_f, thr_f = st.stream_scan_fused_batch(scfg, st0, on, pm)
    torch.cuda.synchronize()
    launches = sk.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != 1:
        raise AssertionError(f"stream_machine launched {launches} times, expected 1")

    # --- the scan twin on the same series: the same events, bit for bit ---
    st_s, ev_s, thr_s = st.stream_scan(scfg, st0, on, pm)
    same = (all(bits_equal(a, b) for a, b in zip(ev_f, ev_s))
            and all(bits_equal(a, b) for a, b in zip(st_f, st_s)) and bits_equal(thr_f, thr_s))
    if not same:
        raise AssertionError("stations: fused and scan outputs differ")
    counts = ev_f.count.cpu().numpy()
    t0s, t1s = ev_f.time_start.cpu().numpy(), ev_f.time_stop.cpu().numpy()
    missed = [c for c in range(STATIONS)
              if missed_tones([tones[c]], list(zip(t0s[c, : counts[c]], t1s[c, : counts[c]])))]
    if missed or bool(ev_f.overflow.any()):
        raise AssertionError(f"stations: tones missed at stations {missed[:8]}")

    def pipeline():
        o, p, _ = st.stream_front_headless(cfg, x, LIVE_FS)
        return st.stream_scan_fused_batch(scfg, st0, o, p)

    total_ms = cuda_ms(pipeline, warmup=2, reps=9)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipeline()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    out = {
        "phase": "e2e_stations", "stations": STATIONS, "seconds": STATION_SECONDS,
        "blocks": int(on.shape[1]), "launches": launches, "events": int(counts.sum()),
        "tones_missed": 0, "fused_equals_scan": True, "peak_device_bytes": peak,
        "pipeline_ms": total_ms,
        "front_ms": cuda_ms(lambda: st.stream_front_headless(cfg, x, LIVE_FS), warmup=2, reps=9),
        "solve_ms": cuda_ms(lambda: st.stream_scan_fused_batch(scfg, st0, on, pm), warmup=2, reps=9),
        "agg_samples_per_s": STATIONS * n / (total_ms / 1e3),
        "profiled_device_ms": sum(r[1] for r in rows),
        "profiled_device_top": [[k, round(ms, 3), c] for k, ms, c in rows[:10]],
    }
    emit(out)
    return out


def port_modules_loaded_from_jax() -> list:
    """JAX or JAX-package modules present in this process."""
    return [k for k, v in sys.modules.items() if v is not None and (
        k.split(".")[0] == "jax" or k == "meteor_scatter_tpu" or k.startswith("meteor_scatter_tpu."))]


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

    t_start = time.perf_counter()
    info = phase_device()
    phase_build()
    records = {"adaptive_solver": phase_kernel_k1(), "stream_machine": phase_kernel_k3()}
    with tempfile.TemporaryDirectory() as tmp:
        e2e = phase_e2e(tmp)
        x = analyzer_day(tmp)
        records["bandpower"] = phase_kernel_k2(x)
        e2e_bp = phase_e2e_bandpower(x)
        del x
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        e2e_live = phase_e2e_live(tmp)
    e2e_st = phase_e2e_stations()
    loaded = port_modules_loaded_from_jax()
    if loaded:
        raise AssertionError(f"the port loaded JAX or the JAX package: {loaded[:5]}")

    launches = {"adaptive_solver": e2e["launches"], "bandpower": e2e_bp["launches"],
                "stream_machine": e2e_live["launches"] + e2e_st["launches"]}
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi_line())
    emit({"kernels": [{"name": name, **KERNELS[name], "launches": launches[name], **records[name]}
                      for name in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"], "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
