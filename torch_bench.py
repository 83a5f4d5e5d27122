#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: audio samples/s on one card through
band power + adaptive detection, and five opt-in secondary metrics.

The port's counterpart of ``bench.py`` (the JAX package's benchmark, which
stays as it is): the same constants, flags, sizes, seeds and metric keys,
through the port's own public functions.  It imports ``torch`` and
``meteor_scatter_tpu_torch``, never JAX, the JAX package or ``bench.py``;
the numpy pieces it needs (``synth_audio``, ``baseline_numpy``, the
fixtures, the bytes-per-sample table) are copies here.  Run from the root of
a checkout::

    python3 torch_bench.py [--quick] [--multi] [--stations] [--image]
        [--frontend] [--frontend-iq] [--no-verify] [--profile DIR]
        [--device cuda|cpu]

Timing, single calls.  Every metric is the time of one call of its
pipeline on inputs already on the device, taken with CUDA events around the
call after warm-up, over :data:`REPS` calls.  A metric reports its median,
its p90 and the number of timed calls; its rate comes from the median.
Host syncs inside a call count, since a user pays them: ``events_from_mask``
reads its fixed-point range check (``to_fixed_point``, one sync per
detected series), and the image path's label loops test for a change once
a round.  The pageable upload of each
input is timed on its own, as ``{prefix}_upload_ms``, and is not in the
rate.  With ``--device cpu`` the same calls run on the CPU, timed by the
host clock, and the artifact says so (``clock``); no number of such a run is
a card's.  ``--profile DIR`` adds, after each metric's timed calls, a few
calls under ``torch.profiler`` and a summary of their trace (device time,
launches, copies and host waits a call); the timed calls are never
profiled.

Timing, chained.  ``bench.py`` runs k dependent calls inside one jitted
``fori_loop``, the dependency threaded through a tiny table (an eps that is
1 only after a NaN), and estimates a call as ``(tk - t1) / (k - 1)``
(:func:`chained_timing`, ``bench.py:60-90``).  Here one call of a
pipeline, with the same dependency, is captured as one CUDA graph
(:func:`capture`), and ``timed(k)`` is k replays of it between two CUDA
events: no host work inside a call, as in the jitted program.  Every key
but ``image`` (whose label loops test for a change on the host) reports
``{p}chained_ms`` and ``{p}chained_samples_per_sec`` beside its single-call
fields, bench.py's ``{p}t1_ms``, ``{p}tk_ms``, ``{p}chain_k`` (and
``{p}noise_bound``), and the gate ``{p}chain_equals_eager``: one replay from
the metric's starting inputs or state against one eager call from the same,
every output bit for bit.  A capture that fails raises.  With ``--device
cpu``, ``timed(k)`` is a host loop of k calls.

Gates.  ``fused_equals_parallel`` (the headline hour's events through K1's
route and through the fixpoint), ``stations_fused_equals_scan`` (K3 against
its twin, bit for bit), at the full size ``stations_golden_G3`` (the first
call's events against the JAX package's, ``tests/data/golden/G3.json.gz``),
``frontend_iq_framed_equals_flat`` and the five ``chain_equals_eager``.  A
gate that reads false is printed in the artifact and the program exits 1,
as it does when a rate implies more input traffic than the card's memory
can carry (``implausible``).  No failure of a requested metric is caught:
it raises, and the exit is not 0.

The last line printed is the JSON artifact.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# tools/golden_compare.py and tools/golden_fixtures.py: numpy and the stdlib
TOOLS = os.path.join(REPO, "tools")

# ---------------------------------------------------------------------------
# workload: BRAMS-like 6 kHz audio, reference analyzer parameters
# (bench.py:26-39)
# ---------------------------------------------------------------------------
FS = 6000
BLOCK_SEC = 0.2
BLOCK = int(FS * BLOCK_SEC)
N_FFT = 1024  # effective (reference user 512 doubled, main.py:353)
FREQ_BAND = (993.0, 1013.0)
NOISE_BAND = (690.0, 710.0)
K_STD = 4.0
WINDOW_BLOCKS = 600
FREEZE_BEFORE = 15
FREEZE_AFTER = 100
FIXED_INIT = 50
# detect_adaptive takes the solver's spans in seconds
ADAPTIVE_SEC = dict(
    threshold_estimation_window_sec=WINDOW_BLOCKS * BLOCK_SEC,
    threshold_freeze_before_detection_sec=FREEZE_BEFORE * BLOCK_SEC,
    threshold_freeze_after_detection_sec=FREEZE_AFTER * BLOCK_SEC,
    threshold_fixed_init_duration_sec=FIXED_INIT * BLOCK_SEC,
)
BATCH_CAP, MULTI_CAP = 4096, 1024  # bench.py's event caps (:183, :243)
MULTI_CHANNELS = 8

# Sizes, full and --quick (bench.py:718-720 and each call site); the
# headline hour is bench.py's TPU_SECONDS.
FULL = dict(batch_seconds=3600.0, baseline_seconds=60.0, multi_seconds=900.0,
            stations=64, stations_seconds=600.0, image_segments=8, image_seconds=30.0,
            frontend_seconds=10.0, frontend_iq_seconds=10.0, frontend_stations=8)
QUICK = dict(FULL, batch_seconds=300.0, baseline_seconds=20.0, multi_seconds=300.0,
             stations_seconds=120.0)

# Timed calls a metric (the p90 then has ten beyond it) and untimed calls
# before them.
REPS = 100
WARMUP = 3
UPLOAD_REPS = 5
PROFILED_CALLS = 10  # calls a metric under the profiler with --profile

# Card peaks (H100 SXM data sheet): HBM bytes/s and FP32 FLOP/s.  The
# roofline of every kernel in chip_smoke.py, and the ceiling below.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Every chain here streams its input from device memory at least once a
# call, so samples/s x bytes a sample can never exceed HBM_BYTES_PER_S; a
# metric above it is listed in the artifact's ``implausible``
# (bench.py:41-57, the same table).
METRIC_BYTES_PER_SAMPLE = {
    "value": 4.0,
    "multi8_samples_per_sec": 4.0,
    "stations64_samples_per_sec": 4.0,
    "image_samples_per_sec": 4.0,
    "channelizer_input_samples_per_sec": 4.0,
    "frontend_iq_2msps_samples_per_sec": 8.0,  # complex64-equivalent
}
# bench.py's chain length a key (k dependent calls in timed(k)); image is
# not chained (its label loops test for a change on the host once a round)
CHAIN_K = {"value": 201, "multi8": 101, "stations64": 101, "channelizer": 201,
           "frontend_iq": 101}
# each chained key's rate beside the single-call rate whose bytes a sample
# it shares
CHAINED_RATES = {"value": "chained_samples_per_sec",
                 "multi8_samples_per_sec": "multi8_chained_samples_per_sec",
                 "stations64_samples_per_sec": "stations64_chained_samples_per_sec",
                 "channelizer_input_samples_per_sec": "channelizer_chained_samples_per_sec",
                 "frontend_iq_2msps_samples_per_sec": "frontend_iq_chained_samples_per_sec"}
GATES = ("fused_equals_parallel", "stations_fused_equals_scan", "stations_golden_G3",
         "frontend_iq_framed_equals_flat", "chain_equals_eager", "multi8_chain_equals_eager",
         "stations64_chain_equals_eager", "channelizer_chain_equals_eager",
         "frontend_iq_chain_equals_eager")

# The live / stations configuration (BASELINE config 5; bench.py:357-362)
STATIONS_FS = 4000
STATIONS_TONE_HZ = 1000.0
# G3 is bench.py's stations fixture at 600 s; chip_smoke.py holds the card
# to it with these tolerances (its EVENT_DB_TOL, DURATION_TOL, THR_TOL_DB)
G3_SECONDS = 600.0
G3_DB_TOL, G3_DURATION_TOL, G3_THR_TOL = 1e-2, 1e-5, 1e-2


def bound(bytes_moved: float, flops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the FP32 operations over the FP32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "flops": flops}


def implausible_metrics(artifact: dict) -> list:
    """Metric fields, single-call and chained, whose value implies more
    input traffic than HBM carries."""
    fields = list(METRIC_BYTES_PER_SAMPLE.items())
    fields += [(CHAINED_RATES[f], bps) for f, bps in fields if f in CHAINED_RATES]
    return [f for f, bps in fields
            if artifact.get(f) is not None and artifact[f] * bps > HBM_BYTES_PER_S]


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# fixtures (numpy, from seeds)
# ---------------------------------------------------------------------------
def synth_audio(seconds: float, seed: int = 0) -> np.ndarray:
    """bench.py:98: 6 kHz noise with a 1 s 1003 Hz tone every 47 s from 10 s."""
    rng = np.random.default_rng(seed)
    n = int(FS * seconds)
    x = rng.standard_normal(n).astype(np.float32) * 0.5
    t = np.arange(n) / FS
    for s in np.arange(10.0, seconds - 5.0, 47.0):
        m = (t >= s) & (t < s + 1.0)
        x[m] += 2.0 * np.sin(2 * np.pi * 1003.0 * t[m]).astype(np.float32)
    return x


def baseline_numpy(x: np.ndarray) -> float:
    """bench.py:109: the reference hot loop (main.py:376-388 rfft band power,
    :450-522 adaptive threshold) in numpy on the host; returns samples/s."""
    freqs = np.fft.rfftfreq(N_FFT, d=1.0 / FS)
    m1 = (freqs >= FREQ_BAND[0]) & (freqs <= FREQ_BAND[1])
    m2 = (freqs >= NOISE_BAND[0]) & (freqs <= NOISE_BAND[1])
    w = np.hanning(BLOCK)
    nb = len(x) // BLOCK

    t0 = time.perf_counter()
    band = np.empty(nb)
    noise = np.empty(nb)
    for i in range(nb):
        blk = x[i * BLOCK : (i + 1) * BLOCK]
        X = np.fft.rfft(blk * w, n=N_FFT)
        P = np.abs(X) ** 2
        band[i] = 10 * np.log10(P[m1].sum() + 1e-12)
        noise[i] = 10 * np.log10(P[m2].sum() + 1e-12)
    delta = band - noise

    g_thr = delta.mean() + K_STD * delta.std()
    thr = g_thr
    freeze_until = -1
    for i in range(nb):
        if i < FIXED_INIT:
            thr = g_thr
        elif i > freeze_until:
            win = delta[max(0, i - WINDOW_BLOCKS) : i]
            thr = win.mean() + K_STD * win.std()
        if delta[i] > thr:
            freeze_until = max(i + FREEZE_AFTER, max(0, i - FREEZE_BEFORE))
    dt = time.perf_counter() - t0
    return len(x) / dt


def stations_fixture(n_stations: int, seconds: float):
    """bench.py:364-375 (seed 7): ``n_stations`` x ``seconds`` at 4 kHz,
    whole 0.2 s blocks, a 1 s tone a station at 20 + 7c (mod seconds - 30) s.
    At 600 s its rows are G3's (``tools/golden_fixtures.py::g3_stations``).
    Returns (x (n_stations, n) float32, the tones' starts)."""
    fs = STATIONS_FS
    block = int(round(BLOCK_SEC * fs))
    n = int(fs * seconds) // block * block
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n_stations, n)).astype(np.float32) * 0.3
    t = np.arange(n) / fs
    tones = []
    for c in range(n_stations):
        s0 = 20.0 + (7.0 * c) % max(seconds - 30.0, 1.0)
        m = (t >= s0) & (t < s0 + 1.0)
        x[c, m] += 1.5 * np.sin(2 * np.pi * STATIONS_TONE_HZ * t[m]).astype(np.float32)
        tones.append(s0)
    return x, tones


def image_fixture(n_segments: int, seconds: float, fs: int) -> np.ndarray:
    """bench.py:481-488 (seed 11): segments of noise (std 300) with 1 s
    1000 Hz bursts of amplitude 3000 at 8 + s and 20 s."""
    rng = np.random.default_rng(11)
    n = int(fs * seconds)
    x = rng.standard_normal((n_segments, n)).astype(np.float32) * 300.0
    t = np.arange(n) / fs
    for s in range(n_segments):
        for b0 in (8.0 + s, 20.0):
            m = (t >= b0) & (t < b0 + 1.0)
            x[s, m] += 3000.0 * np.sin(2 * np.pi * 1000.0 * t[m]).astype(np.float32)
    return x


def channelizer_fixture(seconds: float, n_stations: int):
    """bench.py:537-544 (seed 5): a real 1 MS/s capture of unit noise and
    the bank's channel centres, 1 kHz apart from 49 970 Hz."""
    fs = 1_000_000
    rng = np.random.default_rng(5)
    x = rng.standard_normal(int(fs * seconds)).astype(np.float32)
    return x, np.asarray([49_970 + 1000 * c for c in range(n_stations)])


def iq_station_freqs(n_stations: int) -> list:
    """bench.py:612-613: offsets 50 kHz apart centred on 0 Hz, 25 kHz for 0."""
    half = n_stations // 2
    return [50_000.0 * (i - half) or 25_000.0 for i in range(n_stations)]


def stations_config():
    """bench.py:358-362: the live detector's defaults at a 1000 Hz tone,
    accepting a mean of 1 dB over 0.5 s."""
    from meteor_scatter_tpu_torch.config import DetectionConfig

    return DetectionConfig(signal_freq=STATIONS_TONE_HZ, detection_db_over_noise_mean_min=1.0,
                           detection_dur_min_sec=0.5)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(fn, device: torch.device, reps: int = REPS, warmup: int = WARMUP) -> list:
    """Milliseconds of each of ``reps`` calls of ``fn`` after ``warmup``
    untimed ones: CUDA events around the call on a card (host work and
    syncs inside the call included), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(device)
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def summary(times: list, prefix: str = "") -> dict:
    """Median, p90 (the value with a tenth of the calls above it) and count
    of a list of call times, under ``{prefix}_`` (no prefix for the
    headline)."""
    p = f"{prefix}_" if prefix else ""
    ordered = sorted(times)
    return {f"{p}median_ms": statistics.median(ordered),
            f"{p}p90_ms": ordered[max(math.ceil(0.9 * len(ordered)) - 1, 0)],
            f"{p}n_calls": len(ordered)}


def trace_summary(path: str, calls: int, prefix: str = "") -> dict:
    """What ``calls`` calls did on the device, from a ``torch.profiler``
    chrome trace: device milliseconds (kernels, copies and fills), kernel
    records, launches and copies issued by the host, and host waits for
    the device (stream and device synchronises, less the one that closes
    the profiled window).  The tracer may drop kernel records, so the
    device time is a lower bound; launches come from the host's calls."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host = collections.Counter(e["name"] for e in events if e.get("cat") == "cuda_runtime")
    p = f"{prefix}_" if prefix else ""
    waits = host["cudaStreamSynchronize"] + host["cudaDeviceSynchronize"] - 1
    return {f"{p}profiled_calls": calls,
            f"{p}device_ms_per_call": sum(e.get("dur", 0) for e in dev) / 1e3 / calls,
            f"{p}kernel_records_per_call": sum(e["cat"] == "kernel" for e in dev) / calls,
            f"{p}launches_per_call_traced": sum(n for k, n in host.items()
                                                if "Launch" in k) / calls,
            f"{p}memcpy_per_call": host["cudaMemcpyAsync"] / calls,
            f"{p}host_waits_per_call": max(waits, 0) / calls}


@dataclasses.dataclass(frozen=True)
class Timing:
    """How a metric is timed: :func:`time_calls` of ``reps`` calls after
    ``warmup`` untimed ones, summarised by :func:`summary`.  With a
    ``profile_dir``, :data:`PROFILED_CALLS` more calls then run under
    ``torch.profiler`` (``utils/timing.py::maybe_profile``), their trace in
    ``profile_dir/<metric>/trace.json`` and its :func:`trace_summary` in
    the artifact; the timed calls are never profiled."""

    reps: int = REPS
    warmup: int = WARMUP
    profile_dir: Optional[str] = None

    def measure(self, run, device: torch.device, prefix: str = "") -> dict:
        return {**summary(time_calls(run, device, self.reps, self.warmup), prefix),
                **self.profile(run, device, prefix)}

    def profile(self, run, device: torch.device, prefix: str = "") -> dict:
        """With a ``profile_dir``, :data:`PROFILED_CALLS` calls of ``run``
        under ``torch.profiler`` and their :func:`trace_summary`; else
        nothing."""
        from meteor_scatter_tpu_torch.utils.timing import maybe_profile

        if not self.profile_dir:
            return {}
        trace_dir = os.path.join(self.profile_dir, prefix or "value")
        with maybe_profile(trace_dir):
            for _ in range(PROFILED_CALLS):
                run()
            sync(device)
        return trace_summary(os.path.join(trace_dir, "trace.json"), PROFILED_CALLS, prefix)


def upload_ms(host: np.ndarray, device: torch.device, reps: int = UPLOAD_REPS) -> float:
    """Median host-clock time of a pageable upload of ``host`` to the device,
    through the synchronise that ends it."""
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        torch.from_numpy(host).to(device)
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def launch_counts() -> dict:
    """The hand-written kernels' launch counters (each wrapper adds one a
    launch; the CPU's twins add none)."""
    from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as ak
    from meteor_scatter_tpu_torch.ops.kernels import bandpower_kernel as bk
    from meteor_scatter_tpu_torch.ops.kernels import bank_kernel as rk
    from meteor_scatter_tpu_torch.ops.kernels import stream_kernel as sk

    return {"adaptive_solver": ak.launches, "bandpower": bk.launches, "stream_machine": sk.launches,
            "bank_rotate": rk.launches}


def launches_of(fn, device: torch.device):
    """``fn()`` once, and the launches it made of each kernel."""
    before = launch_counts()
    out = fn()
    sync(device)
    after = launch_counts()
    return out, {k: after[k] - before[k] for k in after}


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN payloads included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def solves_equal(a, b) -> bool:
    """Two ``(state, events, thresholds)`` results of a streaming solve,
    every leaf bit for bit."""
    return (all(bits_equal(x, y) for x, y in zip(a[0], b[0]))
            and all(bits_equal(x, y) for x, y in zip(a[1], b[1])) and bits_equal(a[2], b[2]))


def chained_timing(timed, k: int, reps: int = 3, prefix: str | None = None):
    """bench.py:60-90, the same arithmetic and fields: ``timed(k)`` runs k
    dependent calls and returns wall seconds; a call is ``(min tk - min t1)
    / (k - 1)`` over ``reps`` of each, or ``tk / k`` (the round-trip-inclusive
    upper bound, flagged ``{prefix}_noise_bound``) when that is not
    positive.  Returns ``(dt_per_exec, diag)``; diag keys are prefixed
    ``{prefix}_t1_ms`` etc. (unprefixed for the headline)."""
    t1s = [timed(1) for _ in range(reps)]
    tks = [timed(k) for _ in range(reps)]
    t1, tk = min(t1s), min(tks)
    dt = (tk - t1) / (k - 1)
    noise_bound = dt <= 0
    if noise_bound:
        print(f"# warning: chained timing noise-bound ({prefix or 'headline'}); "
              "reporting the round-trip-inclusive upper bound", file=sys.stderr)
        dt = tk / k
    p = f"{prefix}_" if prefix else ""
    diag = {
        f"{p}t1_ms": [round(v * 1e3, 3) for v in t1s],
        f"{p}tk_ms": [round(v * 1e3, 3) for v in tks],
        f"{p}chain_k": k,
    }
    if noise_bound:
        diag[f"{p}noise_bound"] = True
    return dt, diag


@dataclasses.dataclass(frozen=True)
class Chain:
    """A pipeline with bench.py's dependency between calls.  ``step()`` is
    one call on the carry, tensors that it reads and overwrites in place
    (the previous call's value that makes the eps, or the stream state), and
    returns the call's outputs; ``start()`` puts the metric's starting value
    or state into the carry; ``eager()`` is one call of the metric's own
    pipeline from the same inputs, without the eps, with the outputs in
    ``step()``'s order."""

    step: Callable[[], tuple]
    start: Callable[[], None]
    eager: Callable[[], tuple]


def solve_outputs(solve) -> tuple:
    """A streaming solve's ``(state, events, thresholds)`` as one flat
    tuple: every state leaf, every event field, the thresholds."""
    state, events, thr = solve
    return (*state, *events, thr)


def state_chain(st0, call, eager) -> Chain:
    """A chain whose carry is a stream state, as bench.py's state-carried
    programs (:410-466, :648-677): ``call(state, eps)`` is one solve from
    ``state``, eps from the state's ``tr_sum[0]``, returning ``(state,
    events, thresholds)``; the carry starts as a copy of ``st0`` and takes
    each new state in place.  ``eager()`` is the metric's own solve from
    ``st0``."""
    carry = type(st0)(*(a.clone() for a in st0))

    def step():
        new, events, thr = call(carry, nan_eps(carry.tr_sum[0]))
        for a, b in zip(carry, new):
            a.copy_(b)
        return solve_outputs((carry, events, thr))

    def start():
        for a, b in zip(carry, st0):
            a.copy_(b)

    return Chain(step, start, lambda: solve_outputs(eager()))


def nan_eps(t: torch.Tensor) -> torch.Tensor:
    """bench.py's dependency: 1 where ``t`` is NaN, else 0 (float32, on
    ``t``'s device), added to a tiny table of the next call."""
    return torch.where(torch.isnan(t), 1.0, 0.0)


def capture(chain: Chain):
    """One ``chain.step()`` from the starting carry captured as a CUDA
    graph, after one eager step on a side stream (libraries set up their
    workspaces outside the capture).  Returns the graph, the outputs it
    writes at every replay, and the hand-written kernels' launches in one
    replay (the wrappers count their launches while the capture records
    them; a replay counts none).  A call that the capture refuses raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain.start()
        chain.step()
    torch.cuda.current_stream().wait_stream(side)
    chain.start()
    graph = torch.cuda.CUDAGraph()
    before = launch_counts()
    with torch.cuda.graph(graph):
        outputs = chain.step()
    after = launch_counts()
    return graph, outputs, {n: after[n] - before[n] for n in after}


def chained(chain: Chain, device: torch.device, k: int, samples: int,
            prefix: str | None = None, timing: Timing = Timing()) -> dict:
    """bench.py's chained timing of ``chain`` (:func:`chained_timing`): on a
    card ``timed(n)`` is n replays of the captured call between two CUDA
    events, then a synchronise; on the CPU a host loop of n calls.  Each
    ``timed`` starts from the starting carry, as bench.py's programs do.
    Then the gate: one replay (a call on the CPU) from the starting carry
    against ``chain.eager()``, every output bit for bit.  With the timing's
    ``profile_dir``, a few more replays under the profiler, summarised as
    ``{p}chained_device_ms_per_call`` etc."""
    p = f"{prefix}_" if prefix else ""
    out = {}
    if device.type == "cuda":
        graph, outputs, per_replay = capture(chain)
        replays = 0

        def timed(n):
            nonlocal replays
            chain.start()
            sync(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(n):
                graph.replay()
            b.record()
            torch.cuda.synchronize(device)
            replays += n
            return a.elapsed_time(b) / 1e3

        dt, diag = chained_timing(timed, k, prefix=prefix)
        chain.start()
        graph.replay()
        got = [t.clone() for t in outputs]
        out.update({f"{p}chain_launches_per_replay": per_replay,
                    f"{p}chain_replays": replays + 1,
                    **timing.profile(graph.replay, device, f"{p}chained")})
        del graph, outputs
    else:
        def timed(n):
            chain.start()
            t0 = time.perf_counter()
            for _ in range(n):
                chain.step()
            return time.perf_counter() - t0

        dt, diag = chained_timing(timed, k, prefix=prefix)
        chain.start()
        got = chain.step()
        out.update(timing.profile(chain.step, device, f"{p}chained"))
    want = chain.eager()
    equal = len(got) == len(want) and all(bits_equal(a, b) for a, b in zip(got, want))
    return {f"{p}chained_ms": dt * 1e3, f"{p}chained_samples_per_sec": samples / dt, **diag,
            f"{p}chain_equals_eager": equal, **out}


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------
def _projection(device: torch.device):
    from meteor_scatter_tpu_torch.ops.bandpower import band_projection_matrix

    M, slices = band_projection_matrix(FS, N_FFT, BLOCK, [FREQ_BAND, NOISE_BAND])
    return torch.from_numpy(M).to(device), slices


def batch_pipeline(x_np: np.ndarray, device: torch.device, timing: Timing = Timing(),
                   chain_k: int = CHAIN_K["value"]) -> dict:
    """bench.py:144 ``tpu_pipeline``: the headline, a 6 kHz series uploaded
    pre-blocked (nb, 1200), through band power (one FP32 ``torch.matmul``,
    ``ops/bandpower.py::band_power_db``, as the analyzer) and
    ``detect_adaptive(impl="fused")`` with bench.py's cap of 4 096: K1 on a
    card, one launch a chunk of at most 131 072 blocks.  Unlike bench.py
    (:185-186, ``events_from_run_sums`` on K1's run sums) the port's fused
    route takes its events from the above mask by ``events_from_mask``,
    whose range check reads the card on the host once a call.  Chained
    (bench.py:173-208): eps from the previous call's last threshold, added
    to the projection."""
    from meteor_scatter_tpu_torch.models.adaptive import detect_adaptive
    from meteor_scatter_tpu_torch.ops.bandpower import band_power_db

    M, slices = _projection(device)
    nb = len(x_np) // BLOCK
    host = np.ascontiguousarray(x_np[: nb * BLOCK].reshape(nb, BLOCK))
    up = upload_ms(host, device)
    x = torch.from_numpy(host).to(device)

    def call(proj):  # (events, thresholds)
        band, noise = band_power_db(x, proj, slices)
        return detect_adaptive(band - noise, K_STD, BLOCK_SEC, cap=BATCH_CAP, impl="fused",
                               **ADAPTIVE_SEC)

    def run():
        return call(M)[0]

    ev, launches = launches_of(run, device)
    s = timing.measure(run, device)
    last = torch.zeros((), device=device)  # the previous call's thr[-1]

    def step():
        ev, thr = call(M + nan_eps(last))
        last.copy_(thr[-1])
        return (*ev, thr)

    def eager():
        ev, thr = call(M)
        return (*ev, thr)

    chain = chained(Chain(step, last.zero_, eager), device, chain_k, len(x_np), timing=timing)
    return {"samples_per_sec": len(x_np) / (s["median_ms"] / 1e3), **s, "upload_ms": up,
            "events": int(ev.count), "launches_per_call": launches, **chain}


def verify_fused_vs_parallel(x_np: np.ndarray, device: torch.device) -> dict:
    """bench.py:263: the flat series through ``delta_power_db``, then
    ``detect_adaptive`` by the fused route (K1 on a card) and by the
    fixpoint (``impl="parallel"``); the event lists must be identical:
    count, start and stop exactly, ``db_mean`` within rtol 1e-4."""
    from meteor_scatter_tpu_torch.models.adaptive import detect_adaptive
    from meteor_scatter_tpu_torch.ops.bandpower import delta_power_db

    delta = delta_power_db(torch.from_numpy(x_np).to(device), FS, N_FFT, BLOCK, FREQ_BAND,
                           NOISE_BAND)[2]

    def run(impl):
        ev, _ = detect_adaptive(delta, K_STD, BLOCK_SEC, impl=impl, **ADAPTIVE_SEC)
        c = int(ev.count)
        return c, *(getattr(ev, f)[:c].cpu().numpy() for f in ("start", "stop", "db_mean"))

    cf, sf, pf, mf = run("fused")
    cp, sp, pp, mp = run("parallel")
    equal = (cf == cp and np.array_equal(sf, sp) and np.array_equal(pf, pp)
             and np.allclose(mf, mp, rtol=1e-4))
    return {"fused_equals_parallel": bool(equal), "verify_device": str(device),
            "verify_events": cf}


def multi_channel_pipeline(n_channels: int, seconds: float, device: torch.device,
                           timing: Timing = Timing(), chain_k: int = CHAIN_K["multi8"]) -> dict:
    """bench.py:212: ``n_channels`` beacon channels (``synth_audio`` seeds
    10 + c), uploaded pre-blocked (C, nb, 1200), band power over the batch,
    then the fused detection a channel: bench.py vmaps K1 into one grid, the
    port's K1 takes one series, so a call launches it once a channel (and
    reads each channel's range check on the host).  Chained (bench.py:
    231-259): eps from the last channel's last threshold, added to the
    projection."""
    from meteor_scatter_tpu_torch.models.adaptive import detect_adaptive
    from meteor_scatter_tpu_torch.ops.bandpower import band_power_db

    M, slices = _projection(device)
    x_np = np.stack([synth_audio(seconds, seed=10 + c) for c in range(n_channels)])
    nb = x_np.shape[1] // BLOCK
    host = np.ascontiguousarray(x_np[:, : nb * BLOCK].reshape(n_channels, nb, BLOCK))
    up = upload_ms(host, device)
    x = torch.from_numpy(host).to(device)

    def call(proj):  # (events, thresholds) a channel
        band, noise = band_power_db(x, proj, slices)
        delta = band - noise
        return [detect_adaptive(delta[c], K_STD, BLOCK_SEC, cap=MULTI_CAP, impl="fused",
                                **ADAPTIVE_SEC) for c in range(n_channels)]

    def run():
        return [ev for ev, _ in call(M)]

    def flat(outs):
        return tuple(t for ev, thr in outs for t in (*ev, thr))

    evs, launches = launches_of(run, device)
    s = timing.measure(run, device, "multi8")
    last = torch.zeros((), device=device)  # the previous call's last thr[-1]

    def step():
        outs = call(M + nan_eps(last))
        last.copy_(outs[-1][1][-1])
        return flat(outs)

    chain = chained(Chain(step, last.zero_, lambda: flat(call(M))), device, chain_k, x_np.size,
                    "multi8", timing)
    return {"multi8_samples_per_sec": x_np.size / (s["multi8_median_ms"] / 1e3), **s,
            "multi8_upload_ms": up, "multi8_events": sum(int(e.count) for e in evs),
            "multi8_launches_per_call": launches, **chain}


def g3_check(x_np: np.ndarray, events, overflow, on: np.ndarray, thr: np.ndarray) -> dict:
    """The stations' first solve against the JAX package's (G3): the
    fixture's SHA-256s first, then the events and the sampled thresholds
    under chip_smoke.py's tolerances (``tools/golden_compare.py``).  Returns
    the gate and what the comparison read; a comparison that fails reads
    false with its reason."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    import golden_compare as gc
    import golden_fixtures as gf

    try:
        got = gc.compare_stations(gc.load("G3"), gf.station_hashes(x_np), events, overflow, on,
                                  thr, G3_DB_TOL,
                                  G3_DURATION_TOL, G3_THR_TOL)
    except (gc.FixtureDiffers, gc.GoldenMismatch) as e:
        return {"stations_golden_G3": False,
                "stations_golden_error": f"{type(e).__name__}: {e}"[:2000]}
    keep = ("fixture_hashes_matched", "events_jax", "events_card", "identical", "ties",
            "max_abs_ddelta", "max_abs_dthr", "db_max_abs_err", "duration_max_abs_err")
    return {"stations_golden_G3": True,
            **{f"stations_golden_{k}": got[k] for k in keep if k in got}}


def stations_pipeline(n_stations: int, seconds: float, device: torch.device,
                      timing: Timing = Timing(), chain_k: int = CHAIN_K["stations64"]) -> dict:
    """bench.py:307: BASELINE config 5, ``n_stations`` x ``seconds`` at
    4 kHz uploaded pre-blocked (C, n_blocks, 800), through
    ``stream_front_headless`` + ``stream_scan_fused_batch`` (one K3 launch
    on a card), the state carried from call to call.  Gates: the first
    call against the scan twin on the same series, every leaf bit for bit;
    at 600 s (G3's fixture, the first ``n_stations`` of its 64) the first
    call's events against the JAX package's.  Chained (bench.py:398-466):
    the front inlined with eps from the state's ``tr_sum[0]`` added to its
    projection, as bench.py's, against ``stream_front_headless``."""
    from meteor_scatter_tpu_torch.models import streaming as st
    from meteor_scatter_tpu_torch.ops.welch import block_band_sums_db

    cfg = stations_config()
    scfg = st.StreamConfig.from_config(cfg)
    fs = STATIONS_FS
    x_np, _ = stations_fixture(n_stations, seconds)
    block = int(round(cfg.proc_block_sec * fs))
    host = x_np.reshape(n_stations, -1, block)
    up = upload_ms(host, device)
    x = torch.from_numpy(host).to(device)
    st0 = st.stream_init_batch(scfg, n_stations, device=device)

    def first():
        on, pm, _ = st.stream_front_headless(cfg, x, fs)
        return on, pm, st.stream_scan_fused_batch(scfg, st0, on, pm)

    (on, pm, fused), launches = launches_of(first, device)
    out = {"stations_fused_equals_scan": solves_equal(fused, st.stream_scan(scfg, st0, on, pm)),
           "stations_events": int(fused[1].count.sum()), "stations64_launches_per_call": launches}
    if seconds == G3_SECONDS:
        ev = fused[1]
        fields = [getattr(ev, f).cpu().numpy() for f in
                  ("time_start", "time_stop", "duration", "db_min", "db_max", "db_mean", "db_std")]
        counts = ev.count.cpu().numpy()
        events = [[[float(f[c, i]) for f in fields] for i in range(counts[c])]
                  for c in range(n_stations)]
        out.update(g3_check(x_np, events, ev.overflow.cpu().tolist(), on.cpu().numpy(),
                            fused[2].cpu().numpy()))
    del on, pm, fused

    state = [st0]

    def run():
        on, pm, _ = st.stream_front_headless(cfg, x, fs)
        state[0], ev, _ = st.stream_scan_fused_batch(scfg, state[0], on, pm)
        return ev

    s = timing.measure(run, device, "stations64")
    # stream_front_headless's own projection (cached a device), eps added
    P, slices, nseg = st._headless_projection_on(
        fs, cfg.n_fft, min(cfg.welch_nperseg, block),
        (cfg.signal_band, cfg.noise_band_1, cfg.noise_band_2), block, str(x.device))

    def call(state, eps):
        ms, n1, n2 = (st._sanitize_levels(v) for v in block_band_sums_db(x, P + eps, slices, nseg))
        on = ms - (n1 + n2) / 2.0
        return st.stream_scan_fused_batch(scfg, state, on, torch.zeros_like(on))

    out.update(chained(state_chain(st0, call, lambda: first()[2]), device, chain_k, x_np.size,
                       "stations64", timing))
    return {"stations64_samples_per_sec": x_np.size / (s["stations64_median_ms"] / 1e3), **s,
            "stations64_upload_ms": up, **out}


def image_pipeline(n_segments: int, seconds: float, device: torch.device, fs: int = 5000,
                   timing: Timing = Timing()) -> dict:
    """bench.py:470: the monitor's image path, ``n_segments`` 30 s segments
    at 5 kHz as one batch through ``models/image.py::
    detect_and_cluster_bursts`` (no hand-written kernel; the label loops
    read a change flag on the host once a round)."""
    from meteor_scatter_tpu_torch.models import image

    x_np = image_fixture(n_segments, seconds, fs)
    up = upload_ms(x_np, device)
    x = torch.from_numpy(x_np).to(device)

    def run():
        return image.detect_and_cluster_bursts(x, float(fs))[1]

    bursts, launches = launches_of(run, device)
    rounds = dict(image.label_rounds)
    s = timing.measure(run, device, "image")
    return {"image_samples_per_sec": x_np.size / (s["image_median_ms"] / 1e3), **s,
            "image_upload_ms": up,
            "image_clusters": int((bursts.n_critical + bursts.n_non_critical).sum()),
            "image_critical": int(bursts.n_critical.sum()), "image_label_rounds": rounds,
            "image_launches_per_call": launches}


def frontend_pipeline(seconds: float, n_stations: int, device: torch.device,
                      timing: Timing = Timing(), chain_k: int = CHAIN_K["channelizer"]) -> dict:
    """bench.py:516: the wideband channelizer, a real 1 MS/s capture into
    ``n_stations`` basebands (257 taps, decimation 166, 200 Hz channels),
    uploaded pre-framed (``frame_capture_host``) and through
    ``channelize_frames`` (one FP32 GEMM and the per-row rotation).
    Chained (bench.py:548-565): eps from the previous call's ``re.sum() +
    im.sum()``, added to the tap table."""
    from meteor_scatter_tpu_torch.ops import fir

    fs = 1_000_000
    x_np, centers = channelizer_fixture(seconds, n_stations)
    plan, tables = fir.channel_bank_plan(x_np.size, fs, centers, bandwidth=200.0, decim=166,
                                         numtaps=257, device=device)
    host = fir.frame_capture_host(x_np, plan)
    up = upload_ms(host, device)
    f = torch.from_numpy(host).to(device)

    def run():
        return fir.channelize_frames(f, tables, plan)

    _, launches = launches_of(run, device)
    s = timing.measure(run, device, "channelizer")
    last = torch.zeros((), device=device)  # the previous call's re.sum() + im.sum()

    def step():
        re, im = fir.channelize_frames(f, (tables[0] + nan_eps(last), *tables[1:]), plan)
        last.copy_(re.sum() + im.sum())
        return re, im

    chain = chained(Chain(step, last.zero_, run), device, chain_k, x_np.size, "channelizer",
                    timing)
    return {"channelizer_input_samples_per_sec": x_np.size / (s["channelizer_median_ms"] / 1e3),
            **s, "channelizer_upload_ms": up, "channelizer_launches_per_call": launches, **chain}


def frontend_iq_pipeline(seconds: float, n_stations: int, device: torch.device,
                         timing: Timing = Timing(), chain_k: int = CHAIN_K["frontend_iq"]) -> dict:
    """bench.py:569: BASELINE config 4 at spec, a 2 MS/s I/Q capture
    (``synth_wideband_iq``, seed 3) uploaded pre-framed through
    ``channelize_iq_frames`` (2 001 taps, decimation 500, 1 500 Hz
    channels) → ``stream_front_headless`` → ``stream_scan_fused_batch`` (one
    K3 launch on a card), the state carried from call to call.  Gate: the
    flat capture through ``channelize_iq`` gives the pre-framed chain's
    result, every leaf bit for bit.  Chained (bench.py:648-677): eps from
    the state's ``tr_sum[0]``, added to the tap table."""
    from meteor_scatter_tpu_torch.apps.frontend import synth_wideband_iq
    from meteor_scatter_tpu_torch.models import streaming as st
    from meteor_scatter_tpu_torch.ops import fir

    fs, audio_rate, tone = 2_000_000, STATIONS_FS, STATIONS_TONE_HZ
    decim = fs // audio_rate  # 500, exact
    freqs = iq_station_freqs(n_stations)
    centers = np.asarray([f - tone for f in freqs])
    x_re, x_im, _ = synth_wideband_iq(fs, seconds, freqs, seed=3)
    cfg = stations_config()
    scfg = st.StreamConfig.from_config(cfg)
    plan, tables = fir.channel_bank_plan(x_re.size, fs, centers, bandwidth=1500.0, decim=decim,
                                         numtaps=2001, device=device)
    host = fir.frame_capture_host(np.stack([x_re, x_im]), plan)
    up = upload_ms(host, device)
    f = torch.from_numpy(host).to(device)
    st0 = st.stream_init_batch(scfg, n_stations, device=device)

    def chain(audio, state):
        on, pm, _ = st.stream_front_headless(cfg, audio, audio_rate)
        return st.stream_scan_fused_batch(scfg, state, on, pm)

    framed, launches = launches_of(lambda: chain(fir.channelize_iq_frames(f, tables, plan)[0], st0),
                                   device)
    audio_flat, _ = fir.channelize_iq(torch.from_numpy(x_re).to(device),
                                      torch.from_numpy(x_im).to(device), fs, centers,
                                      bandwidth=1500.0, decim=decim, numtaps=2001)
    out = {"frontend_iq_framed_equals_flat": solves_equal(framed, chain(audio_flat, st0)),
           "frontend_iq_events": int(framed[1].count.sum()),
           "frontend_iq_launches_per_call": launches}
    del audio_flat, framed

    state = [st0]

    def run():
        state[0], ev, _ = chain(fir.channelize_iq_frames(f, tables, plan)[0], state[0])
        return ev

    s = timing.measure(run, device, "frontend_iq")

    def call(state, eps):
        return chain(fir.channelize_iq_frames(f, (tables[0] + eps, *tables[1:]), plan)[0], state)

    out.update(chained(
        state_chain(st0, call, lambda: chain(fir.channelize_iq_frames(f, tables, plan)[0], st0)),
        device, chain_k, x_re.size, "frontend_iq", timing))
    return {"frontend_iq_2msps_samples_per_sec": x_re.size / (s["frontend_iq_median_ms"] / 1e3),
            **s, "frontend_iq_upload_ms": up, **out}


def _free(device: torch.device) -> None:
    """Release the cached blocks of a finished metric before the next."""
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None, sizes: dict = None, reps: int = REPS, warmup: int = WARMUP,
         chain_k: dict = CHAIN_K) -> int:
    """Run the benchmark; print the JSON artifact last.  ``sizes`` replaces
    :data:`FULL` / :data:`QUICK`, ``reps`` / ``warmup`` the timed and
    untimed calls a metric, and ``chain_k`` :data:`CHAIN_K` (tests run at
    their own small sizes)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true", help="bench.py's --quick sizes")
    p.add_argument("--multi", action="store_true", help="multi8_samples_per_sec")
    p.add_argument("--stations", action="store_true", help="stations64_samples_per_sec")
    p.add_argument("--image", action="store_true", help="image_samples_per_sec")
    p.add_argument("--frontend", action="store_true", help="channelizer_input_samples_per_sec")
    p.add_argument("--frontend-iq", action="store_true", help="frontend_iq_2msps_samples_per_sec")
    p.add_argument("--no-verify", action="store_true", help="skip the fused == parallel gate")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help=f"after each metric's timed calls, {PROFILED_CALLS} more under "
                        "torch.profiler: DIR/<metric>/trace.json and a summary in the artifact")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from meteor_scatter_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    size = sizes or (QUICK if args.quick else FULL)
    on_card = device.type == "cuda"
    timing = Timing(reps, warmup, args.profile)

    base_sps = baseline_numpy(synth_audio(size["baseline_seconds"], seed=1))
    print(f"# baseline (numpy replica of the reference hot loop, host CPU): "
          f"{base_sps:,.0f} samples/s", file=sys.stderr)

    x = synth_audio(size["batch_seconds"], seed=2)
    head = batch_pipeline(x, device, timing, chain_k["value"])
    sps = head.pop("samples_per_sec")
    print(f"# {device.type}: {len(x):,} samples in {head['median_ms']:.3f} ms (median of "
          f"{head['n_calls']}) -> {sps:,.0f} samples/s; chained {head['chained_ms']:.4f} ms "
          f"(k = {head['chain_k']})", file=sys.stderr)
    extra = {"baseline_cpu_samples_per_sec": round(base_sps), **head}
    if not args.no_verify:
        extra.update(verify_fused_vs_parallel(x, device))
    del x
    _free(device)

    secondaries = [
        (args.multi, lambda: multi_channel_pipeline(MULTI_CHANNELS, size["multi_seconds"], device,
                                                    timing, chain_k["multi8"])),
        (args.stations, lambda: stations_pipeline(size["stations"], size["stations_seconds"],
                                                  device, timing, chain_k["stations64"])),
        (args.image, lambda: image_pipeline(size["image_segments"], size["image_seconds"],
                                            device, timing=timing)),
        (args.frontend, lambda: frontend_pipeline(size["frontend_seconds"],
                                                  size["frontend_stations"], device, timing,
                                                  chain_k["channelizer"])),
        (args.frontend_iq, lambda: frontend_iq_pipeline(size["frontend_iq_seconds"],
                                                        size["frontend_stations"], device,
                                                        timing, chain_k["frontend_iq"])),
    ]
    for wanted, metric in secondaries:
        if wanted:
            got = metric()
            print(f"# {json.dumps(got)}", file=sys.stderr)
            extra.update(got)
            _free(device)

    artifact = {
        "metric": "audio_samples_per_sec_per_chip_stft_detect",
        "value": round(sps),
        "unit": "samples/s",
        "vs_baseline": round(sps / base_sps, 2),
        "date": time.strftime("%Y-%m-%d"),
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": torch.cuda.device_count() if on_card else 0},
        "nvidia_smi": nvidia_smi_line() if on_card else None,
        "clock": "cuda_events" if on_card else "host",
        **{k: round(v) if k in METRIC_BYTES_PER_SAMPLE or k in CHAINED_RATES.values() else v
           for k, v in extra.items()},
    }
    bad = implausible_metrics(artifact)
    if bad:
        artifact["implausible"] = bad
    failed = [g for g in GATES if artifact.get(g) is False]
    if failed or bad:
        print(f"# failed gates {failed}, implausible metrics {bad}", file=sys.stderr)
    print(json.dumps(artifact))
    return 1 if failed or bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
