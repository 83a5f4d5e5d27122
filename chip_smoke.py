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
   the main paths' shapes, with stated tolerances, both timed: K1 (the
   adaptive solver's walk route, one cooperative launch across the SMs, at
   a 1 h series, a first and a later chunk of a day, and on dense series: a
   freeze that rarely lifts, one that never does, a 2 000-block window;
   with the fix-up's counts; its time is the profiler's device time of the
   kernel), K3 (the fused streaming solve: prologue,
   state machine, compaction and ring in one launch; bit-exact at 3 000 x
   64 fresh, 300 x 1 carried mid-track, 1 100 x 130, and at the seams and
   edges: mid-Init with n = 303, inside a lock window, a track open at the
   end, 20 000 blocks over three shared-memory tiles, a series crossing the
   threshold every block with an overflowing buffer; its time is the
   profiler's device time of the kernel) and K2 (band power at the 24 h
   analyzer shape, with ``torch.matmul`` plus the same epilogue as a
   yardstick the port never calls; each the median of 60 CUDA-event
   launches, with its share of the bound).
4. e2e           — G1: a 24 h, 6 kHz, int16 WAV with a 1 s 1003 Hz tone
   every 47 s and one on each of K1's chunk seams through
   ``apps.analyze.main`` (K1 launched once per chunk, by the walk route,
   every tone detected, fused == parallel events), adaptive and
   ``--fixed-threshold``, each against the JAX package's golden output;
   a profiled warm run of the day.
5. e2e_bandpower — the same day through ``fused_bandpower_delta`` (one K2
   launch), against the analyzer's band power and the golden delta.
6. e2e_live      — G2: a 24 h, 4 kHz, int16 WAV with a 1 s 1000 Hz tone
   every 47 s through ``apps.live.main`` (welch front, impl auto = fused:
   K3 launched once per 60 s feed, every tone detected, no overflow, the
   lines and events against the golden output's); fused == scan events on
   the first hour; the headless (bins) front over the day; a profiled hour.
7. e2e_stations  — G3: 64 stations x 600 s at 4 kHz, pre-blocked, through
   ``stream_front_headless`` + ``stream_scan_fused_batch`` (one K3
   launch, and the profiled solve shows K3 as its only device row),
   events bit-equal to the scan twin's and equal to the golden output's,
   every station's tone found, aggregate samples/s.
8. e2e_frontend  — G4: ``apps.frontend.main`` on a 60 s, 2 MS/s capture of
   8 stations, real (channelize /200, resample x3/5 to 6 kHz) and
   ``--iq``: every burst after the 10 s fixed start found, no overflow, the
   station lines equal to the golden output's; on a 30 s cut the stages
   timed one by one and the card's events equal to the CPU's.
9. e2e_frontend_iq — BASELINE config 4 at spec: 60 s of 2 MS/s I/Q, 8
   stations, uploaded pre-framed, through ``channelize_iq_frames`` +
   ``stream_front_headless`` + ``stream_scan_fused_batch`` (one K3 launch),
   fused == scan bit for bit, pre-framed == flat events, every burst after
   the 8 s initial wait found; complex samples/s with and without the
   upload, profile rows and the bank GEMM's bound.
10. e2e_spec_export — the spectrogram PNG exports: ``apps.analyze.main
   --out-spec-dir`` on the first hour of the batch day (one PNG per event,
   named from the event CSV) and ``apps.live.main --spec-export-dir`` on the
   first hour of the live day (one PNG per event whose ±3 s window lies in
   one 60 s feed: the ring holds the last feed), with the time per export. Their K1 / K3 launches are printed
   on the phase's line and not added to the kernel records' counts.
11. e2e_episode  — the episode-jump solvers (``impl="jump"`` / ``"hop"``),
   which on the card solve through K3: the 64 stations' series through
   ``stream_scan_jump`` / ``stream_scan_jump_batch`` (one K3 launch each,
   no lockstep iteration, bit-equal to a K3 yardstick launch) against the
   lockstep solvers on the card (the path they replace, bit for bit on
   thresholds, counts, start and stop times and the exact state leaves, the
   other fields within the JAX tests' tolerances, timed beside them) and on
   CPU copies (the same, thresholds bit for bit where the CPU's
   ``torch.sqrt`` rounds correctly), and ``stream_process`` on the audio
   finding the same counts; a chunk past hop's record bound (8 x 600 at
   cap 2), which runs the lockstep hop on the card, against the CPU's
   (``thr_degraded`` set, thresholds equal); the live day's first hour through
   ``apps.live.main --impl jump|hop|fused`` (K3 once a feed each, equal
   event lines, ms a feed); hop sharded on a 2 x 4 mesh (K3 once per
   position) against unsharded; ``welch_band_sums_db`` card against CPU in
   both branches; ``adaptive_thresholds_fast`` on the whole batch day
   against K1's walk (equal events, so equal above-mask); the scan, jump
   and hop on the CPU at the stations and live-feed shapes.  The routed
   solvers' K3 launches are added to the kernel record; its K1 launches
   are printed on its line only.
12. e2e_monitor — the segment monitor: the JAX package's image benchmark
   fixture (8 x 30 s at 5 kHz, bursts at 8 + s and 20 s) as one batch
   through ``detect_and_cluster_bursts`` on the card in both keypoint
   modes (2 critical clusters a segment, each burst inside a cluster's
   box, counts equal to the port's on the CPU, the card's image clustered
   on the CPU equal field for field, none of K1-K3 launched), segments/s
   for the batch and ms for one segment, the label rounds, a profile of
   one segment; then ``apps.monitor.main --wav`` over a synthetic 6 h day
   from 21:00 (the daily CSVs byte-equal to the port's ledger fed the
   truth on the same clock and, as G5, with the journals, PNG names and
   counts, to the JAX CLI's golden output; one PNG per burst segment).
13. e2e_host    — the host slice: first a line with pandas' and
   matplotlib's versions (null where absent, decided by ``find_spec``) and
   g++'s path; the config tree's INI round trip (defaults and
   ``config.example.ini``); ``apps.monitor.main --pump`` over the 6 h
   replay against the WAV source on the audio timeline from yesterday
   21:00 (pump, wav, wav, pump: CSVs and PNGs byte-equal, the native ring
   and pump from ``csrc/ms_native.cc``, 0 dropped, segments/s of each);
   with matplotlib, ``apps.analyze.main --plot-dir`` on the batch day's
   first hour (4 PNGs, K1 once by the walk route, ms for the plots) and
   ``apps.live.main --ui`` on 2 min of the live day under Agg, pacing off
   (the event lines of a run without it, K3 once a 1 s feed, ms a feed with
   and without the view); with pandas, ``apps.merge.main`` over the
   analyzer's event CSV and every dashboard endpoint in-process on the pump
   run's ledger (charts with matplotlib only), ms each.  Paths whose
   package is missing are listed under ``not_run``.  Its K1 / K3 launches
   are printed on its line and not added to the kernel records' counts.
14. e2e_sharded — the multi-device layer on virtual meshes that repeat the
   card: the port's ``dryrun_multichip`` on a 2 x 4 mesh (every assertion
   of the JAX package's, its three streaming cases; K3 20 times, 10 each in
   ``bins:fused`` and ``bins:hop``); BASELINE config 5 (the stations fixture) through
   ``sharded_stream_process(front="bins", impl="fused")`` on a 2 x 4 mesh
   (K3 once per mesh position) against the unsharded ``stream_process``,
   events equal; BASELINE config 4 (the at-spec I/Q fixture) framed per
   time shard through ``sharded_channelize_iq_frames`` on a 1 x 4 mesh
   against ``channelize_iq_frames``, then ``detect_channels`` on a 2 x 1
   mesh against no mesh; ``init_multihost`` without settings and a
   world-size-1 NCCL group's heartbeat.  Its K3 launches are printed on its
   line and not added to the kernel records' counts.
15. e2e_multiproc — the multi-device layer on a process group: two spawned
   processes share the card through a gloo group (a ``file://`` store; every
   transfer staged through the host), each owning ``cuda:0`` twice.  (a)
   BASELINE config 5 (the stations fixture) through
   ``sharded_stream_process(front="bins", impl="fused")`` on a 2 x 2 mesh
   spanning both, K3 launched twice in each process (counted there and
   added to the kernel records), every state, event and threshold leaf
   bit-equal to the unsharded batched ``stream_process``; (b) the at-spec
   I/Q capture flat through ``sharded_channelize_iq`` on 1 x 4 (halos across
   the process seam) against the unsharded bank; (c)
   ``sharded_detect_adaptive`` on 1 x 4 over the batch day's first 20
   minutes, the mask equal to one process's; each with ms in every process, the
   same call on one process's virtual mesh, the bytes staged and the
   compute mode (not ``Default``: (a)-(c) under ``not_run``); (d) (a) over
   16 stations on a world-size-1 NCCL group (K3 4 times, bit-equal).

16. e2e_determinism — repeats that must give the same bits on the card:
   (a) ``apps.analyze.main`` twice with ``--fixed-threshold``, twice with
   K1 (impl auto) and ``proc_wav_file(impl="parallel")`` twice on the batch
   day, each pair's event CSVs and Audacity labels byte-identical; (b) 20
   repeats of ``events_from_mask`` on the day's fixed-threshold mask (every
   field the same bits), its means equal to ``fixed_point_run_means`` on
   CPU copies bit for bit and to the CPU's float path within the
   analyzer's 1e-4 dB; (c) 20 repeats of ``adaptive_thresholds_parallel``
   on the day's delta and on the front end's (8, 300) detection input
   (thresholds and mask the same bits), beside the plain float
   ``torch.cumsum`` and ``scatter_add_`` that they no longer use (repeats
   and times); (d) every ``ms-torch-*`` script of ``pyproject.toml``, in a
   process where ``import jax`` fails: its module imports and
   ``main(["--help"])`` exits 0; (e) ``build_native()``
   and ``LOCAL_RANK=0`` taking ``cuda:0`` (``process_device``, the scaling
   bench's ``local_devices``).  Its K1 launches are printed on its line and
   not added to the kernel records' counts.
17. e2e_bench — the port's benchmark, ``torch_bench.main(["--quick",
   "--multi", "--stations", "--image", "--frontend", "--frontend-iq"])``
   in this process (bench.py's quick sizes: every metric key, every gate
   true, nothing implausible; its K1 and K3 launches added to the kernel
   records), then each timing tool of ``tools/`` (``torch_streaming_bench``,
   ``torch_stations_bench``, ``torch_stations_breakdown``,
   ``torch_iq_breakdown``) once at a small size, its events check passed.

The days are made on the host with numpy from seeds
(``tools/golden_fixtures.py``); ``tests/data/golden/`` holds what the JAX
package made of them on the CPU (``tools/make_golden.py``).  Each golden
comparison (``tools/golden_compare.py``) checks the input's hashes first,
then prints a ``golden`` line: events of both, the identical count, ties
with their margins, the sampled blocks' largest delta and threshold
differences, the launches.  A fault fails the run after the last phase.

Each main path is driven with every launch count set to 0 just before it
and read just after.  The last three lines are the ``nvidia-smi`` line, one
JSON object with a record per kernel, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import datetime
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
REPO = os.path.dirname(os.path.abspath(__file__))
# tools/golden_fixtures.py (the seeded days) and tools/golden_compare.py
# (the golden outputs of tests/data/golden/): numpy and the stdlib only
sys.path.insert(0, os.path.join(REPO, "tools"))
# the port's benchmark (torch_bench.py): the roofline bound, the nvidia-smi
# line, the launch counts, bit equality, the image fixture; e2e_bench runs it
import torch_bench  # noqa: E402
from torch_bench import bits_equal, bound, launch_counts, nvidia_smi_line  # noqa: E402

FS = 6000
HOURS = 24
BLOCK_SEC = 0.2
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
# A streaming event's duration against the JAX package's: XLA may contract
# i * block_sec - start into one fused multiply-add, an ulp away
# (tests/test_torch_live.py, tests/test_torch_streaming.py).
DURATION_TOL = 1e-5

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
# K2's time and its yardstick's: the median of this many CUDA-event launches
# (its share of the bound has straddled 50 % from run to run)
K2_TIMING_REPS = 60
# A fresh profiler window can miss the first kernel records; the timed
# work starts this long after the window opens.  Even so the tracer has
# kept as few as 9 of 20 launches of a window, so a count of records is
# checked only against the launches made (at least one, at most all).
TRACER_SETTLE_S = 0.2
# The wideband front end (BASELINE configs 3 and 4): a 2 MS/s capture of 8
# stations through apps.frontend.main (real: 100 kHz + 50 kHz i; I/Q:
# 50 kHz (i - 4), or 25 kHz for 0), and a 30 s cut of the same captures on
# the card and on the CPU.
FRONTEND_FS = 2_000_000.0
FRONTEND_STATIONS, FRONTEND_BASE_HZ, FRONTEND_SPACING_HZ = 8, 100_000.0, 50_000.0
FRONTEND_SECONDS, FRONTEND_CUT_SECONDS = 60.0, 30.0
FRONTEND_FIXED_INIT_SEC = 10.0  # detect_channels' fixed start: bursts after it are found
# Card vs CPU event means: delta series whose float32 products sum in other
# orders (the port against the JAX package on the CPU: up to ~2e-5 dB).
FRONTEND_DB_TOL = 1e-3
EVENT_CAP = 512  # detect_channels' buffer: a count below it means no overflow
# BASELINE config 4 at spec (the JAX package's bench.py::frontend_iq_pipeline):
# 2 MS/s I/Q, 8 stations, 1000 Hz tone at 4 kHz audio, decimation 500,
# 2 001 taps, 1 500 Hz channels, 60 s with 4 bursts a station (seed 3).
IQ_SECONDS, IQ_AUDIO_RATE, IQ_DECIM, IQ_NUMTAPS, IQ_BANDWIDTH = 60.0, 4000, 500, 2001, 1500.0
# The bank sharded over 4 time shards against the unsharded bank, relative
# to the outputs' RMS: one more float32 rotation a sample (~1e-7), and GEMMs
# of m / 4 rows that cuBLAS may reduce in another order (q = 500 terms, a
# few float32 ulps of the partial sums) -- ~1e-6 of the RMS; 1e-4 leaves
# room for the sum of 5 tap columns at the bursts' peaks.
IQ_SHARD_REL_TOL = 1e-4
# The segment monitor (the reference's 24/7 loop, MonitorConfig defaults):
# 30 s segments at 5 kHz. The batch fixture is the JAX package's
# bench.py::image_pipeline's (torch_bench.image_fixture: 8 segments, seed
# 11, noise std 300, 1 s 1000 Hz bursts of amplitude 3000 at 8 + s and
# 20 s); the CLI replays a synthetic
# 6 h day from 21:00, crossing hourly flushes and one midnight rotation.
MONITOR_FS, MONITOR_SEG_SEC, MONITOR_BATCH, MONITOR_NFFT = 5000, 30, 8, 2048
MONITOR_HOURS, MONITOR_START = 6, "2026-08-16T21:00:00"
# e2e_host: live --ui feeds 1 s chunks; 2 min of the live day
HOST_UI_SECONDS = 120
# The exports' context after an event (SpecExportConfig.time_after_meteor_sec)
SPEC_AFTER_SEC = 3.0
# The episode-jump solvers against K3: the JAX package's split of fields
# (tests/test_streaming_jump.py): exact leaves bit for bit, the events'
# other fields within the JAX tests' tolerances (jump 1e-5, hop 1e-4), the
# state sums within 1e-5 (as rtol = atol there: relative to 1 + |value|).
EPISODE_EXACT_STATE = ("state", "block_idx", "ring", "locked_until_block",
                       "track_start_sec", "track_start_block", "tr_count", "init_count")
EPISODE_CLOSE_STATE = ("tr_sum", "tr_sumsq", "tr_min", "tr_max", "init_sum",
                       "psd_db_mean_from_init", "locked_threshold")
EPISODE_TOL = {"jump": 1e-5, "hop": 1e-4}
EPISODE_STATE_TOL = 1e-5
# welch_band_sums_db, card against CPU: float32 products summed in other
# orders by cuBLAS and the CPU's BLAS (3.8e-6 dB read on the H100); a TF32
# or lower-precision product would miss by far more.  8 stations.
EPISODE_WELCH_DB_TOL = 1e-4
EPISODE_WELCH_STATIONS = 8
EPISODE_K1_CAP = 4096  # events of the batch day (detect_adaptive's default cap)
EPISODE_CPU_REPS = 3  # CPU walls of the scan / jump / hop, median of 3
EPISODE_DEGRADED_STATIONS = 8  # channels of the chunk past hop's record bound
LIVE_FEED_SEC = 60.0  # apps.live's chunk, and its waterfall ring (max_range_sec)
# The analyzer's event dB against the JAX package's (its DB_ATOL,
# tests/test_torch_analyze.py): the golden CSVs, and in e2e_determinism the
# card's event means against the CPU's float path.
ANALYZER_DB_ATOL = 1e-4
# e2e_determinism: repeats that must give the same bits; a buffer no
# fixed-threshold day fills.
DETERMINISM_REPEATS = 20
DETERMINISM_CAP = 1 << 16
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


T_START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line carries ``t_s``, the seconds since the
    script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


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


def k3_bound(C: int, n: int, w: int, cap: int) -> dict:
    """K3's bound for C channels of n blocks: in, on, pm and the state (14
    leaves and the ring of w); out, the thresholds, the event buffers,
    count, overflow and the state; 2·w operations a block for the window
    sums."""
    return bound(3 * 4 * n * C + 7 * 4 * C * cap + 5 * C + 2 * (14 * 4 + 4 * w) * C, 2 * w * n * C)


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


CHUNK = 131072  # the fused solver's chunk (adaptive_kernel.MAX_FUSED_BLOCKS)
# K1's cases: label -> (blocks, halo, solver parameters that differ from
# SOLVER).  The first three are the main path's shapes (a 1 h recording, the
# first and a later chunk of a day); the rest are dense series.
K1_CASES = {
    "1h": (18000, 0, {}),
    "chunk_first": (CHUNK, 0, {}),
    "chunk_haloed": (CHUNK, 600, {}),
    "dense_k1.5": (CHUNK, 0, {"threshold_std_factor": 1.5}),
    "never_lifting": (CHUNK, 0, {"fixed_threshold_blocks": 0}),
    "window_2000": (CHUNK, 2000, {"window_blocks": 2000}),
}


def k1_args(label: str) -> tuple:
    """The arguments of ``adaptive_kernel._launch`` for one K1 case, on the
    card: a haloed case is a later chunk (i0 past the first chunk, frozen
    for 40 blocks on entry, a carried threshold 1.5 dB over the fixed one)."""
    import torch

    n, halo, over = K1_CASES[label]
    sv = {**SOLVER, **over}
    k, w = sv["threshold_std_factor"], sv["window_blocks"]
    dev = torch.device(DEVICE)
    d = delta_series(n, seed=n + halo)
    if sv["fixed_threshold_blocks"] == 0:
        # block 0's threshold is 0: a block 0 above it opens a freeze at
        # threshold 0, which half the blocks of the series then extend
        d[0] = abs(d[0]) + 5.0
    d = torch.from_numpy(d).to(dev)
    fixed_thr = d.mean() + k * d.std(correction=0)
    if halo:
        i0 = CHUNK - w
        carry_i = torch.tensor([i0, i0 + 40], dtype=torch.int32, device=dev)
        carry_f = torch.stack([fixed_thr, fixed_thr + 1.5]).float()
    else:
        carry_i = torch.tensor([0, -1], dtype=torch.int32, device=dev)
        carry_f = torch.stack([fixed_thr, fixed_thr]).float()
    return (d, carry_i, carry_f, halo, k, w, sv["freeze_blocks_before"],
            sv["freeze_blocks_after"], sv["fixed_threshold_blocks"], n)


def phase_kernel_k1() -> dict:
    """K1 (kernel) against its twin on the card, at the main path's shapes
    and on dense series, each by the walk route and timed."""
    import torch

    from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as ak

    cases = []
    for label in K1_CASES:
        args = k1_args(label)
        n, halo = args[0].shape[0], args[3]
        walks = ak.walk_launches
        thr_k, ab_k, s_k, c_k = ak._launch(*args)
        route = "walk" if ak.walk_launches == walks + 1 else "rounds"
        untrusted, fixup_walks, walked = ak.last_fixup.tolist()
        thr_p, ab_p, s_p, c_p = ak.adaptive_solver_plain(*args)
        torch.cuda.synchronize()
        case = {
            "case": label, "n": n, "halo": halo, "route": route,
            "untrusted_seams": untrusted, "fixup_walks": fixup_walks, "fixup_blocks": walked,
            "above_equal": bool(torch.equal(ab_k, ab_p)),
            "s_incl_equal": bool(torch.equal(s_k, s_p)),
            "n_above": int(ab_p.sum()),
            "runs": int(s_p[-1]),
            "thr_max_abs_err": float((thr_k - thr_p).abs().max()),
            "csm_max_abs_err": float((c_k - c_p).abs().max()),
            "csm_tol": CSM_RTOL * max(1.0, float(c_p.abs().max())),
            "ms": kernel_device_ms(lambda: ak._launch(*args), "walk_kernel"),
            "call_ms": cuda_ms(lambda: ak._launch(*args)),
            "plain_ms": cuda_ms(lambda: ak.adaptive_solver_plain(*args)),
        }
        case["ok"] = (
            route == "walk" and case["above_equal"] and case["s_incl_equal"]
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
    # and run sums (~16 per block) and one pass of the freeze recurrence
    return {
        "max_abs_err": max(c["thr_max_abs_err"] for c in cases),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        **bound(4 * total + 16 + 13 * n, 16 * total + n),
        "library_ms": None,
    }


@contextlib.contextmanager
def recording(module, name: str):
    """``module.name`` wrapped for the ``with`` block so that each call's
    result is kept in the yielded list: an entry point's own run read
    without a second run."""
    fn = getattr(module, name)
    made = []

    def wrapper(*args, **kw):
        made.append(fn(*args, **kw))
        return made[-1]

    setattr(module, name, wrapper)
    try:
        yield made
    finally:
        setattr(module, name, fn)


def file_text(path: str) -> str:
    with open(path) as fh:
        return fh.read()


# Failed golden comparisons, raised together once every phase has run (so
# that one run shows all of them)
GOLDEN_FAILURES: list = []


def golden_check(config: str, mode, compare, launches: dict) -> None:
    """Run one comparison with the golden outputs (``compare()``, a call of
    ``tools/golden_compare.py``) and print its line: the events of both,
    how many are identical, the ties with their margins, the sampled
    blocks' largest differences, the run's launches and the fixture hashes
    matched; or the fault, kept for the end of the run."""
    import golden_compare as gc

    line = {"phase": "golden", "config": config, "mode": mode}
    try:
        emit({**line, "ok": True, **compare(), "launches": launches})
    except (gc.FixtureDiffers, gc.GoldenMismatch) as e:
        emit({**line, "ok": False, "error": f"{type(e).__name__}: {e}"[:4000],
              "launches": launches})
        GOLDEN_FAILURES.append(f"{config} {mode}: {type(e).__name__}")


def read_rows(path: str) -> list:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def timer_totals(text: str) -> dict:
    """Phase totals from a ``PhaseTimer.summary()`` printed by ``main``."""
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^(\S[^:\n]*): total ([0-9.]+)s", text, re.M)}


def phase_e2e(tmp: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import golden_compare as gc
    import golden_fixtures as gf

    from meteor_scatter_tpu_torch.apps import analyze
    from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as ak

    wav = os.path.join(tmp, ANALYZE_WAV)
    t0 = time.perf_counter()
    day = gf.g1_day()
    gf.write_wav(wav, day.fs, day.pcm)
    starts, hashes = day.tones, day.hour_sha256
    del day
    synth_s = time.perf_counter() - t0
    n_blocks = FS * HOURS * 3600 // int(FS * BLOCK_SEC)
    if (gf.K1_CHUNK_BLOCKS, gf.ANALYZER_WINDOW_BLOCKS) != (ak.MAX_FUSED_BLOCKS,
                                                          SOLVER["window_blocks"]):
        raise AssertionError("tools/golden_fixtures.py's chunk seams are not the solver's")
    chunk = ak.MAX_FUSED_BLOCKS - SOLVER["window_blocks"]
    want_launches = 1 if n_blocks <= ak.MAX_FUSED_BLOCKS else math.ceil(n_blocks / chunk)
    golden = gc.load("G1")

    out = {k: os.path.join(tmp, k) for k in ("fused.csv", "fused.txt", "par.csv", "par.txt",
                                             "fixed.csv", "fixed.txt")}
    # --- the main path, through the CLI entry point; counted launches ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ak.launches = ak.walk_launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log), recording(analyze, "proc_wav_file") as made:
        rc = analyze.main([wav, "--out-csv", out["fused.csv"], "--out-audacity", out["fused.txt"],
                           "--device", DEVICE])
    main_wall = time.perf_counter() - t0
    launches, walk_launches = ak.launches, ak.walk_launches
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise RuntimeError(f"analyze.main returned {rc}")
    if launches != want_launches or walk_launches != want_launches:
        raise AssertionError(f"adaptive_solver launched {launches} times ({walk_launches} by the "
                             f"walk route), expected {want_launches} walks")
    # --- the same files against the JAX package's (tests/data/golden/G1) ---
    res = made[0]
    golden_check("G1", "adaptive", lambda: gc.compare_analyzer(
        golden, "adaptive", hashes, file_text(out["fused.csv"]), file_text(out["fused.txt"]),
        res.delta_power, res.thresholds, ANALYZER_DB_ATOL, THR_TOL_DB, K2_ATOL[2]),
        {"adaptive_solver": launches, "walk": walk_launches,
         "chunk_seams": gf.k1_seam_blocks(n_blocks)})
    zero_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()), recording(analyze, "proc_wav_file") as made:
        rc = analyze.main([wav, "--out-csv", out["fixed.csv"], "--out-audacity", out["fixed.txt"],
                           "--fixed-threshold", "--device", DEVICE])
    if rc != 0:
        raise RuntimeError(f"analyze.main --fixed-threshold returned {rc}")
    res_fixed = made[0]
    golden_check("G1", "fixed", lambda: gc.compare_analyzer(
        golden, "fixed", hashes, file_text(out["fixed.csv"]), file_text(out["fixed.txt"]),
        res_fixed.delta_power, res_fixed.thresholds, ANALYZER_DB_ATOL, THR_TOL_DB, K2_ATOL[2]),
        launch_counts())
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
    # --- and once more under the profiler: device busy share, K1's rows ---
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACER_SETTLE_S)
        t0 = time.perf_counter()
        analyze.proc_wav_file(wav, expected_sample_rate=None, impl="fused", device=DEVICE,
                              verbose=False)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    rows = device_rows(prof)
    k1_rows = [r for r in rows if "walk_kernel" in r[0]]

    e2e = {
        "phase": "e2e", "hours": HOURS, "samples": FS * HOURS * 3600, "blocks": n_blocks,
        "synth_write_s": synth_s, "launches": launches, "walk_launches": walk_launches,
        "want_launches": want_launches,
        "events": len(fused), "tones": len(starts), "tones_missed": 0,
        "fused_equals_parallel": True, "event_db_max_abs_err": db_err,
        "main_wall_s": main_wall, "main_phases_s": phases,
        "warm_fused_phases_s": dict(res_warm.timer.totals),
        "parallel_phases_s": dict(res_par.timer.totals),
        "peak_device_bytes": peak,
        "profiled_wall_s": prof_wall, "profiled_device_busy_ms": sum(r[1] for r in rows),
        "profiled_k1_ms": sum(r[1] for r in k1_rows),
        "profiled_k1_launches": sum(r[2] for r in k1_rows),
        "profiled_device_top": [[k, round(ms, 3), n] for k, ms, n in rows[:8]],
    }
    emit(e2e)
    return e2e


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


def kernel_device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of one launch of ``kernel`` over ``reps`` calls of
    ``fn``, from the profiler's kernel rows (over the launches it
    recorded): the kernel alone, without the host work of the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACER_SETTLE_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel in e.key and e.self_device_time_total > 0]
    count = sum(e.count for e in rows)
    if not 1 <= count <= reps:  # the tracer may drop records (TRACER_SETTLE_S)
        raise AssertionError(f"the profile shows {[(e.key, e.count) for e in rows]} for {kernel}")
    return sum(e.self_device_time_total for e in rows) / count / 1e3


def alternating_series(n: int):
    """Two channels that cross the locked threshold every block after a
    quiet start: period 2 (episodes, none accepted) and period 3 (an
    accepted two-block track every three blocks)."""
    import torch

    on = (np.random.default_rng(3).standard_normal((2, n)) * 0.1).astype(np.float32)
    k = np.arange(n - 100)
    on[0, 100:] = np.where(k % 2 == 0, 5.0, -1.0)
    on[1, 100:] = np.where(k % 3 < 2, 5.0, -1.0)
    return torch.from_numpy(on).to(DEVICE), torch.zeros((2, n), device=DEVICE)


def phase_kernel_k3() -> dict:
    """K3 (the fused streaming solve) against its twin on the card, bit for
    bit on thresholds, every event slot, count, overflow, every state leaf
    and the ring: the stations shape from a fresh state, the live feed
    shape from a carried mid-track state, a ragged grid of 130 channels,
    and the seams and edges a stream meets."""
    import torch

    from meteor_scatter_tpu_torch.models import streaming as st
    from meteor_scatter_tpu_torch.ops.kernels import stream_kernel as sk

    scfg = st.StreamConfig.from_config(live_config())

    def carried(on, pm, n_before, cfg=scfg):
        state = st.stream_scan(cfg, st.stream_init_batch(cfg, on.shape[0], device=DEVICE),
                               on[:, :n_before], pm[:, :n_before])[0]
        return state, on[:, n_before:].contiguous(), pm[:, n_before:].contiguous()

    def case_inputs(label):
        """(state, on, pm, StreamConfig, what the carried state must be)."""
        fresh = lambda C, on, pm, cfg=scfg: (st.stream_init_batch(cfg, C, device=DEVICE), on, pm, cfg)
        if label == "stations":
            return fresh(64, *stream_series(64, 3000, seed=64 * 3000)), None
        if label == "live_feed":  # a burst over the seam: the feed starts inside a track
            on, pm = stream_series(1, 600, seed=11)
            on[:, 280:330] += 12.0
            return (*carried(on, pm, 300), scfg), st.TRACK
        if label == "ragged":
            return fresh(130, *stream_series(130, 1100, seed=130 * 1100)), None
        if label == "mid_init_n303":  # n not a multiple of 4: plain loads
            on, pm = stream_series(4, 320, seed=5)
            return (*carried(on, pm, 17), scfg), st.INIT
        if label == "lock_window":  # the lock runs ~58 blocks past the seam
            on, pm = stream_series(4, 600, seed=6)
            on[:, 150:190] += 9.0
            return (*carried(on, pm, 200), scfg), st.DETECT
        if label == "track_open_at_end":  # a 90-block track still open at the end
            on, pm = stream_series(2, 400, seed=8)
            on[:, 320:] += 9.0
            return fresh(2, on, pm), None
        if label == "two_tiles_20000":  # past one shared-memory tile
            on, pm = stream_series(2, 20000, seed=9)
            on[:, 8150:8250] += 9.0  # a track across the tile seam
            return fresh(2, on, pm), None
        if label == "alternating_cap16":  # ~n episodes, the buffer overflows
            cfg = scfg._replace(cap=16, min_dur_sec=0.2)
            return fresh(2, *alternating_series(700), cfg), None
        raise ValueError(label)

    cases = []
    for label in ("stations", "live_feed", "ragged", "mid_init_n303", "lock_window",
                  "track_open_at_end", "two_tiles_20000", "alternating_cap16"):
        (state, on, pm, cfg), want_state = case_inputs(label)
        if want_state is not None and not bool((state.state == want_state).all()):
            raise AssertionError(f"{label}: the carried state is not {want_state}")
        args, kw = (on, pm, tuple(state)), st.solve_params(cfg)
        got = sk._launch(*args, **kw)
        want = sk.stream_solve_plain(*args, **kw)
        torch.cuda.synchronize()
        if label == "track_open_at_end" and not bool((want[0][0] == st.TRACK).all()):
            raise AssertionError("track_open_at_end: the chunk does not end inside a track")
        names = (["thresholds"] + list(st.StreamEvents._fields)
                 + ["state." + f for f in st.StreamState._fields])
        pairs = list(zip([got[2], *got[1], *got[0]], [want[2], *want[1], *want[0]]))
        unequal = [nm for nm, (a, b) in zip(names, pairs) if not bits_equal(a, b)]
        finite = [(a.float() - b.float())[torch.isfinite(b.float())].abs() for a, b in pairs]
        C, n = on.shape
        w, cap = state.ring.shape[1], kw["cap"]
        case = {
            "case": label, "C": C, "n": n, "bit_exact": not unequal, "unequal_outputs": unequal,
            "max_abs_err": max(float(e.max()) if e.numel() else 0.0 for e in finite),
            "events": int(want[1][7].sum()), "overflow": int(want[1][8].sum()),
            "nan_thresholds": int(torch.isnan(want[2]).sum()),
            **k3_bound(C, n, w, cap),
        }
        if label in ("stations", "live_feed"):
            case["ms"] = kernel_device_ms(lambda: sk._launch(*args, **kw), "stream_solve_kernel")
            case["call_ms"] = cuda_ms(lambda: sk._launch(*args, **kw))
            case["plain_ms"] = cuda_ms(lambda: sk.stream_solve_plain(*args, **kw), warmup=1, reps=3)
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
        "ms": cuda_ms(lambda: bk._launch(frames, proj, nb, 1e-12), warmup=5, reps=K2_TIMING_REPS),
        "plain_ms": cuda_ms(lambda: bk.band_power_db_plain(frames, proj, nb, 1e-12)),
        "library_ms": cuda_ms(library, warmup=5, reps=K2_TIMING_REPS),
        "timing_reps": K2_TIMING_REPS,
        # frames' first L samples, the projection, three outputs; 2 flops
        # per multiply-add of the product
        **bound(4 * nf * L + 4 * L * ncols + 3 * 4 * nf, 2.0 * nf * L * ncols),
    }
    case["share_of_bound"] = case["bound_ms"] / case["ms"]
    case["library_share_of_bound"] = case["bound_ms"] / case["library_ms"]
    emit({"phase": "kernel_check", "kernel": "bandpower", **case})
    if any(e > t for e, t in zip(errs, K2_ATOL)):
        raise AssertionError(f"bandpower kernel differs from its twin by {errs} dB")
    return {k: case[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")} | {
        "max_abs_err": max(errs)}


def phase_e2e_bandpower(x) -> dict:
    """The fused band-power entry point over the analyzer's day: one K2
    launch, against the analyzer's ``torch.matmul`` band power and the
    JAX package's delta (tests/data/golden/G1)."""
    import torch

    import golden_compare as gc

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
    # K2's delta against the JAX package's on the day's sampled blocks
    record = gc.load("G1")["adaptive"]["blocks"]
    delta = got[2].cpu().numpy()
    golden_check("G1", "k2", lambda: gc.compare_sampled_delta(record, delta, K2_ATOL[2]),
                 {"bandpower": launches})
    return out


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

    import golden_compare as gc
    import golden_fixtures as gf

    from meteor_scatter_tpu_torch.apps import live
    from meteor_scatter_tpu_torch.io.wavio import read_wav

    wav = os.path.join(tmp, "live_4khz_24h.wav")
    t0 = time.perf_counter()
    day = gf.g2_day()
    gf.write_wav(wav, day.fs, day.pcm)
    starts, hashes = day.tones, day.hour_sha256
    del day
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    read_wav(wav, mono=True)
    read_s = time.perf_counter() - t0
    seconds = LIVE_HOURS * 3600
    feeds = math.ceil(seconds / 60.0)

    if LIVE_ARGS != gf.G2_ARGS:
        raise AssertionError("the live arguments are not the golden output's")
    # --- the main path: the CLI, welch front, impl auto (fused on the card) ---
    with recording(live, "wav_file_process") as sessions:
        welch, text, wall, launches, peak = run_live_main([wav, "--device", DEVICE, *LIVE_ARGS])
    if launches != feeds:
        raise AssertionError(f"stream_machine launched {launches} times, expected {feeds}")
    if "overflow" in text:
        raise AssertionError("a per-chunk event buffer overflowed")
    missed = missed_tones(starts, welch)
    if missed:
        raise AssertionError(f"{len(missed)} of {len(starts)} tones not detected, first {missed[:5]}")
    # --- the lines and the unrounded events against the JAX package's ---
    lines = text.splitlines()
    golden_check("G2", None, lambda: gc.compare_live(
        gc.load("G2"), hashes, [ln for ln in lines if ln.startswith("Detected Meteor:")],
        [ln for ln in lines if ln.startswith("Total detected meteors:")],
        [[float(ev[k]) for k in gc.STREAM_FIELDS] for ev in sessions[0]], EVENT_DB_TOL,
        DURATION_TOL),
        {"stream_machine": launches, "feeds": feeds})

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
        time.sleep(TRACER_SETTLE_S)
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


def stations_fixture():
    """BASELINE config 5 (``tools/golden_fixtures.py::g3_stations``): 64
    stations x 600 s at 4 kHz, a 1 s tone a station, uploaded pre-blocked.
    Returns (x (64, 3 000, 800) on the card, the samples a station, the
    tones' start times, each station's SHA-256)."""
    import torch

    import golden_fixtures as gf

    x_np, tones = gf.g3_stations()
    block = int(round(BLOCK_SEC * LIVE_FS))
    x = torch.from_numpy(x_np.reshape(STATIONS, -1, block)).to(DEVICE)
    return x, x_np.shape[1], tones, gf.station_hashes(x_np)


def phase_e2e_stations() -> dict:
    """64 stations x 600 s (:func:`stations_fixture`), uploaded pre-blocked;
    one K3 launch for the batch, against the JAX package's events
    (tests/data/golden/G3)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import golden_compare as gc

    from meteor_scatter_tpu_torch.models import streaming as st
    from meteor_scatter_tpu_torch.ops.kernels import stream_kernel as sk

    cfg = live_config()
    scfg = st.StreamConfig.from_config(cfg)
    x, n, tones, x_sha = stations_fixture()
    st0 = st.stream_init_batch(scfg, STATIONS, device=DEVICE)

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
    # --- K3's events and thresholds against the JAX package's vmapped scan ---
    fields = [getattr(ev_f, k).cpu().numpy() for k in gc.STREAM_FIELDS]
    events = [[[float(f[c, i]) for f in fields] for i in range(counts[c])] for c in range(STATIONS)]
    on_h, thr_h = on.cpu().numpy(), thr_f.cpu().numpy()
    golden_check("G3", None, lambda: gc.compare_stations(
        gc.load("G3"), x_sha, events, ev_f.overflow.cpu().tolist(), on_h, thr_h, EVENT_DB_TOL,
        DURATION_TOL, THR_TOL_DB), {"stream_machine": launches})

    def pipeline():
        o, p, _ = st.stream_front_headless(cfg, x, LIVE_FS)
        return st.stream_scan_fused_batch(scfg, st0, o, p)

    total_ms = cuda_ms(pipeline, warmup=2, reps=9)
    # twenty solves alone: K3 is the only device row (1 to 20 launches of
    # it, as the tracer may drop records)
    reps = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACER_SETTLE_S)
        for _ in range(reps):
            st.stream_scan_fused_batch(scfg, st0, on, pm)
        torch.cuda.synchronize()
    solve_rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                  if e.self_device_time_total > 0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACER_SETTLE_S)
        pipeline()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if (len(solve_rows) != 1 or "stream_solve_kernel" not in solve_rows[0][0]
            or not 1 <= solve_rows[0][2] <= reps):
        raise AssertionError(f"stations: the profiled solves ran {solve_rows}, not K3 alone "
                             f"(pipeline rows: {[(k, c) for k, _, c in rows]})")
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
        "profiled_solve_rows": [[k, ms, c] for k, ms, c in solve_rows],
    }
    emit(out)
    return out


def zero_launch_counts() -> None:
    from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as ak
    from meteor_scatter_tpu_torch.ops.kernels import bandpower_kernel as bk
    from meteor_scatter_tpu_torch.ops.kernels import stream_kernel as sk

    ak.launches = ak.walk_launches = bk.launches = sk.launches = 0


STATION_LINE = re.compile(r"^station (\d+) \(.*?\): (\d+) events (\[.*?\]) \(truth: (\[.*\])\)$", re.M)


def bursts_missed(events, truth, after_sec: float, within_sec: float = 0.5) -> list:
    """Bursts (t0, dur) starting after ``after_sec`` that no event starts
    within ``within_sec`` of."""
    starts = np.array([e[0] for e in events])
    return [t0 for t0, _ in truth
            if t0 > after_sec and not (starts.size and np.abs(starts - t0).min() < within_sec)]


def events_to_host(ev) -> list:
    """Per channel, the valid rows of an ``Events`` as numpy arrays."""
    f = [t.cpu().numpy() for t in ev]
    return [tuple(a[c, : int(f[3][c])] for a in f[:3]) for c in range(f[3].shape[0])]


def phase_e2e_frontend() -> dict:
    """BASELINE configs 3 and 4 through the CLI: ``apps.frontend.main`` on a
    60 s, 2 MS/s real capture of 8 stations (channelize /200, resample
    x3/5 to 6 kHz, band power, the fixpoint detector), and again with
    ``--iq``; then a 30 s cut of the same captures stage by stage on the
    card and through the same entry points on the CPU, events compared."""
    import ast

    import torch

    import golden_compare as gc
    import golden_fixtures as gf

    from meteor_scatter_tpu_torch.apps import frontend as fe
    from meteor_scatter_tpu_torch.models import adaptive
    from meteor_scatter_tpu_torch.ops.fir import resample_poly

    golden = gc.load("G4")
    if golden["fixture"]["argv"] != gf.G4_ARGV:
        raise AssertionError("the golden output's front-end arguments are not the fixture's")
    out = {"phase": "e2e_frontend", "fs": FRONTEND_FS, "stations": FRONTEND_STATIONS}
    fs_i = int(FRONTEND_FS)
    decim, up, down = fe._stages(fs_i, 6000, 2500.0)
    for iq in (False, True):
        label = "iq" if iq else "real"
        # FRONTEND_* as the golden fixture's arguments
        argv = [*gf.G4_ARGV, "--device", DEVICE] + (["--iq"] if iq else [])
        # --- the main path, through the CLI entry point ---
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log), recording(
                fe, "synth_wideband_iq" if iq else "synth_wideband") as made:
            rc = fe.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if rc != 0:
            raise RuntimeError(f"frontend.main {argv} returned {rc}")
        # --- the station lines against the JAX package's CLI on the same capture ---
        hashes = [gf.sha256(a) for a in made[0][:-1]]
        del made[:]
        golden_check("G4", label, lambda: gc.compare_frontend(
            golden, label, hashes,
            [ln for ln in log.getvalue().splitlines() if ln.startswith("station ")]), launches)
        rows = STATION_LINE.findall(log.getvalue())
        if len(rows) != FRONTEND_STATIONS:
            raise AssertionError(f"frontend.main printed {len(rows)} station lines:\n{log.getvalue()}")
        missed, counts = [], []
        for c, cnt, spans, truth in rows:
            events = [(float(a), float(b)) for a, b in re.findall(r"\[([0-9.]+),([0-9.]+)\]s", spans)]
            counts.append(int(cnt))
            missed += [(int(c), t0_) for t0_ in
                       bursts_missed(events, ast.literal_eval(truth), FRONTEND_FIXED_INIT_SEC)]
        if missed or max(counts) >= EVENT_CAP:
            raise AssertionError(f"frontend {label}: bursts missed {missed}, counts {counts}")

        # --- a 30 s cut: the stages one by one on the card, then the CPU ---
        freqs = fe.station_freqs(FRONTEND_STATIONS, FRONTEND_BASE_HZ, FRONTEND_SPACING_HZ, iq)
        centers = np.asarray(freqs) - fe.TONE_FREQ
        if iq:
            x, x_im, _ = fe.synth_wideband_iq(FRONTEND_FS, FRONTEND_CUT_SECONDS, freqs)
        else:
            (x, _), x_im = fe.synth_wideband(FRONTEND_FS, FRONTEND_CUT_SECONDS, freqs), None
        audio = fe.iq_frontend(x, FRONTEND_FS, freqs, x_im=x_im, device=DEVICE)
        ev_card, delta = fe.detect_channels(audio)
        stages = {}
        for _ in range(2):  # the second, warm, pass is the one kept
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bank = fe._bank(x, x_im, FRONTEND_FS, centers, 2500.0, decim, 513, DEVICE)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            audio_s = resample_poly(bank, up, down)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            fe.detect_channels(audio_s)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            stages = {"channelize_with_upload_s": t1 - t0, "resample_s": t2 - t1, "detect_s": t3 - t2}
        _, _, rounds = adaptive._fixpoint(delta, **SOLVER)
        ev_cpu, _ = fe.detect_channels(fe.iq_frontend(x, FRONTEND_FS, freqs, x_im=x_im, device="cpu"))
        card, cpu = events_to_host(ev_card), events_to_host(ev_cpu)
        same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(card, cpu)) and bool(
            torch.equal(ev_card.overflow.cpu(), ev_cpu.overflow))
        db_err = max((float(np.abs(a[2] - b[2]).max()) for a, b in zip(card, cpu) if a[2].size),
                     default=0.0)
        n_cut = sum(a[0].size for a in card)
        if not same or db_err > FRONTEND_DB_TOL or n_cut == 0:
            raise AssertionError(f"frontend {label} 30 s cut: card and CPU events differ "
                                 f"(equal starts/stops {same}, dB err {db_err}, {n_cut} events)")
        out[label] = {
            "seconds": FRONTEND_SECONDS, "main_wall_s": wall, "launches": launches,
            "peak_device_bytes": peak, "events_per_station": counts, "bursts_missed": 0,
            "cut_seconds": FRONTEND_CUT_SECONDS, "cut_events": n_cut,
            "cut_card_equals_cpu": True, "cut_event_db_max_abs_err": db_err,
            "cut_stage_wall_s": stages, "fixpoint_rounds": rounds,
            "audio_shape": list(audio.shape),
        }
        del audio, audio_s, bank, delta, x, x_im
        torch.cuda.empty_cache()
    emit(out)
    return out


def frontend_iq_fixture() -> dict:
    """BASELINE config 4 at spec: 60 s of 2 MS/s I/Q, 8 stations centred on
    0 Hz, 4 bursts a station (seed 3), on the host."""
    from meteor_scatter_tpu_torch.apps import frontend as fe

    freqs = fe.station_freqs(FRONTEND_STATIONS, FRONTEND_BASE_HZ, FRONTEND_SPACING_HZ, True)
    t0 = time.perf_counter()
    x_re, x_im, truth = fe.synth_wideband_iq(int(FRONTEND_FS), IQ_SECONDS, freqs,
                                             bursts_per_station=4, seed=3)
    return {"x_re": x_re, "x_im": x_im, "truth": truth, "freqs": freqs,
            "centers": np.asarray([f - LIVE_TONE_HZ for f in freqs]),
            "synth_s": time.perf_counter() - t0}


def phase_e2e_frontend_iq(iq: dict) -> dict:
    """BASELINE config 4 at spec (:func:`frontend_iq_fixture`), uploaded
    pre-framed, through ``channelize_iq_frames`` → ``stream_front_headless``
    → ``stream_scan_fused_batch`` (one K3 launch for the 8 stations)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from meteor_scatter_tpu_torch.models import streaming as st
    from meteor_scatter_tpu_torch.ops import fir

    fs = int(FRONTEND_FS)
    x_re, x_im, truth, freqs, centers = (iq[k] for k in ("x_re", "x_im", "truth", "freqs",
                                                         "centers"))
    synth_s = iq["synth_s"]
    cfg = live_config()
    scfg = st.StreamConfig.from_config(cfg)
    plan, tables = fir.channel_bank_plan(x_re.size, fs, centers, IQ_BANDWIDTH, IQ_DECIM,
                                         IQ_NUMTAPS, device=DEVICE)
    t0 = time.perf_counter()
    f_host = fir.frame_capture_host(np.stack([x_re, x_im]), plan)
    frame_s = time.perf_counter() - t0
    f = torch.from_numpy(f_host).to(DEVICE)
    st0 = st.stream_init_batch(scfg, len(freqs), device=DEVICE)

    def pipeline(frames):
        audio, _ = fir.channelize_iq_frames(frames, tables, plan)
        on, pm, _ = st.stream_front_headless(cfg, audio, IQ_AUDIO_RATE)
        return on, pm, st.stream_scan_fused_batch(scfg, st0, on, pm)

    # --- the main path, once, counted ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    on, pm, (st_f, ev_f, thr_f) = pipeline(f)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if launches != {"adaptive_solver": 0, "bandpower": 0, "stream_machine": 1}:
        raise AssertionError(f"frontend_iq launched {launches}, expected K3 once")

    # --- the scan twin on the same series: bit for bit ---
    st_s, ev_s, thr_s = st.stream_scan(scfg, st0, on, pm)
    if not (all(bits_equal(a, b) for a, b in zip(ev_f, ev_s))
            and all(bits_equal(a, b) for a, b in zip(st_f, st_s)) and bits_equal(thr_f, thr_s)):
        raise AssertionError("frontend_iq: fused and scan outputs differ")
    # --- the flat capture through channelize_iq: the same events ---
    audio_flat, _ = fir.channelize_iq(torch.from_numpy(x_re).to(DEVICE),
                                      torch.from_numpy(x_im).to(DEVICE), fs, centers,
                                      IQ_BANDWIDTH, IQ_DECIM, IQ_NUMTAPS)
    on2, pm2, _ = st.stream_front_headless(cfg, audio_flat, IQ_AUDIO_RATE)
    ev_flat = st.stream_scan_fused_batch(scfg, st0, on2, pm2)[1]
    if not all(bits_equal(a, b) for a, b in zip(ev_f, ev_flat)):
        raise AssertionError("frontend_iq: the pre-framed and flat chains' events differ")
    del audio_flat, on2, pm2
    counts = ev_f.count.cpu().numpy()
    t0s = ev_f.time_start.cpu().numpy()
    missed = [(c, t) for c in range(len(freqs))
              for t in bursts_missed([(s,) for s in t0s[c, : counts[c]]], truth[c],
                                     scfg.init_wait_sec)]
    if missed or bool(ev_f.overflow.any()):
        raise AssertionError(f"frontend_iq: bursts missed {missed[:8]}, overflow "
                             f"{ev_f.overflow.tolist()}")

    # --- throughput: from the frames on the card, and with the upload ---
    n = x_re.size
    ms = cuda_ms(lambda: pipeline(f), warmup=2, reps=9)
    ms_upload = cuda_ms(lambda: pipeline(torch.from_numpy(f_host).to(DEVICE)), warmup=1, reps=9)
    reps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACER_SETTLE_S)
        for _ in range(reps):
            pipeline(f)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    # the bank GEMM alone, as the bank takes it: (2·C·A, q) @ frames^T (q, m), twice, FP32
    hh = tables[0]
    rows_m, q, cols = 2 * plan["m"], plan["q"], hh.shape[1]
    gemm_ms = cuda_ms(lambda: torch.matmul(hh.t(), f.transpose(-1, -2)), warmup=2, reps=9)
    gemm = bound(4 * (rows_m * q + q * cols + rows_m * cols), 2.0 * rows_m * q * cols)
    out = {
        "phase": "e2e_frontend_iq", "fs": fs, "seconds": IQ_SECONDS, "stations": len(freqs),
        "complex_samples": n, "frames": list(f.shape), "audio_rate": IQ_AUDIO_RATE,
        "blocks": int(on.shape[1]), "synth_s": synth_s, "frame_host_s": frame_s,
        "launches": launches["stream_machine"], "peak_device_bytes": peak,
        "events": int(counts.sum()), "bursts_missed": 0, "fused_equals_scan": True,
        "preframed_equals_flat": True,
        "pipeline_ms": ms, "complex_samples_per_s": n / (ms / 1e3),
        "pipeline_with_upload_ms": ms_upload, "complex_samples_per_s_with_upload": n / (ms_upload / 1e3),
        "bank_gemm_ms": gemm_ms, "bank_gemm_bound": gemm,
        "bank_gemm_shape": [rows_m, q, cols],
        "k3_shape": [int(on.shape[1]), len(freqs)],
        "k3_bound": k3_bound(len(freqs), int(on.shape[1]), scfg.avg_win, scfg.cap),
        "profiled_calls": reps, "profiled_device_ms": sum(r[1] for r in rows),
        "profiled_device_top": [[k[:160], round(ms_, 4), c] for k, ms_, c in rows[:12]],
    }
    emit(out)
    return out


def file_bytes(path: str):
    """A file's bytes, or None where there is no file."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        return fh.read()


def bursts_to_host(b) -> dict:
    return {f: getattr(b, f).cpu().numpy() for f in b._fields}


def bursts_equal(a: dict, b: dict) -> bool:
    """Every ``ImageBursts`` field equal, dtype and empty slots included."""
    return all(a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]) for f in a)


def phase_e2e_monitor(tmp: str) -> dict:
    """The segment monitor: (a) the batch fixture as one (8, 150 000) call of
    ``detect_and_cluster_bursts`` on the card in both keypoint modes, held
    against the port on the CPU, timed, with its label rounds and a
    profile; (b) ``apps.monitor.main --wav`` over a synthetic 6 h day,
    against the JAX CLI's outputs (tests/data/golden/G5)."""
    import datetime

    import torch
    from torch.profiler import ProfilerActivity, profile

    import golden_compare as gc
    import golden_fixtures as gf

    from meteor_scatter_tpu_torch.apps import monitor
    from meteor_scatter_tpu_torch.io.ledger import HourlyLedger
    from meteor_scatter_tpu_torch.models import image as im

    fs = float(MONITOR_FS)
    x_np = torch_bench.image_fixture(MONITOR_BATCH, MONITOR_SEG_SEC, MONITOR_FS)
    x = torch.from_numpy(x_np).to(DEVICE)
    out = {"phase": "e2e_monitor", "batch_segments": MONITOR_BATCH, "fs": MONITOR_FS}
    for mode in ("threshold", "corner"):
        # --- (a) the batch on the card: the main path of the detector ---
        torch.cuda.synchronize()
        zero_launch_counts()
        img, b = im.detect_and_cluster_bursts(x, fs, keypoint_mode=mode)
        torch.cuda.synchronize()
        launches = launch_counts()
        rounds = im.label_rounds["cluster_core_labels"]
        card = bursts_to_host(b)
        if any(launches.values()):
            raise AssertionError(f"monitor {mode}: the image path launched {launches}")
        if not ((card["count"] == 2).all() and (card["n_critical"] == 2).all()
                and not card["overflow"].any()):
            raise AssertionError(f"monitor {mode}: counts {card['count']}, critical "
                                 f"{card['n_critical']}, overflow {card['overflow']}")
        missed = []
        for s in range(MONITOR_BATCH):
            lo = card["t_min"][s, :2] * img.hop_sec
            hi = card["t_max"][s, :2] * img.hop_sec + MONITOR_NFFT / fs
            missed += [(s, b0) for b0 in (8.0 + s, 20.0) if not ((lo <= b0) & (b0 <= hi)).any()]
        if missed:
            raise AssertionError(f"monitor {mode}: bursts outside every cluster's box {missed}")
        # --- the port on the CPU, same audio: the same counts ---
        _, b_cpu = im.detect_and_cluster_bursts(torch.from_numpy(x_np), fs, keypoint_mode=mode)
        cpu = bursts_to_host(b_cpu)
        if any(not np.array_equal(card[f], cpu[f])
               for f in ("count", "n_critical", "n_non_critical", "overflow")):
            raise AssertionError(f"monitor {mode}: card counts {card['count']} != CPU {cpu['count']}")
        # --- the card's image clustered on the CPU: every field equal ---
        img_h = im.SpectrogramImage(img.db.cpu(), img.vmin.cpu(), img.freqs, img.hop_sec,
                                    img.hz_per_bin)
        kp = im.corner_keypoints(img).cpu() if mode == "corner" else None
        if not bursts_equal(bursts_to_host(im.cluster_bursts(img_h, keypoint_mask=kp)), card):
            raise AssertionError(f"monitor {mode}: the card's image clustered on the CPU differs")
        batch_ms = cuda_ms(lambda: im.detect_and_cluster_bursts(x, fs, keypoint_mode=mode),
                           warmup=2, reps=9)
        one_ms = cuda_ms(lambda: im.detect_and_cluster_bursts(x[0], fs, keypoint_mode=mode),
                         warmup=2, reps=9)
        one_rounds = im.label_rounds["cluster_core_labels"]
        out[mode] = {
            "launches": launches, "counts": card["count"].tolist(),
            "critical": card["n_critical"].tolist(), "card_counts_equal_cpu": True,
            "card_image_clustered_on_cpu_equal": True, "core_label_rounds_batch": rounds,
            "core_label_rounds_one": one_rounds, "batch_ms": batch_ms,
            "segments_per_s_batch": MONITOR_BATCH / (batch_ms / 1e3), "one_segment_ms": one_ms,
        }
    # --- one segment under the profiler: its device kernels, busy share ---
    reps = 5
    im.detect_and_cluster_bursts(x[0], fs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACER_SETTLE_S)
        t0 = time.perf_counter()
        for _ in range(reps):
            im.detect_and_cluster_bursts(x[0], fs)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    rows = device_rows(prof)
    busy_ms = sum(r[1] for r in rows)
    out["profile_one_segment"] = {
        "calls": reps, "wall_ms": prof_wall * 1e3 / reps,
        # a lower bound: the tracer may drop kernel records (TRACER_SETTLE_S)
        "device_records_per_call": sum(r[2] for r in rows) / reps,
        "device_busy_ms_per_call": busy_ms / reps,
        "device_busy_share": busy_ms / (prof_wall * 1e3),
        "core_label_rounds": im.label_rounds["cluster_core_labels"],
        "device_top": [[k[:100], round(ms / reps, 4), c / reps] for k, ms, c in rows[:12]],
    }
    del x, img, b

    # --- (b) the CLI over a synthetic day: hourly ledger and PNGs ---
    wav = os.path.join(tmp, "monitor_5khz.wav")
    t0 = time.perf_counter()
    day = gf.g5_day()
    gf.write_wav(wav, day.fs, day.pcm)
    hashes = day.hour_sha256
    del day
    burst = gf.g5_bursts()
    synth_s = time.perf_counter() - t0
    if (MONITOR_START, MONITOR_HOURS, MONITOR_FS) != (gf.G5_START, gf.G5_HOURS, gf.G5_FS):
        raise AssertionError("the monitor replay is not the golden fixture's")
    csv_dir, png_dir, truth_dir = (os.path.join(tmp, d) for d in ("csv", "png", "truth"))
    torch.cuda.synchronize()
    zero_launch_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = monitor.main(["--wav", wav, "--csv-out", csv_dir, "--spec-out", png_dir,
                           "--start-time", MONITOR_START, "--device", DEVICE])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if rc != 0 or any(launches.values()):
        raise AssertionError(f"monitor.main returned {rc}, launched {launches}")
    text = log.getvalue()
    # --- the ledger, journals, PNG names and counts against the JAX CLI's ---
    outputs = gc.monitor_outputs(csv_dir, png_dir, text)
    golden_check("G5", None, lambda: gc.compare_monitor(gc.load("G5"), hashes, outputs), launches)
    crit = [int(v) for v in re.findall(r"^Critical bursts this segment: (\d+)$", text, re.M)]
    non = [int(v) for v in re.findall(r"^Non-critical bursts this segment: (\d+)$", text, re.M)]
    wrong = [k for k, (c, n_) in enumerate(zip(crit, non)) if (c, n_) != (int(burst[k]), 0)]
    if len(crit) != len(burst) or wrong:
        raise AssertionError(f"monitor CLI: {len(crit)} segments of {len(burst)}, counts wrong in "
                             f"segments {wrong[:8]}")
    # the truth through the port's own ledger on the same simulated clock
    start = datetime.datetime.fromisoformat(MONITOR_START)
    ledger = HourlyLedger(truth_dir, now=start)
    names = set()
    for k, has in enumerate(burst):
        now = start + datetime.timedelta(seconds=(k + 1) * MONITOR_SEG_SEC)
        ledger.add(int(has), 0, now=now)
        if has:
            names.add(now.strftime("%Y%m%d-%H%M%S") + "-1-0.png")
    truth_files = sorted(os.listdir(truth_dir))
    csvs = sorted(f for f in os.listdir(csv_dir) if f.endswith(".csv"))
    differ = [f for f in truth_files if file_bytes(os.path.join(csv_dir, f))
              != file_bytes(os.path.join(truth_dir, f))]
    if differ or csvs != [f for f in truth_files if f.endswith(".csv")] or len(csvs) != 2:
        raise AssertionError(f"monitor CLI: ledger files differ from the truth's: {differ}, {csvs}")
    pngs = set(os.listdir(png_dir))
    if pngs != names:
        raise AssertionError(f"monitor CLI: {len(pngs)} PNGs for {len(names)} burst segments")
    with open(os.path.join(csv_dir, csvs[0])) as fh:
        rows_day1 = fh.read().splitlines()
    out["cli"] = {
        "hours": MONITOR_HOURS, "segments": len(burst), "burst_segments": len(names),
        "synth_write_s": synth_s, "wall_s": wall, "segments_per_s": len(burst) / wall,
        "phases_s": timer_totals(text), "csv_files": csvs, "rows_first_day": len(rows_day1) - 1,
        "ledger_equals_truth": True, "pngs": len(pngs),
        "last_segment_core_label_rounds": im.label_rounds["cluster_core_labels"],
    }
    emit(out)
    return out


def cut_host_inputs(tmp: str, host_tmp: str) -> dict:
    """The first hour of the batch day (same gqrx name) and the first 2 min
    of the live day, for ``e2e_host``."""
    from meteor_scatter_tpu_torch.io.wavio import read_wav, write_wav

    out = {"batch_hour": os.path.join(host_tmp, ANALYZE_WAV),
           "live_2min": os.path.join(host_tmp, "live_4khz_2min.wav")}
    for src, dst, seconds in ((os.path.join(tmp, ANALYZE_WAV), out["batch_hour"], 3600),
                              (os.path.join(tmp, "live_4khz_24h.wav"), out["live_2min"],
                               HOST_UI_SECONDS)):
        fs, data = read_wav(src, mono=True)
        write_wav(dst, fs, data[: fs * seconds])
    return out


def host_packages() -> dict:
    """pandas / matplotlib versions (None where absent, decided by
    ``find_spec`` without importing) and g++'s path."""
    import importlib.metadata
    import importlib.util
    import shutil

    found = {pkg: importlib.metadata.version(pkg) if importlib.util.find_spec(pkg) else None
             for pkg in ("pandas", "matplotlib")}
    return {**found, "gxx": shutil.which("g++")}


def replay_start() -> datetime.datetime:
    """The replays' audio timeline starts yesterday at 21:00."""
    return datetime.datetime.combine(datetime.date.today() - datetime.timedelta(days=1),
                                     datetime.time(21))


def run_monitor_cli(wav: str, out: str, extra: list):
    """``apps.monitor.main`` over the 6 h replay into fresh ``out/csv`` and
    ``out/png``: (csv dir, png dir, wall seconds, segments, pump sources).
    The WAV source runs on the audio timeline (``--start-time``); ``--pump``
    has no position, so it runs on the wall clock, as in the JAX CLI."""
    import torch

    from meteor_scatter_tpu_torch.apps import monitor

    made = []

    class RecordedPump(monitor.PumpSegmentSource):
        """The CLI's pump source, kept with its ring's and pump's native flags
        as constructed (``stop`` clears the pump's handle)."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.native_at_start = (self.ring.native, self.pump.native)
            made.append(self)

    csv_dir, png_dir = os.path.join(out, "csv"), os.path.join(out, "png")
    clock = [] if "--pump" in extra else ["--start-time", replay_start().isoformat()]
    monitor.PumpSegmentSource = RecordedPump
    try:
        torch.cuda.synchronize()
        zero_launch_counts()
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = monitor.main(["--wav", wav, "--csv-out", csv_dir, "--spec-out", png_dir,
                               *clock, "--device", DEVICE, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        monitor.PumpSegmentSource = RecordedPump.__bases__[0]
    launches = launch_counts()
    segments = log.getvalue().count("Critical bursts this segment")
    if rc != 0 or any(launches.values()) or segments != MONITOR_HOURS * 3600 // MONITOR_SEG_SEC:
        raise AssertionError(f"monitor.main {extra}: rc {rc}, {segments} segments, {launches}")
    return csv_dir, png_dir, wall, segments, made


class AudioClock:
    """A segment source whose clock follows the segments it has handed out,
    from :func:`replay_start` (what ``--start-time`` gives a positioned
    source).  It hides the source's position, so ``run_monitor`` journals no
    offset for either source."""

    def __init__(self, source):
        self.source, self.n = source, 0

    def grab(self):
        seg = self.source.grab()
        self.n += seg is not None
        return seg

    def now(self) -> datetime.datetime:
        return replay_start() + datetime.timedelta(seconds=self.n * MONITOR_SEG_SEC)


def run_monitor_clocked(wav: str, out: str, kind: str):
    """``apps.monitor.run_monitor`` over the 6 h replay from the pump or the
    WAV source on the same injected audio clock (:class:`AudioClock`):
    (csv dir, png dir, wall seconds, segments, source)."""
    import torch

    from meteor_scatter_tpu_torch.apps import monitor

    cfg = monitor.MonitorConfig(csv_out_dir=os.path.join(out, "csv"),
                                spec_out_dir=os.path.join(out, "png"))
    src = (monitor.PumpSegmentSource if kind == "pump" else monitor.WavSegmentSource)(wav, cfg)
    if kind == "pump":
        src.native_at_start = (src.ring.native, src.pump.native)
    clock = AudioClock(src)
    torch.cuda.synchronize()
    zero_launch_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log):
            monitor.run_monitor(clock, cfg, now_fn=clock.now, device=DEVICE)
        torch.cuda.synchronize()
    finally:
        if kind == "pump":
            src.close()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    segments = log.getvalue().count("Critical bursts this segment")
    if any(launches.values()) or segments != MONITOR_HOURS * 3600 // MONITOR_SEG_SEC:
        raise AssertionError(f"run_monitor ({kind}): {segments} segments, {launches}")
    return cfg.csv_out_dir, cfg.spec_out_dir, wall, segments, src


def same_tree(a: str, b: str) -> bool:
    """The same file names with the same bytes."""
    names = sorted(os.listdir(a))
    return names == sorted(os.listdir(b)) and all(
        file_bytes(os.path.join(a, n)) == file_bytes(os.path.join(b, n)) for n in names)


def phase_e2e_host(tmp: str, inputs: dict) -> dict:
    """The host slice: the config round trip; ``monitor --pump`` over the 6 h
    replay against the WAV source (byte-equal ledger and PNGs, the native
    ring and pump, segments/s interleaved pump, wav, wav, pump); with
    matplotlib, ``analyze --plot-dir`` on the batch hour and ``live --ui``
    on 2 min of the live day (Agg, pacing off); with pandas, the merge of
    the analyzer's event CSV and every dashboard endpoint in-process on the
    pump run's ledger (charts only with matplotlib).  A package found
    missing (``find_spec``, before anything runs) lists its paths under
    ``not_run``."""
    import dataclasses
    import shutil

    from meteor_scatter_tpu_torch import config as tcfg

    pkgs = host_packages()
    emit({"phase": "e2e_host_packages", **pkgs})
    not_run = []
    if pkgs["matplotlib"] is None:
        not_run += [{"path": p, "reason": "matplotlib is not installed"}
                    for p in ("analyze --plot-dir", "live --ui", "dashboard charts")]
    if pkgs["pandas"] is None:
        not_run += [{"path": p, "reason": "pandas is not installed"}
                    for p in ("merge", "dashboard")]
    out = {"phase": "e2e_host", "card": nvidia_smi_line(), "packages": pkgs}

    # --- the INI round trip: the defaults and the repo's example file ---
    example = tcfg.load_config(os.path.join(REPO, "config.example.ini"))
    for cfg in (tcfg.FrameworkConfig(), example):
        back = tcfg.from_ini(tcfg.to_ini(cfg))
        if dataclasses.asdict(back) != dataclasses.asdict(cfg):
            raise AssertionError("the INI round trip changed the configuration")
    out["config_round_trip"] = {"sections": len(tcfg._SECTIONS), "equal": True}

    # --- the pump against the WAV source on one injected audio clock, interleaved ---
    wav = os.path.join(tmp, "monitor_5khz.wav")
    runs = {"pump": [], "wav": []}
    trees = {}
    for k, kind in enumerate(("pump", "wav", "wav", "pump")):
        csv_dir, png_dir, wall, segments, src = run_monitor_clocked(
            wav, os.path.join(tmp, f"host_{kind}{k}"), kind)
        runs[kind].append(segments / wall)
        trees.setdefault(kind, (csv_dir, png_dir))
        if kind == "pump":
            if src.native_at_start != (True, True) or src.ring.dropped() != 0:
                raise AssertionError(f"pump: native (ring, pump) {src.native_at_start}, "
                                     f"{src.ring.dropped()} dropped")
            if src.pump.frames_pushed() != segments * MONITOR_FS * MONITOR_SEG_SEC:
                raise AssertionError(f"pump pushed {src.pump.frames_pushed()} frames")
    for i in range(2):
        if not same_tree(trees["pump"][i], trees["wav"][i]):
            raise AssertionError(f"the pump source: {('csv', 'png')[i]} files differ from the WAV "
                                 "source's")
    # --- the CLI's --pump, on the wall clock as in the JAX CLI (PNGs of one
    # second and the same counts share a name there): no offset journal ---
    csv_cli, _, cli_wall, _, made = run_monitor_cli(wav, os.path.join(tmp, "host_cli"), ["--pump"])
    if ".offset.json" in os.listdir(csv_cli) or made[0].native_at_start != (True, True):
        raise AssertionError(f"monitor --pump: {sorted(os.listdir(csv_cli))}, native "
                             f"{made[0].native_at_start}")
    from meteor_scatter_tpu_torch.io.native import load_native

    out["pump"] = {
        "segments": segments, "native_ring": True, "native_pump": True, "dropped": 0,
        "library": load_native()._name, "csv_png_equal_wav_source": True,
        "segments_per_s_pump": runs["pump"], "segments_per_s_wav": runs["wav"],
        "order": ["pump", "wav", "wav", "pump"],
        "cli_pump_segments_per_s": segments / cli_wall, "cli_pump_offset_journal": False,
    }
    ledger_dir = trees["pump"][0]

    if pkgs["matplotlib"] is not None:
        import matplotlib

        matplotlib.use("Agg")
        from meteor_scatter_tpu_torch.apps import analyze

        # --- analyze --plot-dir on the batch hour: K1 as before, 4 PNGs ---
        plots, events_csv = os.path.join(tmp, "plots"), os.path.join(tmp, "hour_events.csv")
        zero_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = analyze.main([inputs["batch_hour"], "--plot-dir", plots, "--out-csv", events_csv,
                               "--device", DEVICE])
        launches = launch_counts()
        from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as ak

        names = sorted(os.listdir(plots))
        if rc != 0 or names != ["delta_threshold.png", "hist_db.png", "hist_duration.png",
                                "per_hour.png"] or launches["adaptive_solver"] != 1 \
                or ak.walk_launches != 1:
            raise AssertionError(f"analyze --plot-dir: rc {rc}, {names}, {launches}")
        res = analyze.proc_wav_file(inputs["batch_hour"], device=DEVICE, verbose=False,
                                    expected_sample_rate=None,
                                    wav_start_date_time=analyze.parse_gqrx_start_time(ANALYZE_WAV))
        t0 = time.perf_counter()
        analyze.export_debug_plots(res, os.path.join(tmp, "plots_timed"))
        out["plot_dir"] = {"seconds": 3600, "events": len(res.detections), "pngs": names,
                           "k1_launches": launches["adaptive_solver"],
                           "ms_four_pngs": (time.perf_counter() - t0) * 1e3}

        # --- live --ui on 2 min of the live day, pacing off ---
        cut = [inputs["live_2min"], "--device", DEVICE, *LIVE_ARGS]
        plain, _, _, _, _ = run_live_main(cut)
        ui, _, ui_wall, k3, _ = run_live_main([*cut, "--ui", "--realtime-factor", "1e9"])
        import matplotlib.pyplot as plt

        plt.close("all")
        if ui != plain or not plain or k3 != HOST_UI_SECONDS:
            raise AssertionError(f"live --ui: events {ui} against {plain}, K3 {k3} launches")
        from meteor_scatter_tpu_torch.apps import live

        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            live.wav_file_process(inputs["live_2min"], live_config(), chunk_sec=1.0,
                                  expected_sample_rate=None, device=DEVICE)
        plain_wall = time.perf_counter() - t0
        out["ui"] = {"seconds": HOST_UI_SECONDS, "events": len(ui), "lines_equal": True,
                     "k3_launches": k3, "feeds": HOST_UI_SECONDS,
                     "ms_per_feed_with_view": ui_wall / HOST_UI_SECONDS * 1e3,
                     "ms_per_feed_without_view": plain_wall / HOST_UI_SECONDS * 1e3}

    if pkgs["pandas"] is not None:
        from meteor_scatter_tpu_torch.apps import merge
        from meteor_scatter_tpu_torch.config import DashboardConfig
        from meteor_scatter_tpu_torch.dashboard.app import DashboardApp

        # --- merge: the analyzer's event CSV (written above with matplotlib,
        # else by the analyzer alone) ---
        events_csv = os.path.join(tmp, "hour_events.csv")
        if not os.path.exists(events_csv):
            from meteor_scatter_tpu_torch.apps import analyze

            with contextlib.redirect_stdout(io.StringIO()):
                analyze.proc_wav_file(inputs["batch_hour"], out_csv_file=events_csv,
                                      device=DEVICE, verbose=False, expected_sample_rate=None,
                                      wav_start_date_time=analyze.parse_gqrx_start_time(
                                          ANALYZE_WAV))
        merged = os.path.join(tmp, "merged")
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = merge.main([events_csv, "--out-dir", merged])
        merge_ms = (time.perf_counter() - t0) * 1e3
        want = {"report.html"} | ({"per_hour.png", "per_day.png", "heatmap.pdf"}
                                  if pkgs["matplotlib"] else
                                  {"per_hour.csv", "per_day.csv", "heatmap.csv"})
        if rc != 0 or set(os.listdir(merged)) != want:
            raise AssertionError(f"merge: rc {rc}, {sorted(os.listdir(merged))}")
        out["merge"] = {"rows": len(read_rows(events_csv)), "files": sorted(want), "ms": merge_ms}

        # --- every dashboard endpoint, in-process, on the pump run's ledger ---
        static = os.path.join(tmp, "static")
        os.makedirs(static)
        pkg_static = os.path.join(REPO, "meteor_scatter_tpu_torch", "dashboard", "static")
        for name in ("script.js", "styles.css"):
            shutil.copy(os.path.join(pkg_static, name), static)
        app = DashboardApp(DashboardConfig(csv_folder=ledger_dir,
                                           csv_storage_path=os.path.join(tmp, "final.csv")),
                           static_dir=static)
        requests = [("GET", "/"), ("GET", "/config/slideshow_interval"), ("POST", "/update_csv"),
                    ("GET", "/api/dynamischer_inhalt"), ("GET", "/static/script.js"),
                    ("GET", "/static/slides/Folie1.png")]
        if pkgs["matplotlib"]:
            requests += [("GET", f"/load_chart/{c}") for c in
                         ("zeiger", "tagesverlauf", "week", "month")]
        ms = {}
        for method, path in requests:
            got = {}
            t0 = time.perf_counter()
            body = b"".join(app({"REQUEST_METHOD": method, "PATH_INFO": path,
                                 "wsgi.input": io.BytesIO(b"")},
                                lambda status, headers: got.update(status=status)))
            ms[f"{method} {path}"] = (time.perf_counter() - t0) * 1e3
            if got["status"] != "200 OK":
                raise AssertionError(f"dashboard {method} {path}: {got['status']} {body[:200]}")
            if path.startswith("/load_chart/"):
                png = file_bytes(os.path.join(static, json.loads(body)["img_url"].split("/")[-1]))
                if png is None or png[:8] != b"\x89PNG\r\n\x1a\n":
                    raise AssertionError(f"dashboard {path}: no PNG")
            if path == "/api/dynamischer_inhalt":
                missing = len(json.loads(body)["missing_days"])
        # the replay's first day is yesterday: the other 30 of the month are missing
        if missing != 30:
            raise AssertionError(f"dashboard: {missing} missing days, expected 30")
        out["dashboard"] = {"endpoints": len(ms), "missing_days": missing, "ms": ms}
    out["not_run"] = not_run
    emit(out)
    return out


def phase_e2e_spec_export(tmp: str) -> dict:
    """The spectrogram PNG exports: the analyzer's ``--out-spec-dir`` on the
    first hour of the batch day (one PNG per event, named from the event
    CSV's times) and the live CLI's ``--spec-export-dir`` on the first hour
    of the live day (one PNG per event whose window lies in one feed's
    span, the span of the waterfall ring), with the time per export."""
    from meteor_scatter_tpu_torch.apps import analyze

    out = {"phase": "e2e_spec_export"}
    # --- the analyzer, 1 h cut of the 24 h batch day ---
    wav = os.path.join(tmp, ANALYZE_WAV)
    spec_dir, csv_path = os.path.join(tmp, "spec_analyze"), os.path.join(tmp, "spec_cut.csv")
    zero_launch_counts()
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = analyze.main([wav, "--end-sec", "3600", "--out-csv", csv_path,
                           "--out-spec-dir", spec_dir, "--device", DEVICE])
    wall = time.perf_counter() - t0
    launches = launch_counts()
    rows = read_rows(csv_path)
    want = {f"spec_and_psd_{float(r['t_start']):.2f}_{float(r['t_stop']):.2f}.png" for r in rows}
    got = set(os.listdir(spec_dir))
    if rc != 0 or got != want or len(got) != len(rows) or len(rows) < 70:
        raise AssertionError(f"analyze --out-spec-dir: {len(got)} PNGs for {len(rows)} events")
    export_s = timer_totals(log.getvalue())["spec_export"]
    out["analyze"] = {"seconds": 3600, "events": len(rows), "pngs": len(got), "wall_s": wall,
                      "spec_export_s": export_s, "ms_per_export": export_s / len(rows) * 1e3,
                      "launches": launches}
    # --- the live CLI, 1 h cut of the 24 h live day, with and without ---
    wav = os.path.join(tmp, "live_4khz_24h.wav")
    spec_dir = os.path.join(tmp, "spec_live")
    cut = ["--stop-sec", "3600", "--device", DEVICE, *LIVE_ARGS]
    events_n, _, wall_n, _, _ = run_live_main([wav, *cut])
    events, _, wall, k3, _ = run_live_main([wav, "--spec-export-dir", spec_dir, *cut])
    # the ring holds the last feed's 60 s, so a window is exported when it
    # lies inside the span of one feed, (60 (k - 1), 60 k], before the end
    want = set()
    for a, b in events:
        k = math.ceil((b + SPEC_AFTER_SEC) / LIVE_FEED_SEC)
        if a - SPEC_AFTER_SEC > LIVE_FEED_SEC * (k - 1) and k * LIVE_FEED_SEC <= 3600.0:
            want.add(f"spec_{a:.2f}_{b:.2f}.png")
    got = set(os.listdir(spec_dir))
    if events != events_n or got != want or len(got) < 60:
        raise AssertionError(f"live --spec-export-dir: {len(got)} PNGs for {len(want)} closed "
                             f"windows ({len(events)} events; same events without: "
                             f"{events == events_n})")
    out["live"] = {"seconds": 3600, "events": len(events), "pngs": len(got), "wall_s": wall,
                   "wall_without_export_s": wall_n,
                   "ms_per_export": (wall - wall_n) / len(got) * 1e3, "k3_launches": k3}
    emit(out)
    return out


def max_dev(a, b) -> float:
    """The largest |a - b| where both are numbers (NaN where both are NaN,
    and equal infinities, count as equal)."""
    import torch

    both_nan = torch.isnan(a) & torch.isnan(b)
    if bool((torch.isnan(a) != torch.isnan(b)).any()):
        return math.inf
    return float(torch.where(both_nan | (a == b), 0.0, (a - b).abs()).max())


def phase_e2e_sharded(tmp: str, iq: dict) -> tuple:
    """The multi-device layer on virtual meshes of the one card: (a) the
    dryrun on a 2 x 4 mesh; (b) BASELINE config 5 (:func:`stations_fixture`)
    through ``sharded_stream_process(front="bins", impl="fused")`` on a
    2 x 4 mesh against the unsharded batched ``stream_process`` and its
    eight K3 launches against K3's twin on the gathered series; (c)
    BASELINE config 4 (:func:`frontend_iq_fixture`) framed per time shard
    through ``sharded_channelize_iq_frames`` on a 1 x 4 mesh against
    ``channelize_iq_frames``, then ``detect_channels`` on a 2 x 1 mesh
    against no mesh; (d) the multi-process runtime on a world-size-1 NCCL
    group.  K3's launches here are this line's, not the kernel records'.
    Returns the record and (c)'s (8, 300) detection input, which
    ``e2e_determinism`` reuses."""
    import datetime

    import torch
    import torch.distributed as dist

    from meteor_scatter_tpu_torch.apps import frontend as fe
    from meteor_scatter_tpu_torch.models import adaptive
    from meteor_scatter_tpu_torch.models import streaming as st
    from meteor_scatter_tpu_torch.ops import fir
    from meteor_scatter_tpu_torch.ops.kernels import stream_kernel as sk
    from meteor_scatter_tpu_torch.parallel import distributed as pdist
    from meteor_scatter_tpu_torch.parallel.dryrun import dryrun_multichip
    from meteor_scatter_tpu_torch.parallel.mesh import make_mesh
    from meteor_scatter_tpu_torch.parallel.sharded import (
        _iq_bank_setup,
        sharded_channelize_iq_frames,
        sharded_stream_process,
    )

    card = f"{DEVICE}:{torch.cuda.current_device()}"
    out = {"phase": "e2e_sharded", "nvidia_smi": nvidia_smi_line(),
           "note": "virtual meshes that repeat one card: the times measure the shard "
                   "bookkeeping (halo copies, per-position launches), not scaling across cards"}

    # --- (a) the dryrun: every assertion of the JAX package's dryrun_multichip ---
    zero_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        line = dryrun_multichip(8, devices=[card] * 8)
    out["dryrun"] = {"mesh": [2, 4], "wall_s": time.perf_counter() - t0, "line": line,
                     "k3_launches": sk.launches}
    # K3 runs in bins:fused and in bins:hop, each on 8 positions + 2 unsharded
    # channels (hop's 320-block chunks lie inside its record bound)
    if sk.launches != 20 or "bins:hop" not in line:
        raise AssertionError(f"dryrun: K3 launched {sk.launches} times (expected 20): {line}")

    # --- (b) BASELINE config 5: 64 stations, 2 x 4 mesh, bins front, K3 ---
    cfg = live_config()
    scfg = st.StreamConfig.from_config(cfg)
    x, n, _, _ = stations_fixture()
    st0 = st.stream_init_batch(scfg, STATIONS, device=DEVICE)
    mesh = make_mesh(2, 4, [card] * 8)

    def sharded():
        return sharded_stream_process(cfg, st0, x, LIVE_FS, mesh, front="bins", impl="fused")

    def unsharded():
        return st.stream_process(cfg, st0, x, LIVE_FS, front="bins", impl="fused")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.launches = 0
    state_s, ev_s, dg_s = sharded()
    torch.cuda.synchronize()
    k3 = sk.launches
    peak = torch.cuda.max_memory_allocated()
    _, ev_u, dg_u = unsharded()
    same = all(torch.equal(getattr(ev_s, f), getattr(ev_u, f))
               for f in ("count", "time_start", "time_stop"))
    # the eight launches against K3's twin on the gathered series: every
    # state and event leaf and the thresholds, bit for bit
    on_s = dg_s["over_noise"]
    state_t, ev_t, thr_t = st.stream_scan(scfg, st0, on_s, torch.zeros_like(on_s))
    twin = all(bits_equal(a, b) for a, b in zip((*state_s, *ev_s, dg_s["threshold"]),
                                                (*state_t, *ev_t, thr_t)))
    if k3 != 8 or not same or not twin or bool(ev_s.overflow.any() | ev_u.overflow.any()):
        raise AssertionError(f"sharded stations: K3 launched {k3} times (expected 8), events "
                             f"equal {same}, bit-equal to the twin {twin}, overflow "
                             f"{bool(ev_s.overflow.any())}")
    out["stations"] = {
        "mesh": [2, 4], "stations": STATIONS, "blocks": int(dg_u["over_noise"].shape[1]),
        "k3_launches": k3, "k3_shape": [int(dg_u["over_noise"].shape[1]), STATIONS // 2],
        "events": int(ev_u.count.sum()), "events_equal": True, "twin_bit_equal": True,
        "threshold_max_abs_dev": max_dev(dg_s["threshold"], dg_u["threshold"]),
        "threshold_bit_equal": bits_equal(dg_s["threshold"], dg_u["threshold"]),
        "over_noise_max_abs_dev": max_dev(dg_s["over_noise"], dg_u["over_noise"]),
        "over_noise_bit_equal": bits_equal(dg_s["over_noise"], dg_u["over_noise"]),
        "sharded_ms": cuda_ms(sharded, warmup=1, reps=9),
        "unsharded_ms": cuda_ms(unsharded, warmup=1, reps=9),
        "peak_device_bytes_sharded": peak,
    }
    del x, dg_s, dg_u, on_s, state_t, ev_t, thr_t
    torch.cuda.empty_cache()

    # --- (c) BASELINE config 4: pre-framed per time shard, 1 x 4 mesh ---
    fs = int(FRONTEND_FS)
    centers = iq["centers"]
    stacked = np.stack([iq["x_re"], iq["x_im"]])
    bank = (IQ_BANDWIDTH, IQ_DECIM, IQ_NUMTAPS)
    plan, tables = fir.channel_bank_plan(stacked.shape[-1], fs, centers, *bank, device=DEVICE)
    f = torch.from_numpy(fir.frame_capture_host(stacked, plan)).to(DEVICE)
    f_sh = torch.from_numpy(fir.frame_capture_sharded_host(stacked, plan, 4)).to(DEVICE)
    del stacked
    mesh4 = make_mesh(1, 4, [card] * 4)
    y_s = sharded_channelize_iq_frames(f_sh, mesh4, fs, centers, *bank)
    y_u = fir.channelize_iq_frames(f, tables, plan)
    rms = math.sqrt(float(sum((y * y).mean() for y in y_u)) / 2)
    err = max(float((a - b).abs().max()) for a, b in zip(y_s, y_u))
    if not err <= IQ_SHARD_REL_TOL * rms:
        raise AssertionError(f"sharded IQ bank: max |sharded - unsharded| {err} > "
                             f"{IQ_SHARD_REL_TOL} x RMS {rms}")
    audio = y_u[0]
    det = dict(audio_rate=IQ_AUDIO_RATE, tone_freq=LIVE_TONE_HZ)
    mesh21 = make_mesh(2, 1, [card] * 2)
    ev_m, d_m = fe.detect_channels(audio, mesh=mesh21, **det)
    ev_0, d_0 = fe.detect_channels(audio, **det)
    card_m, card_0 = events_to_host(ev_m), events_to_host(ev_0)
    same = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
               for a, b in zip(card_m, card_0)) and bool(torch.equal(ev_m.overflow, ev_0.overflow))
    db_err = max((float(np.abs(a[2] - b[2]).max()) for a, b in zip(card_m, card_0) if a[2].size),
                 default=0.0)
    n_ev = sum(a[0].size for a in card_0)
    if not same or db_err > FRONTEND_DB_TOL or n_ev == 0 or bool(ev_0.overflow.any()):
        raise AssertionError(f"detect_channels(mesh=2x1) differs from no mesh: starts/stops "
                             f"equal {same}, dB err {db_err}, {n_ev} events")
    blocks = int(d_0.shape[1])
    t0 = time.perf_counter()
    _iq_bank_setup(plan["n"], fs, centers, *bank, 4)  # the host half of every sharded call
    setup_s = time.perf_counter() - t0
    out["frontend_iq"] = {
        "bank_mesh": [1, 4], "frames_sharded": list(f_sh.shape), "frames": list(f.shape),
        "bank_max_abs_err": err, "bank_rms": rms, "bank_rel_tol": IQ_SHARD_REL_TOL,
        "bank_sharded_ms": cuda_ms(lambda: sharded_channelize_iq_frames(f_sh, mesh4, fs, centers,
                                                                        *bank), warmup=1, reps=9),
        "bank_unsharded_ms": cuda_ms(lambda: fir.channelize_iq_frames(f, tables, plan),
                                     warmup=1, reps=9),
        "bank_sharded_host_setup_ms": setup_s * 1e3,
        "detect_mesh": [2, 1], "blocks": blocks, "events": n_ev, "events_equal": True,
        "event_db_max_abs_err": db_err, "delta_max_abs_dev": max_dev(d_m, d_0),
        "delta_bit_equal": bits_equal(d_m, d_0),
        "detect_sharded_ms": cuda_ms(lambda: fe.detect_channels(audio, mesh=mesh21, **det),
                                     warmup=1, reps=5),
        "detect_unsharded_ms": cuda_ms(lambda: fe.detect_channels(audio, **det), warmup=1, reps=5),
        # detect_channels' defaults at 0.2 s blocks are SOLVER's
        "scan_ms": cuda_ms(lambda: adaptive.adaptive_thresholds(d_0, **SOLVER), warmup=1, reps=5),
        "scan_shape": list(d_0.shape),
    }
    del f, f_sh, y_s, y_u, audio
    torch.cuda.empty_cache()

    # --- (d) the runtime: no process group without settings; NCCL of one ---
    env = {k: os.environ.pop(k) for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
           if k in os.environ}
    try:
        single = pdist.init_multihost()
    finally:
        os.environ.update(env)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'nccl_store')}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        beat = pdist.Heartbeat().check()
        info = pdist.host_shard_info(STATIONS)
    finally:
        dist.destroy_process_group()
    want = pdist.HostShard(0, 1, (0, STATIONS), torch.cuda.device_count())
    if single is not False or not beat or info != want:
        raise AssertionError(f"runtime: init_multihost() {single}, heartbeat {beat}, {info}")
    out["runtime"] = {"init_multihost_without_env": single, "nccl_world_1_heartbeat": beat,
                      "host_shard": [info.process_id, info.num_processes,
                                     list(info.station_range), info.local_devices]}
    emit(out)
    return out, d_0


# e2e_multiproc: BASELINE config 5 on a mesh spanning two processes of the
# one card.  Two ranks of a gloo group (NCCL refuses two ranks on one GPU),
# each owning the card twice; the joins are bounded so a hung collective
# fails the phase instead of the call.
MULTIPROC_RANKS = 2
MULTIPROC_JOIN_S = 900
MULTIPROC_REPS = 5
MULTIPROC_NCCL_STATIONS = 16  # (d): the stations fixture cut to 16 stations
# (c): the batch day's first 20 minutes (6 000 blocks, 1 500 a shard): the
# warm-started scan is a host loop of ~0.3-0.7 ms a block (e2e_sharded's
# scan_ms), so the whole day's 432 000 blocks would take minutes a call
MULTIPROC_DELTA_MINUTES = 20


def compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def batch_delta_head(x) -> np.ndarray:
    """The batch day's first ``MULTIPROC_DELTA_MINUTES`` as a (1, B)
    delta-dB series (the analyzer's band power), on the host."""
    from meteor_scatter_tpu_torch.ops import bandpower as bp

    head = x[: FS * 60 * MULTIPROC_DELTA_MINUTES]
    return bp.delta_power_db(head, FS, 1024, int(FS * BLOCK_SEC), (993.0, 1013.0),
                             (690.0, 710.0))[2][None].cpu().numpy()


def multiproc_child(rank: int, spec: dict) -> None:
    """One process of ``e2e_multiproc``: rank ``rank`` of a gloo group of
    two through a file store, owning ``[spec["card"]] * 2``.  Runs (a) the
    stations fixture on a 2 x 2 mesh, (b) the at-spec I/Q bank and (c) the
    warm-started detection on 1 x 4 meshes, all spanning both processes,
    and writes its global results (``rank<r>.npz``) and its counts, bytes
    and times (``rank<r>.json``) to ``spec["dir"]``."""
    import torch
    import torch.distributed as dist

    from meteor_scatter_tpu_torch.models import streaming as st
    from meteor_scatter_tpu_torch.parallel import distributed as pdist
    from meteor_scatter_tpu_torch.parallel.mesh import make_mesh
    from meteor_scatter_tpu_torch.parallel.sharded import (
        sharded_channelize_iq,
        sharded_detect_adaptive,
        sharded_stream_process,
    )

    d, card = spec["dir"], torch.device(spec["card"])
    torch.cuda.set_device(card)
    pdist.init_multihost(f"file://{d}/store", MULTIPROC_RANKS, rank, device="cuda",
                         backend="gloo")
    try:
        out, arrays = {"rank": rank}, {}

        def measured(mesh, fn):
            """The first call's results, its launches and bytes, then its ms."""
            torch.cuda.synchronize()
            zero_launch_counts()
            mesh.link.staged_bytes = mesh.link.wire_bytes = 0
            res = fn()
            torch.cuda.synchronize()
            rec = {"launches": launch_counts(), "staged_bytes": mesh.link.staged_bytes,
                   "wire_bytes": mesh.link.wire_bytes, "transport": mesh.transport,
                   "owners": mesh.owners}
            rec["ms"] = cuda_ms(fn, warmup=1, reps=MULTIPROC_REPS)
            return res, rec

        # --- (a) BASELINE config 5: 64 stations x 600 s, 2 x 2 mesh, K3 ---
        cfg = live_config()
        scfg = st.StreamConfig.from_config(cfg)
        x = torch.from_numpy(np.load(os.path.join(d, "stations.npy"))).to(card)
        # the bins front's projection is numpy's eigh on the host, cached per
        # process: made one process at a time, as two processes' BLAS threads
        # at once oversubscribe the host
        for r in range(MULTIPROC_RANKS):
            if r == rank:
                st.stream_front_headless(cfg, x[:1, :1], LIVE_FS)
            dist.barrier()
        st0 = st.stream_init_batch(scfg, x.shape[0], device=card)
        mesh = make_mesh(2, 2, [card] * 2)
        if mesh.transport != spec["transport"]:
            raise AssertionError(f"transport {mesh.transport}, expected {spec['transport']}")
        (state, ev, dg), out["a"] = measured(mesh, lambda: sharded_stream_process(
            cfg, st0, x, LIVE_FS, mesh, front="bins", impl="fused"))
        arrays.update({f"a.state.{f}": v for f, v in zip(state._fields, state)})
        arrays.update({f"a.events.{f}": v for f, v in zip(ev._fields, ev)})
        arrays.update({f"a.{k}": dg[k] for k in ("threshold", "over_noise")})
        del x, dg

        # --- (b) BASELINE config 4's bank at spec, flat, halos on 1 x 4 ---
        with open(os.path.join(d, "iq.json")) as f:
            centers = np.asarray(json.load(f)["centers"])
        x_re = torch.from_numpy(np.load(os.path.join(d, "iq_re.npy"))).to(card)
        x_im = torch.from_numpy(np.load(os.path.join(d, "iq_im.npy"))).to(card)
        mesh14 = make_mesh(1, 4, [card] * 2)
        bank = (IQ_BANDWIDTH, IQ_DECIM, IQ_NUMTAPS)
        (y_re, y_im), out["b"] = measured(mesh14, lambda: sharded_channelize_iq(
            x_re, x_im, mesh14, int(FRONTEND_FS), centers, *bank))
        arrays.update({"b.y_re": y_re, "b.y_im": y_im})
        del x_re, x_im
        torch.cuda.empty_cache()

        # --- (c) the warm-started detection over the batch day's head, 1 x 4 ---
        delta = torch.from_numpy(np.load(os.path.join(d, "delta.npy"))).to(card)
        (thr, above), out["c"] = measured(mesh14, lambda: sharded_detect_adaptive(
            delta, mesh14, **SOLVER))
        arrays.update({"c.thresholds": thr, "c.above": above})

        loaded = port_modules_loaded_from_jax()
        if loaded:
            raise AssertionError(f"a child loaded JAX or the JAX package: {loaded[:5]}")
        np.savez(os.path.join(d, f"rank{rank}.npz"),
                 **{k: v.cpu().numpy() for k, v in arrays.items()})
        with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_multiproc(d: str) -> list:
    """The two children of ``e2e_multiproc``; a child that fails fails the
    phase (``ProcessRaisedException``), and one that outlasts the join
    bound is killed and fails it too.  Returns each rank's (arrays, record)."""
    import torch.multiprocessing as mp

    spec = {"dir": d, "card": "cuda:0", "transport": "gloo-host-staged"}
    ctx = mp.spawn(multiproc_child, args=(spec,), nprocs=MULTIPROC_RANKS, join=False)
    deadline = time.monotonic() + MULTIPROC_JOIN_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"e2e_multiproc: the children ran past {MULTIPROC_JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    ranks = []
    for r in range(MULTIPROC_RANKS):
        with np.load(os.path.join(d, f"rank{r}.npz")) as z:
            arrays = dict(z)
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append((arrays, json.load(f)))
    return ranks


def phase_e2e_multiproc(tmp: str, iq: dict, day_delta: np.ndarray) -> dict:
    """The multi-device layer on a process group: a mesh that spans two
    processes sharing the card (gloo, staged through the host), each owning
    ``cuda:0`` twice.  (a) BASELINE config 5 (:func:`stations_fixture`)
    through ``sharded_stream_process(front="bins", impl="fused")`` on 2 x 2
    (K3 once per owned position, 2 in each process), bit-equal to the
    unsharded batched ``stream_process`` here; (b) the at-spec I/Q bank
    flat through ``sharded_channelize_iq`` on 1 x 4 (halos across the
    process seam and a local seam) within ``IQ_SHARD_REL_TOL`` of the
    unsharded bank; (c) ``sharded_detect_adaptive`` on 1 x 4 over the batch
    day's first 20 minutes, the mask equal to the single-process sharded
    one;
    (d) a world-size-1 NCCL group driving (a) over 16 stations.  Each with
    its time in the children beside the same call on one process's virtual
    mesh.  Without the ``Default`` compute mode (a)-(c) go under
    ``not_run``; (d) runs."""
    import torch
    import torch.distributed as dist

    from meteor_scatter_tpu_torch.models import streaming as st
    from meteor_scatter_tpu_torch.ops import fir
    from meteor_scatter_tpu_torch.ops.kernels import stream_kernel as sk
    from meteor_scatter_tpu_torch.parallel.mesh import make_mesh
    from meteor_scatter_tpu_torch.parallel.sharded import (
        sharded_channelize_iq,
        sharded_detect_adaptive,
        sharded_stream_process,
    )

    card = f"{DEVICE}:{torch.cuda.current_device()}"
    mode = compute_mode()
    out = {"phase": "e2e_multiproc", "nvidia_smi": nvidia_smi_line(), "compute_mode": mode,
           "note": "two processes share one card through gloo, every transfer staged through "
                   "the host: the times measure the transport and the bookkeeping of a mesh "
                   "that spans processes, not scaling", "not_run": []}
    cfg = live_config()
    scfg = st.StreamConfig.from_config(cfg)
    x, _, _, _ = stations_fixture()
    st0 = st.stream_init_batch(scfg, STATIONS, device=DEVICE)
    fs = int(FRONTEND_FS)
    bank = (IQ_BANDWIDTH, IQ_DECIM, IQ_NUMTAPS)
    k3_children = 0
    if mode == "Default":
        d = os.path.join(tmp, "multiproc")
        os.makedirs(d)
        t0 = time.perf_counter()
        np.save(os.path.join(d, "stations.npy"), x.cpu().numpy())
        np.save(os.path.join(d, "iq_re.npy"), iq["x_re"])
        np.save(os.path.join(d, "iq_im.npy"), iq["x_im"])
        np.save(os.path.join(d, "delta.npy"), day_delta)
        with open(os.path.join(d, "iq.json"), "w") as f:
            json.dump({"centers": iq["centers"].tolist()}, f)
        t1 = time.perf_counter()
        ranks = spawn_multiproc(d)
        out["inputs_to_files_s"], out["children_wall_s"] = t1 - t0, time.perf_counter() - t1
        recs = [rec for _, rec in ranks]

        # (a) against the unsharded batched solve, bit for bit
        state_u, ev_u, dg_u = st.stream_process(cfg, st0, x, LIVE_FS, front="bins", impl="fused")
        want = {f"a.state.{f}": v for f, v in zip(state_u._fields, state_u)}
        want.update({f"a.events.{f}": v for f, v in zip(ev_u._fields, ev_u)})
        want.update({f"a.{k}": dg_u[k] for k in ("threshold", "over_noise")})
        unequal = sorted({k for arrays, _ in ranks for k, v in want.items()
                          if not bits_equal(torch.from_numpy(arrays[k]), v.cpu())})
        launches = [rec["a"]["launches"] for rec in recs]
        if unequal or any(ln != {"adaptive_solver": 0, "bandpower": 0, "stream_machine": 2}
                          for ln in launches) or bool(ev_u.overflow.any()):
            raise AssertionError(f"multiproc stations: leaves not bit-equal to the unsharded "
                                 f"solve {unequal[:6]}, launches {launches}")
        k3_children = sum(ln["stream_machine"] for ln in launches)
        mesh22 = make_mesh(2, 2, [card] * 4)
        out["stations"] = {
            "mesh": [2, 2], "processes": MULTIPROC_RANKS, "owners": recs[0]["a"]["owners"],
            "transport": recs[0]["a"]["transport"], "stations": STATIONS,
            "k3_launches_per_process": [ln["stream_machine"] for ln in launches],
            "k3_shape": [int(dg_u["threshold"].shape[1]), STATIONS // 2],
            "events": int(ev_u.count.sum()), "bit_equal_unsharded": True,
            "ms_per_process": [rec["a"]["ms"] for rec in recs],
            "staged_bytes_per_call": [rec["a"]["staged_bytes"] for rec in recs],
            "wire_bytes_per_call": [rec["a"]["wire_bytes"] for rec in recs],
            "single_process_virtual_ms": cuda_ms(lambda: sharded_stream_process(
                cfg, st0, x, LIVE_FS, mesh22, front="bins", impl="fused"), warmup=1,
                reps=MULTIPROC_REPS),
            "unsharded_ms": cuda_ms(lambda: st.stream_process(
                cfg, st0, x, LIVE_FS, front="bins", impl="fused"), warmup=1, reps=MULTIPROC_REPS),
        }
        del state_u, ev_u, dg_u

        # (b) against the unsharded bank, within the bank's tolerance
        stacked = np.stack([iq["x_re"], iq["x_im"]])
        plan, tables = fir.channel_bank_plan(stacked.shape[-1], fs, iq["centers"], *bank,
                                             device=DEVICE)
        y_u = fir.channelize_iq_frames(torch.from_numpy(fir.frame_capture_host(stacked, plan))
                                       .to(DEVICE), tables, plan)
        del stacked
        rms = math.sqrt(float(sum((y * y).mean() for y in y_u)) / 2)
        errs = [max(float((torch.from_numpy(arrays[k]).to(DEVICE) - y).abs().max())
                    for k, y in zip(("b.y_re", "b.y_im"), y_u)) for arrays, _ in ranks]
        del y_u
        x_re = torch.from_numpy(iq["x_re"]).to(DEVICE)
        x_im = torch.from_numpy(iq["x_im"]).to(DEVICE)
        mesh14 = make_mesh(1, 4, [card] * 4)
        y_v = sharded_channelize_iq(x_re, x_im, mesh14, fs, iq["centers"], *bank)
        same_v = all(bits_equal(torch.from_numpy(arrays[k]), y.cpu())
                     for arrays, _ in ranks for k, y in zip(("b.y_re", "b.y_im"), y_v))
        del y_v
        if not max(errs) <= IQ_SHARD_REL_TOL * rms:
            raise AssertionError(f"multiproc I/Q bank: max |sharded - unsharded| {errs} > "
                                 f"{IQ_SHARD_REL_TOL} x RMS {rms}")
        out["frontend_iq"] = {
            "mesh": [1, 4], "owners": recs[0]["b"]["owners"], "samples": int(iq["x_re"].size),
            "bank_max_abs_err": errs, "bank_rms": rms, "bank_rel_tol": IQ_SHARD_REL_TOL,
            "bit_equal_single_process_virtual": same_v,
            "ms_per_process": [rec["b"]["ms"] for rec in recs],
            "staged_bytes_per_call": [rec["b"]["staged_bytes"] for rec in recs],
            "wire_bytes_per_call": [rec["b"]["wire_bytes"] for rec in recs],
            "single_process_virtual_ms": cuda_ms(lambda: sharded_channelize_iq(
                x_re, x_im, mesh14, fs, iq["centers"], *bank), warmup=1, reps=MULTIPROC_REPS),
        }
        del x_re, x_im
        torch.cuda.empty_cache()

        # (c) against the same call on one process's virtual 1 x 4 mesh
        delta = torch.from_numpy(day_delta).to(DEVICE)
        thr_v, above_v = sharded_detect_adaptive(delta, mesh14, **SOLVER)
        mask_equal = all(bits_equal(torch.from_numpy(arrays["c.above"]), above_v.cpu())
                         for arrays, _ in ranks)
        thr_equal = all(bits_equal(torch.from_numpy(arrays["c.thresholds"]), thr_v.cpu())
                        for arrays, _ in ranks)
        if not mask_equal:
            raise AssertionError("multiproc warm-started detection: the mask differs from the "
                                 "single-process sharded mask")
        out["detect_adaptive"] = {
            "mesh": [1, 4], "blocks": int(delta.shape[1]), "above": int(above_v.sum()),
            "mask_bit_equal_single_process": True, "thresholds_bit_equal": thr_equal,
            "ms_per_process": [rec["c"]["ms"] for rec in recs],
            "staged_bytes_per_call": [rec["c"]["staged_bytes"] for rec in recs],
            "wire_bytes_per_call": [rec["c"]["wire_bytes"] for rec in recs],
            "single_process_virtual_ms": cuda_ms(lambda: sharded_detect_adaptive(
                delta, mesh14, **SOLVER), warmup=1, reps=MULTIPROC_REPS),
        }
    else:
        out["not_run"] += [{"path": p, "reason": f"compute mode {mode!r}, not 'Default': two "
                                                 f"processes cannot share the card"}
                           for p in ("stations 2 x 2", "frontend_iq 1 x 4", "detect_adaptive 1 x 4")]

    # --- (d) the process-group path on a world-size-1 NCCL group ---
    xs = x[:MULTIPROC_NCCL_STATIONS]
    st_s = st.stream_init_batch(scfg, MULTIPROC_NCCL_STATIONS, device=DEVICE)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(tmp, 'nccl_mp_store')}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(2, 2, [card] * 4)

        def nccl_call():
            return sharded_stream_process(cfg, st_s, xs, LIVE_FS, mesh, front="bins", impl="fused")

        torch.cuda.synchronize()
        sk.launches = 0
        state_n, ev_n, dg_n = nccl_call()
        torch.cuda.synchronize()
        k3_d, transport = sk.launches, mesh.transport
        nccl_ms = cuda_ms(nccl_call, warmup=1, reps=MULTIPROC_REPS)
    finally:
        dist.destroy_process_group()
    state_u, ev_u, dg_u = st.stream_process(cfg, st_s, xs, LIVE_FS, front="bins", impl="fused")
    same = all(bits_equal(a, b) for a, b in zip((*state_n, *ev_n, dg_n["threshold"]),
                                                (*state_u, *ev_u, dg_u["threshold"])))
    if transport != "nccl" or k3_d != 4 or not same:
        raise AssertionError(f"NCCL world 1: transport {transport}, K3 {k3_d} (expected 4), "
                             f"bit-equal to unsharded {same}")
    out["nccl_world_1"] = {"mesh": [2, 2], "stations": MULTIPROC_NCCL_STATIONS,
                           "transport": transport, "k3_launches": k3_d,
                           "bit_equal_unsharded": True, "ms": nccl_ms}
    out["k3_launches_children"] = k3_children
    del x, xs
    torch.cuda.empty_cache()
    emit(out)
    return out


def cpu_solver_ms(scfg, on, pm) -> dict:
    """Median wall ms of the scan, jump and hop on CPU copies of the levels
    ``on`` / ``pm`` (one series ``(n,)`` or a batch ``(C, n)``) from a
    fresh state, each checked against the scan: thresholds and counts bit
    for bit."""
    import torch

    from meteor_scatter_tpu_torch.models import streaming as st

    on, pm = on.cpu(), pm.cpu()
    st0 = (st.stream_init(scfg, device="cpu") if on.dim() == 1
           else st.stream_init_batch(scfg, on.shape[0], device="cpu"))
    out = {"shape": list(on.shape), "threads": torch.get_num_threads()}
    want = None
    for name, solve in (("scan", st.stream_scan), ("jump", st.stream_scan_jump),
                        ("hop", st.stream_scan_jump_batch)):
        times = []
        for _ in range(EPISODE_CPU_REPS):
            t0 = time.perf_counter()
            got = solve(scfg, st0, on, pm)
            times.append((time.perf_counter() - t0) * 1e3)
        want = want or got
        if not (bits_equal(got[2], want[2]) and bits_equal(got[1].count, want[1].count)):
            raise AssertionError(f"CPU {name} on {list(on.shape)}: other thresholds or counts")
        out[f"{name}_ms"] = statistics.median(times)
    out["events"] = int(want[1].count.sum())
    return out


def degraded_series(C: int, n: int):
    """The shape of ``tests/test_torch_episode.py::pathological``: a 9 dB
    one-block spike every 3 blocks on 0.3 dB noise, C channels (seed 50 +
    c), a lock episode at each spike, far more than a small ``cap``'s
    ``4·cap + 8`` records."""
    import torch

    on = np.empty((C, n), np.float32)
    for c in range(C):
        on[c] = np.random.default_rng(50 + c).standard_normal(n) * 0.3
    on[:, 60:580:3] += 9.0
    return torch.from_numpy(on).to(DEVICE), torch.full((C, n), -80.0, device=DEVICE)


def episode_against(got, want, impl: str) -> dict:
    """An episode solve ``got`` against ``want`` (moved to ``want``'s
    device), as the solvers' contract states them: count, overflow, start /
    stop times, the integer and entry state leaves and ``thr_degraded`` bit
    for bit; the events' other fields within ``EPISODE_TOL``; the state
    sums, thresholds and the locked threshold (a copy of one) within
    ``EPISODE_STATE_TOL`` (a root on the CPU may be an ulp off the card's),
    with the blocks whose bits differ counted.  Returns the failures and the
    deviations."""
    import torch

    dev = want[2].device

    def to(t):
        if isinstance(t, dict):
            return {k: v.to(dev) for k, v in t.items()}
        return type(t)(*(a.to(dev) for a in t)) if isinstance(t, tuple) else t.to(dev)

    got = [to(t) for t in got]
    (st_g, ev_g, thr_g), (st_w, ev_w, thr_w) = got[:3], want[:3]
    valid = torch.arange(ev_w.time_start.shape[-1], device=dev) < ev_w.count[..., None]

    def events_in(ev, f):  # an event field, zero past each channel's count
        return torch.where(valid, getattr(ev, f), 0.0)

    exact = {"count": bits_equal(ev_g.count, ev_w.count),
             "overflow": bits_equal(ev_g.overflow, ev_w.overflow)}
    exact.update({f: bits_equal(events_in(ev_g, f), events_in(ev_w, f))
                  for f in ("time_start", "time_stop")})
    exact.update({f"state.{f}": bits_equal(getattr(st_g, f), getattr(st_w, f))
                  for f in EPISODE_EXACT_STATE})
    if impl == "hop":
        exact["thr_degraded"] = bits_equal(got[3]["thr_degraded"], want[3]["thr_degraded"])
    pairs = {f: (events_in(ev_g, f), events_in(ev_w, f), EPISODE_TOL[impl])
             for f in ("duration", "db_min", "db_max", "db_mean", "db_std")}
    pairs.update({f"state.{f}": (getattr(st_g, f), getattr(st_w, f), EPISODE_STATE_TOL)
                  for f in EPISODE_CLOSE_STATE})
    pairs["thresholds"] = (thr_g, thr_w, EPISODE_STATE_TOL)
    wide = [f for f, (a, b, t) in pairs.items()
            if not bool(torch.isclose(a, b, rtol=t, atol=t, equal_nan=True).all())]
    unequal_bits = lambda a, b: int((a.view(torch.int32) != b.view(torch.int32)).sum())  # noqa: E731
    return {"unequal": [f for f, ok in exact.items() if not ok], "beyond_tolerance": wide,
            "max_abs_dev": {f: max_dev(a, b) for f, (a, b, _) in pairs.items()},
            "threshold_blocks_unequal": unequal_bits(thr_g, thr_w)
            + unequal_bits(st_g.locked_threshold, st_w.locked_threshold)}


def phase_e2e_episode(tmp: str) -> dict:
    """The episode-jump solvers (``impl="jump"`` / ``"hop"``), which on the
    card solve through K3: (a) BASELINE config 5 (:func:`stations_fixture`):
    ``stream_scan_jump`` and ``stream_scan_jump_batch(with_diag=True)`` over
    the 64 channels' series, each one K3 launch and no lockstep iteration,
    against the lockstep solvers on the card (the path they replace, timed
    beside them) and on CPU copies, and ``stream_process`` on the audio;
    (a') a chunk past hop's record bound (``n_blocks + 2 > 4·cap + 8``),
    which runs the lockstep hop on the card, against the CPU's; (b) the
    first hour of the live day through ``apps.live.main`` with ``--impl
    jump``, ``hop`` and ``fused``, K3 once a feed each, equal event lines;
    (c) the stations through ``sharded_stream_process(front="bins",
    impl="hop")`` on a 2 x 4 mesh of the card, K3 once per position,
    against the unsharded hop; (d) ``welch_band_sums_db`` on the card
    against the CPU in both branches, and ``adaptive_thresholds_fast`` on
    the whole batch day against K1's walk route; (e) the scan, jump and hop
    on the CPU on the stations' series and the live day's first feed.  The
    routed solvers' K3 launches, each read from counts zeroed just before
    its call, are ``k3_launches``, added to the kernel record: (a) the two
    solves and their two ``stream_process`` calls, (b) the jump and hop
    hours, (c) the sharded call and the unsharded ``stream_process``.  K1's,
    the yardstick's, the fused hour's (a path ``e2e_live`` counts) and the
    check of hop on the gathered series stay out of it."""
    import torch

    from meteor_scatter_tpu_torch.io.wavio import read_wav
    from meteor_scatter_tpu_torch.models import adaptive
    from meteor_scatter_tpu_torch.models import streaming as st
    from meteor_scatter_tpu_torch.models.events import events_from_mask
    from meteor_scatter_tpu_torch.ops import bandpower as bp
    from meteor_scatter_tpu_torch.ops import welch
    from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as ak
    from meteor_scatter_tpu_torch.ops.kernels import stream_kernel as sk
    from meteor_scatter_tpu_torch.parallel.mesh import make_mesh
    from meteor_scatter_tpu_torch.parallel.sharded import sharded_stream_process

    out = {"phase": "e2e_episode", "nvidia_smi": nvidia_smi_line()}
    cfg = live_config()
    scfg = st.StreamConfig.from_config(cfg)
    x, n, _, _ = stations_fixture()
    st0 = st.stream_init_batch(scfg, STATIONS, device=DEVICE)
    k3_launches = 0  # of the routed solvers on the main paths

    # --- (a) the 64 stations: jump and hop, one K3 launch each ---
    on, pm, _ = st.stream_front_headless(cfg, x, LIVE_FS)
    zero_launch_counts()
    k3 = st.stream_scan_fused_batch(scfg, st0, on, pm)
    torch.cuda.synchronize()
    if sk.launches != 1:
        raise AssertionError(f"episode: K3 launched {sk.launches} times, expected 1")
    out["k3_yardstick_launches"] = sk.launches
    out["k3_call_ms"] = cuda_ms(lambda: st.stream_scan_fused_batch(scfg, st0, on, pm),
                                warmup=2, reps=5)
    cpu = lambda t: st._map(lambda a: a.cpu(), t)  # noqa: E731
    st0_c, on_c, pm_c = cpu(st0), on.cpu(), pm.cpu()

    solvers = {"jump": st.stream_scan_jump,
               "hop": lambda *a: st.stream_scan_jump_batch(*a, with_diag=True)}
    lockstep = {"jump": lambda *a: st._jump(scfg, *a),  # the loops these calls ran before
                "hop": lambda *a: st._hop(scfg, *a, track_hop=128)}
    for impl, solve in solvers.items():
        zero_launch_counts()
        st.iterations = st.syncs = 0
        got = solve(scfg, st0, on, pm)
        torch.cuda.synchronize()
        counts = {"iterations": st.iterations, "syncs": st.syncs, "k3_launches": sk.launches}
        on_card = got[2].device.type == got[1].count.device.type == torch.device(DEVICE).type
        if sk.launches != 1 or st.iterations or st.syncs or not on_card:
            raise AssertionError(f"episode {impl}: {counts}, on {got[2].device}")
        k3_launches += sk.launches
        same_k3 = all(bits_equal(a, b) for a, b in zip((got[2], *got[1], *got[0]),
                                                         (k3[2], *k3[1], *k3[0])))
        card_ls = lockstep[impl](st0, on, pm)
        against = {"lockstep_card": episode_against(got, card_ls, impl),
                   "lockstep_cpu": episode_against(got, solve(scfg, st0_c, on_c, pm_c), impl)}
        bad = {k: (v["unequal"], v["beyond_tolerance"]) for k, v in against.items()
               if v["unequal"] or v["beyond_tolerance"]}
        if against["lockstep_card"]["threshold_blocks_unequal"]:  # one device: the same roots
            bad["lockstep_card_thresholds"] = against["lockstep_card"]["threshold_blocks_unequal"]
        if bad or not same_k3 or int(got[1].count.sum()) < STATIONS:
            raise AssertionError(f"episode {impl} on K3: bit-equal to the yardstick {same_k3}, "
                                 f"against the lockstep {bad} ({against}), "
                                 f"{int(got[1].count.sum())} events")
        if impl == "hop" and bool(got[3]["thr_degraded"].any()):
            raise AssertionError("episode hop on K3: thr_degraded inside the bound")
        # the entry point on the audio: one more K3 launch, the same events
        zero_launch_counts()
        _, ev_p, dg_p = st.stream_process(cfg, st0, x, LIVE_FS, front="bins", impl=impl)
        torch.cuda.synchronize()
        if not (torch.equal(ev_p.count, got[1].count) and sk.launches == 1
                and ("thr_degraded" in dg_p) == (impl == "hop")):
            raise AssertionError(f"episode {impl}: stream_process found other events "
                                 f"({sk.launches} K3 launches)")
        k3_launches += sk.launches
        out[impl] = {
            **counts, "events": int(got[1].count.sum()), "bit_equal_k3_yardstick": True,
            **{f"{k}_max_abs_dev": v["max_abs_dev"] for k, v in against.items()},
            "cpu_threshold_blocks_unequal": against["lockstep_cpu"]["threshold_blocks_unequal"],
            "tol": EPISODE_TOL[impl],
            "thr_degraded": bool(got[3]["thr_degraded"].any()) if impl == "hop" else None,
            "solve_ms": cuda_ms(lambda: solve(scfg, st0, on, pm), warmup=2, reps=5),
            "lockstep_card_ms": cuda_ms(lambda: lockstep[impl](st0, on, pm), warmup=1, reps=3),
            "process_ms": cuda_ms(lambda: st.stream_process(cfg, st0, x, LIVE_FS, front="bins",
                                                            impl=impl), warmup=1, reps=5),
        }
        # K3's device time within the call (the rest of solve_ms is the host's)
        out[impl]["k3_device_ms"] = kernel_device_ms(lambda: solve(scfg, st0, on, pm),
                                                     "stream_solve_kernel")
        del card_ls

    # --- (a') past hop's record bound: the lockstep hop on the card ---
    dcfg = scfg._replace(cap=2, min_dur_sec=2.0)
    on_d, pm_d = degraded_series(EPISODE_DEGRADED_STATIONS, 600)
    if st._hop_records_fit(dcfg, on_d.shape[1]):
        raise AssertionError("episode: the degraded case lies inside hop's record bound")
    zero_launch_counts()
    st.iterations = st.syncs = 0
    st0_d = st.stream_init_batch(dcfg, EPISODE_DEGRADED_STATIONS, device=DEVICE)
    got = st.stream_scan_jump_batch(dcfg, st0_d, on_d, pm_d, with_diag=True)
    torch.cuda.synchronize()
    d_counts = {"iterations": st.iterations, "syncs": st.syncs, "k3_launches": sk.launches}
    want = st.stream_scan_jump_batch(dcfg, cpu(st0_d), on_d.cpu(), pm_d.cpu(), with_diag=True)
    cmp_d = episode_against(got, want, "hop")
    if (sk.launches or not st.iterations or cmp_d["unequal"] or cmp_d["beyond_tolerance"]
            or not bool(got[3]["thr_degraded"].all()) or got[2].device.type != "cuda"):
        raise AssertionError(f"episode hop past the bound: {d_counts}, against the CPU {cmp_d}, "
                             f"thr_degraded {got[3]['thr_degraded'].tolist()}")
    out["hop_past_bound"] = {
        "shape": list(on_d.shape), "cap": dcfg.cap, **d_counts,
        "thr_degraded": got[3]["thr_degraded"].tolist(), "events": int(got[1].count.sum()),
        "cpu_max_abs_dev": cmp_d["max_abs_dev"],
        "cpu_threshold_blocks_unequal": cmp_d["threshold_blocks_unequal"],
        "ms": cuda_ms(lambda: st.stream_scan_jump_batch(dcfg, st0_d, on_d, pm_d, with_diag=True),
                      warmup=1, reps=3)}
    del on_d, pm_d, got, want, st0_c, on_c, pm_c
    # the lockstep loops' base-threshold prologue (K3's twin's), alone
    out["prologue_ms"] = cuda_ms(lambda: sk.ring_base_thresholds(
        st0.ring, st0.block_idx, on, scfg.avg_win, scfg.k_std), warmup=2, reps=5)
    # --- (e) the same series on the CPU: scan, jump and hop ---
    out["cpu_stations"] = cpu_solver_ms(scfg, on, pm)

    # --- (c) sharded hop on 2 x 4 positions of the card against the unsharded hop ---
    card = f"{DEVICE}:{torch.cuda.current_device()}"
    mesh = make_mesh(2, 4, [card] * 8)
    zero_launch_counts()
    st.iterations = st.syncs = 0
    st_s, ev_s, dg_s = sharded_stream_process(cfg, st0, x, LIVE_FS, mesh, front="bins", impl="hop")
    torch.cuda.synchronize()
    sh_counts = {"iterations": st.iterations, "syncs": st.syncs, "k3_launches": sk.launches}
    zero_launch_counts()
    st_u, ev_u, dg_u = st.stream_process(cfg, st0, x, LIVE_FS, front="bins", impl="hop")
    torch.cuda.synchronize()
    unsharded_launches = sk.launches
    k3_launches += sh_counts["k3_launches"] + unsharded_launches
    # a check only, not counted: hop on the gathered series, the same bits
    twin = st.stream_scan_jump_batch(scfg, st0, dg_s["over_noise"], torch.zeros_like(dg_s["over_noise"]))
    same = {f: bits_equal(getattr(ev_s, f), getattr(ev_u, f))
            for f in ("count", "overflow", "time_start", "time_stop")}
    same["thresholds"] = bits_equal(dg_s["threshold"], dg_u["threshold"])
    same["thresholds_hop_on_gathered"] = bits_equal(dg_s["threshold"], twin[2])
    if (not all(same.values()) or sh_counts["iterations"] or sh_counts["k3_launches"] != 8
            or unsharded_launches != 1):
        raise AssertionError(f"episode sharded hop against unsharded: {same}, {sh_counts}, "
                             f"{unsharded_launches} K3 launches unsharded (expected 1)")
    out["sharded_hop"] = {"mesh": [2, 4], **sh_counts, "unsharded_k3_launches": unsharded_launches,
                          "events": int(ev_s.count.sum()),
                          "equal": same,
                          "over_noise_max_abs_dev": max_dev(dg_s["over_noise"], dg_u["over_noise"]),
                          "sharded_ms": cuda_ms(lambda: sharded_stream_process(
                              cfg, st0, x, LIVE_FS, mesh, front="bins", impl="hop"), warmup=1, reps=5)}

    # --- (d) welch_band_sums_db, card against CPU, both branches ---
    bands = (cfg.signal_band, cfg.noise_band_1, cfg.noise_band_2)
    xw = x[:EPISODE_WELCH_STATIONS]
    out["welch_band_sums_db"] = {"shape": list(xw.shape), "tol_db": EPISODE_WELCH_DB_TOL}
    for noverlap in (128, 100):  # hop 128 divides nperseg 256 (group sums); 156 does not
        P, slices = welch.welch_band_matrix(LIVE_FS, cfg.n_fft, 256, bands)
        Pc = torch.from_numpy(P).to(DEVICE)
        got = welch.welch_band_sums_db(xw, 256, Pc, slices, noverlap=noverlap)
        want = welch.welch_band_sums_db(xw.cpu(), 256, torch.from_numpy(P), slices, noverlap=noverlap)
        err = max(max_dev(g.cpu(), w) for g, w in zip(got, want))
        if not (err <= EPISODE_WELCH_DB_TOL and got[0].device.type == torch.device(DEVICE).type):
            raise AssertionError(f"welch_band_sums_db noverlap {noverlap}: card vs CPU {err} dB")
        out["welch_band_sums_db"][f"noverlap_{noverlap}"] = {
            "max_abs_err_db": err,
            "ms": cuda_ms(lambda: welch.welch_band_sums_db(xw, 256, Pc, slices, noverlap=noverlap),
                          warmup=1, reps=5)}
    del x, xw, on, pm, dg_p, dg_s, dg_u, twin
    torch.cuda.empty_cache()

    # --- (d) adaptive_thresholds_fast on the whole batch day against K1 ---
    fs_a, pcm = read_wav(os.path.join(tmp, ANALYZE_WAV), mono=True)
    block = int(fs_a * BLOCK_SEC)
    audio = torch.from_numpy(pcm).to(DEVICE).to(torch.float32)
    del pcm
    delta = bp.delta_power_db(audio, fs_a, 1024, block, (993.0, 1013.0), (690.0, 710.0))[2]
    del audio
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    thr_f, above_f = adaptive.adaptive_thresholds_fast(delta, **SOLVER)
    torch.cuda.synchronize()
    fast_s = time.perf_counter() - t0
    ev_f = events_from_mask(above_f, delta, EPISODE_K1_CAP)
    zero_launch_counts()
    ev_k, thr_k = adaptive._detect_adaptive_fused(delta, EPISODE_K1_CAP, **SOLVER)
    torch.cuda.synchronize()
    walks = ak.walk_launches
    want_walks = math.ceil(delta.shape[0] / (ak.MAX_FUSED_BLOCKS - SOLVER["window_blocks"]))
    thr_err = max_dev(thr_f, thr_k)
    # runs of above are the events: with no overflow, equal events are an equal mask
    same = {f: bool(torch.equal(getattr(ev_f, f), getattr(ev_k, f)))
            for f in ("start", "stop", "count", "overflow")}
    if not (all(same.values()) and not bool(ev_f.overflow) and int(ev_f.count) > 0
            and above_f.device.type == torch.device(DEVICE).type
            and thr_err <= THR_TOL_DB and walks == want_walks):
        raise AssertionError(f"adaptive_thresholds_fast against K1 on the day: {same}, "
                             f"thresholds {thr_err} dB, {walks} walk launches of {want_walks}")
    _, _, rounds = adaptive._fixpoint(delta, **SOLVER)
    out["adaptive_thresholds_fast"] = {
        "blocks": int(delta.shape[0]), "above_blocks": int(above_f.sum()),
        "events": int(ev_f.count), "events_equal_k1": True, "fixpoint_rounds": rounds,
        "threshold_max_abs_dev_db": thr_err, "tol_db": THR_TOL_DB, "k1_walk_launches": walks,
        "wall_s": fast_s, "ms": cuda_ms(lambda: adaptive.adaptive_thresholds_fast(delta, **SOLVER),
                                        warmup=1, reps=5),
        "k1_ms": cuda_ms(lambda: adaptive._detect_adaptive_fused(delta, EPISODE_K1_CAP, **SOLVER),
                         warmup=1, reps=5),
    }
    del delta, thr_f, above_f, thr_k

    # --- (b) the live CLI on the first hour: jump, hop and fused print the same lines ---
    wav = os.path.join(tmp, "live_4khz_24h.wav")
    # --- (e) the first feed's series on the CPU: scan, jump and hop ---
    fs_l, pcm = read_wav(wav, mono=True)
    feed = torch.from_numpy(pcm[: int(LIVE_FEED_SEC * fs_l)]).to(DEVICE).to(torch.float32)
    del pcm
    on_l, pm_l, _ = st.stream_front_headless(cfg, feed, fs_l)
    out["cpu_live_feed"] = cpu_solver_ms(scfg, on_l, pm_l)
    del feed, on_l, pm_l
    lines, feeds = {}, math.ceil(3600 / LIVE_FEED_SEC)
    out["live_hour"] = {"feeds": feeds}
    for impl in ("fused", "jump", "hop"):
        st.iterations = st.syncs = 0
        events, text, wall, launches, _ = run_live_main(
            [wav, "--device", DEVICE, "--stop-sec", "3600", "--impl", impl, *LIVE_ARGS])
        lines[impl] = [ln for ln in text.splitlines() if ln.startswith("Detected Meteor:")]
        if launches != feeds or st.iterations or not lines[impl]:
            raise AssertionError(f"live --impl {impl}: {launches} K3 launches (expected {feeds}), "
                                 f"{st.iterations} iterations, {len(lines[impl])} events")
        if impl != "fused":  # fused is the yardstick here; e2e_live counts its path
            k3_launches += launches
        out["live_hour"][impl] = {"events": len(lines[impl]), "k3_launches": launches,
                                  "iterations": st.iterations, "syncs": st.syncs,
                                  "wall_s": wall, "ms_per_feed": wall / feeds * 1e3}
    if not lines["jump"] == lines["hop"] == lines["fused"]:
        raise AssertionError("live --impl jump / hop / fused print different event lines")
    out["live_hour"]["lines_equal"] = True
    out["k3_launches"] = k3_launches
    emit(out)
    return out


def distinct_bits(fn, reps: int = DETERMINISM_REPEATS) -> int:
    """How many different results, bit for bit, ``reps`` calls of ``fn``
    give (a tensor or a tuple of tensors)."""
    import torch

    seen = set()
    for _ in range(reps):
        r = fn()
        r = r if isinstance(r, tuple) else (r,)
        seen.add(b"".join(t.reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes()
                          for t in r))
    return len(seen)


def keep_day_wav(tmp: str, host_tmp: str) -> str:
    """Move the batch day's WAV (same gqrx name) out of ``tmp`` for
    ``e2e_determinism``."""
    os.makedirs(os.path.join(host_tmp, "day"))
    path = os.path.join(host_tmp, "day", ANALYZE_WAV)
    os.replace(os.path.join(tmp, ANALYZE_WAV), path)
    return path


def phase_e2e_determinism(day_wav: str, fe_delta) -> dict:
    """The batch day's detections written twice a route byte for byte, the
    event means and the fixpoint's thresholds the same bits over repeats,
    the ``ms-torch-*`` scripts, ``build_native`` and ``LOCAL_RANK``."""
    import importlib
    import importlib.util
    import tomllib

    import torch

    from meteor_scatter_tpu_torch.apps import analyze
    from meteor_scatter_tpu_torch.io.native import build_native
    from meteor_scatter_tpu_torch.models import adaptive
    from meteor_scatter_tpu_torch.models import events as tev
    from meteor_scatter_tpu_torch.ops.kernels import adaptive_kernel as ak
    from meteor_scatter_tpu_torch.parallel.distributed import process_device

    out = {"phase": "e2e_determinism", "card": nvidia_smi_line(), "repeats": DETERMINISM_REPEATS}
    work = os.path.dirname(day_wav)

    # --- (a) the analyzer twice a route: the same CSV and label bytes ---
    def fixed_or_k1(extra):
        def run(csv_p, lbl_p):
            with contextlib.redirect_stdout(io.StringIO()):
                rc = analyze.main([day_wav, "--out-csv", csv_p, "--out-audacity", lbl_p,
                                   "--device", DEVICE, *extra])
            if rc != 0:
                raise RuntimeError(f"analyze.main {extra} returned {rc}")
        return run

    def parallel(csv_p, lbl_p):
        with contextlib.redirect_stdout(io.StringIO()):
            analyze.proc_wav_file(day_wav, out_csv_file=csv_p, out_audacity_lbl_file=lbl_p,
                                  wav_start_date_time=analyze.parse_gqrx_start_time(day_wav),
                                  expected_sample_rate=None, impl="parallel", device=DEVICE,
                                  verbose=False)

    n_blocks = FS * HOURS * 3600 // int(FS * BLOCK_SEC)
    k1_runs = math.ceil(n_blocks / (ak.MAX_FUSED_BLOCKS - SOLVER["window_blocks"]))
    routes = (("fixed_threshold", fixed_or_k1(["--fixed-threshold"]), 0),
              ("k1", fixed_or_k1([]), k1_runs), ("parallel", parallel, 0))
    out["analyzer"] = {}
    for route, run, want_k1 in routes:
        files, walls = [], []
        zero_launch_counts()
        for k in range(2):
            csv_p, lbl_p = (os.path.join(work, f"{route}{k}.{x}") for x in ("csv", "txt"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(csv_p, lbl_p)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            files.append((file_bytes(csv_p), file_bytes(lbl_p)))
        launches = launch_counts()
        if files[0] != files[1] or not files[0][0] or launches["adaptive_solver"] != 2 * want_k1:
            raise AssertionError(f"analyzer {route}: CSVs equal {files[0][0] == files[1][0]}, "
                                 f"labels equal {files[0][1] == files[1][1]}, {launches}")
        out["analyzer"][route] = {
            "events": len(read_rows(os.path.join(work, f"{route}0.csv"))),
            "csv_bytes": len(files[0][0]), "csv_identical": True, "labels_identical": True,
            "k1_launches": launches["adaptive_solver"], "wall_s": walls}

    # --- (b) events_from_mask on the day's fixed-threshold mask ---
    res = analyze.proc_wav_file(day_wav, flag_adaptive_threshold=False, expected_sample_rate=None,
                                device=DEVICE, verbose=False)
    delta = torch.from_numpy(res.delta_power).to(DEVICE)
    above = delta > torch.from_numpy(res.thresholds).to(DEVICE)
    cap = DETERMINISM_CAP
    ev = tev.events_from_mask(above, delta, cap)
    n_ev = int(ev.count)
    distinct_ev = distinct_bits(lambda: tuple(tev.events_from_mask(above, delta, cap)))
    helper_cpu = tev.fixed_point_run_means(above.cpu(), delta.cpu(), cap)
    helper_equal = bits_equal(ev.db_mean.cpu(), helper_cpu)
    ev_f32 = tev.events_from_mask(above.cpu(), delta.cpu(), cap)
    same_runs = all(bool(torch.equal(getattr(ev, f).cpu(), getattr(ev_f32, f)))
                    for f in ("start", "stop", "count", "overflow"))
    db_err = float((ev.db_mean[:n_ev].cpu() - ev_f32.db_mean[:n_ev]).abs().max())
    _, _, seg = tev._run_slots(above, cap)

    def float_sums():  # the CPU route's run sums, on the card
        return torch.zeros(cap + 1, device=DEVICE).scatter_add_(0, seg, torch.where(above, delta, 0))

    float_distinct = distinct_bits(float_sums)
    if distinct_ev != 1 or not helper_equal or not same_runs or bool(ev.overflow) \
            or n_ev == 0 or not db_err <= ANALYZER_DB_ATOL:
        raise AssertionError(f"events_from_mask: {distinct_ev} distinct results, helper == CPU "
                             f"{helper_equal}, runs equal the CPU's {same_runs}, {n_ev} events, "
                             f"dB err {db_err}")
    out["events_from_mask"] = {
        "blocks": int(delta.shape[0]), "events": n_ev, "distinct_results": distinct_ev,
        "means_equal_cpu_helper_bits": True, "runs_equal_cpu": True,
        "db_max_abs_err_vs_cpu_float": db_err, "db_atol": ANALYZER_DB_ATOL,
        "float_scatter_add_distinct": float_distinct,
        "ms": cuda_ms(lambda: tev.events_from_mask(above, delta, cap), warmup=1, reps=5),
        "fixed_point_means_ms": cuda_ms(lambda: tev.fixed_point_run_means(above, delta, cap),
                                        warmup=1, reps=5),
        "float_scatter_add_ms": cuda_ms(float_sums, warmup=1, reps=5)}

    # --- (c) the fixpoint's thresholds on the day and on the front end's input,
    # its window sums timed beside the float prefix difference they replace ---
    out["adaptive_thresholds_parallel"] = {}
    for name, x in (("day", delta), ("frontend", fe_delta)):
        distinct = distinct_bits(lambda: adaptive.adaptive_thresholds_parallel(x, **SOLVER))
        i = torch.arange(x.shape[-1], device=x.device)
        lo = torch.clamp(i - SOLVER["window_blocks"], min=0)

        def float_window_sums():
            cs = torch.cat([x.new_zeros(x.shape[:-1] + (1,)), torch.cumsum(x, -1)], -1)
            return cs[..., i] - cs[..., lo]

        out["adaptive_thresholds_parallel"][name] = {
            "shape": list(x.shape), "distinct_results": distinct,
            "float_cumsum_distinct": distinct_bits(lambda: torch.cumsum(x, -1)),
            "ms": cuda_ms(lambda: adaptive.adaptive_thresholds_parallel(x, **SOLVER), warmup=1,
                          reps=5),
            "window_sums_fixed_point_ms": cuda_ms(
                lambda: adaptive.window_sums_fixed_point(x, lo, i), warmup=1, reps=5),
            "window_sums_float_ms": cuda_ms(float_window_sums, warmup=1, reps=5)}
        if distinct != 1:
            raise AssertionError(f"adaptive_thresholds_parallel on the {name}: {distinct} "
                                 f"distinct results in {DETERMINISM_REPEATS}")
    del delta, above, ev

    # --- (d) the ms-torch-* console scripts, in a process where `import jax` fails ---
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = sorted(v for k, v in tomllib.load(f)["project"]["scripts"].items()
                         if k.startswith("ms-torch-"))
    code = (
        "import contextlib, importlib, io, json, sys\n"
        "sys.modules['jax'] = None  # any `import jax` now raises ImportError\n"
        "codes = {}\n"
        "for target in sys.argv[1:]:\n"
        "    module, func = target.split(':')\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(io.StringIO()):\n"
        "            getattr(importlib.import_module(module), func)(['--help'])\n"
        "        codes[target] = 0\n"
        "    except SystemExit as e:\n"
        "        codes[target] = e.code\n"
        "loaded = [k for k, v in sys.modules.items() if v is not None and (k.split('.')[0] == 'jax'\n"
        "          or k == 'meteor_scatter_tpu' or k.startswith('meteor_scatter_tpu.'))]\n"
        "print(json.dumps({'codes': codes, 'loaded': loaded}))\n")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code, *scripts], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    got = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.returncode == 0 else None
    if got is None or len(scripts) != 6 or set(got["codes"].values()) != {0} or got["loaded"]:
        raise AssertionError(f"ms-torch-* --help without JAX: rc {proc.returncode}, {got}, "
                             f"{proc.stderr[-2000:]}")
    out["scripts"] = {"help_exit_0_without_jax": scripts,
                      "jax_installed": importlib.util.find_spec("jax") is not None}

    # --- (e) the native build and one card per local rank ---
    spec = importlib.util.spec_from_file_location(
        "torch_scaling_bench", os.path.join(REPO, "tools", "torch_scaling_bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    saved = os.environ.get("LOCAL_RANK")
    os.environ["LOCAL_RANK"] = "0"
    try:
        dev = process_device("cuda")
        current = torch.cuda.current_device()
        bench_devices, _ = bench.local_devices("cuda", None)
    finally:
        if saved is None:
            os.environ.pop("LOCAL_RANK")
        else:
            os.environ["LOCAL_RANK"] = saved
    native = build_native()
    if not native or dev != torch.device("cuda", 0) or current != 0 or bench_devices != ["cuda:0"]:
        raise AssertionError(f"build_native() {native}; LOCAL_RANK=0 gave {dev}, current "
                             f"{current}, the bench {bench_devices}")
    out["build_native"] = True
    out["local_rank_0"] = {"process_device": str(dev), "current_device": current,
                           "bench_devices": bench_devices}
    emit(out)
    return out


# e2e_bench: torch_bench.py at bench.py's --quick sizes with every metric,
# the keys its artifact must hold, and each timing tool of tools/ once at a
# small size (the 64 stations cut to 8 x 120 s, 3 min of the live hour, 2 s
# of the I/Q capture), the scan (K3's twin, seconds a call on the card) as
# the tools' reference only
BENCH_ARGV = ["--quick", "--multi", "--stations", "--image", "--frontend", "--frontend-iq"]
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "date", "multi8_samples_per_sec",
              "stations64_samples_per_sec", "image_samples_per_sec",
              "channelizer_input_samples_per_sec", "frontend_iq_2msps_samples_per_sec",
              "fused_equals_parallel", "stations_fused_equals_scan",
              "frontend_iq_framed_equals_flat")
BENCH_TOOLS = {
    "torch_streaming_bench": ["--hours", "0.05", "--reps", "3",
                              "--combos", "bins:jump,bins:hop,welch:fused,bins:fused"],
    "torch_stations_bench": ["--stations", "8", "--seconds", "120", "--reps", "5",
                             "--impls", "jump,hop,fused"],
    "torch_stations_breakdown": ["--stations", "8", "--seconds", "120", "--reps", "20"],
    "torch_iq_breakdown": ["--seconds", "2", "--reps", "20"],
}


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def phase_e2e_bench() -> dict:
    """``torch_bench.main(BENCH_ARGV)`` in this process, so that the launch
    counts see its K1 and K3 launches: exit 0, every key of
    :data:`BENCH_KEYS`, every gate true, nothing implausible, K1 and K3
    launched.  Then each timing tool of ``tools/`` once at a small size
    (:data:`BENCH_TOOLS`), which exits 0 only when its events check
    passed.  The tools' launches are printed on the line and not added to
    the kernel records' counts."""
    import importlib

    import torch

    out = io.StringIO()
    t0 = time.perf_counter()
    zero_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = torch_bench.main(BENCH_ARGV)
    torch.cuda.synchronize()
    launches = launch_counts()
    bench_s = time.perf_counter() - t0
    artifact = last_json(out.getvalue())
    missing = [k for k in BENCH_KEYS if k not in artifact]
    failed = [g for g in torch_bench.GATES if artifact.get(g) is False]
    if rc != 0 or missing or failed or "implausible" in artifact:
        raise AssertionError(f"torch_bench.py exited {rc}: keys missing {missing}, gates failed "
                             f"{failed}, implausible {artifact.get('implausible')}")
    if launches["adaptive_solver"] < 1 or launches["stream_machine"] < 1:
        raise AssertionError(f"torch_bench.py launched {launches}: K1 and K3 expected")

    tools = {}
    zero_launch_counts()
    for name, argv in BENCH_TOOLS.items():
        text = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            rc = importlib.import_module(name).main(argv)
        if rc != 0:
            raise AssertionError(f"tools/{name}.py {argv} exited {rc}: {text.getvalue()[-2000:]}")
        tools[name] = {"argv": argv, "seconds": time.perf_counter() - t1,
                       "result": last_json(text.getvalue())}
    out = {"phase": "e2e_bench", "argv": BENCH_ARGV, "bench_s": bench_s, "launches": launches,
           "artifact": artifact, "tools": tools, "tool_launches": launch_counts()}
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
    with tempfile.TemporaryDirectory() as host_tmp:
        with tempfile.TemporaryDirectory() as tmp:
            e2e = phase_e2e(tmp)
            x = analyzer_day(tmp)
            records["bandpower"] = phase_kernel_k2(x)
            e2e_bp = phase_e2e_bandpower(x)
            day_delta = batch_delta_head(x)
            del x
            torch.cuda.empty_cache()
            e2e_live = phase_e2e_live(tmp)
            phase_e2e_spec_export(tmp)
            e2e_ep = phase_e2e_episode(tmp)
            host_inputs = cut_host_inputs(tmp, host_tmp)
            day_wav = keep_day_wav(tmp, host_tmp)
        e2e_st = phase_e2e_stations()
        phase_e2e_frontend()
        iq = frontend_iq_fixture()
        e2e_fiq = phase_e2e_frontend_iq(iq)
        with tempfile.TemporaryDirectory() as tmp:
            phase_e2e_monitor(tmp)
            phase_e2e_host(tmp, host_inputs)
            _, fe_delta = phase_e2e_sharded(tmp, iq)
            e2e_mp = phase_e2e_multiproc(tmp, iq, day_delta)
        del iq
        phase_e2e_determinism(day_wav, fe_delta)
    e2e_bench = phase_e2e_bench()
    if GOLDEN_FAILURES:
        raise AssertionError(f"the card differs from the JAX package's golden outputs: "
                             f"{GOLDEN_FAILURES}")
    loaded = port_modules_loaded_from_jax()
    if loaded:
        raise AssertionError(f"the port loaded JAX or the JAX package: {loaded[:5]}")

    bench = e2e_bench["launches"]
    launches = {"adaptive_solver": e2e["launches"] + bench["adaptive_solver"],
                "bandpower": e2e_bp["launches"] + bench["bandpower"],
                "stream_machine": e2e_live["launches"] + e2e_st["launches"] + e2e_fiq["launches"]
                + e2e_mp["k3_launches_children"] + e2e_ep["k3_launches"]
                + bench["stream_machine"]}
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi_line())
    emit({"kernels": [{"name": name, **KERNELS[name], "launches": launches[name], **records[name]}
                      for name in KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"], "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
