"""Streaming 3-state detector (Initialization → Detection → Tracking).

Counterpart of `meteor_scatter_tpu/models/streaming.py` (reference:
`dsp/src/live/backend/processor.py:176-510`), with the same names,
arguments and array layouts.  The decision process is one flat carry
advanced block by block; the per-block spectral work (Welch PSD and three
band sums, or the bins-only block projection) runs batched over the whole
chunk before it.

Per-block semantics (as the reference package):

* over-noise level: ms_db − mean(noise1_db, noise2_db)   (`processor.py:393`)
* rolling mean/std over the last ``avg_win`` values *excluding* the current
  block (`processor.py:394-404`)
* threshold = mean + k·std, overridden by the locked threshold while
  Tracking, or while Detection inside the post-tracking lock window
  (`processor.py:406-413`); the lock window and the minimum-duration
  acceptance are exact integer block arithmetic (:func:`lock_tail_blocks`,
  :func:`min_duration_blocks`)
* Initialization: accumulate mean PSD dB until
  ``block_start_sec >= init_detection_wait_sec`` (`processor.py:444-457`)
* Detection→Tracking on ``over_noise > threshold`` with the threshold
  locked at that value (`processor.py:459-471`)
* Tracking appends the current block to the event statistics *before* the
  below-threshold check (`processor.py:475-488`)
* event accepted iff mean ≥ detection_db_over_noise_mean_min and duration
  ≥ detection_dur_min_sec (`processor.py:476-493`)

Solvers: :func:`stream_step` is the per-block oracle formulation;
:func:`stream_scan` runs the block-rate solve (base-threshold prologue,
block machine, event compaction, final ring) as the plain PyTorch twin of
K3 (:func:`meteor_scatter_tpu_torch.ops.kernels.stream_kernel.stream_solve_plain`)
on any device; :func:`stream_scan_fused_batch` runs the same solve on the
series' device, which is one launch of the hand-written CUDA kernel K3 on
a GPU.  The two are bit-exact with each other on one device.  Every
state and series is batched over a leading channel axis where the
reference uses ``vmap``; an unbatched call is one channel.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from meteor_scatter_tpu_torch.config import DetectionConfig
from meteor_scatter_tpu_torch.device import DeviceLike, resolve_device
from meteor_scatter_tpu_torch.ops.kernels import stream_kernel
from meteor_scatter_tpu_torch.ops.welch import (
    band_sum_db,
    block_band_matrix,
    block_band_sums_db,
    welch_freqs,
    welch_psd,
)

# State machine encoding
INIT, DETECT, TRACK = 0, 1, 2

NOT_PORTED = "is not yet ported to meteor_scatter_tpu_torch (use meteor_scatter_tpu)"


def lock_tail_blocks(after_wait_sec: float, block_sec: float) -> int:
    """Largest integer m with ``m·block_sec < after_wait_sec`` in exact real
    arithmetic: after a track-leave at block j, the locked threshold applies
    in Detection through block ``j + m − 1`` (the reference condition
    ``t_start(j) + W > t_end(i)`` ⟺ ``(i+1−j)·bs < W``, processor.py:406)."""
    return int(math.ceil(after_wait_sec / block_sec - 1e-9)) - 1


def min_duration_blocks(min_dur_sec: float, block_sec: float) -> int:
    """Smallest integer n with ``n·block_sec ≥ min_dur_sec`` in exact real
    arithmetic — the accept rule ``duration ≥ detection_dur_min_sec``
    (processor.py:476-493) with duration = (leave − entry) blocks."""
    return int(math.ceil(min_dur_sec / block_sec - 1e-9))


class StreamConfig(NamedTuple):
    """Static parameters derived from DetectionConfig."""

    block_sec: float
    avg_win: int  # blocks
    init_wait_sec: float
    after_wait_sec: float
    k_std: float
    min_mean_db: float
    min_dur_sec: float
    cap: int

    @staticmethod
    def from_config(cfg: DetectionConfig) -> "StreamConfig":
        return StreamConfig(
            block_sec=cfg.proc_block_sec,
            avg_win=int(cfg.avg_win_sec / cfg.proc_block_sec),
            init_wait_sec=cfg.init_detection_wait_sec,
            after_wait_sec=cfg.after_tracking_wait_sec,
            k_std=cfg.threshold_std_factor,
            min_mean_db=cfg.detection_db_over_noise_mean_min,
            min_dur_sec=cfg.detection_dur_min_sec,
            cap=cfg.max_events,
        )


class StreamEvents(NamedTuple):
    """DetectedMeteor fields (`aggregates.py:66-74`) as fixed-cap tensors."""

    time_start: torch.Tensor
    time_stop: torch.Tensor
    duration: torch.Tensor
    db_min: torch.Tensor
    db_max: torch.Tensor
    db_mean: torch.Tensor
    db_std: torch.Tensor
    count: torch.Tensor
    overflow: torch.Tensor


class StreamState(NamedTuple):
    """The carry — the flattened union of the reference's three state
    dataclasses plus the rolling history."""

    state: torch.Tensor  # int32: INIT/DETECT/TRACK
    block_idx: torch.Tensor  # int32 absolute block counter
    ring: torch.Tensor  # f32 [avg_win] trailing over-noise values
    locked_threshold: torch.Tensor
    locked_until_block: torch.Tensor  # int32: last block the lock applies to
    track_start_sec: torch.Tensor
    track_start_block: torch.Tensor  # int32 absolute entry block
    # running stats of the tracking history
    tr_count: torch.Tensor
    tr_sum: torch.Tensor
    tr_sumsq: torch.Tensor
    tr_min: torch.Tensor
    tr_max: torch.Tensor
    # initialization-phase PSD accumulation (auto-gain, processor.py:448-454)
    init_sum: torch.Tensor
    init_count: torch.Tensor
    psd_db_mean_from_init: torch.Tensor


def _map(fn: Callable, tup):
    return type(tup)(*(fn(x) for x in tup))


def stream_init(cfg: StreamConfig, device: DeviceLike = "cuda", dtype=torch.float32) -> StreamState:
    dev = resolve_device(device)

    def f(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    def i(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return StreamState(
        state=i(INIT),
        block_idx=i(0),
        ring=torch.zeros(cfg.avg_win, dtype=dtype, device=dev),
        locked_threshold=f(-1.0),
        locked_until_block=i(-1),
        track_start_sec=f(0.0),
        track_start_block=i(0),
        tr_count=i(0),
        tr_sum=f(0.0),
        tr_sumsq=f(0.0),
        tr_min=f(math.inf),
        tr_max=f(-math.inf),
        init_sum=f(0.0),
        init_count=i(0),
        psd_db_mean_from_init=f(0.0),
    )


def stream_init_batch(
    cfg: StreamConfig, n_channels: int, device: DeviceLike = "cuda", dtype=torch.float32
) -> StreamState:
    """Per-channel initial state: every :func:`stream_init` leaf gains a
    leading (n_channels,) axis."""
    return _map(
        lambda x: x.expand((n_channels,) + x.shape).contiguous(), stream_init(cfg, device, dtype)
    )


def state_from_numpy(arrays, device: DeviceLike = "cuda") -> StreamState:
    """A :class:`StreamState` on ``device`` from numpy arrays under the
    field names of ``StreamState`` — a mapping, or any object with those
    attributes, such as the JAX package's ``StreamState`` after
    ``np.asarray`` of each leaf.  A stream begun in either package
    continues in the other: dtypes (int32 / float32) and layouts are the
    same in both."""
    dev = resolve_device(device)
    get = arrays.__getitem__ if isinstance(arrays, dict) else functools.partial(getattr, arrays)
    return StreamState(
        *(torch.from_numpy(np.array(get(f))).to(dev) for f in StreamState._fields)
    )


def state_to_numpy(state: StreamState) -> StreamState:
    """The state's leaves as numpy arrays, the inverse of
    :func:`state_from_numpy` (``jax`` ``StreamState(*state_to_numpy(s))``
    hands a stream back to the JAX package)."""
    return _map(lambda t: t.detach().cpu().numpy(), state)


def _empty_events(cap: int, dtype, device) -> StreamEvents:
    zf = torch.zeros(cap, dtype=dtype, device=device)
    return StreamEvents(
        time_start=zf,
        time_stop=zf,
        duration=zf,
        db_min=zf,
        db_max=zf,
        db_mean=zf,
        db_std=zf,
        count=torch.zeros((), dtype=torch.int32, device=device),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
    )


def stream_step(cfg: StreamConfig, state: StreamState, events: StreamEvents, over_noise, psd_db_mean):
    """Advance one block of one channel.  Returns (state, events,
    effective_threshold)."""
    dtype, dev = over_noise.dtype, over_noise.device
    i = state.block_idx
    bs = torch.tensor(cfg.block_sec, dtype=dtype, device=dev)
    t_start = i.to(dtype) * bs
    lock_tail = lock_tail_blocks(cfg.after_wait_sec, cfg.block_sec)
    min_dur_b = min_duration_blocks(cfg.min_dur_sec, cfg.block_sec)
    zero = torch.zeros((), dtype=dtype, device=dev)
    inf = torch.tensor(math.inf, dtype=dtype, device=dev)

    # rolling stats over trailing window (current block excluded)
    w = cfg.avg_win
    cnt = torch.clamp(i, max=w)
    valid = torch.arange(w, device=dev) < cnt
    cnt_f = torch.clamp(cnt, min=1).to(dtype)
    m = torch.where(valid, state.ring, zero).sum() / cnt_f
    m2 = torch.where(valid, state.ring * state.ring, zero).sum() / cnt_f
    std = torch.sqrt(torch.maximum(m2 - m * m, zero))
    base_thr = torch.where(cnt > 0, m + cfg.k_std * std, torch.full_like(m, math.nan))

    thr = torch.where(
        state.state == TRACK,
        state.locked_threshold,
        torch.where(
            (state.state == DETECT) & (i <= state.locked_until_block),
            state.locked_threshold,
            base_thr,
        ),
    )

    # ---- INIT ----
    new_init_sum = state.init_sum + psd_db_mean
    new_init_count = state.init_count + 1
    init_done = t_start >= torch.tensor(cfg.init_wait_sec, dtype=dtype, device=dev)
    psd_mean_from_init = new_init_sum / torch.clamp(new_init_count, min=1).to(dtype)

    # ---- DETECT: enter tracking? ----
    enter_track = over_noise > thr

    # ---- TRACK: update history stats (current block appended first) ----
    tr_count = state.tr_count + 1
    tr_sum = state.tr_sum + over_noise
    tr_sumsq = state.tr_sumsq + over_noise * over_noise
    tr_min = torch.minimum(state.tr_min, over_noise)
    tr_max = torch.maximum(state.tr_max, over_noise)
    leave_track = over_noise < thr

    dur = t_start - state.track_start_sec
    h_cnt = torch.clamp(tr_count, min=1).to(dtype)
    h_mean = tr_sum / h_cnt
    h_std = torch.sqrt(torch.maximum(tr_sumsq / h_cnt - h_mean * h_mean, zero))
    accept = (h_mean >= torch.tensor(cfg.min_mean_db, dtype=dtype, device=dev)) & (
        i - state.track_start_block >= min_dur_b
    )

    is_init = state.state == INIT
    is_detect = state.state == DETECT
    is_track = state.state == TRACK

    emit = is_track & leave_track & accept
    sel = torch.arange(cfg.cap, device=dev) == torch.where(
        emit & (events.count < cfg.cap), events.count, cfg.cap
    )
    events = StreamEvents(
        time_start=torch.where(sel, state.track_start_sec, events.time_start),
        time_stop=torch.where(sel, t_start, events.time_stop),
        duration=torch.where(sel, dur, events.duration),
        db_min=torch.where(sel, tr_min, events.db_min),
        db_max=torch.where(sel, tr_max, events.db_max),
        db_mean=torch.where(sel, h_mean, events.db_mean),
        db_std=torch.where(sel, h_std, events.db_std),
        count=events.count + emit.to(torch.int32),
        overflow=events.overflow | (emit & (events.count >= cfg.cap)),
    )

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    next_state = torch.where(
        is_init,
        torch.where(init_done, i32(DETECT), i32(INIT)),
        torch.where(
            is_detect,
            torch.where(enter_track, i32(TRACK), i32(DETECT)),
            torch.where(leave_track, i32(DETECT), i32(TRACK)),
        ),
    )
    start = is_detect & enter_track
    new_state = StreamState(
        state=next_state,
        block_idx=i + 1,
        ring=torch.where(torch.arange(w, device=dev) == torch.remainder(i, w), over_noise, state.ring),
        locked_threshold=torch.where(start, thr, state.locked_threshold),
        locked_until_block=torch.where(
            is_track & leave_track, i + (lock_tail - 1), state.locked_until_block
        ),
        track_start_sec=torch.where(start, t_start, state.track_start_sec),
        track_start_block=torch.where(start, i, state.track_start_block),
        tr_count=torch.where(start, i32(0), torch.where(is_track, tr_count, state.tr_count)),
        tr_sum=torch.where(start, zero, torch.where(is_track, tr_sum, state.tr_sum)),
        tr_sumsq=torch.where(start, zero, torch.where(is_track, tr_sumsq, state.tr_sumsq)),
        tr_min=torch.where(start, inf, torch.where(is_track, tr_min, state.tr_min)),
        tr_max=torch.where(start, -inf, torch.where(is_track, tr_max, state.tr_max)),
        init_sum=torch.where(is_init, new_init_sum, state.init_sum),
        init_count=torch.where(is_init, new_init_count, state.init_count),
        psd_db_mean_from_init=torch.where(
            is_init & init_done, psd_mean_from_init, state.psd_db_mean_from_init
        ),
    )
    return new_state, events, thr


def _blocked(samples: torch.Tensor, block: int) -> torch.Tensor:
    """Shape audio as ``(..., n_blocks, block)``: flat ``(..., S)`` audio is
    cut into whole blocks (a view), audio already ``(..., n_blocks, block)``
    (ndim ≥ 3) passes as it is."""
    if samples.dim() >= 3 and samples.shape[-1] == block:
        return samples
    n_blocks = samples.shape[-1] // block
    return samples[..., : n_blocks * block].reshape(samples.shape[:-1] + (n_blocks, block))


def _sanitize_levels(on: torch.Tensor) -> torch.Tensor:
    """Clamp ±inf levels (digital-silence / saturated-capture dB) to ±1e15
    and map NaN to −1e15 at the front/solver boundary, as the reference
    package does: finite values pass bit-unchanged, the square of the
    sentinel stays finite in float32, and a degenerate block cannot spread
    NaN through the rolling-window sums.  The three band levels are
    sanitized individually before the band subtraction."""
    big = 1e15
    return torch.clamp(torch.nan_to_num(on, nan=-big), -big, big)


def stream_front(cfg: DetectionConfig, samples: torch.Tensor, fs: float):
    """Vectorized front half (Welch PSD + three band sums for every block
    at once, `processor.py:206,349-393`), batched over any leading dims.

    Returns (over_noise, psd_db_mean, front_diags) with per-block series of
    shape ``samples.shape[:-1] + (n_blocks,)``; audio is accepted flat
    (``(..., S)``) or pre-blocked (``(..., n_blocks, block)``, ndim ≥ 3).
    """
    block = int(round(cfg.proc_block_sec * fs))
    x = _blocked(samples, block)

    psd = welch_psd(x, fs, cfg.n_fft, nperseg=cfg.welch_nperseg)
    psd_db = 10.0 * torch.log10(psd)
    freqs = welch_freqs(fs, cfg.n_fft)

    ms_db = _sanitize_levels(band_sum_db(psd, freqs, cfg.signal_band))
    n1_db = _sanitize_levels(band_sum_db(psd, freqs, cfg.noise_band_1))
    n2_db = _sanitize_levels(band_sum_db(psd, freqs, cfg.noise_band_2))
    over_noise = ms_db - (n1_db + n2_db) / 2.0
    psd_db_mean = psd_db.mean(dim=-1)
    diags = {
        "ms_db": ms_db,
        "noise1_db": n1_db,
        "noise2_db": n2_db,
        "psd_db": psd_db,
        "freqs": freqs,
    }
    return over_noise, psd_db_mean, diags


@functools.lru_cache(maxsize=8)
def _headless_projection(fs: float, nfft: int, nperseg: int, bands, block: int):
    # float64 eigen-factor of the whole-block Welch band operator
    # (block_band_matrix): framing, window, DFT selection and the segment
    # mean folded into one (block, K) factor
    return block_band_matrix(fs, nfft, nperseg, block, bands)


@functools.lru_cache(maxsize=8)
def _headless_projection_on(fs: float, nfft: int, nperseg: int, bands, block: int, device: str):
    P, slices, nseg = _headless_projection(fs, nfft, nperseg, bands, block)
    return torch.from_numpy(P).to(device), slices, nseg


def stream_front_headless(cfg: DetectionConfig, samples: torch.Tensor, fs: float):
    """Bins-only front half: the three Welch band levels as one float32
    product on the raw blocks (:func:`block_band_matrix`) instead of
    zero-padded nfft-point PSDs whose other bins detection never reads.

    Accepts audio flat (``(..., S)``) or pre-blocked (``(..., n_blocks,
    block)``, ndim ≥ 3).  Event decisions depend only on ``over_noise``;
    ``psd_db_mean`` feeds only the visualization auto-gain
    (`processor.py:448-454`), so it is zeros here and no PSD waterfall is
    carried.  Band levels equal the Welch path's to float32 reduction order
    and the factor's truncated eigenmass; a tie at the threshold could in
    principle flip a block, so headless stays opt-in (``front="bins"``,
    ``apps/live.py --headless``).  The projection is built once and kept
    per device.
    """
    block = int(round(cfg.proc_block_sec * fs))
    x = _blocked(samples, block)
    nperseg = min(cfg.welch_nperseg, block)
    P, slices, nseg = _headless_projection_on(
        fs, cfg.n_fft, nperseg,
        (cfg.signal_band, cfg.noise_band_1, cfg.noise_band_2),
        block, str(x.device),
    )
    ms_db, n1_db, n2_db = (_sanitize_levels(v) for v in block_band_sums_db(x, P, slices, nseg))
    over_noise = ms_db - (n1_db + n2_db) / 2.0
    psd_db_mean = torch.zeros_like(over_noise)
    diags = {"ms_db": ms_db, "noise1_db": n1_db, "noise2_db": n2_db}
    return over_noise, psd_db_mean, diags


def solve_params(scfg: StreamConfig) -> dict:
    """The solve's keywords (:func:`stream_kernel.stream_solve_plain`): the
    float constants as the kernel takes them, and the block counts."""
    return dict(
        k_std=float(scfg.k_std),
        block_sec=float(scfg.block_sec),
        init_wait_sec=float(scfg.init_wait_sec),
        min_mean_db=float(scfg.min_mean_db),
        min_dur_b=min_duration_blocks(scfg.min_dur_sec, scfg.block_sec),
        lock_tail=lock_tail_blocks(scfg.after_wait_sec, scfg.block_sec),
        cap=int(scfg.cap),
    )


def _solve(scfg: StreamConfig, state: StreamState, over_noise, psd_db_mean, solve):
    """One chunk of C channels through ``solve`` (the kernel's layout, see
    :mod:`meteor_scatter_tpu_torch.ops.kernels.stream_kernel`); an
    unbatched call (1-D series, scalar state) is C = 1.  Series that are not
    contiguous are copied first; the fronts' are, so on the main path only
    views are taken around the solve."""
    if over_noise.dim() == 1:
        st, ev, thr = _solve(
            scfg, _map(lambda a: a.unsqueeze(0), state), over_noise[None], psd_db_mean[None],
            solve,
        )
        return _map(lambda a: a[0], st), _map(lambda a: a[0], ev), thr[0]
    st, ev, thr = solve(over_noise.contiguous(), psd_db_mean.contiguous(), tuple(state),
                        **solve_params(scfg))
    return StreamState(*st), StreamEvents(*ev), thr


def stream_scan(
    scfg: StreamConfig,
    state: StreamState,
    over_noise: torch.Tensor,  # (n_blocks,) or (C, n_blocks)
    psd_db_mean: torch.Tensor,  # like over_noise
) -> Tuple[StreamState, StreamEvents, torch.Tensor]:
    """The sequential 3-state machine over one chunk — the block-rate back
    half of :func:`stream_process` (reference semantics:
    `processor.py:444-510`).  The whole solve is K3's plain PyTorch twin
    (``stream_solve_plain``) on whatever device the series lie on.  Returns
    (new_state, events,
    per-block thresholds); batched over a leading channel axis, or one
    channel with 1-D series and a scalar state."""
    return _solve(scfg, state, over_noise, psd_db_mean, stream_kernel.stream_solve_plain)


def stream_scan_fused_batch(
    scfg: StreamConfig,
    state: StreamState,        # batched: every leaf has leading dim (C,)
    over_noise: torch.Tensor,  # (C, n_blocks)
    psd_db_mean: torch.Tensor,  # (C, n_blocks)
) -> Tuple[StreamState, StreamEvents, torch.Tensor]:
    """Batched fused form of :func:`stream_scan` — the wide-station solver
    (BASELINE config 5): on a GPU one launch of the CUDA kernel K3 runs
    the whole solve of every channel (prologue, machine, compaction, ring),
    any C, and nothing else is launched; on the CPU the same call runs K3's
    twin.

    Contract: bit-exact vs :func:`stream_scan` on the same device, since
    the kernel is bit-exact against the twin on every output.
    """
    if over_noise.dim() != 2:
        raise ValueError(f"over_noise must be (C, n_blocks), got shape {tuple(over_noise.shape)}")
    return _solve(scfg, state, over_noise, psd_db_mean, stream_kernel.stream_solve)


def stream_scan_fused(
    scfg: StreamConfig,
    state: StreamState,
    over_noise: torch.Tensor,   # (n_blocks,)
    psd_db_mean: torch.Tensor,  # (n_blocks,)
) -> Tuple[StreamState, StreamEvents, torch.Tensor]:
    """Single-series form of :func:`stream_scan_fused_batch` (same
    (new_state, events, thresholds) contract as :func:`stream_scan`)."""
    return _solve(scfg, state, over_noise, psd_db_mean, stream_kernel.stream_solve)


def resolve_stream_auto(front: str, impl: str, device: DeviceLike) -> Tuple[str, str]:
    """Resolve ``front``/``impl`` ``"auto"`` for the device the chunk lies
    on: on a CUDA device the bins front and the fused kernel K3, on the CPU
    the welch front and the scan (the formulation the oracles pin).

    Callers that need the PSD waterfall must pass ``front="welch"``
    explicitly — the bins front computes only the three band levels.
    """
    on_gpu = torch.device(device).type == "cuda"
    if front == "auto":
        front = "bins" if on_gpu else "welch"
    if impl == "auto":
        impl = "fused" if on_gpu else "scan"
    return front, impl


def stream_process(
    cfg: DetectionConfig,
    state: StreamState,
    samples: torch.Tensor,
    fs: float,
    front: str = "auto",
    impl: str = "auto",
) -> Tuple[StreamState, StreamEvents, dict]:
    """Process a chunk of audio (any whole number of blocks) on the device
    the samples and state lie on.

    Vectorized front half (:func:`stream_front` or
    :func:`stream_front_headless`), then the sequential state machine
    (:func:`stream_scan` or :func:`stream_scan_fused`).  Returns
    (new_state, events_found_in_chunk, diagnostics) where diagnostics
    carries the per-block series (over_noise, threshold, band dBs, and the
    psd waterfall with the welch front).

    ``front``/``impl`` default to ``"auto"`` (:func:`resolve_stream_auto`).
    The episode-jump solvers ``"jump"`` / ``"hop"`` are not yet ported and
    raise.
    """
    front, impl = resolve_stream_auto(front, impl, samples.device)
    if impl in ("jump", "hop"):
        raise NotImplementedError(f"impl={impl!r} (episode-jump solver) {NOT_PORTED}")
    if front not in ("welch", "bins"):
        raise ValueError(f"unknown front {front!r} (use 'welch' or 'bins')")
    if impl not in ("scan", "fused"):
        raise ValueError(f"unknown impl {impl!r} (use 'scan' or 'fused')")
    scfg = StreamConfig.from_config(cfg)
    block = int(round(cfg.proc_block_sec * fs))
    n_blocks = samples.shape[-1] // block
    if n_blocks == 0:
        # the same key schema as a non-empty chunk of this front, with
        # length-0 per-block series
        z = torch.zeros(0, dtype=torch.float32, device=samples.device)
        diags = {"over_noise": z, "threshold": z, "ms_db": z, "noise1_db": z, "noise2_db": z}
        if front == "welch":
            freqs = welch_freqs(fs, cfg.n_fft)
            diags["psd_db"] = torch.zeros((0, len(freqs)), dtype=torch.float32, device=samples.device)
            diags["freqs"] = freqs
        return state, _empty_events(scfg.cap, torch.float32, samples.device), diags

    if front == "bins":
        over_noise, psd_db_mean, front_diags = stream_front_headless(cfg, samples, fs)
    else:
        over_noise, psd_db_mean, front_diags = stream_front(cfg, samples, fs)
    solve = stream_scan if impl == "scan" else stream_scan_fused
    state, events, thresholds = solve(scfg, state, over_noise, psd_db_mean)
    diags = {"over_noise": over_noise, "threshold": thresholds, **front_diags}
    return state, events, diags
